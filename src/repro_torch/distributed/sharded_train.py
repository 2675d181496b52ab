"""The sharded train step: the port's counterpart of the reference's
``jax.jit(train_step, in_shardings=...)`` on a ("pod",)? + ("data",
"model") mesh (``repro/launch/train.py:100-104``, ``steps.py:310-327``).

One rule holds whatever the mesh: the step computes what ``make_train_step``
computes on one device. The state is placed (``distributed.sharding``):
params and AdamW moments by ``param_specs(fsdp=True)``, the batch by
``batch_specs``. A step:

1. each data rank (row-major over the data axes) gathers the whole
   weights onto its device (ZeRO-3, the choice the reference's
   ``dp_constrain`` forces on GSPMD) and runs the loss and its gradient
   on its own rows of the batch, ``accum`` microbatches of them summed in
   f32 and divided by ``accum`` as ``make_train_step`` does;
2. the ranks' gradients are summed leaf by leaf in f32 by
   ``ring_allreduce_schedule`` and divided by the rank count, so every
   rank holds the same mean;
3. the clip takes the global norm of that whole mean gradient, and AdamW
   updates each block of the params and moments in place, on its device.

The "model" axis is gathered like the data axes: the matmuls are not
split over it. With ``accum`` > 1, rank r's microbatch i is the r-th of
the data ranks' slices of the global microbatch i (the reference's
grouping), fetched from whichever rank's block holds those rows.

An MoE model whose ``moe_impl`` is not ``"shard_map"`` takes its
capacity from the whole batch in the reference, which a forward per rank
cannot reproduce: on more than one data rank such a step raises. Under
``"shard_map"`` a capacity per data shard is the reference's own
semantics, and each rank's forward dispatches its own tokens.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import ring_allreduce_schedule
from repro_torch.launch.mesh import data_axes
from repro_torch.training import optimizer as opt


def data_ranks(mesh) -> list:
    """Each data rank's device: the mesh's device at the rank's data
    coordinates (row-major over the data axes) and index 0 of the rest."""
    dp = data_axes(mesh)
    return [mesh.device(**dict(zip(dp, r)))
            for r in itertools.product(*(range(mesh.shape[a]) for a in dp))]


def place_params(params, cfg: ModelConfig, mesh, fsdp: bool = True,
                 fsdp_axes: tuple = ("data",)):
    """``params`` (tensors or host arrays) placed by ``param_specs``
    (copies)."""
    specs = shd.param_specs(params, cfg, fsdp=fsdp, fsdp_axes=fsdp_axes)
    return shd.place_tree(shd.tree_map(torch.as_tensor, params),
                          shd.named(mesh, specs))


def init_placed_state(params, moment_dtype: str = "float32"
                      ) -> opt.AdamWState:
    """AdamW's zero moments placed as the params (``opt.init_state``)."""
    dt = getattr(torch, moment_dtype)
    zeros = lambda p: shd.zeros_placed(p, dt)
    return opt.AdamWState(0, shd.tree_map(zeros, params),
                          shd.tree_map(zeros, params))


def place_batch(batch: dict, cfg: ModelConfig, mesh) -> dict:
    """A global batch placed by ``batch_specs`` over the mesh's data
    axes."""
    specs = shd.batch_specs(cfg, "train", data_axes(mesh))
    return {k: shd.device_put(v, shd.NamedSharding(mesh, specs[k]))
            for k, v in batch.items()}


def batch_rows(x: shd.Placed, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a batch leaf placed along its first dim, on
    ``device``, copied from the blocks that hold them."""
    parts, done = [], set()
    for (_, sl), b in x.blocks.items():
        b_lo, b_hi = sl[0]
        if sl in done or b_hi <= lo or b_lo >= hi:
            continue
        done.add(sl)
        parts.append((b_lo, b[max(lo, b_lo) - b_lo:min(hi, b_hi) - b_lo]))
    parts.sort(key=lambda t: t[0])
    return torch.cat([p.to(device) for _, p in parts])


def _check_moe(cfg: ModelConfig, n_ranks: int) -> None:
    if cfg.is_moe and n_ranks > 1 and cfg.moe_impl != "shard_map":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl={cfg.moe_impl!r} takes the MoE capacity "
            f"from the whole batch, which a step per data rank cannot "
            f"reproduce on {n_ranks} ranks; use moe_impl='shard_map' (a "
            f"capacity per data shard, the OPTIMIZED train policies of the "
            f"MoE configurations) or one data rank")


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics
    {"loss", "grad_norm", "lr"})`` over placed state (module docstring);
    the params and moments are updated in place."""

    def __init__(self, cfg: ModelConfig, mesh, accum: int = 1,
                 optc: Optional[opt.AdamWConfig] = None,
                 ce_chunk: int = 512):
        self.cfg = cfg.replace(act_dp=())        # each rank's own forward
        self.mesh = mesh
        self.accum = accum
        self.optc = optc or opt.AdamWConfig()
        self.ce_chunk = ce_chunk
        self.ranks = data_ranks(mesh)

    def rank_grads(self, params, batch: dict, r: int):
        """Rank r's loss and gradient (f32 summed over its microbatches
        and divided by ``accum`` when ``accum`` > 1), with the weights
        gathered onto its device."""
        from repro_torch.launch.steps import chunked_ce_loss, value_and_grad
        dev, n, accum = self.ranks[r], len(self.ranks), self.accum
        B = next(iter(batch.values())).shape[0]
        if B % (n * accum):
            raise ValueError(f"batch {B} does not split into {accum} "
                             f"microbatches over {n} data ranks")
        Bm, b = B // accum, B // accum // n
        weights = shd.tree_map(lambda x: shd.gather(x, dev), params)

        def loss_grads(i):
            mb = {k: batch_rows(v, i * Bm + r * b, i * Bm + (r + 1) * b, dev)
                  for k, v in batch.items()}
            return value_and_grad(lambda p: chunked_ce_loss(
                p, self.cfg, mb, self.ce_chunk)[0], weights)
        if accum == 1:
            return loss_grads(0)
        grads = opt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), weights)
        losses = []
        for i in range(accum):
            l_i, g_i = loss_grads(i)
            opt.tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
            losses.append(l_i)
            del g_i
        grads = opt.tree_map(lambda g: g / accum, grads)
        return sum(losses[1:], losses[0]) / accum, grads

    def _mean_grads(self, params, batch: dict):
        """(the loss; the mean gradient, one {device: whole f32 tensor}
        per leaf in ``tree_leaves`` order, a copy on each device a data
        rank runs on; its global norm)."""
        n = len(self.ranks)
        _check_moe(self.cfg, n)
        losses, flat = [], []
        for r in range(n):
            loss, g = self.rank_grads(params, batch, r)
            losses.append(loss.to(self.ranks[0]))
            flat.append([x for _, x in opt.tree_leaves(g)])
            del g
        means = []
        for i in range(len(flat[0])):
            xs = [flat[r][i].float() for r in range(n)]
            for r in range(n):
                flat[r][i] = None
            out = ring_allreduce_schedule(xs)
            del xs
            mean = {}
            for r, dev in enumerate(self.ranks):
                if dev not in mean:     # one rank's ring returns its input
                    mean[dev] = out[r].div_(n) if n > 1 else out[r] / n
            means.append(mean)
            del out
        lead = self.ranks[0]
        gnorm = opt.global_norm([m[lead] for m in means])
        return sum(losses[1:], losses[0]) / n, means, gnorm

    def grads(self, params, batch: dict):
        """(the loss, the mean gradient: a tree like params of whole f32
        tensors on the first data rank's device, its global norm)."""
        loss, means, gnorm = self._mean_grads(params, batch)
        lead = self.ranks[0]
        it = iter(means)
        return loss, opt.tree_map(lambda _: next(it)[lead], params), gnorm

    @torch.no_grad()
    def _update(self, params, opt_state: opt.AdamWState, means: list,
               gnorm):
        """AdamW on every block of the params and moments, in place, by its
        slice of the mean gradient (``_mean_grads``' list; the copy on the
        block's device, else the first)."""
        optc = self.optc
        opt.check_moments(opt_state, optc)
        step = opt_state.step + 1
        scalars = opt.update_scalars(optc, step, gnorm)
        leaves = zip(opt.tree_leaves(params), means,
                     opt.tree_leaves(opt_state.m),
                     opt.tree_leaves(opt_state.v))
        for (path, p), g, (_, m), (_, v) in leaves:
            for key, pb in p.blocks.items():
                dev, sl = key
                src = g[dev] if dev in g else next(iter(g.values()))
                gb = src[tuple(slice(lo, hi) for lo, hi in sl)].to(dev)
                opt.update_leaf(path, pb, gb, m.blocks[key], v.blocks[key],
                                scalars, optc)
        return params, opt.AdamWState(step, opt_state.m, opt_state.v), \
            {"lr": scalars[1]}

    def __call__(self, params, opt_state: opt.AdamWState, batch: dict):
        loss, means, gnorm = self._mean_grads(params, batch)
        params, opt_state, metrics = self._update(params, opt_state, means,
                                                  gnorm)
        metrics.update(grad_norm=gnorm, loss=loss)
        return params, opt_state, metrics


def make_sharded_train_step(cfg: ModelConfig, mesh, accum: int = 1,
                            optc: Optional[opt.AdamWConfig] = None,
                            ce_chunk: int = 512) -> ShardedTrainStep:
    return ShardedTrainStep(cfg, mesh, accum, optc, ce_chunk)


def gather_state(params, opt_state: opt.AdamWState, device=None
                 ) -> tuple[Any, opt.AdamWState]:
    """Whole params and moments on ``device`` (the exact tensors placed)."""
    g = lambda t: shd.gather_tree(t, device)
    return g(params), opt.AdamWState(opt_state.step, g(opt_state.m),
                                     g(opt_state.v))


__all__ = ["ShardedTrainStep", "batch_rows", "data_ranks", "gather_state",
           "init_placed_state", "make_sharded_train_step", "place_batch",
           "place_params"]
