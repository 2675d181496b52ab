"""AdamW over a parameter tree (port of ``repro/training/optimizer.py``).

Params are the port's nested dicts and lists of tensors; the moments
``m`` and ``v`` mirror that tree. The update is the reference's, leaf by
leaf, in f32 whatever the parameter's dtype: the global-norm clip, bias
correction, decoupled weight decay on every leaf whose name (the last key
of its path) names no norm or bias, and the moments stored in
``moment_dtype``. Plain torch ops over the tree, no ``torch.optim``.

Unlike the reference, which returns new trees, ``apply_updates`` writes
the new parameters and moments into the tensors it is given, so a step
holds one copy of each (at qwen3-14b's width the moments alone are 23 GB
for 2.9 B parameters).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int                # updates applied so far
    m: Any                   # tree like params, in moment_dtype
    v: Any                   # tree like params, in moment_dtype


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment storage dtype: "float32" or "bfloat16" (halves the optimizer's
    # bytes; the maths stays f32)
    moment_dtype: str = "float32"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dicts and lists; leaves are visited in
    ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any, path: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) pairs, dict keys in sorted order (as JAX orders a
    pytree), so trees with the same keys pair leaf by leaf whatever order
    their dicts were built in; a path is its keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def init_state(params, moment_dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def _decay_mask(path) -> bool:
    """No weight decay for norms and biases: leaves whose name contains
    scale, bias, ln or norm."""
    name = str(path[-1])
    return not any(s in name for s in ("scale", "bias", "ln", "norm"))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: the learning
    rate of update ``step``, an f32 scalar (computed in f32, as the
    reference's)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def check_moments(state: AdamWState, cfg: AdamWConfig) -> None:
    """Raise unless the moments are stored in ``cfg.moment_dtype``."""
    mdt = getattr(torch, cfg.moment_dtype)
    for _, m in tree_leaves(state.m):
        if m.dtype != mdt:
            raise ValueError(f"moments stored in {m.dtype}, the config "
                             f"asks for {cfg.moment_dtype}")
        break


def update_scalars(cfg: AdamWConfig, step: int, gnorm: torch.Tensor
                   ) -> tuple[torch.Tensor, ...]:
    """The f32 scalars of update ``step`` (1-based) at gradient norm
    ``gnorm``: (clip factor, learning rate, b1 and b2 bias corrections)."""
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = torch.tensor(step, dtype=torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), stepf)
    return clip, lr, b1c, b2c


# the elements of a leaf one pass of ``update_leaf`` takes at once: its f32
# temporaries (half a dozen of them) stay at 256 MB each, where a whole
# 2.1 B-parameter embedding (command-r-35b's) would hold 8.4 GB each
UPDATE_CHUNK = 1 << 26


@torch.no_grad()
def update_leaf(path, p, g, m, v, scalars, cfg: AdamWConfig) -> None:
    """One leaf's (or one block of a leaf's) AdamW update, in place, in
    f32: ``scalars`` from ``update_scalars``. A leaf of more than
    ``UPDATE_CHUNK`` elements goes a block of its leading rows at a time:
    the same elementwise arithmetic, so the same bits."""
    # a CPU scalar joins an op on any device; one on another card moves
    sc = tuple(x if x.device in (p.device, torch.device("cpu"))
               else x.to(p.device) for x in scalars)
    decay = bool(cfg.weight_decay and _decay_mask(path))
    rows = p.shape[0] if p.dim() else 1
    step = max(1, UPDATE_CHUNK // max(1, p.numel() // max(rows, 1)))
    if rows <= step:                    # a 0-d leaf too
        return _update_rows(p, g, m, v, sc, cfg, decay)
    for i in range(0, rows, step):
        sl = slice(i, i + step)
        _update_rows(p[sl], g[sl], m[sl], v[sl], sc, cfg, decay)


def _update_rows(p, g, m, v, scalars, cfg: AdamWConfig, decay: bool
                 ) -> None:
    clip, lr, b1c, b2c = scalars
    gf = g.float() * clip
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
    vf = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)
    upd = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    m.copy_(mf)
    v.copy_(vf)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig
                  ) -> tuple[Any, AdamWState, dict]:
    """One AdamW update of ``params`` by ``grads`` (a tree like params, any
    float dtype). Writes the new parameters and moments in place and
    returns (params, the new state, {"grad_norm", "lr"}). The state's
    moments must be stored in ``cfg.moment_dtype`` (``init_state``)."""
    check_moments(state, cfg)
    gnorm = global_norm(grads)
    step = state.step + 1
    scalars = update_scalars(cfg, step, gnorm)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.m), tree_leaves(state.v))
    for (path, p), (_, g), (_, m), (_, v) in leaves:
        update_leaf(path, p, g, m, v, scalars, cfg)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": scalars[1]}
