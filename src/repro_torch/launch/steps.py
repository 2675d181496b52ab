"""Step builders (port of ``repro/launch/steps.py``): the train step
(forward, chunked cross-entropy, backward, AdamW), the prefill step and
the decode step over the port's ``lm``.

The chunked cross-entropy never holds (B, L, vocab) logits for the
backward: the final features are unembedded one sequence chunk at a
time, in f32, and each chunk is recomputed in the backward
(``torch.utils.checkpoint``), so only one chunk's logits are alive.

Every (architecture x input shape) cell lowers one of three steps:
train_4k -> the train step (on a mesh, ``distributed.sharded_train``'s
sharded step), prefill_32k -> the prefill step, decode_32k / long_500k ->
the decode step. The shape structs (``batch_struct``, ``params_struct``,
``opt_struct``, ``cache_struct``, ``input_specs``) are tensors on the
``meta`` device: shapes and dtypes, nothing allocated (the full
deepseek-v2-236b tree included). ``CellPolicy`` carries each cell's
distribution knobs, and ``cell_shardings`` the step, the placement of its
inputs and outputs and its donated arguments.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig, \
    get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import data_axes
from repro_torch.models import lm
from repro_torch.training import optimizer as opt


def _chunk_ce(params, cfg: ModelConfig, fc: torch.Tensor,
              yc: torch.Tensor) -> torch.Tensor:
    """Summed next-token CE of one chunk: f32 logits (pad columns at the
    dtype's minimum, ``lm.unembed``), logsumexp minus the gold logit."""
    logits = lm.unembed(params, cfg, fc).float()
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_ce_loss(params, cfg: ModelConfig, batch: dict,
                    chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean next-token CE over the (B, L) labels + 0.01 x the MoE aux
    loss, the aux loss). The VLM's loss covers its text positions. The
    chunk halves until it divides L (the VLM's text span may be odd)."""
    feats, aux, prefix_len = lm.forward_features(params, cfg, batch)
    if cfg.family == "vlm":
        feats = feats[:, prefix_len:]
    labels = batch["labels"]
    B, L, _ = feats.shape
    chunk = min(chunk, L)
    while L % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for c in range(0, L, chunk):
        fc, yc = feats[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_ce, params, cfg, fc, yc,
                                       use_reentrant=False)
        else:
            total = total + _chunk_ce(params, cfg, fc, yc)
    loss = total / (B * L)
    return loss + 0.01 * aux, aux


def value_and_grad(loss_fn, params):
    """(``loss_fn(params)`` detached, its gradient: a tree like ``params``,
    each leaf in its parameter's dtype, zeros where the loss does not
    reach it), as ``jax.value_and_grad``. The leaves require grad only
    within the call."""
    leaves = [p for _, p in opt.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    flat = iter(torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, flat))
    return loss.detach(), opt.tree_map(lambda _: next(flat), params)


def make_train_step(cfg: ModelConfig, accum: int = 1,
                    optc: Optional[opt.AdamWConfig] = None,
                    ce_chunk: int = 512):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics
    {"loss", "grad_norm", "lr"}). With ``accum`` > 1 the batch is split
    along its first dim into that many microbatches, their gradients
    summed in f32 and divided by ``accum``, as the loss. The parameters
    and moments are updated in place (``opt.apply_updates``)."""
    optc = optc or opt.AdamWConfig()

    def loss_grads(params, batch):
        return value_and_grad(
            lambda p: chunked_ce_loss(p, cfg, batch, ce_chunk)[0], params)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = loss_grads(params, batch)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = opt.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses = []
            for i in range(accum):
                l_i, g_i = loss_grads(params, {k: v[i] for k, v in
                                               micro.items()})
                opt.tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
                losses.append(l_i)
                del g_i
            grads = opt.tree_map(lambda g: g / accum, grads)
            loss = sum(losses[1:], losses[0]) / accum
        params, opt_state, metrics = opt.apply_updates(params, grads,
                                                       opt_state, optc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return lm.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos, kv_len):
        return lm.decode_step(params, cfg, tokens, cache, pos, kv_len)

    return decode_step


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 with_labels: bool) -> dict:
    B, L = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {}
    if cfg.family == "vlm":
        Ltxt = L - cfg.prefix_len
        batch["tokens"] = _sds((B, Ltxt), torch.int32)
        batch["patch_embed"] = _sds((B, cfg.prefix_len, cfg.d_model),
                                    torch.float32)
        if with_labels:
            batch["labels"] = _sds((B, Ltxt), torch.int32)
        return batch
    batch["tokens"] = _sds((B, L), torch.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = _sds((B, cfg.enc_len, cfg.d_model), torch.float32)
    if with_labels:
        batch["labels"] = _sds((B, L), torch.int32)
    return batch


_PARAMS_STRUCTS: dict = {}


def params_struct(cfg: ModelConfig):
    """``lm.init_params``' tree on the meta device (no generator draws),
    built once per configuration (a fresh tree of the same meta
    tensors each call)."""
    key = repr(cfg)
    if key not in _PARAMS_STRUCTS:
        _PARAMS_STRUCTS[key] = lm.init_params(None, cfg, _META)
    return opt.tree_map(lambda x: x, _PARAMS_STRUCTS[key])


def opt_struct(params, moment_dtype: str = "float32") -> opt.AdamWState:
    return opt.init_state(params, moment_dtype=moment_dtype)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    return lm.init_cache(cfg, batch, max_len, device=_META)


def input_specs(arch: str, shape_name: str,
                policy: Optional["CellPolicy"] = None, *,
                cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None) -> dict:
    """All inputs for the cell's step, as meta tensors keyed by the
    step's argument names. A policy with kv_dtype changes the cache
    structure, so pass the same policy used for cell_shardings. ``cfg``
    and ``shape`` replace the registry's, as in ``cell_shardings``."""
    cfg = cfg or get_config(arch)
    if policy is not None and policy.kv_dtype:
        cfg = cfg.replace(kv_dtype=policy.kv_dtype)
    shape = shape or SHAPES[shape_name]
    params = params_struct(cfg)
    if shape.kind == "train":
        mdt = policy.moment_dtype if policy is not None else "float32"
        return {"params": params, "opt_state": opt_struct(params, mdt),
                "batch": batch_struct(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_struct(cfg, shape, with_labels=False),
                "cache": cache_struct(cfg, shape.global_batch,
                                      shape.seq_len)}
    # decode: one new token against a seq_len cache
    B = shape.global_batch
    return {"params": params,
            "tokens": _sds((B, 1), torch.int32),
            "cache": cache_struct(cfg, B, shape.seq_len),
            "pos": _sds((), torch.int32),
            "kv_len": _sds((B,), torch.int32)}


# ---------------------------------------------------------------------------
# per-cell policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellPolicy:
    accum: int = 1                      # grad-accum microbatches (train)
    ce_chunk: int = 512                 # CE seq chunk
    cache_seq_axes: tuple = ("model",)  # decode KV-seq sharding axes
    expert_data: bool = False           # serve-mode 2D MoE sharding
    remat: bool = True                  # activation checkpointing (train)
    donate: bool = True
    moe_chunk_tokens: int = 0           # token-chunked MoE dispatch
    moe_impl: str = ""                  # "" = config default; "shard_map"
    kv_dtype: str = ""                  # e.g. "int8" quantized KV
    bf16_boundary: bool = False         # bf16 cotangents at block edges
    fsdp_pod: bool = False              # FSDP over ("pod","data")
    moment_dtype: str = "float32"       # AdamW moment storage


# the reference's grad-accum microbatches per train cell
_TRAIN_ACCUM = {
    "qwen3-14b": 8, "command-r-35b": 16, "qwen2.5-14b": 8, "minicpm3-4b": 8,
    "rwkv6-7b": 8, "mixtral-8x7b": 8, "deepseek-v2-236b": 16,
    "zamba2-7b": 16, "paligemma-3b": 2, "whisper-base": 1,
}

# per-cell overrides applied on top of the defaults
_OVERRIDES: dict[tuple[str, str], dict] = {}

# the reference's tuned configurations of five cells
OPTIMIZED: dict[tuple[str, str], dict] = {
    ("mixtral-8x7b", "prefill_32k"): dict(moe_impl="shard_map",
                                          moe_chunk_tokens=16384),
    ("mixtral-8x7b", "train_4k"): dict(moe_impl="shard_map"),
    ("deepseek-v2-236b", "train_4k"): dict(moe_impl="shard_map", accum=8,
                                           fsdp_pod=True,
                                           moment_dtype="bfloat16"),
    ("deepseek-v2-236b", "prefill_32k"): dict(moe_impl="shard_map",
                                              moe_chunk_tokens=16384),
    ("qwen3-14b", "decode_32k"): dict(kv_dtype="int8"),
}


def optimized_policy(arch: str, shape_name: str) -> CellPolicy:
    base = cell_policy(arch, shape_name)
    kw = OPTIMIZED.get((arch, shape_name))
    return replace(base, **kw) if kw else base


def cell_policy(arch: str, shape_name: str) -> CellPolicy:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    kw: dict[str, Any] = {}
    if shape.kind == "train":
        kw["accum"] = _TRAIN_ACCUM.get(arch, 1)
    if shape.kind == "decode":
        kw["cache_seq_axes"] = (("data", "model")
                                if shape.global_batch == 1 else ("model",))
    if shape.kind != "train" and cfg.is_moe and cfg.n_experts % 16 == 0:
        kw["expert_data"] = True        # deepseek-v2: 445 GB expert bytes
    kw.update(_OVERRIDES.get((arch, shape_name), {}))
    return CellPolicy(**kw)


def set_override(arch: str, shape_name: str, **kw) -> None:
    _OVERRIDES[(arch, shape_name)] = {
        **_OVERRIDES.get((arch, shape_name), {}), **kw}


# ---------------------------------------------------------------------------
# shardings per cell
# ---------------------------------------------------------------------------


def _dp_size(mesh, dp) -> int:
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    return n


def cell_shardings(arch: str, shape_name: str, mesh,
                   policy: Optional[CellPolicy] = None, *,
                   cfg: Optional[ModelConfig] = None,
                   shape: Optional[ShapeConfig] = None):
    """(step, in_shardings dict, out_shardings, donate_argnames) aligned
    with input_specs(arch, shape_name). A train cell's step is the sharded
    train step over ``mesh`` (``distributed.sharded_train``), on inputs
    placed by ``in_shardings``; a serving cell's is the one-device prefill
    or decode step, and its shardings are the reference's placements.
    ``cfg`` and ``shape`` replace the registry's (a cut configuration, a
    shape of the caller's; ``policy`` then defaults to ``CellPolicy()``)."""
    from repro_torch.distributed.sharded_train import \
        make_sharded_train_step
    from repro_torch.models.layers import set_bf16_boundary, set_shard_mesh
    pol = policy or (cell_policy(arch, shape_name)
                     if cfg is None and shape is None else CellPolicy())
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if not pol.remat and shape.kind == "train":
        cfg = cfg.replace(remat=False)
    dp = data_axes(mesh)
    cfg = cfg.replace(act_dp=dp)       # the MoE's data shards
    set_shard_mesh(mesh)
    set_bf16_boundary(pol.bf16_boundary)
    if pol.moe_chunk_tokens:
        cfg = cfg.replace(moe_chunk_tokens=pol.moe_chunk_tokens)
    if pol.moe_impl:
        cfg = cfg.replace(moe_impl=pol.moe_impl)
    if pol.kv_dtype:
        cfg = cfg.replace(kv_dtype=pol.kv_dtype)
    ns = lambda specs: shd.named(mesh, specs)
    pstruct = params_struct(cfg)

    if shape.kind == "train":
        fsdp_axes = (("pod", "data") if pol.fsdp_pod and "pod" in dp
                     else ("data",))
        pspecs = shd.param_specs(pstruct, cfg, fsdp=True,
                                 fsdp_axes=fsdp_axes)
        ospecs = shd.opt_state_specs(None, pspecs)
        bspecs = shd.batch_specs(cfg, "train", dp)
        step = make_sharded_train_step(
            cfg, mesh, accum=pol.accum, ce_chunk=pol.ce_chunk,
            optc=opt.AdamWConfig(moment_dtype=pol.moment_dtype))
        in_sh = {"params": ns(pspecs), "opt_state": ns(ospecs),
                 "batch": ns(bspecs)}
        metrics_sh = {k: shd.NamedSharding(mesh, shd.P())
                      for k in ("loss", "grad_norm", "lr")}
        out_sh = (ns(pspecs), ns(ospecs), metrics_sh)
        return step, in_sh, out_sh, ("params", "opt_state")

    # serving: no backward pass
    cfg = cfg.replace(remat=False)
    pspecs = shd.param_specs(pstruct, cfg, fsdp=False,
                             expert_data=pol.expert_data)
    dp_ax = shd._dp_axis(dp)

    if shape.kind == "prefill":
        bspecs = shd.batch_specs(cfg, "prefill", dp)
        cstruct = cache_struct(cfg, shape.global_batch, shape.seq_len)
        cspecs = shd.cache_spec_tree(cstruct, cfg, dp,
                                     seq_axes=pol.cache_seq_axes)
        step = make_prefill_step(cfg)
        in_sh = {"params": ns(pspecs), "batch": ns(bspecs),
                 "cache": ns(cspecs)}
        logits_sh = shd.NamedSharding(mesh, shd.P(dp_ax, "model"))
        return step, in_sh, (logits_sh, ns(cspecs)), ("cache",)

    # decode
    B = shape.global_batch
    dp_eff = dp if B % max(_dp_size(mesh, dp), 1) == 0 and B > 1 else ()
    dp_ax = shd._dp_axis(dp_eff)
    cfg = cfg.replace(act_dp=dp_eff)
    cstruct = cache_struct(cfg, B, shape.seq_len)
    cspecs = shd.cache_spec_tree(cstruct, cfg, dp_eff,
                                 seq_axes=pol.cache_seq_axes)
    step = make_decode_step(cfg)
    in_sh = {"params": ns(pspecs),
             "tokens": shd.NamedSharding(mesh, shd.P(dp_ax, None)),
             "cache": ns(cspecs),
             "pos": shd.NamedSharding(mesh, shd.P()),
             "kv_len": shd.NamedSharding(mesh, shd.P(dp_ax))}
    logits_sh = shd.NamedSharding(mesh, shd.P(dp_ax, "model"))
    return step, in_sh, (logits_sh, ns(cspecs)), ("cache",)


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    return cfg.skip_shapes.get(shape_name)
