"""Each kernel's route on ``meta`` tensors: a shape-only op.

A meta input runs no kernel and computes nothing. Each wrapper sends it
here, to an op registered with ``torch.library.custom_op`` whose fake
(meta) implementation returns outputs of the kernel's shapes and dtypes
(the saved LSE and WKV6's state checkpoints included), and whose FLOPs
``torch.utils.flop_counter.FlopCounterMode`` counts by the formula
registered beside it: the kernel's own products, as PERF.md §6's bounds
count them. Attention counts the (query, key) pairs its mask lets
through (``mask_pairs``), never the masked half of a causal product;
nothing on the meta route holds a score matrix. A ragged
``kv_valid_len`` is data, which a meta tensor has not: the count takes
every key, the most the call can need. K3 counts the whole cache for the
same reason.

The ops' bodies raise: they are reached only through their meta
implementations. The dry-run (``launch/dryrun.py``) traces a step on the
meta device through these routes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

CKT = 16          # WKV6's checkpoint chunk (``wkv6.ref.CKT``)
LSE_TILE = 64     # the saved LSE's rows round up to it (``ref.lse_rows``)


def mask_pairs(Lq: int, Lkv: int, causal: bool, window: Optional[int],
               prefix_len: int, q_offset: int) -> int:
    """The (query, key) pairs ``flash_attention.ref.attention_mask`` lets
    through with no ``kv_valid_len``: query i at position q_offset + i sees
    key j when j <= its position (causal), its position - j < window, or
    j < prefix_len."""
    if Lq <= 0 or Lkv <= 0:
        return 0
    qpos = q_offset + np.arange(Lq, dtype=np.int64)
    hi = np.minimum(qpos, Lkv - 1) if causal else \
        np.full(Lq, Lkv - 1, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else \
        np.zeros(Lq, dtype=np.int64)
    base = np.maximum(hi - lo + 1, 0)
    P = min(max(prefix_len, 0), Lkv)
    # prefix keys [0, P) outside [lo, hi]
    inside = np.maximum(np.minimum(hi, P - 1) - lo + 1, 0)
    return int((base + P - inside).sum())


def _fail(name: str):
    raise RuntimeError(f"repro_torch::{name} is the meta route of a kernel "
                       f"and runs on meta tensors only")


# --------------------------------------------------------------- K4, K4-bwd

@torch.library.custom_op("repro_torch::flash_attention_meta", mutates_args=())
def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, prefix_len: int,
                         q_offset: int, with_lse: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    _fail("flash_attention_meta")


@flash_attention_meta.register_fake
def _(q, k, v, causal, window, prefix_len, q_offset, with_lse):
    B, Lq, H, _ = q.shape
    out = q.new_empty((B, Lq, H, v.shape[-1]))
    rows = -(-Lq // LSE_TILE) * LSE_TILE if with_lse else 0
    return out, q.new_empty((B, H, rows) if with_lse else (0,),
                            dtype=torch.float32)


def _pairs(q_shape, k_shape, causal, window, prefix_len, q_offset) -> int:
    return mask_pairs(q_shape[1], k_shape[1], causal, window or None,
                      prefix_len, q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
def _fa_flops(q_shape, k_shape, v_shape, causal, window, prefix_len,
              q_offset, with_lse, *args, **kwargs) -> int:
    B, _, H, Dq = q_shape
    pairs = _pairs(q_shape, k_shape, causal, window, prefix_len, q_offset)
    return 2 * B * H * pairs * (Dq + v_shape[-1])


@torch.library.custom_op("repro_torch::flash_attention_bwd_meta",
                         mutates_args=())
def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool, window: int,
                             prefix_len: int, q_offset: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    _fail("flash_attention_bwd_meta")


@flash_attention_bwd_meta.register_fake
def _(q, k, v, causal, window, prefix_len, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta)
def _fa_bwd_flops(q_shape, k_shape, v_shape, causal, window, prefix_len,
                  q_offset, *args, **kwargs) -> int:
    """S recomputed (Dq), dP (Dv), dV (Dv), dQ (Dq), dK (Dq)."""
    B, _, H, Dq = q_shape
    pairs = _pairs(q_shape, k_shape, causal, window, prefix_len, q_offset)
    return 2 * B * H * pairs * (3 * Dq + 2 * v_shape[-1])


# -------------------------------------------------------------------- K3

@torch.library.custom_op("repro_torch::decode_attention_meta",
                         mutates_args=())
def decode_attention_meta(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor) -> torch.Tensor:
    _fail("decode_attention_meta")


@decode_attention_meta.register_fake
def _(q, k_cache, v_cache):
    B, H, _ = q.shape
    return q.new_empty((B, H, v_cache.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.decode_attention_meta)
def _da_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    B, H, Dq = q_shape
    return 2 * B * H * k_shape[1] * (Dq + v_shape[-1])


# ---------------------------------------------------------------- K5, K5-bwd

@torch.library.custom_op("repro_torch::wkv6_meta", mutates_args=())
def wkv6_meta(r: torch.Tensor, state: torch.Tensor, ckpt: bool
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _fail("wkv6_meta")


@wkv6_meta.register_fake
def _(r, state, ckpt):
    B, L, H, K = r.shape
    f32 = dict(dtype=torch.float32)
    ck = r.new_empty((B, H, -(-L // CKT), K, K) if ckpt else (0,), **f32)
    return r.new_empty((B, L, H, K), **f32), \
        state.new_empty(state.shape, **f32), ck


@register_flop_formula(torch.ops.repro_torch.wkv6_meta)
def _wkv6_flops(r_shape, *args, **kwargs) -> int:
    B, L, H, K = r_shape
    return B * L * H * (5 * K * K + 5 * K)


@torch.library.custom_op("repro_torch::wkv6_bwd_meta", mutates_args=())
def wkv6_bwd_meta(r: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                  state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    _fail("wkv6_bwd_meta")


@wkv6_bwd_meta.register_fake
def _(r, w, u, state):
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(r),
            w.new_empty(r.shape, **f32), u.new_empty(u.shape, **f32),
            state.new_empty(state.shape, **f32))


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd_meta)
def _wkv6_bwd_flops(r_shape, *args, **kwargs) -> int:
    B, L, H, K = r_shape
    return 14 * B * L * H * K * K


# ------------------------------------------------------------- K1, K2

@torch.library.custom_op("repro_torch::topk_meta", mutates_args=())
def topk_meta(queries: torch.Tensor, rows: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _fail("topk_meta")


@topk_meta.register_fake
def _(queries, rows, k):
    B = queries.shape[0]
    return (queries.new_empty((B, k), dtype=torch.float32),
            queries.new_empty((B, k), dtype=torch.int32),
            queries.new_empty((B,), dtype=torch.bool))


@register_flop_formula(torch.ops.repro_torch.topk_meta)
def _topk_flops(q_shape, rows_shape, *args, **kwargs) -> int:
    return 2 * q_shape[0] * rows_shape[0] * rows_shape[1]


__all__ = ["decode_attention_meta", "flash_attention_bwd_meta",
           "flash_attention_meta", "mask_pairs", "topk_meta",
           "wkv6_bwd_meta", "wkv6_meta"]
