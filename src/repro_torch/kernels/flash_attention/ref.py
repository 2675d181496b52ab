"""Plain PyTorch version of the prefill attention kernel (K4).

A port of ``repro/kernels/flash_attention/ref.py::attention_ref`` with
what the engine needs added: an explicit ``q_offset`` (default
``Lkv - Lq``, the Pallas wrapper's right-aligned queries), an optional
ragged ``kv_valid_len`` (B,) and an optional rounding of P. The mask is
the model layer's (``repro/models/layers.py:157-161,212-223``): keys past
``kv_valid_len[b]`` are masked; ``kpos <= qpos`` when causal;
``qpos - kpos < window`` when a window is set; keys before ``prefix_len``
are always visible. A fully masked row returns 0, as the Pallas kernel's
online-softmax recurrence does.

Scores, softmax and the sums are f32. With ``p_dtype`` set, the
unnormalised P is rounded to it before P·V, as the model layer and the
bf16 kernel do with the value dtype; without it P stays f32, the Pallas
kernel's form. ``models.layers.flash_attention_plain`` is this function
with ``p_dtype`` the value dtype. The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_mask(Lq: int, Lkv: int, *, causal: bool, window: Optional[int],
                   prefix_len: int, q_offset: int,
                   kv_valid_len: Optional[torch.Tensor], device
                   ) -> torch.Tensor:
    """(B or 1, Lq, Lkv) bool: True where query i may attend to key j."""
    qpos = q_offset + torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(Lkv, device=device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    if prefix_len:
        mask = mask | (kpos < prefix_len)
    mask = mask[None]
    if kv_valid_len is not None:
        ragged = kpos < kv_valid_len.to(device).long()[:, None]   # (B, Lkv)
        mask = mask & ragged[:, None, :]
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, q_offset: Optional[int] = None,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q (B, Lq, H, Dq), k (B, Lkv, Hkv, Dq), v (B, Lkv, Hkv, Dv) ->
    (B, Lq, H, Dv) in q's dtype. Head h reads kv head ``h // (H // Hkv)``."""
    B, Lq, H, Dq = q.shape
    _, Lkv, Hkv, Dv = v.shape
    if q_offset is None:
        q_offset = Lkv - Lq
    qg = q.reshape(B, Lq, Hkv, H // Hkv, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(Dq))
    mask = attention_mask(Lq, Lkv, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                        # (B,Hkv,G,Lq)
    if p_dtype is not None:
        p = p.to(p_dtype)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    l = l.permute(0, 3, 1, 2)[..., None]                     # (B,Lq,Hkv,G,1)
    out = pv / l.clamp_min(1e-37)
    return out.reshape(B, Lq, H, Dv).to(q.dtype)
