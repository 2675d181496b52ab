"""Plain PyTorch version of the flash-decoding kernel (K3).

A port of ``repro/kernels/decode_attention/ref.py::decode_attention_ref``
with the kernel's int8 mode added: int8 codes are widened to f32 and
multiplied by their f32-widened per-(position, head) scale before the dot,
the Pallas kernel's form (``kernel.py:50-52,63-65``). Scores, softmax and
P·V are f32. A sequence with ``kv_len`` 0 returns 0, as the kernels'
online-softmax recurrence does.

Two options give the reference model layer's form
(``repro/models/layers.py:252-276``), which
``models.layers.decode_attention_plain`` is: ``dequant_dtype``, the type
int8 codes are dequantised into (the model dtype there), and ``p_dtype``,
the type the normalised P is rounded to before P·V (the value dtype
there); ``window`` is the layer's sliding window. The CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dequant(x: torch.Tensor, scale: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """int8 codes * per-(position, head) scale, both widened to ``dtype``
    (the reference model's ``kv_dequant``)."""
    return x.to(dtype) * scale[..., None].to(dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         window: Optional[int] = None,
                         dequant_dtype: torch.dtype = torch.float32,
                         p_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """q (B, H, Dh); k/v cache (B, Lc, Hkv, Dh), int8 with ``k_scale`` /
    ``v_scale`` (B, Lc, Hkv); kv_len (B,). Returns (B, H, Dv) in q's dtype.
    Positions >= kv_len, and with a window those <= kv_len - 1 - window,
    are masked."""
    if k_scale is not None:
        k_cache = dequant(k_cache, k_scale, dequant_dtype)
        v_cache = dequant(v_cache, v_scale, dequant_dtype)
    B, H, Dh = q.shape
    _, Lc, Hkv, Dv = v_cache.shape
    qg = q.reshape(B, Hkv, H // Hkv, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) \
        * (1.0 / math.sqrt(Dh))
    kpos = torch.arange(Lc, device=q.device)[None, :]
    kv_len = kv_len.to(q.device).long()[:, None]
    mask = kpos < kv_len
    if window is not None:
        mask = mask & (kpos > kv_len - 1 - window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    if p_dtype is not None:
        p = p.to(p_dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return out.reshape(B, H, Dv).to(q.dtype)
