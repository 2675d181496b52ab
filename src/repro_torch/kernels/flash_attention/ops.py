"""Wrapper around the prefill attention kernel (K4).

For CUDA tensors ``flash_attention`` launches the hand-written kernel (see
``kernel.py``) on the current stream, or raises; for CPU tensors it runs
the plain version in ``ref.py`` with P rounded to v's dtype before P·V,
as the bf16 kernel does. There is no fallback from one to the
other. A bf16 view that TMA cannot describe raises ``ValueError``
(``tma_layout_check``); an f32 view of any strides is read in place (16
bytes at a time where it is 16-byte aligned, else 4). Launches are counted
in ``flash_attention.launches``, the f32 ones also in
``flash_attention.launches_f32``.

Unlike the Pallas wrapper, the kernel reads q/k/v in the (B, L, H, Dh)
layout through their strides (no transposed or padded copies), and takes
an explicit ``q_offset`` and a ragged ``kv_valid_len``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cpu
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref

DH_MAX = 256
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0, q_offset: Optional[int] = None,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B, Lq, H, Dh), k/v (B, Lkv, Hkv, Dh) -> (B, Lq, H, Dh) in q's
    dtype. ``q_offset`` is the position of q[:, 0] (default ``Lkv - Lq``,
    right-aligned queries); ``kv_valid_len`` (B,) masks keys at or past it.
    The mask is ``ref.attention_mask``'s."""
    B, Lq, H, Dh = q.shape
    Lkv, Hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = Lkv - Lq
    if on_cpu(q, k, v, kv_valid_len):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len,
                                 p_dtype=v.dtype)
    dtype = q.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q/k/v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, Lkv, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, Lkv, Hkv, {Dh}) like q's batch and "
                         f"head dim, got {tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    if not 1 <= Dh <= DH_MAX:
        raise ValueError(f"head dim {Dh} outside [1, {DH_MAX}]")
    strides = q.stride() + k.stride() + v.stride()
    if strides[3] != 1 or strides[7] != 1 or strides[11] != 1:
        raise ValueError("q/k/v need unit stride in the head dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if kv_valid_len is not None:
        if kv_valid_len.shape != (B,):
            raise ValueError(f"kv_valid_len must have shape ({B},)")
        kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    if dtype == torch.bfloat16:
        tma_layout_check(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if not (B and Lq and H):
        return out
    K.launch(q, k, v, out, kv_valid_len, causal=causal,
             window=window or 0, prefix_len=prefix_len, q_offset=q_offset,
             strides=strides)
    flash_attention.launches += 1
    if dtype == torch.float32:
        flash_attention.launches_f32 += 1
    return out


flash_attention.launches = 0        # every K4 launch
flash_attention.launches_f32 = 0    # of which f32 (the embedder's)


def tma_layout_check(*tensors: torch.Tensor) -> None:
    """The bf16 kernel reads q/k/v through TMA tensor maps, which take
    16-byte aligned base addresses and byte strides that are multiples of
    16: a head dim that is a multiple of 8, and B/L/H strides (of dims
    longer than 1) that are positive multiples of 8 elements. Anything else
    raises; it is never sent to another kernel."""
    for name, t in zip("qkv", tensors):
        bad = [f"stride {st} of dim {i}" for i, (n, st) in
               enumerate(zip(t.shape[:3], t.stride()[:3]))
               if n > 1 and (st <= 0 or st % 8)]
        if t.shape[3] % 8:
            bad.append(f"head dim {t.shape[3]}")
        if t.data_ptr() % 16:
            bad.append(f"base address {t.data_ptr():#x}")
        if bad:
            raise ValueError(
                f"bf16 flash_attention reads {name} through a TMA tensor map, "
                f"which needs a 16-byte aligned base, a head dim that is a "
                f"multiple of 8 and B/L/H strides that are multiples of 8 "
                f"elements (16 bytes); {name} has " + ", ".join(bad))
