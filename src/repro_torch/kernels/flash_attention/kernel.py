"""Launch the hand-written Hopper prefill attention kernel (K4,
``repro_torch/csrc/flash_attention.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _strides(t: torch.Tensor) -> list[int]:
    """t's element strides for B, L, H; a dim of length 1 is given its
    contiguous stride, which addresses nothing but keeps a tensor map's
    strides aligned."""
    n_b, n_l, n_h, dh = t.shape
    dense = (n_l * n_h * dh, n_h * dh, dh)
    return [st if n > 1 else c
            for n, st, c in zip((n_b, n_l, n_h), t.stride()[:3], dense)]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, kv_valid: torch.Tensor | None, *, causal: bool,
           window: int, prefix_len: int, q_offset: int) -> None:
    """q (B, Lq, H, Dh), k/v (B, Lkv, Hkv, Dh) with unit stride in Dh, read
    in place through their strides; ``out`` contiguous (B, Lq, H, Dh) of
    q's dtype; ``kv_valid`` (B,) int32 or None; ``window`` 0 for none. The
    caller has checked shapes, dtypes and devices."""
    B, Lq, H, Dh = q.shape
    Lkv, Hkv = k.shape[1], k.shape[2]
    fn = _build.load("flash_attention")
    dev = q.device
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kv_valid.data_ptr() if kv_valid is not None else None,
                B, Lq, Lkv, H, Hkv, Dh, *_strides(q), *_strides(k),
                *_strides(v), int(causal), window, prefix_len, q_offset,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "flash_attention")
