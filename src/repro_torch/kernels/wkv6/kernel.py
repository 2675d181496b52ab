"""Launch the hand-written Hopper WKV6 recurrence kernel (K5,
``repro_torch/csrc/wkv6.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s_in: torch.Tensor,
           y: torch.Tensor, s_out: torch.Tensor) -> None:
    """r, k, v (B, L, H, K) of one dtype (bf16 or f32) and w (B, L, H, K)
    f32, each with unit stride in its last dim, read in place through
    their strides; u (H, K), s_in and s_out (B, H, K, K) f32, contiguous;
    y contiguous (B, L, H, K) f32. The caller has checked shapes, dtypes,
    strides and devices. One launch, nothing else."""
    dev = r.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(r, k, v, w, u, s_in, y, s_out)
    B, L, H, K = r.shape
    fn = _build.load("wkv6")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s_in.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "wkv6")
