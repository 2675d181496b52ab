"""Launch the hand-written Hopper WKV6 recurrence kernel (K5,
``repro_torch/csrc/wkv6.cu``) and its backward (K5-bwd,
``repro_torch/csrc/wkv6_bwd.cu``), built and bound by
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


BWD_TT = 16     # csrc/wkv6_bwd.cu: the steps between two state checkpoints


def bwd_scratch(r: torch.Tensor) -> torch.Tensor:
    """K5-bwd's f32 scratch of state checkpoints: for each (sequence, head)
    and 32-column group, the K_P x 32 state slice (K_P: K rounded up to 8)
    at the start of every 16-step chunk."""
    B, L, H, K = r.shape
    kp, ng, nc = -(-K // 8) * 8, -(-K // 32), -(-L // BWD_TT)
    return torch.empty(B * H * ng * nc * kp * 32, dtype=torch.float32,
                       device=r.device)


def launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s_in: torch.Tensor,
               dy: torch.Tensor, ds_out: torch.Tensor | None,
               dr: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
               dw: torch.Tensor, du: torch.Tensor, ds_in: torch.Tensor,
               ckpt: torch.Tensor) -> None:
    """r, k, v (B, L, H, K) of one dtype and w (B, L, H, K) f32, each with
    unit stride in its last dim, read through their strides; u (H, K),
    s_in (B, H, K, K), dy (B, L, H, K) and ds_out (B, H, K, K, or None) f32
    contiguous; dr, dk, dv (r's dtype), dw (f32) contiguous (B, L, H, K);
    du (H, K) and ds_in (B, H, K, K) f32; ckpt from ``bwd_scratch``. The
    caller has checked shapes, dtypes, strides and devices. One launch."""
    dev = r.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_bwd(r, k, v, w, u, s_in, dy, ds_out, dr, dk, dv,
                              dw, du, ds_in, ckpt)
    B, L, H, K = r.shape
    fn = _build.load("wkv6_bwd")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s_in.data_ptr(), dy.data_ptr(),
            0 if ds_out is None else ds_out.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds_in.data_ptr(), ckpt.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "wkv6_bwd")
