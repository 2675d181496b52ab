"""Launch the hand-written Hopper WKV6 recurrence kernel (K5,
``repro_torch/csrc/wkv6.cu``) and its backward (K5-bwd,
``repro_torch/csrc/wkv6_bwd.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import CKT


def ckpt_buffer(r: torch.Tensor) -> torch.Tensor:
    """The f32 buffer of K5's state checkpoints for r's (B, L, H, K): the
    state at the start of every 16-step chunk, transposed, (B, H, ceil(L /
    16), K, K) (``ref.wkv6_ckpt_ref``'s layout)."""
    B, L, H, K = r.shape
    return torch.empty((B, H, -(-L // CKT), K, K), dtype=torch.float32,
                       device=r.device)


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s_in: torch.Tensor,
           y: torch.Tensor, s_out: torch.Tensor,
           ckpt: torch.Tensor | None = None) -> None:
    """r, k, v (B, L, H, K) of one dtype (bf16 or f32) and w (B, L, H, K)
    f32, each with unit stride in its last dim, read in place through
    their strides; u (H, K), s_in and s_out (B, H, K, K) f32, contiguous;
    y contiguous (B, L, H, K) f32; ckpt None or from ``ckpt_buffer``,
    which then gets the checkpoints. The caller has checked shapes,
    dtypes, strides and devices. One launch, nothing else."""
    dev = r.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(r, k, v, w, u, s_in, y, s_out, ckpt)
    B, L, H, K = r.shape
    fn = _build.load("wkv6")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s_in.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            0 if ckpt is None else ckpt.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "wkv6")


def launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
               ds_out: torch.Tensor | None, ckpt: torch.Tensor,
               dr: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
               dw: torch.Tensor, du: torch.Tensor, ds_in: torch.Tensor
               ) -> None:
    """r, k, v (B, L, H, K) of one dtype and w (B, L, H, K) f32, each with
    unit stride in its last dim, read through their strides; u (H, K), dy
    (B, L, H, K), ds_out (B, H, K, K, or None) and ckpt (K5's checkpoints
    of these inputs, ``ckpt_buffer``'s shape) f32 contiguous; dr, dk, dv
    (r's dtype), dw (f32) contiguous (B, L, H, K); du (H, K) and ds_in (B,
    H, K, K) f32. The caller has checked shapes, dtypes, strides and
    devices. One launch."""
    dev = r.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_bwd(r, k, v, w, u, dy, ds_out, ckpt, dr, dk, dv,
                              dw, du, ds_in)
    B, L, H, K = r.shape
    fn = _build.load("wkv6_bwd")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(),
            0 if ds_out is None else ds_out.data_ptr(), ckpt.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), ds_in.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "wkv6_bwd")
