"""Launch the hand-written Hopper prefill attention kernel (K4,
``repro_torch/csrc/flash_attention.cu``) and its backward's kernels
(``repro_torch/csrc/flash_attention_bwd.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# the C entry point's 30 int64 arguments, packed into one bytes object
_ARGS = struct.Struct("30q")


def _strides(t: torch.Tensor) -> list[int]:
    """t's element strides for B, L, H, D; a dim of length 1 is given its
    contiguous stride, which addresses nothing but keeps a tensor map's
    strides aligned."""
    n_b, n_l, n_h, dh = t.shape
    dense = (n_l * n_h * dh, n_h * dh, dh)
    return [st if n > 1 else c
            for n, st, c in zip((n_b, n_l, n_h), t.stride()[:3], dense)] + [1]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, kv_valid: torch.Tensor | None, *, causal: bool,
           window: int, prefix_len: int, q_offset: int,
           strides: tuple, entry=None, lse: torch.Tensor | None = None
           ) -> None:
    """q (B, Lq, H, Dq), k (B, Lkv, Hkv, Dq), v (B, Lkv, Hkv, Dv), each
    with unit stride in its head dim, read in place through their strides;
    ``out`` contiguous (B, Lq, H, Dv) of q's dtype; ``kv_valid`` (B,)
    int32 or None; ``window`` 0 for none. The
    caller has checked shapes, dtypes and devices, and read ``strides``,
    ``q.stride() + k.stride() + v.stride()``: the f32 kernels take them as
    they are (and ignore those of dims of length 1), the bf16 tensor maps
    take ``_strides``. ``entry``: another C entry point of the library
    with the same arguments (``tools/trace_kernels.py``'s unrouted
    probe); default the routed one. ``lse``: None, or a training call's
    (B, H, Lq rounded up to 64) f32 buffer (``bwd_scratch``'s) that the
    kernel fills with each row's LSE for the backward (bf16 at Dq in (64,
    96] with Dv <= 64 alone: ``flash_bf16_persistent_lse``)."""
    fn = entry or _build.load("flash_attention")
    index = q.device.index
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return launch(q, k, v, out, kv_valid, causal=causal,
                          window=window, prefix_len=prefix_len,
                          q_offset=q_offset, strides=strides, entry=entry,
                          lse=lse)
    B, Lq, H, Dq = q.shape
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        strides = (*_strides(q), *_strides(k), *_strides(v))
    rc = fn(_ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(),
                       0 if kv_valid is None else kv_valid.data_ptr(),
                       B, Lq, k.shape[1], H, k.shape[2], Dq, v.shape[3],
                       *strides, causal, window, prefix_len, q_offset,
                       is_bf16, 0 if lse is None else lse.data_ptr()),
            # torch.cuda.current_stream(dev).cuda_stream, without building
            # a Stream object
            torch._C._cuda_getCurrentRawStream(index))
    _build.check_rc(rc, "flash_attention")


def bwd_scratch(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's (B, H, Lq) f32 scratch for LSE and D, which (a)
    writes and (b) reads; in bf16 (the wgmma pairs) Lq is rounded up to
    the kernels' 64-row q tile, whose rows past Lq (a) fills, so that (b)
    loads whole tiles."""
    B, Lq, H, _ = q.shape
    if q.dtype == torch.bfloat16:
        Lq = ref.lse_rows(Lq)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    return lse, torch.empty_like(lse)


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, do: torch.Tensor, dq: torch.Tensor,
               dk: torch.Tensor, dv: torch.Tensor,
               lse: torch.Tensor | None, dsum: torch.Tensor | None, *,
               causal: bool, window: int, prefix_len: int, q_offset: int,
               part: int, scale_dim: int | None = None,
               kv_valid_len: torch.Tensor | None = None) -> None:
    """One of the backward's kernels (``csrc/flash_attention_bwd.cu``):
    ``part`` 0 (a) writes dq, ``lse`` and ``dsum``; ``part`` 1 (b) reads
    them and writes dk and dv; ``part`` 2, the f32 one-pass kernel, writes
    dq, dk and dv and takes no ``lse`` or ``dsum`` (None); ``part`` 3, (a)
    from a saved LSE (bf16 at Dq in (64, 96] with Dv <= 64 alone), reads
    ``lse`` (as K4's training forward wrote it) and writes dq and
    ``dsum``. Every tensor
    contiguous: q, dq (B, Lq, H, Dq); o, do (B, Lq, H, Dv); k, dk (B, Lkv,
    Hkv, Dq); v, dv (B, Lkv, Hkv, Dv); lse, dsum from ``bwd_scratch``; in
    bf16 each 16-byte aligned with Dq and Dv multiples of 8 (the tensor
    maps'). ``window`` 0 for none; the scale is 1 /
    sqrt(``scale_dim``) (default Dq); ``kv_valid_len`` (B,) int32
    contiguous, or None: keys of row b at or past it are masked. The
    caller has checked shapes, dtypes and devices."""
    fn = _build.load("flash_attention_bwd")
    index = q.device.index
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return launch_bwd(q, k, v, o, do, dq, dk, dv, lse, dsum,
                              causal=causal, window=window,
                              prefix_len=prefix_len, q_offset=q_offset,
                              part=part, scale_dim=scale_dim,
                              kv_valid_len=kv_valid_len)
    B, Lq, H, D = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            0 if lse is None else lse.data_ptr(),
            0 if dsum is None else dsum.data_ptr(),
            0 if kv_valid_len is None else kv_valid_len.data_ptr(),
            B, Lq, k.shape[1], H,
            k.shape[2], D, v.shape[3], scale_dim or D, int(causal), window,
            prefix_len, q_offset, int(q.dtype == torch.bfloat16), part,
            torch._C._cuda_getCurrentRawStream(index))
    _build.check_rc(rc, "flash_attention_bwd")
