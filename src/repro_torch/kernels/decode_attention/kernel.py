"""Launch the hand-written Hopper flash-decoding kernel (K3,
``repro_torch/csrc/decode_attention.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

GENERIC_CHUNK = 256   # cache positions a split of the generic path takes
CTA_ROWS = 64         # the fast path's chunks are multiples of this (the
                      # fast path: a bf16 q with a bf16 or int8 cache at
                      # head dim 64, 128 or 256, MLA's Dv mode in bf16, or
                      # a bf16 cache at zamba2's 112, padded to 128 in
                      # shared memory)
CTAS_PER_SM = 16      # the most CTAs of 128 threads an SM holds
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# per (device index, stream): int32 arrival counters (zeroed once, left 0
# by every launch) and f32 partials, both grown on demand
_scratch: dict = {}
_n_sm: dict = {}
# the last launch's splits per (sequence, kv head); 0: the generic path
last_n_split = ctypes.c_int(0)


def split_capacity(B: int, Hkv: int, Lc: int, n_sm: int) -> int:
    """Splits per (sequence, kv head) the partials must hold: the generic
    path's ceil(Lc / 256), or the fast path's one wave of resident CTAs."""
    generic = -(-Lc // GENERIC_CHUNK)
    fast = min(-(-Lc // CTA_ROWS), CTAS_PER_SM * n_sm // max(1, B * Hkv))
    return max(1, generic, fast)


def _scratch_for(dev: torch.device, stream: int, n_count: int,
                 n_part: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    count, part = _scratch.get(key, (None, None))
    if count is None or count.numel() < n_count:
        count = torch.zeros(max(n_count, 256), dtype=torch.int32, device=dev)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    _scratch[key] = (count, part)
    return count, part


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
           kv_len: torch.Tensor, out: torch.Tensor) -> None:
    """q (B, H, Dh); k cache (B, Lc, Hkv, Dh) and v cache (B, Lc, Hkv, Dv)
    read in place, each through its own strides; scales (B, Lc, Hkv) f16
    with shared strides, or None; kv_len (B,) int32 or int64, contiguous;
    ``out`` contiguous (B, H, Dv) of q's dtype. The caller has checked
    shapes, dtypes, strides and devices. One launch (two on the generic
    path, which the dispatch in ``csrc/decode_attention.cu`` gives an f32
    q or cache, a view that is not 16-byte aligned, an int8 cache at head
    dim 112 and head dims the fast kernel has no instance for), nothing
    else: no conversion, no fill.
    ``last_n_split`` then holds the fast kernel's splits per (sequence,
    kv head), or 0 for the generic path."""
    B, H, Dh = q.shape
    Lc, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(q, k, v, k_scale, v_scale, kv_len, out)
    n_sm = _n_sm.get(dev.index)
    if n_sm is None:
        n_sm = _n_sm[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    s_cap = split_capacity(B, Hkv, Lc, n_sm)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count, part = _scratch_for(dev, stream, B * Hkv,
                               B * Hkv * s_cap * (H // Hkv) * (Dv + 2))
    sstride = k_scale.stride() if k_scale is not None else (0, 0, 0)
    fn = _build.load("decode_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
            count.data_ptr(), ctypes.addressof(last_n_split), B, H, Hkv,
            Dh, Dv, Lc, q.stride(0), q.stride(1), *k.stride()[:3],
            *v.stride()[:3], *sstride,
            s_cap,
            int(q.dtype == torch.bfloat16), KV_KIND[k.dtype],
            int(kv_len.dtype == torch.int64), stream)
    _build.check_rc(rc, "decode_attention")
