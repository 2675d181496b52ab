"""Launch the hand-written Hopper flash-decoding kernel (K3,
``repro_torch/csrc/decode_attention.cu``), built and bound by
``repro_torch.kernels._build``. Nothing here runs at import time."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 256          # cache positions per split (CHUNK in the source)
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def n_splits(Lc: int) -> int:
    return max(1, -(-Lc // CHUNK))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
           kv_len: torch.Tensor, out: torch.Tensor) -> None:
    """q (B, H, Dh); caches (B, Lc, Hkv, Dh) read in place through their
    (shared) strides; scales (B, Lc, Hkv) f16 with shared strides, or None;
    kv_len (B,) int32; ``out`` contiguous (B, H, Dh) of q's dtype. The
    caller has checked shapes, dtypes, strides and devices."""
    B, H, Dh = q.shape
    Lc, Hkv = k.shape[1], k.shape[2]
    S = n_splits(Lc)
    G = H // Hkv
    dev = q.device
    part_ml = torch.empty((B, Hkv, S, G, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, Hkv, S, G, Dh), dtype=torch.float32,
                           device=dev)
    sstride = k_scale.stride() if k_scale is not None else (0, 0, 0)
    fn = _build.load("decode_attention")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr() if k_scale is not None else None,
                v_scale.data_ptr() if v_scale is not None else None,
                kv_len.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                part_acc.data_ptr(), B, H, Hkv, Dh, Lc, q.stride(0),
                q.stride(1), *k.stride()[:3], *sstride, S,
                int(q.dtype == torch.bfloat16), KV_KIND[k.dtype], CHUNK,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(rc, "decode_attention")
