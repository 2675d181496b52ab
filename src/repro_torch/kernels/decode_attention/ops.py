"""Wrapper around the flash-decoding kernel (K3).

For CUDA tensors ``decode_attention`` launches the hand-written kernel
(see ``kernel.py``) on the current stream, or raises; for CPU tensors it
runs the plain version in ``ref.py``. There is no fallback from one to
the other; meta tensors take the shape-only ``meta.decode_attention_meta``.
Launches are counted in ``decode_attention.launches`` (every
mode); of them, those with a value head dim other than the q/k one (MLA's
materialised decode: a port extension, held against the model layer's jnp
``decode_attention``, which takes a separate Dv) also in
``decode_attention.launches_dv``, and the other int8-KV ones in
``decode_attention.launches_int8`` (the two are disjoint). The kernel
has no backward: under grad mode with an input that requires grad it
raises (``kernels.refuse_grad``).

Unlike the Pallas wrapper, the kernel reads the cache in place in the
port's (B, Lc, Hkv, Dh) layout (no transposed or padded copy of the
cache per call), and int8 codes with f16 scales as they are stored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import meta, on_cpu, on_meta, refuse_grad
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref

DH_MAX = 256
G_MAX = 16           # query heads per kv head
Q_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q (B, H, Dh); k_cache (B, Lc, Hkv, Dh) and v_cache (B, Lc, Hkv, Dv),
    each read through its own strides, f32/bf16, or int8 codes with f16
    ``k_scale``/``v_scale`` (B, Lc, Hkv); kv_len (B,) valid lengths, read
    by the kernel as they are when int32 or int64 (the model passes
    int32). Returns (B, H, Dv) in q's dtype."""
    B, H, Dh = q.shape
    Lc, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    quant = k_scale is not None
    if quant != (v_scale is not None) or quant != (k_cache.dtype == torch.int8):
        raise ValueError("int8 caches go with both k_scale and v_scale, "
                         "and only they do")
    if on_meta(q, k_cache, v_cache, kv_len, k_scale, v_scale):
        return meta.decode_attention_meta(q, k_cache, v_cache)
    if on_cpu(q, k_cache, v_cache, kv_len, k_scale, v_scale):
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_len,
                                        k_scale=k_scale, v_scale=v_scale)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if k_cache.shape != (B, Lc, Hkv, Dh) or v_cache.shape != (B, Lc, Hkv, Dv):
        raise ValueError(f"caches must be (B, Lc, Hkv, {Dh}) and (B, Lc, Hkv, "
                         f"Dv), got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if Hkv == 0 or H % Hkv or H // Hkv > G_MAX:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}, at most "
                         f"{G_MAX} times it")
    if not (1 <= Dh <= DH_MAX and 1 <= Dv <= DH_MAX):
        raise ValueError(f"head dims {Dh}, {Dv} outside [1, {DH_MAX}]")
    if q.dtype not in Q_DTYPES or k_cache.dtype not in K.KV_KIND \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"unsupported dtypes q {q.dtype}, cache "
                        f"{k_cache.dtype}/{v_cache.dtype}")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1 \
            or q.stride(-1) != 1:
        raise ValueError("q and the k/v caches need unit stride in the head "
                         "dim")
    if quant:
        if k_scale.shape != (B, Lc, Hkv) or v_scale.shape != k_scale.shape \
                or k_scale.dtype != torch.float16 \
                or v_scale.dtype != torch.float16 \
                or v_scale.stride() != k_scale.stride():
            raise ValueError("k_scale/v_scale must be (B, Lc, Hkv) float16 "
                             "with equal strides")
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must have shape ({B},)")
    if kv_len.dtype not in (torch.int32, torch.int64) \
            or kv_len.stride(0) != 1:
        kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    K.launch(q, k_cache, v_cache, k_scale, v_scale, kv_len, out)
    decode_attention.launches += 1
    if Dv != Dh:
        decode_attention.launches_dv += 1
    elif quant:
        decode_attention.launches_int8 += 1
    return out


decode_attention.launches = 0
decode_attention.launches_int8 = 0
decode_attention.launches_dv = 0
