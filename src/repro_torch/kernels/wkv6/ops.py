"""Wrapper around the WKV6 recurrence kernel (K5).

For CUDA tensors ``wkv6`` launches the hand-written kernel (see
``kernel.py``) on the current stream, or raises; for CPU tensors it runs
the plain step loop in ``ref.py``. There is no fallback from one to the
other. Launches are counted in ``wkv6.launches``. The kernel has no
backward yet: under grad mode with an input that requires grad it raises
(``kernels.refuse_grad``); the plain loop differentiates.

The reference has no Pallas kernel here: XLA compiles its step scan
(``repro/models/ssm.py:93``, ``rwkv6_linear_attention``) into one loop on
the TPU, where eager PyTorch would run L steps of small ops a layer. The
kernel is a port extension, held against that jnp function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cpu, refuse_grad
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6 import ref

K_MAX = 64
DTYPES = (torch.float32, torch.bfloat16)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, L, H, K) in bf16 or f32, read in place through their
    strides (unit stride in the last dim); w: (B, L, H, K) f32 decay; u:
    (H, K) bonus, widened to f32; state: (B, H, K, K) f32, read, not
    written. K = V <= 64. Returns (y (B, L, H, K) f32, the final state
    (B, H, K, K) f32)."""
    if on_cpu(r, k, v, w, u, state):
        return ref.wkv6_ref(r, k, v, w, u, state)
    refuse_grad("wkv6", r, k, v, w, u, state)
    B, L, H, Kd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, v and w must all be (B, L, H, K), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    if u.shape != (H, Kd) or state.shape != (B, H, Kd, Kd):
        raise ValueError(f"u must be ({H}, {Kd}) and state ({B}, {H}, {Kd}, "
                         f"{Kd}), got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    if not 1 <= Kd <= K_MAX:
        raise ValueError(f"head dim {Kd} outside [1, {K_MAX}]")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must all be float32 or all bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"w and state must be float32, got {w.dtype}, "
                        f"{state.dtype}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("r, k, v and w need unit stride in the head dim")
    u = u.to(torch.float32).contiguous()
    s_in = state.contiguous()
    y = torch.empty((B, L, H, Kd), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s_in)
    if B * H == 0:
        return y, s_out
    K.launch(r, k, v, w, u, s_in, y, s_out)
    wkv6.launches += 1
    return y, s_out


wkv6.launches = 0
