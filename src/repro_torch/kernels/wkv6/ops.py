"""Wrapper around the WKV6 recurrence kernel (K5) and its backward (K5-bwd).

For CUDA tensors ``wkv6`` launches the hand-written kernel (see
``kernel.py``) on the current stream, or raises; for CPU tensors it runs
the plain step loop in ``ref.py``. There is no fallback from one to the
other. Launches are counted in ``wkv6.launches``.

Training: with grad mode on and an input that requires grad, ``wkv6``
goes through ``WKV6Fn``, whose forward is the same call that also writes
the state at the start of every 16-step chunk (K5's checkpoints, counted
in ``wkv6.launches_ckpt`` as well; ``ref.wkv6_ckpt_ref`` on CPU tensors),
and whose backward is ``wkv6_bwd`` from those checkpoints: the
hand-written kernel on CUDA tensors (``csrc/wkv6_bwd.cu``, launches
counted in ``wkv6.launches_bwd``), ``ref.wkv6_bwd_ref`` on CPU tensors.
Neither falls back to the other.

The reference has no Pallas kernel here: XLA compiles its step scan
(``repro/models/ssm.py:93``, ``rwkv6_linear_attention``) into one loop on
the TPU, where eager PyTorch would run L steps of small ops a layer. The
kernel and its backward are port extensions, held against that jnp
function and ``jax.grad`` of it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cpu
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
    (B, H, K, K) f32). Under grad with an input that requires grad, the
    call goes through ``WKV6Fn``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6Fn.apply(r, k, v, w, u.float(), state)
    return _forward(r, k, v, w, u, state)[:2]


def _forward(r, k, v, w, u, state, ckpt: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(y, the final state, and with ``ckpt`` the state at the start of
    every 16-step chunk, else None): K5's launch on CUDA tensors,
    ``ref.wkv6_ref`` (and ``ref.wkv6_ckpt_ref``) on CPU tensors."""
    if on_cpu(r, k, v, w, u, state):
        y, s_out = ref.wkv6_ref(r, k, v, w, u, state)
        return y, s_out, ref.wkv6_ckpt_ref(k, v, w, state) if ckpt else None
    B, L, H, Kd = r.shape
    _check(r, k, v, w, u, state)
    u = u.to(torch.float32).contiguous()
    s_in = state.contiguous()
    y = torch.empty((B, L, H, Kd), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s_in)
    ck = K.ckpt_buffer(r) if ckpt else None
    if B * H == 0:
        return y, s_out, ck
    K.launch(r, k, v, w, u, s_in, y, s_out, ck)
    wkv6.launches += 1
    wkv6.launches_ckpt += ckpt
    return y, s_out, ck


def _check(r, k, v, w, u, state) -> None:
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


wkv6.launches = 0           # every K5 launch
wkv6.launches_ckpt = 0      # of which with checkpoint writes (training)
wkv6.launches_bwd = 0       # every K5-bwd launch


class WKV6Fn(torch.autograd.Function):
    """The WKV6 recurrence with a hand-written backward: the forward is K5
    writing its state checkpoints too (or ``ref.wkv6_ref`` and
    ``ref.wkv6_ckpt_ref`` on CPU tensors); the backward ``wkv6_bwd`` from
    the saved inputs and checkpoints (under remat they are recomputed
    with the layer). u comes in f32 (``wkv6`` widens it outside, so
    autograd casts its gradient back)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        y, s_out, ckpt = _forward(r, k, v, w, u, state, ckpt=True)
        ctx.save_for_backward(r, k, v, w, u, state, ckpt)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds):
        *xs, ckpt = ctx.saved_tensors
        return wkv6_bwd(*xs, dy, ds, ckpt=ckpt)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
             dy: Optional[torch.Tensor], ds: Optional[torch.Tensor] = None,
             ckpt: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, d(state)) of ``wkv6`` at its inputs given the
    cotangents dy of y and ds of the final state (either None for zero),
    each in its input's dtype: on CUDA tensors one launch of K5-bwd
    (counted in ``wkv6.launches_bwd``; B, L and H at least 1) from
    ``ckpt``, the state at the start of every 16-step chunk that K5 wrote
    in ``WKV6Fn``'s forward, transposed, (B, H, ceil(L / 16), K, K) f32
    (``ref.wkv6_ckpt_ref``'s layout); given none, the
    call launches K5 with checkpoint writes first (its y and final state
    dropped). ``ref.wkv6_bwd_ref`` on CPU tensors, from ``ckpt`` where
    given. Inputs as ``wkv6`` takes them; dy and ds are made contiguous
    f32."""
    if on_cpu(r, k, v, w, u, state, dy, ds, ckpt):
        return ref.wkv6_bwd_ref(r, k, v, w, u, state, dy, ds, ckpt)
    _check(r, k, v, w, u, state)
    B, L, H, Kd = r.shape
    if ckpt is None:
        ckpt = _forward(r, k, v, w, u, state, ckpt=True)[2]
    elif (ckpt.shape != (B, H, -(-L // K.CKT), Kd, Kd)
          or ckpt.dtype != torch.float32 or ckpt.device != r.device
          or not ckpt.is_contiguous()):
        raise ValueError(f"ckpt must be contiguous float32 (B, H, "
                         f"ceil(L / {K.CKT}), K, K) = "
                         f"{(B, H, -(-L // K.CKT), Kd, Kd)} on {r.device}, "
                         f"got {tuple(ckpt.shape)} {ckpt.dtype} on "
                         f"{ckpt.device}")
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, L, H, Kd), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty((B, L, H, Kd), **f32)
    du = torch.empty((H, Kd), **f32)
    ds_in = torch.empty((B, H, Kd, Kd), **f32)
    dy = torch.zeros((B, L, H, Kd), **f32) if dy is None else \
        dy.to(torch.float32).contiguous()
    if ds is not None:
        ds = ds.to(torch.float32).contiguous()
    K.launch_bwd(r, k, v, w, u.to(torch.float32).contiguous(), dy, ds, ckpt,
                 dr, dk, dv, dw, du, ds_in)
    wkv6.launches_bwd += 1
    return dr, dk, dv, dw, du.to(u.dtype), ds_in.to(state.dtype)
