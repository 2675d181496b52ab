"""Plain PyTorch version of the WKV6 recurrence kernel (K5).

The exact per-step recurrence of ``repro/models/ssm.py:93``
(``rwkv6_linear_attention``), per (sequence, head):

    y_t = r_t (S_{t-1} + diag(u . k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

in f32, y before the update. The reference pads L up to a multiple of
its chunk with w = 1 and k = 0; a padded step leaves S exactly as it was
(S = 1 * S + 0) and its y is sliced away, so running the L real steps
gives the same y and the same final state. The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.

``wkv6_bwd_ref`` is the plain version of the backward kernel (K5-bwd,
``csrc/wkv6_bwd.cu``): the explicit reverse recurrence, a step loop that
autograd takes no part in.
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (B, L, H, K); v: (B, L, H, V); u: (H, K); state: (B, H, K,
    V). Every input is widened to f32. Returns (y (B, L, H, V) f32, the
    final state (B, H, K, V) f32); ``state`` is left as it was."""
    B, L, H, _ = r.shape
    S = state.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(L):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]              # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S + uf * kv))
        S = wt[..., None] * S + kv
    if not ys:
        return (torch.zeros((B, 0, H, v.shape[-1]), dtype=torch.float32,
                            device=r.device), S.clone())
    return torch.stack(ys, dim=1), S


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 dy: Optional[torch.Tensor], ds: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du, d(state)) of ``wkv6_ref`` at its
    inputs, given the cotangents of its outputs: dy (B, L, H, V) and ds
    (B, H, K, V) of the final state (None for zero). With P_t the state
    before step t and G the cotangent of P_{t+1}, for t = L-1 .. 0:

        dr_t = P_t dy_t + u k_t (dy_t . v_t)
        dk_t = u r_t (dy_t . v_t) + G v_t
        dv_t = dy_t a_t + G^T k_t,         a_t = sum_k r_t u k_t
        dw_t = rowsum(G . P_t)
        du  += sum over the batch of r_t k_t (dy_t . v_t)
        G   <- diag(w_t) G + r_t dy_t^T,   d(state) = G after step 0

    in f32, the states P_t recomputed forward first. Each gradient comes
    back in its input's dtype."""
    B, L, H, K = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    P = [state.float()]
    for t in range(L):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        P.append(wf[:, t, :, :, None] * P[t] + kv)
    G = torch.zeros_like(P[0]) if ds is None else ds.float().clone()
    dyf = torch.zeros_like(vf) if dy is None else dy.float()
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (rf, kf, vf, wf))
    du = torch.zeros_like(uf)
    for t in reversed(range(L)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
        dyv = (dyt * vt).sum(-1, keepdim=True)                  # (B, H, 1)
        a = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhv,bhkv->bhk", dyt, P[t]) + uf * kt * dyv
        dk[:, t] = uf * rt * dyv + torch.einsum("bhkv,bhv->bhk", G, vt)
        dv[:, t] = dyt * a + torch.einsum("bhkv,bhk->bhv", G, kt)
        dw[:, t] = (G * P[t]).sum(-1)
        du += (rt * kt * dyv).sum(0)
        G = wt[..., None] * G + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), G.to(state.dtype))
