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

``wkv6_ckpt_ref`` is the plain version of K5's checkpoints: the state at
the start of every 16-step chunk, transposed, which K5 writes for its
backward.
``wkv6_bwd_ref`` is the plain version of the backward kernel (K5-bwd,
``csrc/wkv6_bwd.cu``): the explicit reverse recurrence, a step loop that
autograd takes no part in, which restarts its states at given
checkpoints.
"""
from __future__ import annotations

from typing import Optional

import torch

CKT = 16        # steps between two state checkpoints (K5's, csrc/wkv6_common.cuh)


def _step(S: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
          wt: torch.Tensor) -> torch.Tensor:
    """The state after one step, S (B, H, K, V) f32 and the step's f32 k,
    v, w (B, H, K or V): the one expression of the update that the
    checkpoints and the backward's recomputed states share, so that both
    are the same bits."""
    return wt[..., None] * S + kt[..., :, None] * vt[..., None, :]


def wkv6_ckpt_ref(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor) -> torch.Tensor:
    """The state at the start of every CKT-step chunk, transposed (K5's
    layout: a column's K rows contiguous): (B, H, ceil(L / CKT), V, K) f32,
    chunk 0's the state carried in. k, w (B, L, H, K), v (B, L, H, V) and
    state (B, H, K, V) are widened to f32."""
    L = k.shape[1]
    S = state.float()
    out = []
    for t in range(L):
        if t % CKT == 0:
            out.append(S)
        S = _step(S, k[:, t].float(), v[:, t].float(), w[:, t].float())
    if not out:
        return torch.zeros((*S.shape[:2], 0, *S.shape[2:][::-1]),
                           dtype=torch.float32, device=S.device)
    return torch.stack(out, dim=2).transpose(-1, -2).contiguous()


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
                 dy: Optional[torch.Tensor], ds: Optional[torch.Tensor] = None,
                 ckpt: Optional[torch.Tensor] = None
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

    in f32, the states P_t recomputed forward first: from ``state``, or
    with ``ckpt`` (``wkv6_ckpt_ref``'s layout) from each chunk's
    checkpoint, which gives the same bits where the checkpoints are
    ``wkv6_ckpt_ref``'s of these inputs. Each gradient comes back in its
    input's dtype."""
    B, L, H, K = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    P = [state.float()]
    for t in range(L):
        if ckpt is not None and t % CKT == 0:
            P[t] = ckpt[:, :, t // CKT].float().transpose(-1, -2) \
                .contiguous()
        P.append(_step(P[t], kf[:, t], vf[:, t], wf[:, t]))
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
