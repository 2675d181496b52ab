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
"""
from __future__ import annotations

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
