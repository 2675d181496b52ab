"""Plain PyTorch versions of the cosine top-k kernels.

They compute what the Hopper kernels compute, early-exit tile semantics
included, on any device: the CPU tests run them, and ``chip_smoke.py``
holds each kernel against them on the card. The logical tile is the
reference kernel's ``block_n = min(512, ceil128(N))``.
"""
from __future__ import annotations

import torch


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def logical_block(n: int, block_n: int = 512) -> int:
    """The reference kernel's tile: min(block_n, ceil128(N))."""
    return min(block_n, _ceil_to(max(n, 1), 128))


def _tile_padded(sims: torch.Tensor, bn: int) -> torch.Tensor:
    B, N = sims.shape
    T = -(-N // bn)
    padded = torch.full((B, max(T, 1) * bn), float("-inf"),
                        dtype=torch.float32, device=sims.device)
    padded[:, :N] = sims
    return padded


def tiles_needed(sims: torch.Tensor, thr: float, early_exit: bool,
                 block_n: int = 512) -> int:
    """How many logical tiles the sequential kernel processes: all of them,
    or with ``early_exit`` up to the first tile t > 0 before which every
    query's best so far is >= thr."""
    B, N = sims.shape
    bn = logical_block(N, block_n)
    T = -(-N // bn)
    if not early_exit or T <= 1 or not B:
        return T
    best = _tile_padded(sims, bn).view(B, -1, bn).amax(dim=2)
    done = best.cummax(dim=1).values.amin(dim=0) >= thr   # after tile t
    stop = torch.nonzero(done[:-1]).flatten()
    return int(stop[0]) + 1 if len(stop) else T


def topk_tiles(sims: torch.Tensor, k: int, thr: float, early_exit: bool,
               block_n: int = 512):
    """Top-k of masked sims (B, N) as the sequential tiled kernel sees it.

    With ``early_exit``, tile t > 0 is skipped once every query's best so
    far is >= thr; skipping is monotone, so the result is the top-k over the
    prefix of tiles before the first skip. Ties go to the lowest column (a
    stable descending sort), ``idx = -1`` where the value is not finite, and
    ``hit = best >= thr``. Returns (vals (B, k), idx (B, k) int32, hit (B,)).
    """
    B, N = sims.shape
    bn = logical_block(N, block_n)
    padded = _tile_padded(sims, bn)
    t_end = tiles_needed(sims, thr, early_exit, block_n)
    cols = padded[:, :max(t_end, 1) * bn]
    vals, idx = torch.sort(cols, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx, vals[:, 0] >= thr


def _matched(queries: torch.Tensor, rows: torch.Tensor):
    """Both operands in f32 at one width: the narrower is zero-padded on
    the right (lane-padded mirrors), which adds exactly 0.0 to each dot."""
    q, r = queries.float(), rows.float()
    w = max(q.shape[1], r.shape[1])
    q = torch.nn.functional.pad(q, (0, w - q.shape[1]))
    r = torch.nn.functional.pad(r, (0, w - r.shape[1]))
    return q, r


def cosine_topk_ref(queries: torch.Tensor, centroids: torch.Tensor,
                    k: int = 1, valid: torch.Tensor | None = None,
                    theta: float = 2.0, early_exit: bool = False,
                    block_n: int = 512):
    """queries (B, D) x centroids (N, D) f32 -> (vals, idx, hit)."""
    q, c = _matched(queries, centroids)
    sims = q @ c.T
    if valid is not None:
        sims = torch.where(valid[None, :] != 0, sims,
                           torch.full_like(sims, float("-inf")))
    thr = float(torch.tensor(theta, dtype=torch.float32))
    return topk_tiles(sims, k, thr, early_exit, block_n)


def cosine_top1_local_ref(queries: torch.Tensor, centroids: torch.Tensor,
                          valid: torch.Tensor | None = None,
                          block_n: int = 512):
    """K1 at k=1, theta 2.0, early exit off -> ((B,) best, (B,) row); a
    miss (no valid row) keeps its -inf sim at row 0, not -1."""
    vals, idx, _ = cosine_topk_ref(queries, centroids, 1, valid, 2.0, False,
                                   block_n)
    return vals[:, 0], idx[:, 0].clamp_min(0)


def cosine_topk_q8_ref(queries: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, k: int = 1,
                       valid: torch.Tensor | None = None,
                       theta: float = 2.0, margin: float = 0.0,
                       early_exit: bool = False, block_n: int = 512):
    """sim_j = (q . codes_j) * scale_j, the scale applied after the
    reduction; hit and early exit against f32(theta) + f32(margin)."""
    q, c = _matched(queries, codes)
    sims = (q @ c.T) * scales.float()[None, :]
    if valid is not None:
        sims = torch.where(valid[None, :] != 0, sims,
                           torch.full_like(sims, float("-inf")))
    thr = float(torch.tensor(theta, dtype=torch.float32)
                + torch.tensor(margin, dtype=torch.float32))
    return topk_tiles(sims, k, thr, early_exit, block_n)
