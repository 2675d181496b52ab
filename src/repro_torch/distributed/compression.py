"""Gradient compression for the data-parallel all-reduce (port of
``repro/distributed/compression.py``, DESIGN.md §6).

Two schemes, over lists of per-rank trees (rank r's tree on its own
device), where the reference runs inside ``shard_map``:

* int8 quantized all-reduce — per-tensor symmetric quantization before the
  wire, dequantize + average after;
* top-k sparsification with error feedback — keep the k largest-|g|
  entries, accumulate the residual locally so dropped mass is re-sent in
  later steps.

The sums over ranks are :func:`ring_allreduce_schedule`'s. As in the
reference, ``launch/train.py`` parses ``--grad-compression`` and does not
use it.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.distributed.collectives import ring_allreduce_schedule
from repro_torch.training.optimizer import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# int8 symmetric quantization
# ---------------------------------------------------------------------------


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes, f32 scale). Symmetric, per-tensor,
    rounding half to even."""
    scale = _scale(x.abs().max().float())
    return _codes(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(trees: Sequence[Any]) -> list:
    """int8-compressed mean over ranks of ``trees`` (one tree a rank).

    The ranks first agree on a GLOBAL scale (the maximum of their |x|
    maxima: summing codes quantized under different scales would be
    wrong), then sum their int32 codes around the ring and dequantize
    once. Returns the mean, one tree a rank (the same bits on each), in
    each leaf's dtype."""
    size = len(trees)
    leaves = [[x for _, x in tree_leaves(t)] for t in trees]
    out = [[] for _ in trees]
    for xs in zip(*leaves):
        amax = torch.stack([x.abs().max().float().to(xs[0].device)
                            for x in xs]).max()
        scales = [_scale(amax).to(x.device) for x in xs]
        q = [_codes(x, s).to(torch.int32) for x, s in zip(xs, scales)]
        qsum = ring_allreduce_schedule(q)
        for r, x in enumerate(xs):
            out[r].append((dequantize_int8(qsum[r], scales[r]) / size)
                          .to(x.dtype))
    its = [iter(o) for o in out]
    return [tree_map(lambda _: next(it), t) for t, it in zip(trees, its)]


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback
# ---------------------------------------------------------------------------


def kth_largest_abs(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |flat| (f32, 0-d): a bisection over the f32 bit
    patterns of |flat|, which order as the values do (31 counting passes,
    no sort and no (k,) buffer; a full-width embedding's gradient has 778 M
    entries). Equal to ``torch.topk(|flat|, k).values[-1]``."""
    bits = flat.float().abs().view(torch.int32)
    lo, hi = 0, int(bits.max())          # count(bits >= lo) >= k always
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int((bits >= mid).sum()) >= k:
            lo = mid
        else:
            hi = mid - 1
    return torch.tensor(lo, dtype=torch.int32).view(torch.float32).to(
        flat.device)


def topk_sparsify(x: torch.Tensor, frac: float = 0.01
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the entries with |x| at least the k-th largest, k = max(1,
    int(frac * n)) (ties at the threshold all kept).
    Returns (sparse dense-layout tensor, residual)."""
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    thresh = kth_largest_abs(flat, k)
    mask = flat.abs().float() >= thresh
    kept = torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape)
    return kept, x - kept


def topk_psum_with_feedback(trees: Sequence[Any], residuals: Sequence[Any],
                            frac: float = 0.01) -> tuple[list, list]:
    """Error-feedback top-k all-reduce: rank r keeps g' = topk(g + r),
    new r = (g + r) - g', and the ranks' g' are summed around the ring and
    divided by the rank count. Returns (the mean, one tree a rank, in each
    leaf's dtype; the new residuals, f32, one tree a rank)."""
    size = len(trees)
    leaves = [[x for _, x in tree_leaves(t)] for t in trees]
    res_leaves = [[x for _, x in tree_leaves(t)] for t in residuals]
    grads = [[] for _ in trees]
    new_res = [[] for _ in trees]
    for gs, rs in zip(zip(*leaves), zip(*res_leaves)):
        kept = []
        for r, (g, res) in enumerate(zip(gs, rs)):
            kp, nr = topk_sparsify(g.float() + res.float(), frac)
            kept.append(kp)
            new_res[r].append(nr)
        total = ring_allreduce_schedule(kept)
        for r, g in enumerate(gs):
            grads[r].append((total[r] / size).to(g.dtype))
    out = []
    for t, g_r, n_r in zip(trees, grads, new_res):
        gi, ni = iter(g_r), iter(n_r)
        out.append((tree_map(lambda _: next(gi), t),
                    tree_map(lambda _: next(ni), t)))
    return [o[0] for o in out], [o[1] for o in out]


def init_residuals(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# compression error metrics
# ---------------------------------------------------------------------------


def relative_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    nx = torch.linalg.vector_norm(x.float())
    return torch.linalg.vector_norm((x - y).float()) / torch.where(
        nx > 0, nx, torch.ones_like(nx))
