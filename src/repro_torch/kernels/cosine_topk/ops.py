"""Wrappers around the cosine top-k kernels (K1 f32, K2 int8; K1's
shard-local mode for the sharded cache plane, ``cosine_top1_local``).

For CUDA tensors each wrapper launches its hand-written kernel (see
``kernel.py``) on the current stream, or raises; for CPU tensors it runs
the plain version in ``ref.py``. There is no fallback from one to the
other. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
The kernels have no backward: under grad mode with an input that requires
grad they raise (``kernels.refuse_grad``).

``quantize_rows`` is host numpy, carried over from the reference as is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, on_cpu, refuse_grad
from repro_torch.kernels.cosine_topk import kernel as K
from repro_torch.kernels.cosine_topk import ref

KMAX = 16    # the kernels keep at most 16 candidates per query


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def quantize_rows(rows: np.ndarray, width: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of an (n, d) f32 matrix.

    Returns (codes (n, width) int8 — lane-padded with zero columns when
    ``width`` > d, scales (n,) f32, err (n,) f64) where
    ``row_j ~= codes_j * scale_j`` and ``err_j = ||row_j - codes_j *
    scale_j||_2`` computed in float64. ``err_j`` bounds the quantized-sim
    deviation for any query: |q . row_j - (q . codes_j) * scale_j|
    <= ||q||_2 * err_j (Cauchy-Schwarz), which is what makes the margin
    rescoring in SemanticCache exact (DESIGN.md §15).
    """
    rows = np.ascontiguousarray(np.asarray(rows, np.float32))
    n, d = rows.shape
    width = int(width if width is not None else d)
    amax = np.abs(rows).max(axis=1) if n else np.zeros((0,), np.float32)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.zeros((n, width), np.int8)
    if n:
        codes[:, :d] = np.clip(np.rint(rows / scales[:, None]),
                               -127, 127).astype(np.int8)
    deq = codes[:, :d].astype(np.float32) * scales[:, None]
    err = np.linalg.norm(rows.astype(np.float64) - deq.astype(np.float64),
                         axis=1)
    return codes, scales, err


def _lane_padded(x: torch.Tensor, width: int, dtype) -> torch.Tensor:
    """x as a contiguous (rows, width) tensor of ``dtype``, zero-padded on
    the right; no copy when it already is one (the serving mirror)."""
    if x.shape[1] == width and x.dtype == dtype and x.is_contiguous():
        return x
    out = torch.zeros((x.shape[0], width), dtype=dtype, device=x.device)
    out[:, :x.shape[1]] = x.to(dtype)
    return out


def _valid_bytes(valid, n: int, device) -> torch.Tensor:
    """The mask as contiguous 0/1 bytes; a contiguous bool mask (the serving
    mirror's) is passed as it is."""
    if valid is None:
        return torch.ones((n,), dtype=torch.uint8, device=device)
    if valid.shape != (n,):
        raise ValueError(f"valid must have shape ({n},), got "
                         f"{tuple(valid.shape)}")
    if valid.dtype == torch.bool and valid.is_contiguous():
        return valid                            # 0/1 bytes already
    return (valid != 0).to(torch.uint8).contiguous()


def _check_k(k: int) -> None:
    if not 1 <= k <= KMAX:
        raise ValueError(f"k must be in [1, {KMAX}], got {k}")


def _empty(k: int, device):
    return (torch.zeros((0, k), dtype=torch.float32, device=device),
            torch.zeros((0, k), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.bool, device=device))


# per (device index, stream): the pass-1 candidate lists, grown on demand
_scratch: dict = {}


def _launch(name: str, dev: torch.device, B: int, T: int, k: int,
            inputs: tuple, args: tuple):
    """Launch kernel ``name`` on ``dev``'s current stream with the input
    pointers ``inputs`` and the scalar ``args``; returns fresh (vals (B, k),
    idx (B, k), hit (B,)). The candidate lists are scratch kept per device
    and stream, so a call allocates only its outputs and launches only the
    kernel's own two passes."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(name, dev, B, T, k, inputs, args)
    # torch.cuda.current_stream(dev).cuda_stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    part_v, part_i = _scratch.get(key, (None, None))
    if part_v is None or part_v.numel() < B * T * k:
        n = max(B * T * k, 4096)
        part_v = torch.empty(n, dtype=torch.float32, device=dev)
        part_i = torch.empty(n, dtype=torch.int32, device=dev)
        _scratch[key] = (part_v, part_i)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    hit = torch.empty((B,), dtype=torch.bool, device=dev)
    rc = K.load(name)(*inputs, part_v.data_ptr(), part_i.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(), hit.data_ptr(),
                      *args, stream)
    _build.check_rc(rc, name)
    return vals, idx, hit


def cosine_topk(queries: torch.Tensor, centroids: torch.Tensor, k: int = 1,
                valid: torch.Tensor | None = None, theta: float = 2.0,
                block_n: int = 512, early_exit: bool = False,
                return_hit: bool = False):
    """queries (B, D) x centroids (N, D) -> (sims (B, k) f32, idx (B, k)
    i32[, hit (B,) bool]).

    ``valid`` (N,) marks the rows to consider (default all); invalid rows
    score -inf, and idx is -1 where the value is not finite. ``hit`` is
    ``best >= f32(theta)``. With ``early_exit`` a logical tile is skipped
    once every query's best so far clears theta (match-good-enough
    semantics of the reference kernel). A lane-padded f32 matrix (the
    serving mirror) is read in place.
    """
    _check_k(k)
    if on_cpu(queries, centroids, valid):
        out = ref.cosine_topk_ref(queries, centroids, k, valid, theta,
                                  early_exit, block_n)
    elif queries.shape[0] == 0:
        out = _empty(k, queries.device)
    else:
        refuse_grad("cosine_topk", queries, centroids)
        out = _k1(queries, centroids, k, valid, theta, block_n, early_exit)
        cosine_topk.launches += 1
    return out if return_hit else out[:2]


cosine_topk.launches = 0


def _k1(queries, centroids, k, valid, theta, block_n, early_exit):
    """One launch of K1 on the card; the calling wrapper counts it."""
    B, D = queries.shape
    N, Dc = centroids.shape
    dev = queries.device
    Dp = _ceil_to(max(D, Dc, 1), 128)
    q = _lane_padded(queries, Dp, torch.float32)
    c = _lane_padded(centroids, Dp, torch.float32)
    v = _valid_bytes(valid, N, dev)
    bn = ref.logical_block(N, block_n)
    T = -(-N // bn)
    return _launch("cosine_topk", dev, B, T, k,
                   (q.data_ptr(), c.data_ptr(), v.data_ptr()),
                   (B, N, Dp, k, bn, float(np.float32(theta)),
                    int(bool(early_exit))))


def cosine_top1_local(queries: torch.Tensor, centroids: torch.Tensor,
                      valid: torch.Tensor | None = None, block_n: int = 512
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard-local exact top-1 for the sharded cache plane (DESIGN.md §11):
    K1 at k=1, theta 2.0, early exit off, since the cross-shard merge needs
    each shard's exact best row, not a good-enough one. A shard with no
    valid row reports its -inf sim at row 0 (the reference clamps the -1),
    which loses every cross-shard comparison. Returns ((B,) best sims f32,
    (B,) local rows i32). Its launches count in
    ``cosine_top1_local.launches``, not in K1's."""
    if on_cpu(queries, centroids, valid):
        return ref.cosine_top1_local_ref(queries, centroids, valid, block_n)
    if queries.shape[0] == 0:
        vals, idx, _ = _empty(1, queries.device)
    else:
        refuse_grad("cosine_top1_local", queries, centroids)
        vals, idx, _ = _k1(queries, centroids, 1, valid, 2.0, block_n,
                           False)
        cosine_top1_local.launches += 1
    return vals[:, 0], idx[:, 0].clamp_min(0)


cosine_top1_local.launches = 0


def cosine_topk_q8(queries: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, k: int = 1,
                   valid: torch.Tensor | None = None, theta: float = 2.0,
                   margin: float = 0.0, block_n: int = 512,
                   early_exit: bool = False, return_hit: bool = False):
    """Quantized lookup: queries (B, D) x codes (N, Dc) int8 with per-row
    scales (N,) f32 -> (quant sims (B, k) f32, idx (B, k) i32[, hit]).

    The similarity of row j is ``(q . codes_j) * scale_j``; the hit mask
    and early exit compare against ``f32(theta) + f32(margin)``, so a
    reported hit is conservative (DESIGN.md §15).
    """
    _check_k(k)
    B, D = queries.shape
    N, Dc = codes.shape
    if on_cpu(queries, codes, scales, valid):
        out = ref.cosine_topk_q8_ref(queries, codes, scales, k, valid,
                                     theta, margin, early_exit, block_n)
    elif B == 0:
        out = _empty(k, queries.device)
    else:
        refuse_grad("cosine_topk_q8", queries, scales)
        dev = queries.device
        Dp = _ceil_to(max(D, Dc, 1), 128)
        q = _lane_padded(queries, Dp, torch.float32)
        c = _lane_padded(codes, Dp, torch.int8)
        s = scales.to(torch.float32).contiguous()
        if s.shape != (N,):
            raise ValueError(f"scales must have shape ({N},)")
        v = _valid_bytes(valid, N, dev)
        bn = ref.logical_block(N, block_n)
        T = -(-N // bn)
        thr = float(np.float32(theta) + np.float32(margin))
        out = _launch("cosine_topk_q8", dev, B, T, k,
                      (q.data_ptr(), c.data_ptr(), s.data_ptr(),
                       v.data_ptr()),
                      (B, N, Dp, k, bn, thr, int(bool(early_exit))))
        cosine_topk_q8.launches += 1
    return out if return_hit else out[:2]


cosine_topk_q8.launches = 0
