"""The online semantic cache (port of ``repro/core/semantic_cache.py``).

Two regions (paper §5.2.5): the Algorithm-1-managed centroid region and an
LRU spill region for individual query vectors in leftover capacity.

Lookup backends:
  * "dense"     — top-1 + theta compare + answer gather with torch ops over
                  a persistent padded mirror (exact, recall = 1);
  * "pallas"    — the hand-written K1 cosine top-k kernel (the name is the
                  reference's; on the card it is CUDA, on the CPU its plain
                  version), theta_R hit mask and early exit from the kernel;
  * "pallas_q8" — int8 plane through K2 + exact theta-margin rescoring
                  (DESIGN.md §15): decisions and sims bit-identical to
                  "dense";
  * "hnsw"      — locality-ordered HNSW on the host (``core/hnsw.py``,
                  §4.3), built lazily from centroids + spill and guarded
                  against a stale serving generation.
The sharded plane (``shard=`` with more than one shard) arrives with
ROADMAP Queue A item 5 and raises ``NotImplementedError`` here.

Device-resident hot path (DESIGN.md §4): the padded centroid/answer
matrices are persistent tensors on ``device``. Offline refreshes rebuild
them once; online spill inserts patch one row. The JAX reference patches
with a donated ``dynamic_update_slice``; the port updates the persistent
tensors in place with index writes. Double-buffered refresh (DESIGN.md
§10) stages the new region on the host and swaps the mirror in one upload;
every swap or rebuild bumps ``generation``, except the one rebuild that
re-materializes a restored snapshot (DESIGN.md §12), which rebuilds the
mirror once and keeps the snapshot's generation.

Eviction taps (DESIGN.md §13-14): ``evict_sink`` receives every spill LRU
victim and spill trim (the tiered hierarchy demotes them), and
``fair_share_eviction`` with ``tenant_of`` makes victim selection
tenant-weighted. Unset, every path is bit-identical to the single-tier,
single-namespace cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.clustering import _pow2_pad
from repro_torch.core.hnsw import HNSW
from repro_torch.core.store import CentroidStore
from repro_torch.core.tenancy import fair_share_take
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cosine_topk import ops as ctk_ops
from repro_torch.kernels.cosine_topk.ops import quantize_rows

# Absolute slack added to the quant rescoring margin (DESIGN.md §15) on top
# of the Cauchy-Schwarz bound ||q|| * err_max: absorbs the f32
# accumulation-order difference between the int8 kernel and the exact
# bound's real-arithmetic model. Oversizing it never breaks exactness.
QUANT_SLACK = 1e-3


def _lane_pad(d: int) -> int:
    """Lane-width (128) padded feature dim for device mirrors."""
    return (max(d, 1) + 127) // 128 * 128


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to the device (a copy on the CPU too: the mirror
    must never alias host buffers that keep mutating)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def _sims(queries: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """The reference f32 contraction, queries @ mat.T. The dense top-1, the
    quant rescore and its fallback all call it on (_pow2_pad(n), dim)
    matrices: the GEMM picks its algorithm by shape, and a row's dot
    product does not depend on the other rows, so the rescore reproduces
    the dense sims bit for bit."""
    return queries @ mat.T


def _fused_top1(queries, mat, ans, valid, aid, theta: float):
    """Top-1 + theta compare + answer gather on the device. Invalid rows
    score -1.0 (the reference's fill); ties go to the first row."""
    sims = _sims(queries, mat)
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, -1.0))
    idx = torch.argmax(sims, dim=1)       # first max, as jnp.argmax
    best = sims.gather(1, idx[:, None])[:, 0]
    hit = best >= _f32(theta, sims.device)
    answer, answer_id = _gather_hits(ans, aid, idx, hit)
    return hit, best, idx.to(torch.int32), answer, answer_id


def _gather_hits(ans, aid, idx, hit):
    """Answer gather for backends that produce (idx, hit) themselves."""
    safe = idx.long().clamp_min(0)
    answer = torch.where(hit[:, None], ans[safe], torch.zeros_like(ans[safe]))
    answer_id = torch.where(hit, aid[safe], torch.full_like(aid[safe], -1))
    return answer, answer_id


@dataclass
class _DeviceState:
    """Persistent device-resident mirror of centroid + spill regions."""
    mat: torch.Tensor      # (pad, width) float32
    ans: torch.Tensor      # (pad, answer_dim) float32
    valid: torch.Tensor    # (pad,) bool
    aid: torch.Tensor      # (pad,) int32
    pad: int

    @property
    def rows(self) -> int:
        return self.pad

    def write_row(self, row: int, vec: np.ndarray, answer: np.ndarray,
                  answer_id: int) -> None:
        """In-place row patch (the reference donates a dynamic_update_slice)."""
        v = torch.tensor(np.asarray(vec, np.float32), device=self.mat.device)
        self.mat[row, :len(v)] = v
        self.ans[row] = torch.tensor(np.asarray(answer, np.float32),
                                     device=self.ans.device)
        self.valid[row] = True
        self.aid[row] = int(answer_id)


@dataclass
class _QuantDeviceState:
    """Device mirror for the int8 plane (backend "pallas_q8", DESIGN.md
    §15): per-row symmetric codes + scales, no answer matrix — answers stay
    host-side and are gathered per hit."""
    codes: torch.Tensor    # (pad, dpad) int8, lane-padded codes
    scales: torch.Tensor   # (pad,) float32 per-row scales
    valid: torch.Tensor    # (pad,) bool
    pad: int
    dpad: int
    err_max: float         # running max per-row dequant L2 error

    @property
    def rows(self) -> int:
        return self.pad

    def write_row(self, row: int, vec: np.ndarray, answer: np.ndarray,
                  answer_id: int) -> None:
        """In-place spill patch: quantize host-side, write code row and
        scale. ``answer``/``answer_id`` stay host-side."""
        crow, scale, err = quantize_rows(
            np.asarray(vec, np.float32).reshape(1, -1), width=self.dpad)
        self.codes[row] = torch.tensor(crow[0], device=self.codes.device)
        self.scales[row] = float(scale[0])
        self.valid[row] = True
        self.err_max = max(self.err_max, float(err[0]))


@dataclass
class LookupResult:
    hit: np.ndarray        # (B,) bool
    sim: np.ndarray        # (B,) float32 best similarity
    answer: np.ndarray     # (B, answer_dim) float32 (zeros on miss)
    answer_id: np.ndarray  # (B,) int64 (-1 on miss)
    entry: np.ndarray      # (B,) int64 row index (-1 on miss)
    region: np.ndarray     # (B,) int8: 0 centroid, 1 spill, -1 miss
    generation: int = -1   # serving-state generation (DESIGN.md §10)


class SemanticCache:
    def __init__(self, dim: int, answer_dim: int, capacity: int,
                 backend: str = "dense", spill_lru: bool = True,
                 shard=None, rescore_k: int = 16,
                 device: DeviceLike = None):
        if backend not in ("dense", "hnsw", "pallas", "pallas_q8"):
            raise ValueError(f"unknown cache backend {backend!r}")
        # n_shards == 1 is the single-device path, as in the reference
        self.shard = shard if shard is not None \
            and getattr(shard, "n_shards", 1) > 1 else None
        self.backend = backend
        self._reject_hnsw_shard()
        if self.shard is not None:
            raise NotImplementedError(
                "the sharded cache plane is not ported yet")
        self.device = resolve_device(device)
        self.dim = dim
        self.answer_dim = answer_dim
        self.capacity = capacity
        self.spill_lru = spill_lru
        self.rescore_k = rescore_k
        self.quant_rescored = 0     # full-precision rows rescored
        self.quant_fallbacks = 0    # margin-coverage misses -> dense ref
        self.centroids = CentroidStore(dim, answer_dim)
        self.spill = CentroidStore(dim, answer_dim)
        self._spill_clock = 0
        self._spill_last_use: np.ndarray = np.zeros((0,), np.int64)
        self._dev = None
        self._hnsw = None
        self.hits = 0
        self.misses = 0
        self.dev_rebuilds = 0
        self.dev_row_writes = 0
        self.dev_swaps = 0
        self.generation = 0
        # generation the HNSW index was built at, guarded against the
        # serving generation at every graph lookup
        self._hnsw_gen = 0
        self._shadow: Optional[dict] = None
        # set by load_state: the next mirror (re)build reproduces the
        # snapshot's serving state, so it must NOT advance the generation
        self._restore_pending = False
        self._quant_restore: Optional[dict] = None   # snapshot codes
        # demotion tap (DESIGN.md §13): when set, every evicted entry
        # (spill LRU victim, spill trim) is handed to the sink as
        #   sink(vectors, answers, answer_id, cluster_size, access_count,
        #        kind)
        # instead of being discarded
        self.evict_sink = None
        # tenant-weighted victim selection (DESIGN.md §14): both set by
        # SISO from its TenancyConfig
        self.fair_share_eviction = False
        self.tenant_of = None     # answer_ids -> tenants, or None

    def _reject_hnsw_shard(self) -> None:
        """The hnsw backend serves from a host graph and would silently
        ignore a sharded device plane. Checked at construction and at
        every graph lookup (a post-construction mutation would otherwise
        fall through)."""
        if self.shard is not None and self.backend == "hnsw":
            raise ValueError("sharded cache plane needs a device-resident "
                             "backend (dense/pallas); hnsw is host-graph")

    # ----------------------------------------------------------------- state

    @property
    def spill_capacity(self) -> int:
        return max(0, self.capacity - len(self.centroids))

    def set_centroids(self, store: CentroidStore) -> None:
        order = np.argsort(-store.cluster_size, kind="stable")
        store = store.copy()
        store.take(order)  # locality-first layout
        self.centroids = store
        self._trim_spill()
        self._restore_pending = False   # a real new state supersedes restore
        self._quant_restore = None
        self._invalidate()

    def _fair_share(self) -> bool:
        return self.fair_share_eviction and self.tenant_of is not None

    def _evicted_rows(self, rows: np.ndarray) -> Optional[tuple]:
        """Copies of the spill rows about to leave, for the sink (None
        without one)."""
        if self.evict_sink is None:
            return None
        sp = self.spill
        return (sp.vectors[rows].copy(), sp.answers[rows].copy(),
                sp.answer_id[rows].copy(), sp.cluster_size[rows].copy(),
                sp.access_count[rows].copy())

    def _trim_spill(self) -> None:
        """Evict spill rows that no longer fit the leftover capacity (shared
        by set_centroids and commit_shadow): LRU, or over-budget
        namespaces first with fair-share eviction."""
        if len(self.spill) > self.spill_capacity:
            drop = len(self.spill) - self.spill_capacity
            if self._fair_share():
                victims = fair_share_take(
                    self.tenant_of(self.spill.answer_id),
                    self._spill_last_use, drop)
            else:
                victims = np.argsort(self._spill_last_use)[:drop]
            dead = self._evicted_rows(np.sort(victims))
            keep = np.setdiff1d(np.arange(len(self.spill)), victims)
            self.spill.take(keep)
            self._spill_last_use = self._spill_last_use[keep]
            if dead is not None:    # the sink fires after the rows left
                self.evict_sink(*dead, "spill_trim")

    def drop_spill_ids(self, answer_ids: np.ndarray) -> int:
        """Remove spill rows whose answer identity (>= 0) is in
        ``answer_ids``: the tiered wrapper calls this right before a
        refresh commit, so an identity promoted into the new centroid
        region keeps no second copy in the spill (DESIGN.md §13). It
        invalidates the mirror, which that commit rebuilds or swaps
        anyway."""
        ids = np.asarray(answer_ids)
        ids = ids[ids >= 0]
        if not len(ids) or not len(self.spill):
            return 0
        dup = np.isin(self.spill.answer_id, ids)
        n = int(dup.sum())
        if n:
            keep = np.where(~dup)[0]
            self.spill.take(keep)
            self._spill_last_use = self._spill_last_use[keep]
            self._quant_restore = None
            self._invalidate()
        return n

    def apply_chunk(self, chunk: CentroidStore, first: bool) -> None:
        """Progressive update entry point (CacheManager.update_chunks)."""
        if first:
            self._staging = CentroidStore(self.dim, self.answer_dim)
        self._staging.add(chunk.vectors, chunk.answers, chunk.cluster_size,
                          chunk.access_count, chunk.answer_id)

    def finish_update(self) -> None:
        self.set_centroids(self._staging)
        del self._staging

    def _invalidate(self) -> None:
        """Full invalidation (the offline refresh path): online spill
        inserts patch the device mirror in place instead."""
        self._dev = None
        self._hnsw = None

    # ---------------------------------------------------------------- device

    def _bump_generation(self) -> None:
        """A mirror/index rebuild starts a new serving state, except the one
        rebuild that re-materializes a restored snapshot."""
        if self._restore_pending:
            self._restore_pending = False
        else:
            self.generation += 1

    def _quantize_all(self, vecs: np.ndarray) -> tuple:
        """(codes, scales, err_max) for the full host row set; a pending
        snapshot restore hands back the snapshot's own codes and scales
        when their shapes match, so a warm restart serves from the very
        same int8 plane."""
        n = len(vecs)
        dpad = _lane_pad(self.dim)
        restore, self._quant_restore = self._quant_restore, None
        if restore is not None:
            codes = np.asarray(restore["codes"], np.int8)
            scales = np.asarray(restore["scales"], np.float32)
            if len(codes) == n and codes.shape[1] == dpad \
                    and len(scales) == n:
                return codes, scales, float(restore["err_max"])
        codes, scales, err = quantize_rows(vecs, width=dpad)
        return codes, scales, float(err.max()) if n else 0.0

    @property
    def _mat_width(self) -> int:
        """The K1 backend keeps the f32 mirror lane-padded so the kernel
        reads it in place; zero columns add exactly 0.0 to every dot."""
        return _lane_pad(self.dim) if self.backend == "pallas" else self.dim

    def _device_state(self):
        if self._dev is None:
            nc = len(self.centroids)
            n = nc + len(self.spill)
            vecs = np.concatenate([self.centroids.vectors,
                                   self.spill.vectors]).reshape(n, self.dim)
            pad = _pow2_pad(n)
            valid = np.zeros((pad,), bool)
            valid[:n] = True
            if self.backend == "pallas_q8":   # int8 plane (DESIGN.md §15)
                dpad = _lane_pad(self.dim)
                codes, scales, err_max = self._quantize_all(vecs)
                cp = np.zeros((pad, dpad), np.int8)
                sp = np.zeros((pad,), np.float32)
                cp[:n], sp[:n] = codes, scales
                self._dev = _QuantDeviceState(
                    _upload(cp, self.device), _upload(sp, self.device),
                    _upload(valid, self.device), pad, dpad, err_max)
            else:
                mat = np.zeros((pad, self._mat_width), np.float32)
                ans = np.zeros((pad, self.answer_dim), np.float32)
                aid = np.full((pad,), -1, np.int32)
                mat[:n, :self.dim] = vecs
                ans[:n] = np.concatenate([self.centroids.answers,
                                          self.spill.answers])
                aid[:n] = np.concatenate([self.centroids.answer_id,
                                          self.spill.answer_id])
                self._dev = _DeviceState(
                    _upload(mat, self.device), _upload(ans, self.device),
                    _upload(valid, self.device), _upload(aid, self.device),
                    pad)
            self.dev_rebuilds += 1
            self._bump_generation()
        return self._dev

    # --------------------------------------------- double-buffered refresh

    def begin_shadow(self, n_new: int) -> None:
        """Open the shadow buffer for a refresh in flight (DESIGN.md §10):
        the new centroid region is staged host-side chunk by chunk while
        the live mirror keeps serving; one commit_shadow makes it live."""
        keep_spill = min(len(self.spill), max(0, self.capacity - n_new))
        pad = _pow2_pad(n_new + keep_spill)
        if self.backend == "pallas_q8":
            self._shadow = {
                "codes": np.zeros((pad, _lane_pad(self.dim)), np.int8),
                "scales": np.zeros((pad,), np.float32),
                "valid": np.zeros((pad,), bool),
                "err_max": 0.0, "n_new": n_new, "filled": 0}
            return
        self._shadow = {
            "mat": np.zeros((pad, self._mat_width), np.float32),
            "ans": np.zeros((pad, self.answer_dim), np.float32),
            "valid": np.zeros((pad,), bool),
            "aid": np.full((pad,), -1, np.int32),
            "n_new": n_new, "filled": 0}

    def shadow_write(self, vectors: np.ndarray, answers: np.ndarray,
                     answer_id: np.ndarray) -> None:
        """Stage one bounded chunk of the new centroid region (host-side
        memcpy — the live mirror is untouched)."""
        sh = self._shadow
        s, k = sh["filled"], len(vectors)
        if self.backend == "pallas_q8":
            codes, scales, err = quantize_rows(
                np.asarray(vectors, np.float32).reshape(k, self.dim),
                width=_lane_pad(self.dim))
            if len(err):
                sh["err_max"] = max(sh["err_max"], float(err.max()))
            sh["codes"][s:s + k] = codes
            sh["scales"][s:s + k] = scales
        else:
            sh["mat"][s:s + k, :self.dim] = vectors
            sh["ans"][s:s + k] = answers
            sh["aid"][s:s + k] = answer_id
        sh["valid"][s:s + k] = True
        sh["filled"] = s + k

    @staticmethod
    def _regrow(arrays: dict, keys_fill: tuple, nc: int, pad: int) -> None:
        """Grow staged host buffers to ``pad`` rows, keeping the first nc."""
        for key, fill in keys_fill:
            old = arrays[key]
            grown = np.full((pad,) + old.shape[1:], fill, old.dtype)
            grown[:nc] = old[:nc]
            arrays[key] = grown

    def commit_shadow(self, store: CentroidStore) -> None:
        """Atomic swap ending a double-buffered refresh: install the store,
        LRU-trim the spill, append the surviving spill rows, upload once
        and swap the mirror — lookups see the whole old generation or the
        whole new one."""
        sh = self._shadow
        if sh is None or sh["filled"] != sh["n_new"] \
                or sh["n_new"] != len(store):
            raise ValueError("commit_shadow: shadow incomplete or store "
                             "size mismatch")
        self.centroids = store
        self._trim_spill()
        nc, ns = len(store), len(self.spill)
        need = nc + ns
        q8 = self.backend == "pallas_q8"
        if need > len(sh["valid"]):     # spill grew past the headroom
            keys = ((("codes", 0), ("scales", 0.0), ("valid", False)) if q8
                    else (("mat", 0.0), ("ans", 0.0), ("valid", False),
                          ("aid", -1)))
            self._regrow(sh, keys, nc, _pow2_pad(need))
        if ns:
            sh["valid"][nc:need] = True
            if q8:
                sc, ss, err = quantize_rows(self.spill.vectors,
                                            width=_lane_pad(self.dim))
                sh["err_max"] = max(sh["err_max"], float(err.max()))
                sh["codes"][nc:need], sh["scales"][nc:need] = sc, ss
            else:
                sh["mat"][nc:need, :self.dim] = self.spill.vectors
                sh["ans"][nc:need] = self.spill.answers
                sh["aid"][nc:need] = self.spill.answer_id
        pad = len(sh["valid"])
        if q8:
            self._dev = _QuantDeviceState(
                _upload(sh["codes"], self.device),
                _upload(sh["scales"], self.device),
                _upload(sh["valid"], self.device), pad,
                _lane_pad(self.dim), sh["err_max"])
        else:
            self._dev = _DeviceState(
                _upload(sh["mat"], self.device),
                _upload(sh["ans"], self.device),
                _upload(sh["valid"], self.device),
                _upload(sh["aid"], self.device), pad)
        self._hnsw = None        # graph path stays rebuild-based
        self._shadow = None
        self._restore_pending = False   # a real new state supersedes restore
        self._quant_restore = None
        self.generation += 1
        self.dev_swaps += 1

    # ---------------------------------------------------------------- lookup

    def _to_device(self, queries: np.ndarray) -> torch.Tensor:
        return torch.tensor(queries, device=self.device)

    def lookup(self, queries: np.ndarray, theta_r: float,
               update_counts: bool = True) -> LookupResult:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        B = len(queries)
        nc = len(self.centroids)
        n = nc + len(self.spill)
        if n == 0:
            if update_counts:
                self.misses += B
            return LookupResult(np.zeros(B, bool), np.full(B, -1.0, np.float32),
                                np.zeros((B, self.answer_dim), np.float32),
                                np.full(B, -1, np.int64),
                                np.full(B, -1, np.int64),
                                np.full(B, -1, np.int8),
                                generation=self.generation)
        if self.backend == "hnsw":
            sims, idx = self._hnsw_lookup(queries)
            hit = sims >= theta_r
            answer, answer_id = self._host_gather(hit, idx, nc, B)
        elif self.backend == "pallas_q8":
            # int8 plane: K2 top-C on the device, exact margin rescore;
            # answers are host resident
            sims, idx = self._quant_lookup(queries, theta_r)
            # f32-exact compare, as the device compares f32 sims to f32
            hit = sims >= np.float32(theta_r)
            answer, answer_id = self._host_gather(hit, idx, nc, B)
        else:
            dev = self._device_state()
            q = self._to_device(queries)
            if self.backend == "pallas":
                # early-accept only for real serving thresholds: probe
                # lookups (theta_r = -1.0) need exact top-1 sims
                s, i, h = ctk_ops.cosine_topk(
                    q, dev.mat, k=1, valid=dev.valid, theta=theta_r,
                    early_exit=bool(theta_r > 0), return_hit=True)
                s, i = s[:, 0], i[:, 0]
                a, ai = _gather_hits(dev.ans, dev.aid, i, h)
            else:
                h, s, i, a, ai = _fused_top1(q, dev.mat, dev.ans, dev.valid,
                                             dev.aid, theta_r)
            hit, sims, idx, answer, answer_id = (
                x.cpu().numpy() for x in (h, s, i, a, ai))
            answer_id = answer_id.astype(np.int64)
        idx = np.asarray(idx, np.int64)
        region = np.where(~hit, -1, np.where(idx < nc, 0, 1)).astype(np.int8)
        if update_counts:
            cent_rows = idx[hit & (idx < nc)]
            if len(cent_rows):
                np.add.at(self.centroids.access_count, cent_rows, 1.0)
            spill_rows = idx[hit & (idx >= nc)] - nc
            if len(spill_rows):
                # per-hit clock ticks in batch order (duplicates keep the
                # latest tick, same as the sequential loop would)
                self._spill_last_use[spill_rows] = \
                    self._spill_clock + 1 + np.arange(len(spill_rows))
                self._spill_clock += len(spill_rows)
            self.hits += int(hit.sum())
            self.misses += int(B - hit.sum())
        entry = np.where(hit, idx, -1).astype(np.int64)
        return LookupResult(hit, sims.astype(np.float32), answer, answer_id,
                            entry, region, generation=self.generation)

    def _quant_lookup(self, queries: np.ndarray, theta_r: float
                      ) -> tuple[np.ndarray, np.ndarray]:
        """K2 top-C (C = rescore_k) on the device, then the exact rescore."""
        dev = self._device_state()
        C = min(self.rescore_k, dev.rows)
        s, i = ctk_ops.cosine_topk_q8(
            self._to_device(queries), dev.codes, dev.scales, k=C,
            valid=dev.valid, theta=theta_r, early_exit=False)
        cand_s, cand_r = s.cpu().numpy(), i.cpu().numpy()
        return self._rescore_exact(queries, cand_s, cand_r, cand_s[:, -1:],
                                   dev.err_max)

    def _rows_matrix(self, rows: Optional[np.ndarray]) -> torch.Tensor:
        """A zero (_pow2_pad(n), dim) matrix — the dense mirror's shape —
        holding the requested rows (all rows for None) at their positions."""
        nc = len(self.centroids)
        n = nc + len(self.spill)
        # zero-filled on the device; only the requested rows cross over
        mat = torch.zeros((_pow2_pad(n), self.dim), dtype=torch.float32,
                          device=self.device)
        if rows is None:        # copy_ straight from the host arrays
            mat[:nc] = torch.from_numpy(self.centroids.vectors)
            mat[nc:n] = torch.from_numpy(self.spill.vectors)
            return mat
        vecs = np.empty((len(rows), self.dim), np.float32)
        c_rows = rows < nc
        vecs[c_rows] = self.centroids.vectors[rows[c_rows]]
        vecs[~c_rows] = self.spill.vectors[rows[~c_rows] - nc]
        mat[_upload(rows, self.device)] = _upload(vecs, self.device)
        return mat

    def _rescore_exact(self, queries: np.ndarray, cand_s: np.ndarray,
                       cand_r: np.ndarray, kth: np.ndarray,
                       err_max: float) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-1 from quantized candidates (proof in DESIGN.md §15).

        Quant sims deviate from the f32 sims by at most eps = err_max *
        ||q||_2 (+ slack). If the C-th candidate sits strictly below
        (max candidate - 2 eps), every row tied at the true best is a
        candidate, so one f32 rescore over the candidate union with
        first-max tie-breaking IS the reference answer. Uncovered windows
        fall back to the dense reference (counted, rare).
        """
        B = len(queries)
        qn = np.linalg.norm(queries.astype(np.float64), axis=1)
        eps = err_max * qn + QUANT_SLACK
        finite = np.isfinite(cand_s)
        m = np.max(np.where(finite, cand_s, -np.inf), axis=1,
                   initial=-np.inf)
        bar = (m - 2.0 * eps)[:, None]
        covered = ((~np.isfinite(kth)) | (kth < bar)).all(axis=1)
        if not covered.all():
            self.quant_fallbacks += 1
            return self._dense_reference_lookup(queries)
        rows = np.unique(cand_r[finite].astype(np.int64))    # sorted asc
        if not len(rows):                                    # B == 0
            return (np.full(B, -1.0, np.float32), np.zeros(B, np.int64))
        self.quant_rescored += int(len(rows))
        # same shape, same row positions as the dense mirror: the dense
        # computation with non-candidate rows zeroed, bit for bit
        sims = _sims(self._to_device(queries),
                     self._rows_matrix(rows)).cpu().numpy()[:, rows]
        pos = np.argmax(sims, axis=1)        # first max -> lowest row
        best = sims[np.arange(B), pos]
        return best.astype(np.float32), rows[pos]

    def _dense_reference_lookup(self, queries: np.ndarray
                                ) -> tuple[np.ndarray, np.ndarray]:
        """Margin-coverage fallback: the full f32 row set through the
        reference contraction — bitwise the dense backend's answer."""
        n = len(self.centroids) + len(self.spill)
        sims = _sims(self._to_device(queries),
                     self._rows_matrix(None)).cpu().numpy()[:, :n]
        pos = np.argmax(sims, axis=1)
        best = sims[np.arange(len(queries)), pos]
        return best.astype(np.float32), pos.astype(np.int64)

    def _host_gather(self, hit: np.ndarray, idx: np.ndarray, nc: int,
                     B: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized host-side answer gather (hnsw + quant backends)."""
        answer = np.zeros((B, self.answer_dim), np.float32)
        answer_id = np.full(B, -1, np.int64)
        hc = hit & (idx < nc)
        hs = hit & (idx >= nc)
        if hc.any():
            answer[hc] = self.centroids.answers[idx[hc]]
            answer_id[hc] = self.centroids.answer_id[idx[hc]]
        if hs.any():
            sj = idx[hs] - nc
            answer[hs] = self.spill.answers[sj]
            answer_id[hs] = self.spill.answer_id[sj]
        return answer, answer_id

    def _hnsw_lookup(self, queries: np.ndarray):
        self._reject_hnsw_shard()   # serving-time guard, not just __init__
        if self._hnsw is None:
            vecs = np.concatenate([self.centroids.vectors, self.spill.vectors]) \
                if len(self.spill) else self.centroids.vectors
            size = np.concatenate([self.centroids.cluster_size,
                                   np.zeros(len(self.spill))]) \
                if len(self.spill) else self.centroids.cluster_size
            self._hnsw = HNSW.build(vecs, locality=size)
            if self._dev is None:
                # pure graph serving: an index rebuild is a new serving
                # state, so it bumps the generation as a mirror rebuild does
                # (unless it re-materializes a restored snapshot)
                self._bump_generation()
            self._hnsw_gen = self.generation
        if self._hnsw_gen != self.generation:
            # a device rebuild/shadow swap advanced the serving state
            # without invalidating the graph: serving from it would mix
            # generations mid-refresh
            raise RuntimeError(
                f"HNSW index generation {self._hnsw_gen} is stale vs "
                f"serving generation {self.generation}")
        return self._hnsw.search_batch(queries, k=1)

    # ----------------------------------------------------------------- spill

    def insert_spill(self, vector: np.ndarray, answer: np.ndarray,
                     answer_id: int = -1, cluster_size: float = 1.0) -> None:
        """LRU insert of an individual query vector into free space. The
        device mirror is patched in place; a full rebuild only happens when
        the padded matrix must grow (pow2 sizing)."""
        if not self.spill_lru or self.spill_capacity == 0:
            return
        nc = len(self.centroids)
        self._quant_restore = None   # snapshot codes no longer match
        self._spill_clock += 1
        if len(self.spill) >= self.spill_capacity:
            if self._fair_share():
                # charge the incoming row to its namespace, then evict
                # from the largest-occupancy namespace (its own LRU row)
                incoming = int(self.tenant_of(
                    np.asarray([answer_id], np.int64))[0])
                victim = int(fair_share_take(
                    self.tenant_of(self.spill.answer_id),
                    self._spill_last_use, 1, incoming=incoming)[0])
            else:
                victim = int(np.argmin(self._spill_last_use))
            # copies: set_row overwrites the slot; the sink fires once the
            # row has left the device
            dead = self._evicted_rows(slice(victim, victim + 1))
            self.spill.set_row(victim, vector, answer, answer_id,
                               cluster_size=cluster_size)
            self._spill_last_use[victim] = self._spill_clock
            if dead is not None:
                self.evict_sink(*dead, "spill_evict")
            row = nc + victim
        else:
            self.spill.add(vector, answer, cluster_size,
                           answer_id=answer_id)
            self._spill_last_use = np.append(self._spill_last_use,
                                             self._spill_clock)
            row = nc + len(self.spill) - 1
        if self._dev is not None:
            if row < self._dev.rows:
                self._dev.write_row(row, vector, answer, answer_id)
                self.dev_row_writes += 1
            else:               # outgrew the padding: rebuild (pow2 growth)
                self._dev = None
        self._hnsw = None       # graph path stays rebuild-based

    # --------------------------------------------------------------- metrics

    @property
    def hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def layout_dict(self) -> dict:
        """Device-mirror layout descriptor (single device)."""
        pad = (self._dev.pad if self._dev is not None
               else _pow2_pad(len(self.centroids) + len(self.spill)))
        return {"n_shards": np.asarray(1), "rows": np.asarray(pad),
                "pad": np.asarray(pad)}

    def memory_bytes(self) -> dict:
        """Bytes-level accounting of the device mirror (DESIGN.md §15)."""
        out = {"backend": self.backend, "n_shards": 1,
               "mirror_live": self._dev is not None,
               "rows": len(self.centroids) + len(self.spill),
               "centroid_bytes": 0, "answer_bytes": 0,
               "codes_bytes": 0, "scales_bytes": 0, "meta_bytes": 0}
        dev = self._dev
        if isinstance(dev, _QuantDeviceState):
            out["codes_bytes"] = int(dev.codes.nbytes)
            out["scales_bytes"] = int(dev.scales.nbytes)
            out["centroid_bytes"] = out["codes_bytes"] + out["scales_bytes"]
            out["meta_bytes"] = int(dev.valid.nbytes)
        elif dev is not None:
            out["centroid_bytes"] = int(dev.mat.nbytes)
            out["answer_bytes"] = int(dev.ans.nbytes)
            out["meta_bytes"] = int(dev.valid.nbytes + dev.aid.nbytes)
        out["device_total_bytes"] = (out["centroid_bytes"]
                                     + out["answer_bytes"]
                                     + out["meta_bytes"])
        out["per_shard_bytes"] = out["device_total_bytes"]
        out["host_store_bytes"] = int(
            self.centroids.vectors.nbytes + self.centroids.answers.nbytes
            + self.spill.vectors.nbytes + self.spill.answers.nbytes)
        return out

    def _counters(self) -> dict:
        return {"spill": self.spill.state_dict(),
                "spill_last_use": self._spill_last_use,
                "spill_clock": np.asarray(self._spill_clock),
                "hits": np.asarray(self.hits),
                "misses": np.asarray(self.misses),
                "generation": np.asarray(self.generation),
                # was a serving mirror or graph index materialized at
                # snapshot time? Then the restore-rebuild reproduces it
                # without a generation bump; a pending invalidation bumps
                "mirror_live": np.asarray(self._dev is not None
                                          or self._hnsw is not None),
                "dev_rebuilds": np.asarray(self.dev_rebuilds),
                "dev_row_writes": np.asarray(self.dev_row_writes),
                "dev_swaps": np.asarray(self.dev_swaps),
                "quant_rescored": np.asarray(self.quant_rescored),
                "quant_fallbacks": np.asarray(self.quant_fallbacks)}

    def state_dict(self) -> dict:
        """Full snapshot of the live state (DESIGN.md §12)."""
        st = self._quant_state_entries() \
            if self.backend == "pallas_q8" else {}
        return {**st, **self._counters(),
                "centroids": self.centroids.state_dict(),
                "layout": self.layout_dict()}

    def _quant_state_entries(self) -> dict:
        """Codes + scales for the full [centroids; spill] row set
        (requantized host-side: bit-deterministic, identical to the live
        codes); err_max keeps the live mirror's running max."""
        vecs = np.concatenate([self.centroids.vectors, self.spill.vectors])
        codes, scales, err = quantize_rows(
            vecs.reshape(len(vecs), self.dim), width=_lane_pad(self.dim))
        err_max = float(err.max()) if len(err) else 0.0
        if self._dev is not None:
            err_max = max(err_max, float(self._dev.err_max))
        return {"quant": {"codes": codes, "scales": scales,
                          "err_max": np.asarray(err_max)}}

    def state_delta(self) -> dict:
        """Delta snapshot: what mutates between refresh commits — centroid
        access counts (with the ids as the epoch witness), the spill
        region, recency and counters."""
        return {"centroid_ids": self.centroids.ids,
                "centroid_access": self.centroids.access_count,
                **self._counters()}

    def _load_common(self, state: dict) -> None:
        # np.array (copy): an in-process restore must not alias the donor's
        # live recency buffer
        self._spill_last_use = np.array(state["spill_last_use"], np.int64)
        self._spill_clock = int(state["spill_clock"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.generation = int(state.get("generation", self.generation))
        for name in ("dev_rebuilds", "dev_row_writes", "dev_swaps",
                     "quant_rescored", "quant_fallbacks"):
            setattr(self, name, int(state.get(name, getattr(self, name))))

    def load_state(self, state: dict) -> None:
        """Restore a full snapshot (DESIGN.md §12); the mirror is rebuilt
        once, on the next lookup or by :meth:`rebuild_mirror`."""
        cent = CentroidStore.from_state(state["centroids"])
        if cent.vectors.shape[1] != self.dim:
            raise ValueError(f"snapshot dim {cent.vectors.shape[1]} != "
                             f"cache dim {self.dim}")
        self.centroids = cent
        self.spill = CentroidStore.from_state(state["spill"])
        self._load_common(state)
        self._quant_restore = state.get("quant")
        self._restore_pending = bool(state.get("mirror_live",
                                               "generation" in state))
        self._invalidate()

    def load_delta(self, state: dict) -> None:
        """Overlay a delta snapshot on an already-restored base (the full
        snapshot of the same refresh epoch; the caller checks epochs)."""
        access = np.array(state["centroid_access"], np.float64)
        ids = np.asarray(state.get("centroid_ids", ()), np.int64)
        if len(access) != len(self.centroids) \
                or not np.array_equal(ids, self.centroids.ids):
            raise ValueError(
                "delta centroid region does not match the restored base "
                "— the delta belongs to another refresh epoch")
        self.centroids.access_count = access
        self.spill = CentroidStore.from_state(state["spill"])
        self._load_common(state)
        # the delta's spill supersedes the full snapshot's codes; the
        # rebuild requantizes (bit-deterministic, so still identical)
        self._quant_restore = None
        self._restore_pending = bool(state.get("mirror_live", True))
        self._invalidate()

    def rebuild_mirror(self) -> None:
        """Re-materialize the serving state from the restored host arrays
        (warm restart): the device mirror, or the graph index for hnsw,
        built once and keeping the restored generation."""
        if len(self.centroids) + len(self.spill) == 0:
            self._restore_pending = False
            return
        if self.backend == "hnsw":
            self._hnsw_lookup(np.zeros((1, self.dim), np.float32))
        else:
            self._device_state()
