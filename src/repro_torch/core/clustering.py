"""SISO-Cluster: queries -> centroids (paper §4.1), ported.

Community detection (the sentence-transformers fast-clustering algorithm
the paper selects in Table 2): every vector with >= min_community_size
neighbours above theta_C seeds a community; communities are extracted
greedily in decreasing size so each vector joins its largest community.

The reference's jitted device passes become plain batched torch on
``device`` (none of them is a Pallas kernel, so they use ``torch.matmul``;
TF32 is off, see :mod:`repro_torch.device`). The resumable
:class:`CommunityDetector` and its greedy host scans are carried over
unchanged; :func:`community_detection_reference` keeps the seed
implementation as the equivalence oracle.

Thresholds are assumed positive (cosine communities): zero padding rows
can then never clear them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class Cluster:
    centroid: np.ndarray          # (d,) L2-normalized mean of members
    members: np.ndarray           # member indices into the input array
    representative: int           # index of member closest to the centroid
    cluster_size: int = 0

    def __post_init__(self):
        self.cluster_size = int(len(self.members))


# ---------------------------------------------------------------------------
# device passes (shared with cache_manager's MergePlanner)
# ---------------------------------------------------------------------------


def _thr(threshold: float, device) -> torch.Tensor:
    """The threshold as an f32 scalar: the reference compares f32 sims
    against a weakly typed (f32) threshold."""
    return torch.tensor(np.float32(threshold), device=device)


def _block_sims(block: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return block @ emb.T


def _counts_fused(queries: torch.Tensor, emb: torch.Tensor, threshold,
                  block: int) -> torch.Tensor:
    """All neighbour counts, one (block, N) tile at a time on the device;
    only the (N,) counts leave it."""
    return torch.cat([_count_block(blk, emb, threshold)
                      for blk in queries.split(block)])


def _count_block(block: torch.Tensor, emb: torch.Tensor,
                 threshold) -> torch.Tensor:
    """One bounded count tile (the RefreshPipeline's incremental unit)."""
    return (block @ emb.T >= _thr(threshold, emb.device)).sum(
        dim=1, dtype=torch.int32)


def ge_mask_block(block: torch.Tensor, emb: torch.Tensor,
                  threshold) -> torch.Tensor:
    """Boolean >= threshold neighbour rows for a block of queries."""
    return block @ emb.T >= _thr(threshold, emb.device)


def gt_mask_block(block: torch.Tensor, emb: torch.Tensor,
                  threshold) -> torch.Tensor:
    """Strict > threshold variant (Algorithm 1's merge comparisons)."""
    return block @ emb.T > _thr(threshold, emb.device)


def top1_block(block: torch.Tensor, emb: torch.Tensor,
               n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(best sim, argmax row) per query over the first n_valid corpus rows
    (the corpus is pow2-padded with zero rows)."""
    sims = block @ emb.T
    cols = torch.arange(emb.shape[0], device=emb.device)
    sims = torch.where(cols[None, :] < n_valid, sims,
                       torch.full_like(sims, float("-inf")))
    idx = torch.argmax(sims, dim=1)
    best = sims.gather(1, idx[:, None])[:, 0]
    return best, idx.to(torch.int32)


def _pow2_pad(n: int, floor: int = 128) -> int:
    return max(floor, 1 << (n - 1).bit_length()) if n else floor


def run_budgeted(unit, done, budget_s: float) -> bool:
    """The resumable-budget contract shared by the blocked state machines
    (CommunityDetector, MergePlanner): advance bounded units until
    ~budget_s elapsed (0 -> exactly one unit). Returns True while work
    remains."""
    if done():
        return False
    t0 = time.perf_counter()
    while True:
        unit()
        if done():
            return False
        if time.perf_counter() - t0 >= budget_s:
            return True


def _stage(emb: np.ndarray, pad_n: int, device) -> torch.Tensor:
    padded = np.zeros((pad_n, emb.shape[1]), np.float32)
    padded[:len(emb)] = emb
    return torch.tensor(padded, device=device)


# ---------------------------------------------------------------------------
# vectorized community detection (resumable)
# ---------------------------------------------------------------------------


class CommunityDetector:
    """Resumable community detection (see the reference docstring).

    Phases (each ``step()`` advances one bounded unit): ``stage`` (pad +
    upload), ``counts`` (fused or per tile), ``extract`` (seed blocks +
    greedy claim scan over ``scan_rows`` rows per unit) and ``finalize``
    (segment sums, ``finalize_rows`` member rows per unit). Semantics match
    :func:`community_detection_reference`.
    """

    def __init__(self, emb: np.ndarray, threshold: float = 0.86,
                 min_community_size: int = 1, count_block: int = 1024,
                 seed_block: int = 256, scan_rows: int = 64,
                 finalize_rows: int = 8192, fused_counts: bool = True,
                 device: DeviceLike = None):
        emb = np.ascontiguousarray(np.atleast_2d(emb), np.float32)
        self.device = resolve_device(device)
        self.emb = emb
        self.n, self.d = emb.shape
        self.threshold = float(threshold)
        self.min_size = int(min_community_size)
        self.pad_n = _pow2_pad(self.n)
        self.count_block = min(1 << max(0, count_block.bit_length() - 1),
                               self.pad_n)
        self.seed_block = min(1 << max(0, seed_block.bit_length() - 1),
                              self.pad_n)
        self.scan_rows = scan_rows
        self.finalize_rows = finalize_rows
        self.fused_counts = fused_counts
        self._emb_t: torch.Tensor | None = None   # staged by the first unit
        self.counts = np.zeros((self.n,), np.int64)
        self._phase = "stage" if self.n else "done"
        self._pos = 0
        self._order: np.ndarray | None = None
        self._cursor = 0
        self._assigned = np.zeros((self.n,), bool)
        self._members: list[np.ndarray] = []
        self._mask: np.ndarray | None = None
        self._seeds: np.ndarray | None = None
        self._row = 0
        self._fin: dict | None = None
        self._clusters: list[Cluster] | None = None

    # ------------------------------------------------------------------ api

    @property
    def done(self) -> bool:
        return self._phase == "done"

    def step(self, budget_s: float = 0.0) -> bool:
        return run_budgeted(self._unit, lambda: self.done, budget_s)

    def run(self) -> list[Cluster]:
        while self.step(float("inf")):
            pass
        return self.result()

    def result(self) -> list[Cluster]:
        """Per-cluster objects, built lazily on first call."""
        assert self.done
        if self._clusters is None:
            if self._fin is None:      # empty input: no finalize ever ran
                self._clusters = []
                return self._clusters
            f = self._fin
            n_comm = len(self._members)
            singles_start = (int(f["offsets"][n_comm])
                             if n_comm < len(f["sizes"]) else 0)
            self._clusters = []
            for rank, j in enumerate(f["order"]):
                if j < n_comm:
                    members = self._members[j]
                else:
                    k = singles_start + (j - n_comm)
                    members = f["flat"][k:k + 1]
                self._clusters.append(Cluster(
                    centroid=self._cents[rank], members=members,
                    representative=int(self._reps[rank])))
        return self._clusters

    def result_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(centroids (K, d), representatives (K,), sizes (K,)) in final
        sorted order."""
        assert self.done
        return self._cents, self._reps, self._sizes

    # ---------------------------------------------------------------- units

    def _unit(self) -> None:
        getattr(self, f"_unit_{self._phase}")()

    def _unit_stage(self) -> None:
        self._emb_t = _stage(self.emb, self.pad_n, self.device)
        self._phase = "counts"

    def _unit_counts(self) -> None:
        if self.fused_counts:
            c = _counts_fused(self._emb_t, self._emb_t, self.threshold,
                              self.count_block).cpu().numpy()
            self.counts = c[:self.n].astype(np.int64)
            self._finish_counts()
            return
        s = self._pos
        e = min(s + self.count_block, self.pad_n)
        c = _count_block(self._emb_t[s:s + self.count_block], self._emb_t,
                         self.threshold).cpu().numpy()
        take = min(e, self.n) - s
        if take > 0:
            self.counts[s:s + take] = c[:take]
        self._pos = e
        if self._pos >= self.n:
            self._finish_counts()

    def _finish_counts(self) -> None:
        order = np.argsort(-self.counts, kind="stable")
        eligible = self.counts[order] >= self.min_size
        cut = int(np.argmin(eligible)) if not eligible.all() else len(order)
        self._order = order[:cut]
        self._phase = "extract"

    def _unit_extract(self) -> None:
        if self._mask is None:
            if not self._gather():
                self._begin_finalize()
            return
        end = min(self._row + self.scan_rows, len(self._seeds))
        for r in range(self._row, end):
            s = self._seeds[r]
            if self._assigned[s]:
                continue
            members = np.flatnonzero(self._mask[r, :self.n]
                                     & ~self._assigned)
            if len(members) == 0:
                continue
            self._assigned[members] = True
            self._members.append(members)
        self._row = end
        if self._row >= len(self._seeds):
            self._mask = self._seeds = None

    def _gather(self) -> bool:
        """Collect the next <= seed_block unassigned seeds (in count order)
        and compute their boolean neighbour rows. False when exhausted."""
        while self._cursor < len(self._order):
            remaining = self._order[self._cursor:]
            un = np.flatnonzero(~self._assigned[remaining])
            if len(un) == 0:
                self._cursor = len(self._order)
                return False
            take = un[:self.seed_block]
            seeds = remaining[take]
            self._cursor += int(take[-1]) + 1
            pad = np.zeros((self.seed_block,), np.int64)
            pad[:len(seeds)] = seeds
            rows = self._emb_t[torch.tensor(pad, device=self.device)]
            mask = ge_mask_block(rows, self._emb_t,
                                 self.threshold).cpu().numpy()
            self._mask, self._seeds, self._row = mask, seeds, 0
            return True
        return False

    # ------------------------------------------------------------- finalize

    def _begin_finalize(self) -> None:
        singles = np.flatnonzero(~self._assigned)
        sizes = np.array([len(m) for m in self._members]
                         + [1] * len(singles), np.int64)
        flat = (np.concatenate(self._members + [singles])
                if len(self._members) or len(singles)
                else np.zeros((0,), np.int64))
        offsets = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        self._fin = {"flat": flat, "sizes": sizes, "offsets": offsets,
                     "k": 0,
                     "cents": np.zeros((len(sizes), self.d), np.float32),
                     "reps": np.zeros((len(sizes),), np.int64)}
        self._phase = "finalize"
        if len(sizes) == 0:
            self._finish()

    def _unit_finalize(self) -> None:
        """Batched _make_cluster: segment sums -> centroids, segment argmax
        -> representatives (host numpy, carried over)."""
        f = self._fin
        k0 = f["k"]
        rows = 0
        k1 = k0
        while k1 < len(f["sizes"]) and rows < self.finalize_rows:
            rows += int(f["sizes"][k1])
            k1 += 1
        s = int(f["offsets"][k0])
        e = s + rows
        flat = f["flat"][s:e]
        sizes = f["sizes"][k0:k1].astype(np.float64)
        offs = (f["offsets"][k0:k1] - s).astype(np.int64)
        memb = self.emb[flat]
        sums = np.add.reduceat(memb, offs, axis=0)
        means = (sums / sizes[:, None]).astype(np.float32)
        norms = np.maximum(np.linalg.norm(means, axis=1, keepdims=True),
                           1e-9)
        cents = (means / norms).astype(np.float32)
        seg = np.repeat(np.arange(k1 - k0), f["sizes"][k0:k1])
        dots = np.einsum("ij,ij->i", memb, cents[seg])
        maxs = np.maximum.reduceat(dots, offs)
        cand = np.where(dots == maxs[seg], np.arange(len(flat)), len(flat))
        rel = np.minimum.reduceat(cand, offs)
        f["cents"][k0:k1] = cents
        f["reps"][k0:k1] = flat[rel]
        f["k"] = k1
        if k1 >= len(f["sizes"]):
            self._finish()

    def _finish(self) -> None:
        f = self._fin
        order = np.argsort(-f["sizes"], kind="stable")
        self._cents = f["cents"][order]
        self._reps = f["reps"][order]
        self._sizes = f["sizes"][order]
        f["order"] = order
        self._phase = "done"


def neighbor_counts(emb: np.ndarray, threshold: float, block: int = 1024,
                    device: DeviceLike = None) -> np.ndarray:
    """Per-vector neighbour counts at threshold, computed on the device."""
    n = len(emb)
    if n == 0:
        return np.zeros((0,), np.int64)
    pad_n = _pow2_pad(n)
    emb_t = _stage(np.asarray(emb, np.float32), pad_n,
                   resolve_device(device))
    blk = min(1 << max(0, block.bit_length() - 1), pad_n)
    c = _counts_fused(emb_t, emb_t, float(threshold), blk).cpu().numpy()
    return c[:n].astype(np.int64)


def community_detection(emb: np.ndarray, threshold: float = 0.86,
                        min_community_size: int = 1, block: int = 2048,
                        device: DeviceLike = None) -> list[Cluster]:
    """emb: (N, d) L2-normalized. Returns clusters sorted by size desc;
    greedy semantics identical to :func:`community_detection_reference`."""
    det = CommunityDetector(emb, threshold=threshold,
                            min_community_size=min_community_size,
                            count_block=block, seed_block=min(block, 1024),
                            device=device)
    return det.run()


# ---------------------------------------------------------------------------
# seed reference implementation (equivalence oracle for tests)
# ---------------------------------------------------------------------------


def community_detection_reference(emb: np.ndarray, threshold: float = 0.86,
                                  min_community_size: int = 1,
                                  block: int = 2048,
                                  device: DeviceLike = None
                                  ) -> list[Cluster]:
    """The seed implementation: one (1, N) matmul round trip per seed and a
    per-cluster Python _make_cluster loop."""
    n = emb.shape[0]
    if n == 0:
        return []
    emb_t = torch.tensor(np.asarray(emb, np.float32),
                         device=resolve_device(device))
    thr = _thr(threshold, emb_t.device)
    counts = np.zeros((n,), np.int64)
    for s in range(0, n, block):
        sims = _block_sims(emb_t[s:s + block], emb_t)
        counts[s:s + block] = (sims >= thr).sum(dim=1).cpu().numpy()
    order = np.argsort(-counts, kind="stable")
    assigned = np.zeros((n,), bool)
    clusters: list[Cluster] = []
    for seed in order:
        if assigned[seed]:
            continue
        if counts[seed] < min_community_size:
            break
        sims = _block_sims(emb_t[seed][None], emb_t)[0]
        members = np.where((sims >= thr).cpu().numpy() & ~assigned)[0]
        if len(members) == 0:
            continue
        assigned[members] = True
        clusters.append(_make_cluster(emb, members))
    for i in np.where(~assigned)[0]:  # singletons
        clusters.append(_make_cluster(emb, np.array([i])))
    clusters.sort(key=lambda c: -c.cluster_size)
    return clusters


def _make_cluster(emb: np.ndarray, members: np.ndarray) -> Cluster:
    mean = emb[members].mean(axis=0)
    mean = mean / max(np.linalg.norm(mean), 1e-9)
    rep = members[int(np.argmax(emb[members] @ mean))]
    return Cluster(centroid=mean.astype(np.float32), members=members,
                   representative=int(rep))


# ---------------------------------------------------------------------------
# intra-cluster stats (Table 2)
# ---------------------------------------------------------------------------


def _intra_block(rows, memb, rows_seg, seg, rows_gid):
    """One blocked tile of the pairwise pass: per row, the count / sum /
    min of sims against same-cluster members with a larger global index."""
    sims = rows @ memb.T
    cols = torch.arange(memb.shape[0], device=memb.device)
    mask = (rows_seg[:, None] == seg[None, :]) \
        & (rows_gid[:, None] < cols[None, :])
    cnt = mask.sum(dim=1, dtype=torch.int32)
    ssum = torch.where(mask, sims, torch.zeros_like(sims)).sum(dim=1)
    smin = torch.where(mask, sims,
                       torch.full_like(sims, float("inf"))).amin(dim=1)
    return cnt, ssum, smin


def intra_cluster_stats(emb: np.ndarray, clusters: list[Cluster],
                        device: DeviceLike = None) -> tuple[float, float]:
    """(min, mean) intra-cluster cosine similarity — the Table 2 metrics —
    by one blocked pairwise pass on the device."""
    keep = [c for c in clusters if len(c.members) >= 2]
    if not keep:
        return 1.0, 1.0
    dev = resolve_device(device)
    flat = np.concatenate([c.members for c in keep])
    seg_np = np.repeat(np.arange(len(keep)), [len(c.members) for c in keep])
    m = len(flat)
    pad_m = _pow2_pad(m)
    memb_t = _stage(emb[flat], pad_m, dev)
    seg_pad = np.full((pad_m,), -1, np.int32)
    seg_pad[:m] = seg_np
    seg_t = torch.tensor(seg_pad, device=dev)
    block = min(512, pad_m)
    cnt = np.zeros((len(keep),), np.int64)
    ssum = np.zeros((len(keep),), np.float64)
    smin = np.full((len(keep),), np.inf)
    for s in range(0, m, block):
        rgid = torch.arange(s, s + block, device=dev)
        c, su, mn = (x.cpu().numpy() for x in _intra_block(
            memb_t[s:s + block], memb_t, seg_t[s:s + block], seg_t, rgid))
        take = min(block, m - s)
        rows_seg = seg_np[s:s + take]
        np.add.at(cnt, rows_seg, c[:take])
        np.add.at(ssum, rows_seg, su[:take])
        np.minimum.at(smin, rows_seg, mn[:take])
    means = ssum / np.maximum(cnt, 1)
    return float(smin.min()), float(means.mean())
