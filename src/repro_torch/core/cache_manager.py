"""SISO-CacheManager — Algorithm 1 (merge -> filter -> update).

Faithful semantics:
  * MergeCentroids: each repository centroid either augments the
    cluster_size of its closest cached centroid (cos-sim > theta_C) or is
    added as a new entry with access_count = inf (fresh-entry priority).
  * FilteringCentroids: while over capacity, evict ascending
    (cluster_size, access_count); then decay cluster_size by /1.1 and zero
    all access counts (lines 16–21).
  * Update: progressive replacement in small groups so the online path is
    never blocked (§4.2) — exposed as a chunk iterator the server drains
    between batches, and as the resumable :class:`MergePlanner` the
    RefreshPipeline advances one bounded block per serving tick
    (DESIGN.md §10).

Ported from ``repro/core/cache_manager.py``: the device passes run as
torch on ``device`` (:mod:`repro_torch.core.clustering`); the host logic is
carried over.

The merge is fully vectorized and blocked on-device: repo centroids are
matched against the current cache with a blocked top-1 pass; the unmatched
remainder is deduplicated against itself with a blocked upper-triangular
similarity pass in descending cluster_size order, which is
order-equivalent to Algorithm 1's sequential scan for any fixed processing
order (:func:`merge_centroids_reference` keeps the seed scan as the
equivalence oracle).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.clustering import (_pow2_pad, gt_mask_block,
                                         run_budgeted, top1_block)
from repro_torch.core.store import CentroidStore
from repro_torch.core.tenancy import fair_share_take
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class RefreshStats:
    merged: int = 0
    added: int = 0
    evicted: int = 0


class MergePlanner:
    """Resumable, blocked MergeCentroids (Algorithm 1 lines 6-13).

    Phases (one bounded device pass per ``step()`` unit):

      match   blocked top-1 of repo centroids against the cached set —
              absorbed mass lands on the closest cached centroid;
      dedup   blocked strict-upper-triangular similarity pass over the
              unmatched remainder in descending cluster_size order; the
              greedy keep/absorb scan runs over the harvested boolean
              rows (same semantics as the sequential reference scan).

    Corpora are pow2-padded with zero rows for compile-shape stability;
    theta_C must be positive so padding can never clear it.
    """

    def __init__(self, c_cur: CentroidStore, c_repo: CentroidStore,
                 theta_c: float, block: int = 512,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.theta_c = float(theta_c)
        self.stats = RefreshStats()
        self.c_new = c_cur.copy()
        self.c_repo = c_repo
        self.block = max(1, block)
        self._done = False
        r, n = len(c_repo), len(self.c_new)
        if r == 0:
            self._done = True
            return
        self._best = np.full((r,), -np.inf, np.float32)
        self._closest = np.zeros((r,), np.int64)
        self._pos = 0
        if n > 0:
            pad = _pow2_pad(n)
            cur = np.zeros((pad, c_cur.dim), np.float32)
            cur[:n] = self.c_new.vectors
            self._cur_t = torch.tensor(cur, device=self.device)
            self._phase = "match"
        else:
            self._phase = "dedup"
            self._begin_dedup(np.arange(r))

    # ------------------------------------------------------------------ api

    @property
    def done(self) -> bool:
        return self._done

    def step(self, budget_s: float = 0.0) -> bool:
        """Advance bounded units until ~budget_s elapsed (0 -> one unit).
        Returns True while work remains."""
        return run_budgeted(self._unit, lambda: self._done, budget_s)

    def _unit(self) -> None:
        if self._phase == "match":
            self._unit_match()
        else:
            self._unit_dedup()

    def run(self) -> tuple[CentroidStore, RefreshStats]:
        while self.step(float("inf")):
            pass
        return self.result()

    def result(self) -> tuple[CentroidStore, RefreshStats]:
        assert self._done
        return self.c_new, self.stats

    # ---------------------------------------------------------------- match

    def _unit_match(self) -> None:
        repo = self.c_repo
        s = self._pos
        e = min(s + self.block, len(repo))
        blk = np.zeros((self.block, repo.dim), np.float32)
        blk[:e - s] = repo.vectors[s:e]
        best, idx = top1_block(torch.tensor(blk, device=self.device),
                               self._cur_t, len(self.c_new))
        self._best[s:e] = best.cpu().numpy()[:e - s]
        self._closest[s:e] = idx.cpu().numpy()[:e - s]
        self._pos = e
        if e >= len(repo):
            hit = self._best > self.theta_c
            # lines 9-10: absorb cluster mass into the closest centroid
            np.add.at(self.c_new.cluster_size, self._closest[hit],
                      repo.cluster_size[hit])
            self.stats.merged = int(hit.sum())
            self._begin_dedup(np.where(~hit)[0])

    # ---------------------------------------------------------------- dedup

    def _begin_dedup(self, rest: np.ndarray) -> None:
        self._phase = "dedup"
        if len(rest) == 0:
            self._done = True
            return
        repo = self.c_repo
        # descending cluster_size processing order (stable)
        self._order = rest[np.argsort(-repo.cluster_size[rest],
                                      kind="stable")]
        r = len(self._order)
        self._vecs = repo.vectors[self._order]
        self._sizes = repo.cluster_size[self._order].copy()
        self._taken = np.zeros((r,), bool)
        self._keep: list[int] = []
        pad = _pow2_pad(r)
        corpus = np.zeros((pad, repo.dim), np.float32)
        corpus[:r] = self._vecs
        self._corpus_t = torch.tensor(corpus, device=self.device)
        self._pos = 0

    def _unit_dedup(self) -> None:
        r = len(self._order)
        s = self._pos
        e = min(s + self.block, r)
        blk = np.zeros((self.block, self.c_repo.dim), np.float32)
        blk[:e - s] = self._vecs[s:e]
        mask = gt_mask_block(torch.tensor(blk, device=self.device),
                             self._corpus_t, self.theta_c).cpu().numpy()
        # greedy keep/absorb over this block's rows, reference order: a
        # kept row absorbs every later untaken row above theta_C (sizes
        # of absorbed rows are their originals — they were never kept)
        for p in range(s, e):
            if self._taken[p]:
                continue
            dup = np.flatnonzero(mask[p - s, p + 1:r]
                                 & ~self._taken[p + 1:]) + p + 1
            self._sizes[p] += self._sizes[dup].sum()
            self._taken[dup] = True
            self._keep.append(p)
        self._pos = e
        if e >= r:
            self._finish_dedup()

    def _finish_dedup(self) -> None:
        keep_rows = np.asarray(self._keep, int)
        repo, order = self.c_repo, self._order
        # lines 12-13: new centroids enter with access_count = inf
        self.c_new.add(self._vecs[keep_rows], repo.answers[order][keep_rows],
                       self._sizes[keep_rows], access_count=np.inf,
                       answer_id=repo.answer_id[order][keep_rows])
        self.stats.added = int(len(keep_rows))
        # intra-repo duplicates absorbed into an earlier-added centroid are
        # "merged" in Algorithm 1's sequential semantics (lines 9-10)
        self.stats.merged += int(len(order) - len(keep_rows))
        self._done = True


def merge_centroids(c_cur: CentroidStore, c_repo: CentroidStore,
                    theta_c: float, device: DeviceLike = None
                    ) -> tuple[CentroidStore, RefreshStats]:
    """Vectorized Algorithm-1 merge (see :class:`MergePlanner`); same
    semantics as :func:`merge_centroids_reference`."""
    return MergePlanner(c_cur, c_repo, theta_c, device=device).run()


def merge_centroids_reference(c_cur: CentroidStore, c_repo: CentroidStore,
                              theta_c: float
                              ) -> tuple[CentroidStore, RefreshStats]:
    """The seed implementation, kept verbatim: host matmuls and an O(R^2)
    Python dedup scan (equivalence oracle for tests/benchmarks)."""
    stats = RefreshStats()
    c_new = c_cur.copy()
    if len(c_repo) == 0:
        return c_new, stats
    if len(c_new) > 0:
        sims = c_repo.vectors @ c_new.vectors.T  # (R, N)
        closest = np.argmax(sims, axis=1)
        best = sims[np.arange(len(c_repo)), closest]
        hit = best > theta_c
        np.add.at(c_new.cluster_size, closest[hit], c_repo.cluster_size[hit])
        stats.merged = int(hit.sum())
        rest = np.where(~hit)[0]
    else:
        rest = np.arange(len(c_repo))
    if len(rest):
        order = rest[np.argsort(-c_repo.cluster_size[rest], kind="stable")]
        vecs = c_repo.vectors[order]
        sizes = c_repo.cluster_size[order].copy()
        taken = np.zeros(len(order), bool)
        keep_rows = []
        for i in range(len(order)):
            if taken[i]:
                continue
            sims_i = vecs[i] @ vecs[i + 1:].T if i + 1 < len(order) else \
                np.zeros((0,))
            dup = np.where((sims_i > theta_c) & ~taken[i + 1:])[0] + i + 1
            sizes[i] += sizes[dup].sum()
            taken[dup] = True
            keep_rows.append(i)
        keep_rows = np.asarray(keep_rows, int)
        c_new.add(vecs[keep_rows], c_repo.answers[order][keep_rows],
                  sizes[keep_rows], access_count=np.inf,
                  answer_id=c_repo.answer_id[order][keep_rows])
        stats.added = int(len(keep_rows))
        stats.merged += int(len(rest) - len(keep_rows))
    return c_new, stats


def filter_centroids(c_new: CentroidStore, capacity: int,
                     decay: float = 1.1, collect_evicted: bool = False,
                     tenants: np.ndarray | None = None):
    """capacity: max number of entries (TotalMemoryUsage / bytes_per_entry).

    With ``collect_evicted`` the return gains a third element: a store of
    the evicted rows (pre-decay field values), so a tiered hierarchy can
    demote cold centroids instead of discarding them (DESIGN.md §13).

    ``tenants`` (one namespace id per row, DESIGN.md §14) switches victim
    selection to fair-share: the ascending (cluster_size, access_count)
    order becomes a per-row rank, and rows leave from the most-occupying
    namespace first, coldest-ranked within it. None keeps Algorithm 1's
    unweighted prefix eviction."""
    evicted = 0
    evicted_store = None
    if len(c_new) > capacity:
        # ascending (cluster_size, access_count); evict the prefix
        order = np.lexsort((c_new.access_count, c_new.cluster_size))
        evicted = len(c_new) - capacity
        if tenants is not None:
            # rank key: fair_share_take's within-namespace ascending-key
            # order then equals the composite lexsort order
            rank = np.empty(len(c_new), np.int64)
            rank[order] = np.arange(len(c_new))
            victims = np.sort(fair_share_take(tenants, rank, evicted))
            keep = np.setdiff1d(np.arange(len(c_new)), victims)
        else:
            keep = np.sort(order[len(c_new) - capacity:])
            victims = np.sort(order[:evicted])
        if collect_evicted:
            evicted_store = c_new.copy()
            evicted_store.take(victims)
        c_new.take(keep)
    elif collect_evicted:
        evicted_store = CentroidStore(c_new.dim, c_new.answer_dim)
    # lines 19-21: decay semantic locality; reset short-term popularity
    c_new.cluster_size = c_new.cluster_size / decay
    c_new.access_count = np.zeros_like(c_new.access_count)
    if collect_evicted:
        return c_new, evicted, evicted_store
    return c_new, evicted


class CacheManager:
    """Orchestrates Algorithm 1 against a live SemanticCache."""

    def __init__(self, theta_c: float = 0.86, decay: float = 1.1,
                 update_group: int = 1024, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.theta_c = theta_c
        self.decay = decay
        self.update_group = update_group

    def plan(self, c_cur: CentroidStore, c_repo: CentroidStore,
             capacity: int, collect_evicted: bool = False,
             tenant_of=None):
        c_new, stats = merge_centroids(c_cur, c_repo, self.theta_c,
                                       device=self.device)
        # resolve row ownership once, on the merged pre-filter store
        # (answer_id -> namespace; DESIGN.md §14), None = unweighted
        tenants = tenant_of(c_new.answer_id) if tenant_of is not None \
            else None
        if collect_evicted:
            c_new, stats.evicted, evicted = filter_centroids(
                c_new, capacity, self.decay, collect_evicted=True,
                tenants=tenants)
            return c_new, stats, evicted
        c_new, stats.evicted = filter_centroids(c_new, capacity, self.decay,
                                                tenants=tenants)
        return c_new, stats

    def update_chunks(self, c_new: CentroidStore) -> Iterator[CentroidStore]:
        """Progressive update: yield c_new in id-ordered groups; the serving
        cache applies one group between query batches (no long lock)."""
        n = len(c_new)
        for s in range(0, max(n, 1), self.update_group):
            chunk = c_new.copy()
            chunk.take(np.arange(s, min(s + self.update_group, n)))
            yield chunk
