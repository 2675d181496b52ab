"""Locality-ordered HNSW (paper §4.3).

Standard HNSW (Malkov & Yashunin) with SISO's twist: levels are assigned by
semantic locality rank instead of geometric randomness — centroids with the
largest cluster_size sit at the top levels, so popular regions are reached
in the first hops and searches terminate early. The level *distribution*
matches HNSW's (|level >= l| ~ N / M^l), so graph properties are preserved.

This is the host-fidelity path (port of ``repro/core/hnsw.py``, carried
over as numpy); the device path is the dense/pallas cosine_topk scan (see
semantic_cache.py / kernels/cosine_topk).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class HNSW:
    vectors: np.ndarray                 # (N, d) L2-normalized
    m: int = 16
    ef_construction: int = 64
    ef_search: int = 32
    levels: np.ndarray = None           # (N,) int
    neighbors: list = None              # neighbors[l][i] -> list[int]
    entry: int = -1
    max_level: int = 0

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, vectors: np.ndarray, locality: np.ndarray | None = None,
              m: int = 16, ef_construction: int = 64, ef_search: int = 32,
              seed: int = 0) -> "HNSW":
        n = len(vectors)
        idx = cls(vectors=np.asarray(vectors, np.float32), m=m,
                  ef_construction=ef_construction, ef_search=ef_search)
        if n == 0:
            idx.levels = np.zeros((0,), int)
            idx.neighbors = []
            return idx
        idx.levels = cls._assign_levels(n, m, locality, seed)
        idx.max_level = int(idx.levels.max())
        idx.neighbors = [[[] for _ in range(n)]
                         for _ in range(idx.max_level + 1)]
        order = np.argsort(-idx.levels, kind="stable")  # top levels first
        idx.entry = int(order[0])
        for i in order[1:]:
            idx._insert(int(i))
        return idx

    @staticmethod
    def _assign_levels(n: int, m: int, locality: np.ndarray | None,
                       seed: int) -> np.ndarray:
        if locality is None:  # classic geometric levels
            rng = np.random.default_rng(seed)
            ml = 1.0 / math.log(m)
            return np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(int)
        # locality-ordered: rank r (0 = most popular) gets the level that the
        # geometric distribution would give its quantile: |lvl >= l| = n/m^l
        ranks = np.empty(n, int)
        ranks[np.argsort(-np.asarray(locality), kind="stable")] = np.arange(n)
        levels = np.floor(np.log(n / (ranks + 1.0)) / math.log(m)).astype(int)
        return np.maximum(levels, 0)

    # ----------------------------------------------------------------- search

    def _sims(self, q: np.ndarray, ids: list[int]) -> np.ndarray:
        return self.vectors[ids] @ q

    def _greedy(self, q: np.ndarray, start: int, level: int) -> int:
        cur = start
        cur_sim = float(self.vectors[cur] @ q)
        improved = True
        while improved:
            improved = False
            nbrs = self.neighbors[level][cur]
            if not nbrs:
                break
            sims = self._sims(q, nbrs)
            j = int(np.argmax(sims))
            if sims[j] > cur_sim:
                cur, cur_sim = nbrs[j], float(sims[j])
                improved = True
        return cur

    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      level: int) -> list[tuple[float, int]]:
        visited = {entry}
        e_sim = float(self.vectors[entry] @ q)
        cand = [(-e_sim, entry)]           # max-heap by sim
        found = [(e_sim, entry)]           # min-heap of best ef
        while cand:
            negs, c = heapq.heappop(cand)
            if -negs < found[0][0] and len(found) >= ef:
                break
            for nb in self.neighbors[level][c]:
                if nb in visited:
                    continue
                visited.add(nb)
                s = float(self.vectors[nb] @ q)
                if len(found) < ef or s > found[0][0]:
                    heapq.heappush(cand, (-s, nb))
                    heapq.heappush(found, (s, nb))
                    if len(found) > ef:
                        heapq.heappop(found)
        return sorted(found, reverse=True)

    def search(self, q: np.ndarray, k: int = 1,
               ef: int | None = None) -> list[tuple[int, float]]:
        """Returns [(index, similarity)] best-first."""
        if len(self.vectors) == 0:
            return []
        ef = ef or max(self.ef_search, k)
        cur = self.entry
        for level in range(self.max_level, 0, -1):
            cur = self._greedy(q, cur, level)
        found = self._search_layer(q, cur, ef, 0)
        return [(i, s) for s, i in found[:k]]

    def search_batch(self, queries: np.ndarray, k: int = 1,
                     ef: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Top-1-per-query over a (B, d) batch: (sims (B,), idx (B,)).

        Graph traversal is inherently sequential per query; this packs the
        per-query results into arrays so callers get the same contract as
        the dense/pallas backends (misses score -1)."""
        queries = np.atleast_2d(queries)
        sims = np.full(len(queries), -1.0, np.float32)
        idx = np.zeros(len(queries), np.int64)
        for b, q in enumerate(queries):
            res = self.search(q, k=k, ef=ef)
            if res:
                idx[b], sims[b] = res[0]
        return sims, idx

    # ----------------------------------------------------------------- insert

    def _insert(self, i: int) -> None:
        q = self.vectors[i]
        lvl = int(self.levels[i])
        cur = self.entry
        for level in range(self.max_level, lvl, -1):
            cur = self._greedy(q, cur, level)
        for level in range(min(lvl, self.max_level), -1, -1):
            found = self._search_layer(q, cur, self.ef_construction, level)
            m_max = self.m if level > 0 else 2 * self.m
            selected = [j for _, j in found[: self.m]]
            self.neighbors[level][i] = selected
            for j in selected:
                lst = self.neighbors[level][j]
                lst.append(i)
                if len(lst) > m_max:  # prune to the closest m_max
                    sims = self._sims(self.vectors[j], lst)
                    keep = np.argsort(-sims)[:m_max]
                    self.neighbors[level][j] = [lst[t] for t in keep]
            cur = selected[0] if selected else cur
