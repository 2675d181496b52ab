"""Cache baselines the paper compares against (§5.1, §5.2.6); port of
``repro/serving/baselines.py``, carried over as numpy.

* ``VectorCache`` — GPTCache-style per-query vector cache with pluggable
  replacement: lru (GPTCache default), lfu, fifo, rr (§5.2.6), or
  ``optimal`` (unlimited memory oracle of Fig. 3/4).
* ``NoCache`` — the vLLM path (every request hits the engine).

All front-ends implement the :class:`repro_torch.serving.CacheFrontend`
protocol (lookup/record/stats/state_dict); ``insert`` is the historical
spelling of ``record`` and both keep working.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.semantic_cache import LookupResult


@dataclass
class FrontendTimes:
    """Per-lookup latency contributions (Table 4, seconds)."""
    embed: float = 2.63e-3
    search_hit: float = 23.98e-3
    search_miss: float = 23.99e-3


class NoCache:
    """vLLM baseline: no semantic caching."""
    times = FrontendTimes(embed=0.0, search_hit=0.0, search_miss=0.0)
    theta_r = None

    def lookup(self, vectors: np.ndarray, now: float = 0.0,
               user_ids=None) -> LookupResult:
        vectors = np.atleast_2d(vectors)
        B, d = vectors.shape
        return LookupResult(np.zeros(B, bool), np.full(B, -1.0, np.float32),
                            np.zeros((B, d), np.float32),
                            np.full(B, -1, np.int64), np.full(B, -1, np.int64),
                            np.full(B, -1, np.int8))

    def insert(self, vector, answer, answer_id: int = -1) -> None:
        pass

    def record(self, vector, answer, answer_id: int = -1) -> None:
        """CacheFrontend protocol spelling of insert()."""
        self.insert(vector, answer, answer_id=answer_id)

    def stats(self) -> dict:
        return {"hit_ratio": 0.0}

    def state_dict(self) -> dict:
        return {}       # stateless by definition


class VectorCache:
    """Individual-vector semantic cache (GPTCache equivalent).

    capacity: max entries. policy: lru | lfu | fifo | rr | optimal.
    theta_r fixed (0.86 in the paper's comparisons).
    """

    def __init__(self, dim: int, answer_dim: int, capacity: int,
                 policy: str = "lru", theta_r: float = 0.86,
                 seed: int = 0):
        assert policy in ("lru", "lfu", "fifo", "rr", "optimal")
        self.dim, self.answer_dim = dim, answer_dim
        self.capacity = capacity
        self.policy = policy
        self.theta_r = theta_r
        self.rng = np.random.default_rng(seed)
        self.vectors = np.zeros((0, dim), np.float32)
        self.answers = np.zeros((0, answer_dim), np.float32)
        self.answer_id = np.zeros((0,), np.int64)
        self.meta = np.zeros((0,), np.float64)   # policy metric
        self._clock = 0
        self._rr_ptr = 0
        self.hits = 0
        self.misses = 0
        self.times = FrontendTimes()

    def __len__(self) -> int:
        return len(self.vectors)

    # ------------------------------------------------------------------ api

    def lookup(self, vectors: np.ndarray, now: float = 0.0,
               user_ids=None) -> LookupResult:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        B = len(vectors)
        sims = np.full(B, -1.0, np.float32)
        idx = np.full(B, -1, np.int64)
        if len(self.vectors):
            m = vectors @ self.vectors.T
            idx = np.argmax(m, axis=1)
            sims = m[np.arange(B), idx].astype(np.float32)
        hit = sims >= self.theta_r
        answer = np.zeros((B, self.answer_dim), np.float32)
        aid = np.full(B, -1, np.int64)
        rows = idx[hit]
        if len(rows):
            # vectorized host gather + batched policy touch — no per-hit
            # Python loop on the serving path (cf. SemanticCache.lookup)
            answer[hit] = self.answers[rows]
            aid[hit] = self.answer_id[rows]
            self._touch_batch(rows)
        self.hits += int(hit.sum())
        self.misses += int(B - hit.sum())
        entry = np.where(hit, idx, -1).astype(np.int64)
        region = np.where(hit, 1, -1).astype(np.int8)
        return LookupResult(hit, sims, answer, aid, entry, region)

    def insert(self, vector: np.ndarray, answer: np.ndarray,
               answer_id: int = -1) -> None:
        self._clock += 1
        if self.policy != "optimal" and len(self.vectors) >= self.capacity:
            v = self._victim()
            self.vectors[v] = vector
            self.answers[v] = answer
            self.answer_id[v] = answer_id
            self.meta[v] = self._fresh_meta()
        else:
            self.vectors = np.concatenate([self.vectors,
                                           np.atleast_2d(vector)])
            self.answers = np.concatenate([self.answers,
                                           np.atleast_2d(answer)])
            self.answer_id = np.append(self.answer_id, answer_id)
            self.meta = np.append(self.meta, self._fresh_meta())

    def record(self, vector: np.ndarray, answer: np.ndarray,
               answer_id: int = -1) -> None:
        """CacheFrontend protocol spelling of insert()."""
        self.insert(vector, answer, answer_id=answer_id)

    def state_dict(self) -> dict:
        return {"vectors": self.vectors, "answers": self.answers,
                "answer_id": self.answer_id, "meta": self.meta,
                "clock": np.asarray(self._clock),
                "rr_ptr": np.asarray(self._rr_ptr),
                "hits": np.asarray(self.hits),
                "misses": np.asarray(self.misses)}

    # --------------------------------------------------------------- policy

    def _fresh_meta(self) -> float:
        if self.policy == "lfu":
            return 1.0
        return float(self._clock)       # lru / fifo timestamp; rr ignores

    def _touch_batch(self, rows: np.ndarray) -> None:
        """Policy bookkeeping for one batch of hit rows, duplicate-safe:
        LRU assigns per-hit clock ticks in batch order (duplicates keep
        the latest, as the sequential loop did); LFU counts every hit of
        a row, including duplicates within the batch (np.add.at)."""
        if self.policy == "lru":
            self.meta[rows] = self._clock + 1 + np.arange(len(rows))
            self._clock += len(rows)
        elif self.policy == "lfu":
            np.add.at(self.meta, rows, 1.0)

    def _victim(self) -> int:
        if self.policy == "rr":
            v = self._rr_ptr % self.capacity
            self._rr_ptr += 1
            return v
        return int(np.argmin(self.meta))  # oldest (lru/fifo) or least-freq

    # -------------------------------------------------------------- metrics

    @property
    def hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def stats(self) -> dict:
        return {"hit_ratio": self.hit_ratio, "entries": len(self),
                "policy": self.policy}
