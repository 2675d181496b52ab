"""SISO facade — the paper's full system wired together (Fig. 8), ported.

Offline path:  query log --SISO-Cluster--> centroid repository
               --SISO-CacheManager (Alg. 1)--> semantic cache refresh
Online path:   queries --embed--> cache lookup @ theta_R --hit--> answer
                                   |miss--> LLM engine
with dynamic theta_R (M/D/1 + T2H), repeated-query escape hatch, and
individual-vector LRU spill for leftover capacity.

The reference's tiered hierarchy (``tiered=``), tenant namespaces
(``tenancy=``) and sharded plane (``shard=``) arrive in later slices and
raise ``NotImplementedError``; ``tenant_ids`` without a tenancy config
takes the single-namespace path, exactly as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from repro_torch.core.cache_manager import CacheManager, RefreshStats
from repro_torch.core.clustering import community_detection
from repro_torch.core.refresh import RefreshPipeline
from repro_torch.core.semantic_cache import LookupResult, SemanticCache
from repro_torch.core.store import CentroidStore
from repro_torch.core.threshold import DynamicThreshold, T2HTable
from repro_torch.device import DeviceLike
from repro_torch.distributed.cache_plane import ShardedCacheConfig


@dataclass
class SISOConfig:
    dim: int = 64
    answer_dim: int = 64
    capacity: int = 4096
    theta_c: float = 0.86            # clustering threshold
    theta_r: float = 0.86            # retrieval threshold (initial / fixed)
    dynamic_threshold: bool = True
    backend: str = "dense"
    spill_lru: bool = True
    rescore_k: int = 16              # quant plane: top-C candidates per
                                     # query for the exact margin rescore
    repeat_sim: float = 0.99         # same-user repeat detection
    repeat_window: float = 60.0      # seconds
    t2h_sample_frac: float = 0.05    # paper: 5% of fresh queries
    refresh_frac: float = 0.10       # re-cluster at +10% new queries (§4.1)
    refresh_min: int = 32            # cold-start floor before the first
                                     # clustering of an un-bootstrapped system
    refresh_async: bool = True       # incremental RefreshPipeline (§10)
    refresh_budget_s: float = 0.002  # ~wall budget of one refresh_tick()
    shard: Optional[Any] = None      # only ShardedCacheConfig(n_shards=1),
                                     # the single-device path; the sharded
                                     # plane is not ported yet and raises
    tiered: Optional[Any] = None     # not ported yet: must stay None
    tenancy: Optional[Any] = None    # not ported yet: must stay None


class SISO:
    def __init__(self, cfg: SISOConfig, slo_latency: float = 1.0,
                 llm_latency: float = 0.5, device: DeviceLike = None):
        for plane, is_set in (
                ("tiered", cfg.tiered is not None),
                ("tenancy", cfg.tenancy is not None),
                ("shard", cfg.shard is not None and not (
                    isinstance(cfg.shard, ShardedCacheConfig)
                    and cfg.shard.n_shards == 1))):
            if is_set:
                raise NotImplementedError(
                    f"SISOConfig.{plane}: the plane is not ported yet")
        self.cfg = cfg
        self.cache = SemanticCache(cfg.dim, cfg.answer_dim, cfg.capacity,
                                   backend=cfg.backend,
                                   spill_lru=cfg.spill_lru,
                                   rescore_k=cfg.rescore_k, device=device)
        self.device = self.cache.device
        self.manager = CacheManager(theta_c=cfg.theta_c, device=self.device)
        self.t2h = T2HTable(np.array([cfg.theta_r]), np.array([0.0]))
        self.threshold = DynamicThreshold(
            self.t2h, slo_latency=slo_latency, llm_latency=llm_latency,
            enabled=cfg.dynamic_threshold)
        self.threshold.theta = cfg.theta_r
        self._user_last: dict = {}      # user -> (vec, t)
        self._last_user_sweep = -np.inf
        self._log_vecs: list = []       # accumulating query log (online)
        self._log_answers: list = []
        self._initial_log_size = 0
        self.pipeline = RefreshPipeline(self)   # DESIGN.md §10
        self._sync_refreshes = 0
        self.tenant_of = None

    @classmethod
    def from_config(cls, cfg, device: DeviceLike = None) -> "SISO":
        """Build from a :class:`repro_torch.serving.config.ServingConfig`
        (DESIGN.md §16.4). Lowers to the flat SISOConfig through
        ``cfg.to_siso_config()``, so the result is bit-identical to
        building from a SISOConfig with the same fields. A plane that is
        not ported yet raises ``NotImplementedError`` naming it."""
        cfg.check_ported()
        return cls(cfg.to_siso_config(), slo_latency=cfg.slo_latency,
                   llm_latency=cfg.llm_latency, device=device)

    # ----------------------------------------------------------------- online

    @property
    def theta_r(self) -> float:
        return self.threshold.theta if self.cfg.dynamic_threshold \
            else self.cfg.theta_r

    @property
    def centroid_capacity(self) -> int:
        return max(1, self.cfg.capacity)

    def handle_batch(self, vectors: np.ndarray, now: float = 0.0,
                     user_ids: Optional[np.ndarray] = None,
                     tenant_ids: Optional[np.ndarray] = None
                     ) -> LookupResult:
        """Lookup a batch of query embeddings. Repeated queries from the
        same user are forced to miss (routed to the LLM). Negative user
        ids mark anonymous requests. ``tenant_ids`` without a tenancy
        config serve from the shared pool (the reference's own path)."""
        vectors = np.atleast_2d(vectors)
        self.threshold.observe_arrivals(now, len(vectors))
        self._sweep_user_last(now)
        return self._serve_batch(vectors, now, user_ids)

    def _sweep_user_last(self, now: float) -> None:
        """Expire repeat-tracking entries older than repeat_window, at most
        once per window (semantics-preserving, bounds ``_user_last``)."""
        if now - self._last_user_sweep < self.cfg.repeat_window:
            return
        horizon = now - self.cfg.repeat_window
        self._user_last = {u: vt for u, vt in self._user_last.items()
                           if vt[1] >= horizon}
        self._last_user_sweep = now

    def _serve_batch(self, vectors: np.ndarray, now: float,
                     user_ids: Optional[np.ndarray]) -> LookupResult:
        """The single-namespace serving path."""
        # pre-lookup spill recency snapshot: a repeat escape must be able
        # to undo the phantom hit's LRU bump
        prev_lru = (self.cache._spill_last_use.copy()
                    if user_ids is not None and len(self.cache.spill)
                    else None)
        res = self.cache.lookup(vectors, self.theta_r)
        if user_ids is not None:
            spill_order = np.where(res.hit & (res.region == 1))[0]
            escaped_spill: list[tuple[int, int]] = []   # (batch pos, row)
            nc = len(self.cache.centroids)
            for b, u in enumerate(user_ids):
                if int(u) < 0:
                    continue
                prev = self._user_last.get(int(u))
                if (prev is not None and now - prev[1] <= self.cfg.repeat_window
                        and float(vectors[b] @ prev[0]) >= self.cfg.repeat_sim
                        and res.hit[b]):
                    # dissatisfied-user escape: undo the phantom hit's
                    # serving stats and popularity bump
                    if res.region[b] == 0:
                        self.cache.centroids.access_count[
                            int(res.entry[b])] -= 1.0
                    elif res.region[b] == 1:
                        escaped_spill.append((b, int(res.entry[b]) - nc))
                    self.cache.hits -= 1
                    self.cache.misses += 1
                    res.hit[b] = False
                    res.region[b] = -1
                    res.entry[b] = -1
                self._user_last[int(u)] = (vectors[b], now)
            if escaped_spill:
                self._restore_spill_recency(res, prev_lru, spill_order,
                                            escaped_spill, nc)
        return res

    def _restore_spill_recency(self, res: LookupResult,
                               prev_lru: Optional[np.ndarray],
                               spill_order: np.ndarray,
                               escaped_spill: list[tuple[int, int]],
                               nc: int) -> None:
        """Undo the LRU recency bump of escaped spill phantom hits: an
        escaped row reverts to its latest surviving tick from this batch,
        or to its pre-lookup value."""
        base = self.cache._spill_clock - len(spill_order)
        escaped_pos = {b for b, _ in escaped_spill}
        latest: dict[int, int] = {}
        for j, p in enumerate(spill_order):
            if p in escaped_pos:
                continue
            latest[int(res.entry[p]) - nc] = base + 1 + j
        for _, row in escaped_spill:
            if row in latest:
                self.cache._spill_last_use[row] = latest[row]
            elif prev_lru is not None and row < len(prev_lru):
                self.cache._spill_last_use[row] = prev_lru[row]

    def observe_completion(self, wait: float,
                           service: Optional[float] = None,
                           tenant: Optional[int] = None) -> None:
        """An engine (or inline-hit) completion's realized wait/service,
        fed into the dynamic-threshold control loop (DESIGN.md §7.1)."""
        self.threshold.observe_completion(wait, service)

    def record_llm_answer(self, vector: np.ndarray, answer: np.ndarray,
                          answer_id: int = -1,
                          tenant: Optional[int] = None) -> None:
        """A miss came back from the LLM: log it (offline path input) and
        LRU-insert into spare capacity."""
        self._log_vecs.append(np.asarray(vector, np.float32))
        self._log_answers.append((np.asarray(answer, np.float32), answer_id))
        self.cache.insert_spill(vector, answer, answer_id)

    # CacheFrontend protocol surface
    def lookup(self, vectors: np.ndarray, now: float = 0.0,
               user_ids: Optional[np.ndarray] = None,
               tenant_ids: Optional[np.ndarray] = None) -> LookupResult:
        return self.handle_batch(vectors, now=now, user_ids=user_ids,
                                 tenant_ids=tenant_ids)

    def record(self, vector: np.ndarray, answer: np.ndarray,
               answer_id: int = -1, tenant: Optional[int] = None) -> None:
        self.record_llm_answer(vector, answer, answer_id=answer_id)

    def draw_t2h_sample(self, fresh_vectors: np.ndarray,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
        """§4.1: sample t2h_sample_frac of the fresh queries (deterministic
        by default)."""
        rng = rng or np.random.default_rng(0)
        n = max(1, int(self.cfg.t2h_sample_frac * len(fresh_vectors)))
        sel = rng.choice(len(fresh_vectors), size=n, replace=False)
        return fresh_vectors[sel]

    @property
    def refreshes_completed(self) -> int:
        return self._sync_refreshes + self.pipeline.cycles

    def needs_refresh(self) -> bool:
        if self._initial_log_size == 0:
            return len(self._log_vecs) >= self.cfg.refresh_min
        return len(self._log_vecs) \
            >= self.cfg.refresh_frac * self._initial_log_size

    # ---------------------------------------------------------------- offline

    def build_repository(self, vectors: np.ndarray, answers: np.ndarray,
                         answer_ids: Optional[np.ndarray] = None
                         ) -> CentroidStore:
        """SISO-Cluster: log -> clusters -> repository centroids, each with
        its representative's answer (§4.1)."""
        clusters = community_detection(vectors, threshold=self.cfg.theta_c,
                                       device=self.device)
        repo = CentroidStore(self.cfg.dim, self.cfg.answer_dim)
        if clusters:
            reps = np.array([c.representative for c in clusters], np.int64)
            repo.add(np.stack([c.centroid for c in clusters]),
                     answers[reps],
                     np.array([c.cluster_size for c in clusters],
                              np.float64),
                     answer_id=(answer_ids[reps]
                                if answer_ids is not None else None))
        return repo

    def bootstrap(self, vectors: np.ndarray, answers: np.ndarray,
                  answer_ids: Optional[np.ndarray] = None,
                  t2h_sample: Optional[np.ndarray] = None) -> RefreshStats:
        """Initial long-history clustering + cache fill + T2H build."""
        self._initial_log_size = len(vectors)
        repo = self.build_repository(vectors, answers, answer_ids)
        return self._refresh_from_repo(repo, vectors, t2h_sample)

    def refresh(self, rng: Optional[np.random.Generator] = None
                ) -> RefreshStats:
        """Synchronous re-clustering over newly accumulated queries (§4.1);
        an in-flight incremental cycle is finished first."""
        pending = self.pipeline.finish()
        if not self._log_vecs:
            return pending if pending is not None else RefreshStats()
        vecs, answers, aids = self._snapshot_log()
        repo = self.build_repository(vecs, answers, aids)
        stats = self._refresh_from_repo(repo, vecs, None, rng)
        if pending is not None:
            stats.merged += pending.merged
            stats.added += pending.added
            stats.evicted += pending.evicted
        return stats

    def _snapshot_log(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        vecs = np.stack(self._log_vecs)
        answers = np.stack([a for a, _ in self._log_answers])
        aids = np.array([i for _, i in self._log_answers], np.int64)
        self._initial_log_size += len(vecs)
        self._log_vecs, self._log_answers = [], []
        return vecs, answers, aids

    def refresh_tick(self, budget_s: Optional[float] = None
                     ) -> Optional[RefreshStats]:
        """Bounded refresh work for the serving loop (DESIGN.md §10)."""
        if not self.cfg.refresh_async:
            if self.needs_refresh() and self._log_vecs:
                return self.refresh()
            return None
        if self.pipeline.active:
            return self.pipeline.step(self.cfg.refresh_budget_s
                                      if budget_s is None else budget_s)
        if self.needs_refresh() and self._log_vecs:
            self._start_pipeline_from_log()
        return None

    def _start_pipeline_from_log(self) -> None:
        vecs_l, answers_l = self._log_vecs, self._log_answers
        self._initial_log_size += len(vecs_l)
        self._log_vecs, self._log_answers = [], []
        self.pipeline.start_from_log(vecs_l, answers_l)

    def refresh_drain(self) -> Optional[RefreshStats]:
        """Complete any due or in-flight refresh work (offline moment)."""
        out = None
        if not self.cfg.refresh_async:
            if self.needs_refresh() and self._log_vecs:
                out = self.refresh()
            return out
        while self.pipeline.active or (self.needs_refresh()
                                       and self._log_vecs):
            if not self.pipeline.active:
                self._start_pipeline_from_log()
            stats = self.pipeline.finish()
            out = stats if stats is not None else out
        return out

    def _refresh_from_repo(self, repo: CentroidStore,
                           fresh_vectors: np.ndarray,
                           t2h_sample: Optional[np.ndarray] = None,
                           rng: Optional[np.random.Generator] = None
                           ) -> RefreshStats:
        c_new, stats = self.manager.plan(self.cache.centroids, repo,
                                         self.centroid_capacity)
        first = True
        for chunk in self.manager.update_chunks(c_new):  # progressive update
            self.cache.apply_chunk(chunk, first)
            first = False
        self.cache.finish_update()
        if t2h_sample is None and len(fresh_vectors):
            t2h_sample = self.draw_t2h_sample(fresh_vectors, rng)
        if t2h_sample is not None and len(t2h_sample):
            self.t2h = T2HTable.build(self.cache, t2h_sample)
            self.threshold.t2h = self.t2h
            self.threshold.retune()
        self._sync_refreshes += 1
        return stats

    # ----------------------------------------------------------- persistence

    def state_dict(self, delta: bool = False) -> dict:
        """One snapshot of the serving-plane state (DESIGN.md §12)."""
        users = sorted(self._user_last)
        return {
            "cache": (self.cache.state_delta() if delta
                      else self.cache.state_dict()),
            "threshold": self.threshold.state_dict(),
            "pipeline": self.pipeline.state_dict(),
            "log_vecs": (np.stack(self._log_vecs) if self._log_vecs
                         else np.zeros((0, self.cfg.dim), np.float32)),
            "log_answers": (np.stack([a for a, _ in self._log_answers])
                            if self._log_answers
                            else np.zeros((0, self.cfg.answer_dim),
                                          np.float32)),
            "log_aids": np.array([i for _, i in self._log_answers],
                                 np.int64),
            "initial_log_size": np.asarray(self._initial_log_size),
            "sync_refreshes": np.asarray(self._sync_refreshes),
            "user_ids": np.asarray(users, np.int64),
            "user_vecs": (np.stack([self._user_last[u][0] for u in users])
                          if users else np.zeros((0, self.cfg.dim),
                                                 np.float32)),
            "user_times": np.asarray(
                [self._user_last[u][1] for u in users], np.float64),
            "last_user_sweep": np.asarray(self._last_user_sweep),
        }

    @property
    def refresh_epoch(self) -> int:
        """Epoch a delta snapshot is valid against (ticks at the commit)."""
        return self.refreshes_completed + int(self.pipeline.phase == "t2h")

    # --------------------------------------------------------------- metrics

    def stats(self) -> dict:
        thr = self.threshold
        return {
            "hit_ratio": self.cache.hit_ratio,
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "n_centroids": len(self.cache.centroids),
            "n_spill": len(self.cache.spill),
            "theta_r": self.theta_r,
            "lambda": thr.lam,
            "llm_latency_ema": thr.llm_latency,
            "predicted_wait": thr.predicted_wait(thr.theta),
            "wait_error": thr.wait_error_stats(),
            "n_feedback": thr.n_feedback,
            "refresh_active": self.pipeline.active,
            "refresh_cycles": self.pipeline.cycles,
            "refresh_ticks": self.pipeline.ticks,
            "mirror_generation": self.cache.generation,
            "cache_shards": 1,
        }
