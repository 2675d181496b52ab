"""SISO facade — the paper's full system wired together (Fig. 8), ported.

Offline path:  query log --SISO-Cluster--> centroid repository
               --SISO-CacheManager (Alg. 1)--> semantic cache refresh
Online path:   queries --embed--> cache lookup @ theta_R --hit--> answer
                                   |miss--> LLM engine
with dynamic theta_R (M/D/1 + T2H), repeated-query escape hatch, and
individual-vector LRU spill for leftover capacity.

The tiered hierarchy (``tiered=``, DESIGN.md §13) wraps the device cache
in a :class:`~repro_torch.core.tiered.TieredCache`; tenant namespaces
(``tenancy=``, §14) add per-tenant overlays, theta and fair-share
eviction; ``state_dict``/``load_state``/``warm_start`` restore the whole
serving plane (§12). The sharded plane (``shard=`` with more than one
shard) arrives in a later slice and raises ``NotImplementedError``;
``tenant_ids`` without a tenancy config takes the single-namespace path,
exactly as in the reference.
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
from repro_torch.core.tenancy import (REGION_OVERLAY, TenancyConfig,
                                      TenantRegistry, TenantState)
from repro_torch.core.threshold import DynamicThreshold, T2HTable
from repro_torch.core.tiered import TieredCache, TieredCacheConfig
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
    tiered: Optional[TieredCacheConfig] = None
                                     # device → host → disk hierarchy
                                     # (DESIGN.md §13); None keeps the
                                     # single-tier path bit-identical
    tenancy: Optional[TenancyConfig] = None
                                     # multi-tenant namespaces (DESIGN.md
                                     # §14); None keeps the single-
                                     # namespace path bit-identical


class SISO:
    def __init__(self, cfg: SISOConfig, slo_latency: float = 1.0,
                 llm_latency: float = 0.5, device: DeviceLike = None):
        if cfg.shard is not None and not (
                isinstance(cfg.shard, ShardedCacheConfig)
                and cfg.shard.n_shards == 1):
            raise NotImplementedError(
                "SISOConfig.shard: the plane is not ported yet")
        self.cfg = cfg
        self.cache = SemanticCache(cfg.dim, cfg.answer_dim, cfg.capacity,
                                   backend=cfg.backend,
                                   spill_lru=cfg.spill_lru,
                                   rescore_k=cfg.rescore_k, device=device)
        self.device = self.cache.device
        if cfg.tiered is not None:     # device→host→disk (DESIGN.md §13)
            self.cache = TieredCache(self.cache, cfg.tiered)
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
        # multi-tenant namespaces (DESIGN.md §14): per-tenant overlays + a
        # registry attributing shared-store rows to their namespace.
        # tenant_of is the answer_ids -> tenants resolver the eviction
        # paths (spill, refresh filter, tier demotion) consult; None keeps
        # every one of them bit-identical to the unweighted path.
        self._tenants: dict = {}        # tenant id -> TenantState
        self.registry = (TenantRegistry(cfg.tenancy.registry_cap)
                         if cfg.tenancy is not None else None)
        self.tenant_of = None
        if cfg.tenancy is not None and cfg.tenancy.fair_share_eviction:
            self.tenant_of = self.tenants_of
            dev = self.cache.device if cfg.tiered is not None else self.cache
            dev.fair_share_eviction = True
            dev.tenant_of = self.tenant_of
            if cfg.tiered is not None:
                self.cache.fair_share_eviction = True
                self.cache.tenant_of = self.tenant_of

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
        """Rows the refresh may fill with centroids; a tiered config keeps
        ``device_reserve`` rows for the spill so promotions always have
        somewhere to land (DESIGN.md §13)."""
        reserve = self.cfg.tiered.device_reserve if self.cfg.tiered else 0
        return max(1, self.cfg.capacity - reserve)

    def handle_batch(self, vectors: np.ndarray, now: float = 0.0,
                     user_ids: Optional[np.ndarray] = None,
                     tenant_ids: Optional[np.ndarray] = None
                     ) -> LookupResult:
        """Lookup a batch of query embeddings. Repeated queries from the
        same user are forced to miss (routed to the LLM). Negative user
        ids mark anonymous requests. ``tenant_ids`` (with a TenancyConfig)
        routes each row through its namespace: overlay-then-global lookup
        at the tenant's own theta (DESIGN.md §14); -1 marks anonymous rows,
        which serve from the shared pool like the tenant-free path."""
        vectors = np.atleast_2d(vectors)
        self.threshold.observe_arrivals(now, len(vectors))
        self._sweep_user_last(now)
        if tenant_ids is None or self.cfg.tenancy is None:
            return self._serve_batch(vectors, now, user_ids)
        return self._serve_batch_tenant(vectors, now, user_ids,
                                        np.asarray(tenant_ids, np.int64))

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
                    elif res.region[b] >= 2:
                        # warm/cold tier phantom hit (DESIGN.md §13):
                        # revert popularity, cancel the queued promotion
                        self.cache.undo_tier_hit(int(res.entry[b]),
                                                 int(res.region[b]))
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

    # ---------------------------------------------------------- multi-tenant

    def tenants_of(self, answer_ids: np.ndarray) -> np.ndarray:
        """Row ownership for the fair-share eviction paths: answer_id ->
        namespace through the registry (-1 = shared pool)."""
        if self.registry is None:
            return np.full(len(np.atleast_1d(answer_ids)), -1, np.int64)
        return self.registry.tenants_of(answer_ids)

    def _tenant_state(self, tid: int) -> Optional[TenantState]:
        ts = self._tenants.get(tid)
        if ts is None:
            if len(self._tenants) >= self.cfg.tenancy.max_tenants:
                return None     # cap: overflow tenants share the pool
            ts = TenantState(self.cfg.dim, self.cfg.answer_dim,
                             self.cfg.tenancy)
            self._tenants[tid] = ts
        return ts

    def tenant_theta(self, tid: int) -> float:
        """The namespace's serving threshold (the global theta_r until
        per-tenant calibration kicks in, or when tenancy/DTA is off)."""
        if (self.cfg.tenancy is None
                or not self.cfg.tenancy.per_tenant_theta
                or not self.cfg.dynamic_threshold):
            return self.theta_r
        return self.threshold.tenant_theta(int(tid))

    def _serve_batch_tenant(self, vectors: np.ndarray, now: float,
                            user_ids: Optional[np.ndarray],
                            tenant_ids: np.ndarray) -> LookupResult:
        """Namespace-aware serving (DESIGN.md §14): overlay-then-global
        lookup, per-tenant theta, repeat escapes, per-tenant counters —
        still one device round trip for the whole batch. The global
        lookup runs at the weakest theta present; rows whose best sim
        misses their own namespace's theta are escaped back to the
        engine with the exact repeat-escape undo machinery."""
        tcfg = self.cfg.tenancy
        n = len(vectors)
        per_theta = tcfg.per_tenant_theta and self.cfg.dynamic_threshold
        if per_theta:
            self.threshold.observe_tenant_arrivals(now, tenant_ids)
        thetas = np.full(n, self.theta_r, np.float64)
        if per_theta:
            for b in range(n):
                if tenant_ids[b] >= 0:
                    thetas[b] = self.threshold.tenant_theta(
                        int(tenant_ids[b]))
        # ---- overlay pass: each tenant's personal view first
        ov: dict = {}             # batch pos -> (TenantState, row, sim)
        for b in range(n):
            tid = int(tenant_ids[b])
            if tid < 0:
                continue
            ts = self._tenants.get(tid)
            if ts is None or not len(ts.overlay):
                continue
            sim, row = ts.overlay.search(vectors[b])
            if sim >= thetas[b]:
                ov[b] = (ts, row, sim)
        pending = np.asarray([b for b in range(n) if b not in ov],
                             np.int64)
        theta_min = float(thetas[pending].min()) if len(pending) \
            else self.theta_r
        prev_lru = (self.cache._spill_last_use.copy()
                    if len(pending) and len(self.cache.spill) else None)
        sub = (self.cache.lookup(vectors[pending], theta_min)
               if len(pending) else None)
        nc = len(self.cache.centroids)
        spill_order = (np.where(sub.hit & (sub.region == 1))[0]
                       if sub is not None else np.zeros(0, np.int64))
        escaped_spill: list[tuple[int, int]] = []
        sub_pos = {int(p): j for j, p in enumerate(pending)}
        # ---- unified per-row pass in batch order, so repeat-tracking
        # updates and duplicate-user-in-batch semantics match the
        # single-namespace loop exactly
        for b in range(n):
            tid = int(tenant_ids[b])
            u = int(user_ids[b]) if user_ids is not None else -1
            repeat = False
            if u >= 0:
                prev = self._user_last.get(u)
                repeat = (prev is not None
                          and now - prev[1] <= self.cfg.repeat_window
                          and float(vectors[b] @ prev[0])
                          >= self.cfg.repeat_sim)
            if b in ov:
                ts, row, sim = ov[b]
                if repeat:
                    # dissatisfied-user escape straight off the overlay:
                    # nothing was touched yet — just count an engine miss
                    self.cache.misses += 1
                    ts.misses += 1
                    del ov[b]
                else:
                    ts.overlay.touch(row)
                    self.cache.hits += 1
                    ts.hits += 1
                    ts.overlay_hits += 1
            else:
                j = sub_pos[b]
                # float32: the device decided hits at f32 precision, so
                # the per-row theta filter must compare at f32 too (a
                # tenant at exactly theta_min must never escape its hits)
                escape = bool(sub.hit[j]) and (
                    float(sub.sim[j]) < float(np.float32(thetas[b]))
                    or repeat)
                if escape:
                    if sub.region[j] == 0:
                        self.cache.centroids.access_count[
                            int(sub.entry[j])] -= 1.0
                    elif sub.region[j] == 1:
                        escaped_spill.append((j, int(sub.entry[j]) - nc))
                    elif sub.region[j] >= 2:
                        self.cache.undo_tier_hit(int(sub.entry[j]),
                                                 int(sub.region[j]))
                    self.cache.hits -= 1
                    self.cache.misses += 1
                    sub.hit[j] = False
                    sub.region[j] = -1
                    sub.entry[j] = -1
                if tid >= 0:
                    ts = self._tenant_state(tid)
                    if ts is not None:
                        if sub.hit[j]:
                            ts.hits += 1
                        else:
                            ts.misses += 1
            if u >= 0:
                self._user_last[u] = (vectors[b], now)
        if escaped_spill:
            self._restore_spill_recency(sub, prev_lru, spill_order,
                                        escaped_spill, nc)
        return self._merge_tenant_result(vectors, ov, pending, sub)

    def _merge_tenant_result(self, vectors: np.ndarray, ov: dict,
                             pending: np.ndarray,
                             sub: Optional[LookupResult]) -> LookupResult:
        """Stitch overlay hits (region 4) and the global sub-lookup back
        into one batch-ordered LookupResult."""
        n = len(vectors)
        res = LookupResult(
            np.zeros(n, bool), np.full(n, -1.0, np.float32),
            np.zeros((n, self.cfg.answer_dim), np.float32),
            np.full(n, -1, np.int64), np.full(n, -1, np.int64),
            np.full(n, -1, np.int8),
            generation=(sub.generation if sub is not None
                        else self.cache.generation))
        if sub is not None:
            res.hit[pending] = sub.hit
            res.sim[pending] = sub.sim
            res.answer[pending] = sub.answer
            res.answer_id[pending] = sub.answer_id
            res.entry[pending] = sub.entry
            res.region[pending] = sub.region
        for b, (ts, row, sim) in ov.items():
            res.hit[b] = True
            res.sim[b] = np.float32(sim)
            res.answer[b] = ts.overlay.answers[row]
            res.answer_id[b] = int(ts.overlay.answer_id[row])
            res.entry[b] = row
            res.region[b] = REGION_OVERLAY
        return res

    def observe_completion(self, wait: float,
                           service: Optional[float] = None,
                           tenant: Optional[int] = None) -> None:
        """An engine (or inline-hit) completion's realized wait/service,
        fed into the dynamic-threshold control loop (DESIGN.md §7.1).
        ``tenant`` additionally drives the namespace's own feedback."""
        self.threshold.observe_completion(wait, service, tenant=tenant)

    def record_llm_answer(self, vector: np.ndarray, answer: np.ndarray,
                          answer_id: int = -1,
                          tenant: Optional[int] = None) -> None:
        """A miss came back from the LLM: log it (offline path input) and
        LRU-insert into spare capacity. With a tenant, the answer is first
        attributed to its namespace; *personal* answers (similar to the
        tenant's own recent misses) go to the tenant overlay only — never
        the shared log/spill, so they are never clustered into global
        centroids (DESIGN.md §14)."""
        if tenant is not None and tenant >= 0 \
                and self.cfg.tenancy is not None:
            # attribution before the insert: the spill's fair-share
            # victim choice must already see the inserter's namespace
            self.registry.note(int(answer_id), int(tenant))
            ts = self._tenant_state(int(tenant))
            if ts is not None:
                # classify against the window BEFORE this query joins it
                # (else every answer self-matches as personal)
                personal = ts.is_personal(vector)
                ts.push_recent(vector)
                if personal:
                    ts.overlay.add(np.asarray(vector, np.float32),
                                   np.asarray(answer, np.float32),
                                   int(answer_id))
                    return
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
        self.record_llm_answer(vector, answer, answer_id=answer_id,
                               tenant=tenant)

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
        """Bounded refresh work for the serving loop (DESIGN.md §10); a
        tiered cache applies its queued promotions here first, off the
        lookup path (§13)."""
        if hasattr(self.cache, "promote_tick"):
            self.cache.promote_tick()
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
        if hasattr(self.cache, "promote_drain"):
            self.cache.promote_drain()   # offline moment: flush the tiers
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
        sink = getattr(self.cache, "evict_sink", None)
        if sink is not None:    # tiered: demote filter evictions (§13)
            c_new, stats, evicted = self.manager.plan(
                self.cache.centroids, repo, self.centroid_capacity,
                collect_evicted=True, tenant_of=self.tenant_of)
        else:
            evicted = None
            c_new, stats = self.manager.plan(self.cache.centroids, repo,
                                             self.centroid_capacity,
                                             tenant_of=self.tenant_of)
        first = True
        for chunk in self.manager.update_chunks(c_new):  # progressive update
            self.cache.apply_chunk(chunk, first)
            first = False
        self.cache.finish_update()
        if sink is not None and evicted is not None and len(evicted):
            sink(evicted.vectors, evicted.answers, evicted.answer_id,
                 evicted.cluster_size, evicted.access_count,
                 "refresh_evict")
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
        """One snapshot of the serving-plane state (DESIGN.md §12): cache
        (full or delta), controller, in-flight refresh cycle, the miss log,
        repeat-tracking state, counters and the tenancy plane."""
        users = sorted(self._user_last)
        state = {
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
        if self.cfg.tenancy is not None:
            # small (bounded overlays + registry): rides in full snapshots
            # AND deltas, so a restart from either serves overlays exactly
            state["tenancy"] = {
                "registry": self.registry.state_dict(),
                "tenants": {str(t): ts.state_dict()
                            for t, ts in self._tenants.items()},
            }
        return state

    @property
    def refresh_epoch(self) -> int:
        """Epoch a delta snapshot is valid against (ticks at the commit)."""
        return self.refreshes_completed + int(self.pipeline.phase == "t2h")

    def load_state(self, state: dict, delta: bool = False) -> None:
        if delta:
            self.cache.load_delta(state["cache"])
        else:
            self.cache.load_state(state["cache"])
        self.threshold.load_state(state["threshold"])
        self.t2h = self.threshold.t2h     # single shared table object
        self.pipeline.load_state(state["pipeline"])
        vecs = np.asarray(state["log_vecs"], np.float32)
        answers = np.asarray(state["log_answers"], np.float32)
        aids = np.asarray(state["log_aids"], np.int64)
        self._log_vecs = [v for v in vecs]
        self._log_answers = [(a, int(i)) for a, i in zip(answers, aids)]
        self._initial_log_size = int(state["initial_log_size"])
        self._sync_refreshes = int(state["sync_refreshes"])
        self._user_last = {
            int(u): (v, float(t))
            for u, v, t in zip(np.asarray(state["user_ids"], np.int64),
                               np.asarray(state["user_vecs"], np.float32),
                               np.asarray(state["user_times"], np.float64))}
        # .get(): checkpoints predating the sweep/tenancy restore clean
        self._last_user_sweep = float(state.get("last_user_sweep",
                                                -np.inf))
        if self.cfg.tenancy is not None:
            ten = state.get("tenancy")
            self._tenants = {}
            if ten is not None:
                self.registry.load_state(ten["registry"])
                for key, tstate in ten["tenants"].items():
                    ts = TenantState(self.cfg.dim, self.cfg.answer_dim,
                                     self.cfg.tenancy)
                    ts.load_state(tstate)
                    self._tenants[int(key)] = ts

    def warm_start(self) -> None:
        """Re-materialize the restored serving state (DESIGN.md §12):
        rebuild the device mirror once without advancing the generation,
        then retune the operating point from the restored T2H/lambda/bias
        — both deterministic functions of the restored state, so the first
        post-restart lookup is element-wise identical to an uninterrupted
        run's."""
        self.cache.rebuild_mirror()
        self.threshold.retune()

    # --------------------------------------------------------------- metrics

    def stats(self) -> dict:
        thr = self.threshold
        out = {
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
        if hasattr(self.cache, "tier_stats"):   # hierarchy (DESIGN.md §13)
            out["tiers"] = self.cache.tier_stats()
        if self.cfg.tenancy is not None:        # namespaces (DESIGN.md §14)
            out["tenants"] = self.tenant_stats()
        return out

    def tenant_stats(self) -> dict:
        """Per-namespace breakdown (DESIGN.md §14): serving counters,
        overlay footprint, and each tenant's share of the shared stores
        (device + warm + cold rows, attributed through the registry) —
        the observable form of the fair-share isolation claim."""
        if hasattr(self.cache, "tier_membership"):
            tm = self.cache.tier_membership()
            all_ids = np.concatenate([tm["device"], tm["host"],
                                      tm["disk"]])
        else:
            all_ids = np.concatenate([self.cache.centroids.answer_id,
                                      self.cache.spill.answer_id])
        occ = (self.registry.occupancy(all_ids)
               if self.registry is not None else {})
        total = max(1, len(all_ids))
        out = {}
        for tid in sorted(self._tenants):
            ts = self._tenants[tid]
            served = ts.hits + ts.misses
            rows = int(occ.get(tid, 0))
            out[int(tid)] = {
                "hits": ts.hits,
                "misses": ts.misses,
                "hit_ratio": ts.hits / served if served else 0.0,
                "overlay_hits": ts.overlay_hits,
                "overlay_rows": len(ts.overlay),
                "shared_rows": rows,
                "occupancy_share": rows / total,
                "theta": self.tenant_theta(tid),
            }
        return out
