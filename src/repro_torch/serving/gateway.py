"""SISO serving gateway — the end-to-end online pipeline (DESIGN.md §7).

One object owns the whole request path the paper's Fig. 8 sketches and the
examples used to hand-wire:

    raw token batch
      --embed (batched)--> query vectors
      --SISO.handle_batch--> batched cache lookup @ dynamic theta_R
                            (+ repeated-query escape hatch)
      --hit--> answered inline, never touches an engine slot
      --miss--> ContinuousBatchScheduler -> ModelEngine decode slots
      --completion--> record_llm_answer (spill insert + offline log)
                      + observe_completion (wait feedback + L EMA,
                        DESIGN.md §7.1)
      --every +refresh_frac new queries--> incremental Algorithm-1
                      refresh: submit() advances the frontend's
                      RefreshPipeline by one bounded budget slice per
                      batch; drain() completes any in-flight cycle
                      (DESIGN.md §10)

Port of ``repro/serving/gateway.py``: batching, wiring, serving metrics,
``from_config`` and crash-safe persistence (DESIGN.md §12: full snapshots
at refresh commits and drains, deltas every ``delta_every`` batches, and
``warm_start`` from the newest full + same-epoch delta) are carried over.

The gateway is deliberately thin: the frontend owns cache policy, the
scheduler owns slot management, and this class owns only batching, wiring,
and serving metrics (per-batch lookup latency percentiles, hit/miss split,
refresh cadence, theta_R trace, SLO attainment).

The frontend is usually a :class:`repro_torch.core.siso.SISO`, but any object
with the CacheFrontend protocol (``lookup``/``insert``/``stats``) works —
``NoCache`` and ``VectorCache`` run through the identical path, which is
how ``benchmarks/bench_slo.py`` compares systems on the *live* pipeline
instead of the analytic simulator.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Engine,
                                           Request)


@dataclass
class GatewayRequest:
    """A raw serving request: model tokens for the engine, embed tokens for
    the cache key (defaults to the model tokens)."""
    rid: int
    model_tokens: np.ndarray
    embed_tokens: Optional[np.ndarray] = None
    user_id: Optional[int] = None
    # namespace identity (DESIGN.md §14): routes the request through its
    # tenant's cache view / theta; None = anonymous (shared pool)
    tenant: Optional[int] = None
    max_new: int = 32
    eos_id: int = -1
    # ground-truth answer embedding to record on engine completion
    # (benches that know it); None -> the gateway's answer_fn
    answer_vec: Optional[np.ndarray] = None


# per-batch samples kept for percentile reporting; bounded because the
# gateway is a long-lived serving object (percentiles describe the recent
# window, not lifetime aggregates)
STATS_WINDOW = 4096


@dataclass
class GatewayStats:
    submitted: int = 0
    refreshes: int = 0
    lookup_s: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))
    batch_sizes: deque = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    # (now, theta_R) sampled once per submitted batch — the live trace of
    # the dynamic-threshold operating point under this gateway's load
    theta_trace: deque = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))

    def lookup_percentiles(self) -> dict:
        if not self.lookup_s:
            return {"p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        a = np.asarray(self.lookup_s) * 1e3
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean())}


class ServingGateway:
    """Batched online serving over a cache frontend + continuous-batching
    engine.

    embed_fn: list of embed-token arrays -> (B, dim) float32 query vectors
              (one batched call per submitted batch — the embedder is part
              of the hot path and must not be invoked per request).
    answer_fn: generated token array -> answer embedding, used to record
              engine completions back into the cache; None disables
              recording (pure read-only cache).
    slo_latency: per-request SLO used for attainment reporting; defaults
              to the frontend's DynamicThreshold SLO when it has one.
    """

    def __init__(self, siso, engine: Engine,
                 embed_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
                 answer_fn: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 auto_refresh: bool = True,
                 slo_latency: Optional[float] = None):
        self.siso = siso                # any CacheFrontend; SISO-rich paths
        self.frontend = siso            # are feature-detected per call
        self.engine = engine
        self.embed_fn = embed_fn
        self.auto_refresh = auto_refresh
        self.clock = clock or time.perf_counter
        thr = getattr(siso, "threshold", None)
        self.slo_latency = (slo_latency if slo_latency is not None
                            else getattr(thr, "slo_latency", None))
        self.sched = ContinuousBatchScheduler(engine, cache=siso,
                                              answer_fn=answer_fn,
                                              clock=self.clock)
        self.stats = GatewayStats()
        # crash-safe persistence (DESIGN.md §12); attach_persistence wires
        self.ckpt: Optional[CheckpointManager] = None
        self._delta_every = 0
        self._since_snap = 0
        self._snap_step = 0
        self._snap_epoch: Optional[int] = None
        self._full_steps: deque = deque(maxlen=2)
        # running completion counters: report() ingests only the done-list
        # suffix it has not seen yet, so per-call cost stays O(new + window)
        # instead of rescanning every completion since process start
        self._done_cursor = 0
        self._served = {"cache": 0, "engine": 0}
        self._eng_wait_sum = 0.0
        self._eng_wait_n = 0
        self._eng_waits: deque = deque(maxlen=STATS_WINDOW)
        self._slo_ok = 0
        self._slo_n = 0
        # per-tenant serving/SLO tallies (DESIGN.md §14): tenant id ->
        # [served_cache, served_engine, slo_ok, slo_n]; anonymous
        # requests (tenant -1) stay out — they are the shared pool
        self._tenant_counts: dict = {}
        # completions ingested by a previous incarnation (warm restart):
        # report()'s lifetime "completed" is base + this process's cursor
        self._completed_base = 0
        self._last_now = 0.0     # last submit() timestamp (rides in the
                                 # snapshot so virtual clocks can resume)
        # LookupResult of the most recent submit(): the HTTP front end
        # (launch/serve.py) reads per-request region/sim for its X-Cache
        # headers without a second frontend call
        self.last_result = None

    @classmethod
    def from_config(cls, cfg, *, engine: Engine,
                    embed_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
                    answer_fn: Optional[Callable] = None,
                    clock: Optional[Callable[[], float]] = None,
                    auto_refresh: bool = True) -> "ServingGateway":
        """Build a fully wired gateway from a
        :class:`repro_torch.serving.config.ServingConfig` (DESIGN.md
        §16.4): the frontend through ``SISO.from_config`` on the engine's
        device (the port's default, ``cuda``, for an engine without one),
        and persistence attached when ``cfg.persistence`` has a directory."""
        from repro_torch.core.siso import SISO
        siso = SISO.from_config(cfg, device=getattr(engine, "device", None))
        gw = cls(siso, engine, embed_fn, answer_fn=answer_fn, clock=clock,
                 auto_refresh=auto_refresh, slo_latency=cfg.slo_latency)
        p = cfg.persistence
        if p is not None and p.directory:
            gw.attach_persistence(p.directory, keep=p.keep,
                                  async_write=p.async_write,
                                  delta_every=p.delta_every)
        return gw

    # ------------------------------------------------------------------ api

    def submit(self, batch: Sequence[GatewayRequest],
               now: Optional[float] = None) -> np.ndarray:
        """One pipeline pass over a request batch. Hits are answered inline;
        misses enter the engine queue. Returns the (B,) hit mask."""
        if not len(batch):
            return np.zeros(0, bool)
        now = self.clock() if now is None else now
        missing = [r.embed_tokens is None for r in batch]
        if any(missing) and not all(missing):
            # a mixed batch would hand embed_fn a heterogeneous list
            # (embed keys + raw model tokens) and mis-embed silently
            raise ValueError("mixed batch: every request must either set "
                             "embed_tokens or leave it unset (falls back "
                             "to model_tokens for the whole batch)")
        # recorded only once the batch is accepted: a rejected batch must
        # not advance the persisted resume clock
        self._last_now = float(now)
        embed_toks = [r.embed_tokens if r.embed_tokens is not None
                      else r.model_tokens for r in batch]
        vectors = np.asarray(self.embed_fn(embed_toks), np.float32)
        user_ids = None
        if any(r.user_id is not None for r in batch):
            # anonymous rows get the -1 sentinel: SISO skips repeat
            # tracking for them and keeps no per-request state
            user_ids = np.asarray([-1 if r.user_id is None else r.user_id
                                   for r in batch])
        tenant_ids = None
        if any(r.tenant is not None for r in batch):
            # same -1 sentinel for namespaces (DESIGN.md §14); the kwarg
            # is only passed when some request carries a tenant, so
            # tenant-free traffic exercises the exact pre-tenancy path
            tenant_ids = np.asarray([-1 if r.tenant is None else r.tenant
                                     for r in batch])
        t0 = time.perf_counter()
        if hasattr(self.frontend, "handle_batch"):
            if tenant_ids is not None:
                res = self.frontend.handle_batch(vectors, now=now,
                                                 user_ids=user_ids,
                                                 tenant_ids=tenant_ids)
            else:
                res = self.frontend.handle_batch(vectors, now=now,
                                                 user_ids=user_ids)
        else:
            res = self.frontend.lookup(vectors, now=now, user_ids=user_ids)
        self.stats.lookup_s.append(time.perf_counter() - t0)
        self.stats.batch_sizes.append(len(batch))
        self.stats.submitted += len(batch)
        self.last_result = res
        theta = getattr(self.frontend, "theta_r", None)
        if theta is not None:
            self.stats.theta_trace.append((float(now), float(theta)))
        for b, r in enumerate(batch):
            req = Request(rid=r.rid, tokens=np.asarray(r.model_tokens),
                          max_new=r.max_new, eos_id=r.eos_id,
                          vector=vectors[b], answer_vec=r.answer_vec,
                          tenant=-1 if r.tenant is None else int(r.tenant))
            if res.hit[b]:
                self.sched.admit_resolved(req, res.answer[b])
            else:
                self.sched.enqueue(req)
        self.sched.step()
        self._maybe_refresh()
        self._maybe_snapshot()
        return res.hit

    def step(self) -> int:
        """One engine tick (admit -> prefill -> batched decode -> retire)."""
        return self.sched.step()

    def drain(self, max_ticks: int = 10_000) -> list[Request]:
        """Run the engine until every queued miss has completed; returns all
        finished requests (cache hits included), then completes any due or
        in-flight refresh (an offline moment — no request is waiting).
        Per-path serving counts live in report(), derived from done."""
        out = self.sched.drain(max_ticks)
        self._maybe_refresh(drain=True)
        if self.ckpt is not None:
            self.snapshot(full=True)    # drained = cheap consistent point
        return out

    @property
    def done(self) -> list[Request]:
        return self.sched.done

    # ------------------------------------------------------------- internal

    def _maybe_refresh(self, drain: bool = False) -> None:
        """Advance the frontend's refresh machinery (DESIGN.md §10).

        On the hot path (submit) a RefreshPipeline frontend gets exactly
        one bounded refresh_tick(); on drain it runs to completion. A
        frontend without refresh_tick keeps the legacy blocking behavior.
        """
        if not self.auto_refresh:
            return
        fe = self.frontend
        if hasattr(fe, "refresh_tick"):
            before = getattr(fe, "refreshes_completed", None)
            # a duck-typed frontend may implement only refresh_tick; the
            # bounded tick is then the drain-path fallback too
            drain_fn = getattr(fe, "refresh_drain", fe.refresh_tick)
            stats = drain_fn() if drain else fe.refresh_tick()
            if before is not None:
                # exact: one drain can complete more than one cycle
                self.stats.refreshes += fe.refreshes_completed - before
            elif stats is not None:
                self.stats.refreshes += 1
        elif hasattr(fe, "needs_refresh") and fe.needs_refresh():
            fe.refresh()
            self.stats.refreshes += 1

    # --------------------------------------------------------- persistence

    def attach_persistence(self, directory: str, keep: int = 3,
                           async_write: bool = True,
                           delta_every: int = 16) -> None:
        """Wire crash-safe snapshotting (DESIGN.md §12).

        Full snapshots are written whenever the frontend completes a
        refresh cycle (piggybacked on the commit that just rewrote the
        centroid region — the one moment the big matrices actually
        changed) and at every drain(). Between commits, a cheap *delta*
        snapshot (spill region, recency, controller, counters — no
        centroid matrices) is written every ``delta_every`` submitted
        batches. With ``async_write`` the writer runs on its own thread,
        so submit() never blocks on disk.
        """
        fe = self.frontend
        if not (hasattr(fe, "state_dict") and hasattr(fe, "load_state")):
            raise ValueError("frontend has no state_dict/load_state — "
                             "persistence needs a snapshot-capable "
                             "frontend (e.g. SISO)")
        self.ckpt = CheckpointManager(directory, keep=keep,
                                      async_write=async_write)
        self._delta_every = delta_every
        steps = self.ckpt.all_steps()
        self._snap_step = (steps[-1] + 1) if steps else 1
        self._snap_epoch = self._epoch()
        if not steps:
            # fresh directory: lay down a base full immediately, or the
            # first delta_every batches would write deltas with no full
            # to compose against — a crash in that window would be
            # unrecoverable despite snapshots on disk. (A populated
            # directory means a restart: warm_start() restores first.)
            self.snapshot(full=True)

    def _epoch(self) -> int:
        return int(getattr(self.frontend, "refresh_epoch", 0))

    def snapshot(self, full: bool = True) -> int:
        """Write one snapshot now; returns its step id. Composition:
        ``meta`` (kind + refresh epoch) + frontend state + gateway
        counters. Delta snapshots are valid only against the full
        snapshot of the same refresh epoch (warm_start checks)."""
        if self.ckpt is None:
            raise RuntimeError("attach_persistence first")
        fe = self.frontend
        state = {
            "meta": {"kind": np.asarray("full" if full else "delta"),
                     "epoch": np.asarray(self._epoch())},
            "frontend": (fe.state_dict() if full
                         else fe.state_dict(delta=True)),
            "gateway": self.state_dict(),
        }
        step = self._snap_step
        self._snap_step += 1
        self.ckpt.save(step, state)
        if full:
            # retention must never strand deltas without their base full.
            # Keep the last TWO fulls protected: the async writer reaps in
            # FIFO order, so by the time the older one becomes reapable
            # (a third full enqueued), the middle one is already on disk —
            # a crash can never leave only deltas behind.
            self._full_steps.append(step)
            self.ckpt.protect = set(self._full_steps)
        self._since_snap = 0
        self._snap_epoch = self._epoch()
        return step

    def _maybe_snapshot(self) -> None:
        """Piggybacked cadence: a completed refresh commit triggers a full
        snapshot (the centroid region just changed — deltas against the
        old epoch stopped being valid); otherwise every ``delta_every``
        batches ships a delta. The async writer makes both O(host-copy)
        on the serving path."""
        if self.ckpt is None:
            return
        epoch = self._epoch()
        if epoch != self._snap_epoch:
            self.snapshot(full=True)
        else:
            self._since_snap += 1
            if self._delta_every and self._since_snap >= self._delta_every:
                self.snapshot(full=False)

    def warm_start(self) -> dict:
        """Crash recovery (DESIGN.md §12): restore the newest full
        snapshot (+ the newest later delta of the same refresh epoch),
        rebuild the device mirror without advancing the serving
        generation, retune the controller, and resume. Returns recovery
        metadata: the restored step/kind and wall-clock spent."""
        if self.ckpt is None:
            raise RuntimeError("attach_persistence first")
        t0 = time.perf_counter()
        self.ckpt.wait()
        steps = self.ckpt.all_steps()
        full_step = delta_step = None
        full_snap = delta_snap = None
        for step in reversed(steps):
            # classify from the tiny meta entry alone — loading whole
            # intermediate snapshots here would bill recovery wall-clock
            # for payloads that are about to be discarded
            kind = str(np.asarray(
                self.ckpt.restore_entry(step, "meta")["kind"]))
            if kind == "delta" and delta_step is None and full_step is None:
                delta_step = step
            elif kind == "full":
                full_step = step
                break
        if full_step is None:
            raise FileNotFoundError(
                f"no full snapshot under {self.ckpt.dir}")
        full_snap = self.ckpt.restore(full_step)
        if delta_step is not None:
            delta_snap = self.ckpt.restore(delta_step)
        fe = self.frontend
        fe.load_state(full_snap["frontend"])
        self.load_state(full_snap["gateway"])
        restored = {"step": full_step, "kind": "full"}
        if delta_snap is not None:
            same_epoch = int(np.asarray(delta_snap["meta"]["epoch"])) \
                == int(np.asarray(full_snap["meta"]["epoch"]))
            if same_epoch:
                fe.load_state(delta_snap["frontend"], delta=True)
                self.load_state(delta_snap["gateway"])
                restored = {"step": delta_step, "kind": "full+delta"}
        if hasattr(fe, "warm_start"):
            fe.warm_start()     # eager mirror rebuild + retune
        self._snap_step = steps[-1] + 1
        self._snap_epoch = self._epoch()
        self._since_snap = 0
        # re-protect the restored base: this process's fresh manager
        # started with an empty protect set, and post-restart retention
        # must never reap the full snapshot its deltas compose against
        self._full_steps.append(full_step)
        self.ckpt.protect = set(self._full_steps)
        restored["recovery_s"] = time.perf_counter() - t0
        return restored


    def state_dict(self) -> dict:
        """Gateway/scheduler serving counters (the request path's own
        state): lifetime tallies stay exact across a restart; in-flight
        engine slots are NOT snapshotted — a crash loses queued misses,
        which re-arrive as ordinary traffic."""
        self._ingest_done()
        trace = np.asarray([list(p) for p in self.stats.theta_trace],
                           np.float64).reshape(-1, 2)
        return {
            "submitted": np.asarray(self.stats.submitted),
            "refreshes": np.asarray(self.stats.refreshes),
            "lookup_s": np.asarray(self.stats.lookup_s, np.float64),
            "batch_sizes": np.asarray(self.stats.batch_sizes, np.int64),
            "theta_trace": trace,
            "served_cache": np.asarray(self._served["cache"]),
            "served_engine": np.asarray(self._served["engine"]),
            "eng_wait_sum": np.asarray(self._eng_wait_sum),
            "eng_wait_n": np.asarray(self._eng_wait_n),
            "eng_waits": np.asarray(self._eng_waits, np.float64),
            "slo_ok": np.asarray(self._slo_ok),
            "slo_n": np.asarray(self._slo_n),
            "completed": np.asarray(self._completed_base
                                    + self._done_cursor),
            "sched_tick": np.asarray(self.sched._tick),
            "last_now": np.asarray(self._last_now),
            # per-tenant tallies, flattened (DESIGN.md §14)
            "tenant_ids": np.asarray(sorted(self._tenant_counts),
                                     np.int64),
            "tenant_counts": np.asarray(
                [self._tenant_counts[t]
                 for t in sorted(self._tenant_counts)],
                np.int64).reshape(-1, 4),
        }

    def load_state(self, state: dict) -> None:
        st = self.stats
        st.submitted = int(state["submitted"])
        st.refreshes = int(state["refreshes"])
        st.lookup_s = deque(np.asarray(state["lookup_s"]).tolist(),
                            maxlen=STATS_WINDOW)
        st.batch_sizes = deque(
            np.asarray(state["batch_sizes"]).tolist(), maxlen=STATS_WINDOW)
        st.theta_trace = deque(
            (tuple(p) for p in np.asarray(
                state["theta_trace"]).reshape(-1, 2)),
            maxlen=STATS_WINDOW)
        self._served = {"cache": int(state["served_cache"]),
                        "engine": int(state["served_engine"])}
        self._eng_wait_sum = float(state["eng_wait_sum"])
        self._eng_wait_n = int(state["eng_wait_n"])
        self._eng_waits = deque(np.asarray(state["eng_waits"]).tolist(),
                                maxlen=STATS_WINDOW)
        self._slo_ok = int(state["slo_ok"])
        self._slo_n = int(state["slo_n"])
        self._completed_base = int(state["completed"])
        self._done_cursor = 0           # fresh process: empty done list
        self.sched._tick = int(state["sched_tick"])
        self._last_now = float(state.get("last_now", 0.0))
        # .get() fallback: pre-tenancy gateway snapshots load clean
        tids = np.asarray(state.get("tenant_ids", np.zeros(0, np.int64)),
                          np.int64)
        tcounts = np.asarray(state.get("tenant_counts",
                                       np.zeros((0, 4), np.int64)),
                             np.int64).reshape(-1, 4)
        self._tenant_counts = {int(t): [int(c) for c in row]
                               for t, row in zip(tids, tcounts)}

    # --------------------------------------------------------------- report

    def _ingest_done(self) -> None:
        """Fold completions the running counters have not seen yet. Sums
        and SLO attainment are exact over the lifetime; p99_wait is over
        the recent STATS_WINDOW engine completions (the gateway is a
        long-lived serving object — a full-history percentile would cost
        O(completed) per report call)."""
        done = self.sched.done
        for r in done[self._done_cursor:]:
            wait = r.t_done - r.t_submit
            self._served[r.served_by] += 1
            if r.served_by == "engine":
                self._eng_wait_sum += wait
                self._eng_wait_n += 1
                self._eng_waits.append(wait)
            slo_ok = (int(wait <= self.slo_latency)
                      if self.slo_latency is not None else 0)
            if self.slo_latency is not None:
                self._slo_n += 1
                self._slo_ok += slo_ok
            tid = int(getattr(r, "tenant", -1))
            if tid >= 0:
                tc = self._tenant_counts.setdefault(tid, [0, 0, 0, 0])
                tc[0 if r.served_by == "cache" else 1] += 1
                if self.slo_latency is not None:
                    tc[2] += slo_ok
                    tc[3] += 1
        self._done_cursor = len(done)

    def report(self) -> dict:
        s = self.frontend.stats() if hasattr(self.frontend, "stats") else {}
        self._ingest_done()
        rep = {
            **s,
            "submitted": self.stats.submitted,
            "completed": self._completed_base + self._done_cursor,
            "served_cache": self._served["cache"],
            "served_engine": self._served["engine"],
            "refreshes": self.stats.refreshes,
            "lookup": self.stats.lookup_percentiles(),
        }
        if self._eng_wait_n:
            rep["mean_wait"] = self._eng_wait_sum / self._eng_wait_n
            rep["p99_wait"] = float(np.percentile(
                np.asarray(self._eng_waits), 99))
        if self.slo_latency is not None and self._slo_n:
            rep["slo_latency"] = float(self.slo_latency)
            rep["slo_attainment"] = self._slo_ok / self._slo_n
        if self.stats.theta_trace:
            rep["theta_trace"] = [list(p) for p in self.stats.theta_trace]
        thr = getattr(self.frontend, "threshold", None)
        if thr is not None:
            rep["lam_trace"] = [list(p) for p in thr.lam_trace]
        cache = getattr(self.frontend, "cache", None)
        if cache is not None and hasattr(cache, "dev_rebuilds"):
            rep["dev_rebuilds"] = cache.dev_rebuilds
            rep["dev_row_writes"] = cache.dev_row_writes
            rep["dev_swaps"] = cache.dev_swaps
            shard = getattr(cache, "shard", None)
            if shard is not None:   # mesh cache plane (DESIGN.md §11)
                rep["cache_shards"] = shard.n_shards
                dev = cache._dev
                if dev is not None:
                    rep["cache_rows_per_shard"] = dev.pad
        if cache is not None and hasattr(cache, "memory_bytes"):
            # bytes-level accounting (DESIGN.md §15): per-shard and
            # per-tier centroid/answer bytes, codes vs scales split —
            # capacity-per-byte is observable, not inferred
            rep["memory"] = cache.memory_bytes()
        if cache is not None and getattr(cache, "backend", "") == "pallas_q8":
            rep["quant_rescored"] = cache.quant_rescored
            rep["quant_fallbacks"] = cache.quant_fallbacks
        if cache is not None and hasattr(cache, "tier_stats"):
            # tiered hierarchy (DESIGN.md §13): per-tier hit / promotion /
            # demotion counters ride in every report
            rep["tiers"] = cache.tier_stats()
        tenants = self._tenant_report(s)
        if tenants:
            rep["tenants"] = tenants
        return rep

    def _tenant_report(self, frontend_stats: dict) -> dict:
        """Per-tenant breakdown (DESIGN.md §14): the frontend's cache-side
        view (hit ratio, overlay, occupancy share) merged with the
        gateway's serving-side tallies (served split, SLO attainment)."""
        out: dict = {}
        for tid, ts in (frontend_stats.get("tenants") or {}).items():
            out[int(tid)] = dict(ts)
        for tid, (c, e, ok, n) in self._tenant_counts.items():
            row = out.setdefault(int(tid), {})
            row["served_cache"] = c
            row["served_engine"] = e
            if self.slo_latency is not None and n:
                row["slo_attainment"] = ok / n
        return out
