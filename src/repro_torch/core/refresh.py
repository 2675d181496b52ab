"""Non-blocking Algorithm-1 refresh pipeline (DESIGN.md §10).

The paper's §4.2 requires that cache updates never block the online path.
:class:`RefreshPipeline` is the state machine that delivers that: when a
refresh comes due, SISO snapshots the accumulated query log and hands it
here; every subsequent serving tick (``SISO.refresh_tick``, driven by
``ServingGateway.submit``) advances the cycle by one bounded budget slice
instead of stalling a request on a full re-cluster.

Phases (each ``step()`` consumes ~budget_s of bounded units):

  cluster   incremental device-native SISO-Cluster over the snapshot
            (:class:`repro_torch.core.clustering.CommunityDetector`);
  plan      blocked Algorithm-1 merge (:class:`MergePlanner`), then
            filter + locality sort — the full new centroid region is
            known from here on;
  apply     bounded chunks of the sorted region staged into the
            semantic cache's shadow buffer (host memcpy; the live device
            mirror keeps serving, spill inserts keep patching it) — on a
            sharded cache plane (DESIGN.md §11) each chunk is scattered
            straight into its owner shard's staging rows;
  commit    one ``commit_shadow``: spill trim + single upload (per-shard
            when sharded) + atomic mirror-pointer swap (generation bump);
  t2h       the 5% T2H sample re-probed against the *new* state in
            bounded blocks; table install + ``retune()`` end the cycle.
            The block size is deliberately shard-agnostic: each probe
            already batches t2h_block queries into one dispatch, which
            amortizes the sharded plane's per-block collective, and a
            fixed block keeps the one-unit-per-tick latency bound
            independent of shard count.

Ported from ``repro/core/refresh.py``: host logic carried over; the
clustering and merge units run on the cache's device. The tiered demotion
and tenant-weighted filter of the reference arrive in later slices.

Equivalence: driving the pipeline to completion yields the same centroid
store, T2H table, and lookup results as the synchronous ``SISO.refresh()``
over the same snapshot (pinned by tests/test_refresh_pipeline.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cache_manager import (MergePlanner, RefreshStats,
                                            filter_centroids)
from repro_torch.core.clustering import CommunityDetector, run_budgeted
from repro_torch.core.store import CentroidStore
from repro_torch.core.threshold import T2HTable


class RefreshPipeline:
    """Owns one in-flight refresh cycle against a :class:`SISO` facade."""

    def __init__(self, siso, count_block: int = 32, seed_block: int = 32,
                 scan_rows: int = 24, merge_block: int = 128,
                 chunk_rows: Optional[int] = None, t2h_block: int = 64):
        self.siso = siso
        self.count_block = count_block
        self.seed_block = seed_block
        self.scan_rows = scan_rows
        self.merge_block = merge_block
        self.chunk_rows = chunk_rows
        self.t2h_block = t2h_block
        self.phase = "idle"
        # observability (SISO.stats / gateway report)
        self.cycles = 0          # completed refresh cycles
        self.ticks = 0           # step() calls that found work

    # ------------------------------------------------------------------ api

    @property
    def active(self) -> bool:
        return self.phase != "idle"

    def start_from_log(self, log_vecs: list, log_answers: list,
                       rng: Optional[np.random.Generator] = None) -> None:
        """Begin a cycle over SISO's raw miss-log lists — the snapshot is
        owned by the pipeline; new misses recorded while the cycle is in
        flight belong to the *next* cycle. Stacking the lists into arrays
        is O(log) memcpy, so it runs as the first ``step()`` unit instead
        of inside the serving tick that merely *starts* the cycle."""
        if self.active:
            raise RuntimeError("refresh cycle already in flight")
        if not log_vecs:
            return
        self._raw = (log_vecs, log_answers)
        self._rng = rng
        self._stats: Optional[RefreshStats] = None
        self.phase = "snapshot"

    def step(self, budget_s: float = 0.0) -> Optional[RefreshStats]:
        """Advance the cycle by ~budget_s of bounded work (0 -> one unit).
        Returns the cycle's RefreshStats on the tick that completes it,
        else None. Never blocks on a full re-cluster."""
        if not self.active:
            return None
        self.ticks += 1
        run_budgeted(self._unit, lambda: not self.active, budget_s)
        return None if self.active else self._stats

    def finish(self) -> Optional[RefreshStats]:
        """Run the in-flight cycle to completion (offline moment)."""
        return self.step(float("inf")) if self.active else None

    # ---------------------------------------------------------------- units

    def _unit(self) -> None:
        getattr(self, f"_unit_{self.phase}")()

    def _unit_snapshot(self) -> None:
        """Materialize the snapshot arrays (one O(log) memcpy unit)."""
        log_vecs, log_answers = self._raw
        self._vecs = np.stack(log_vecs)
        self._answers = np.stack([a for a, _ in log_answers])
        self._aids = np.array([i for _, i in log_answers], np.int64)
        self._raw = None
        self._detector = CommunityDetector(
            self._vecs, threshold=self.siso.cfg.theta_c,
            count_block=self.count_block, seed_block=self.seed_block,
            scan_rows=self.scan_rows, fused_counts=False,
            device=self.siso.cache.device)
        # freeze the live access counts at cycle start: had the refresh
        # run synchronously here, every later hit would land post-swap —
        # the commit carries exactly that delta into the new store
        self._counts0 = self.siso.cache.centroids.access_count.copy()
        self.phase = "cluster"

    def _unit_cluster(self) -> None:
        if self._detector.step(0.0):
            return
        cents, reps, sizes = self._detector.result_arrays()
        repo = CentroidStore(self.siso.cfg.dim, self.siso.cfg.answer_dim)
        if len(cents):
            repo.add(cents, self._answers[reps], sizes,
                     answer_id=self._aids[reps])
        self._detector = None
        self._planner = MergePlanner(self.siso.cache.centroids, repo,
                                     self.siso.cfg.theta_c,
                                     block=self.merge_block,
                                     device=self.siso.cache.device)
        self.phase = "plan"

    def _unit_plan(self) -> None:
        if self._planner.step(0.0):
            return
        c_new, stats = self._planner.result()
        self._planner = None
        c_new, stats.evicted = filter_centroids(
            c_new, self.siso.centroid_capacity, self.siso.manager.decay)
        # final store in the cache's locality-first layout, rebuilt through
        # a fresh add() so ids match the synchronous staging path exactly
        final = CentroidStore(self.siso.cfg.dim, self.siso.cfg.answer_dim)
        final.add(c_new.vectors, c_new.answers, c_new.cluster_size,
                  c_new.access_count, c_new.answer_id)
        order = np.argsort(-final.cluster_size, kind="stable")
        final.take(order)
        # provenance ids per final row (the rebuild assigns fresh ids to
        # mirror the sync staging path; the carry needs the originals)
        self._src_ids = c_new.ids[order]
        self._final = final
        self._stats = stats
        self._cursor = 0
        self.siso.cache.begin_shadow(len(final))
        self.phase = "apply"

    def _unit_apply(self) -> None:
        final = self._final
        rows = self.chunk_rows or self.siso.manager.update_group
        s = self._cursor
        e = min(s + rows, len(final))
        if e > s:
            self.siso.cache.shadow_write(final.vectors[s:e],
                                         final.answers[s:e],
                                         final.answer_id[s:e])
        self._cursor = e
        if e >= len(final):
            self.phase = "commit"

    def _unit_commit(self) -> None:
        self._carry_access_counts()
        self.siso.cache.commit_shadow(self._final)
        self._final = None
        # T2H sample exactly as the synchronous path draws it (§4.1: 5%
        # of the fresh queries), probed against the NEW state
        self._t2h_sample = self.siso.draw_t2h_sample(self._vecs, self._rng)
        self._t2h_pos = 0
        self._t2h_sims: list[np.ndarray] = []
        self.phase = "t2h"

    def _unit_t2h(self) -> None:
        s = self._t2h_pos
        e = min(s + self.t2h_block, len(self._t2h_sample))
        res = self.siso.cache.lookup(self._t2h_sample[s:e], theta_r=-1.0,
                                     update_counts=False)
        self._t2h_sims.append(res.sim)
        self._t2h_pos = e
        if e >= len(self._t2h_sample):
            sims = np.concatenate(self._t2h_sims)
            self.siso.t2h = T2HTable.from_sims(sims)
            self.siso.threshold.t2h = self.siso.t2h
            self.siso.threshold.retune()
            self._vecs = self._answers = self._aids = None
            self._t2h_sample = self._t2h_sims = None
            self.cycles += 1
            self.phase = "idle"

    # ---------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        """Serializable view of the in-flight cycle (DESIGN.md §12).

        Device-side intermediates (CommunityDetector tiles, MergePlanner
        blocks, the half-staged shadow buffer) are deliberately NOT
        serialized: every phase up to ``commit`` is a deterministic pure
        function of the snapshot arrays + the frozen access counts, so a
        restore simply *restarts* the cycle from its inputs ("restart"
        group) and converges to the identical store/T2H. Once the commit
        has swapped the mirror ("t2h" phase), re-running the merge would
        double-apply Algorithm 1 — so from there the bounded T2H probe
        state itself is carried (sample, cursor, accumulated sims).
        """
        out = {"cycles": np.asarray(self.cycles),
               "ticks": np.asarray(self.ticks)}
        if self.phase == "idle":
            out["phase"] = np.asarray("idle")
        elif self.phase == "t2h":
            st = self._stats or RefreshStats()
            out.update({
                "phase": np.asarray("t2h"),
                "t2h_sample": np.asarray(self._t2h_sample, np.float32),
                "t2h_pos": np.asarray(self._t2h_pos),
                "t2h_sims": (np.concatenate(self._t2h_sims)
                             if self._t2h_sims else
                             np.zeros((0,), np.float32)),
                "stats": np.asarray([st.merged, st.added, st.evicted],
                                    np.int64)})
        else:   # snapshot | cluster | plan | apply | commit -> restart
            if self.phase == "snapshot":    # arrays not stacked yet
                log_vecs, log_answers = self._raw
                vecs = np.stack(log_vecs)
                answers = np.stack([a for a, _ in log_answers])
                aids = np.array([i for _, i in log_answers], np.int64)
                counts0 = self.siso.cache.centroids.access_count.copy()
            else:
                vecs, answers, aids = self._vecs, self._answers, self._aids
                counts0 = self._counts0
            out.update({"phase": np.asarray("restart"),
                        "vecs": np.asarray(vecs, np.float32),
                        "answers": np.asarray(answers, np.float32),
                        "aids": np.asarray(aids, np.int64),
                        "counts0": np.asarray(counts0, np.float64)})
        return out

    def load_state(self, state: dict) -> None:
        # the restored state is authoritative: whatever cycle this object
        # was in (including one restored from a base snapshot a delta now
        # overlays) is discarded wholesale
        self._detector = self._planner = None
        self._raw = self._final = None
        self.cycles = int(state["cycles"])
        self.ticks = int(state["ticks"])
        phase = str(np.asarray(state["phase"]))
        if phase == "idle":
            self.phase = "idle"
            return
        self._rng = None    # custom cycle rngs do not survive a restart
        # np.array (copy) everywhere below: in-process restores must not
        # alias arrays the donor pipeline keeps mutating
        if phase == "t2h":
            st = np.asarray(state["stats"], np.int64)
            self._stats = RefreshStats(*(int(x) for x in st))
            self._t2h_sample = np.array(state["t2h_sample"], np.float32)
            self._t2h_pos = int(state["t2h_pos"])
            sims = np.array(state["t2h_sims"], np.float32)
            self._t2h_sims = [sims] if len(sims) else []
            self.phase = "t2h"
            return
        # pre-commit phases restart from the cycle's inputs: same snapshot
        # + same frozen counts -> same centroids, same carry, same T2H
        self._vecs = np.array(state["vecs"], np.float32)
        self._answers = np.array(state["answers"], np.float32)
        self._aids = np.array(state["aids"], np.int64)
        self._counts0 = np.array(state["counts0"], np.float64)
        self._stats = None
        self._detector = CommunityDetector(
            self._vecs, threshold=self.siso.cfg.theta_c,
            count_block=self.count_block, seed_block=self.seed_block,
            scan_rows=self.scan_rows, fused_counts=False,
            device=self.siso.cache.device)
        self.phase = "cluster"

    def _carry_access_counts(self) -> None:
        """Fold hits that landed while this cycle was in flight into the
        new store: the live store keeps counting during plan/apply, but
        the planner worked from the frozen copy — without the carry, a
        centroid that got hot mid-cycle would look cold to the NEXT
        refresh's (cluster_size, access_count) eviction sort. Matched by
        stable row id (surviving centroids keep theirs through the merge);
        the blocking refresh has no in-flight window, so its carry is
        always zero and the pipeline==sync equivalence is unaffected."""
        live = self.siso.cache.centroids
        delta = live.access_count - self._counts0
        self._counts0 = None
        if not np.any(delta):
            return
        src_ids = self._src_ids        # final-row -> pre-merge id
        order = np.argsort(live.ids)
        pos = np.searchsorted(live.ids[order], src_ids)
        pos = np.clip(pos, 0, len(order) - 1)
        match = live.ids[order][pos] == src_ids
        self._final.access_count[match] += delta[order][pos[match]]
