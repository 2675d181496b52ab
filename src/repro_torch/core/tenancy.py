"""Multi-tenant namespaces for the semantic cache (port of
``repro/core/tenancy.py``, DESIGN.md §14; host logic carried over as
numpy).

One global cache plus per-tenant machinery, threaded from the gateway
request down through lookup, admission, eviction, and persistence:

  * :class:`TenantOverlay` — a small per-namespace LRU view holding a
    tenant's *personal* answers. Lookup checks overlay-then-global;
    personal admissions go to the overlay only and never enter the shared
    log, so they are never clustered into the global centroid region.
  * :class:`TenantRegistry` — answer-identity -> tenant attribution. The
    shared regions (centroids, spill, warm/cold tiers) stay
    tenant-agnostic; fair-share eviction derives each row's owner from its
    answer_id through this map.
  * :func:`fair_share_take` — tenant-weighted victim selection: victims
    are drawn from the currently-largest namespace first (water-filling),
    so a flooding tenant evicts its own rows before anyone else's.

Anonymous traffic (tenant ``-1``) is one shared pool: it counts as a
single namespace in fair-share accounting but never creates overlays,
registry entries, or per-tenant controller state.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

# LookupResult.region code for overlay hits (0 centroid, 1 spill,
# 2 host tier, 3 disk tier — core/tiered.py)
REGION_OVERLAY = 4


@dataclass
class TenancyConfig:
    overlay_capacity: int = 64   # per-tenant overlay rows; 0 disables
                                 # overlays (shared-cache-only tenancy)
    personal_sim: float = 0.90   # an engine answer whose query is this
                                 # similar to the tenant's recent misses is
                                 # classified personal -> overlay admission
    recent_window: int = 32      # recent-miss vectors kept per tenant for
                                 # the personal/global classification
    fair_share_eviction: bool = True
                                 # tenant-weighted victim selection in
                                 # spill insert/trim, refresh filter
                                 # eviction, and tier demotion
    per_tenant_theta: bool = True
                                 # per-namespace DynamicThreshold state
                                 # (arrival windows, theta, feedback bias)
    max_tenants: int = 4096      # hard cap on tracked namespaces (beyond
                                 # it, new tenants serve from the shared
                                 # pool only — no unbounded state growth)
    registry_cap: int = 1 << 16  # answer-id -> tenant map entries (FIFO)


def fair_share_take(tenants: np.ndarray, key: np.ndarray, k: int,
                    incoming: Optional[int] = None) -> np.ndarray:
    """Pick ``k`` eviction victims fairly across namespaces.

    ``tenants`` charges each row to its owner (-1 = the shared pool,
    itself one namespace); ``key`` orders rows *within* a namespace
    (ascending = evicted first — an LRU clock or a hotness rank). Victims
    are drawn by water-filling: always from the namespace with the
    largest current occupancy (ties break toward the smaller tenant id,
    deterministically), so occupancies converge toward the fair share and
    a flooding tenant consumes its own rows first. ``incoming`` charges
    one not-yet-inserted row to its tenant, so an insert's victim choice
    sees the post-insert occupancy.

    With a single namespace present this degrades to plain ``key`` order
    — exactly the unweighted LRU/hotness eviction.
    """
    tenants = np.asarray(tenants, np.int64)
    n = len(tenants)
    k = int(min(max(k, 0), n))
    if k == 0:
        return np.zeros((0,), np.int64)
    uniq, inv = np.unique(tenants, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    if incoming is not None:
        j = np.searchsorted(uniq, int(incoming))
        if j < len(uniq) and uniq[j] == int(incoming):
            counts[j] += 1
    # per-namespace row lists in ascending key order (stable: equal keys
    # keep row order, matching np.argsort(kind="stable"))
    order = np.argsort(key, kind="stable")
    per: list[list[int]] = [[] for _ in uniq]
    for r in order:
        per[inv[r]].append(int(r))
    cursor = np.zeros(len(uniq), np.int64)
    avail = np.array([len(p) for p in per], np.int64)
    out = np.empty(k, np.int64)
    for i in range(k):
        # largest occupancy with rows still available; ties -> smaller id
        cand = np.where(avail > cursor)[0]
        g = cand[np.argmax(counts[cand])]
        out[i] = per[g][cursor[g]]
        cursor[g] += 1
        counts[g] -= 1
    return out


class TenantOverlay:
    """Per-namespace LRU view: a tenant's personal answers (DESIGN.md
    §14). Small by construction (``overlay_capacity`` rows), searched
    brute-force before the global lookup; hits carry region code
    :data:`REGION_OVERLAY` and the overlay row as the entry id."""

    def __init__(self, dim: int, answer_dim: int, capacity: int):
        self.dim = dim
        self.answer_dim = answer_dim
        self.capacity = capacity
        self.vectors = np.zeros((0, dim), np.float32)
        self.answers = np.zeros((0, answer_dim), np.float32)
        self.answer_id = np.zeros((0,), np.int64)
        self.access_count = np.zeros((0,), np.float64)
        self.last_use = np.zeros((0,), np.int64)
        self.clock = 0

    def __len__(self) -> int:
        return len(self.vectors)

    def add(self, vector: np.ndarray, answer: np.ndarray,
            answer_id: int = -1) -> None:
        self.clock += 1
        vector = np.asarray(vector, np.float32)
        answer = np.asarray(answer, np.float32)
        if answer_id >= 0:
            dup = np.flatnonzero(self.answer_id == answer_id)
            if len(dup):        # upsert: one copy per identity
                r = int(dup[0])
                self.vectors[r] = vector
                self.answers[r] = answer
                self.last_use[r] = self.clock
                return
        if self.capacity > 0 and len(self) >= self.capacity:
            victim = int(np.argmin(self.last_use))
            self.vectors[victim] = vector
            self.answers[victim] = answer
            self.answer_id[victim] = answer_id
            self.access_count[victim] = 0.0
            self.last_use[victim] = self.clock
            return
        self.vectors = np.concatenate([self.vectors, vector[None]])
        self.answers = np.concatenate([self.answers, answer[None]])
        self.answer_id = np.append(self.answer_id, np.int64(answer_id))
        self.access_count = np.append(self.access_count, 0.0)
        self.last_use = np.append(self.last_use, np.int64(self.clock))

    def search(self, vector: np.ndarray) -> tuple[float, int]:
        """Top-1 (sim, row); (-1.0, -1) when empty."""
        if not len(self.vectors):
            return -1.0, -1
        sims = self.vectors @ np.asarray(vector, np.float32)
        r = int(np.argmax(sims))
        return float(sims[r]), r

    def touch(self, row: int) -> int:
        """Count a served hit; returns the pre-touch recency so a repeat
        escape can undo it exactly."""
        prev = int(self.last_use[row])
        self.clock += 1
        self.last_use[row] = self.clock
        self.access_count[row] += 1.0
        return prev

    def untouch(self, row: int, prev_last_use: int) -> None:
        """Repeat-escape undo of :meth:`touch` (the clock keeps its tick —
        monotone, like the spill clock after a recency restore)."""
        self.last_use[row] = prev_last_use
        self.access_count[row] -= 1.0

    def state_dict(self) -> dict:
        return {"vectors": self.vectors, "answers": self.answers,
                "answer_id": self.answer_id,
                "access_count": self.access_count,
                "last_use": self.last_use,
                "clock": np.asarray(self.clock)}

    def load_state(self, state: dict) -> None:
        self.vectors = np.array(state["vectors"], np.float32)
        self.answers = np.array(state["answers"], np.float32)
        self.answer_id = np.array(state["answer_id"], np.int64)
        self.access_count = np.array(state["access_count"], np.float64)
        self.last_use = np.array(state["last_use"], np.int64)
        self.clock = int(state["clock"])


class TenantState:
    """Everything SISO keeps per identified namespace: the overlay, the
    recent-miss window driving the personal/global admission split, and
    serving counters for the per-tenant report."""

    def __init__(self, dim: int, answer_dim: int, cfg: TenancyConfig):
        self.cfg = cfg
        self.overlay = TenantOverlay(dim, answer_dim, cfg.overlay_capacity)
        self.recent = np.zeros((0, dim), np.float32)   # newest last
        self.hits = 0           # served from cache (overlay or global)
        self.misses = 0
        self.overlay_hits = 0

    def is_personal(self, vector: np.ndarray) -> bool:
        """Classify an engine answer before its query joins the window:
        personal = the tenant has recently re-asked something this
        similar (a paraphrase of their own traffic)."""
        if self.cfg.overlay_capacity <= 0 or not len(self.recent):
            return False
        sims = self.recent @ np.asarray(vector, np.float32)
        return float(sims.max()) >= self.cfg.personal_sim

    def push_recent(self, vector: np.ndarray) -> None:
        self.recent = np.concatenate(
            [self.recent, np.asarray(vector, np.float32)[None]])
        if len(self.recent) > self.cfg.recent_window:
            self.recent = self.recent[-self.cfg.recent_window:]

    def state_dict(self) -> dict:
        return {"overlay": self.overlay.state_dict(),
                "recent": self.recent,
                "hits": np.asarray(self.hits),
                "misses": np.asarray(self.misses),
                "overlay_hits": np.asarray(self.overlay_hits)}

    def load_state(self, state: dict) -> None:
        self.overlay.load_state(state["overlay"])
        self.recent = np.array(state["recent"], np.float32)
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.overlay_hits = int(state["overlay_hits"])


class TenantRegistry:
    """Answer-identity -> tenant attribution (bounded FIFO map).

    The shared stores stay tenant-agnostic; eviction paths resolve row
    ownership through :meth:`tenants_of` on their ``answer_id`` columns.
    Unknown or anonymous identities map to -1 (the shared pool)."""

    def __init__(self, cap: int = 1 << 16):
        self.cap = cap
        self._map: OrderedDict[int, int] = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def note(self, answer_id: int, tenant: int) -> None:
        if answer_id < 0 or tenant < 0:
            return
        if answer_id in self._map:
            self._map.move_to_end(answer_id)
        self._map[answer_id] = int(tenant)
        while len(self._map) > self.cap:
            self._map.popitem(last=False)

    def tenants_of(self, answer_ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(answer_ids, np.int64).reshape(-1)
        out = np.full(len(ids), -1, np.int64)
        m = self._map
        for i, a in enumerate(ids):
            t = m.get(int(a))
            if t is not None:
                out[i] = t
        return out

    def occupancy(self, answer_ids: np.ndarray) -> dict[int, int]:
        """Per-tenant row counts over a membership array (-1 = shared)."""
        t = self.tenants_of(answer_ids)
        uniq, counts = np.unique(t, return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, counts)}

    def state_dict(self) -> dict:
        ids = np.fromiter(self._map.keys(), np.int64, len(self._map))
        ten = np.fromiter(self._map.values(), np.int64, len(self._map))
        return {"ids": ids, "tenants": ten, "cap": np.asarray(self.cap)}

    def load_state(self, state: dict) -> None:
        self.cap = int(state.get("cap", self.cap))
        self._map = OrderedDict(
            (int(a), int(t))
            for a, t in zip(np.asarray(state["ids"], np.int64),
                            np.asarray(state["tenants"], np.int64)))
