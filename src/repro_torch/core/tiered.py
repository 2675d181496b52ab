"""Tiered cache hierarchy: device → host → disk (port of
``repro/core/tiered.py``, DESIGN.md §13; host logic carried over as numpy).

The device mirror caps capacity at device memory. This module stacks two
further tiers under it, LMCache-style:

  device  the port's :class:`SemanticCache` (centroid + spill regions, K1
          or K2 on the mirror) — untouched hot path;
  host    full-precision centroids + answers in host RAM, searched brute
          force while small and via the locality-ordered HNSW
          (``core/hnsw.py``) once large;
  disk    an append-friendly answer store built on the checkpoint
          manager's atomic segment writes (``checkpoint/manager.py``,
          ``keep=0`` disables reaping) with a RAM-resident vector index.

Lookups fall through device top-1 → host ANN → disk; warm/cold hits are
queued for *asynchronous promotion* into the device mirror through
``SemanticCache.insert_spill`` (the mirror's in-place row patch), bounded
per serving tick. Demotion is the reverse flow: every device eviction
(spill LRU victims, spill trims after a refresh shrank leftover capacity,
and Algorithm-1 filter evictions at commit) lands in ``evict_sink`` and
is routed by a :class:`TierPolicy` into host or straight to disk.

Invariant: every live entry exists in exactly one tier — promotion
removes from the source tier before the device insert, demotion removes
from the device before the lower-tier add, and overflow drops are
counted, so total entries are conserved.

A 1-tier config (no host, no disk) installs no ``evict_sink`` and adds no
work to the device path: it is bit-identical to the plain
:class:`SemanticCache`.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.hnsw import HNSW
from repro_torch.core.semantic_cache import LookupResult, SemanticCache
from repro_torch.core.store import CentroidStore
from repro_torch.core.tenancy import fair_share_take

# LookupResult.region codes for the lower tiers (0 centroid, 1 spill)
REGION_HOST = 2
REGION_DISK = 3


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@dataclass
class TierPolicy:
    """TTL / tier-selection policy (the LMCache idiom, SNIPPETS.md §1).

    ``compute_ttl`` stretches a base TTL by semantic locality (ln of the
    cluster mass behind a centroid) and short-term popularity (ln of the
    access count): hot, high-locality entries stay warm longer.
    ``hotness`` is the scalar the demotion/eviction sorts key on — the
    same locality+popularity mass, decayed by age relative to the entry's
    TTL and penalized by answer size (big answers must earn their bytes).
    """
    base_ttl: float = 512.0   # hierarchy clock ticks a cold size-1 entry
                              # survives in the warm tier
    alpha: float = 0.5        # locality multiplier weight
    beta: float = 0.25        # popularity multiplier weight
    size_ref: float = 4096.0  # answer bytes at which the size penalty = 2x
    disk_cut: float = 0.05    # device evictions below this hotness skip
                              # the warm tier and demote straight to disk

    def compute_ttl(self, cluster_size: np.ndarray,
                    access_count: np.ndarray) -> np.ndarray:
        cs = np.maximum(np.nan_to_num(np.asarray(cluster_size, np.float64),
                                      posinf=0.0), 0.0)
        ac = np.maximum(np.nan_to_num(np.asarray(access_count, np.float64),
                                      posinf=0.0), 0.0)
        return (self.base_ttl * (1.0 + self.alpha * np.log1p(cs))
                * (1.0 + self.beta * np.log1p(ac)))

    def hotness(self, cluster_size: np.ndarray, access_count: np.ndarray,
                last_use: np.ndarray, clock: int,
                answer_bytes: np.ndarray) -> np.ndarray:
        cs = np.maximum(np.nan_to_num(np.asarray(cluster_size, np.float64),
                                      posinf=0.0), 0.0)
        ac = np.maximum(np.nan_to_num(np.asarray(access_count, np.float64),
                                      posinf=0.0), 0.0)
        age = np.maximum(clock - np.asarray(last_use, np.float64), 0.0)
        ttl = self.compute_ttl(cs, ac)
        mass = 1.0 + np.log1p(cs) + np.log1p(ac)
        size_pen = 1.0 + np.asarray(answer_bytes, np.float64) / self.size_ref
        return mass * np.exp(-age / ttl) / size_pen

    def select_tier(self, hotness: np.ndarray, has_host: bool,
                    has_disk: bool) -> np.ndarray:
        """(N,) destination per evicted entry: 0 host, 1 disk, 2 drop."""
        n = len(hotness)
        if has_host and has_disk:
            return np.where(hotness >= self.disk_cut, 0, 1).astype(np.int8)
        if has_host:
            return np.zeros(n, np.int8)
        if has_disk:
            return np.ones(n, np.int8)
        return np.full(n, 2, np.int8)


# ---------------------------------------------------------------------------
# host warm tier
# ---------------------------------------------------------------------------


class HostTier:
    """Full-precision warm tier in host RAM.

    Entries carry the same struct-of-arrays as the device store plus a
    recency clock. Search is exact brute force below ``hnsw_min`` rows and
    the locality-ordered HNSW above it (rebuilt lazily once enough
    mutations accumulate; rows added after a build are covered by an exact
    brute-force overlay, and built rows whose entry has since left the
    tier are skipped via their stable id).
    """

    def __init__(self, dim: int, answer_dim: int, hnsw_min: int = 4096):
        self.store = CentroidStore(dim, answer_dim)
        self.last_use = np.zeros((0,), np.int64)
        self.hnsw_min = hnsw_min
        self._index = None
        self._index_ids: Optional[np.ndarray] = None   # built-pos -> id
        self._mutations = 0      # removals/adds since the last build

    def __len__(self) -> int:
        return len(self.store)

    # -------------------------------------------------------------- mutation

    def add(self, vectors: np.ndarray, answers: np.ndarray,
            answer_id: np.ndarray, cluster_size: np.ndarray,
            access_count: np.ndarray, clock: int) -> np.ndarray:
        ids = self.store.add(vectors, answers, cluster_size,
                             access_count=access_count, answer_id=answer_id)
        self.last_use = np.concatenate(
            [self.last_use, np.full(len(ids), clock, np.int64)])
        self._mutations += len(ids)
        return ids

    def take_rows(self, rows: np.ndarray) -> tuple:
        """Remove ``rows`` and return their field arrays (copies)."""
        rows = np.asarray(rows, np.int64)
        st = self.store
        out = (st.vectors[rows].copy(), st.answers[rows].copy(),
               st.answer_id[rows].copy(), st.cluster_size[rows].copy(),
               st.access_count[rows].copy())
        mask = np.ones(len(st), bool)
        mask[rows] = False
        st.take(mask)
        self.last_use = self.last_use[mask]
        self._mutations += len(rows)
        return out

    def row_of(self, entry_id: int) -> Optional[int]:
        rows = np.flatnonzero(self.store.ids == entry_id)
        return int(rows[0]) if len(rows) else None

    def touch(self, rows: np.ndarray, clock: int) -> None:
        self.last_use[rows] = clock
        np.add.at(self.store.access_count, rows, 1.0)

    # ---------------------------------------------------------------- search

    def search(self, queries: np.ndarray
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Top-1 per query: (sims (B,), row (B,)), or None when empty."""
        n = len(self.store)
        if n == 0:
            return None
        if n < self.hnsw_min:
            return self._brute(queries, np.arange(n))
        self._ensure_index()
        built = len(self._index_ids)
        id2row = {int(i): r for r, i in enumerate(self.store.ids)}
        sims = np.full(len(queries), -1.0, np.float32)
        rows = np.zeros(len(queries), np.int64)
        for b, q in enumerate(queries):
            # a built row may have been promoted/demoted away since the
            # build: take the best candidate whose id is still live
            for p, s in self._index.search(q, k=4):
                r = id2row.get(int(self._index_ids[p]))
                if r is not None:
                    sims[b], rows[b] = np.float32(s), r
                    break
        if built < n:   # exact overlay over rows added after the build
            tail = np.arange(built, n)
            tsims, trows = self._brute(queries, tail)
            better = tsims > sims
            sims[better], rows[better] = tsims[better], trows[better]
        return sims, rows

    def _brute(self, queries: np.ndarray, rows: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
        sims = queries @ self.store.vectors[rows].T          # (B, n)
        j = np.argmax(sims, axis=1)
        best = sims[np.arange(len(queries)), j].astype(np.float32)
        return best, rows[j]

    def _ensure_index(self) -> None:
        built = 0 if self._index_ids is None else len(self._index_ids)
        stale = self._mutations > max(64, built // 8)
        if self._index is None or stale:
            self._index = HNSW.build(self.store.vectors,
                                     locality=self.store.cluster_size)
            self._index_ids = self.store.ids.copy()
            self._mutations = 0

    # ----------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        return {"store": self.store.state_dict(),
                "last_use": self.last_use}

    def load_state(self, state: dict) -> None:
        self.store = CentroidStore.from_state(state["store"])
        self.last_use = np.array(state["last_use"], np.int64)
        self._index = self._index_ids = None    # rebuilt lazily
        self._mutations = 0


# ---------------------------------------------------------------------------
# disk cold tier
# ---------------------------------------------------------------------------


class DiskTier:
    """Append-friendly cold tier on the checkpoint atomic-write machinery.

    Answers are flushed in segments through a :class:`CheckpointManager`
    with ``keep=0`` (retention disabled — segments are data, not
    checkpoints), so every segment lands via the same tmp+fsync+rename
    dance as a snapshot: a crash can never leave a torn segment. The
    search index (vectors + metadata) stays in RAM; freshly demoted rows
    buffer in a pending list (answers in RAM, ``seg == -1``) and flush
    once ``flush_rows`` accumulate, keeping the serving path off
    synchronous disk writes. Promotion out of the tier tombstones the row
    (``live = False``) — the segment bytes become garbage, which is the
    append-friendly trade.
    """

    def __init__(self, directory: str, dim: int, answer_dim: int,
                 flush_rows: int = 128, seg_cache: int = 8):
        self.manager = CheckpointManager(directory, keep=0)
        self.dim = dim
        self.answer_dim = answer_dim
        self.flush_rows = flush_rows
        self.vectors = np.zeros((0, dim), np.float32)
        self.answer_id = np.zeros((0,), np.int64)
        self.cluster_size = np.zeros((0,), np.float64)
        self.access_count = np.zeros((0,), np.float64)
        self.last_use = np.zeros((0,), np.int64)
        self.seg = np.zeros((0,), np.int64)     # -1 = pending (RAM)
        self.row = np.zeros((0,), np.int64)     # row within segment/pending
        self.live = np.zeros((0,), bool)
        self.ids = np.zeros((0,), np.int64)
        self._next_id = 0
        self._next_seg = 0
        self._pending: list[np.ndarray] = []    # answers not yet flushed
        self._seg_cache: dict[int, np.ndarray] = {}
        self._seg_cache_cap = seg_cache

    @property
    def live_count(self) -> int:
        return int(self.live.sum())

    # -------------------------------------------------------------- mutation

    def append(self, vectors: np.ndarray, answers: np.ndarray,
               answer_id: np.ndarray, cluster_size: np.ndarray,
               access_count: np.ndarray, clock: int) -> np.ndarray:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n = len(vectors)
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        rows = np.arange(len(self._pending),
                         len(self._pending) + n, dtype=np.int64)
        self._pending.extend(np.asarray(a, np.float32).copy()
                             for a in np.atleast_2d(answers))
        self.vectors = np.concatenate([self.vectors, vectors])
        self.answer_id = np.concatenate(
            [self.answer_id, np.asarray(answer_id, np.int64)])
        self.cluster_size = np.concatenate(
            [self.cluster_size, np.asarray(cluster_size, np.float64)])
        self.access_count = np.concatenate(
            [self.access_count, np.asarray(access_count, np.float64)])
        self.last_use = np.concatenate(
            [self.last_use, np.full(n, clock, np.int64)])
        self.seg = np.concatenate([self.seg, np.full(n, -1, np.int64)])
        self.row = np.concatenate([self.row, rows])
        self.live = np.concatenate([self.live, np.ones(n, bool)])
        self.ids = np.concatenate([self.ids, ids])
        if len(self._pending) >= self.flush_rows:
            self.flush()
        return ids

    def flush(self) -> None:
        """Write the pending answers as one atomic segment."""
        if not self._pending:
            return
        arr = np.stack(self._pending)
        self.manager.save(self._next_seg, {"answers": arr})
        pend = self.seg == -1
        # pending rows keep their within-buffer order as the segment row
        self.seg[pend] = self._next_seg
        self._seg_cache[self._next_seg] = arr
        self._trim_seg_cache()
        self._next_seg += 1
        self._pending = []

    def answer(self, idx: int) -> np.ndarray:
        if self.seg[idx] == -1:
            return self._pending[int(self.row[idx])].copy()
        return self._load_seg(int(self.seg[idx]))[int(self.row[idx])].copy()

    def _load_seg(self, seg: int) -> np.ndarray:
        if seg not in self._seg_cache:
            self._seg_cache[seg] = self.manager.restore(seg)["answers"]
            self._trim_seg_cache()
        return self._seg_cache[seg]

    def _trim_seg_cache(self) -> None:
        while len(self._seg_cache) > self._seg_cache_cap:
            self._seg_cache.pop(next(iter(self._seg_cache)))

    def pop(self, idx: int) -> tuple:
        """Tombstone row ``idx`` and return its entry (promotion out)."""
        out = (self.vectors[idx].copy(), self.answer(idx),
               int(self.answer_id[idx]), float(self.cluster_size[idx]),
               float(self.access_count[idx]))
        self.live[idx] = False
        return out

    def row_of(self, entry_id: int) -> Optional[int]:
        rows = np.flatnonzero((self.ids == entry_id) & self.live)
        return int(rows[0]) if len(rows) else None

    def touch(self, rows: np.ndarray, clock: int) -> None:
        self.last_use[rows] = clock
        np.add.at(self.access_count, rows, 1.0)

    # ---------------------------------------------------------------- search

    def search(self, queries: np.ndarray
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        rows = np.flatnonzero(self.live)
        if not len(rows):
            return None
        sims = queries @ self.vectors[rows].T
        j = np.argmax(sims, axis=1)
        best = sims[np.arange(len(queries)), j].astype(np.float32)
        return best, rows[j]

    # ----------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        return {"vectors": self.vectors, "answer_id": self.answer_id,
                "cluster_size": self.cluster_size,
                "access_count": self.access_count,
                "last_use": self.last_use, "seg": self.seg,
                "row": self.row, "live": self.live, "ids": self.ids,
                "pending": (np.stack(self._pending) if self._pending else
                            np.zeros((0, self.answer_dim), np.float32)),
                "next_id": np.asarray(self._next_id),
                "next_seg": np.asarray(self._next_seg)}

    def load_state(self, state: dict) -> None:
        self.vectors = np.array(state["vectors"], np.float32)
        self.answer_id = np.array(state["answer_id"], np.int64)
        self.cluster_size = np.array(state["cluster_size"], np.float64)
        self.access_count = np.array(state["access_count"], np.float64)
        self.last_use = np.array(state["last_use"], np.int64)
        self.seg = np.array(state["seg"], np.int64)
        self.row = np.array(state["row"], np.int64)
        self.live = np.array(state["live"], bool)
        self.ids = np.array(state["ids"], np.int64)
        self._pending = [a for a in np.array(state["pending"], np.float32)]
        self._next_id = int(state["next_id"])
        self._next_seg = int(state["next_seg"])
        self._seg_cache = {}


# ---------------------------------------------------------------------------
# the tiered frontend
# ---------------------------------------------------------------------------


@dataclass
class TieredCacheConfig:
    host_capacity: int = 0           # 0 disables the warm tier
    disk_capacity: int = 0           # 0 disables the cold tier
    disk_dir: Optional[str] = None   # required when disk_capacity > 0
    device_reserve: int = 0          # device rows kept out of the centroid
                                     # region so the spill always has room
                                     # for promotions (SISO plans refreshes
                                     # against capacity - device_reserve)
    promote_budget: int = 8          # promotions applied per promote_tick
    flush_rows: int = 128            # disk pending-buffer flush threshold
    hnsw_min: int = 4096             # host tier: brute force below this
    sweep_every: int = 64            # TTL sweep cadence (hierarchy ticks)
    sweep_max: int = 256             # max host entries expired per sweep
    policy: TierPolicy = field(default_factory=TierPolicy)


class TieredCache:
    """Three-tier frontend wrapping the port's :class:`SemanticCache`
    (DESIGN.md §13; ``device`` is that cache, the hot tier). Drop-in for
    the places SISO touches its cache: lookup / insert_spill / refresh
    staging / persistence all delegate to the device tier, with the
    host/disk fall-through and the promotion/demotion flows layered on
    top."""

    def __init__(self, device: SemanticCache, cfg: TieredCacheConfig):
        self.device = device
        self.cfg = cfg
        self.policy = cfg.policy
        if cfg.disk_capacity > 0 and not cfg.disk_dir:
            raise ValueError("TieredCacheConfig.disk_dir is required when "
                             "disk_capacity > 0 (the cold tier persists "
                             "answer segments there)")
        self.host = (HostTier(device.dim, device.answer_dim,
                              hnsw_min=cfg.hnsw_min)
                     if cfg.host_capacity > 0 else None)
        self.disk = (DiskTier(cfg.disk_dir, device.dim, device.answer_dim,
                              flush_rows=cfg.flush_rows)
                     if cfg.disk_capacity > 0 else None)
        # hierarchy clock: one tick per counted lookup batch — recency /
        # TTL ages are measured in it (deterministic, restart-safe)
        self.clock = 0
        # wrapper-level serving counters across ALL tiers (SISO's repeat
        # escape adjusts these directly, so they must be plain ints)
        self.hits = 0
        self.misses = 0
        self.tier_hits = {"device": 0, "host": 0, "disk": 0}
        self.promotions = 0
        self.demotions = {"host": 0, "disk": 0}
        self.drops = 0           # overflow evictions out of the hierarchy
        self._promo: deque = deque()       # (region, entry_id) FIFO
        self._promo_set: set = set()
        self.promote_latencies: deque = deque(maxlen=4096)
        self._last_sweep = 0
        # multi-tenant fair-share eviction (DESIGN.md §14): mirrors the
        # device tier's knobs — when SISO wires both, lower-tier capacity
        # victims are charged to their owning namespace too, so a flood
        # cannot purge a steady tenant's warm/cold entries either.
        # Defaults keep the unweighted hotness eviction bit-identical.
        self.fair_share_eviction = False
        self.tenant_of = None
        if self.host is not None or self.disk is not None:
            # the demotion tap: only installed when a lower tier exists,
            # so a 1-tier config leaves the device path bit-identical
            device.evict_sink = self._on_device_evict

    # ------------------------------------------------------- device plumbing

    @property
    def centroids(self):
        return self.device.centroids

    @property
    def spill(self):
        return self.device.spill

    @property
    def _spill_last_use(self):
        return self.device._spill_last_use

    @property
    def _spill_clock(self):
        return self.device._spill_clock

    @property
    def generation(self):
        return self.device.generation

    @property
    def shard(self):
        return self.device.shard

    @property
    def backend(self):
        return self.device.backend

    @property
    def _dev(self):
        return self.device._dev

    @property
    def spill_capacity(self):
        return self.device.spill_capacity

    @property
    def dev_rebuilds(self):
        return self.device.dev_rebuilds

    @property
    def dev_row_writes(self):
        return self.device.dev_row_writes

    @property
    def dev_swaps(self):
        return self.device.dev_swaps

    @property
    def evict_sink(self):
        # the refresh paths probe this to decide whether filter evictions
        # should be collected for demotion (None in a 1-tier config)
        return self.device.evict_sink

    @property
    def quant_rescored(self):
        return self.device.quant_rescored

    @property
    def quant_fallbacks(self):
        return self.device.quant_fallbacks

    def memory_bytes(self) -> dict:
        """Bytes-level accounting across the hierarchy (DESIGN.md §15):
        the device tier's mirror breakdown plus per-lower-tier
        centroid/answer bytes, so gateway.report() exposes where every
        cached byte lives."""
        out = self.device.memory_bytes()
        tiers = {"device": int(out["device_total_bytes"])}
        if self.host is not None:
            st = self.host.store
            tiers["host"] = int(st.vectors.nbytes + st.answers.nbytes)
        if self.disk is not None:
            live = int(self.disk.live.sum())
            tiers["disk"] = int(
                self.disk.vectors.nbytes
                + live * self.disk.answer_dim * 4)   # flushed f32 answers
        out["tier_bytes"] = tiers
        return out

    def set_centroids(self, store: CentroidStore) -> None:
        # drop spill staging rows whose identity the new centroid region
        # now carries — one copy per identity across the whole hierarchy
        self.device.drop_spill_ids(store.answer_id)
        self.device.set_centroids(store)
        self._purge_lower(self.device.centroids.answer_id)

    def apply_chunk(self, chunk: CentroidStore, first: bool) -> None:
        self.device.apply_chunk(chunk, first)

    def finish_update(self) -> None:
        staging = getattr(self.device, "_staging", None)
        if staging is not None:
            self.device.drop_spill_ids(staging.answer_id)
        self.device.finish_update()
        self._purge_lower(self.device.centroids.answer_id)

    def begin_shadow(self, n_new: int) -> None:
        self.device.begin_shadow(n_new)

    def shadow_write(self, vectors, answers, answer_id) -> None:
        self.device.shadow_write(vectors, answers, answer_id)

    def commit_shadow(self, store: CentroidStore) -> None:
        # before the swap: the commit uploads the surviving spill rows, so
        # identities moving into the new centroid region must leave first
        self.device.drop_spill_ids(store.answer_id)
        self.device.commit_shadow(store)
        self._purge_lower(self.device.centroids.answer_id)

    def _purge_lower(self, answer_ids: np.ndarray) -> None:
        """Upsert semantics: when an identity (answer_id >= 0) enters a
        higher tier — a refresh committed it as a centroid, or a fresh
        copy was re-recorded — stale lower-tier copies are removed, so
        every live id exists in exactly one tier. Anonymous entries
        (answer_id == -1) carry no identity and are left alone."""
        if self.host is None and self.disk is None:
            return
        ids = np.asarray(answer_ids, np.int64)
        ids = ids[ids >= 0]
        if not len(ids):
            return
        if self.host is not None and len(self.host):
            rows = np.flatnonzero(np.isin(self.host.store.answer_id, ids))
            if len(rows):
                self.host.take_rows(rows)
        if self.disk is not None:
            dead = self.disk.live & np.isin(self.disk.answer_id, ids)
            if dead.any():
                self.disk.live[dead] = False

    # ---------------------------------------------------------------- lookup

    def lookup(self, queries: np.ndarray, theta_r: float,
               update_counts: bool = True) -> LookupResult:
        """Fall-through lookup: device top-1 → host ANN → disk scan.

        Tier hits fill the result in place (region 2 host, 3 disk; entry
        carries the tier's stable entry id) and, when counted, bump the
        tier's recency/popularity and enqueue the entry for asynchronous
        promotion into the device mirror. T2H probes
        (``update_counts=False``) fall through without side effects."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        res = self.device.lookup(queries, theta_r,
                                 update_counts=update_counts)
        dev_hits = int(res.hit.sum())
        if update_counts:
            self.clock += 1
        pending = np.flatnonzero(~res.hit)
        if len(pending) and self.host is not None and len(self.host):
            pending = self._tier_fill(res, queries, pending, theta_r,
                                      self.host, REGION_HOST, "host",
                                      update_counts)
        if len(pending) and self.disk is not None and self.disk.live_count:
            self._tier_fill(res, queries, pending, theta_r,
                            self.disk, REGION_DISK, "disk", update_counts)
        if update_counts:
            hits = int(res.hit.sum())
            self.hits += hits
            self.misses += len(queries) - hits
            self.tier_hits["device"] += dev_hits
        return res

    def _tier_fill(self, res: LookupResult, queries: np.ndarray,
                   pending: np.ndarray, theta_r: float, tier, region: int,
                   name: str, update_counts: bool) -> np.ndarray:
        out = tier.search(queries[pending])
        if out is None:
            return pending
        sims, rows = out
        hit = sims >= theta_r
        if not hit.any():
            return pending
        qsel, rsel = pending[hit], rows[hit]
        res.hit[qsel] = True
        res.sim[qsel] = sims[hit]
        res.region[qsel] = region
        if region == REGION_HOST:
            st = tier.store
            res.answer[qsel] = st.answers[rsel]
            res.answer_id[qsel] = st.answer_id[rsel]
            res.entry[qsel] = st.ids[rsel]
        else:
            res.answer_id[qsel] = tier.answer_id[rsel]
            res.entry[qsel] = tier.ids[rsel]
            for q, r in zip(qsel, rsel):
                res.answer[q] = tier.answer(int(r))
        if update_counts:
            tier.touch(rsel, self.clock)
            self.tier_hits[name] += len(qsel)
            ids = (tier.store.ids if region == REGION_HOST
                   else tier.ids)[rsel]
            for i in ids:
                self._queue_promotion(region, int(i))
        return pending[~hit]

    def _queue_promotion(self, region: int, entry_id: int) -> None:
        key = (region, entry_id)
        if key not in self._promo_set:
            self._promo_set.add(key)
            self._promo.append(key)

    def undo_tier_hit(self, entry_id: int, region: int) -> None:
        """Repeat-escape undo for a warm/cold phantom hit: revert the
        popularity bump and cancel the queued promotion (the request went
        to the engine; the entry earned nothing)."""
        key = (int(region), int(entry_id))
        if key in self._promo_set:
            self._promo_set.discard(key)
            self._promo.remove(key)
        tier = self.host if region == REGION_HOST else self.disk
        if tier is None:
            return
        row = tier.row_of(int(entry_id))
        if row is None:
            return
        if region == REGION_HOST:
            tier.store.access_count[row] -= 1.0
            self.tier_hits["host"] -= 1
        else:
            tier.access_count[row] -= 1.0
            self.tier_hits["disk"] -= 1

    # ----------------------------------------------------------- insert path

    def insert_spill(self, vector: np.ndarray, answer: np.ndarray,
                     answer_id: int = -1, cluster_size: float = 1.0) -> None:
        if answer_id >= 0:
            # a re-recorded identity supersedes its lower-tier copies
            self._purge_lower(np.asarray([answer_id]))
        if (self.host is not None or self.disk is not None) \
                and (not self.device.spill_lru
                     or self.device.spill_capacity == 0):
            # the device can't take new entries (spill disabled or the
            # centroid region fills capacity): fresh answers land warm
            # instead of vanishing — the hierarchy's whole point
            self._admit_lower(np.atleast_2d(np.asarray(vector, np.float32)),
                              np.atleast_2d(np.asarray(answer, np.float32)),
                              np.asarray([answer_id], np.int64),
                              np.asarray([cluster_size], np.float64),
                              np.zeros(1, np.float64))
            return
        self.device.insert_spill(vector, answer, answer_id,
                                 cluster_size=cluster_size)

    def record(self, vector: np.ndarray, answer: np.ndarray,
               answer_id: int = -1, cluster_size: float = 1.0) -> None:
        """CacheFrontend protocol spelling of insert_spill()."""
        self.insert_spill(vector, answer, answer_id=answer_id,
                          cluster_size=cluster_size)

    def stats(self) -> dict:
        """CacheFrontend protocol stats: overall ratio + per-tier split."""
        return {"hit_ratio": self.hit_ratio, "tiers": self.tier_stats()}

    # ------------------------------------------------------- demotion flows

    def _on_device_evict(self, vectors, answers, answer_id, cluster_size,
                         access_count, kind: str) -> None:
        """``SemanticCache.evict_sink``: spill LRU victims, refresh spill
        trims, and Algorithm-1 filter evictions all demote through here
        instead of being discarded."""
        self._admit_lower(vectors, answers, answer_id, cluster_size,
                          access_count)

    def _admit_lower(self, vectors, answers, answer_id, cluster_size,
                     access_count) -> None:
        vectors = np.atleast_2d(vectors)
        if not len(vectors):
            return
        aid = np.asarray(answer_id, np.int64)
        # an identity still live on the device (e.g. the same answer was
        # both clustered into a centroid and staged in the spill) must not
        # gain a shadow copy below — the device row already serves it
        dev_live = np.concatenate([self.device.centroids.answer_id,
                                   self.device.spill.answer_id]) \
            if len(self.device.spill) else self.device.centroids.answer_id
        keep = ~((aid >= 0) & np.isin(aid, dev_live[dev_live >= 0]))
        if not keep.all():
            vectors = vectors[keep]
            answers = np.atleast_2d(answers)[keep]
            answer_id = aid[keep]
            cluster_size = np.asarray(cluster_size)[keep]
            access_count = np.asarray(access_count)[keep]
            if not len(vectors):
                return
        # upsert: a demoted identity replaces any stale lower-tier copy
        self._purge_lower(np.asarray(answer_id))
        bytes_ = np.full(len(vectors), 4.0 * self.device.answer_dim)
        # age 0 at demotion time: hotness is the pure locality/popularity
        # mass, so the policy splits genuinely-cold from recently-useful
        hot = self.policy.hotness(cluster_size, access_count,
                                  np.full(len(vectors), self.clock),
                                  self.clock, bytes_)
        dest = self.policy.select_tier(hot, self.host is not None,
                                       self.disk is not None)
        for code, tier_name in ((0, "host"), (1, "disk")):
            sel = dest == code
            if not sel.any():
                continue
            tier = self.host if code == 0 else self.disk
            fn = tier.add if code == 0 else tier.append
            fn(vectors[sel], np.atleast_2d(answers)[sel],
               np.asarray(answer_id)[sel],
               np.asarray(cluster_size)[sel],
               np.asarray(access_count)[sel], self.clock)
            self.demotions[tier_name] += int(sel.sum())
        self.drops += int((dest == 2).sum())
        self._enforce_capacity()

    def _enforce_capacity(self) -> None:
        if self.host is not None and len(self.host) > self.cfg.host_capacity:
            k = len(self.host) - self.cfg.host_capacity
            st = self.host.store
            score = self.policy.hotness(
                st.cluster_size, st.access_count, self.host.last_use,
                self.clock, np.full(len(st), 4.0 * self.device.answer_dim))
            if self.fair_share_eviction and self.tenant_of is not None:
                victims = np.sort(fair_share_take(
                    self.tenant_of(st.answer_id), score, k))
            else:
                victims = np.sort(np.argsort(score, kind="stable")[:k])
            entry = self.host.take_rows(victims)
            if self.disk is not None:
                self.disk.append(*entry, self.clock)
                self.demotions["disk"] += k
            else:
                self.drops += k
        if self.disk is not None \
                and self.disk.live_count > self.cfg.disk_capacity:
            k = self.disk.live_count - self.cfg.disk_capacity
            rows = np.flatnonzero(self.disk.live)
            score = self.policy.hotness(
                self.disk.cluster_size[rows], self.disk.access_count[rows],
                self.disk.last_use[rows], self.clock,
                np.full(len(rows), 4.0 * self.device.answer_dim))
            if self.fair_share_eviction and self.tenant_of is not None:
                victims = rows[fair_share_take(
                    self.tenant_of(self.disk.answer_id[rows]), score, k)]
            else:
                victims = rows[np.argsort(score, kind="stable")[:k]]
            self.disk.live[victims] = False
            self.drops += k

    # -------------------------------------------------------- promotion flow

    def promote_tick(self, budget: Optional[int] = None) -> int:
        """Apply up to ``budget`` queued promotions into the device mirror
        (each one ``insert_spill``: the mirror's in-place row patch), then
        run the TTL sweep if due. Called from the serving loop's refresh
        tick — never from lookup itself, so the fall-through read path
        stays write-free."""
        budget = self.cfg.promote_budget if budget is None else budget
        n = 0
        while self._promo and n < budget:
            region, eid = self._promo.popleft()
            self._promo_set.discard((region, eid))
            if not self.device.spill_lru or self.device.spill_capacity == 0:
                continue        # nowhere to promote into; entry stays put
            t0 = time.perf_counter()
            tier = self.host if region == REGION_HOST else self.disk
            if tier is None:
                continue
            row = tier.row_of(eid)
            if row is None:     # migrated/evicted since it was queued
                continue
            if region == REGION_HOST:
                vec, ans, aid, cs, ac = (
                    x[0] if getattr(x, "ndim", 0) else x
                    for x in tier.take_rows(np.asarray([row])))
            else:
                vec, ans, aid, cs, ac = tier.pop(row)
            # the device insert may evict a spill victim -> evict_sink ->
            # demotion: the promotion/demotion cycle conserves entries
            self.device.insert_spill(vec, ans, int(aid),
                                     cluster_size=float(cs))
            self.promotions += 1
            self.promote_latencies.append(time.perf_counter() - t0)
            n += 1
        self._maybe_sweep()
        return n

    def promote_drain(self) -> None:
        """Offline moment: apply every queued promotion and flush the
        disk tier's pending segment."""
        while self._promo:
            self.promote_tick(budget=len(self._promo))
        self._maybe_sweep(force=True)
        if self.disk is not None:
            self.disk.flush()

    def _maybe_sweep(self, force: bool = False) -> None:
        """TTL sweep: expire host entries whose age outran their
        locality/popularity-stretched TTL; they demote to disk (or drop
        when no cold tier exists)."""
        if self.host is None or not len(self.host):
            return
        if not force and self.clock - self._last_sweep < self.cfg.sweep_every:
            return
        self._last_sweep = self.clock
        st = self.host.store
        ttl = self.policy.compute_ttl(st.cluster_size, st.access_count)
        age = self.clock - self.host.last_use
        expired = np.flatnonzero(age > ttl)[: self.cfg.sweep_max]
        if not len(expired):
            return
        entry = self.host.take_rows(expired)
        if self.disk is not None:
            self.disk.append(*entry, self.clock)
            self.demotions["disk"] += len(expired)
        else:
            self.drops += len(expired)
        self._enforce_capacity()

    # --------------------------------------------------------------- metrics

    @property
    def hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def tier_membership(self) -> dict:
        """Per-tier live entry identity (answer_id) — the invariant tests'
        witness that every entry lives in exactly one tier."""
        dev = np.concatenate([self.device.centroids.answer_id,
                              self.device.spill.answer_id])
        return {
            "device": dev,
            "host": (self.host.store.answer_id.copy()
                     if self.host is not None else np.zeros(0, np.int64)),
            "disk": (self.disk.answer_id[self.disk.live].copy()
                     if self.disk is not None else np.zeros(0, np.int64)),
        }

    def tier_stats(self) -> dict:
        return {
            "tier_hits": dict(self.tier_hits),
            "promotions": self.promotions,
            "promotion_queue": len(self._promo),
            "demotions_host": self.demotions["host"],
            "demotions_disk": self.demotions["disk"],
            "tier_drops": self.drops,
            "host_rows": len(self.host) if self.host is not None else 0,
            "disk_rows": (self.disk.live_count
                          if self.disk is not None else 0),
            "disk_segments": (self.disk._next_seg
                              if self.disk is not None else 0),
            "host_capacity": self.cfg.host_capacity,
            "disk_capacity": self.cfg.disk_capacity,
        }

    # ----------------------------------------------------------- persistence

    def _own_state(self) -> dict:
        promo = (np.asarray(list(self._promo), np.int64).reshape(-1, 2)
                 if self._promo else np.zeros((0, 2), np.int64))
        out = {"clock": np.asarray(self.clock),
               "hits": np.asarray(self.hits),
               "misses": np.asarray(self.misses),
               "tier_hits": {k: np.asarray(v)
                             for k, v in self.tier_hits.items()},
               "promotions": np.asarray(self.promotions),
               "demotions": {k: np.asarray(v)
                             for k, v in self.demotions.items()},
               "drops": np.asarray(self.drops),
               "promo": promo,
               "last_sweep": np.asarray(self._last_sweep)}
        if self.host is not None:
            out["host"] = self.host.state_dict()
        if self.disk is not None:
            # flush first: a snapshot must never reference answer bytes
            # that exist only in this process's RAM
            self.disk.flush()
            out["disk"] = self.disk.state_dict()
        return out

    def _load_own(self, state: dict) -> None:
        self.clock = int(state["clock"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.tier_hits = {k: int(v) for k, v in state["tier_hits"].items()}
        self.promotions = int(state["promotions"])
        self.demotions = {k: int(v) for k, v in state["demotions"].items()}
        self.drops = int(state["drops"])
        promo = np.asarray(state["promo"], np.int64).reshape(-1, 2)
        self._promo = deque((int(r), int(i)) for r, i in promo)
        self._promo_set = set(self._promo)
        self.promote_latencies = deque(maxlen=4096)
        self._last_sweep = int(state["last_sweep"])
        if self.host is not None:
            if "host" not in state:
                raise ValueError("snapshot has no host tier but this "
                                 "config enables one")
            self.host.load_state(state["host"])
        if self.disk is not None:
            if "disk" not in state:
                raise ValueError("snapshot has no disk tier but this "
                                 "config enables one")
            self.disk.load_state(state["disk"])

    def state_dict(self) -> dict:
        return {"device": self.device.state_dict(), **self._own_state()}

    def state_delta(self) -> dict:
        """Delta snapshot: the device tier's cheap delta plus the lower
        tiers in full — host/disk indices are small relative to the
        centroid matrices a delta exists to avoid re-serializing."""
        return {"device": self.device.state_delta(), **self._own_state()}

    def load_state(self, state: dict) -> None:
        if "device" not in state:
            raise ValueError("snapshot is not a tiered-cache snapshot "
                             "(no 'device' tier) — config mismatch?")
        self.device.load_state(state["device"])
        self._load_own(state)

    def load_delta(self, state: dict) -> None:
        if "device" not in state:
            raise ValueError("delta snapshot is not a tiered-cache delta "
                             "(no 'device' tier) — config mismatch?")
        self.device.load_delta(state["device"])
        self._load_own(state)

    def rebuild_mirror(self) -> None:
        self.device.rebuild_mirror()
