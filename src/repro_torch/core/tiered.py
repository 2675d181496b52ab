"""Tiered cache hierarchy, device -> host -> disk (port of
``repro/core/tiered.py``, DESIGN.md §13): configuration only.

The hierarchy itself (``HostTier``, ``DiskTier``, ``TieredCache``) comes
with ROADMAP Queue A item 3 (persistence, tiers, tenants). Until then this
module holds what ``serving/config.py`` nests: :class:`TieredCacheConfig`
and its :class:`TierPolicy`, carried over field for field. Setting
``ServingConfig.tiering`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

@dataclass
class TierPolicy:
    """TTL / tier-selection policy (the LMCache idiom, SNIPPETS.md §1).

    ``compute_ttl`` stretches a base TTL by semantic locality (ln of the
    cluster mass behind a centroid) and short-term popularity (ln of the
    access count). ``hotness`` is the scalar the demotion/eviction sorts
    key on: the same locality+popularity mass, decayed by age relative to
    the entry's TTL and penalized by answer size.
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


@dataclass
class TieredCacheConfig:
    host_capacity: int = 0           # 0 disables the warm tier
    disk_capacity: int = 0           # 0 disables the cold tier
    disk_dir: Optional[str] = None   # required when disk_capacity > 0
    device_reserve: int = 0          # device rows kept out of the centroid
                                     # region so the spill always has room
                                     # for promotions
    promote_budget: int = 8          # promotions applied per promote_tick
    flush_rows: int = 128            # disk pending-buffer flush threshold
    hnsw_min: int = 4096             # host tier: brute force below this
    sweep_every: int = 64            # TTL sweep cadence (hierarchy ticks)
    sweep_max: int = 256             # max host entries expired per sweep
    policy: TierPolicy = field(default_factory=TierPolicy)
