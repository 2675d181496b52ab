"""Unified serving configuration (port of ``repro/serving/config.py``,
DESIGN.md §16.4).

:class:`ServingConfig` is the one composable root, nested dataclasses, one
per concern:

    ServingConfig(
        cache=CacheConfig(dim=64, capacity=4096, backend="dense"),
        refresh=RefreshConfig(frac=0.10, async_pipeline=True),
        tiering=TieredCacheConfig(...),      # or None
        tenancy=TenancyConfig(...),          # or None
        persistence=PersistenceConfig(directory="..."),  # or None
        sharding=ShardedCacheConfig(...),    # or None
        replication=None,
        slo_latency=1.0, llm_latency=0.5,
    )

built through ``SISO.from_config(cfg)`` and
``ServingGateway.from_config(cfg, engine=..., embed_fn=...)``. Both lower
through :meth:`ServingConfig.to_siso_config`, so new-style construction is
bit-identical to building ``SISO(SISOConfig(...))`` with the same fields.

The plane configs are carried over field for field, and every plane is
ported. ``replication`` is read by the launcher, which builds the replica
group (``launch/serve.py``), and ``SISO.from_config`` ignores it, as the
reference does. ``sharding`` places the cache's shards on the devices of
its ``mesh`` (``launch/mesh.py``); left unset, the mesh is the first
``n_shards`` CUDA devices, or virtual shards on the CPU for a frontend
built with ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.siso import SISOConfig
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.core.tiered import TieredCacheConfig
from repro_torch.distributed.cache_plane import ShardedCacheConfig
from repro_torch.distributed.replication import ReplicationConfig
from repro_torch.distributed.transport import TransportConfig


@dataclass
class CacheConfig:
    """The cache plane proper: geometry, backend, thresholds, policies."""
    dim: int = 64
    answer_dim: Optional[int] = None     # None -> dim
    capacity: int = 4096
    backend: str = "dense"               # dense | hnsw | pallas | pallas_q8
    spill_lru: bool = True
    rescore_k: int = 16                  # quant plane top-C (DESIGN.md §15)
    theta_c: float = 0.86                # clustering threshold
    theta_r: float = 0.86                # retrieval threshold (initial/fixed)
    dynamic_threshold: bool = True       # M/D/1 + T2H control loop (§7.1)
    repeat_sim: float = 0.99             # same-user repeat escape
    repeat_window: float = 60.0          # seconds


@dataclass
class RefreshConfig:
    """Algorithm-1 refresh cadence and the incremental pipeline knobs."""
    frac: float = 0.10                   # re-cluster at +frac new queries
    min: int = 32                        # cold-start floor before first cycle
    async_pipeline: bool = True          # budget-sliced RefreshPipeline (§10)
    budget_s: float = 0.002              # per-tick wall budget
    t2h_sample_frac: float = 0.05        # paper: 5% of fresh queries


@dataclass
class PersistenceConfig:
    """Crash-safe snapshotting (DESIGN.md §12); wired by
    ``ServingGateway.from_config`` via ``attach_persistence``."""
    directory: str = ""
    keep: int = 3
    async_write: bool = True
    delta_every: int = 16


@dataclass
class ServingConfig:
    """One composable root for the whole serving plane. Optional nested
    configs default to None = that plane off."""
    cache: CacheConfig = field(default_factory=CacheConfig)
    refresh: RefreshConfig = field(default_factory=RefreshConfig)
    tiering: Optional[TieredCacheConfig] = None      # DESIGN.md §13
    tenancy: Optional[TenancyConfig] = None          # DESIGN.md §14
    sharding: Optional[ShardedCacheConfig] = None    # DESIGN.md §11
    persistence: Optional[PersistenceConfig] = None  # DESIGN.md §12
    replication: Optional[ReplicationConfig] = None  # DESIGN.md §16
    slo_latency: float = 1.0
    llm_latency: float = 0.5

    def to_siso_config(self) -> SISOConfig:
        """Lower to the flat ``SISOConfig``. Pure field plumbing, so
        new-style construction is bit-identical to old-style by
        construction."""
        c, r = self.cache, self.refresh
        return SISOConfig(
            dim=c.dim,
            answer_dim=c.dim if c.answer_dim is None else c.answer_dim,
            capacity=c.capacity,
            theta_c=c.theta_c,
            theta_r=c.theta_r,
            dynamic_threshold=c.dynamic_threshold,
            backend=c.backend,
            spill_lru=c.spill_lru,
            rescore_k=c.rescore_k,
            repeat_sim=c.repeat_sim,
            repeat_window=c.repeat_window,
            t2h_sample_frac=r.t2h_sample_frac,
            refresh_frac=r.frac,
            refresh_min=r.min,
            refresh_async=r.async_pipeline,
            refresh_budget_s=r.budget_s,
            shard=self.sharding,
            tiered=self.tiering,
            tenancy=self.tenancy,
        )

    @classmethod
    def from_siso_config(cls, cfg: SISOConfig, slo_latency: float = 1.0,
                         llm_latency: float = 0.5) -> "ServingConfig":
        """Raise a flat config into the nested form."""
        return cls(
            cache=CacheConfig(
                dim=cfg.dim, answer_dim=cfg.answer_dim,
                capacity=cfg.capacity, backend=cfg.backend,
                spill_lru=cfg.spill_lru, rescore_k=cfg.rescore_k,
                theta_c=cfg.theta_c, theta_r=cfg.theta_r,
                dynamic_threshold=cfg.dynamic_threshold,
                repeat_sim=cfg.repeat_sim,
                repeat_window=cfg.repeat_window),
            refresh=RefreshConfig(
                frac=cfg.refresh_frac, min=cfg.refresh_min,
                async_pipeline=cfg.refresh_async,
                budget_s=cfg.refresh_budget_s,
                t2h_sample_frac=cfg.t2h_sample_frac),
            tiering=cfg.tiered, tenancy=cfg.tenancy, sharding=cfg.shard,
            slo_latency=slo_latency, llm_latency=llm_latency)


__all__ = ["CacheConfig", "RefreshConfig", "PersistenceConfig",
           "ReplicationConfig", "TransportConfig", "ServingConfig"]
