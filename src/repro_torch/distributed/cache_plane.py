"""Sharded cache plane (port of ``repro/distributed/cache_plane.py``,
DESIGN.md §11): configuration only.

The plane itself (``ShardedDeviceState``, ``ShardedQuantState``, the
cross-shard top-1) comes with ROADMAP Queue A item 5, on
``torch.distributed``. Until then this module holds what
``serving/config.py`` nests: :class:`ShardedCacheConfig`. ``n_shards=1``
is the single-device path, as in the reference; ``n_shards > 1`` raises
``NotImplementedError``. The reference's ``mesh`` field (a jax ``Mesh``)
has no counterpart until the plane is ported.
"""
from __future__ import annotations

from dataclasses import dataclass

SHARD_PAD_FLOOR = 32


@dataclass
class ShardedCacheConfig:
    """``n_shards=1`` keeps the single-device hot path (bit-identical to
    an unsharded cache)."""
    n_shards: int = 1
    pad_floor: int = SHARD_PAD_FLOOR
