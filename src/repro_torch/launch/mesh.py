"""Device lists for the sharded cache plane (port of ``make_cache_mesh`` in
``repro/launch/mesh.py``, DESIGN.md §11).

The reference builds a one-axis jax ``Mesh`` and fans the plane's device
work out with ``shard_map``. The port's plane is driven by one process (the
one that runs the cache's host bookkeeping) over a list of torch devices:
shard ``s`` keeps its blocks on ``devices[s]``, and the cross-shard merge
runs on ``devices[0]``. A device may appear more than once: ``[d] * S``
gives S *virtual shards* on one device, the port's counterpart of the
reference's forced host devices (``--xla_force_host_platform_device_count``).

A function, not a constant: importing this module touches no device state.
The compute meshes (``make_production_mesh``, ``make_host_mesh``) come with
training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class CacheMesh:
    """A one-axis ``("cache",)`` mesh: shard ``s`` lives on ``devices[s]``."""
    devices: tuple
    axis_names: tuple = ("cache",)

    @property
    def lead(self) -> torch.device:
        """Where the shards' candidates are gathered and merged."""
        return self.devices[0]


def make_cache_mesh(n_shards: int = 1,
                    devices: Optional[Sequence] = None) -> CacheMesh:
    """One-axis mesh for the sharded cache plane. By default the first
    ``n_shards`` CUDA devices, raising when fewer are visible; ``devices``
    names them explicitly, repeats allowed."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_shards > n:
            raise ValueError(
                f"cache mesh needs {n_shards} CUDA devices, only {n} "
                f"visible; pass devices=[torch.device('cuda:0')] * "
                f"{n_shards} for {n_shards} virtual shards on one card (or "
                f"CPU devices for the plain versions)")
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"cache mesh of {n_shards} shards got "
                         f"{len(devices)} devices")
    return CacheMesh(devices)
