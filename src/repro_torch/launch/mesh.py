"""Meshes of torch devices (port of ``repro/launch/mesh.py``, DESIGN.md §6,
§11).

The reference builds jax ``Mesh``es and leaves the device work to GSPMD
and ``shard_map``. The port's planes are driven by one process over an
n-dimensional grid of torch devices: :class:`Mesh` for the training
plane (``("data", "model")``, with ``"pod"`` in front on the multi-pod
mesh, or ``("stage",)`` for the pipeline), :class:`CacheMesh` for the
sharded cache plane. A device may appear more than once: ``[d] * N``
gives N *virtual devices* on one device, the port's counterpart of the
reference's forced host devices
(``--xla_force_host_platform_device_count``). Nothing here uses
``torch.distributed``.

Functions, not constants: importing this module touches no device state.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An n-dimensional grid of torch devices with named axes, as jax's
    ``Mesh``: ``devices`` is a numpy object array, ``shape`` maps each
    axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs as many "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def device(self, **coords) -> torch.device:
        """The device at the named coordinates, 0 on every axis not named."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = list(dict.fromkeys(self.devices.flat))   # each once
        return f"Mesh({shape}; devices {devices})"


def _visible_cuda() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: over the visible CUDA devices, raising when fewer are
    visible, or over ``devices`` as given (repeats allowed)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = _visible_cuda() if devices is None else list(devices)
    if len(devs) < n:
        raise ValueError(f"the production mesh {shape} needs {n} devices, "
                         f"{len(devs)} given or visible; pass devices= for "
                         f"virtual ones")
    return Mesh(np.asarray(devs[:n], dtype=object).reshape(shape), axes)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh for tests, examples and the trainer. With no
    ``devices``, the visible CUDA devices with the reference's clamp (one
    card gives (1, 1) whatever is asked); an explicit list is used as
    given, repeats allowed, under the same clamp to its length."""
    devs = _visible_cuda() if devices is None else list(devices)
    n = len(devs)
    if n == 0:
        raise ValueError("no CUDA device visible; pass devices= (CPU "
                         "devices run the plain versions)")
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    grid = np.asarray(devs[:data * model], dtype=object)
    return Mesh(grid.reshape(data, model), ("data", "model"))


@dataclass(frozen=True)
class CacheMesh:
    """A one-axis ``("cache",)`` mesh: shard ``s`` lives on ``devices[s]``;
    the cross-shard merge runs on ``devices[0]``."""
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
