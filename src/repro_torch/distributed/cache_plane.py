"""Sharded device-resident cache plane (port of
``repro/distributed/cache_plane.py``, DESIGN.md §11).

The cache's centroid + spill mirror is split over S shards, so capacity
grows with the shard count instead of one device's memory. Lookups have no
cross-entry coupling: each shard runs the single-device top-1 on its own
rows, and only O(B x S) candidates cross to the merge
(:func:`~repro_torch.distributed.collectives.cross_shard_top1`).

Owner mapping: host row ``r`` (its index in the cache's [centroids; spill]
order) lives on shard ``r % S`` at local row ``r // S``. Appends never
remap a row, so a spill insert or an LRU victim patch is one in-place row
write on its owner shard, and the hot low rows (the locality-first layout)
stripe evenly over the shards.

One process drives the plane, as in the reference (whose ``shard_map``
runs under a single controller): it keeps the cache's host bookkeeping
and holds shard ``s``'s blocks on ``mesh.devices[s]``
(:mod:`repro_torch.launch.mesh`). Each shard holds ``pad`` rows
(pow2-padded per shard): ``mat (pad, dim) f32``, ``ans (pad, A) f32``,
``valid (pad,) bool``, ``aid (pad,) i32``; the int8 plane holds ``codes``,
``scales`` and ``valid``. The ``pallas`` backend runs K1's shard-local mode
(``cosine_top1_local``) on each block, ``dense`` the reference's masked
``q @ mat.T`` and argmax, ``pallas_q8`` K2's top-C candidates for the
cache's exact rescore. ``n_shards=1`` is the single-device path, bit for
bit: the cache then never builds a plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.collectives import cross_shard_top1
from repro_torch.kernels.cosine_topk import ops as ctk_ops
from repro_torch.kernels.cosine_topk.ops import quantize_rows
from repro_torch.launch.mesh import CacheMesh, make_cache_mesh

# per-shard pow2 pad floor: smaller than the single-device mirror's 128, so
# an 8-way split of a small cache does not inflate 8x
SHARD_PAD_FLOOR = 32


def _pow2_pad(n: int, floor: int) -> int:
    return max(floor, 1 << (n - 1).bit_length()) if n else floor


def owner_shard(row, n_shards: int):
    """Shard owning host row(s) ``row`` (round-robin)."""
    return row % n_shards


def shard_local_row(row, n_shards: int):
    """Local row of host row(s) ``row`` on its owner shard."""
    return row // n_shards


def shard_pad(n_rows: int, n_shards: int, floor: int = SHARD_PAD_FLOOR
              ) -> int:
    """Per-shard pow2 pad that fits ``n_rows`` total host rows."""
    return _pow2_pad(-(-n_rows // n_shards) if n_rows else 0, floor)


@dataclass
class ShardedCacheConfig:
    """Configuration of the sharded cache plane (DESIGN.md §11).

    ``n_shards=1`` keeps the single-device hot path. ``mesh`` places the
    shards (:func:`~repro_torch.launch.mesh.make_cache_mesh`); left unset,
    it is built on first use."""
    n_shards: int = 1
    mesh: Optional[CacheMesh] = None
    pad_floor: int = SHARD_PAD_FLOOR

    def make_mesh(self) -> CacheMesh:
        """The configured mesh; else the first ``n_shards`` CUDA devices
        (kept), raising when fewer are visible. Virtual shards, on the card
        or on the CPU, are a mesh passed in."""
        if self.mesh is None:
            self.mesh = make_cache_mesh(self.n_shards)
        return self.mesh


def _owner_layout(n: int, S: int, pad: int, cols: dict) -> dict:
    """Scatter host-row-order arrays into (S, pad, ...) owner layout;
    ``cols`` maps a name to (host rows, fill)."""
    rows = np.arange(n)
    s, l = rows % S, rows // S
    out = {}
    for key, (arr, fill) in cols.items():
        arr = np.asarray(arr)
        out[key] = np.full((S, pad) + arr.shape[1:], fill, arr.dtype)
        if n:
            out[key][s, l] = arr
    out["valid"] = np.zeros((S, pad), bool)
    out["valid"][s, l] = True
    return out


def _blocks(mesh: CacheMesh, arr: np.ndarray) -> list:
    """One upload per shard: block ``s`` of an (S, pad, ...) host array to
    ``mesh.devices[s]``."""
    return [torch.tensor(np.ascontiguousarray(arr[s]), device=dev)
            for s, dev in enumerate(mesh.devices)]


def _per_device(queries: np.ndarray, mesh: CacheMesh) -> list:
    """The queries on each shard's device, uploaded once per distinct
    device."""
    up: dict = {}
    return [up.setdefault(dev, torch.tensor(queries, device=dev))
            for dev in mesh.devices]


@dataclass
class ShardedDeviceState:
    """The sharded f32 mirror of the centroid + spill regions: the
    single-device mirror's ``write_row`` contract, plus a ``lookup`` that
    runs the shard-local top-1 and the cross-shard merge."""
    mat: list           # S blocks (pad, dim) float32
    ans: list           # S blocks (pad, answer_dim) float32
    valid: list         # S blocks (pad,) bool
    aid: list           # S blocks (pad,) int32
    pad: int            # rows per shard
    n_shards: int
    mesh: CacheMesh
    backend: str = "dense"

    @property
    def rows(self) -> int:
        """Total addressable host rows before the plane must regrow."""
        return self.pad * self.n_shards

    @classmethod
    def from_shard_layout(cls, mesh: CacheMesh, n_shards: int,
                          mat: np.ndarray, ans: np.ndarray,
                          valid: np.ndarray, aid: np.ndarray,
                          backend: str = "dense") -> "ShardedDeviceState":
        """Upload host staging already in (S, pad, ...) owner layout, one
        transfer per array and shard."""
        return cls(_blocks(mesh, mat), _blocks(mesh, ans),
                   _blocks(mesh, valid), _blocks(mesh, aid),
                   pad=mat.shape[1], n_shards=n_shards, mesh=mesh,
                   backend=backend)

    @classmethod
    def build(cls, mesh: CacheMesh, n_shards: int, vectors: np.ndarray,
              answers: np.ndarray, answer_id: np.ndarray,
              pad_floor: int = SHARD_PAD_FLOOR,
              backend: str = "dense") -> "ShardedDeviceState":
        """Scatter host rows (host-row order) into the owner layout and
        upload: the full rebuild path (online writes use ``write_row``)."""
        n = len(vectors)
        lay = _owner_layout(n, n_shards, shard_pad(n, n_shards, pad_floor),
                            {"mat": (np.asarray(vectors, np.float32), 0),
                             "ans": (np.asarray(answers, np.float32), 0),
                             "aid": (np.asarray(answer_id, np.int32), -1)})
        return cls.from_shard_layout(mesh, n_shards, lay["mat"], lay["ans"],
                                     lay["valid"], lay["aid"],
                                     backend=backend)

    def lookup(self, queries: np.ndarray, theta):
        """Batch top-1 over all shards: the shard-local top-1, then
        ``cross_shard_top1``. Returns tensors on the lead device: (hit,
        best sim, winning host row, answer, answer_id)."""
        S = self.n_shards
        best, host_row = [], []
        for s, q in enumerate(_per_device(queries, self.mesh)):
            if self.backend == "pallas":
                b, l = ctk_ops.cosine_top1_local(q, self.mat[s],
                                                 self.valid[s])
            else:   # the reference's masked product; invalid rows -1.0
                sims = q @ self.mat[s].T
                sims = torch.where(self.valid[s][None, :], sims,
                                   torch.full_like(sims, -1.0))
                l = torch.argmax(sims, dim=1)      # first max
                b = sims.gather(1, l[:, None])[:, 0]
            best.append(b)
            host_row.append(l.to(torch.int32) * S + s)    # globalize
        return cross_shard_top1(best, host_row, self.ans, self.aid, theta)

    def write_row(self, row: int, vec: np.ndarray, answer: np.ndarray,
                  answer_id: int) -> None:
        """In-place patch of host row ``row`` on its owner shard only."""
        s, l = row % self.n_shards, row // self.n_shards
        dev = self.mesh.devices[s]
        self.mat[s][l] = torch.tensor(np.asarray(vec, np.float32),
                                      device=dev)
        self.ans[s][l] = torch.tensor(np.asarray(answer, np.float32),
                                      device=dev)
        self.valid[s][l] = True
        self.aid[s][l] = int(answer_id)

    def layout_dict(self) -> dict:
        """Serializable layout descriptor (rides in snapshots, DESIGN.md
        §12). The mapping is a pure function of (row, n_shards), so a
        restore onto another shard count rebuilds an equivalent plane; the
        descriptor records the plane the snapshot served from."""
        return {"n_shards": np.asarray(self.n_shards),
                "rows": np.asarray(self.rows),
                "pad": np.asarray(self.pad)}

    def nbytes_per_shard(self) -> int:
        """Device bytes each shard holds (the capacity bench's proxy for
        memory per device)."""
        per_row = (4 * self.mat[0].shape[1] + 4 * self.ans[0].shape[1]
                   + self.valid[0].element_size()
                   + self.aid[0].element_size())
        return self.pad * per_row


@dataclass
class ShardedQuantState:
    """The sharded int8 mirror (backend "pallas_q8", DESIGN.md §15): the
    same owner mapping, codes + per-row scales only (answers stay on the
    host). A lookup returns each shard's top-C candidates; the exact
    margin rescore is the cache's, shared with the single-device path."""
    codes: list         # S blocks (pad, dpad) int8
    scales: list        # S blocks (pad,) float32
    valid: list         # S blocks (pad,) bool
    pad: int            # rows per shard
    n_shards: int
    mesh: CacheMesh
    err_max: float      # running max per-row dequant L2 error

    @property
    def rows(self) -> int:
        return self.pad * self.n_shards

    @property
    def dpad(self) -> int:
        return self.codes[0].shape[1]

    @classmethod
    def from_shard_layout(cls, mesh: CacheMesh, n_shards: int,
                          codes: np.ndarray, scales: np.ndarray,
                          valid: np.ndarray, err_max: float
                          ) -> "ShardedQuantState":
        """Upload host staging already in (S, pad, ...) owner layout."""
        return cls(_blocks(mesh, codes), _blocks(mesh, scales),
                   _blocks(mesh, valid), pad=codes.shape[1],
                   n_shards=n_shards, mesh=mesh, err_max=float(err_max))

    @classmethod
    def build(cls, mesh: CacheMesh, n_shards: int, codes: np.ndarray,
              scales: np.ndarray, err_max: float,
              pad_floor: int = 128) -> "ShardedQuantState":
        """Scatter quantized host rows into the owner layout and upload;
        the pad floor is >= 128, so each block is kernel-tile shaped."""
        n = len(codes)
        lay = _owner_layout(n, n_shards, shard_pad(n, n_shards, pad_floor),
                            {"codes": (np.asarray(codes, np.int8), 0),
                             "scales": (np.asarray(scales, np.float32), 0)})
        return cls.from_shard_layout(mesh, n_shards, lay["codes"],
                                     lay["scales"], lay["valid"], err_max)

    def candidates(self, queries: np.ndarray, k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """K2's top-k per (query, shard), early exit off: ((B, S, k) quant
        sims f32, (B, S, k) host rows i32, -1 for exhausted slots)."""
        S = self.n_shards
        sims, rows = [], []
        for s, q in enumerate(_per_device(queries, self.mesh)):
            v, i = ctk_ops.cosine_topk_q8(q, self.codes[s], self.scales[s],
                                          k=k, valid=self.valid[s],
                                          early_exit=False)
            sims.append(v.to(self.mesh.lead))
            rows.append(torch.where(i >= 0, i * S + s, i).to(self.mesh.lead))
        return (torch.stack(sims, dim=1).cpu().numpy(),
                torch.stack(rows, dim=1).cpu().numpy())

    def write_row(self, row: int, vec: np.ndarray, answer: np.ndarray,
                  answer_id: int) -> None:
        """In-place code-row + scale patch on the owner shard; the answer
        stays on the host."""
        crow, scale, err = quantize_rows(
            np.asarray(vec, np.float32).reshape(1, -1), width=self.dpad)
        s, l = row % self.n_shards, row // self.n_shards
        self.codes[s][l] = torch.tensor(crow[0],
                                        device=self.mesh.devices[s])
        self.scales[s][l] = float(scale[0])
        self.valid[s][l] = True
        self.err_max = max(self.err_max, float(err[0]))

    def layout_dict(self) -> dict:
        return {"n_shards": np.asarray(self.n_shards),
                "rows": np.asarray(self.rows),
                "pad": np.asarray(self.pad)}

    def nbytes_per_shard(self) -> int:
        per_row = (self.codes[0].shape[1] + 4
                   + self.valid[0].element_size())
        return self.pad * per_row


__all__ = ["SHARD_PAD_FLOOR", "ShardedCacheConfig", "ShardedDeviceState",
           "ShardedQuantState", "owner_shard", "shard_local_row",
           "shard_pad"]
