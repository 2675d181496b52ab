"""One cell's cost, traced on the meta device (the port's counterpart of
``repro/launch/hlo_cost.py``).

The reference compiles a step and re-derives its cost from the HLO text
(``HloCostModel``): FLOPs with loop trip counts, op-boundary bytes,
collectives. The port's step is eager torch, so it is traced instead:
run on ``meta`` tensors, where every op gives its output's shape and
dtype and allocates nothing, and every kernel wrapper takes its shape-only
op (``kernels.meta``). Under the trace:

* ``torch.utils.flop_counter.FlopCounterMode`` counts FLOPs by op: the
  matmuls' 2 x M x N x K, and each kernel's own products by the formula
  registered with its meta op (attention only over the pairs its mask
  lets through). Elementwise ops count nothing, as in the reference.
* ``CostMode`` keeps the live bytes: each storage an op makes is counted
  from its first output until it is freed, on top of the arguments'
  bytes, and the largest sum is the trace's peak. It also sums the bytes
  at op boundaries, every non-view op's inputs and outputs (``bytes``,
  the unfused upper bound) and the matmuls' and kernels' alone
  (``dot_bytes``, the fused lower bound), the reference's two measures.

A sharded train step's collectives are not traced: the step runs on one
process, and its hops are copies. They come from the step's own plan
(``distributed/sharded_train.py``), by ``roofline.wire_bytes``: each data
rank gathers every weight leaf from its blocks (an all-gather over the
leaf's blocks), the ranks' f32 gradients go round
``ring_allreduce_schedule`` (an all-reduce over the data ranks), and a
microbatch's rows that another rank's block holds are fetched from it (a
permute).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import sharding as shd
from repro_torch.launch.roofline import wire_bytes
from repro_torch.training import optimizer as opt

_aten = torch.ops.aten
# the ops whose operands a fused kernel streams from memory: the matmuls,
# and the kernels' meta routes (``kernels.meta``)
_DOT_OPS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
            _aten.convolution}
_KERNEL_NS = "repro_torch"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Live storage bytes and op-boundary bytes of the ops run under it.
    ``seen`` storages (the arguments') are known from the start: ``base``
    bytes of them count as live, and an op that returns one of them (an
    in-place op, a view) makes nothing new."""

    def __init__(self, seen: Iterable[torch.Tensor] = (), base: int = 0):
        super().__init__()
        self.live = self.peak = int(base)
        self.bytes = 0.0
        self.dot_bytes = 0.0
        self._refs: dict = {}
        self._known = {t.untyped_storage()._cdata for t in seen}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs or key in self._known:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n, mode=weakref.ref(self)):
            m = mode()
            if m is not None and m._refs.pop(key, None) is not None:
                m.live -= n
        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in outs)
            self.bytes += b
            if func.overloadpacket in _DOT_OPS or \
                    func.namespace == _KERNEL_NS:
                self.dot_bytes += b
        for t in outs:
            self._track(t)
        return out


@dataclass
class Trace:
    """What one traced call cost (``trace``)."""
    flops: float
    flops_by_op: dict
    bytes: float
    dot_bytes: float
    args_bytes: int
    peak_bytes: int
    end_bytes: int           # live when the call returned, its outputs held
    out: Any = field(repr=False, default=None)


def _op_name(op) -> str:
    return str(op).replace("aten.", "") if str(op).startswith("aten.") \
        else str(op)


def trace(fn: Callable, *args, seen: Iterable[torch.Tensor] = (),
          base: int | None = None) -> Trace:
    """Run ``fn(*args)`` on meta tensors under ``FlopCounterMode`` and
    ``CostMode``. The live bytes start at ``base`` (default: every distinct
    storage among ``args`` and ``seen``, each once); the storages of
    ``args`` and ``seen`` are never counted again."""
    known = {}
    for t in _tensors(args) + list(seen):
        known.setdefault(t.untyped_storage()._cdata, t)
    if base is None:
        base = sum(t.untyped_storage().nbytes() for t in known.values())
    fc = FlopCounterMode(display=False)
    cm = CostMode(seen=known.values(), base=base)
    with fc, cm:
        out = fn(*args)
    end = cm.live
    counts = fc.get_flop_counts().get("Global", {})
    return Trace(flops=float(fc.get_total_flops()),
                 flops_by_op={_op_name(k): float(v)
                              for k, v in sorted(counts.items(),
                                                 key=lambda kv: -kv[1])},
                 bytes=cm.bytes, dot_bytes=cm.dot_bytes, args_bytes=base,
                 peak_bytes=cm.peak, end_bytes=end, out=out)


# ---------------------------------------------------------------------------
# placements: a device's argument bytes, the step's collectives
# ---------------------------------------------------------------------------


def _zero(mesh) -> dict:
    return {a: 0 for a in mesh.axis_names}


def block_bytes(x: shd.Placed, coord: dict | None = None) -> int:
    """Bytes of ``x``'s block at mesh coordinate ``coord`` (default 0 on
    every axis), from its block shape (``sharding.block_slices``)."""
    mesh = x.sharding.mesh
    sl = shd.block_slices(x.shape, mesh, x.sharding.spec,
                          coord or _zero(mesh))
    n = int(np.prod([s.stop - s.start for s in sl], dtype=np.int64))
    return n * torch.empty((), dtype=x.dtype, device="meta").element_size()


def device_bytes(tree, coord: dict | None = None) -> int:
    """The argument bytes one device holds: every placed leaf's block at
    ``coord``; a leaf that is not placed counts whole."""
    total = 0
    for t in tree_flatten(tree, is_leaf=lambda x: isinstance(
            x, shd.Placed))[0]:
        if isinstance(t, shd.Placed):
            total += block_bytes(t, coord)
        elif isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def placed_leaves(tree) -> list:
    """The ``Placed`` leaves of ``tree``."""
    return [x for x in tree_flatten(tree, is_leaf=lambda x: isinstance(
        x, shd.Placed))[0] if isinstance(x, shd.Placed)]


def spec_bytes(specs, shardings, coord: dict | None = None) -> int:
    """The bytes one device would hold of meta tensors ``specs`` placed by
    ``shardings`` (a tree like it, or one sharding), its block at
    ``coord``, with nothing placed."""
    total = 0

    def add(x, s):
        nonlocal total
        total += block_bytes(shd.Placed(s, x.shape, x.dtype, {}), coord)
    shd.tree_map(add, specs, shardings)
    return total


def update_transient(step, params, state: opt.AdamWState) -> int:
    """The live bytes AdamW's update of one block adds while it runs
    (``opt.update_leaf``; the blocks go one after another): the largest,
    traced on the first device's largest block, with its slice of the
    f32 mean gradient."""
    zero = _zero(step.mesh)
    best = None
    for (path, p), (_, m), (_, v) in zip(opt.tree_leaves(params),
                                         opt.tree_leaves(state.m),
                                         opt.tree_leaves(state.v)):
        n = block_bytes(p, zero)
        if best is None or n > best[0]:
            best = (n, path, p.block(), m.block(), v.block())
    if best is None:
        return 0
    _, path, pb, mb, vb = best
    gb = torch.empty(pb.shape, dtype=torch.float32, device=pb.device)
    gnorm = torch.ones((), dtype=torch.float32, device=pb.device)
    scalars = opt.update_scalars(step.optc, 1, gnorm)
    tr = trace(opt.update_leaf, path, pb, gb, mb, vb, scalars, step.optc,
               base=0)
    return tr.peak_bytes


def _n_blocks(x: shd.Placed) -> int:
    return len({sl for _, sl in x.blocks})


class Collectives:
    """Wire bytes and counts by collective op, for one device."""

    def __init__(self):
        self.wire: dict = {}
        self.count: dict = {}

    def add(self, op: str, size: float, g: int) -> None:
        if g <= 1 and op != "collective-permute":
            return
        self.wire[op] = self.wire.get(op, 0.0) + wire_bytes(op, size, g)
        self.count[op] = self.count.get(op, 0.0) + 1

    @property
    def total(self) -> float:
        return float(sum(self.wire.values()))


def _padded_numel(shape, world: int) -> int:
    """A leaf's elements with its leading dim padded to a multiple of the
    ring's world size (``ring_allreduce_schedule``)."""
    if not len(shape):
        return 1
    rows = shape[0] + (-shape[0]) % world
    return int(rows * np.prod(shape[1:], dtype=np.int64))


def sharded_step_collectives(step, params, batch: dict) -> Collectives:
    """The first data rank's collectives in one call of ``step`` (a
    ``ShardedTrainStep``) on placed ``params`` and ``batch``."""
    c = Collectives()
    n = len(step.ranks)
    for _, x in opt.tree_leaves(params):
        c.add("all-gather", _nbytes_placed(x), _n_blocks(x))
    for _, x in opt.tree_leaves(params):
        c.add("all-reduce", 4.0 * _padded_numel(x.shape, n), n)
    # rank 0's microbatch rows held by another data rank's block
    B = next(iter(batch.values())).shape[0]
    Bm = B // step.accum
    b = Bm // n
    for v in batch.values():
        own = shd.block_slices(v.shape, v.sharding.mesh, v.sharding.spec,
                               _zero(v.sharding.mesh))[0]
        row = _nbytes_placed(v) // max(v.shape[0], 1)
        for i in range(step.accum):
            lo, hi = i * Bm, i * Bm + b
            far = (hi - lo) - max(0, min(hi, own.stop) - max(lo, own.start))
            if far:
                c.add("collective-permute", far * row, 2)
    return c


def _nbytes_placed(x: shd.Placed) -> int:
    return int(np.prod(x.shape, dtype=np.int64)) * \
        torch.empty((), dtype=x.dtype, device="meta").element_size()


def ring_phase_peak(grads, n_ranks: int, live: int) -> tuple[int, int]:
    """(peak, live after) of one device through ``ShardedTrainStep.
    _mean_grads`` after its backward, leaf by leaf as the step goes, from
    ``live`` bytes with the device's whole gradient held (``grads``, one
    rank's tree): the leaf's f32 copy (none for an f32 leaf, which is its
    own copy), which frees the rank's leaf, then the ring's padded
    accumulator, whose view becomes the mean, and a received chunk with
    its sum; or, on one rank, the mean as a new f32 tensor. The copy goes
    when the mean is made. ``tests/test_torch_dryrun.py`` holds this
    against a count of device 0's bytes through the step itself."""
    peak = live
    for _, g in opt.tree_leaves(grads):
        n, gb = g.numel(), _nbytes(g)
        copy = 0 if g.dtype == torch.float32 else 4 * n
        held = live - (gb if copy else 0)
        if n_ranks == 1:
            peak = max(peak, held + copy + 4 * n)
            live += 4 * n - gb
        else:
            acc = 4 * _padded_numel(g.shape, n_ranks)
            peak = max(peak, held + copy + acc + 2 * acc // n_ranks)
            live += acc - gb
    return peak, live


__all__ = ["Collectives", "CostMode", "Trace", "block_bytes", "device_bytes",
           "placed_leaves", "ring_phase_peak", "sharded_step_collectives",
           "spec_bytes", "trace", "update_transient"]
