"""Pipeline parallelism on the GPipe schedule (port of
``repro/distributed/pipeline.py``).

Stages hold contiguous layer spans, one stage a device along the mesh's
``axis``; the microbatches flow through them so that at step t stage s
runs microbatch t - s, and the bubble is the standard (S-1)/(M+S-1). The
reference runs the schedule as a ``lax.scan`` inside ``shard_map`` with a
``ppermute`` hop; the port drives it from one process, and a hop copies a
stage's output to the next stage's device (``_hop``).

Unlike the reference, which computes every (step, stage) slot and masks
the dead ones, a dead slot runs nothing here.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _hop(y: torch.Tensor, device) -> torch.Tensor:
    """A stage's output copied to the next stage's device."""
    return y.to(device)


def _downstream(stage: int, microbatch: int) -> int:
    """The stage a stage's output for ``microbatch`` goes to."""
    return stage + 1


def stage_devices(mesh, axis: str = "stage") -> list:
    """The device of each stage: the mesh's devices along ``axis``, at
    index 0 of every other axis."""
    n = mesh.shape[axis]
    return [mesh.device(**{axis: s}) for s in range(n)]


def pipeline_forward(stage_fn: Callable, stage_params: Sequence, x, *,
                     mesh, axis: str = "stage",
                     n_microbatches: int = 4) -> torch.Tensor:
    """Run x through S pipeline stages along the mesh's ``axis``.

    stage_fn(stage_params, x_micro) -> x_micro: one stage's layers.
    stage_params: one tree a stage, ``stage_params[s]`` on stage s's
    device. x: (B, ...) global batch; B %
    n_microbatches == 0.

    GPipe: M + S - 1 steps; at step t stage s runs microbatch t - s when
    0 <= t - s < M. Stage 0 takes the microbatch from x, each stage sends
    its output downstream, and the last stage's outputs come back in
    microbatch order, on x's device."""
    devs = stage_devices(mesh, axis)
    S, B, M = len(devs), x.shape[0], n_microbatches
    if len(stage_params) != S:
        raise ValueError(f"{len(stage_params)} stage params for {S} stages")
    assert B % M == 0
    micro = x.reshape(M, B // M, *x.shape[1:])
    inbox: list = [dict() for _ in range(S)]      # stage -> {mb: tensor}
    outs: dict = {}
    for t in range(M + S - 1):
        sent: list = []
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue                          # a dead slot
            feed = micro[mb].to(devs[0]) if s == 0 else inbox[s].pop(mb, None)
            if feed is None:
                continue                          # nothing arrived
            y = stage_fn(stage_params[s], feed)
            if s == S - 1:
                outs[mb] = y
            else:
                dst = _downstream(s, mb)
                if dst >= S:
                    outs[mb] = y
                else:
                    sent.append((dst, mb, _hop(y, devs[dst])))
        for dst, mb, y in sent:                   # delivered for step t + 1
            inbox[dst][mb] = y
    missing = [mb for mb in range(M) if mb not in outs]
    if missing:
        raise RuntimeError(f"pipeline: microbatches {missing} never left "
                           f"the last stage")
    return torch.cat([outs[mb].to(x.device) for mb in range(M)])


def stage_spans(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) layer spans, remainder to early stages."""
    base, rem = divmod(n_layers, n_stages)
    spans, s = [], 0
    for i in range(n_stages):
        e = s + base + (1 if i < rem else 0)
        spans.append((s, e))
        s = e
    return spans


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
