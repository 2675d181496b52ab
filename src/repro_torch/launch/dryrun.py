"""Dry-run of every (arch x shape x mesh) cell on the meta device (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step against shape-only
inputs and reads the compiled program's memory analysis, its
trip-count-aware HLO cost and its collectives. The port has no compiler
to ask: it runs each cell's step on ``meta`` tensors (``step_cost.trace``),
where nothing is allocated or computed and each kernel wrapper takes its
shape-only op, and reads from the trace the FLOPs by op, the op-boundary
bytes and the peak of live bytes; the collectives come from the sharded
step's plan. No cell touches CUDA: the tool runs on a machine with no GPU.

What is traced is what the port's step does, not the reference's:

* A train cell runs the sharded train step (``distributed/
  sharded_train.py``) over the mesh, whose devices are all ``meta``. The
  step gives every data rank the same work on its own rows of the batch
  (``ShardedTrainStep.rank_grads``): each rank gathers the whole weights
  onto its device, "model" axis included, and runs the loss and the
  gradient of the one-device step. So one data rank is traced: a
  device's FLOPs are that rank's whole step, and its live bytes hold its
  blocks of the params, moments and batch, a gathered copy of every
  weight, the activations and the whole gradient. After the backward the
  rank's part of the ring (``step_cost.ring_phase_peak``) and the AdamW
  update of the blocks (traced) follow. On one data rank, or with
  ``whole_step``, the whole step is traced instead, every rank on the one
  meta device: what a mesh of virtual devices on one card holds.
* With no mesh, a train cell runs ``steps.make_train_step`` on one
  device, as the trainer's one-device runs do.
* A serving cell (prefill, decode) runs the one-device step on whole
  inputs (``steps.cell_shardings`` gives it beside the reference's
  placements), so its FLOPs and live bytes are one device's, whatever the
  mesh; its argument bytes per device are the placements' blocks.

The record keeps the reference's keys where they mean something here;
``lower_s``/``compile_s`` become ``trace_s``, ``xla_*_single_trip`` and
``hlo_ops`` are dropped (no HLO), and ``flops_by_op`` is added. The
reference's ``--keep-hlo`` has no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch qwen3-14b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both   # all cells
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, \
    ShapeConfig, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline as R
from repro_torch.launch import step_cost as SC
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training import optimizer as opt

META = torch.device("meta")


def meta_mesh(multi_pod: bool = False):
    """The production mesh over meta devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[META] * n)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in SC._tensors(tree))


def _train_one_device(cfg, shape, policy, specs):
    """``make_train_step`` on one device: (trace, argument bytes,
    collectives, computing devices)."""
    if not policy.remat:
        cfg = cfg.replace(remat=False)
    step = S.make_train_step(
        cfg, accum=policy.accum, ce_chunk=policy.ce_chunk,
        optc=opt.AdamWConfig(moment_dtype=policy.moment_dtype))
    args = (specs["params"], specs["opt_state"], specs["batch"])
    tr = SC.trace(step, *args)
    return tr, tr.args_bytes, SC.Collectives(), 1


def _train_sharded(cfg, shape, mesh, policy, specs, whole_step: bool):
    """The sharded train step over ``mesh``: (trace of one data rank, or
    of the whole step; the device's argument bytes; its collectives; the
    computing devices)."""
    from repro_torch.distributed import sharded_train as ST
    step, in_sh, _, _ = S.cell_shardings(cfg.name, shape.name, mesh,
                                         policy, cfg=cfg, shape=shape)
    params = shd.place_tree(specs["params"], in_sh["params"])
    state = ST.init_placed_state(params, policy.moment_dtype)
    batch = {k: shd.device_put(v, in_sh["batch"][k])
             for k, v in specs["batch"].items()}
    n = len(step.ranks)
    ST._check_moe(step.cfg, n)
    coll = SC.sharded_step_collectives(step, params, batch)
    blocks = [b for x in SC.placed_leaves((params, state, batch))
              for b in x.blocks.values()]
    if whole_step or n == 1:
        tr = SC.trace(step, params, state, batch, seen=blocks)
        return tr, tr.args_bytes, coll, n
    args_dev = SC.device_bytes((params, state.m, state.v, batch))
    tr = SC.trace(step.rank_grads, params, batch, 0, seen=blocks,
                  base=args_dev)
    loss, grads = tr.out
    peak, live = SC.ring_phase_peak(grads, n, tr.end_bytes)
    del grads, tr.out
    up = SC.update_transient(step, params, state)
    tr.peak_bytes = max(tr.peak_bytes, peak, live + up)
    return tr, args_dev, coll, n


def _serve(cfg, shape, mesh, policy, specs):
    """The one-device serving step on whole inputs: (trace, the argument
    bytes a device holds under the reference's placements, no
    collectives, one computing device)."""
    step, in_sh, _, _ = S.cell_shardings(cfg.name, shape.name, mesh,
                                         policy, cfg=cfg, shape=shape)
    names = list(specs)
    tr = SC.trace(step, *[specs[a] for a in names])
    per_dev = sum(SC.spec_bytes(specs[a], in_sh[a]) for a in names)
    return tr, per_dev, SC.Collectives(), 1


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             policy: Optional[S.CellPolicy] = None, *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             whole_step: bool = False) -> dict:
    """One cell's record: skipped with the reference's reason, ``ok`` with
    its trace's figures and roofline, or ``error`` with the exception.
    ``cfg``/``shape`` replace the registry's (a cut configuration, a
    shape of one's own); ``mesh`` None runs a train cell's one-device
    step; ``whole_step`` traces every data rank (module docstring)."""
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = S.skip_reason(arch, shape_name) if shape is None else None
    if reason:
        rec.update(status="skip", reason=reason)
        return rec
    t0 = time.time()
    try:
        cfg = cfg or get_config(arch)
        shape = shape or SHAPES[shape_name]
        if policy is None:
            policy = S.cell_policy(arch, shape_name) if shape_name in SHAPES \
                else S.CellPolicy()
        specs = S.input_specs(arch, shape_name, policy, cfg=cfg,
                              shape=shape)
        if shape.kind == "train" and mesh is None:
            tr, args_dev, coll, n_work = _train_one_device(cfg, shape,
                                                           policy, specs)
        elif shape.kind == "train":
            tr, args_dev, coll, n_work = _train_sharded(
                cfg, shape, mesh, policy, specs, whole_step)
        else:
            tr, args_dev, coll, n_work = _serve(cfg, shape, mesh, policy,
                                                specs)
        t_trace = time.time() - t0
        mf = R.model_flops(cfg, shape)
        mb = float(_tree_bytes(specs["params"])
                   + _tree_bytes(specs.get("cache", ())))
        n_dev = 1 if mesh is None else int(mesh.devices.size)
        rec.update(
            status="ok",
            trace_s=round(t_trace, 2),
            flops_per_device=tr.flops,
            flops_by_op=tr.flops_by_op,
            bytes_per_device=tr.dot_bytes,   # fused lower bound
            bytes_unfused_per_device=tr.bytes,
            argument_bytes_per_device=int(args_dev),
            live_bytes_per_device=int(tr.peak_bytes),
            collective_bytes=coll.total,
            collective_by_op=dict(coll.wire),
            collective_counts=dict(coll.count),
            model_flops_total=mf,
            model_bytes_total=mb,
            n_devices=n_dev,
            computing_devices=n_work,
            active_params=int(cfg.active_params),
            total_params=int(cfg.total_params),
        )
        roof = R.Roofline(arch, shape_name, mesh_name, tr.flops,
                          tr.dot_bytes, coll.total, mf, n_work,
                          peak_memory_bytes=tr.peak_bytes,
                          model_bytes_total=mb)
        rec["roofline"] = roof.to_dict()
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc(limit=8))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the tuned policies (steps.OPTIMIZED)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    wanted = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    n_err = 0
    for mesh_name in wanted:
        mesh = meta_mesh(multi_pod=mesh_name == "multi")
        for arch in args.arch:
            for shape_name in args.shape:
                pol = (S.optimized_policy(arch, shape_name)
                       if args.optimized else None)
                rec = run_cell(arch, shape_name, mesh, mesh_name,
                               policy=pol)
                tag = f"{arch}|{shape_name}|{mesh_name}"
                path = os.path.join(
                    args.out, f"{arch}_{shape_name}_{mesh_name}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    if not args.quiet:
                        print(f"OK    {tag:44s} trace={rec['trace_s']:7.1f}s "
                              f"mem={rec['live_bytes_per_device']/2**30:8.2f}GiB "
                              f"tc={r['t_compute']:.2e} tm={r['t_memory']:.2e} "
                              f"tx={r['t_collective']:.2e} -> {r['bottleneck']}",
                              flush=True)
                elif rec["status"] == "skip":
                    if not args.quiet:
                        print(f"SKIP  {tag:44s} {rec['reason']}", flush=True)
                else:
                    n_err += 1
                    print(f"ERROR {tag:44s} {rec['error']}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
