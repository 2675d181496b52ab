"""Runnable trainer (port of ``repro/launch/train.py``): any ``--arch``,
reduced or at full width, on a (data, model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --reduced --steps 20 --batch 8 --seq 128 [--device cpu] \\
        [--data 2 --model 1] [--ckpt-dir DIR --ckpt-every N [--resume]]

The loop: a synthetic batch, the sharded train step
(``distributed.sharded_train``: each data rank's forward, chunked
cross-entropy and backward on its rows, the ring all-reduce, AdamW on
each placed block), the metrics line, a checkpoint every
``--ckpt-every`` steps through ``checkpoint.CheckpointManager`` (params,
moments and the step, the reference's layout), ``--resume`` from the
newest one. The mesh is ``make_host_mesh(--data, --model)``: on ``cuda``
(the default: K4 forward and its backward kernels for every attention
kind, K5 with its backward kernel for rwkv6) over the visible cards, with
the reference's clamp, so one card gives (1, 1); on ``cpu`` (the plain
versions) over data x model virtual CPU devices. On a (1, 1) mesh the
step is ``make_train_step``'s, bit for bit. An MoE model's step on more
than one data rank raises unless its ``moe_impl`` is ``"shard_map"``
(``distributed/sharded_train.py``). ``--grad-compression`` is parsed and
unused, as in the reference.

Unlike the reference, whose batch stream restarts from the seed on a
resume, step s draws its batch from ``default_rng((seed, s))``, so a
resumed run continues the uninterrupted one exactly. A reduced model's
default learning rate is 3e-3, the reference's tiny-train test's
(``tests/test_models.py:115``): at the full models' 3e-4, ten steps move
the loss less than the batch-to-batch noise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import sharded_train as st
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.training import optimizer as opt


def synth_batch(cfg, rng, batch: int, seq: int, device=None) -> dict:
    """Token stream with learnable structure (bigram-ish chains) so the loss
    visibly decreases: a stand-in for the real data pipeline."""
    V = cfg.vocab_size
    starts = rng.integers(0, V, size=(batch, 1))
    steps = rng.integers(1, 7, size=(batch, seq))
    toks = (starts + np.cumsum(steps, axis=1) - steps) % V
    out = {"tokens": toks.astype(np.int32),
           "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embed"] = rng.normal(
            size=(batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(
            size=(batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns {"losses": the per-step losses of
    this run, "params", "state"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 3e-4, or 3e-3 with --reduced")
    ap.add_argument("--data", type=int, default=1, help="data-mesh size")
    ap.add_argument("--model", type=int, default=1, help="model-mesh size")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_host_mesh(args.data, args.model, devices=None
                          if dev.type == "cuda" else
                          [dev] * (args.data * args.model))
    print(f"mesh: {mesh}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(remat=False).reduced()
    lr = args.lr if args.lr is not None else 3e-3 if args.reduced else 3e-4
    optc = opt.AdamWConfig(lr=lr, total_steps=max(args.steps, 2),
                           warmup_steps=max(2, args.steps // 10))
    fsdp = mesh.shape["data"] > 1
    place = lambda tree: st.place_params(tree, cfg, mesh, fsdp=fsdp)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    if ckpt and args.resume and ckpt.all_steps():
        start_step, rec = ckpt.restore_latest()
        params = place(rec["params"])
        state = opt.AdamWState(int(rec["meta"]["step"]),
                               place(rec["opt_m"]), place(rec["opt_v"]))
        print(f"resumed from step {start_step}")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = place(lm.init_params(gen, cfg, dev))
        state = st.init_placed_state(params)

    step_fn = st.make_sharded_train_step(cfg, mesh, accum=args.accum,
                                         optc=optc,
                                         ce_chunk=min(512, args.seq))
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = st.place_batch(synth_batch(
            cfg, np.random.default_rng((args.seed, step)), args.batch,
            args.seq, dev), cfg, mesh)
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {step:4d} loss={loss:8.4f} "
              f"gnorm={float(metrics['grad_norm']):7.3f} "
              f"lr={float(metrics['lr']):.2e} "
              f"dt={time.perf_counter() - t0:6.2f}s", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {
                "params": shd.gather_tree(params),
                "opt_m": shd.gather_tree(state.m),
                "opt_v": shd.gather_tree(state.v),
                "meta": {"step": np.asarray(state.step)}})
    if len(losses) >= 5:
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'DECREASED' if last < first else 'no decrease'})")
    if ckpt:
        ckpt.wait()
    params, state = st.gather_state(params, state)
    return {"losses": losses, "params": params, "state": state}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
