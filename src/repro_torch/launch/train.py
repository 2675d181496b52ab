"""Runnable trainer (port of ``repro/launch/train.py``): any ``--arch``,
reduced or at full width, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --reduced --steps 20 --batch 8 --seq 128 [--device cpu] \\
        [--ckpt-dir DIR --ckpt-every N [--resume]]

The loop: a synthetic batch, ``make_train_step`` (forward, chunked
cross-entropy, backward, AdamW), the metrics line, a checkpoint every
``--ckpt-every`` steps through ``checkpoint.CheckpointManager`` (params,
moments and the step, the reference's layout), ``--resume`` from the
newest one. It runs on ``--device`` (default ``cuda``: K4 forward and its
backward kernels, for every attention kind (the MLA pairs and head dims
up to 256 among them), and K5 with its backward kernel for rwkv6; ``cpu``
runs the plain versions). Every LM configuration trains on the card. ``--data``/``--model``
above 1 (meshes) raise until the parallel-training slice;
``--grad-compression`` is parsed and unused, as in the reference.

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
from repro_torch.launch.steps import make_train_step
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


def _to(tree, device):
    """A restored checkpoint tree (numpy arrays, CPU bf16 tensors) on
    ``device``."""
    return opt.tree_map(lambda x: torch.as_tensor(x).to(device), tree)


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
    if args.data > 1 or args.model > 1:
        raise NotImplementedError("--data/--model above 1 need the parallel "
                                  "training plane, which is not ported yet")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(remat=False).reduced()
    lr = args.lr if args.lr is not None else 3e-3 if args.reduced else 3e-4
    optc = opt.AdamWConfig(lr=lr, total_steps=max(args.steps, 2),
                           warmup_steps=max(2, args.steps // 10))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(gen, cfg, dev)
    state = opt.init_state(params)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    if ckpt and args.resume and ckpt.all_steps():
        start_step, rec = ckpt.restore_latest()
        params = _to(rec["params"], dev)
        state = opt.AdamWState(int(rec["meta"]["step"]),
                               _to(rec["opt_m"], dev), _to(rec["opt_v"], dev))
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, accum=args.accum, optc=optc,
                              ce_chunk=min(512, args.seq))
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = synth_batch(cfg, np.random.default_rng((args.seed, step)),
                            args.batch, args.seq, dev)
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {step:4d} loss={loss:8.4f} "
              f"gnorm={float(metrics['grad_norm']):7.3f} "
              f"lr={float(metrics['lr']):.2e} "
              f"dt={time.perf_counter() - t0:6.2f}s", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {
                "params": params, "opt_m": state.m, "opt_v": state.v,
                "meta": {"step": np.asarray(state.step)}})
    if len(losses) >= 5:
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'DECREASED' if last < first else 'no decrease'})")
    if ckpt:
        ckpt.wait()
    return {"losses": losses, "params": params, "state": state}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
