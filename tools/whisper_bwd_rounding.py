"""whisper-base's training step with the bf16 attention backward's rounding
emulated, on the CPU: how far each gradient leaf moves from the same step
with the plain attention, as ``chip_smoke.py``'s phase 13 (b) holds it.

whisper-base at full width and depth (6 + 6 layers, d_model 512, 8 heads
of 64, 1,500 stub frames), bf16 parameters from ``--seed``, takes
``launch.steps.chunked_ce_loss`` and its gradient on one seeded batch of B
1 x ``--seq`` decoder tokens: once with every attention call plain (the
port's CPU route, ``flash_attention_plain`` under autograd), and once for
each of ``--modes`` with an attention whose forward is the plain one and
whose backward is the recurrence of ``ref.attention_bwd_ref`` with D and
the bf16 operands of the card's kernels chosen so:

* ``o``: D = rowsum(do . o) from the bf16 output, the rest in f32;
* ``pdp``: D = rowsum(P dP) in f32 (``attention_bwd_ref``'s bf16 route);
* ``kernel-o``: ``o`` with dS and P rounded to bf16 before the products,
  as the wgmma kernels take them (the bf16 pair as it was);
* ``kernel``: ``pdp`` with the same rounding (the bf16 pair with pass 1
  summing D).

For each mode it prints the loss, the leaves farthest from the plain
step (the difference over the plain leaf's largest |gradient|), and the
cross-attention key biases, whose exact gradient is 0: the largest
|gradient| with this backward and with the plain one, over the tree's
largest |gradient|. About 4 GB and a minute a mode at 4,096 tokens:

    PYTHONPATH=src python tools/whisper_bwd_rounding.py --seq 4096
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import steps
from repro_torch.launch.train import synth_batch
from repro_torch.models import layers as L, lm
from repro_torch.training import optimizer as opt

MODES = ("o", "pdp", "kernel-o", "kernel")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class EmulatedFn(torch.autograd.Function):
    """The plain attention forward; the backward's recurrence in ``mode``."""

    mode = "kernel"

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out = ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                p_dtype=v.dtype)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        # D from the f32 view of o: rowsum(do . o); replaced below
        p, dp, dsum, qf, dof, scale = ref._bwd_terms(
            q, k, v, o.float(), do, ctx.causal, None, 0, ctx.q_offset)
        mode = EmulatedFn.mode
        if mode in ("pdp", "kernel"):
            dsum = (p * dp).sum(dim=-1, keepdim=True)
        ds = p * (dp - dsum)
        if mode.startswith("kernel"):
            ds, p = _bf16(ds), _bf16(p)
        dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
        dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
        dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None)


def emulated_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                       q_offset=0, kv_valid_len=None):
    if window is not None or prefix_len or kv_valid_len is not None:
        raise ValueError("whisper-base's attention has no window, prefix "
                         "or ragged keys")
    return EmulatedFn.apply(q, k, v, causal, q_offset)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=448)
    ap.add_argument("--seed", type=int, default=400)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()
    cfg = get_config("whisper-base")
    params = lm.init_params(torch.Generator().manual_seed(args.seed), cfg,
                            "cpu")
    batch = synth_batch(cfg, np.random.default_rng(args.seed + 1), 1,
                        args.seq, "cpu")

    def grads():
        return steps.value_and_grad(lambda p: steps.chunked_ce_loss(
            p, cfg, batch, 512)[0], params)
    t0 = time.perf_counter()
    loss_p, g_p = grads()
    leaves_p = list(opt.tree_leaves(g_p))
    tree = max(float(b.abs().max()) for _, b in leaves_p)
    print(f"whisper-base, B 1 x {args.seq}: plain loss {float(loss_p):.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    plain = L.flash_attention
    for mode in args.modes.split(","):
        EmulatedFn.mode = mode
        L.flash_attention = emulated_attention
        try:
            loss_k, g_k = grads()
        finally:
            L.flash_attention = plain
        rows, zero = [], []
        for (path, a), (_, b) in zip(opt.tree_leaves(g_k), leaves_p):
            name = "/".join(map(str, path))
            top = float(b.abs().max())
            if name.endswith("xattn/bk"):
                zero.append(f"{name} {float(a.abs().max()) / tree:.3g} vs "
                            f"{top / tree:.3g}")
                continue
            rows.append((float((a.float() - b.float()).abs().max()) / top,
                         name))
        rows.sort(reverse=True)
        print(f"{mode}: loss {float(loss_k):.6f}; farthest leaves " + ", ".join(
            f"{n} {r:.4g}" for r, n in rows[:args.top]), flush=True)
        print(f"{mode}: cross-attention key biases over the tree's largest "
              f"|gradient| (this backward vs plain): " + "; ".join(zero),
              flush=True)


if __name__ == "__main__":
    main()
