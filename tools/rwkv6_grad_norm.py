"""rwkv6-7b's gradient at full width in both packages, on the CPU.

One rwkv6-7b layer at the published widths (d_model 4,096, 64 heads of 64,
d_ff 14,336, vocab 65,536), f32, with the reference's parameters
(``repro.models.lm.init_params`` from ``--seed``) carried into the port by
``repro_torch.weights.convert_lm``, takes the chunked CE loss and its
gradient on one seeded sequence of ``--seq`` tokens in each package
(``jax.value_and_grad`` of ``repro.launch.steps.chunked_ce_loss``, and
``repro_torch.launch.steps.value_and_grad`` of the port's). It prints both
losses, both global gradient norms and their relative difference, the
largest leaf difference (over that leaf's largest |gradient|) and the
leaves that carry most of the norm. This settles whether a gradient norm
in the hundreds at full width is the reference's own or the port's.

The two packages hold about 12 GB of f32 between them (parameters and
gradients, about 0.75 B each), so this is no tier-1 test:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rwkv6_grad_norm.py
"""
from __future__ import annotations

import argparse
import gc
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch.steps import chunked_ce_loss as j_ce
from repro.models import lm as JLM
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.launch import steps
from repro_torch.training.optimizer import tree_leaves


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=64,
                    help="the CE chunk (tokens a chunk of the LM head)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    arch = "rwkv6-7b"
    cfg = get_config(arch).replace(n_layers=args.layers, dtype="float32")
    jcfg = j_get_config(arch).replace(n_layers=args.layers, dtype="float32")
    t0 = time.perf_counter()
    jp = JLM.init_params(jax.random.PRNGKey(args.seed), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    n = sum(x.numel() for _, x in tree_leaves(tp))
    print(f"{arch} x {args.layers} layer(s) at full width: {n / 1e9:.3f} B "
          f"params, f32 ({time.perf_counter() - t0:.1f} s to build)",
          flush=True)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab_size, (1, args.seq)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    t0 = time.perf_counter()
    (jloss, _), jg = jax.value_and_grad(
        lambda p: j_ce(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                       args.chunk), has_aux=True)(jp)
    ref = weights.convert_lm(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    del jp, jg
    gc.collect()
    print(f"reference: loss {float(jloss):.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    tloss, tg = steps.value_and_grad(lambda p: steps.chunked_ce_loss(
        p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        args.chunk)[0], tp)
    print(f"port: loss {float(tloss):.6f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    pairs = list(zip(tree_leaves(tg), tree_leaves(ref)))
    sq_t = sq_r = 0.0
    worst, worst_path, shares = 0.0, None, []
    for (path, g), (_, r) in pairs:
        g64, r64 = g.double(), r.double()
        st, sr = float((g64 * g64).sum()), float((r64 * r64).sum())
        sq_t, sq_r = sq_t + st, sq_r + sr
        shares.append((sr, "/".join(map(str, path))))
        big = float(r64.abs().max())
        rel = float((g64 - r64).abs().max()) / big if big else \
            float(g64.abs().max())
        if rel > worst:
            worst, worst_path = rel, "/".join(map(str, path))
    norm_t, norm_r = math.sqrt(sq_t), math.sqrt(sq_r)
    print(f"global gradient norm: port {norm_t:.6f}, reference {norm_r:.6f}, "
          f"relative difference {abs(norm_t - norm_r) / norm_r:.3e}")
    print(f"largest leaf difference: {worst:.3e} of its largest |gradient| "
          f"({worst_path})")
    print("leaves with the largest share of the squared norm (reference): "
          + "; ".join(f"{p} {s / sq_r:.4f}"
                      for s, p in sorted(shares, reverse=True)[:5]))


if __name__ == "__main__":
    main()
