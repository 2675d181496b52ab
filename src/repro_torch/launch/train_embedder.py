"""Train the ALBERT-style sentence embedder with a contrastive objective
(port of ``examples/train_embedder.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_embedder \\
        [--steps 60] [--full] [--device cpu]

Synthetic paraphrase corpus: "topics" are word pools; two samples of the
same topic are positives (in-batch negatives, InfoNCE / multiple-negatives
ranking loss, the sentence-transformers recipe). After a few dozen steps
the dup/non-dup similarity gap turns positive, the property Table 1
selects embedders by. The reduced embedder in f32 by default, as the
reference's example; ``--full`` trains the served siso-embedder (d 768,
6 shared layers) in f32. On the card its attention is the f32 K4 and the
backward's f32 kernels.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import embedder as E
from repro_torch.training import optimizer as opt

WORDS = [f"w{i}" for i in range(4000)]
N_TOPICS = 64


def make_corpus(rng, n_topics: int = N_TOPICS, words_per_topic: int = 30):
    pools = [rng.choice(WORDS, size=words_per_topic, replace=False)
             for _ in range(n_topics)]

    def sentence(topic):
        n = rng.integers(5, 12)
        return " ".join(rng.choice(pools[topic], size=n))

    return sentence


def info_nce(params, cfg, a_ids, a_mask, b_ids, b_mask,
             temp: float = 0.07) -> torch.Tensor:
    za = E.encode(params, cfg, a_ids, a_mask)       # (B, d)
    zb = E.encode(params, cfg, b_ids, b_mask)
    logits = za @ zb.T / temp                        # (B, B)
    return torch.mean(torch.logsumexp(logits, dim=1) - torch.diagonal(logits))


def train(steps: int = 400, batch: int = 48, lr=None, seed: int = 0,
          full: bool = False, device=None, log_every: int = 10,
          wrap_step=None, params=None) -> dict:
    """Train and return {"before": (dup, nondup), "after": (dup, nondup),
    "losses": the per-step losses}: the median cosine of duplicate and of
    non-duplicate pairs over 128 fresh pairs each. ``lr`` defaults to the
    reference's 2e-3 for the reduced embedder and 3e-4 for the full one
    (at 2e-3 the full embedder collapses within ten steps: every sentence
    maps to one vector and the loss sits at ln(batch)). ``wrap_step(i,
    run)``, where given, runs step i by calling ``run()``, which returns
    the step's loss, and returns that loss. It is a measurement seam, not
    a training option: the command line never sets it, and
    ``chip_smoke.py`` uses it to time each step on the host and trace the
    last one, which it cannot reach from outside ``train`` (the step is a
    closure over the optimiser state). ``params``: the embedder's initial
    weights on ``device`` (default: drawn from ``seed``), as a test gives
    the reference's."""
    dev = resolve_device(device)
    if lr is None:
        lr = 3e-4 if full else 2e-3
    cfg = get_config("siso-embedder")
    if not full:
        cfg = cfg.reduced()
    cfg = cfg.replace(dtype="float32")
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=24)
    rng = np.random.default_rng(seed)
    sentence = make_corpus(rng)
    if params is None:
        params = E.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, dev)
    state = opt.init_state(params)
    optc = opt.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps,
                           weight_decay=0.01)

    def encode(texts):
        ids, mask = tok.encode_batch(texts)
        return torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)

    def step(a, b):
        nonlocal state
        loss, grads = value_and_grad(
            lambda p: info_nce(p, cfg, *a, *b), params)
        _, state, _ = opt.apply_updates(params, grads, state, optc)
        return float(loss)

    @torch.no_grad()
    def eval_gap(n: int = 128):
        topics = rng.integers(0, N_TOPICS, size=n)
        a = [sentence(t) for t in topics]
        b = [sentence(t) for t in topics]                     # dup pairs
        c = [sentence((t + 1 + rng.integers(N_TOPICS - 2)) % N_TOPICS)
             for t in topics]
        za, zb, zc = (E.encode(params, cfg, *encode(x)) for x in (a, b, c))
        # the reference's median: of an even count, the mean of the two
        # middle values (torch.median gives the lower one)
        dup = float(torch.quantile(torch.sum(za * zb, -1), 0.5))
        nondup = float(torch.quantile(torch.sum(za * zc, -1), 0.5))
        return dup, nondup

    before = eval_gap()
    print(f"before: dup={before[0]:.3f} nondup={before[1]:.3f} "
          f"gap={before[0] - before[1]:+.3f}", flush=True)
    losses = []
    for i in range(steps):
        topics = rng.integers(0, N_TOPICS, size=batch)
        a = encode([sentence(t) for t in topics])
        b = encode([sentence(t) for t in topics])
        losses.append(wrap_step(i, lambda: step(a, b)) if wrap_step
                      else step(a, b))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1:3d} loss={losses[-1]:.4f}", flush=True)
    after = eval_gap()
    print(f"after:  dup={after[0]:.3f} nondup={after[1]:.3f} "
          f"gap={after[0] - after[1]:+.3f}", flush=True)
    return {"before": before, "after": after, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 2e-3, or 3e-4 with --full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the served siso-embedder (d 768), not the reduced")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    res = train(args.steps, args.batch, args.lr, args.seed, args.full,
                args.device)
    (d0, n0), (d1, n1) = res["before"], res["after"]
    if not d1 - n1 > d0 - n0:
        print("the dup/non-dup gap did not widen")
        return 1
    print("gap widened: the embedder learned paraphrase similarity.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
