#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--seed S] [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. build    — both cosine top-k kernels from ``src/repro_torch/csrc``,
              one nvcc per source, started together;
2. kernels  — K1 (f32) and K2 (int8) against their plain PyTorch versions
              at serving shapes (D=768, N=65,536 rows, B in {0, 1, 4, 8,
              32}, k in {1, 16}, early exit on/off, a valid mask with
              holes), then timed beside the plain version and one library
              call (torch.topk over a masked q @ c.T, a yardstick only);
3. cache    — one interleaved lookup / insert_spill stream with a shadow
              refresh commit, through the dense, pallas (K1) and pallas_q8
              (K2 + exact rescore) backends: identical decisions, and q8
              sims equal to dense sims bit for bit (DESIGN.md §15), both
              for lookups that K2 + the rescore decide and for those that
              fall back to the dense reference (at least 10 of 24 must be
              the former); the q8 margin-window sizes are logged;
4. serve    — the serve_with_siso stream (40 requests, batches of 4,
              max_new=8) through the ServingGateway: siso-embedder at its
              published widths in fp32, qwen3-14b at full width in bf16
              with seeded random weights (``--layers`` cuts depth only),
              SISO bootstrapped from a synthetic history into a centroid
              region of >= 32,768 rows. Once with backend "pallas" (K1),
              once with "pallas_q8" (K2); each kernel's launch counter is
              zeroed just before its run and read just after. Every
              distinct kernel call of these runs (B, N, k, early exit,
              theta) is then held against the plain version at its own
              arguments.

The line before the last is a JSON object with one entry per kernel; the
last line is the device JSON. Details go to DIR/chip_smoke.json (default
results/, relative to the repository root).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
D, N_ROWS = 768, 65536
N_HIST, MIN_CENTROIDS = 38000, 32768
ATOL = 1e-5     # 768-term fp32 dots of unit vectors in another summation
                # order differ by ~1e-7; neighbouring sims are ~1e-3 apart
H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores

TOPICS = {
    "caching": ["what is semantic caching", "explain semantic caching",
                "how does a semantic cache work", "define semantic caching"],
    "slo": ["what is an slo", "explain service level objectives",
            "service level objective meaning"],
    "llm": ["how do llms generate text", "explain llm decoding",
            "how does an llm produce output"],
    "weather": ["will it rain tomorrow in seoul",
                "seoul weather forecast tomorrow"],
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*a) -> None:
    print(*a, flush=True)


def gen(torch, seed: int):
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def far_tile(n: int) -> int:
    return n // 512 - 2


def kernel_inputs(torch, B: int, seed: int, n: int = N_ROWS):
    """Unit rows with 10% invalid holes; each query has a near copy in tile
    0 (sim ~0.98) and an exact copy in the second-to-last tile (sim 1.0),
    so early exit at theta 0.9 serves tile 0 and exact top-k the copy."""
    g = gen(torch, seed)
    rows = torch.randn((n, D), generator=g, device=DEV)
    rows /= rows.norm(dim=1, keepdim=True)
    valid = torch.rand((n,), generator=g, device=DEV) > 0.1
    q = torch.randn((max(B, 1), D), generator=g, device=DEV)
    q = (q / q.norm(dim=1, keepdim=True))[:B]
    if B:
        # 13 and 11 are odd, so up to 512 queries get distinct rows
        near = (7 + 13 * torch.arange(B, device=DEV)) % 512
        far = far_tile(n) * 512 + (11 * torch.arange(B, device=DEV)) % 512
        noisy = q + 0.2 * torch.nn.functional.normalize(
            torch.randn((B, D), generator=g, device=DEV), dim=1)
        rows[near] = noisy / noisy.norm(dim=1, keepdim=True)
        rows[far] = q
        valid[near] = True
        valid[far] = True
    return q.contiguous(), rows.contiguous(), valid


class Inputs:
    """One kernel_inputs draw with its int8 code plane."""

    def __init__(self, torch, ops, B: int, seed: int, n: int = N_ROWS):
        self.n = n
        self.q, self.rows, self.valid = kernel_inputs(torch, B, seed, n)
        codes, scales, _ = ops.quantize_rows(self.rows.cpu().numpy())
        self.codes = torch.tensor(codes, device=DEV)
        self.scales = torch.tensor(scales, device=DEV)


def compare(torch, ops, ref, fn: str, x: Inputs, k: int, early: bool,
            theta: float = 0.9, margin: float = 0.01) -> float:
    """One kernel call against its plain version on the same inputs;
    returns the largest sim difference."""
    if fn == "cosine_topk":
        kv, ki, kh = ops.cosine_topk(x.q, x.rows, k=k, valid=x.valid,
                                     theta=theta, early_exit=early,
                                     return_hit=True)
        pv, pi, ph = ref.cosine_topk_ref(x.q, x.rows, k, x.valid, theta,
                                         early)
        thr = theta
    else:
        kv, ki, kh = ops.cosine_topk_q8(x.q, x.codes, x.scales, k=k,
                                        valid=x.valid, theta=theta,
                                        margin=margin, early_exit=early,
                                        return_hit=True)
        pv, pi, ph = ref.cosine_topk_q8_ref(x.q, x.codes, x.scales, k,
                                            x.valid, theta, margin, early)
        thr = theta + margin
    torch.cuda.synchronize()
    B = x.q.shape[0]
    ctx = f"{fn} B={B} N={x.n} k={k} early={early} theta={theta}"
    check(kv.shape == (B, k) and ki.shape == (B, k) and kh.shape == (B,),
          f"{ctx}: shapes")
    check(torch.equal(ki, pi), f"{ctx}: indices differ")
    check(torch.equal(kh, ph), f"{ctx}: hit masks differ")
    fin = torch.isfinite(pv)
    check(torch.equal(fin, torch.isfinite(kv)), f"{ctx}: finiteness differs")
    e = float((kv[fin] - pv[fin]).abs().max()) if B else 0.0
    check(e <= ATOL, f"{ctx}: max abs err {e}")
    if B:
        served = ki[:, 0].cpu()
        if early and 0 < thr < 0.97:
            check(bool((served < 512).all()), f"{ctx}: early exit did not fire")
        elif not early:
            check(bool((served >= far_tile(x.n) * 512).all()),
                  f"{ctx}: exact top-k missed the copies")
    return e


def phase_kernels(torch, seed: int) -> dict:
    """Both kernels at D=768, N=65,536 over B in {0, 1, 4, 8, 32} (4 is the
    served batch), k in {1, 16}, early exit on and off."""
    from repro_torch.kernels.cosine_topk import ops, ref
    err = {"cosine_topk": 0.0, "cosine_topk_q8": 0.0}
    checks = 0
    for B in (0, 1, 4, 8, 32):
        x = Inputs(torch, ops, B, seed + B)
        for fn in err:
            for k in (1, 16):
                for early in (False, True):
                    err[fn] = max(err[fn],
                                  compare(torch, ops, ref, fn, x, k, early))
                    checks += 1
    log(f"[kernels] {checks} kernel-vs-plain comparisons agree "
        f"(indices and hit masks identical, sims within atol {ATOL}); "
        f"max abs err K1 {err['cosine_topk']:.3g}, "
        f"K2 {err['cosine_topk_q8']:.3g}")
    return err


class CallRecorder:
    """Stands in for the kernel ops module inside the semantic cache while
    the main path runs: it notes the arguments that decide each kernel
    call's work (B, N, k, early exit, theta, margin) and passes the call on
    to the real wrapper, which does its own launch counting."""

    def __init__(self, ops):
        self._ops = ops
        self.calls: set = set()

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def cosine_topk(self, q, rows, k=1, valid=None, theta=2.0,
                    early_exit=False, **kw):
        self.calls.add(("cosine_topk", q.shape[0], rows.shape[0], k,
                        bool(early_exit), float(theta), 0.0))
        return self._ops.cosine_topk(q, rows, k=k, valid=valid, theta=theta,
                                     early_exit=early_exit, **kw)

    def cosine_topk_q8(self, q, codes, scales, k=1, valid=None, theta=2.0,
                       margin=0.0, early_exit=False, **kw):
        self.calls.add(("cosine_topk_q8", q.shape[0], codes.shape[0], k,
                        bool(early_exit), float(theta), float(margin)))
        return self._ops.cosine_topk_q8(q, codes, scales, k=k, valid=valid,
                                        theta=theta, margin=margin,
                                        early_exit=early_exit, **kw)


def phase_main_shapes(torch, calls: set, seed: int) -> dict:
    """Every distinct kernel call of the main path, held against the plain
    version at its own B, N, k, early exit, theta and margin."""
    from repro_torch.kernels.cosine_topk import ops, ref
    err = {"cosine_topk": 0.0, "cosine_topk_q8": 0.0}
    for fn, B, n, k, early, theta, margin in sorted(calls):
        x = Inputs(torch, ops, B, seed + 7 * B + 1, n)
        err[fn] = max(err[fn], compare(torch, ops, ref, fn, x, k, early,
                                       theta, margin))
        log(f"[kernels] main-path call {fn} B={B} N={n} k={k} "
            f"early={early} theta={theta} margin={margin}: agrees with "
            f"the plain version")
    return err


def bound(fn: str, B: int, k: int, rows_needed: int, tiles_rows: int):
    """Least time for the work this input needs: bytes read once / written
    once over HBM rate vs fp32 FMA flops over the non-tensor fp32 peak."""
    row_bytes = D * 4 if fn == "cosine_topk" else D + 4   # codes + scale
    nbytes = (B * D * 4 + tiles_rows + rows_needed * row_bytes
              + B * k * 8 + B)
    flops = 2.0 * B * rows_needed * D
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, seed: int) -> dict:
    """Times at serving shapes: random queries (no planted hits), so early
    exit never fires and every tile is needed, as for a batch that holds a
    miss. K1 as served (k=1, early exit on), K2 as served (k=16, off)."""
    from repro_torch.kernels.cosine_topk import ops, ref
    out = {}
    g = gen(torch, seed + 99)
    rows = torch.nn.functional.normalize(
        torch.randn((N_ROWS, D), generator=g, device=DEV), dim=1)
    valid = torch.rand((N_ROWS,), generator=g, device=DEV) > 0.1
    codes_np, scales_np, _ = ops.quantize_rows(rows.cpu().numpy())
    codes = torch.tensor(codes_np, device=DEV)
    scales = torch.tensor(scales_np, device=DEV)
    neg = torch.tensor(float("-inf"), device=DEV)
    for B in (1, 4, 8, 32):
        q = torch.nn.functional.normalize(
            torch.randn((B, D), generator=g, device=DEV), dim=1)
        for fn, k, early in (("cosine_topk", 1, True),
                             ("cosine_topk_q8", 16, False)):
            if fn == "cosine_topk":
                kern = lambda: ops.cosine_topk(q, rows, k=k, valid=valid,
                                               theta=0.95, early_exit=early,
                                               return_hit=True)
                plain = lambda: ref.cosine_topk_ref(q, rows, k, valid, 0.95,
                                                    early)
                lib = lambda: torch.topk(
                    torch.where(valid[None], q @ rows.T, neg), k, dim=1)
                sims = torch.where(valid[None], q @ rows.T, neg)
            else:
                kern = lambda: ops.cosine_topk_q8(q, codes, scales, k=k,
                                                  valid=valid, theta=0.95,
                                                  early_exit=early,
                                                  return_hit=True)
                plain = lambda: ref.cosine_topk_q8_ref(q, codes, scales, k,
                                                       valid, 0.95, 0.0,
                                                       early)
                lib = lambda: torch.topk(torch.where(
                    valid[None], (q @ codes.float().T) * scales, neg), k,
                    dim=1)
                sims = torch.where(valid[None],
                                   (q @ codes.float().T) * scales, neg)
            t_end = ref.tiles_needed(sims, 0.95, early)
            bn = ref.logical_block(N_ROWS)
            tiles_rows = min(t_end * bn, N_ROWS)
            rows_needed = int(valid[:tiles_rows].sum())
            b_ms, b_by = bound(fn, B, k, rows_needed, tiles_rows)
            rec = {"B": B, "k": k, "early_exit": early,
                   "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": cuda_ms(torch, lib), "bound_ms": b_ms,
                   "bound_by": b_by, "tiles_needed": t_end,
                   "rows_needed": rows_needed}
            out.setdefault(fn, []).append(rec)
            log(f"[timing] {fn} B={B} k={k}: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, library "
                f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
    return out


# ---------------------------------------------------------------------------
# phase 3: cache decisions across backends
# ---------------------------------------------------------------------------


class WindowRecorder:
    """Wraps one pallas_q8 cache's exact rescore and notes, at each lookup,
    how many of each query's top rescore_k quant candidates lie within
    2 eps of its best (DESIGN.md §15). A count of rescore_k means the margin
    window holds rescore_k rows or more, and then the whole lookup falls
    back to the dense reference. Host arithmetic on the candidates the
    rescore receives anyway, for the log."""

    def __init__(self, cache):
        import numpy as np
        from repro_torch.core.semantic_cache import QUANT_SLACK
        self.rescore_k = cache.rescore_k
        self.windows: list = []
        rescore = cache._rescore_exact

        def recording(queries, cand_s, cand_r, kth, err_max):
            eps = err_max * np.linalg.norm(queries.astype(np.float64),
                                           axis=1) + QUANT_SLACK
            m = np.max(np.where(np.isfinite(cand_s), cand_s, -np.inf),
                       axis=1, initial=-np.inf)
            self.windows.append(
                (cand_s >= (m - 2.0 * eps)[:, None]).sum(axis=1))
            return rescore(queries, cand_s, cand_r, kth, err_max)
        cache._rescore_exact = recording

    def full(self) -> int:
        """Lookups with at least one full window: the ones that fell back."""
        return sum(int((w >= self.rescore_k).any()) for w in self.windows)


def phase_cache(torch, np, seed: int) -> dict:
    """One stream through three backends. Odd steps send batches of exact
    and near copies only (the q8 margin windows are narrow, so K2's top-16
    plus the exact rescore decides them); even steps mix in random queries,
    whose windows at dim 768 often hold more than 16 rows and so fall back
    to the dense reference. Both q8 routes must equal dense bit for bit."""
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    A = 64

    def unit(rng, n):
        v = rng.normal(size=(n, D)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def store(vecs, sizes, aid0):
        st = CentroidStore(D, A)
        st.add(vecs, vecs[:, :A], sizes,
               answer_id=np.arange(len(vecs)) + aid0)
        return st

    def stream(backend):
        rng = np.random.default_rng(seed)
        cache = SemanticCache(D, A, capacity=20600, backend=backend,
                              device=DEV)
        rec = WindowRecorder(cache) if backend == "pallas_q8" else None
        base = unit(rng, 20000)
        cache.set_centroids(store(base, rng.uniform(1, 50, 20000).round(),
                                  0))
        parts, results, steps = [base], [], []
        for step in range(24):
            B = int(rng.integers(1, 33))
            q = unit(rng, B)
            pool = np.concatenate(parts)
            pick = rng.integers(0, len(pool), size=B)
            kind = rng.integers(step % 2, 3, size=B)    # 0 random, 1 copy,
            near = pool[pick] + 0.03 * unit(rng, B)     # 2 near copy
            near /= np.linalg.norm(near, axis=1, keepdims=True)
            q[kind == 1] = pool[pick][kind == 1]
            q[kind == 2] = near[kind == 2]
            theta = float(rng.choice([0.6, 0.95, 0.999, -1.0]))
            fb0 = cache.quant_fallbacks
            results.append(cache.lookup(q, theta, update_counts=theta > 0))
            steps.append((kind, cache.quant_fallbacks > fb0))
            for _ in range(int(rng.integers(0, 40))):
                v = unit(rng, 1)[0]
                cache.insert_spill(v, v[:A], answer_id=100000 + step)
                parts.append(v[None])
            if step == 12:
                new = unit(rng, 5000)
                st = store(new, np.arange(5000, 0, -1.0), 50000)
                cache.begin_shadow(len(st))
                for s in range(0, 5000, 1024):
                    cache.shadow_write(st.vectors[s:s + 1024],
                                       st.answers[s:s + 1024],
                                       st.answer_id[s:s + 1024])
                cache.commit_shadow(st)
                parts[0] = new      # the old centroid rows are gone
        return cache, results, steps, rec

    runs = {b: stream(b) for b in ("dense", "pallas", "pallas_q8")}
    dense = runs["dense"][1]
    for b in ("pallas", "pallas_q8"):
        for step, (r, d) in enumerate(zip(runs[b][1], dense)):
            for f in ("hit", "entry", "region", "answer_id", "generation"):
                check(np.array_equal(getattr(r, f), getattr(d, f)),
                      f"[cache] {b} step {step}: {f} differs from dense")
            if b == "pallas_q8":
                check(np.array_equal(r.sim, d.sim),
                      f"[cache] q8 step {step}: sims not bitwise dense")
            else:
                check(np.allclose(r.sim, d.sim, atol=ATOL, rtol=0),
                      f"[cache] pallas step {step}: sims differ")
    hits = int(sum(r.hit.sum() for r in dense))
    q8, steps, rec = (runs["pallas_q8"][0], runs["pallas_q8"][2],
                      runs["pallas_q8"][3])
    check(hits > 20, "[cache] stream served too few hits to mean anything")
    check(runs["pallas"][0].dev_swaps == 1, "[cache] no shadow commit")
    covered = sum(not fb for _, fb in steps)
    check(covered >= 10, f"[cache] only {covered} of {len(steps)} q8 "
                         f"lookups were decided by K2 + the exact rescore")
    check(len(rec.windows) == len(steps)
          and rec.full() == q8.quant_fallbacks,
          "[cache] margin windows do not account for the fallbacks")
    kinds = np.concatenate([k for k, _ in steps])
    wins = np.concatenate(rec.windows)
    win_by_kind = {}
    for kd, label in enumerate(("random", "copy", "near_copy")):
        w = wins[kinds == kd]
        win_by_kind[label] = {
            "queries": int(len(w)),
            "median": float(np.median(w)) if len(w) else None,
            "full": int((w >= q8.rescore_k).sum())}
    info = {"lookups": len(dense), "hits": hits,
            "q8_covered_lookups": covered,
            "quant_rescored": q8.quant_rescored,
            "quant_fallbacks": q8.quant_fallbacks,
            "err_max": q8._device_state().err_max,
            "margin_windows": win_by_kind,
            "dev_row_writes": q8.dev_row_writes}
    log(f"[cache] dense / pallas / pallas_q8 decisions identical over "
        f"{len(dense)} lookups ({hits} hits, 1 shadow commit); q8 sims "
        f"bitwise dense on both routes: {covered} lookups by K2 + exact "
        f"rescore (quant_rescored={q8.quant_rescored}), "
        f"{q8.quant_fallbacks} by the dense fallback")
    log(f"[cache] q8 margin windows (of the top {q8.rescore_k} candidates,"
        f" those within 2 eps of the best; err_max {info['err_max']:.5f}; a "
        f"full window forces the fallback): " + "; ".join(
            f"{k} n={v['queries']} median={v['median']} full={v['full']}"
            for k, v in win_by_kind.items()))
    return info


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------


def phase_engine_consistency(torch, np, seed: int) -> None:
    """Small-input reference check of the engine on the card: batched,
    per-slot KV-cached decode gives the tokens of greedy decoding by full
    re-prefill (no cache), reduced qwen3 in fp32."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ModelEngine
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    params = lm.init_params(gen(torch, seed),
                            cfg, device=DEV)
    eng = ModelEngine(params, cfg, n_slots=2, max_len=32, device=DEV)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9)]
    toks = np.asarray([eng.prefill_into(s, p) for s, p in enumerate(prompts)])
    outs = [[int(t)] for t in toks]
    for _ in range(6):
        toks = eng.decode_active(toks)
        for s in range(2):
            outs[s].append(int(toks[s]))
    for p, out in zip(prompts, outs):
        seq = list(p)
        for t in out:
            cache = lm.init_cache(cfg, 1, 32, device=DEV)
            logits, _ = lm.prefill(params, cfg, {"tokens": torch.tensor(
                [seq], device=DEV)}, cache)
            ref_tok = int(torch.argmax(logits[0]))
            check(ref_tok == t, "[serve] cached decode disagrees with "
                                "re-prefill greedy decoding")
            seq.append(t)
    log("[serve] engine: batched KV-cached decode == re-prefill greedy "
        "(reduced qwen3, fp32, on the card)")


def build_models(torch, layers: int, seed: int):
    from repro_torch.configs.base import get_config
    from repro_torch.models import embedder as E, lm
    ecfg = get_config("siso-embedder").replace(dtype="float32")
    mcfg = get_config("qwen3-14b")
    if layers != mcfg.n_layers:
        log(f"[serve] depth cut: qwen3-14b at {layers} of "
            f"{mcfg.n_layers} layers (widths unchanged)")
        mcfg = mcfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    eparams = E.init_params(gen(torch, seed + 1), ecfg, device=DEV)
    mparams = lm.init_params(gen(torch, seed + 2), mcfg, device=DEV)
    torch.cuda.synchronize()
    n_m = lm.n_params(mparams)
    log(f"[serve] embedder {ecfg.name} d={ecfg.d_model} heads={ecfg.n_heads}"
        f" d_ff={ecfg.d_ff} vocab={ecfg.vocab_size} layers={ecfg.n_layers}"
        f" fp32; engine {mcfg.name} d={mcfg.d_model} heads={mcfg.n_heads}/"
        f"{mcfg.n_kv_heads} d_head={mcfg.head_dim} d_ff={mcfg.d_ff} vocab="
        f"{mcfg.vocab_size} layers={mcfg.n_layers} bf16: {n_m / 1e9:.2f}B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    return ecfg, eparams, mcfg, mparams


def serve_once(torch, np, backend, models, recorder, seed: int) -> dict:
    from repro_torch.core import semantic_cache as SC
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import embedder as E
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import GatewayRequest, ServingGateway
    ecfg, eparams, mcfg, mparams = models
    tok = HashTokenizer(vocab_size=ecfg.vocab_size, max_len=24)

    def encode(ids, mask):
        with torch.inference_mode():
            return E.encode(eparams, ecfg, torch.tensor(ids, device=DEV),
                            torch.tensor(mask, device=DEV)).cpu().numpy()

    def embed_tokens(batches):
        return encode(np.stack([t[0] for t in batches]),
                      np.stack([t[1] for t in batches]))

    def answer_embed(out_tokens):
        ids, mask = tok.encode_batch([" ".join(f"t{t}" for t in out_tokens)])
        return encode(ids, mask)[0]

    # set-up: bootstrap SISO from a synthetic history at dim 768
    t0 = time.perf_counter()
    n_hist = N_HIST
    wl = SyntheticWorkload("quora", dim=ecfg.d_model, n_clusters=20000,
                           seed=seed)
    hist = wl.sample(n_hist, rps=100.0)
    siso = SISO(SISOConfig(dim=ecfg.d_model, answer_dim=ecfg.d_model,
                           capacity=n_hist + 4096, theta_r=0.95,
                           backend=backend, dynamic_threshold=False,
                           refresh_frac=8.0 / n_hist), device=DEV)
    siso.bootstrap(hist.vectors, hist.answers,
                   answer_ids=np.arange(n_hist) + 10**6)
    n_cent = len(siso.cache.centroids)
    check(n_cent >= MIN_CENTROIDS,
          f"[serve] centroid region {n_cent} < {MIN_CENTROIDS} rows")
    engine = ModelEngine(mparams, mcfg, n_slots=3, max_len=96, device=DEV)
    gw = ServingGateway(siso, engine, embed_fn=embed_tokens,
                        answer_fn=answer_embed)
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(40):
        topic = rng.choice(list(TOPICS))
        stream.append(str(rng.choice(TOPICS[topic])))
    setup_s = time.perf_counter() - t0
    # the main path: counters read only around the served stream
    name = "cosine_topk" if backend == "pallas" else "cosine_topk_q8"
    kern = getattr(ops, name)
    torch.cuda.synchronize()
    kern.launches = 0
    other = ops.cosine_topk_q8 if backend == "pallas" else ops.cosine_topk
    other.launches = 0
    fallbacks0 = siso.cache.quant_fallbacks
    windows = WindowRecorder(siso.cache) if backend == "pallas_q8" else None
    SC.ctk_ops = recorder
    t0 = time.perf_counter()
    for base in range(0, len(stream), 4):
        reqs = []
        for rid, text in enumerate(stream[base:base + 4], start=base):
            ids, mask = tok.encode_batch([text])
            prompt = np.asarray(tok.tokenize(text)[:12], np.int64) \
                % mcfg.vocab_size
            reqs.append(GatewayRequest(rid=rid, model_tokens=prompt,
                                       embed_tokens=(ids[0], mask[0]),
                                       max_new=8))
        gw.submit(reqs)
    done = gw.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    SC.ctk_ops = ops
    launches = kern.launches
    rep = gw.report()
    check(rep["completed"] == len(stream) == len(done),
          f"[serve] {rep['completed']} of {len(stream)} completed")
    check(rep["served_cache"] > 0, "[serve] nothing served from the cache")
    check(rep["served_engine"] > 0, "[serve] nothing served by the engine")
    check(launches > 0, f"[serve] {name} was never launched")
    for r in done:
        if r.served_by == "engine":
            check(len(r.out) == 8 and all(0 <= t < mcfg.vocab_size
                                          for t in r.out),
                  f"[serve] rid {r.rid}: bad completion {r.out}")
        check(r.answer is not None and np.isfinite(r.answer).all()
              and r.answer.shape == (ecfg.d_model,),
              f"[serve] rid {r.rid}: bad answer")
    lk = rep["lookup"]
    log(f"[serve] backend={backend}: {rep['completed']} requests, "
        f"{rep['served_cache']} from cache, {rep['served_engine']} through "
        f"the engine; hits={rep['hits']} misses={rep['misses']}; lookup "
        f"p50={lk['p50_ms']:.3f} ms p99={lk['p99_ms']:.3f} ms; "
        f"{name} launches={launches}; centroids={n_cent}, mirror rows="
        f"{siso.cache._dev.pad if siso.cache._dev is not None else 0}; "
        f"refreshes={rep['refreshes']}; set-up {setup_s:.1f} s, "
        f"served in {serve_s:.1f} s")
    extra = {}
    if backend == "pallas_q8":
        # what one margin-coverage fallback costs (the dense reference over
        # the host-resident f32 rows), timed on the served batch size
        qs = encode(*tok.encode_batch(stream[:4]))
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            siso.cache._dense_reference_lookup(qs)
            times.append(1e3 * (time.perf_counter() - t1))
        fell_back = siso.cache.quant_fallbacks - fallbacks0
        check(windows.full() == fell_back,
              "[serve] margin windows do not account for the fallbacks")
        wins = np.concatenate(windows.windows)
        extra = {"fallbacks_in_stream": fell_back,
                 "fallback_ms": statistics.median(times),
                 "lookup_sizes": [len(w) for w in windows.windows],
                 "lookup_max_windows": [int(w.max())
                                        for w in windows.windows],
                 "queries_with_full_window": int(
                     (wins >= siso.cache.rescore_k).sum())}
        log(f"[serve] quant_rescored={rep['quant_rescored']} "
            f"quant_fallbacks={rep['quant_fallbacks']}; {fell_back} of "
            f"{len(windows.windows)} lookups in the served stream fell back;"
            f" one fallback (dense reference, B=4) takes "
            f"{extra['fallback_ms']:.3f} ms host time; largest margin window"
            f" per lookup (B): " + ", ".join(
                f"{m} ({b})" for m, b in zip(extra["lookup_max_windows"],
                                             extra["lookup_sizes"]))
            + f"; {extra['queries_with_full_window']} of {len(wins)} "
            f"queries had a full window ({siso.cache.rescore_k})")
    return {"backend": backend, "kernel": name, "launches": launches,
            "other_kernel_launches": other.launches, **extra,
            "batches": len(stream) // 4, "served_s": serve_s,
            "setup_s": setup_s, "centroids": n_cent,
            "report": {k: v for k, v in rep.items()
                       if k not in ("theta_trace", "lam_trace")}}


# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="qwen3-14b depth (widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results",
                    help="directory for chip_smoke.json, relative to the "
                         "repository root")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.cosine_topk import kernel as K, ops
    strict_fp32()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    detail = {"nvidia_smi": smi}
    t0 = time.perf_counter()
    reports = K.build()
    build_s = time.perf_counter() - t0
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(reports)} kernels built in {build_s:.1f} s "
        f"(nvcc per source, in parallel)")
    detail["build_s"] = build_s
    for name in K.KERNELS:
        K.load(name)
    t = time.perf_counter()
    err = phase_kernels(torch, args.seed)
    timing = phase_timing(torch, args.seed)
    detail.update(max_abs_err=err, timing=timing,
                  kernels_s=time.perf_counter() - t)
    t = time.perf_counter()
    detail["cache"] = phase_cache(torch, np, args.seed)
    detail["cache_s"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_engine_consistency(torch, np, args.seed)
    models = build_models(torch, args.layers, args.seed)
    recorder = CallRecorder(ops)
    serve = {b: serve_once(torch, np, b, models, recorder, args.seed)
             for b in ("pallas", "pallas_q8")}
    detail["serve"] = serve
    detail["serve_s"] = time.perf_counter() - t
    main_err = phase_main_shapes(torch, recorder.calls, args.seed)
    check({c[0] for c in recorder.calls} == set(err),
          "[kernels] a kernel of the main path was never called")
    err = {fn: max(err[fn], main_err[fn]) for fn in err}
    detail.update(max_abs_err=err, main_path_calls=sorted(recorder.calls))

    main_b = 4      # the served batch size, the one the kernels line times
    for name in err:
        check(any(c[:3] == (name, main_b, N_ROWS) for c in recorder.calls),
              f"[kernels] {name}: the main path never ran B={main_b} at "
              f"N={N_ROWS}, the shape that is timed")
    replaces = {"cosine_topk": "src/repro/kernels/cosine_topk/kernel.py:49",
                "cosine_topk_q8": "src/repro/kernels/cosine_topk/kernel.py:98"}
    sources = {"cosine_topk": "src/repro_torch/csrc/cosine_topk.cu",
               "cosine_topk_q8": "src/repro_torch/csrc/cosine_topk_q8.cu"}
    launches = {"cosine_topk": serve["pallas"]["launches"],
                "cosine_topk_q8": serve["pallas_q8"]["launches"]}
    kernels = []
    for name in ("cosine_topk", "cosine_topk_q8"):
        rec = next(r for r in timing[name] if r["B"] == main_b)
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"kernels": kernels, **detail}, indent=1, default=float))
    print(smi)      # the card's name and power limit, as nvidia-smi says
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
