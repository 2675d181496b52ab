#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--seed S] [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. build    — all four kernels from ``src/repro_torch/csrc`` (K1, K2
              cosine top-k; K3 decode attention; K4 prefill attention),
              one nvcc per source, started together; ptxas register and
              spill lines logged;
2. kernels  — K1 (f32) and K2 (int8) against their plain PyTorch versions
              at serving shapes (D=768, N=65,536 rows, B in {0, 1, 4, 5, 8,
              32, 33}, k in {1, 16}, early exit on/off, a valid mask with
              holes), then timed beside the plain version and one library
              call (torch.topk over a masked q @ c.T, a yardstick only),
              with a torch.profiler split into pass 1 and pass 2 (K1 at
              every timed batch, K2 at B=4), which must show the kernel's
              own two launches and no other;
              K4 against its plain version over every mask mode (causal,
              bidirectional, window, prefix, ragged kv with a q offset,
              right-aligned queries) in f32 and bf16, bf16 at shapes
              ragged against its 128-row and 128-key tiles, with a kv ring
              that wraps four times and with qwen3's 40/8 heads, and K3
              with f32, bf16 and int8 caches; both at the main path's
              shapes too, then timed there (K4's TFLOP/s and share of its
              bound logged; both K4 calls, the bf16 prefill and the
              embedder's f32 one, and SDPA beside each also on the device
              through torch.profiler, K3 too: each call must show its
              one kernel and no other) beside the
              plain version, a bound and
              scaled_dot_product_attention (a yardstick only, never called
              by the port); bf16 outputs are held to 2^-7 |plain| + c x
              the rms of the output row (kernels.bf16_excess), and a kv
              tile dropped from the plain version must fail that limit;
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
              arguments. K4 runs in the embedder and the engine's prefill,
              K3 in every decode step; their launch counters are zeroed
              and read around each stream too, and every distinct K3/K4
              call (shapes, dtypes, masks, kv lengths) is held against the
              plain version at its own arguments. E.encode's host ms per
              batch (median over the stream) is logged. Before the stream, the
              engine check (reduced qwen3, fp32: cached decode equals
              re-prefill greedy decoding; with the int8 KV cache, batched
              decode equals one-sequence decode) runs on the card;
5. engine-long — qwen3-14b at full width and depth, the served run's
              weights, ModelEngine(n_slots=4, max_len=8192): four 4,096-token
              prompts through prefill (K4 on every layer), then 16 decode
              steps (K3 on every layer), once with the bf16 KV cache and
              once with the int8 one. The first prefill's last-position
              logits and the first decode step's logits are held against
              the plain layers on the same inputs; a planted fault in the
              prefill attention must exceed the limit. Every K3/K4 call
              of the prefills and steps is re-checked at its own
              arguments. Two more decode steps run under torch.profiler:
              the device's busy time per step, K3's share of it and the
              idle share; then one
              more prefill: its device busy time and K4's share of it.
6. slo      — the paper's comparison at the embedder's width (dim 768):
              (a) benchmarks/fig9_slo.py's configuration through the
              ServingSimulator over the analytic engine (qwen3-14b on one
              H100, concurrency 4): 8,000 training queries, then two test
              streams of 800 (rps 10 cv 0.1, rps 8 cv 5), capacity 512,
              for vLLM, GPTCache, SISO-NoDTA and SISO on backend pallas
              (K1), then SISO on dense and on pallas_q8 (K2 + exact
              rescore), which must give equal SimResults; (b)
              benchmarks/bench_slo.py's live harness (virtual clock, 2
              slots, 6 new tokens, 0.05 s ticks) over the served qwen3-14b
              weights, repeat_heavy and topic_drift, for SISO (built with
              ServingGateway.from_config, backend pallas), VectorCache and
              NoCache: every request completes, SISO serves from both the
              cache and the engine, and every distinct K1/K3/K4 call is
              re-checked at its own arguments with the earlier phases'.
              Hit ratio, SLO attainment, theta range and wall seconds are
              logged per system, not asserted.

The line before the last is a JSON object with one entry per kernel (K3's
int8 mode and K4's f32 mode, the embedder's call, their own entries, with
their own bounds; every entry also carries ``device_ms``, the profiler's
device time, and each entry with a library call ``library_device_ms``,
that call's); the line
before it is the card's name and power limit; the last line is the device
JSON. Details go to DIR/chip_smoke.json (default
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


def far_start(n: int) -> int:
    """First row of the exact copies: the second-to-last 512-row tile, or
    the second half of a table no longer than one tile (the slo phase's
    cache plane)."""
    return (n // 512 - 2) * 512 if n >= 1024 else n // 2


def kernel_inputs(torch, B: int, seed: int, n: int = N_ROWS):
    """Unit rows with 10% invalid holes; each query has a near copy in tile
    0 (sim ~0.98) and an exact copy at ``far_start`` (sim 1.0), so early
    exit at theta 0.9 serves tile 0 and exact top-k the copy. Queries
    beyond the rows available share copies (only the last one keeps its
    exact copy)."""
    g = gen(torch, seed)
    rows = torch.randn((n, D), generator=g, device=DEV)
    rows /= rows.norm(dim=1, keepdim=True)
    valid = torch.rand((n,), generator=g, device=DEV) > 0.1
    q = torch.randn((max(B, 1), D), generator=g, device=DEV)
    q = (q / q.norm(dim=1, keepdim=True))[:B]
    if B:
        # 13 and 11 are odd, so up to 512 queries get distinct rows
        f0 = far_start(n)
        near = (7 + 13 * torch.arange(B, device=DEV)) % min(512, f0)
        far = f0 + (11 * torch.arange(B, device=DEV)) % min(512, n - f0)
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
        elif not early and B <= min(512, x.n - far_start(x.n)):
            check(bool((served >= far_start(x.n)).all()),
                  f"{ctx}: exact top-k missed the copies")
    return e


def phase_kernels(torch, seed: int) -> dict:
    """Both kernels at D=768, N=65,536 over B in {0, 1, 4, 5, 8, 32, 33}
    (4 is the served batch; 5 and 33 are ragged against the query
    buckets), k in {1, 16}, early exit on and off."""
    from repro_torch.kernels.cosine_topk import ops, ref
    err = {"cosine_topk": 0.0, "cosine_topk_q8": 0.0}
    checks = 0
    for B in (0, 1, 4, 5, 8, 32, 33):
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
                f"({b_by}, {b_ms / rec['ms']:.3f} of it)")
            if fn == "cosine_topk" or B == SPLIT_B:
                rec.update(topk_device_ms(torch, kern, fn))
                split = rec["device_kernels"]
                log(f"[timing] {fn} B={B}, torch.profiler: " + (
                    "; ".join(f"{n} {t:.4f} ms" for n, t in split.items())
                    + f"; {rec['device_ms']:.4f} ms on the device "
                      f"({b_ms / rec['device_ms']:.3f} of the bound)"
                    if split else
                    "no device activity recorded (not measured)"))
            if B == SPLIT_B:
                rec["library_device_ms"] = library_device_ms(torch, lib)
                log(f"[timing] {fn} B={B}, library on the device: "
                    f"{rec['library_device_ms']} ms")
    return out


def library_device_ms(torch, lib):
    """Device ms per call of the library yardstick ``lib`` (all the
    kernels one call launches), from a torch.profiler trace of 10 calls;
    None when the profiler records no device activity."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split = device_kernel_ms(torch, lib, iters=10)
    return sum(split.values()) if split else None


SPLIT_B = 4     # the served batch: K2 traced pass by pass there; K1 at
                # every batch


def topk_device_ms(torch, fn, name: str) -> dict:
    """Device ms per call of each of the kernel's launches (pass 1
    ``sims_tile_*`` and pass 2 ``merge_tiles``), from a torch.profiler
    trace of 10 calls. One call launches these two and nothing else: no
    copy, cast or fill."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split = device_kernel_ms(torch, fn, iters=10)
    if not split:
        return {"device_ms": None, "device_kernels": {}}
    names = sorted(n.split("(")[0].split("<")[0].replace("void ", "")
                   for n in split)
    check(names == ["ctk::merge_tiles", f"ctk::sims_tile_"
                    f"{'f32' if name == 'cosine_topk' else 'q8'}"],
          f"[timing] {name}: one call launches {list(split)}, not its own "
          f"two passes alone")
    return {"device_ms": sum(split.values()),
            "device_kernels": {n.split("(")[0]: t for n, t in split.items()}}


# ---------------------------------------------------------------------------
# phase 2b: attention kernels (K3, K4) against their plain versions
# ---------------------------------------------------------------------------

ATT_ATOL_F32 = 2e-5   # the reference's own for f32 outputs: sums in
                      # another order
# bf16 outputs: |kernel - plain| <= 2^-7 |plain| + ATT_ROW_RTOL x the rms of
# plain's row (kernels.bf16_excess). K4 rounds P to bf16 at each kv tile's
# running max, its plain version at the row's final max: independent
# roundings of up to 2^-9 each, whose sum over the row's keys is about
# 0.002 of the row's rms (one standard deviation), so the largest of the
# 2e7 outputs at the prefill shape lies near 0.012. A kv tile dropped from
# a 4,096-key row moves it by about sqrt(64 / 4096) = 0.125 of the rms.
# K3 is f32 throughout, as is its plain version: only the summation order
# differs.
ATT_ROW_RTOL = {"flash_attention": 2.0 ** -5,
                "decode_attention": 2.0 ** -10,
                "decode_attention_int8": 2.0 ** -10}
# the attention kernels' entries: K4 bf16 and f32 apart (the f32 outputs are
# held at ATT_ATOL_F32, with no bf16 limit)
ATT_KEYS = ("flash_attention", "flash_attention_f32", "decode_attention",
            "decode_attention_int8")
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
EMBED_SHAPE = dict(B=4, Lq=24, Lkv=24, H=12, Hkv=12, Dh=64)
PREFILL_SHAPE = dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=8, Dh=128)
DECODE_SHAPE = dict(B=4, H=40, Hkv=8, Dh=128)
DECODE_LENS = (4096, 32768)         # engine-long's prompt; decode_32k
DECODE_TIMED = ((8192, 4096),       # (cache length, kv_len): engine-long's
                (32768, 32768))     # layout; decode_32k
FLASH_MODES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "window": dict(causal=True, window=100),
    "prefix": dict(causal=True, prefix_len=40),
    "offset-ragged": dict(causal=True, q_offset=150, kv_valid_len=[300, 97]),
    "right-aligned": dict(causal=True, Lq=77),
}


FLASH_SWEEP = (
    (dict(B=2, Lq=77, Lkv=333, H=4, Hkv=2, Dh=128), dict(causal=True)),
    (dict(B=2, Lq=300, Lkv=333, H=4, Hkv=2, Dh=128), dict(causal=False)),
    (dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1, Dh=128), dict(causal=True)),
    (dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1, Dh=128),
     dict(causal=True, window=300)),
    (dict(B=3, Lq=260, Lkv=260, H=40, Hkv=8, Dh=128),
     dict(causal=True, kv_valid_len=[260, 77, 129])),
)


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def flash_inputs(torch, B, Lq, Lkv, H, Hkv, Dh, dtype, seed):
    g = gen(torch, seed)
    return tuple(torch.randn(s, generator=g, device=DEV).to(dtype)
                 for s in ((B, Lq, H, Dh), (B, Lkv, Hkv, Dh),
                           (B, Lkv, Hkv, Dh)))


def decode_inputs(torch, B, H, Hkv, Dh, Lc, qdtype, int8, seed):
    """q (B, H, Dh) and caches (B, Lc, Hkv, Dh) in ``qdtype``, or int8
    codes and f16 scales made by the model's quantizer."""
    from repro_torch.models import lm
    g = gen(torch, seed)
    q = torch.randn((B, H, Dh), generator=g, device=DEV).to(qdtype)
    k, v = (torch.randn((B, Lc, Hkv, Dh), generator=g, device=DEV)
            for _ in range(2))
    if not int8:
        return q, k.to(qdtype), v.to(qdtype), {}
    (kq, ks), (vq, vs) = lm.kv_quant(k), lm.kv_quant(v)
    return q, kq, vq, {"k_scale": ks, "v_scale": vs}


class Agreement:
    """Per kernel entry: the largest |kernel - plain| and the largest share
    of the bf16 limit used (``kernels.bf16_excess``) over its comparisons."""

    def __init__(self):
        self.err = dict.fromkeys(ATT_KEYS, 0.0)
        self.share = dict.fromkeys(ATT_KEYS, 0.0)
        self.n = 0

    def hold(self, torch, key: str, out, plain, ctx: str) -> None:
        from repro_torch.kernels import bf16_excess
        check(out.shape == plain.shape and out.dtype == plain.dtype,
              f"{ctx}: shape or dtype")
        check(bool(torch.isfinite(out).all()), f"{ctx}: non-finite output")
        e = float((out.float() - plain.float()).abs().max())
        self.err[key] = max(self.err[key], e)
        self.n += 1
        if out.dtype == torch.float32:
            check(e <= ATT_ATOL_F32, f"{ctx}: max abs err {e}")
            return
        x = bf16_excess(out, plain, ATT_ROW_RTOL[key])
        self.share[key] = max(self.share[key], x)
        check(x <= 1.0, f"{ctx}: max abs err {e}, {x:.3g} of the bf16 limit")

    def merge(self, other: "Agreement") -> None:
        for key in self.err:
            self.err[key] = max(self.err[key], other.err[key])
            self.share[key] = max(self.share[key], other.share[key])
        self.n += other.n


def compare_flash(torch, agree: Agreement, shape: dict, dtype, seed: int,
                  **kw) -> None:
    """K4 against its plain version, which rounds P as the kernel does."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = flash_inputs(torch, **shape, dtype=dtype, seed=seed)
    if kw.get("kv_valid_len") is not None:
        kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device=DEV)
    out = ops.flash_attention(q, k, v, **kw)
    plain = ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    agree.hold(torch, "flash_attention_f32" if dtype == torch.float32
               else "flash_attention", out, plain,
               f"flash_attention {shape} {_dtype_name(dtype)} {kw}")


def compare_decode(torch, agree: Agreement, shape: dict, Lc: int, kv_len,
                   qdtype, int8: bool, seed: int) -> None:
    from repro_torch.kernels.decode_attention import ops, ref
    q, k, v, sc = decode_inputs(torch, **shape, Lc=Lc, qdtype=qdtype,
                                int8=int8, seed=seed)
    kv_len = torch.tensor(kv_len, device=DEV)
    out = ops.decode_attention(q, k, v, kv_len, **sc)
    plain = ref.decode_attention_ref(q, k, v, kv_len, **sc)
    torch.cuda.synchronize()
    agree.hold(torch, "decode_attention_int8" if int8 else "decode_attention",
               out, plain, f"decode_attention {shape} Lc={Lc} kv_len="
               f"{kv_len.tolist()} q {_dtype_name(qdtype)} cache "
               f"{_dtype_name(k.dtype)}")


def log_agreement(what: str, agree: Agreement) -> None:
    log(f"[kernels] {agree.n} {what} agree with the plain version (f32 "
        f"atol {ATT_ATOL_F32}; bf16 2^-7 |plain| + 2^-5 (K4) or 2^-10 (K3) "
        f"x the row's rms): " + "; ".join(
            f"{key} max abs err {agree.err[key]:.3g}, largest share of the "
            f"bf16 limit {agree.share[key]:.3g}" for key in agree.err))


def phase_attention_kernels(torch, seed: int) -> Agreement:
    """K4 over every mask mode in f32 and bf16 (B=2, L=300, H=8/2, Dh=128)
    and at the embedder's and the engine prefill's shapes; K3 with f32,
    bf16 and int8 caches, ragged kv_len, at the engine decode's shape."""
    agree = Agreement()
    for i, (mode, kw) in enumerate(FLASH_MODES.items()):
        kw = dict(kw)
        shape = dict(B=2, Lq=kw.pop("Lq", 300), Lkv=300, H=8, Hkv=2, Dh=128)
        for dtype in (torch.float32, torch.bfloat16):
            compare_flash(torch, agree, shape, dtype, seed + 10 + i, **kw)
    # bf16 K4 against its tiles (128 q rows, 128 keys in a 2-stage ring):
    # ragged edges, a ring that wraps four times, qwen3's 40/8 heads
    for i, (shape, kw) in enumerate(FLASH_SWEEP):
        compare_flash(torch, agree, shape, torch.bfloat16, seed + 50 + i,
                      **kw)
    compare_flash(torch, agree, EMBED_SHAPE, torch.float32, seed + 20,
                  causal=False)
    compare_flash(torch, agree, PREFILL_SHAPE, torch.bfloat16, seed + 21,
                  causal=True)
    compare_flash(torch, agree, PREFILL_SHAPE, torch.float32, seed + 22,
                  causal=True)
    B = DECODE_SHAPE["B"]
    for Lc in DECODE_LENS:
        lens = [Lc, Lc - 1, Lc // 2 + 3, 1][:B]
        for qdtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                             (torch.bfloat16, True), (torch.float32, True)):
            compare_decode(torch, agree, DECODE_SHAPE, Lc, lens, qdtype,
                           int8, seed + Lc)
    log_agreement("attention kernel-vs-plain comparisons", agree)
    return agree


FAULT_TILE = 64     # half of K4's 128-key kv tile; K3's fault drops 256
                    # positions, four of its 64-position chunk steps


def flash_tile_dropped(torch, q, k, v):
    """Causal prefill (Lq == Lkv) through K4's plain version with one kv
    tile (keys L/2 .. L/2 + 64) left out of the last quarter of the query
    rows: a planted fault that the checks must fail."""
    from repro_torch.kernels.flash_attention import ref
    L = q.shape[1]
    lo, r0 = L // 2, 3 * L // 4
    out = ref.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)

    def holed(x):
        return torch.cat([x[:, :lo], x[:, lo + FAULT_TILE:]], dim=1)
    # rows r0.. see every key before the hole; shifting the positions of
    # the later keys and of the rows by the hole's width keeps causality
    out[:, r0:] = ref.attention_ref(q[:, r0:], holed(k), holed(v),
                                    causal=True, q_offset=r0 - FAULT_TILE,
                                    p_dtype=v.dtype)
    return out


def phase_planted_faults(torch, seed: int) -> dict:
    """The bf16 limit must fail a dropped kv tile: K4 at the engine
    prefill's shape with one 64-key tile left out of the last quarter of
    the rows, K3 at decode_32k's kv length with one 256-position split
    left out. Plain versions only; the readings are logged."""
    from repro_torch.kernels import bf16_excess
    from repro_torch.kernels.decode_attention import ref as dr
    from repro_torch.kernels.flash_attention import ref as fr
    q, k, v = flash_inputs(torch, **PREFILL_SHAPE, dtype=torch.bfloat16,
                           seed=seed + 40)
    plain = fr.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = flash_tile_dropped(torch, q, k, v)
    out = {"flash_attention": (
        bf16_excess(bad, plain, ATT_ROW_RTOL["flash_attention"]),
        float((bad.float() - plain.float()).abs().max()))}
    del q, k, v, plain, bad
    Lc = DECODE_LENS[-1]
    q, k, v, _ = decode_inputs(torch, **DECODE_SHAPE, Lc=Lc,
                               qdtype=torch.bfloat16, int8=False,
                               seed=seed + 41)
    kv_len = torch.full((DECODE_SHAPE["B"],), Lc, device=DEV)
    plain = dr.decode_attention_ref(q, k, v, kv_len)
    split = 256
    lo = Lc // 2
    holed = [torch.cat([x[:, :lo], x[:, lo + split:]], dim=1) for x in (k, v)]
    bad = dr.decode_attention_ref(q, *holed, kv_len - split)
    out["decode_attention"] = (
        bf16_excess(bad, plain, ATT_ROW_RTOL["decode_attention"]),
        float((bad.float() - plain.float()).abs().max()))
    for key, (x, e) in out.items():
        check(x > 1.0, f"[kernels] the bf16 limit passes a planted fault in "
                       f"{key}: {x:.3g} of the limit")
        log(f"[kernels] planted fault in {key} (one kv tile dropped): "
            f"{x:.3g} times the bf16 limit, max abs {e:.3g}")
    return out


def att_bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_attention_timing(torch, seed: int) -> dict:
    """K4 at the embedder's shape (f32, bidirectional) and the engine
    prefill's (bf16, causal), K3 at the engine decode's (bf16 and int8
    caches; kv_len 4,096 in an 8,192-position cache, engine-long's
    layout, and 32,768 in a full one): kernel, plain version, bound and
    scaled_dot_product_attention (a yardstick; it takes no int8 cache, and
    is given the kv_len mask). The bound counts each input that the work
    needs read once and the output written once: for causal prefill only
    the unmasked half of the scores, for decode the first kv_len
    positions."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da, ref as dr
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    out = {}
    for label, shape, dtype, causal in (
            ("embedder", EMBED_SHAPE, torch.float32, False),
            ("prefill", PREFILL_SHAPE, torch.bfloat16, True)):
        q, k, v = flash_inputs(torch, **shape, dtype=dtype, seed=seed + 31)
        B, L, H, Hkv, Dh = (shape[x] for x in ("B", "Lq", "H", "Hkv", "Dh"))
        esz = q.element_size()
        nbytes = esz * (2 * B * L * H * Dh + 2 * B * L * Hkv * Dh)
        pairs = L * (L + 1) // 2 if causal else L * L
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
        b_ms, b_by = att_bound(nbytes, 4.0 * B * H * Dh * pairs, peak)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {"shape": shape, "dtype": _dtype_name(dtype), "causal": causal,
               "ms": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, causal=causal)),
               "plain_ms": cuda_ms(torch, lambda: fr.attention_ref(
                   q, k, v, causal=causal)),
               "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["tflops"] = 4.0 * B * H * Dh * pairs / rec["ms"] / 1e9
        out[f"flash_attention/{label}"] = rec
        log(f"[timing] flash_attention {label} {shape} "
            f"{rec['dtype']}: kernel {rec['ms']:.4f} ms "
            f"({rec['tflops']:.1f} TFLOP/s), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); the kernel takes "
            f"{b_ms / rec['ms']:.3f} of its bound")
        # device time beside the events' (which time the wrapper's host
        # work too, most of a call this short)
        rec.update(flash_device_ms(
            torch, lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv),
            "flash_f32" if dtype == torch.float32 else "flash_bf16", label))
        log(f"[timing] flash_attention {label}, torch.profiler: "
            + ("not measured (no profiler activity)"
               if rec["device_ms"] is None else
               f"kernel {rec['device_ms']:.4f} ms on the device "
               f"({b_ms / rec['device_ms']:.3f} of the bound) in "
               f"{list(rec['device_kernels'])}, library "
               f"{rec['library_device_ms']:.4f} ms in its kernels "
               f"{rec['library_kernels']}"))
    B, H, Hkv, Dh = (DECODE_SHAPE[x] for x in ("B", "H", "Hkv", "Dh"))
    for Lc, n_kv in DECODE_TIMED:
        for int8 in (False, True):
            q, k, v, sc = decode_inputs(torch, **DECODE_SHAPE, Lc=Lc,
                                        qdtype=torch.bfloat16, int8=int8,
                                        seed=seed + 32)
            kv_len = torch.full((B,), n_kv, device=DEV)
            row = Hkv * Dh * k.element_size() + (Hkv * 2 if int8 else 0)
            nbytes = 2 * B * H * Dh * 2 + 2 * B * n_kv * row + B * 4
            b_ms, b_by = att_bound(nbytes, 4.0 * B * H * Dh * n_kv,
                                   H100_BF16_FLOPS)
            name = "decode_attention_int8" if int8 else "decode_attention"
            lib = None
            if not int8:
                qt = q[:, :, None]
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                mask = (torch.arange(Lc, device=DEV)[None, :]
                        < kv_len[:, None])[:, None, None, :]
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                lib = cuda_ms(torch, sdpa)
            call = lambda: da.decode_attention(q, k, v, kv_len, **sc)
            rec = {"Lc": Lc, "kv_len": n_kv, "ms": cuda_ms(torch, call),
                   "plain_ms": cuda_ms(torch, lambda: dr.decode_attention_ref(
                       q, k, v, kv_len, **sc)),
                   "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
            rec.update(decode_device_ms(torch, call, name))
            if lib is not None:
                rec["library_device_ms"] = library_device_ms(torch, sdpa)
            out[f"{name}/{Lc}/{n_kv}"] = rec
            dev_ms = rec["device_ms"]
            log(f"[timing] {name} B={B} H={H}/{Hkv} Dh={Dh} Lc={Lc} "
                f"kv_len={n_kv}: "
                f"kernel {rec['ms']:.4f} ms (CUDA events), "
                + ("device not measured (no profiler activity)"
                   if dev_ms is None else
                   f"{dev_ms:.4f} ms on the device "
                   f"({b_ms / dev_ms:.3f} of the bound)")
                + f", plain {rec['plain_ms']:.4f} ms, library "
                f"{'n/a (no int8 cache)' if lib is None else f'{lib:.4f} ms'}"
                + ("" if lib is None else
                   f" ({rec['library_device_ms']} ms on the device)")
                + f", bound {b_ms:.4f} ms ({b_by}); device kernels "
                f"{rec['device_kernels']}")
            del q, k, v, sc
    return out


def flash_device_ms(torch, call, lib, kernel: str, label: str) -> dict:
    """A K4 call and scaled_dot_product_attention on the same inputs,
    device ms per call from torch.profiler traces (mean of 20 calls). One
    K4 call launches its own kernel (``kernel`` in its name) and nothing
    else: no fill, copy or second pass."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    own, other = (device_kernel_ms(torch, f, iters=20) for f in (call, lib))
    check(not own or (len(own) == 1 and kernel in next(iter(own))),
          f"[timing] flash_attention {label}: one call launches "
          f"{list(own)}, not its {kernel} kernel alone")
    return {"device_ms": sum(own.values()) if own else None,
            "device_kernels": {n.split("(")[0]: t for n, t in own.items()},
            "library_device_ms": sum(other.values()) if other else None,
            "library_kernels": {n.split("(")[0][:60]: t
                                for n, t in other.items()}}


def decode_device_ms(torch, call, name: str) -> dict:
    """K3's device ms per call from a torch.profiler trace (the int64
    kv_len the timing passes included), and the kernels one call launches:
    K3 launches one (two on its generic path) and nothing else, no
    conversion or fill."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split = device_kernel_ms(torch, call, iters=10)
    if not split:
        return {"device_ms": None, "device_kernels": {}}
    check(len(split) <= 2 and all("da::decode" in n for n in split),
          f"[timing] {name}: one call launches {list(split)}, not K3's "
          f"kernel alone")
    return {"device_ms": sum(split.values()),
            "device_kernels": {n.split("(")[0]: t for n, t in split.items()}}


class AttnRecorder:
    """Stands in for an attention ops module inside ``models.layers`` while
    the main path runs: notes the arguments that decide each K3/K4 call's
    work (shapes, dtypes, masks; K3's kv_len is kept on the card and read
    after the stream) and passes the call on to the real wrapper, which
    does its own launch counting."""

    def __init__(self, ops):
        self._ops = ops
        self.calls: list = []

    def flash_attention(self, q, k, v, *, causal=True, window=None,
                        prefix_len=0, q_offset=None, kv_valid_len=None):
        B, Lq, H, Dh = q.shape
        self.calls.append(("flash_attention", dict(
            B=B, Lq=Lq, Lkv=k.shape[1], H=H, Hkv=k.shape[2], Dh=Dh),
            _dtype_name(q.dtype), dict(causal=causal, window=window,
                                       prefix_len=prefix_len,
                                       q_offset=q_offset),
            None if kv_valid_len is None else kv_valid_len.clone()))
        return self._ops.flash_attention(
            q, k, v, causal=causal, window=window, prefix_len=prefix_len,
            q_offset=q_offset, kv_valid_len=kv_valid_len)

    def decode_attention(self, q, k_cache, v_cache, kv_len, *, k_scale=None,
                         v_scale=None):
        B, H, Dh = q.shape
        self.calls.append(("decode_attention", dict(
            B=B, H=H, Hkv=k_cache.shape[2], Dh=Dh), k_cache.shape[1],
            _dtype_name(q.dtype), k_scale is not None, kv_len.clone()))
        return self._ops.decode_attention(q, k_cache, v_cache, kv_len,
                                          k_scale=k_scale, v_scale=v_scale)

    def distinct(self) -> set:
        out = set()
        for c in self.calls:
            if c[0] == "flash_attention":
                _, shape, dt, kw, kvl = c
                out.add(("flash_attention", tuple(shape.items()), dt,
                         tuple(kw.items()),
                         None if kvl is None else tuple(kvl.tolist())))
            else:
                _, shape, Lc, dt, int8, kvl = c
                out.add(("decode_attention", tuple(shape.items()), Lc, dt,
                         int8, tuple(kvl.tolist())))
        return out


def phase_attention_main_shapes(torch, calls: set, seed: int) -> Agreement:
    """Every distinct K3/K4 call of the main path (served streams and
    engine-long), held against the plain version at its own shapes,
    dtypes, masks and kv lengths."""
    agree = Agreement()
    for i, c in enumerate(sorted(calls, key=repr)):
        if c[0] == "flash_attention":
            _, shape, dt, kw, kvl = c
            compare_flash(torch, agree, dict(shape), getattr(torch, dt),
                          seed + 1000 + i,
                          kv_valid_len=None if kvl is None else list(kvl),
                          **dict(kw))
        else:
            _, shape, Lc, dt, int8, kvl = c
            compare_decode(torch, agree, dict(shape), Lc, list(kvl),
                           getattr(torch, dt), int8, seed + 1000 + i)
    n_f = sum(c[0] == "flash_attention" for c in calls)
    log_agreement(f"distinct calls of the main path ({n_f} K4, "
                  f"{len(calls) - n_f} K3), each at its own arguments,",
                  agree)
    return agree


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


def phase_engine_consistency(torch, np, seed: int, kv_dtype: str) -> None:
    """Small-input reference check of the engine on the card, through K4
    and K3, reduced qwen3 in fp32. With the f32 KV cache, batched per-slot
    KV-cached decode gives the tokens of greedy decoding by full re-prefill
    (no cache). With the int8 cache, whose codes change what decode attends
    to, it gives the tokens of one-sequence decoding with its own int8
    cache."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ModelEngine
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    kv_dtype=kv_dtype)
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
    with torch.inference_mode():
        for p, out in zip(prompts, outs):
            seq = list(p)
            cache = lm.init_cache(cfg, 1, 32, device=DEV)
            logits, _ = lm.prefill(params, cfg, {"tokens": torch.tensor(
                [seq], device=DEV)}, cache)
            for i, t in enumerate(out):
                ref_tok = int(torch.argmax(logits[0]))
                check(ref_tok == t, f"[serve] {kv_dtype} KV: cached batched "
                                    f"decode disagrees with the reference "
                                    f"at token {i}")
                seq.append(t)
                if kv_dtype == "int8":
                    logits, cache = lm.decode_step(
                        params, cfg, torch.tensor([[t]], device=DEV), cache,
                        len(seq) - 1)
                else:
                    logits, _ = lm.prefill(params, cfg, {
                        "tokens": torch.tensor([seq], device=DEV)},
                        lm.init_cache(cfg, 1, 32, device=DEV))
    ref = ("one-sequence int8-cached decode" if kv_dtype == "int8"
           else "re-prefill greedy decoding")
    log(f"[serve] engine, {kv_dtype} KV: batched KV-cached decode == {ref} "
        f"(reduced qwen3, fp32, through K4/K3 on the card)")


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


def serve_once(torch, np, backend, models, recorder, att_recorders,
               seed: int) -> dict:
    from repro_torch.core import semantic_cache as SC
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import embedder as E, layers as L
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import GatewayRequest, ServingGateway
    ecfg, eparams, mcfg, mparams = models
    tok = HashTokenizer(vocab_size=ecfg.vocab_size, max_len=24)
    encode_ms: dict = {}      # batch size -> host ms of each E.encode

    def encode(ids, mask):
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = E.encode(eparams, ecfg, torch.tensor(ids, device=DEV),
                           torch.tensor(mask, device=DEV)).cpu().numpy()
        encode_ms.setdefault(len(ids), []).append(
            1e3 * (time.perf_counter() - t0))    # .cpu() synchronised
        return out

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
    zero_attention_launches()
    fallbacks0 = siso.cache.quant_fallbacks
    windows = WindowRecorder(siso.cache) if backend == "pallas_q8" else None
    SC.ctk_ops = recorder
    encode_ms.clear()
    t0 = time.perf_counter()
    with recorded_ops(L, att_recorders):
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
    encode_p50 = {b: statistics.median(t) for b, t in encode_ms.items()}
    launches = kern.launches
    att = attention_launches()
    rep = gw.report()
    check(rep["completed"] == len(stream) == len(done),
          f"[serve] {rep['completed']} of {len(stream)} completed")
    check(rep["served_cache"] > 0, "[serve] nothing served from the cache")
    check(rep["served_engine"] > 0, "[serve] nothing served by the engine")
    check(launches > 0, f"[serve] {name} was never launched")
    check(att["flash_attention"] > 0 and att["flash_attention_f32"] > 0
          and att["decode_attention"] > 0,
          f"[serve] attention kernels not launched: {att}")
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
        f"{name} launches={launches}; K4 launches="
        f"{att['flash_attention']} bf16 + {att['flash_attention_f32']} f32, "
        f"K3 launches={att['decode_attention']}; "
        f"centroids={n_cent}, mirror rows="
        f"{siso.cache._dev.pad if siso.cache._dev is not None else 0}; "
        f"refreshes={rep['refreshes']}; set-up {setup_s:.1f} s, "
        f"served in {serve_s:.1f} s; E.encode host ms (median) "
        + ", ".join(f"{encode_p50[b]:.3f} at B={b} ({len(encode_ms[b])} "
                    f"calls)" for b in sorted(encode_p50)))
    check(4 in encode_p50, "[serve] no batch of 4 was embedded")
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
            "attention_launches": att, "encode_ms_median": encode_p50,
            "other_kernel_launches": other.launches, **extra,
            "batches": len(stream) // 4, "served_s": serve_s,
            "setup_s": setup_s, "centroids": n_cent,
            "report": {k: v for k, v in rep.items()
                       if k not in ("theta_trace", "lam_trace")}}


# ---------------------------------------------------------------------------
# phase 5: engine-long, qwen3-14b at full depth on 4,096-token prompts
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_SLOTS, LONG_MAX, LONG_STEPS = 4096, 4, 8192, 16
ENGINE_RTOL = 0.05   # largest |kernel - plain| logit over the largest
                     # |plain| logit: bf16 activations through 40 layers of
                     # random weights round differently once an attention
                     # output moves by one bf16 ulp. Each K3/K4 call is
                     # also held against its plain version at its own
                     # arguments; this limit must fail a planted fault
                     # (one kv tile dropped from the last quarter of the
                     # prefill rows, every layer)


class swap_attention:
    """Within the block, ``models.layers`` runs its plain attention on CUDA
    tensors too (the reference the kernels are held against), or the given
    prefill attention in place of K4 (a planted fault)."""

    def __init__(self, L, flash=None):
        self.L = L
        self.fns = (flash or L.flash_attention_plain,
                    L.decode_attention_plain)

    def __enter__(self):
        L = self.L
        self.saved = (L.flash_attention, L.decode_attention)
        L.flash_attention, L.decode_attention = self.fns

    def __exit__(self, *exc):
        self.L.flash_attention, self.L.decode_attention = self.saved


class recorded_ops:
    """Within the block, ``models.layers`` reaches the kernels through the
    AttnRecorders, which note each call and pass it on."""

    def __init__(self, L, att_recorders):
        self.L, self.rec = L, att_recorders

    def __enter__(self):
        self.saved = (self.L.fa_ops, self.L.da_ops)
        self.L.fa_ops, self.L.da_ops = self.rec

    def __exit__(self, *exc):
        self.L.fa_ops, self.L.da_ops = self.saved


def trace_decode(torch, eng, toks, steps: int = 2) -> dict:
    """``steps`` decode steps under torch.profiler: the device's busy time
    per step (the union of the kernel and copy intervals the profiler
    records on the card) and the kernels that took the most of it. Empty
    where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            toks = eng.decode_active(toks)
        torch.cuda.synchronize()
    tr = device_summary(prof, steps)
    if not tr:
        return {}
    k3 = sum(t for n, t in tr["by_name_ms"].items() if "da::decode" in n)
    return {"steps": steps, "device_events": tr["device_events"],
            "busy_ms_per_step": tr["busy_ms"], "k3_ms_per_step": k3,
            "k3_share_of_busy": k3 / tr["busy_ms"],
            "top_kernels_ms_per_step": tr["top_kernels_ms"]}


def device_summary(prof, n: int) -> dict:
    """Per one of ``n`` repeats: the device's busy ms (the union of the
    kernel and copy intervals the profiler recorded on the card), ms by
    kernel name and the largest kernels. Empty without device events."""
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if str(e.device_type).endswith("CUDA"))
    if not dev:
        return {}
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in dev:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_events": len(dev), "busy_ms": busy / 1e3 / n,
            "by_name_ms": by_name,
            "top_kernels_ms": [(k[:120], t) for k, t in top]}


def trace_prefill(torch, eng, prompt) -> dict:
    """One prefill of ``prompt`` into slot 0 under torch.profiler: the
    device's busy ms, K4's ms (the ``flash_bf16`` launches) and its share
    of the busy time, and the largest kernels. Empty where the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill_into(0, prompt)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    tr = device_summary(prof, 1)
    if not tr:
        return {}
    k4 = sum(t for k, t in tr.pop("by_name_ms").items() if "flash_bf16" in k)
    return {"profiled_wall_ms": wall, "k4_ms": k4,
            "k4_share_of_busy": k4 / tr["busy_ms"], **tr}


def rel_diff(torch, a, b) -> float:
    a, b = a.float(), b.float()
    check(bool(torch.isfinite(a).all()), "[engine-long] non-finite logits")
    return float((a - b).abs().max() / b.abs().max())


def attention_launches():
    """K4's launches by dtype (the bf16 prefill; the f32 embedder and
    engine check) and K3's by cache."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    return {"flash_attention": (fa.flash_attention.launches
                                - fa.flash_attention.launches_f32),
            "flash_attention_f32": fa.flash_attention.launches_f32,
            "decode_attention": (da.decode_attention.launches
                                 - da.decode_attention.launches_int8),
            "decode_attention_int8": da.decode_attention.launches_int8}


def zero_attention_launches() -> None:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    fa.flash_attention.launches = fa.flash_attention.launches_f32 = 0
    da.decode_attention.launches = da.decode_attention.launches_int8 = 0


def phase_engine_long(torch, np, models, att_recorders, seed: int,
                      kv_dtype: str) -> dict:
    """Four 4,096-token prompts prefilled into a 4-slot engine (K4 on every
    layer), then 16 batched decode steps (K3 on every layer). The launch
    counters are zeroed before the prefills and before the decode steps and
    read after each, and the AttnRecorders note every K3/K4 call of those
    windows; the comparisons with the plain layers run outside them. The
    first prefill's last-position logits and the first decode step's
    logits are held against the plain layers at ENGINE_RTOL; with the bf16
    cache, a planted fault must exceed it. The comparison's decode step
    writes the new k/v at each slot's position, which the engine's own
    first step then overwrites with the same computation, so the engine's
    state is unchanged by it. Two more decode steps then run under the
    profiler (``trace_decode``): the device's busy time and idle share."""
    from repro_torch.models import layers as L, lm
    from repro_torch.serving.engine import ModelEngine
    mparams, mcfg = models[3], models[2]
    cfg = mcfg.replace(kv_dtype=kv_dtype)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT)
               for _ in range(LONG_SLOTS)]
    first = {"tokens": torch.tensor(prompts[0][None], device=DEV)}
    with torch.inference_mode():
        kl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
            cfg, 1, LONG_PROMPT, device=DEV))
        with swap_attention(L):
            pl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
                cfg, 1, LONG_PROMPT, device=DEV))
        rel_fault = None
        if kv_dtype == "bfloat16":
            def faulty(q, k, v, **kw):
                check(kw == {"causal": True}, f"[engine-long] prefill "
                                              f"attention called with {kw}")
                return flash_tile_dropped(torch, q, k, v)
            with swap_attention(L, flash=faulty):
                fl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
                    cfg, 1, LONG_PROMPT, device=DEV))
            rel_fault = rel_diff(torch, fl, pl)
            check(rel_fault > ENGINE_RTOL,
                  f"[engine-long] a planted attention fault moves the logits"
                  f" by {rel_fault:.4g} of the largest, within ENGINE_RTOL "
                  f"{ENGINE_RTOL}: the limit cannot see it")
            log(f"[engine-long] planted fault (one kv tile dropped from the "
                f"last quarter of the prefill rows, every layer): logits "
                f"move by {rel_fault:.4g} of the largest (limit "
                f"{ENGINE_RTOL})")
            del fl
    rel_prefill = rel_diff(torch, kl, pl)
    del kl, pl
    torch.cuda.empty_cache()
    eng = ModelEngine(mparams, cfg, n_slots=LONG_SLOTS, max_len=LONG_MAX,
                      device=DEV)
    torch.cuda.synchronize()
    zero_attention_launches()
    prefill_ms, toks = [], []
    with recorded_ops(L, att_recorders):
        for s, p in enumerate(prompts):
            t0 = time.perf_counter()
            toks.append(eng.prefill_into(s, p))
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
    launches = attention_launches()
    toks = np.asarray(toks, np.int64)
    with torch.inference_mode():
        pos = torch.tensor(eng.pos.astype(np.int64), device=DEV)
        tok = torch.tensor(toks, device=DEV)[:, None]
        kd, _ = lm.decode_step(mparams, cfg, tok, eng.cache, pos,
                               kv_len=pos + 1)
        with swap_attention(L):
            pd, _ = lm.decode_step(mparams, cfg, tok, eng.cache, pos,
                                   kv_len=pos + 1)
    rel_decode = rel_diff(torch, kd, pd)
    torch.cuda.synchronize()
    zero_attention_launches()
    decode_ms = []
    with recorded_ops(L, att_recorders):
        for _ in range(LONG_STEPS):
            t0 = time.perf_counter()
            toks = eng.decode_active(toks)
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    for k, v in attention_launches().items():
        launches[k] += v
    n = cfg.n_layers
    k3 = "decode_attention_int8" if kv_dtype == "int8" else "decode_attention"
    check(launches["flash_attention"] == LONG_SLOTS * n
          and launches[k3] == LONG_STEPS * n,
          f"[engine-long] {kv_dtype}: launches {launches}, expected "
          f"{LONG_SLOTS * n} K4 and {LONG_STEPS * n} {k3}")
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"[engine-long] {kv_dtype}: bad tokens {toks}")
    check(rel_prefill <= ENGINE_RTOL and rel_decode <= ENGINE_RTOL,
          f"[engine-long] {kv_dtype}: kernel vs plain logits differ by "
          f"{rel_prefill:.4g} (prefill) / {rel_decode:.4g} (decode) of the "
          f"largest logit, over {ENGINE_RTOL}")
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    rec = {"kv_dtype": kv_dtype, "prefill_ms": prefill_ms,
           "decode_ms": decode_ms,
           "prefill_ms_median": statistics.median(prefill_ms),
           "decode_ms_median": statistics.median(decode_ms),
           "rel_diff_prefill": rel_prefill, "rel_diff_decode": rel_decode,
           "rel_diff_planted_fault": rel_fault, "launches": launches, "kv_cache_bytes": kv_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"[engine-long] {kv_dtype} KV ({kv_bytes / 2**30:.2f} GiB cache): "
        f"{LONG_SLOTS} prompts of {LONG_PROMPT} tokens, prefill "
        f"{rec['prefill_ms_median']:.1f} ms per prompt (median; "
        f"{', '.join(f'{t:.1f}' for t in prefill_ms)}), {LONG_STEPS} decode "
        f"steps {rec['decode_ms_median']:.2f} ms per step (median); kernel vs "
        f"plain logits: largest difference {rel_prefill:.4g} (prefill) and "
        f"{rel_decode:.4g} (decode) of the largest logit (tolerance "
        f"{ENGINE_RTOL}); launches {launches}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")
    rec["trace"] = tr = trace_decode(torch, eng, toks)
    if not tr:
        log(f"[engine-long] {kv_dtype} KV: the profiler recorded no device "
            f"activity; device busy time not measured")
    else:
        busy = tr["busy_ms_per_step"]
        log(f"[engine-long] {kv_dtype} KV, profiled decode: device busy "
            f"{busy:.3f} ms per step ({tr['device_events']} device events "
            f"over {tr['steps']} steps), K3 {tr['k3_ms_per_step']:.3f} ms "
            f"of it ({tr['k3_share_of_busy']:.3f}), idle share "
            f"{1 - busy / rec['decode_ms_median']:.3f} of the unprofiled "
            f"median step; most device time: " + "; ".join(
                f"{n} {t:.3f} ms" for n, t in tr["top_kernels_ms_per_step"]))
    rec["prefill_trace"] = pt = trace_prefill(torch, eng, prompts[0])
    if not pt:
        log(f"[engine-long] {kv_dtype} KV: the profiler recorded no device "
            f"activity in a prefill; its split is not measured")
    else:
        log(f"[engine-long] {kv_dtype} KV, profiled prefill of "
            f"{LONG_PROMPT} tokens: device busy {pt['busy_ms']:.3f} ms "
            f"({pt['device_events']} device events, "
            f"{pt['profiled_wall_ms']:.1f} ms on the host clock); K4 {pt['k4_ms']:.3f} ms, "
            f"{pt['k4_share_of_busy']:.3f} of the busy time; most device "
            f"time: " + "; ".join(f"{n} {t:.3f} ms"
                                  for n, t in pt["top_kernels_ms"]))
    del eng
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 6: slo, the paper's four-system comparison and the live gateway
# ---------------------------------------------------------------------------

# (a) benchmarks/fig9_slo.py's configuration at the embedder's width
SIM_DIM, SIM_CLUSTERS, SIM_SEED = 768, 400, 9
SIM_TRAIN, SIM_TEST, SIM_CAPACITY, SIM_THETA = 8000, 800, 512, 0.86
SIM_STREAMS = ((10.0, 0.1), (8.0, 5.0))    # (rps, cv) of each test stream
SIM_RUNS = (("vllm", "vllm", None), ("gptcache", "gptcache", None),
            ("siso-nodta", "siso-nodta", "pallas"), ("siso", "siso", "pallas"),
            ("siso/dense", "siso", "dense"),
            ("siso/pallas_q8", "siso", "pallas_q8"))   # (key, kind, backend)
# (b) benchmarks/bench_slo.py's settings at the embedder's width
SLO_SLOTS, SLO_MAX_NEW, SLO_TICK_S, SLO_LAMBDA_WINDOW = 2, 6, 0.05, 2.0
SLO_CAPACITY, SLO_CLUSTERS, SLO_THETA = 160, 240, 0.86
SLO_TRAIN = 1200
SLO_TEST = 48       # bench_slo's 160, cut to keep the script near 240 s: a
                    # live request costs about 0.2 s of host time a system
SLO_S = 1.3 * SLO_MAX_NEW * SLO_TICK_S     # the paper's 1.3x zero-load rule
SLO_SCENARIOS = ("repeat_heavy", "topic_drift")
SLO_SYSTEMS = ("siso", "vectorcache", "nocache")


def topk_launches() -> dict:
    from repro_torch.kernels.cosine_topk import ops
    return {"cosine_topk": ops.cosine_topk.launches,
            "cosine_topk_q8": ops.cosine_topk_q8.launches}


def zero_topk_launches() -> None:
    from repro_torch.kernels.cosine_topk import ops
    ops.cosine_topk.launches = ops.cosine_topk_q8.launches = 0


def paraphrase_cosine(np, batch, theta: float) -> dict:
    """What a fixed theta can hit: cosine of the paraphrase pairs (same
    cluster) among a stream's first 2,000 queries."""
    v, c = batch.vectors[:2000], batch.cluster_ids[:2000]
    iu = np.triu_indices(len(v), 1)
    dup = (v @ v.T)[iu][(c[:, None] == c[None, :])[iu]]
    return {"pairs": int(len(dup)), "median": float(np.median(dup)),
            "p90": float(np.percentile(dup, 90)),
            "share_ge_theta": float((dup >= theta).mean())}


def phase_slo_simulator(torch, np) -> dict:
    """The paper's comparison (vLLM, GPTCache, SISO-NoDTA, SISO) through
    the discrete-event ServingSimulator over the analytic engine (qwen3-14b
    on one H100, concurrency 4), SISO on backend pallas (K1), then SISO
    again on dense and on pallas_q8 (K2 + exact rescore): the three
    backends must give equal SimResults. K1/K2 launch counters are zeroed
    after each bootstrap and read after the run's two test streams."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.serving.engine import AnalyticEngine, EngineModel
    from repro_torch.serving.simulator import (ServingSimulator,
                                               bootstrap_frontend,
                                               build_system)
    wl = SyntheticWorkload("quora", dim=SIM_DIM, n_clusters=SIM_CLUSTERS,
                           seed=SIM_SEED)
    train = wl.sample(SIM_TRAIN, rps=100)
    tests = [wl.sample(SIM_TEST, rps=rps, cv=cv) for rps, cv in SIM_STREAMS]
    model = EngineModel.from_config(get_config("qwen3-14b"), n_chips=1)
    L = model.e2e(float(np.mean(train.tokens_in)),
                  float(np.mean(train.tokens_out)))
    # the same workload at the reference bench's dim 32, for comparison
    dup_stats = {dim: paraphrase_cosine(np, b, SIM_THETA) for dim, b in (
        (SIM_DIM, train), (32, SyntheticWorkload(
            "quora", dim=32, n_clusters=SIM_CLUSTERS,
            seed=SIM_SEED).sample(2000, rps=100)))}
    for dim, st in dup_stats.items():
        log(f"[slo] sim workload at dim {dim}: {st['pairs']} paraphrase "
            f"pairs, cosine median {st['median']:.4f}, p90 {st['p90']:.4f}, "
            f"{st['share_ge_theta']:.4f} of them >= theta {SIM_THETA}")
    out, launches = {}, {"cosine_topk": 0, "cosine_topk_q8": 0}
    for key, kind, backend in SIM_RUNS:
        t0 = time.perf_counter()
        fe = build_system(kind, dim=SIM_DIM, capacity=SIM_CAPACITY,
                          theta_r=SIM_THETA, slo_latency=1.3 * L,
                          llm_latency=L, backend=backend or "dense",
                          device=DEV)
        bootstrap_frontend(fe, train)
        sim = ServingSimulator(AnalyticEngine(model, concurrency=4), fe)
        setup_s = time.perf_counter() - t0
        if backend is not None:
            st = fe.cache.centroids
            log(f"[slo] sim {key}: bootstrap kept {len(st)} centroids "
                f"(clustering at theta_C {fe.cfg.theta_c}), largest "
                f"cluster {int(st.cluster_size.max())}, "
                f"{int((st.cluster_size > 1).sum())} of more than one query")
        torch.cuda.synchronize()
        zero_topk_launches()
        t0 = time.perf_counter()
        res = [sim.run(t, name=kind) for t in tests]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = topk_launches()
        siso = backend is not None
        for fn, used in (("cosine_topk", backend == "pallas"),
                         ("cosine_topk_q8", backend == "pallas_q8")):
            check(n[fn] > 0 if used else n[fn] == 0,
                  f"[slo] {key}: {fn} launched {n[fn]} times")
            launches[fn] += n[fn]
        for r in res:
            vals = [r.hit_ratio, r.slo_attainment, r.mean_e2e, r.p99_e2e,
                    r.mean_wait, r.mean_quality, r.slo_weighted_quality]
            check(r.n == SIM_TEST and all(np.isfinite(vals))
                  and 0 <= r.hit_ratio <= 1 and 0 <= r.slo_attainment <= 1,
                  f"[slo] {key}: bad SimResult {r}")
            check(len(r.theta_trace) == (SIM_TEST if siso else 0),
                  f"[slo] {key}: theta trace length")
        out[key] = {"backend": backend, "wall_s": wall, "setup_s": setup_s,
                    "launches": n, "results": [dataclasses.asdict(r)
                                               for r in res]}
        for (rps, cv), r in zip(SIM_STREAMS, res):
            th = r.theta_trace or [float("nan")]
            log(f"[slo] sim {key:14s} rps={rps:g} cv={cv:g}: "
                f"hit={r.hit_ratio:.4f} slo={r.slo_attainment:.4f} "
                f"mean_e2e={r.mean_e2e:.4f} s p99={r.p99_e2e:.4f} s "
                f"quality={r.mean_quality:.4f} slo_quality="
                f"{r.slo_weighted_quality:.4f} theta=[{min(th):.2f},"
                f"{max(th):.2f}]")
        log(f"[slo] sim {key}: set-up {setup_s:.1f} s, two "
            f"streams in {wall:.1f} s; launches {n}")
    ref = out["siso"]["results"]
    for other in ("siso/dense", "siso/pallas_q8"):
        for i, (a, b) in enumerate(zip(ref, out[other]["results"])):
            for field, val in a.items():
                check(b[field] == val, f"[slo] stream {i}: siso on "
                                       f"{other.split('/')[1]} differs from "
                                       f"pallas in {field}")
    log(f"[slo] sim: siso on dense, pallas (K1) and pallas_q8 (K2 + exact "
        f"rescore) give equal SimResults on both streams (every field, "
        f"theta traces element for element); zero-load e2e L = {L:.4f} s "
        f"(qwen3-14b on one H100, analytic), SLO 1.3 L")
    return {"runs": out, "launches": launches, "zero_load_s": L,
            "paraphrase_cosine": dup_stats}


class VirtualClock:
    """Callable clock the gateway/scheduler read; the drive loop owns t."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def slo_drive(gw, clock, batch, vocab: int, seed: int = 0, chunk: int = 8,
              max_ticks: int = 200_000) -> None:
    """benchmarks/bench_slo.py's discrete-event drive loop: submit arrivals
    as they come due, one engine tick per SLO_TICK_S of virtual time
    (gw.submit's internal tick is billed too), jump idle gaps."""
    import numpy as np
    from repro_torch.serving.gateway import GatewayRequest
    rng = np.random.default_rng(seed)
    n = len(batch.vectors)
    toks = rng.integers(0, vocab, size=(n, 6)).astype(np.int32)
    i = 0
    for _ in range(max_ticks):
        if i >= n and not gw.sched.queue and not gw.sched.active:
            return
        due = []
        while i < n and batch.arrivals[i] <= clock.t:
            due.append(GatewayRequest(
                rid=i, model_tokens=toks[i], embed_tokens=batch.vectors[i],
                user_id=int(batch.user_ids[i]), max_new=SLO_MAX_NEW,
                answer_vec=batch.answers[i]))
            i += 1
        if due:
            for j in range(0, len(due), chunk):
                gw.submit(due[j: j + chunk], now=clock.t)
                clock.t += SLO_TICK_S          # submit ran one engine tick
        else:
            gw.step()
            clock.t += SLO_TICK_S
        if (not gw.sched.active and not gw.sched.queue and i < n
                and batch.arrivals[i] > clock.t):
            clock.t = float(batch.arrivals[i])
    raise PhaseError("[slo] drive loop exceeded max_ticks")


def phase_slo_gateway(torch, np, models, recorder, att_recorders,
                      seed: int) -> dict:
    """The live SLO harness: each scenario's stream through the real
    ServingGateway over qwen3-14b (the served weights) under a virtual
    clock, for SISO (ServingGateway.from_config, backend pallas),
    VectorCache and NoCache. Launch counters are zeroed after each
    bootstrap and read after the drive; the recorders note every K1, K3
    and K4 call for the re-checks at their own arguments."""
    from repro_torch.core import semantic_cache as SC
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import layers as L
    from repro_torch.serving import CacheFrontend
    from repro_torch.serving.baselines import NoCache, VectorCache
    from repro_torch.serving.config import (CacheConfig, RefreshConfig,
                                            ServingConfig)
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import ServingGateway
    from repro_torch.serving.simulator import bootstrap_frontend
    from repro_torch.serving.workloads import build_scenario
    mcfg, mparams = models[2], models[3]
    dim = SIM_DIM
    engine = ModelEngine(mparams, mcfg, n_slots=SLO_SLOTS, max_len=48,
                         device=DEV)
    out = {}
    launches = {"cosine_topk": 0, **{k: 0 for k in ATT_KEYS}}
    for name in SLO_SCENARIOS:
        scn = build_scenario(name, dim=dim, n_clusters=SLO_CLUSTERS,
                             seed=seed, n_train=SLO_TRAIN, n_test=SLO_TEST)
        out[name] = {"notes": scn.notes}
        for kind in SLO_SYSTEMS:
            clock = VirtualClock()
            embed = lambda vs: np.stack(vs)      # noqa: E731 pre-embedded
            if kind == "siso":
                # refresh_async=False and a deliberately wrong llm_latency,
                # as bench_slo: the live EMA must calibrate it
                cfg = ServingConfig(
                    cache=CacheConfig(dim=dim, answer_dim=dim,
                                      capacity=SLO_CAPACITY,
                                      theta_r=SLO_THETA, backend="pallas",
                                      dynamic_threshold=True),
                    refresh=RefreshConfig(async_pipeline=False),
                    slo_latency=SLO_S,
                    llm_latency=0.2 * SLO_MAX_NEW * SLO_TICK_S)
                gw = ServingGateway.from_config(cfg, engine=engine,
                                                embed_fn=embed, clock=clock)
                gw.frontend.threshold.lambda_window = SLO_LAMBDA_WINDOW
                check(gw.frontend.device == engine.device,
                      "[slo] the gateway's frontend is not on the engine's "
                      "device")
            else:
                fe = (NoCache() if kind == "nocache" else
                      VectorCache(dim, dim, SLO_CAPACITY, policy="lru",
                                  theta_r=SLO_THETA))
                gw = ServingGateway(fe, engine, embed_fn=embed, clock=clock,
                                    slo_latency=SLO_S)
            check(isinstance(gw.frontend, CacheFrontend),
                  f"[slo] {kind} is not a CacheFrontend")
            bootstrap_frontend(gw.frontend, scn.train)
            torch.cuda.synchronize()
            zero_topk_launches()
            zero_attention_launches()
            SC.ctk_ops = recorder
            t0 = time.perf_counter()
            try:
                with recorded_ops(L, att_recorders):
                    slo_drive(gw, clock, scn.test, mcfg.vocab_size,
                              seed=seed + 1)
                    torch.cuda.synchronize()
            finally:
                SC.ctk_ops = ops
            wall = time.perf_counter() - t0
            n = {**topk_launches(), **attention_launches()}
            rep = gw.report()
            check(rep["completed"] == SLO_TEST == len(gw.done)
                  and sorted(r.rid for r in gw.done) == list(range(SLO_TEST)),
                  f"[slo] {name}/{kind}: {rep['completed']} of {SLO_TEST} "
                  f"completed")
            for r in gw.done:
                if r.served_by == "engine":
                    check(len(r.out) == SLO_MAX_NEW and all(
                        0 <= t < mcfg.vocab_size for t in r.out),
                        f"[slo] {name}/{kind} rid {r.rid}: bad completion")
                check(r.answer is not None and r.answer.shape == (dim,)
                      and bool(np.isfinite(r.answer).all()),
                      f"[slo] {name}/{kind} rid {r.rid}: bad answer")
            check(n["cosine_topk_q8"] == 0 and n["flash_attention_f32"] == 0,
                  f"[slo] {name}/{kind}: unexpected launches {n}")
            if kind == "siso":
                check(rep["served_cache"] > 0 and rep["served_engine"] > 0,
                      f"[slo] {name}/siso: served {rep['served_cache']} from "
                      f"the cache, {rep['served_engine']} by the engine")
                check(n["cosine_topk"] > 0, f"[slo] {name}/siso: K1 was "
                                            f"never launched")
            else:
                check(n["cosine_topk"] == 0, f"[slo] {name}/{kind}: K1 ran")
            if rep["served_engine"]:
                check(n["flash_attention"] > 0 and n["decode_attention"] > 0,
                      f"[slo] {name}/{kind}: attention kernels not "
                      f"launched: {n}")
            for k in launches:
                launches[k] += n[k]
            th = [p[1] for p in rep.get("theta_trace", [])] or [float("nan")]
            row = {"hit_ratio": rep.get("hit_ratio", 0.0),
                   "slo_attainment": rep.get("slo_attainment"),
                   "served_cache": rep["served_cache"],
                   "served_engine": rep["served_engine"],
                   "mean_wait": rep.get("mean_wait"),
                   "theta_min": min(th), "theta_max": max(th),
                   "refreshes": rep["refreshes"], "wall_s": wall,
                   "virtual_s": clock.t, "launches": n,
                   "lookup": rep["lookup"]}
            out[name][kind] = row
            log(f"[slo] live {name:12s} {kind:11s}: hit="
                f"{row['hit_ratio']:.4f} slo={row['slo_attainment']:.4f} "
                f"cache/engine={row['served_cache']}/{row['served_engine']}"
                f" theta=[{row['theta_min']:.2f},{row['theta_max']:.2f}] "
                f"refreshes={row['refreshes']} lookup p50="
                f"{row['lookup']['p50_ms']:.3f} ms; {wall:.1f} s wall for "
                f"{clock.t:.2f} s virtual; launches {n}")
    del engine
    torch.cuda.empty_cache()
    return {"scenarios": out, "launches": launches}


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
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    strict_fp32()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {smi}")
    detail = {"nvidia_smi": smi}
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(reports)} kernels built in {build_s:.1f} s "
        f"(nvcc per source, in parallel)")
    detail["build_s"] = build_s
    for name in _build.KERNELS:
        _build.load(name)
    t = time.perf_counter()
    err = phase_kernels(torch, args.seed)
    agree = phase_attention_kernels(torch, args.seed)
    detail["planted_faults"] = phase_planted_faults(torch, args.seed)
    att_err = agree.err
    timing = phase_timing(torch, args.seed)
    timing.update(phase_attention_timing(torch, args.seed))
    detail.update(max_abs_err={**err, **att_err}, timing=timing,
                  kernels_s=time.perf_counter() - t)
    t = time.perf_counter()
    detail["cache"] = phase_cache(torch, np, args.seed)
    detail["cache_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for kv_dtype in ("float32", "int8"):
        phase_engine_consistency(torch, np, args.seed, kv_dtype)
    models = build_models(torch, args.layers, args.seed)
    recorder = CallRecorder(ops)
    att_rec = (AttnRecorder(fa_ops), AttnRecorder(da_ops))
    serve = {b: serve_once(torch, np, b, models, recorder, att_rec,
                           args.seed)
             for b in ("pallas", "pallas_q8")}
    detail["serve"] = serve
    detail["serve_s"] = time.perf_counter() - t
    t = time.perf_counter()
    long_runs = {kv: phase_engine_long(torch, np, models, att_rec,
                                       args.seed, kv)
                 for kv in ("bfloat16", "int8")}
    detail["engine_long"] = long_runs
    detail["engine_long_s"] = time.perf_counter() - t
    t = time.perf_counter()
    slo_sim = phase_slo_simulator(torch, np)
    sim_s = time.perf_counter() - t
    slo_live = phase_slo_gateway(torch, np, models, recorder, att_rec,
                                 args.seed)
    detail["slo"] = {"simulator": slo_sim, "gateway": slo_live}
    detail["slo_s"] = time.perf_counter() - t
    log(f"[slo] phase done in {detail['slo_s']:.1f} s (simulator "
        f"{sim_s:.1f} s, live gateway {detail['slo_s'] - sim_s:.1f} s)")
    main_err = phase_main_shapes(torch, recorder.calls, args.seed)
    check({c[0] for c in recorder.calls} == set(err),
          "[kernels] a kernel of the main path was never called")
    att_calls = att_rec[0].distinct() | att_rec[1].distinct()
    check({c[0] for c in att_calls} == {"flash_attention",
                                        "decode_attention"},
          "[kernels] an attention kernel of the main path was never called")
    check(any(c[0] == "decode_attention" and c[2] == LONG_MAX
              for c in att_calls),
          "[kernels] engine-long's K3 calls were not recorded")
    agree.merge(phase_attention_main_shapes(torch, att_calls, args.seed))
    err = {fn: max(err[fn], main_err[fn]) for fn in err}
    att_err = agree.err
    detail.update(max_abs_err={**err, **att_err},
                  bf16_limit_share=agree.share,
                  main_path_calls=sorted(recorder.calls),
                  main_path_attention_calls=sorted(att_calls, key=repr))

    main_b = 4      # the served batch size, the one the kernels line times
    for name in err:
        check(any(c[:3] == (name, main_b, N_ROWS) for c in recorder.calls),
              f"[kernels] {name}: the main path never ran B={main_b} at "
              f"N={N_ROWS}, the shape that is timed")
    replaces = {
        "cosine_topk": "src/repro/kernels/cosine_topk/kernel.py:49",
        "cosine_topk_q8": "src/repro/kernels/cosine_topk/kernel.py:98",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:19",
        "flash_attention_f32":
            "src/repro/kernels/flash_attention/kernel.py:19",
        "decode_attention": "src/repro/kernels/decode_attention/kernel.py:25",
        "decode_attention_int8":
            "src/repro/kernels/decode_attention/kernel.py:25"}
    sources = {
        "cosine_topk": "src/repro_torch/csrc/cosine_topk.cu",
        "cosine_topk_q8": "src/repro_torch/csrc/cosine_topk_q8.cu",
        "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
        "flash_attention_f32": "src/repro_torch/csrc/flash_attention.cu",
        "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
        "decode_attention_int8": "src/repro_torch/csrc/decode_attention.cu"}
    # launches on the main path: K1/K2 in their served stream and the slo
    # phase's runs; K3/K4 in both served streams, both engine-long runs and
    # the slo phase's live gateway
    launches = {"cosine_topk": serve["pallas"]["launches"]
                + slo_sim["launches"]["cosine_topk"]
                + slo_live["launches"]["cosine_topk"],
                "cosine_topk_q8": serve["pallas_q8"]["launches"]
                + slo_sim["launches"]["cosine_topk_q8"]}
    for name in att_err:
        launches[name] = sum(r["attention_launches"][name]
                             for r in serve.values()) + sum(
            r["launches"][name] for r in long_runs.values()) \
            + slo_live["launches"][name]
        check(launches[name] > 0, f"[kernels] {name} was never launched on "
                                  f"the main path")
    # timed at the main path's shapes: K1/K2 at the served batch; K4 at the
    # engine's 4,096-token prefill; K3 at engine-long's kv length
    timed = {name: next(r for r in timing[name] if r["B"] == main_b)
             for name in err}
    timed["flash_attention"] = timing["flash_attention/prefill"]
    timed["flash_attention_f32"] = timing["flash_attention/embedder"]
    timed["decode_attention"] = \
        timing[f"decode_attention/{LONG_MAX}/{LONG_PROMPT}"]
    timed["decode_attention_int8"] = \
        timing[f"decode_attention_int8/{LONG_MAX}/{LONG_PROMPT}"]
    all_err = {**err, **att_err}
    kernels = []
    for name, rec in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": all_err[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        for key in ("device_ms", "library_device_ms"):   # from the profiler
            if key in rec:
                kernels[-1][key] = rec[key]
    detail["total_s"] = time.perf_counter() - t_start
    log(f"[done] every phase passed in {detail['total_s']:.1f} s")
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
