#!/usr/bin/env python3
"""Device time of each CUDA kernel that one call of a port wrapper launches,
read from a ``torch.profiler`` trace, at the main path's shapes.

    python3 tools/trace_kernels.py [--src DIR] [--iters N] [--out DIR]
                                   [--only topk,prefill,decode,embed,local,ssm,bwd,k4,train]
                                   [--sass]

Traces K1 (f32 cosine top-k, k=1, early exit on, random queries so every
tile is needed) and K2 (int8 cosine top-C, k=16), both at B in {1, 4, 8,
32} over N=65,536 rows of dim 768 with 10% invalid holes, K4 (prefill
attention, bf16, causal, B=1, L=4,096, H=40/8, Dh=128) and K3 (decode attention, bf16 q, B=4, H=40/8,
Dh=128, bf16 and int8 caches; kv_len 4,096 in an 8,192-position cache,
engine-long's layout, and kv_len = Lc = 32,768, decode_32k; kv_len given
as int32 and as int64, the engine's type before and after the change that
makes it int32), with scaled_dot_product_attention beside bf16 K3 as a
yardstick; and the f32 K4 (``embed``) at the embedder's served shapes (B=4
and B=1, L=24, H=12, Dh=64, bidirectional), at L=64 (the tokenizer's
default length), at the reduced qwen3 engine check's causal shape and at
chip_smoke's longer f32 checks (B=2, L=300, H=8/2, Dh=128; B=1, L=4,096,
H=40/8, Dh=128), each beside scaled_dot_product_attention, with the host
us a call (median of 200) at the short shapes, the device time of an
empty kernel launched through ctypes on the current stream (the floor of
a call this small) and, from ``cuobjdump -sass``, the instruction mix of
each f32 K4 kernel and of its loops; and K1's shard-local mode
(``local``, ``cosine_top1_local``) at B=4 on four 16,384-row blocks of
dim 768 whose first 9,072 rows are valid (chip_smoke's S=4 shard of the
served mirror): one block every call, the four in turn, and the four in
turn with a 128 MB write between calls that evicts the 50 MB L2, each
with the number of kernel records the trace holds; and (``ssm``) the WKV6
recurrence at rwkv6-7b's prefill (B=1, L=2,048, H=64, K=V=64, bf16 r/k/v,
a zero state) beside its operations bound and at its decode step (B=4,
L=1, a carried state), K4 at zamba2-7b's prefill (B=1, L=4,096, H=32,
Dh=112, causal) and K3 at its decode (B=4, H=32, Dh=112, kv_len 4,096 of
8,192) beside its bytes bound and scaled_dot_product_attention; and
(``bwd``) the f32 attention backward at one-tile calls (the embedder's B
48 x 24, 12 heads of 64, bidirectional; G = 5 at 64 causal tokens; Dh 128
at 24): the one-pass kernel that ``flash_attention_bwd`` takes there
beside the tiled pair (a) and (b) launched on the same inputs, SDPA's
backward (autograd of scaled_dot_product_attention) and the whole
backward's bytes bound, with ptxas's registers and spills of every
one-pass instance (where this run built them) and the SASS mix of each;
and (``k4``) bf16 K4 at the 4,096-token causal prefill of qwen3-14b
(40/8 heads of 128), minicpm3-4b (40 heads, Dq 96 / Dv 64),
deepseek-v2-236b (128 heads, 192 / 128) and zamba2-7b (32 heads of 112),
each beside scaled_dot_product_attention and its operations bound, twice,
with two calls compared bit for bit; at qwen3's call also the unrouted
probe ``flash_attention_probe`` (flash_bf16_persistent at 128 / 128,
where the library has it) against the routed flash_bf16; then ptxas's
report of every bf16 forward instance; and (``train``) the training
path's backward modes at B 1 x 4,096 tokens: the bf16 attention backward
at qwen3-14b's 40/8 heads of 128, minicpm3-4b's 40 heads of (96, 64) and
deepseek-v2-236b's 128 of (192, 128), causal, and at paligemma-3b's 8/1
heads of 256 with its 256-token prefix, each (a) and (b) apart beside
SDPA's backward (where it takes the call) and the operations bound of its
products over the mask's pairs; K5-bwd at rwkv6-7b's 64 heads of 64
beside its operations bound, its first design and K5 without and with
checkpoint writes, in turns; then ptxas's lines of every bf16 backward
instance and of K5-bwd, and the HGMMA and FFMA counts of each bf16
backward instance's SASS.
For each call it prints every device kernel the call launched (pass 1
and pass 2 of K1/K2 apart, K3's casts and passes apart) with its
mean time per call; for K4 the achieved TFLOP/s of the causal half, for
K1, K2 and K3 the share of their bytes bound (3.35 TB/s) that their own
kernels reach and the host time a call takes to enqueue them.
``--sass`` also counts, from ``cuobjdump -sass`` of the built K1 and K2,
the instructions of each pass-1 kernel's row loop and the 16-byte loads a
lane starts in it before its first FFMA.
``--only`` picks groups of calls (default: all). ``--src`` names
the directory that holds the ``repro_torch`` package (default: this
checkout's ``src``), so an older tree can be traced with the same script;
a run builds only the kernel libraries its groups call.
Needs one CUDA card; writes DIR/trace_kernels.json (default results/).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, N_ROWS = 768, 65536
PREFILL = dict(B=1, L=4096, H=40, Hkv=8, Dh=128)
DECODE = dict(B=4, H=40, Hkv=8, Dh=128)
DECODE_CALLS = ((8192, 4096), (32768, 32768))   # (cache length, kv_len)
H100_BYTES_PER_S = 3.35e12
GROUPS = ("topk", "prefill", "decode", "embed", "local", "ssm", "bwd", "k4",
          "train")
H100_FP32_FLOPS = 67e12
TOPK_BATCHES = (1, 4, 8, 32)
H100_BF16_FLOPS = 989e12
# the groups that need each kernel library: a run builds only those
GROUP_LIBS = {"cosine_topk": {"topk", "local"}, "cosine_topk_q8": {"topk"},
              "decode_attention": {"decode", "ssm"}, "wkv6": {"ssm"},
              "flash_attention": {"prefill", "embed", "ssm", "bwd", "k4",
                                  "train"},
              "flash_attention_bwd": {"bwd", "train"},
              "wkv6_bwd": {"train"}}
# bf16 K4 at the main path's prefill calls (B 1, 4,096 causal tokens):
# (label, H, Hkv, Dq, Dv)
K4_CALLS = (("qwen3-14b", 40, 8, 128, 128), ("minicpm3-4b", 40, 40, 96, 64),
            ("deepseek-v2-236b", 128, 128, 192, 128),
            ("zamba2-7b", 32, 32, 112, 112))


def device_kernel_ms(torch, fn, iters: int = 10, warmup: int = 3,
                     attempts: int = 3) -> tuple[dict, dict]:
    """({device kernel name: ms per call of ``fn``}, {name: records}) from
    a profiler trace of ``iters`` calls, after ``warmup`` untraced ones.
    A kernel's ms per call is its mean over the records the trace holds,
    times the whole launches per call those records show (at least one):
    a trace can come back short of records, and a sum over ``iters``
    calls would then read short. Where the trace is whole this is the sum
    over the calls divided by ``iters``. A trace that holds no device
    record at all (the profiler can drop every record of a session,
    tools/profiler_probe.py) is taken again, ``attempts`` traces in all;
    both empty when none recorded device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total: dict = {}
    records: dict = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                name = e.name[:100]
                total[name] = total.get(name, 0.0) \
                    + (e.time_range.end - e.time_range.start) / 1e3
                records[name] = records.get(name, 0) + 1
        if records:
            break
    ms = {n: t / records[n] * max(1, records[n] // iters)
          for n, t in total.items()}
    order = sorted(ms, key=lambda n: -ms[n])
    return {n: ms[n] for n in order}, {n: records[n] for n in order}


def host_us_per_call(torch, fn, n: int = 50) -> float:
    """Host microseconds one call of ``fn`` takes to enqueue its work,
    over ``n`` calls that run back to back (the device lags behind)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def sass_row_loop(lib: str) -> dict:
    """For each pass-1 kernel (``sims_tile_*``) in the shared library
    ``lib``: the innermost loop that holds an FFMA and a global load, its
    instruction count, the 16-byte global loads before its first FFMA and
    its commonest opcodes, read from ``cuobjdump -sass``."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        name = f.split("\n", 1)[0].strip()
        if "sims_tile" not in name:
            continue
        ops = [(int(m.group(1), 16),
                re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip()))
               for m in re.finditer(r"/\*([0-9a-f]{4,5})\*/\s+(.*?);", f)]
        loops = []
        for addr, ins in ops:
            t = re.search(r"0x([0-9a-f]+)", ins) if ins.startswith("BRA") \
                else None
            if t and int(t.group(1), 16) < addr:
                body = [i for a, i in ops if int(t.group(1), 16) <= a <= addr]
                if any(i.startswith("FFMA") for i in body) and \
                        any(i.startswith("LDG") for i in body):
                    loops.append(body)
        if not loops:
            continue
        body = min(loops, key=len)
        first = next(n for n, i in enumerate(body) if i.startswith("FFMA"))
        out[name] = {
            "instructions": len(body),
            "ldg128_before_first_ffma": sum(
                1 for i in body[:first] if i.startswith("LDG") and ".128" in i),
            "opcodes": collections.Counter(
                i.split()[0] for i in body).most_common(8)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="results")
    ap.add_argument("--sass", action="store_true",
                    help="count K1/K2 pass-1 row-loop instructions")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of calls: "
                         + ", ".join(GROUPS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes {GROUPS}")
    import torch
    if not torch.cuda.is_available():
        print("trace_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.kernels.flash_attention import ops as fa
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}; src {args.src}",
          flush=True)
    need = only | ({"topk"} if args.sass else set())
    reports = _build.build([n for n in _build.KERNELS
                            if need & GROUP_LIBS.get(n, set(GROUPS))])
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"nvidia_smi": smi, "src": args.src}
    if args.sass:
        for name in ("cosine_topk", "cosine_topk_q8"):
            for fn, c in sass_row_loop(str(_build._lib_path(name))).items():
                res.setdefault("sass", {})[fn] = c
                print(f"[sass] {fn}: row loop of {c['instructions']} "
                      f"instructions, {c['ldg128_before_first_ffma']} "
                      f"LDG.128 before the first FFMA; {c['opcodes']}",
                      flush=True)
    if "topk" in only:
        trace_topk(torch, ops, g, args.iters, res)
    if "prefill" in only:
        trace_prefill(torch, fa, g, args.iters, res)
    if "decode" in only:
        trace_decode(torch, g, args.iters, res)
    if "embed" in only:
        trace_embed(torch, fa, _build, g, max(args.iters, 20), res)
    if "local" in only:
        trace_local(torch, ops, g, max(args.iters, 20), res)
    if "ssm" in only:
        trace_ssm(torch, fa, g, args.iters, res)
    if "bwd" in only:
        trace_bwd(torch, fa, _build, reports.get("flash_attention_bwd"), g,
                  max(args.iters, 20), res)
    if "k4" in only:
        trace_k4(torch, fa, _build, reports.get("flash_attention"), g,
                 max(args.iters, 20), res)
    if "train" in only:
        trace_train(torch, fa, reports, g, args.iters, res)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    (out / "trace_kernels.json").write_text(json.dumps(res, indent=1))
    return 0


def trace_topk(torch, ops, g, iters: int, res: dict) -> None:
    """K1 as served (k=1, early exit on at theta 0.95) and K2 as served
    (k=16, off) at B in {1, 4, 8, 32}, chip_smoke's timing shape: N=65,536
    unit rows of dim 768 with 10% invalid holes and random queries, so no
    query clears theta and every tile is needed. Per call: each device
    kernel's ms, the host us a call takes to enqueue them, and the bytes
    bound of the valid rows (K1 f32 rows, K2 codes + scales)."""
    rows = torch.nn.functional.normalize(
        torch.randn((N_ROWS, D), generator=g, device="cuda"), dim=1)
    valid = torch.rand((N_ROWS,), generator=g, device="cuda") > 0.1
    codes_np, scales_np, _ = ops.quantize_rows(rows.cpu().numpy())
    codes = torch.tensor(codes_np, device="cuda")
    scales = torch.tensor(scales_np, device="cuda")
    n_valid = int(valid.sum())
    for fn in ("cosine_topk", "cosine_topk_q8"):
        for B in TOPK_BATCHES:
            q = torch.nn.functional.normalize(
                torch.randn((B, D), generator=g, device="cuda"), dim=1)
            if fn == "cosine_topk":
                k, row_bytes = 1, 4 * D
                call = lambda: ops.cosine_topk(q, rows, k=k, valid=valid,
                                               theta=0.95, early_exit=True,
                                               return_hit=True)
            else:
                k, row_bytes = 16, D + 4
                call = lambda: ops.cosine_topk_q8(q, codes, scales, k=k,
                                                  valid=valid, theta=0.95,
                                                  return_hit=True)
            split, records = device_kernel_ms(torch, call, iters)
            own = sum(t for n, t in split.items() if "ctk::" in n)
            host_us = host_us_per_call(torch, call)
            nbytes = (B * D * 4 + N_ROWS + n_valid * row_bytes
                      + B * k * 8 + B)
            bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
            res[f"{fn}/B={B}"] = {
                "kernels_ms": split, "records": records, "kernel_ms": own,
                "all_ms": sum(split.values()), "launches": len(split),
                "host_us_per_call": host_us, "bound_ms": bound_ms,
                "share_of_bound": bound_ms / own if own else None}
            print(f"[trace] {fn} B={B} k={k}: " + "; ".join(
                f"{n} {t:.4f} ms" for n, t in split.items())
                + f"; own {own:.4f} ms in {len(split)} device kernels; "
                  f"host {host_us:.1f} us a call; bound {bound_ms:.4f} ms "
                  f"(bytes), share "
                  f"{bound_ms / own if own else float('nan'):.3f}",
                  flush=True)


def trace_local(torch, ops, g, iters: int, res: dict) -> None:
    """K1-local at B=4 on four (16,384, 768) blocks, the first 9,072 rows
    of each valid: every device kernel's mean ms a call and its record
    count, for one block every call, the blocks in turn, and the blocks in
    turn with the L2 evicted between calls (the eviction's own kernel is
    left out). The bytes bound counts the valid rows once."""
    S, pad, n_valid, B = 4, 16384, 9072, 4
    blocks = [torch.nn.functional.normalize(
        torch.randn((pad, D), generator=g, device="cuda"), dim=1)
        for _ in range(S)]
    valid = torch.zeros(pad, dtype=torch.bool, device="cuda")
    valid[:n_valid] = True
    q = torch.nn.functional.normalize(
        torch.randn((B, D), generator=g, device="cuda"), dim=1)
    evict = torch.empty(32 << 20, device="cuda")     # 128 MB
    bound_ms = 1e3 * (B * D * 4 + pad + n_valid * 4 * D + B * 8) \
        / H100_BYTES_PER_S
    for label, turn, flush in (("one block", False, False),
                               ("in turn", True, False),
                               ("in turn, L2 evicted", True, True)):
        calls = [0]

        def call():
            if flush:
                evict.zero_()
            ops.cosine_top1_local(q, blocks[calls[0] % S if turn else 0],
                                  valid)
            calls[0] += 1
        split, records = device_kernel_ms(torch, call, iters)
        ms = {n[:60]: t for n, t in split.items()
              if "ctk::" in n or "clamp" in n}
        count = {n[:60]: records[n] for n in split
                 if "ctk::" in n or "clamp" in n}
        own = sum(ms.values())
        res[f"cosine_top1_local/{label}"] = {
            "kernels_ms": ms, "records": count, "calls": iters,
            "kernel_ms": own, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / own if own else None}
        print(f"[trace] cosine_top1_local B={B}, {label}: " + "; ".join(
            f"{n} {t:.4f} ms ({count[n]} records of {iters} calls)"
            for n, t in ms.items()) + f"; own {own:.4f} ms; bound "
            f"{bound_ms:.4f} ms (bytes)", flush=True)


def trace_prefill(torch, fa, g, iters: int, res: dict) -> None:
    B, L, H, Hkv, Dh = (PREFILL[x] for x in ("B", "L", "H", "Hkv", "Dh"))
    q = torch.randn((B, L, H, Dh), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, L, Hkv, Dh), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    split, _ = device_kernel_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), iters)
    flops = 4.0 * B * H * Dh * L * (L + 1) // 2
    main_ms = max(split.values()) if split else float("nan")
    res["flash_attention/prefill"] = {"kernels_ms": split,
                                      "tflops": flops / main_ms / 1e9}
    print(f"[trace] flash_attention prefill {PREFILL} bf16 causal: " +
          "; ".join(f"{n} {t:.4f} ms" for n, t in split.items()) +
          f"; {flops / main_ms / 1e9:.1f} TFLOP/s", flush=True)


def trace_ssm(torch, fa, g, iters: int, res: dict) -> None:
    """WKV6 at rwkv6-7b's prefill (a zero state) and at its decode step (B
    4, L 1, a carried state; 32 layers a step); K4 and K3 at zamba2-7b's
    head dim 112, with SDPA beside K3. WKV6's bound counts the fp32 flops
    the function needs a (token, head), 5 K V + 3 K + 2 V, over 67
    TFLOP/s, and the bytes it moves once (r, k, v bf16; w, y f32; u; the
    state in and out) over 3.35 TB/s."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.wkv6 import ops as wkv6
    H, K = 64, 64
    for key, B, L, carried in (("wkv6/prefill", 1, 2048, False),
                               ("wkv6/decode", 4, 1, True)):
        r, k, v = (torch.randn((B, L, H, K), generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(-3.0 + 4.0 * torch.rand(
            (B, L, H, K), generator=g, device="cuda")))
        u = torch.randn((H, K), generator=g, device="cuda").bfloat16()
        s0 = torch.randn((B, H, K, K), generator=g, device="cuda") \
            if carried else torch.zeros((B, H, K, K), device="cuda")
        split, _ = device_kernel_ms(
            torch, lambda: wkv6.wkv6(r, k, v, w, u, s0), iters)
        own = sum(t for n, t in split.items() if "wkv6_fwd" in n)
        flops = B * L * H * (5.0 * K * K + 3 * K + 2 * K)
        nbytes = (3 * 2 + 4 + 4) * B * L * H * K + 2 * H * K \
            + 2 * 4 * B * H * K * K
        bound_ms = 1e3 * max(flops / H100_FP32_FLOPS,
                             nbytes / H100_BYTES_PER_S)
        res[key] = {"kernels_ms": split, "kernel_ms": own,
                    "bound_ms": bound_ms,
                    "share_of_bound": bound_ms / own if own else None}
        print(f"[trace] {key} B={B} L={L} H={H} K={K} bf16: " + "; ".join(
            f"{n} {t:.4f} ms" for n, t in split.items())
            + f"; bound {bound_ms:.4f} ms ({flops / 1e9:.4f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), share "
              f"{bound_ms / own if own else float('nan'):.3f}", flush=True)
        del r, k, v, w
    L, H, Dh = 4096, 32, 112
    q, k, v = (torch.randn((1, L, H, Dh), generator=g,
                           device="cuda").bfloat16() for _ in range(3))
    split, _ = device_kernel_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), iters)
    res["flash_attention/dh112"] = {"kernels_ms": split}
    print(f"[trace] flash_attention Dh 112 B=1 L={L} H={H} bf16 causal: "
          + "; ".join(f"{n} {t:.4f} ms" for n, t in split.items()),
          flush=True)
    Bd, Lc, n_kv = 4, 8192, 4096
    q = torch.randn((Bd, H, Dh), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((Bd, Lc, H, Dh), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    kv_len = torch.full((Bd,), n_kv, dtype=torch.int32, device="cuda")
    split, _ = device_kernel_ms(
        torch, lambda: da.decode_attention(q, k, v, kv_len), iters)
    nbytes = 2 * Bd * H * Dh * 2 + 2 * Bd * n_kv * H * Dh * 2 + Bd * 4
    bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
    own = sum(split.values())
    res["decode_attention/dh112"] = {
        "kernels_ms": split, "bound_ms": bound_ms,
        "share_of_bound": bound_ms / own if own else None}
    print(f"[trace] decode_attention Dh 112 B={Bd} H={H}/{H} Lc={Lc} "
          f"kv_len={n_kv} bf16: "
          + "; ".join(f"{n} {t:.4f} ms" for n, t in split.items())
          + f"; bound {bound_ms:.4f} ms (bytes), share "
            f"{bound_ms / own if own else float('nan'):.3f}", flush=True)
    mask = (torch.arange(Lc, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    split, _ = device_kernel_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask), iters)
    res["sdpa/dh112"] = {"kernels_ms": split, "all_ms": sum(split.values())}
    print("[trace] sdpa Dh 112 (the same call): " + "; ".join(
        f"{n} {t:.4f} ms" for n, t in split.items())
        + f"; total {sum(split.values()):.4f} ms", flush=True)


def trace_decode(torch, g, iters: int, res: dict) -> None:
    """K3 at engine-long's layout and at decode_32k, bf16 and int8 caches,
    kv_len int32 and int64; SDPA (bf16 cache, kv_len mask) beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import lm
    B, H, Hkv, Dh = (DECODE[x] for x in ("B", "H", "Hkv", "Dh"))
    for Lc, n_kv in DECODE_CALLS:
        q = torch.randn((B, H, Dh), generator=g, device="cuda").bfloat16()
        kf, vf = (torch.randn((B, Lc, Hkv, Dh), generator=g, device="cuda")
                  for _ in range(2))
        caches = {"bf16": (kf.bfloat16(), vf.bfloat16(), {})}
        (kq, ks), (vq, vs) = lm.kv_quant(kf), lm.kv_quant(vf)
        caches["int8"] = (kq, vq, {"k_scale": ks, "v_scale": vs})
        del kf, vf
        for mode, (k, v, sc) in caches.items():
            row = Hkv * Dh * k.element_size() + (Hkv * 2 if sc else 0)
            nbytes = 2 * B * H * Dh * 2 + 2 * B * n_kv * row + B * 4
            bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
            for idt in (torch.int32, torch.int64):
                kv_len = torch.full((B,), n_kv, dtype=idt, device="cuda")
                split, _ = device_kernel_ms(
                    torch, lambda: da.decode_attention(q, k, v, kv_len, **sc),
                    iters)
                own = sum(t for n, t in split.items() if "da::" in n)
                total = sum(split.values())
                host_us = host_us_per_call(
                    torch, lambda: da.decode_attention(q, k, v, kv_len, **sc))
                key = f"decode_attention/{mode}/Lc={Lc}/kv_len={n_kv}/" \
                      f"{str(idt).rsplit('.', 1)[-1]}"
                res[key] = {"kernels_ms": split, "kernel_ms": own,
                            "all_ms": total, "launches": len(split),
                            "host_us_per_call": host_us,
                            "bound_ms": bound_ms,
                            "share_of_bound": bound_ms / own if own else None}
                print(f"[trace] {key}: " + "; ".join(
                    f"{n} {t:.4f} ms" for n, t in split.items())
                    + f"; K3's own {own:.4f} ms, {len(split)} device "
                      f"kernels {total:.4f} ms; host {host_us:.1f} us a "
                      f"call; bound {bound_ms:.4f} ms "
                      f"(bytes), share "
                      f"{bound_ms / own if own else float('nan'):.3f}",
                      flush=True)
            if not sc:
                mask = (torch.arange(Lc, device="cuda")[None, :]
                        < n_kv)[:, None, None, :].expand(B, 1, 1, Lc)
                qt = q[:, :, None]
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                split, _ = device_kernel_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
                key = f"sdpa/bf16/Lc={Lc}/kv_len={n_kv}"
                res[key] = {"kernels_ms": split,
                            "all_ms": sum(split.values())}
                print(f"[trace] {key}: " + "; ".join(
                    f"{n} {t:.4f} ms" for n, t in split.items())
                    + f"; total {sum(split.values()):.4f} ms", flush=True)
        del q, caches


# f32 K4 calls: (label, shape, mask); the first two are the embedder's
# served calls (chip_smoke phase 4 encodes batches of 4 queries and each
# miss's answer alone), L=64 the tokenizer's default length, "engine-check"
# the reduced qwen3 fp32 engine check's longest prompt, the last two
# chip_smoke phase 2's longer f32 checks
EMBED_CALLS = (
    ("embed/B=4", dict(B=4, Lq=24, Lkv=24, H=12, Hkv=12, Dh=64),
     dict(causal=False)),
    ("embed/B=1", dict(B=1, Lq=24, Lkv=24, H=12, Hkv=12, Dh=64),
     dict(causal=False)),
    ("embed/L=64", dict(B=4, Lq=64, Lkv=64, H=12, Hkv=12, Dh=64),
     dict(causal=False)),
    ("engine-check", dict(B=1, Lq=15, Lkv=15, H=4, Hkv=4, Dh=16),
     dict(causal=True)),
    ("phase2/L=300", dict(B=2, Lq=300, Lkv=300, H=8, Hkv=2, Dh=128),
     dict(causal=True)),
    ("phase2/L=4096", dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=8, Dh=128),
     dict(causal=True)),
)
HOST_TIMED_MAX_L = 64        # host us a call only where the device is quick
LONG_ITERS = 3               # the longer checks: a call may take 25 ms
H100_FP32_FLOPS = 67e12


def host_us_median(torch, fn, n: int = 200) -> float:
    """Median host microseconds of one call of ``fn`` over ``n`` calls,
    each timed on its own (the enqueue; the device lags behind)."""
    import statistics
    import time
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(ts)


EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(long long gx, long long gy, long long gz,
                            void* stream) {
  empty_kernel<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)gz), 128, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launcher(torch, _build):
    """A call that launches an empty kernel through ctypes on the current
    stream, built with the port's nvcc flags into build/trace: the floor
    of any small launch."""
    import ctypes
    d = ROOT / "build" / "trace"
    d.mkdir(parents=True, exist_ok=True)
    src, lib = d / "empty.cu", d / "libempty.so"
    src.write_text(EMPTY_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lambda gx, gy, gz: fn(
        gx, gy, gz, torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()))


def sass_mix(lib: str, match: str) -> dict:
    """For each kernel of the shared library ``lib`` whose name holds
    ``match``: its instruction count and mix (FFMA, HGMMA, HMMA, scalar and
    16-byte shared and global loads, cp.async) over the whole function and
    over each loop (a backward branch) that holds an FFMA, from
    ``cuobjdump -sass``."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout

    def mix(body):
        def n(pred):
            return sum(1 for i in body if pred(i))
        return {"instructions": len(body),
                "top": collections.Counter(
                    i.split()[0] for i in body).most_common(12),
                "FFMA": n(lambda i: i.startswith("FFMA")),
                "HGMMA": n(lambda i: i.startswith("HGMMA")),
                "HMMA": n(lambda i: i.startswith("HMMA")),
                "LDS": n(lambda i: i.startswith("LDS")
                         and ".64" not in i and ".128" not in i),
                "LDS.64": n(lambda i: i.startswith("LDS") and ".64" in i),
                "LDS.128": n(lambda i: i.startswith("LDS") and ".128" in i),
                "LDG": n(lambda i: i.startswith("LDG.")
                         and ".128" not in i),
                "LDG.128": n(lambda i: i.startswith("LDG.") and ".128" in i),
                "LDGSTS": n(lambda i: i.startswith("LDGSTS")),
                "STG.128": n(lambda i: i.startswith("STG") and ".128" in i)}
    out = {}
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        name = f.split("\n", 1)[0].strip()
        if match not in name:
            continue
        ops = [(int(m.group(1), 16),
                re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip()))
               for m in re.finditer(r"/\*([0-9a-f]{4,5})\*/\s+(.*?);", f)]
        loops = []
        for addr, ins in ops:
            t = re.search(r"0x([0-9a-f]+)", ins) if ins.startswith("BRA") \
                else None
            if t and int(t.group(1), 16) < addr:
                body = [i for a, i in ops if int(t.group(1), 16) <= a <= addr]
                if any(i.startswith("FFMA") for i in body):
                    loops.append(mix(body))
        out[name] = {"function": mix([i for _, i in ops]), "loops": loops}
    return out


def trace_embed(torch, fa, _build, g, iters: int, res: dict) -> None:
    """The f32 K4 at EMBED_CALLS' shapes beside SDPA on the same inputs:
    device ms a call (mean of ``iters`` under torch.profiler; of
    LONG_ITERS past L=64), the
    kernels a call launches, host us a call (median of 200) at the short
    shapes, and the bound (bytes at 3.35 TB/s or f32 FMAs at 67 TFLOP/s).
    Then an empty kernel launched through ctypes at the embedder's grids,
    and the SASS mix of every f32 K4 kernel."""
    import torch.nn.functional as F
    for label, shape, kw in EMBED_CALLS:
        B, Lq, Lkv, H, Hkv, Dh = (shape[x] for x in
                                  ("B", "Lq", "Lkv", "H", "Hkv", "Dh"))
        q = torch.randn((B, Lq, H, Dh), generator=g, device="cuda")
        k, v = (torch.randn((B, Lkv, Hkv, Dh), generator=g, device="cuda")
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        call = lambda: fa.flash_attention(q, k, v, **kw)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"], enable_gqa=H != Hkv)
        n = iters if Lq <= HOST_TIMED_MAX_L else LONG_ITERS
        own, other = (device_kernel_ms(torch, f, n, warmup=1)[0]
                      for f in (call, lib))
        pairs = Lq * (Lq + 1) // 2 if kw["causal"] else Lq * Lkv
        nbytes = 4 * (2 * B * Lq * H * Dh + 2 * B * Lkv * Hkv * Dh)
        bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S,
                             4.0 * B * H * Dh * pairs / H100_FP32_FLOPS)
        rec = {"shape": shape, "mask": kw, "kernels_ms": own,
               "kernel_ms": sum(own.values()) if own else None,
               "launches": len(own), "library_kernels_ms": other,
               "library_ms": sum(other.values()) if other else None,
               "bound_ms": bound_ms}
        if Lq <= HOST_TIMED_MAX_L:
            rec["host_us_per_call"] = host_us_median(torch, call)
            rec["library_host_us_per_call"] = host_us_median(torch, lib)
        res[f"flash_attention_f32/{label}"] = rec
        print(f"[trace] flash_attention f32 {label} {shape} {kw}: " + "; ".join(
            f"{n} {t:.4f} ms" for n, t in own.items())
            + f"; {len(own)} device kernels; SDPA {rec['library_ms']:.4f} ms "
              f"in {list(other)}; bound {bound_ms:.4f} ms"
            + (f"; host {rec['host_us_per_call']:.1f} us a call (SDPA "
               f"{rec['library_host_us_per_call']:.1f})"
               if "host_us_per_call" in rec else ""), flush=True)
        del q, k, v, qt, kt, vt
    empty = empty_launcher(torch, _build)
    for B in (4, 1):
        split, _ = device_kernel_ms(torch, lambda: empty(1, 12, B), iters)
        host = host_us_median(torch, lambda: empty(1, 12, B))
        res[f"empty_kernel/grid=1x12x{B}"] = {
            "kernels_ms": split, "kernel_ms": sum(split.values()),
            "host_us_per_call": host}
        print(f"[trace] empty kernel, grid 1x12x{B} x 128 threads, through "
              f"ctypes: {sum(split.values()):.4f} ms on the device, host "
              f"{host:.1f} us a call", flush=True)
    lib_path = str(_build._lib_path("flash_attention"))
    for name, c in sass_mix(lib_path, "f32").items():
        res.setdefault("sass_f32", {})[name] = c
        print(f"[sass] {name[:90]}: whole {c['function']}; loops with FFMA: "
              + "; ".join(str(x) for x in c["loops"]), flush=True)


# (label, shape, causal) of the f32 backward's one-tile calls
BWD_CALLS = (("embedder", dict(B=48, L=24, H=12, Hkv=12, Dh=64), False),
             ("g5_l64", dict(B=4, L=64, H=40, Hkv=8, Dh=64), True),
             ("dh128_l24", dict(B=16, L=24, H=8, Hkv=8, Dh=128), False))


def ptxas_functions(report) -> dict:
    """{mangled name: its registers, static shared memory, stack and spill
    bytes} of every function of a build's ``-Xptxas -v`` report, with
    ``wgmma_serialized``, ptxas's warning, where it serialised the
    function's wgmma."""
    import re
    out, name = {}, None
    for line in (report or "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if "serialized" in line:
            m = re.search(r"(_Z\w+)", line)
            if m:
                out.setdefault(m.group(1), {})["wgmma_serialized"] = \
                    line.strip()
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return out


def trace_bwd(torch, fa, _build, report, g, iters: int, res: dict) -> None:
    """The f32 backward at BWD_CALLS: ``flash_attention_bwd`` (one launch
    of the one-pass kernel there), the tiled pair (a) and (b) on the same
    inputs through ``kernel.launch_bwd``, and SDPA's backward, each's
    device ms a call (mean of ``iters`` under torch.profiler) beside the
    whole backward's bound (q, k, v, o, do read and dq, dk, dv written
    once at 3.35 TB/s, or its five products at 67 TFLOP/s); then ptxas's
    lines and the SASS mix of every one-pass instance."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    for label, shape, causal in BWD_CALLS:
        B, L, H, Hkv, Dh = (shape[x] for x in ("B", "L", "H", "Hkv", "Dh"))
        q = torch.randn((B, L, H, Dh), generator=g, device="cuda")
        k, v = (torch.randn((B, L, Hkv, Dh), generator=g, device="cuda")
                for _ in range(2))
        o = fa.flash_attention(q, k, v, causal=causal)
        do = torch.randn(o.shape, generator=g, device="cuda")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        lse, dsum = K.bwd_scratch(q)
        one = lambda: fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
        pair = [lambda part=part: K.launch_bwd(
            q, k, v, o, do, dq, dk, dv, lse, dsum, causal=causal, window=0,
            prefix_len=0, q_offset=0, part=part) for part in (0, 1)]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=H != Hkv)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        own = device_kernel_ms(torch, one, iters)[0]
        tiled = {}
        for f in pair:
            tiled.update(device_kernel_ms(torch, f, iters)[0])
        other = device_kernel_ms(torch, lib, iters)[0]
        pairs = L * (L + 1) // 2 if causal else L * L
        nbytes = 4 * (4 * B * L * H * Dh + 4 * B * L * Hkv * Dh)
        bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S,
                             10.0 * B * H * Dh * pairs / H100_FP32_FLOPS)
        rec = {"shape": shape, "causal": causal, "kernels_ms": own,
               "kernel_ms": sum(own.values()) if own else None,
               "tiled_kernels_ms": tiled,
               "tiled_ms": sum(tiled.values()) if tiled else None,
               "library_kernels_ms": other,
               "library_ms": sum(other.values()) if other else None,
               "bound_ms": bound_ms}
        res[f"flash_attention_bwd_f32/{label}"] = rec
        print(f"[trace] flash_attention_bwd f32 {label} {shape} causal "
              f"{causal}: " + "; ".join(f"{n} {t:.4f} ms"
                                        for n, t in own.items())
              + f"; the tiled pair {rec['tiled_ms']:.4f} ms ("
              + "; ".join(f"{n} {t:.4f}" for n, t in tiled.items())
              + f"); SDPA's backward {rec['library_ms']:.4f} ms; bound "
                f"{bound_ms:.4f} ms", flush=True)
        del q, k, v, o, do, dq, dk, dv, qt, kt, vt, out, dot
    for name, r in ptxas_functions(report).items():
        if "bwd_one_pass" in name:
            res.setdefault("bwd_one_pass_ptxas", {})[name] = r
            print(f"[ptxas] {name}: {r}", flush=True)
    lib_path = str(_build._lib_path("flash_attention_bwd"))
    for name, c in sass_mix(lib_path, "one_pass").items():
        res.setdefault("sass_bwd_one_pass", {})[name] = c
        print(f"[sass] {name[:90]}: whole {c['function']}; loops with FFMA: "
              + "; ".join(str(x) for x in c["loops"]), flush=True)


def trace_k4(torch, fa, _build, report, g, iters: int, res: dict) -> None:
    """bf16 K4 at K4_CALLS (B 1, L 4,096, causal): each call's device ms
    beside scaled_dot_product_attention's on the same inputs and the bound
    (the causal half's products, 2 H (Dq + Dv) flops a (query, key) pair,
    at 989 TFLOP/s, or q, k, v and o once at 3.35 TB/s, the larger); two
    calls compared bit for bit; where the library has the unrouted probe
    entry ``flash_attention_probe`` (the Hopper template at a padded
    width), that too at qwen3's call. Then ptxas's registers, spills and
    serialisation warnings of every bf16 forward instance (where this run
    built the library)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    B, L = 1, 4096
    for label, H, Hkv, Dq, Dv in K4_CALLS:
        q = torch.randn((B, L, H, Dq), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, L, Hkv, Dq), generator=g,
                        device="cuda").bfloat16()
        v = torch.randn((B, L, Hkv, Dv), generator=g,
                        device="cuda").bfloat16()
        call = lambda: fa.flash_attention(q, k, v, causal=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != Hkv)
        pairs = L * (L + 1) // 2
        flops = 2.0 * B * H * (Dq + Dv) * pairs
        nbytes = 2 * B * L * (H * Dq + Hkv * Dq + Hkv * Dv + H * Dv)
        bound_ms = 1e3 * max(flops / H100_BF16_FLOPS,
                             nbytes / H100_BYTES_PER_S)
        own = device_kernel_ms(torch, call, iters)[0]
        lib = device_kernel_ms(torch, sdpa, iters)[0]
        again = device_kernel_ms(torch, call, iters)[0]
        same = bool(torch.equal(call(), call()))
        rec = {"H": H, "Hkv": Hkv, "Dq": Dq, "Dv": Dv, "kernels_ms": own,
               "kernel_ms": sum(own.values()) if own else None,
               "again_kernels_ms": again,
               "library_ms": sum(lib.values()) if lib else None,
               "bound_ms": bound_ms, "bit_identical": same}
        probe = _probe_entry(_build)
        if probe is not None and (Dq, Dv, Hkv) == (128, 128, 8):
            out = torch.empty((B, L, H, Dv), dtype=q.dtype, device="cuda")
            pcall = lambda: K.launch(q, k, v, out, None, causal=True,
                                     window=0, prefix_len=0, q_offset=0,
                                     strides=(), entry=probe)
            prob = device_kernel_ms(torch, pcall, iters)[0]
            pcall()
            ref_out = call()
            torch.cuda.synchronize()
            rec["probe_kernels_ms"] = prob
            rec["probe_ms"] = sum(prob.values()) if prob else None
            rec["probe_max_abs_diff"] = float(
                (out.float() - ref_out.float()).abs().max())
        res[f"k4/{label}"] = rec
        share = bound_ms / rec["kernel_ms"] if rec["kernel_ms"] else None
        print(f"[trace] k4 {label} B={B} L={L} H={H}/{Hkv} Dq={Dq} Dv={Dv} "
              f"bf16 causal: " + "; ".join(f"{n.split('(')[0]} {t:.4f} ms"
                                            for n, t in own.items())
              + f" (again {sum(again.values()):.4f}); SDPA "
                f"{rec['library_ms']:.4f} ms; bound {bound_ms:.4f} ms "
                f"(share {share:.3f}); repeats bit-identical {same}"
              + ("" if "probe_ms" not in rec else
                 f"; probe (Hopper template at 128/128) "
                 f"{rec['probe_ms']:.4f} ms in "
                 f"{[n.split('(')[0] for n in rec['probe_kernels_ms']]},"
                 f" max |probe - K4| {rec['probe_max_abs_diff']:.3g}"),
              flush=True)
        del q, k, v, qt, kt, vt
    for name, r in ptxas_functions(report).items():
        if "flash_bf16" in name:
            res.setdefault("k4_ptxas", {})[name] = r
            print(f"[ptxas] {name}: {r}", flush=True)


def _probe_entry(_build):
    """The unrouted probe entry of K4's library, or None where the library
    has none (an older tree)."""
    try:
        return _build.entry("flash_attention", "flash_attention_probe")
    except AttributeError:
        return None


# the training path's backward modes (label, H, Hkv, Dq, Dv, prefix_len), B 1
# x 4,096 causal bf16 tokens
TRAIN_CALLS = (("qwen3-14b", 40, 8, 128, 128, 0),
               ("minicpm3-4b", 40, 40, 96, 64, 0),
               ("deepseek-v2-236b", 128, 128, 192, 128, 0),
               ("paligemma-3b", 8, 1, 256, 256, 256))
WKV6_BWD = dict(B=1, L=4096, H=64, K=64)


def trace_train(torch, fa, reports, g, iters: int, res: dict) -> None:
    """The bf16 attention backward at TRAIN_CALLS, (a) and (b) apart through
    ``kernel.launch_bwd`` and the whole ``flash_attention_bwd`` call, beside
    SDPA's backward (is_causal, or a boolean mask with the prefix; none
    where SDPA refuses the call) and the operations bound of the products
    the outputs need over the mask's pairs (S, dP, dQ for (a); S, dP, dV,
    dK for (b); each over Dq or Dv) at 989 TFLOP/s; K5-bwd at WKV6_BWD
    (bf16 r, k, v, a zero state) from saved checkpoints beside its bound
    (14 K V fp32 flops a (token, head) at 67 TFLOP/s), its first design
    (``tools/wkv6_bwd_probe.py``) and K5 without and with checkpoint
    writes, in two rounds of opposite order; then ptxas's lines of every bf16
    backward instance and K5-bwd's, and the HGMMA and FFMA counts of
    every bf16 backward instance's SASS."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.wkv6 import ops as wo
    B, L = 1, 4096
    for label, H, Hkv, Dq, Dv, prefix in TRAIN_CALLS:
        q = torch.randn((B, L, H, Dq), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, L, Hkv, Dq), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, L, Hkv, Dv), generator=g, device="cuda").bfloat16()
        kw = dict(causal=True, prefix_len=prefix)
        o = fa.flash_attention(q, k, v, **kw)
        do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
        route = fa.bwd_route(torch.bfloat16, L, L, Dq, Dv)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        lse, dsum = K.bwd_scratch(q)
        saved = None
        if fa.saves_lse(torch.bfloat16, Dq, Dv):
            # the training path's call: (a) from the LSE K4's training
            # forward writes
            o, saved = fa._forward(q, k, v, True, None, prefix, 0, None,
                                   with_lse=True)
            lse = saved
        parts = {n: (lambda part=part: K.launch_bwd(
            q, k, v, o, do, dq, dk, dv, lse, dsum, causal=True, window=0,
            prefix_len=prefix, q_offset=0, part=part))
            for n, part in (("dq", 0 if saved is None else 3), ("dkv", 1))}
        pairs = L * (L + 1) // 2 + prefix * (prefix - 1) // 2
        pq, pv = 2.0 * B * H * Dq * pairs, 2.0 * B * H * Dv * pairs
        bound = {"dq": 1e3 * (2 * pq + pv) / H100_BF16_FLOPS,
                 "dkv": 1e3 * (2 * pq + 2 * pv) / H100_BF16_FLOPS}
        rec = {"H": H, "Hkv": Hkv, "Dq": Dq, "Dv": Dv, "prefix_len": prefix,
               "route": route, "bound_ms": bound}
        for n, f in parts.items():
            own = device_kernel_ms(torch, f, iters)[0]
            rec[f"{n}_kernels_ms"] = own
        whole = device_kernel_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, do, lse=saved, **kw), iters)[0]
        rec["kernels_ms"] = whole
        mask = None if not prefix else fr.attention_mask(
            L, L, causal=True, window=None, prefix_len=prefix, q_offset=0,
            kv_valid_len=None, device="cuda")[0]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        try:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=H != Hkv)
            dot = do.transpose(1, 2)
            other = device_kernel_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), iters)[0]
            rec["library_ms"] = sum(other.values()) if other else None
            del out, dot
        except RuntimeError as e:
            rec["library_ms"] = None
            rec["library_refused"] = str(e).splitlines()[0][:160]
        res[f"flash_attention_bwd/{label}"] = rec
        print(f"[trace] flash_attention_bwd bf16 {label} B 1 x {L}, {H}/"
              f"{Hkv} heads of {Dq}/{Dv}, causal, prefix {prefix} ({route}): "
              + "; ".join(f"({n}) " + ", ".join(
                  f"{x} {t:.4f} ms" for x, t in rec[f'{n}_kernels_ms'].items())
                  + f" (bound {bound[n]:.4f} ms)" for n in parts)
              + f"; the call {sum(whole.values()):.4f} ms; SDPA's backward "
              + ("refused" if rec["library_ms"] is None else
                 f"{rec['library_ms']:.4f} ms"), flush=True)
        del q, k, v, o, do, dq, dk, dv, lse, dsum, qt, kt, vt, saved
        torch.cuda.empty_cache()
    Bw, Lw, Hw, Kw = (WKV6_BWD[x] for x in "BLHK")
    r, kk, vv = (torch.randn((Bw, Lw, Hw, Kw), generator=g, device="cuda")
                 .bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((Bw, Lw, Hw, Kw), generator=g,
                                        device="cuda") * 4 - 3))
    u = torch.randn((Hw, Kw), generator=g, device="cuda")
    s0 = torch.zeros((Bw, Hw, Kw, Kw), device="cuda")
    dy = torch.randn((Bw, Lw, Hw, Kw), generator=g, device="cuda")
    ck = wo._forward(r, kk, vv, w, u, s0, ckpt=True)[2]
    sys.path.insert(0, str(ROOT))
    from tools.wkv6_bwd_probe import three_sweeps
    # K5-bwd from saved checkpoints, its first design, K5 without and
    # with checkpoint writes; two rounds, the second in reverse order
    calls = {"first design": lambda: three_sweeps(torch, r, kk, vv, w, u,
                                                  s0, dy),
             "K5-bwd": lambda: wo.wkv6_bwd(r, kk, vv, w, u, s0, dy,
                                           ckpt=ck),
             "K5": lambda: wo._forward(r, kk, vv, w, u, s0),
             "K5 with checkpoints": lambda: wo._forward(r, kk, vv, w, u, s0,
                                                        ckpt=True)}
    got = {n: [] for n in calls}
    for order in (list(calls), list(calls)[::-1]):
        for n in order:
            got[n].append(device_kernel_ms(torch, calls[n], iters)[0])
    bound = 1e3 * 14.0 * Bw * Lw * Hw * Kw * Kw / H100_FP32_FLOPS
    res["wkv6_bwd"] = {"shape": WKV6_BWD, "bound_ms": bound,
                       "kernels_ms": got}
    print(f"[trace] wkv6_bwd {WKV6_BWD} bf16 (bound {bound:.4f} ms, "
          f"operations), two readings each: " + "; ".join(
              f"{n}: " + " / ".join(", ".join(
                  f"{k.split('(')[0].replace('void ', '')} {t:.4f} ms"
                  for k, t in rd.items()) for rd in rds)
              for n, rds in got.items()), flush=True)
    for lib, key in (("flash_attention_bwd", "bf16"), ("wkv6_bwd", "wkvb")):
        for name, r in ptxas_functions(reports.get(lib)).items():
            if key in name:
                res.setdefault("train_ptxas", {})[name] = r
                print(f"[ptxas] {name}: {r}", flush=True)
    from repro_torch.kernels import _build
    lib = str(_build._lib_path("flash_attention_bwd"))
    for name, c in sass_mix(lib, "bf16").items():
        res.setdefault("train_sass", {})[name] = c["function"]
        print(f"[sass] {name[:80]}: HGMMA {c['function']['HGMMA']}, FFMA "
              f"{c['function']['FFMA']}, {c['function']['instructions']} "
              "instructions", flush=True)


if __name__ == "__main__":
    sys.exit(main())
