#!/usr/bin/env python3
"""Device time of each CUDA kernel that one call of a port wrapper launches,
read from a ``torch.profiler`` trace, at the main path's shapes.

    python3 tools/trace_kernels.py [--src DIR] [--iters N] [--out DIR]

Traces K1 (f32 cosine top-k, B=4, k=1, early exit on, random queries so
every tile is needed), K2 (int8 cosine top-C, B in {1, 4, 8, 32}, k=16)
over N=65,536 rows of dim 768, and K4 (prefill attention, bf16, causal,
B=1, L=4,096, H=40/8, Dh=128). For each call it prints every device kernel
the call launched (pass 1 and pass 2 of K1/K2 apart) with its mean time per
call, and for K4 the achieved TFLOP/s of the causal half. ``--src`` names
the directory that holds the ``repro_torch`` package (default: this
checkout's ``src``), so an older tree can be traced with the same script.
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


def device_kernel_ms(torch, fn, iters: int = 10, warmup: int = 3) -> dict:
    """{device kernel name: mean ms per call of ``fn``} from a profiler
    trace of ``iters`` calls, after ``warmup`` untraced ones. Empty when
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = e.name[:100]
            out[name] = out.get(name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
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
    _build.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.nn.functional.normalize(
        torch.randn((N_ROWS, D), generator=g, device="cuda"), dim=1)
    valid = torch.rand((N_ROWS,), generator=g, device="cuda") > 0.1
    codes_np, scales_np, _ = ops.quantize_rows(rows.cpu().numpy())
    codes = torch.tensor(codes_np, device="cuda")
    scales = torch.tensor(scales_np, device="cuda")
    res = {"nvidia_smi": smi, "src": args.src}
    calls = [("cosine_topk", 4)] + [("cosine_topk_q8", b)
                                     for b in (1, 4, 8, 32)]
    for fn, B in calls:
        q = torch.nn.functional.normalize(
            torch.randn((B, D), generator=g, device="cuda"), dim=1)
        if fn == "cosine_topk":
            call = lambda: ops.cosine_topk(q, rows, k=1, valid=valid,
                                           theta=0.95, early_exit=True,
                                           return_hit=True)
        else:
            call = lambda: ops.cosine_topk_q8(q, codes, scales, k=16,
                                              valid=valid, theta=0.95,
                                              return_hit=True)
        split = device_kernel_ms(torch, call, args.iters)
        res[f"{fn}/B={B}"] = split
        print(f"[trace] {fn} B={B}: " + "; ".join(
            f"{n} {t:.4f} ms" for n, t in split.items()), flush=True)
    B, L, H, Hkv, Dh = (PREFILL[x] for x in ("B", "L", "H", "Hkv", "Dh"))
    q = torch.randn((B, L, H, Dh), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, L, Hkv, Dh), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    split = device_kernel_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), args.iters)
    flops = 4.0 * B * H * Dh * L * (L + 1) // 2
    main_ms = max(split.values()) if split else float("nan")
    res["flash_attention/prefill"] = {"kernels_ms": split,
                                      "tflops": flops / main_ms / 1e9}
    print(f"[trace] flash_attention prefill {PREFILL} bf16 causal: " +
          "; ".join(f"{n} {t:.4f} ms" for n, t in split.items()) +
          f"; {flops / main_ms / 1e9:.1f} TFLOP/s", flush=True)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    (out / "trace_kernels.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
