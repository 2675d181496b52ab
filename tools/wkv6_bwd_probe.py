#!/usr/bin/env python3
"""K5-bwd (``csrc/wkv6_bwd.cu``) on the card beside its first design and
its other grid, at rwkv6-7b's training call: the checks and the readings
behind PERF.md's K5-bwd rows.

    python3 tools/wkv6_bwd_probe.py [--iters N] [--rounds N] [--no-check]
                                    [--phases]

Builds the port's K5 and K5-bwd libraries, the first design of K5-bwd
(``tools/wkv6_bwd_three_sweeps.cu``: three sweeps over L, the forward
recurrence rerun for its own checkpoints; on no path of the port) and
``vc16``, a copy of ``csrc/wkv6_bwd.cu`` edited (``VARIANTS``) to run 16
state columns a CTA (4 CTAs a head at K 64) instead of 32, into
``build/``, and prints ptxas's registers and spills of each K5-bwd
instance and the tensor-core instructions (HMMA, HGMMA) in K5-bwd's SASS,
which must be none. Then, unless ``--no-check``, holds K5-bwd, ``vc16``
and the first design against ``ref.wkv6_bwd_ref`` over a sweep of shapes
(chip_smoke.py's ``wkv6_bwd_excess`` limit: 1e-5 of each gradient's
largest |gradient|, plus 2^-7 |plain| where both round to bf16), checks
that K5's y and final state are the same bits with and without
checkpoint writes, that its checkpoints match ``ref.wkv6_ckpt_ref``
within 1e-6 of the largest |state|, and that K5-bwd given them and given
none gives the same bits. Last, at B 1 x 4,096, 64 heads of 64, bf16
r/k/v and a zero state, it times each kernel alone by ``torch.profiler``
(device ms a call, the mean of ``--iters`` calls,
``tools/trace_kernels.py``'s ``device_kernel_ms``): K5 without and with
checkpoint writes, K5-bwd and ``vc16`` from saved checkpoints, and the
first design, ``--rounds`` rounds whose order alternates (first design,
K5-bwd, vc16, K5; then the reverse), and prints each one's median and
range. ``--phases`` also builds ``phases``, a copy with ``clock64()``
read at each phase of a chunk by thread 0 of head 0's first CTA, and
prints the SM cycles a call spends in each phase at the timed shape.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tools" / "wkv6_bwd_three_sweeps.cu"
TIMED = dict(B=1, L=4096, H=64, K=64)
# (B, L, H, K) for the checks: chip_smoke.py's WKV6_BWD_SWEEP
SWEEP = ((2, 1, 3, 64), (2, 17, 3, 64), (1, 100, 2, 16), (2, 33, 2, 40),
         (3, 50, 2, 24), (2, 33, 2, 17), (1, 300, 4, 64))
# shapes whose bf16 rows the tensor maps cannot take (K 20, 36: rows of 40
# and 72 bytes), and a view one element off, staged by cp.async
FALLBACK = ((2, 33, 3, 20), (1, 50, 2, 36))
RTOL, BF16_RTOL, CKPT_RTOL = 1e-5, 2.0 ** -7, 1e-6
H100_FP32_FLOPS = 67e12

# the phases of a chunk that ``phases`` times (compute warp 0, then the
# producer warp), and its edits: (text, the text with timer reads added)
PHASE_NAMES = ("ready_wait", "second_half", "barrier_wait", "epilogue",
               "first_half", "compute_sync", "push", "chunks",
               "producer_free_wait", "producer_copy_wait", "producer_widen",
               "producer_next_issue", "producer_cluster")
PHASE_EDITS = [
    ('#include "wkv6_common.cuh"\n',
     '#include "wkv6_common.cuh"\n__device__ unsigned long long '
     'wkvb_phase[16];\n#define TICK(v) long long v = clock64()\n'
     '#define ADD(e, v) atomicAdd(&wkvb_phase[e], (unsigned long long)(v))\n'),
    ("      if (i >= 2) bar_sync(B_FREE + buf, NT + 32);   // chunk i - 2 done\n",
     "      TICK(Q0);\n      if (i >= 2) bar_sync(B_FREE + buf, NT + 32);\n"
     "      TICK(Q1);\n"),
    ("      __syncwarp();\n      float* cf = conv + buf * F::CONV;\n",
     "      __syncwarp();\n      TICK(Q2);\n"
     "      float* cf = conv + buf * F::CONV;\n"),
    ("      __syncwarp();     // every lane has read the raw stage\n",
     "      TICK(Q3);\n      __syncwarp();     // every lane has read the raw "
     "stage\n"),
    ("      phase ^= 1;\n", "      phase ^= 1;\n      TICK(Q4);\n"),
    ("        cluster_wait();\n      }\n    }\n    cluster_arrive();\n",
     "        cluster_wait();\n      }\n      TICK(Q5);\n"
     "      if (lane == 0 && h == 0 && g == 0) {\n"
     "        ADD(8, Q1 - Q0);\n        ADD(9, Q2 - Q1);\n"
     "        ADD(10, Q3 - Q2);\n        ADD(11, Q4 - Q3);\n"
     "        ADD(12, Q5 - Q4);\n      }\n    }\n    cluster_arrive();\n"),
    ("    bar_sync(B_READY + buf, NT + 32);   // chunk i staged\n",
     "    TICK(T0);\n    bar_sync(B_READY + buf, NT + 32);   // chunk i staged\n"
     "    TICK(T1);\n"),
    ("    if (i > 0) {\n      cluster_wait();       // chunk i - 1's row sums "
     "are in place\n      epilogue(i - 1);\n",
     "    TICK(T2);\n    long long T3 = T2, T4 = T2;\n    if (i > 0) {\n"
     "      cluster_wait();       // chunk i - 1's row sums are in place\n"
     "      T3 = clock64();\n      epilogue(i - 1);\n      T4 = clock64();\n"),
    ("    states(std::integral_constant<int, 0>{});",
     "    TICK(T5);\n    states(std::integral_constant<int, 0>{});"),
    ("    bar_sync(B_COMPUTE, NT);\n    // each owner's rows",
     "    TICK(T6);\n    bar_sync(B_COMPUTE, NT);\n    TICK(T7);\n"
     "    // each owner's rows"),
    ("    cluster_arrive();\n  }\n  cluster_wait();\n  epilogue(nseq - 1);",
     "    TICK(T8);\n    if (tid == 0 && h == 0 && g == 0) {\n"
     "      ADD(0, T1 - T0);\n      ADD(1, T2 - T1);\n      ADD(2, T3 - T2);\n"
     "      ADD(3, T4 - T3);\n      ADD(4, T6 - T5);\n      ADD(5, T7 - T6);\n"
     "      ADD(6, T8 - T7);\n      ADD(7, 1);\n    }\n"
     "    cluster_arrive();\n  }\n  cluster_wait();\n  epilogue(nseq - 1);"),
]
PHASE_ENTRY = """
extern "C" int wkv6_bwd_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[16] = {};
    return (int)cudaMemcpyToSymbol(wkvb_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, wkvb_phase, sizeof(wkvb_phase));
}
"""
VARIANTS = {
    "vc16": [("constexpr int VC = 32;", "constexpr int VC = 16;")],
    "phases": PHASE_EDITS,
}

_loaded: dict = {}


def _nvcc(src: Path, lib: Path, include: Path | None = None) -> str:
    """Build ``src`` into ``lib`` with the port's nvcc flags; the ptxas
    report."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS]
    if include is not None:
        cmd += ["-I", str(include)]
    p = subprocess.run(cmd + ["-o", str(tmp), str(src)], capture_output=True,
                       text=True)
    if p.returncode:
        raise RuntimeError(f"{src.name}: build failed\n{p.stderr}")
    os.replace(tmp, lib)
    return p.stdout + p.stderr


def three_sweeps_entry():
    """The first design's C entry, built on first use next to the port's
    libraries; (function, ptxas report or None where an earlier run built
    it)."""
    from repro_torch.kernels import _build
    if "three_sweeps" in _loaded:
        return _loaded["three_sweeps"], None
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"libwkv6_bwd_three_sweeps-{h.hexdigest()[:16]}.so"
    report = None if lib.exists() else _nvcc(SRC, lib)
    P, L_, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = ctypes.CDLL(str(lib)).wkv6_bwd_three_sweeps
    fn.argtypes = [P] * 15 + [L_] * 12 + [I] * 5 + [P]
    fn.restype = ctypes.c_int
    _loaded["three_sweeps"] = fn
    return fn, report


def variant_entry(name: str):
    """Variant ``name`` of ``csrc/wkv6_bwd.cu`` (VARIANTS), built under
    build/wkv6_bwd_NAME: (its library, ptxas report)."""
    from repro_torch.kernels import _build
    if name in _loaded:
        return _loaded[name], None
    text = (_build.CSRC / "wkv6_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: an edit matches {text.count(old)} "
                             f"times, not once: {old[:60]!r}")
        text = text.replace(old, new)
    d = ROOT / "build" / f"wkv6_bwd_{name}"
    d.mkdir(parents=True, exist_ok=True)
    src = d / "wkv6_bwd.cu"
    src.write_text(text + (PHASE_ENTRY if name == "phases" else ""))
    report = _nvcc(src, d / f"libwkv6_bwd_{name}.so", _build.CSRC)
    so = ctypes.CDLL(str(d / f"libwkv6_bwd_{name}.so"))
    so.wkv6_bwd.argtypes = _build.KERNELS["wkv6_bwd"][2]
    so.wkv6_bwd.restype = ctypes.c_int
    _loaded[name] = so
    return so, report


def run_entry(torch, fn, xs, dy, ds, ck):
    """(dr, dk, dv, dw, du, d(state)) from a K5-bwd C entry ``fn`` at the
    port's arguments."""
    r, k, v, w, u, s = xs
    B, L, H, K = r.shape
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty((B, L, H, K), device=r.device),
        torch.empty((H, K), device=r.device),
        torch.empty((B, H, K, K), device=r.device)]
    dy = dy.float().contiguous()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.float().contiguous().data_ptr(), dy.data_ptr(),
            0 if ds is None else ds.contiguous().data_ptr(), ck.data_ptr(),
            *(o.data_ptr() for o in outs),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return tuple(outs)


def run_phases(torch, xs, dy, ck, iters: int) -> dict:
    """SM cycles a call of ``phases`` spends in each phase (its thread 0 of
    head 0's first CTA, the mean over ``iters`` calls)."""
    so, _ = variant_entry("phases")
    ph = so.wkv6_bwd_phases
    ph.argtypes, ph.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    host = (ctypes.c_ulonglong * 16)()
    ph(None, 1)
    for _ in range(iters):
        run_entry(torch, so.wkv6_bwd, xs, dy, None, ck)
    torch.cuda.synchronize()
    assert ph(ctypes.addressof(host), 0) == 0
    return {n: host[i] / iters for i, n in enumerate(PHASE_NAMES)}


def three_sweeps(torch, r, k, v, w, u, s, dy, ds=None):
    """The first design's (dr, dk, dv, dw, du, d(state)), as ``wkv6_bwd``
    returns them."""
    fn, _ = three_sweeps_entry()
    B, L, H, K = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, L, H, K), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty((B, L, H, K), **f32)
    du, ds_in = torch.empty((H, K), **f32), torch.empty((B, H, K, K), **f32)
    kp, ng, nc = -(-K // 8) * 8, -(-K // 32), -(-L // 16)
    scratch = torch.empty(B * H * ng * nc * kp * 32, **f32)
    dy = dy.float().contiguous()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.float().contiguous().data_ptr(), s.contiguous().data_ptr(),
            dy.data_ptr(), 0 if ds is None else ds.contiguous().data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), ds_in.data_ptr(), scratch.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, L, H, K, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"three_sweeps launch failed: CUDA error {rc}")
    return dr, dk, dv, dw, du, ds_in


def inputs(torch, B, L, H, K, dtype, seed, carried=True):
    """r, k, v in ``dtype``, w = exp(-exp(x)) over x in [-3, 1], u, a
    state (zero unless ``carried``), dy and ds, from one seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, L, H, K), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((B, L, H, K), generator=g,
                                        device="cuda") * 4 - 3))
    u = torch.randn((H, K), generator=g, device="cuda")
    s = torch.randn((B, H, K, K), generator=g, device="cuda") if carried \
        else torch.zeros((B, H, K, K), device="cuda")
    dy = torch.randn((B, L, H, K), generator=g, device="cuda")
    ds = torch.randn((B, H, K, K), generator=g, device="cuda")
    return (r, k, v, w, u, s), dy, ds


def excess(torch, got, plain) -> float:
    """The largest error of the six gradients over the limit."""
    out = 0.0
    for a, b in zip(got, plain):
        lim = RTOL * float(b.float().abs().max()) + (
            BF16_RTOL * b.float().abs() if a.dtype == torch.bfloat16 else 0)
        d = (a.float() - b.float()).abs()
        if float(d.max()):
            out = max(out, float((d / lim).max()))
    return out


def tensor_core_ops(lib: str) -> int:
    """HMMA and HGMMA instructions in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    return len(re.findall(r"\bHG?MMA\b", txt))


def check(torch, ops, ref) -> float:
    """K5-bwd, vc16 and the first design against the plain backward over
    SWEEP, f32 and bf16, with and without a final-state cotangent; K5's
    outputs with and without checkpoints; its checkpoints against the
    plain ones; K5-bwd from saved checkpoints against none. Returns the
    largest share of the limit; raises on a failure."""
    vc16 = variant_entry("vc16")[0].wkv6_bwd
    worst = 0.0
    for i, (B, L, H, K) in enumerate(SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            xs, dy, ds = inputs(torch, B, L, H, K, dtype, 100 + i)
            y0, s0 = ops.wkv6(*xs)
            y1, s1, ck = ops._forward(*xs, ckpt=True)
            assert torch.equal(y0, y1) and torch.equal(s0, s1), \
                ("K5's outputs move with checkpoint writes", B, L, H, K)
            want = ref.wkv6_ckpt_ref(xs[1], xs[2], xs[3], xs[5])
            err = float((ck - want).abs().max())
            assert err <= CKPT_RTOL * float(want.abs().max()), \
                ("checkpoints", B, L, H, K, err)
            for cot in (None, ds):
                plain = ref.wkv6_bwd_ref(*xs, dy, cot)
                runs = {"k5_bwd": ops.wkv6_bwd(*xs, dy, cot, ckpt=ck),
                        "vc16": run_entry(torch, vc16, xs, dy, cot, ck),
                        "three_sweeps": three_sweeps(torch, *xs, dy, cot)}
                none = ops.wkv6_bwd(*xs, dy, cot)
                assert all(torch.equal(a, b) for a, b in
                           zip(none, runs["k5_bwd"])), \
                    ("saved checkpoints and none differ", B, L, H, K)
                for name, got in runs.items():
                    x = excess(torch, got, plain)
                    worst = max(worst, x)
                    assert x <= 1.0, (name, B, L, H, K, dtype, x)
    for i, (B, L, H, K) in enumerate(FALLBACK + ((1, 40, 2, 64),)):
        xs, dy, ds = inputs(torch, B, L, H, K, torch.bfloat16, 200 + i)
        if K == 64:         # r, k, v one element off their allocations
            xs = tuple(torch.cat([x, x[..., :1]], -1)[..., 1:]
                       if j < 3 else x for j, x in enumerate(xs))
        plain = ref.wkv6_bwd_ref(*xs, dy, ds)
        got = ops.wkv6_bwd(*xs, dy, ds)
        x = excess(torch, got, plain)
        worst = max(worst, x)
        assert x <= 1.0, ("fallback", B, L, H, K, x)
    torch.cuda.synchronize()
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv6_bwd_probe.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as K, ops, ref
    from tools.trace_kernels import device_kernel_ms, ptxas_functions
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    reports = _build.build(["wkv6", "wkv6_bwd"])
    names = ["vc16"] + (["phases"] if args.phases else [])
    for lib, rep in (("wkv6_bwd", reports.get("wkv6_bwd")),
                     ("wkv6", reports.get("wkv6")),
                     ("three_sweeps", three_sweeps_entry()[1]),
                     *((n, variant_entry(n)[1]) for n in names)):
        for name, r in ptxas_functions(rep).items():
            print(f"[ptxas] {lib}: {name}: {r}", flush=True)
    n_tc = tensor_core_ops(str(_build._lib_path("wkv6_bwd")))
    print(f"[sass] wkv6_bwd: {n_tc} HMMA/HGMMA instructions", flush=True)
    if n_tc:
        return 1
    if not args.no_check:
        worst = check(torch, ops, ref)
        print(f"[check] K5-bwd, vc16 and the first design agree with "
              f"wkv6_bwd_ref over {len(SWEEP)} shapes x f32/bf16 x with and "
              f"without ds, K5-bwd also at {FALLBACK} bf16 and on a view "
              f"one element off (cp.async staging; largest share of the "
              f"limit {worst:.3g}); K5's "
              f"y and state the same bits with checkpoint writes; its "
              f"checkpoints within {CKPT_RTOL} of wkv6_ckpt_ref; saved "
              f"checkpoints and none the same bits", flush=True)
    B, L, H, Kd = (TIMED[x] for x in "BLHK")
    xs, dy, _ = inputs(torch, B, L, H, Kd, torch.bfloat16, 7, carried=False)
    r, k, v, w, u, s = xs
    y, s_out = (torch.empty((B, L, H, Kd), device="cuda"),
                torch.empty_like(s))
    ck = K.ckpt_buffer(r)
    vc16 = variant_entry("vc16")[0].wkv6_bwd
    calls = {
        "three_sweeps": lambda: three_sweeps(torch, *xs, dy),
        "k5_bwd": lambda: ops.wkv6_bwd(*xs, dy, ckpt=ck),
        "vc16": lambda: run_entry(torch, vc16, xs, dy, None, ck),
        "k5": lambda: K.launch(r, k, v, w, u, s, y, s_out),
        "k5_ckpt": lambda: K.launch(r, k, v, w, u, s, y, s_out, ck)}
    calls["k5_ckpt"]()
    keys = {n: "wkv6_fwd" if n.startswith("k5") and "bwd" not in n
            else "wkv6_bwd" for n in calls}
    got = {n: [] for n in calls}
    order = list(calls)
    for i in range(args.rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            own = device_kernel_ms(torch, calls[name], args.iters)[0]
            kern = {n: t for n, t in own.items() if keys[name] in n}
            assert len(kern) == 1, (name, list(own))
            got[name].append(next(iter(kern.values())))
    bound = 1e3 * 14.0 * B * L * H * Kd * Kd / H100_FP32_FLOPS
    for name, ts in got.items():
        med = statistics.median(ts)
        share = "" if name.startswith("k5") and "bwd" not in name else \
            f", {bound / med:.3f} of the bound"
        print(f"[time] {name} B {B} x {L}, {H} heads of {Kd}, bf16: median "
              f"{med:.4f} ms on the device (range {min(ts):.4f}-"
              f"{max(ts):.4f}, {len(ts)} readings of {args.iters} calls"
              f"{share}); readings {[round(t, 4) for t in ts]}", flush=True)
    if args.phases:
        cyc = run_phases(torch, xs, dy, ck, args.iters)
        print("[phases] SM cycles a call: " + ", ".join(
            f"{n} {c:.0f}" for n, c in cyc.items()), flush=True)
    med = {n: statistics.median(ts) for n, ts in got.items()}
    print(f"[time] K5-bwd's bound {bound:.4f} ms (operations); K5's "
          f"checkpoint writes cost {med['k5_ckpt'] - med['k5']:.4f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
