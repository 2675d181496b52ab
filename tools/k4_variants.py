#!/usr/bin/env python3
"""Time edited copies of bf16 K4 (``csrc/flash_attention.cu``) beside the
tree they come from: the probes and design alternatives behind PERF.md's
K4 findings.

    python3 tools/k4_variants.py [--src DIR] [--out DIR] NAME [NAME ...]

Each NAME copies ``DIR/repro_torch`` (default: this checkout's ``src``)
into ``build/k4_variants/NAME/src``, applies that variant's text edits
to its ``flash_attention.cu`` (each must match exactly once, or the run
stops), builds the library there, and traces it with
``tools/trace_kernels.py --src ... --only k4`` in a process of its own
(two libraries that define kernels of one name cannot share a process).
The name ``base`` takes the tree unedited. Variants of the parent tree
(``parent-*``) apply to ``git archive 5b61b15`` (the tree before
``flash_bf16_persistent``), unpacked with ``--src``; the others to this
tree. ``profile`` also runs the instrumented kernel once at minicpm3's,
zamba2's and deepseek-v2's 4,096-token prefill and prints each
consumer's clocks an iteration of its kv loop, split by phase (lane 0 of
each consumer's first warp, summed over the CTAs). Builds start
together; traces run one after another. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# -- edits of the parent tree (flash_bf16 alone) ----------------------------
PARENT_SOFTMAX_STUB = [(
    "    auto softmax = [&](int k0) {\n",
    "    auto softmax = [&](int k0) {\n"
    "      if (k0 >= 0) {          // probe: the softmax stubbed, P = S\n"
    "#pragma unroll\n"
    "        for (int kk = 0; kk < BK / 16; ++kk)\n"
    "#pragma unroll\n"
    "          for (int j = 0; j < 4; ++j)\n"
    "            pf[kk][j] = pack_bf16(s[8 * kk + 2 * j],"
    " s[8 * kk + 2 * j + 1]);\n"
    "        return;\n"
    "      }\n")]
PARENT_PRODUCTS_STUB = [
    ("    auto gemm_s = [&](int st) {\n",
     "    auto gemm_s = [&](int st) {\n"
     "      if (st >= 0) return;    // probe: the products stubbed\n"),
    ("    auto gemm_pv = [&](int st) {\n",
     "    auto gemm_pv = [&](int st) {\n"
     "      if (st >= 0) return;    // probe: the products stubbed\n")]
PARENT_HEADS_GROUPED = [
    ("  const int qt = gridDim.z - 1 - blockIdx.z;\n"
     "  const int h = blockIdx.x, b = blockIdx.y;",
     "  const int qt = gridDim.x - 1 - blockIdx.x;   // probe: heads grouped\n"
     "  const int h = blockIdx.z, b = blockIdx.y;"),
    ("  dim3 grid(a.H, a.B, (a.Lq + BQ - 1) / BQ);\n"
     "  flash_bf16<DQ, DV, BK><<<",
     "  dim3 grid((a.Lq + BQ - 1) / BQ, a.B, a.H);\n"
     "  flash_bf16<DQ, DV, BK><<<")]

# -- edits of this tree (flash_bf16_persistent) -----------------------------
EXP2_FMA = (
    "__device__ __forceinline__ void wgmma_wait1() {",
    "// 2^x, x finite and <= 0, on the FMA pipe: j = rint(x) by the 1.5 *\n"
    "// 2^23 shift, 2^(x - j) by a cubic (relative error 7.5e-5), j added\n"
    "// to the exponent\n"
    "__device__ __forceinline__ float exp2_fma(float x) {\n"
    "  x = fmaxf(x, -126.f);\n"
    "  const float t = x + 12582912.f;\n"
    "  const float f = x - (t - 12582912.f);\n"
    "  const float p = fmaf(fmaf(fmaf(0.0551716685f, f, 0.2426111400f), f,\n"
    "                            0.6932609677f), f, 0.9999280572f);\n"
    "  return __uint_as_float(__float_as_uint(p) +"
    " (__float_as_uint(t) << 23));\n"
    "}\n\n"
    "__device__ __forceinline__ void wgmma_wait1() {")


def fma_exp2(n: int) -> list:
    """n of every 8 exp2 of a full tile on the FMA pipe at Dv 64."""
    return [EXP2_FMA, (
        "      if (!tile_full(a, wq_lo, wq_hi, k0, k0 + BK, T.kvlim)) {",
        "      const bool full = tile_full(a, wq_lo, wq_hi, k0, k0 + BK,"
        " T.kvlim);\n      if (!full) {"), (
        "#pragma unroll\n"
        "      for (int i = 0; i < BK / 2; ++i) {\n"
        "        s[i] = ex2(fmaf(s[i], sl2, -safe[(i >> 1) & 1]));\n"
        "        ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];\n"
        "      }",
        f"      constexpr int EMU = DV <= 64 ? {n} : 0;\n"
        "      if (EMU > 0 && full) {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < BK / 2; ++i) {\n"
        "          const float x = fmaf(s[i], sl2, -safe[(i >> 1) & 1]);\n"
        "          s[i] = i % 8 < EMU ? exp2_fma(x) : ex2(x);\n"
        "          ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];\n"
        "        }\n"
        "      } else {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < BK / 2; ++i) {\n"
        "          s[i] = ex2(fmaf(s[i], sl2, -safe[(i >> 1) & 1]));\n"
        "          ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];\n"
        "        }\n"
        "      }")]


RESCALE_SKIP = [(
    "#pragma unroll\n"
    "        for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n"
    "        pack();\n"
    "        pst = st;",
    "        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))"
    " {\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n"
    "        }\n"
    "        pack();\n"
    "        pst = st;")]
# Q and K loaded by thread 0, V by thread 32 of the producer warpgroup
TWO_PRODUCERS = [
    ("    if (threadIdx.x != 0) return;\n    int it = 0, qi = 0;",
     "    if (threadIdx.x % 32 != 0 || threadIdx.x >= 64) return;\n"
     "    const bool kq = threadIdx.x == 0;\n    int it = 0, qi = 0;"),
    ("      const int qb = qi & 1;\n"
     "      mbar_wait(q_empty + qb, ((qi >> 1) & 1) ^ 1);",
     "      const int qb = qi & 1;\n      if (kq) {\n"
     "      mbar_wait(q_empty + qb, ((qi >> 1) & 1) ^ 1);"),
    ("T.row0 + 64 * half, T.b);\n      for (int n = T.n_begin;",
     "T.row0 + 64 * half, T.b);\n      }\n      for (int n = T.n_begin;"),
    ("        ++it;\n        mbar_wait(k_empty + st, ph ^ 1);\n"
     "        mbar_expect_tx(k_full + st, C::K_BYTES);",
     "        ++it;\n        if (kq) {\n"
     "        mbar_wait(k_empty + st, ph ^ 1);\n"
     "        mbar_expect_tx(k_full + st, C::K_BYTES);"),
    ("        mbar_wait(v_empty + st, ph ^ 1);\n"
     "        mbar_expect_tx(v_full + st, C::V_BYTES);",
     "        } else {\n        mbar_wait(v_empty + st, ph ^ 1);\n"
     "        mbar_expect_tx(v_full + st, C::V_BYTES);"),
    ("                   sl * SLAB, T.hk, k0, T.b);\n      }\n    }\n"
     "    return;\n  }",
     "                   sl * SLAB, T.hk, k0, T.b);\n        }\n      }\n"
     "    }\n    return;\n  }")]
DV64_BK128 = [("launch_persistent<96, 64, 192>(a, s)",
               "launch_persistent<96, 64, 128>(a, s)")]

# clock64 around each phase of the kv loop, summed a consumer into
# fa_prof[cta][consumer][phase], read back by fa_prof_read
PROFILE = [
    ("template <int DQ, int DV, int BK>\n"
     "__global__ void __launch_bounds__(FA_THREADS, 1)\n"
     "flash_bf16_persistent(",
     "__device__ unsigned long long fa_prof[160][2][12];\n\n"
     "template <int DQ, int DV, int BK>\n"
     "__global__ void __launch_bounds__(FA_THREADS, 1)\n"
     "flash_bf16_persistent("),
    ("  int turn = 0, it = 0, qi = 0, pend = -1;\n",
     "  int turn = 0, it = 0, qi = 0, pend = -1;\n"
     "  unsigned long long acc[12] = {};\n"
     "  const long long t_start = clock64();\n"),
    ("      for (int j = 1; j < T.ntiles; ++j) {\n"
     "        n = next_tile(n + 1);",
     "      for (int j = 1; j < T.ntiles; ++j) {\n"
     "        const long long c0 = clock64();\n"
     "        n = next_tile(n + 1);"),
    ("        mbar_wait(v_full + pst, ((it - 1) / ST) & 1);\n"
     "        bar_sync(1 + cw);",
     "        mbar_wait(v_full + pst, ((it - 1) / ST) & 1);\n"
     "        const long long c1 = clock64();\n"
     "        bar_sync(1 + cw);\n"
     "        const long long c2 = clock64();"),
    ("        ++turn;\n"
     "        wgmma_wait1();\n"
     "        keep(s);\n"
     "        if (lane == 0) mbar_arrive(k_empty + st);\n"
     "        softmax(n * BK, alpha);\n"
     "        wgmma_wait0();\n"
     "        keep(o);\n"
     "        keep(pf);\n",
     "        ++turn;\n"
     "        const long long c3 = clock64();\n"
     "        wgmma_wait1();\n"
     "        keep(s);\n"
     "        const long long c4 = clock64();\n"
     "        if (lane == 0) mbar_arrive(k_empty + st);\n"
     "        softmax(n * BK, alpha);\n"
     "        keep(s);\n"
     "        const long long c5 = clock64();\n"
     "        wgmma_wait0();\n"
     "        keep(o);\n"
     "        keep(pf);\n"
     "        const long long c6 = clock64();\n"),
    ("        pack();\n"
     "        pst = st;\n"
     "        ++it;\n"
     "      }",
     "        pack();\n"
     "        keep(pf);\n"
     "        const long long c7 = clock64();\n"
     "        acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2;\n"
     "        acc[3] += c4 - c3; acc[4] += c5 - c4; acc[5] += c6 - c5;\n"
     "        acc[6] += c7 - c6; acc[7] += 1;\n"
     "        pst = st;\n"
     "        ++it;\n"
     "      }"),
    ("  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" :::"
     " \"memory\");\n}",
     "  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" :::"
     " \"memory\");\n"
     "  acc[8] = clock64() - t_start;\n"
     "  if (tid == 0 && blockIdx.x < 160)\n"
     "    for (int i = 0; i < 12; ++i) fa_prof[blockIdx.x][cw][i] = acc[i];\n"
     "}"),
    ("extern \"C\" int flash_attention_probe(",
     "extern \"C\" int fa_prof_read(unsigned long long* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, fa::fa_prof,"
     " sizeof(fa::fa_prof));\n}\n\n"
     "extern \"C\" int flash_attention_probe(")]

VARIANTS = {
    "base": [],
    "parent-softmax-stubbed": PARENT_SOFTMAX_STUB,
    "parent-products-stubbed": PARENT_PRODUCTS_STUB,
    "parent-heads-grouped": PARENT_HEADS_GROUPED,
    "fma-exp2-2of8": fma_exp2(2),
    "fma-exp2-4of8": fma_exp2(4),
    "rescale-skip": RESCALE_SKIP,
    "two-producers": TWO_PRODUCERS,
    "dv64-bk128": DV64_BK128,
    "profile": PROFILE,
}
PHASES = ("loads", "turn", "issue", "S wait", "softmax", "P V wait",
          "rescale + pack")


def make(name: str, src: Path) -> Path:
    """The variant's tree under build/k4_variants/NAME/src."""
    dst = ROOT / "build" / "k4_variants" / name / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "repro_torch" / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        n = text.count(old)
        if n != 1:
            raise SystemExit(f"{name}: an edit matches {n} times, not once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def build(dst: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from repro_torch.kernels import _build;"
         "print(_build.build(['flash_attention']).get('flash_attention', ''))",
         str(dst)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


PROFILE_RUN = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
phases = %r
for label, H, Dq, Dv in (("minicpm3-4b", 40, 96, 64), ("zamba2-7b", 32, 112,
                         112), ("deepseek-v2-236b", 128, 192, 128)):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 4096, H, Dq), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, 4096, H, Dq), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, 4096, H, Dv), generator=g, device="cuda").bfloat16()
    ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    lib = ctypes.CDLL(str(_build._lib_path("flash_attention")))
    buf = (ctypes.c_ulonglong * (160 * 2 * 12))()
    assert lib.fa_prof_read(buf) == 0
    rows = [buf[i * 12:(i + 1) * 12] for i in range(160 * 2)]
    tot = [sum(r[i] for r in rows) for i in range(12)]
    n, busy = tot[7], sum(tot[:7])
    print(f"[profile] {label}: {n} kv iterations; clocks an iteration: "
          + ", ".join(f"{p} {tot[i] / n:.0f}" for i, p in enumerate(phases))
          + f"; the loop {busy / tot[8]:.3f} of the consumers' clocks",
          flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default="results/k4_variants")
    args = ap.parse_args()
    trees = {n: make(n, Path(args.src).resolve()) for n in args.names}
    procs = {n: build(d) for n, d in trees.items()}
    for n, p in procs.items():
        report = p.communicate()[0]
        if p.returncode:
            print(report[-3000:], file=sys.stderr)
            raise SystemExit(f"{n}: the build failed")
        for line in report.splitlines():
            if "persistent" in line or "spill" in line or "serial" in line:
                print(f"[ptxas {n}] {line.strip()[:160]}", flush=True)
    for n, d in trees.items():
        print(f"=== {n}", flush=True)
        subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "trace_kernels.py"),
                        "--src", str(d), "--only", "k4", "--iters", "20",
                        "--out", f"{args.out}/{n}"], check=True)
        if n == "profile":
            subprocess.run([sys.executable, "-c", PROFILE_RUN % (PHASES,),
                            str(d)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
