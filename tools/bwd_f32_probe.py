#!/usr/bin/env python3
"""Where the f32 tiled attention backward (``csrc/flash_attention_bwd.cu``'s
``bwd_dq_f32`` and ``bwd_dkv_f32``) spends its time, and what its register
micro-tiles can reach: the readings behind PERF.md's PR 34 section.

    python3 tools/bwd_f32_probe.py [--phases] [--lds]

``--phases`` builds a copy of ``csrc/flash_attention_bwd.cu`` with
``clock64()`` read at each phase of (a) and (b) (text edits, ``EDITS``;
each must match as often as it says) under ``build/bwd_f32_phases``, runs
(a) then (b) once at phase 13 (a)'s timed call (B 1 x 1,024, 40/8 heads
of 128, causal, f32) and prints, for thread 0 of each group (A: threads
0-127, B: 128-255) summed over every CTA, the share of its cycles in each
phase (the copy's timers add to the kernels' time; the shares, not the
times, are the reading). The copy defines the port's kernel names, so it
runs in a process of its own.

``--lds`` builds and runs a loop of 4 LDS.128 (16-byte shared loads) and
64 x N FFMAs a thread (N 1, 2, 4: 4, 8 or 16 FFMAs a 4-byte read), 256
threads a CTA and one CTA on each of 132 SMs, with the 32 lanes of a warp
reading 32, 8, 4 or 1 distinct addresses, and prints the fp32 rate it
reaches against the H100's 66.9 TFLOP/s. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bwd_f32_phases"

# the timers: thread 0 of each group adds the cycles since its last reading
# to slot (group, k)
TIMERS = ("__device__ unsigned long long fab_ph[64];\n"
          "#define PH(k) do { if ((threadIdx.x & 127) == 0) { long long t_ = "
          "clock64(); atomicAdd(&fab_ph[(threadIdx.x >> 7) * 32 + (k)], "
          "(unsigned long long)(t_ - ph_t)); ph_t = t_; } } while (0)\n")
ENTRY = """
extern "C" int fab_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[64] = {};
    return (int)cudaMemcpyToSymbol(fab::fab_ph, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, fab::fab_ph, sizeof(fab::fab_ph));
}
"""
# (text, replacement, times it must match)
EDITS = [
    ("namespace fab {\n", "namespace fab {\n" + TIMERS, 1),
    ("  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & (TG - 1);\n",
     "  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & (TG - 1);\n"
     "  long long ph_t = clock64();\n", 2),
    # (a)
    ("                         a.dsum + ((size_t)b * a.H + h) * a.ls);\n",
     "                         a.dsum + ((size_t)b * a.H + h) * a.ls);\n"
     "  PH(0);\n", 1),
    ("    __syncthreads();          // stage st landed; stage st ^ 1 is free\n",
     "    __syncthreads();\n    PH(1);\n", 1),
    ("    issue(nx, st ^ 1);\n", "    issue(nx, st ^ 1);\n    PH(2);\n", 2),
    ("                                             acc);\n"
     "        reduce_scatter<SK, P>(acc, s);\n",
     "                                             acc);\n        PH(3);\n"
     "        reduce_scatter<SK, P>(acc, s);\n", 1),
    ("          m[i] = mn;\n        }\n",
     "          m[i] = mn;\n        }\n        PH(4);\n", 1),
    ("      if (!lse_done) finish_lse(), lse_done = true;\n",
     "      if (!lse_done) finish_lse(), lse_done = true;\n      PH(5);\n", 1),
    ("                                           pc, s, acc);\n"
     "      reduce_scatter<SK, P>(acc, s);\n",
     "                                           pc, s, acc);\n      PH(6);\n"
     "      reduce_scatter<SK, P>(acc, s);\n      PH(7);\n", 1),
    ("      __syncthreads();\n      outer_frag<DP, LDT, BN / KS>(",
     "      PH(8);\n      __syncthreads();\n      PH(9);\n"
     "      outer_frag<DP, LDT, BN / KS>(", 1),
    ("kq * (BN / KS), dg, dq);\n",
     "kq * (BN / KS), dg, dq);\n      PH(10);\n", 1),
    ("  if (!lse_done) finish_lse();", "  PH(11);\n  if (!lse_done) finish_lse();",
     1),
    ("8 * rg, a.Lq - q0, dg, a.D, a.scale, dq);\n}",
     "8 * rg, a.Lq - q0, dg, a.D, a.scale, dq);\n  PH(12);\n}", 1),
    # (b)
    ("  issue(cur, 0);\n  int st = 0;\n",
     "  issue(cur, 0);\n  PH(0);\n  int st = 0;\n", 1),
    ("    __syncthreads();          // stage st landed; stage st ^ 1, P, dS "
     "free\n", "    __syncthreads();\n    PH(1);\n", 1),
    ("                                         s, acc);\n"
     "    reduce_scatter<SK, P>(acc, s);\n",
     "                                         s, acc);\n    PH(3);\n"
     "    reduce_scatter<SK, P>(acc, s);\n    PH(4);\n", 1),
    ("    __syncthreads();\n    // A: dV += P^T dO; B: dK += dS^T Q\n",
     "    PH(5);\n    __syncthreads();\n    PH(6);\n", 1),
    ("rq * (BM / RS), dg, out);\n", "rq * (BM / RS), dg, out);\n    PH(7);\n",
     1),
    ("  cp_async_wait_all();\n  __syncthreads();\n  sum_splits<RS",
     "  PH(8);\n  cp_async_wait_all();\n  __syncthreads();\n  sum_splits<RS",
     1),
    ("8 * kg, a.Lkv - k0, dg, a.D, a.scale, out);\n  }\n}",
     "8 * kg, a.Lkv - k0, dg, a.D, a.scale, out);\n  }\n  PH(9);\n}", 1),
]
PHASES = {
    0: ("prologue", "wait + barrier", "copy issue", "pass 1 S", "pass 1 stats",
        "LSE", "pass 2 S / dP", "reduce", "swap + P, dS", "barrier",
        "dQ product", "end wait", "sums + store"),
    1: ("prologue", "wait + barrier", "copy issue", "S^T / dP^T", "reduce",
        "swap + P, dS", "barrier", "dV / dK product", "end wait",
        "sums + store"),
}

LDS = r"""
#include <cstdio>
#include <cuda_runtime.h>
// a thread: iters x (4 LDS.128 at the pattern's addresses, then NF x 64
// FFMAs on 64 accumulators)
template <int PAT, int NF>
__global__ void __launch_bounds__(256, 1) k(float* out, int iters) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += 256) sm[i] = i * 1e-7f;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int off = PAT == 0 ? lane * 4 + w * 128          // 32 addresses
                : PAT == 1 ? (lane & 7) * 4 + w * 32     // 8
                : PAT == 2 ? (lane >> 3) * 32 + w * 4    // 4
                : w * 4;                                 // 1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float* p = sm + ((off + (it & 3) * 1024) & 4095);
    float4 a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = *reinterpret_cast<const float4*>(p + j * 256);
    const float v[16] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y,
                         a[1].z, a[1].w, a[2].x, a[2].y, a[2].z, a[2].w,
                         a[3].x, a[3].y, a[3].z, a[3].w};
#pragma unroll
    for (int r = 0; r < NF; ++r)
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = fmaf(v[(i + r) & 15], v[((i >> 4) + r) & 15], acc[i]);
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
template <int PAT, int NF>
int run(float* out) {
  const int iters = 8192;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<PAT, NF><<<132, 256>>>(out, 16);
  cudaEventRecord(a);
  k<PAT, NF><<<132, 256>>>(out, iters);
  cudaEventRecord(b);
  if (cudaEventSynchronize(b) != cudaSuccess ||
      cudaGetLastError() != cudaSuccess)
    return 1;
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double tf = 2.0 * 132 * 256 * iters * NF * 64 / ms / 1e9;
  const char* pat[] = {"32 addresses", "8 addresses", "4 addresses",
                       "1 address"};
  printf("[lds] %s a warp, %d FFMAs a 4-byte read: %.3f ms, %.1f TFLOP/s, "
         "%.1f%% of 66.9\n", pat[PAT], NF * 4, ms, tf, 100 * tf / 66.9);
  return 0;
}
int main() {
  float* out;
  cudaMalloc(&out, 132 * 256 * 4);
  return run<0, 1>(out) | run<1, 1>(out) | run<2, 1>(out) | run<3, 1>(out) |
         run<0, 2>(out) | run<1, 2>(out) | run<2, 2>(out) | run<3, 2>(out) |
         run<0, 4>(out) | run<3, 4>(out);
}
"""


def nvcc(args: list[str]) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([_build._nvcc(), *args], capture_output=True,
                       text=True)
    if p.returncode:
        raise SystemExit(f"nvcc failed\n{p.stderr[-4000:]}")


def phases() -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K, ref
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new, n in EDITS:
        if src.count(old) != n:
            raise SystemExit(f"an edit matches {src.count(old)} times, not "
                             f"{n}: {old[:70]!r}")
        src = src.replace(old, new)
    (OUT / "flash_attention_bwd.cu").parent.mkdir(parents=True,
                                                  exist_ok=True)
    (OUT / "flash_attention_bwd.cu").write_text(src + ENTRY)
    nvcc([*_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
          str(OUT / "libphases.so"), str(OUT / "flash_attention_bwd.cu")])
    lib = ctypes.CDLL(str(OUT / "libphases.so"))
    fn = lib.flash_attention_bwd
    fn.argtypes = _build.KERNELS["flash_attention_bwd"][2]
    fn.restype = ctypes.c_int
    lib.fab_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    L, H, Hkv, D = 1024, 40, 8, 128
    q = torch.randn(1, L, H, D, generator=g, device="cuda")
    k, v = (torch.randn(1, L, Hkv, D, generator=g, device="cuda")
            for _ in range(2))
    o = ref.attention_ref(q, k, v, causal=True).contiguous()
    do = torch.randn(o.shape, generator=g, device="cuda")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    lse, dsum = K.bwd_scratch(q)

    def call(part):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), 0, 1, L, L, H, Hkv, D, D, D,
                1, 0, 0, 0, 0, part, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"flash_attention_bwd part {part}: error {rc}")
    for part in (0, 1):
        call(part)
        torch.cuda.synchronize()
        lib.fab_phases(None, 1)
        call(part)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.fab_phases(buf, 0)
        for grp in (0, 1):
            vals = [buf[grp * 32 + i] for i in range(len(PHASES[part]))]
            tot = sum(vals)
            print(f"[phases] {'(a)' if part == 0 else '(b)'} group "
                  f"{'AB'[grp]}, {tot / 1e6:.1f} M cycles: " + ", ".join(
                      f"{n} {x / tot:.3f}" for n, x in zip(PHASES[part], vals)),
                  flush=True)


def lds() -> None:
    (OUT / "lds.cu").parent.mkdir(parents=True, exist_ok=True)
    (OUT / "lds.cu").write_text(LDS)
    nvcc(["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
          str(OUT / "lds"), str(OUT / "lds.cu")])
    rc = subprocess.run([str(OUT / "lds")]).returncode
    if rc:
        raise SystemExit(f"lds: exit {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--lds", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    if args.phases:
        phases()
    if args.lds:
        lds()
    return 0


if __name__ == "__main__":
    sys.exit(main())
