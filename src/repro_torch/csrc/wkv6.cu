// K5: the RWKV6 (Finch) WKV recurrence. Per (sequence, head), with K = V:
//
//     y_t[v]    = sum_k r_t[k] (S[k][v] + u[k] k_t[k] v_t[v])
//     S[k][v]  <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// in f32, y before the update, the state carried in and out.
//
// Replaces no Pallas kernel: the reference runs this as a jnp step scan,
// src/repro/models/ssm.py:93 (rwkv6_linear_attention), which XLA compiles
// into one loop on the TPU. A port extension held against that function
// (kernels/wkv6/ref.py is its plain version). The reference pads L up to
// a multiple of its chunk with w = 1 and k = 0; those steps leave S as it
// was, so the kernel runs the L real steps only.
//
// Bound on an H100: the bonus factorises, y[v] = sum_k r[k] S[k][v] +
// v[v] a with a = sum_k r[k] u[k] k[k], so per state entry the function
// needs an FMA for y, a multiply (k v) and an FMA (w S + k v) for the
// update: 5 K V + 3 K + 2 V flops a (token, head). At rwkv6-7b's prefill
// (B 1, L 2,048, H 64, K = V 64) that is 2.73 GFLOP of fp32 CUDA-core work
// (0.041 ms at 67 TFLOP/s) against 119.5 MB read or written once (0.036 ms
// at 3.35 TB/s): bound by operations. The recurrence is sequential in L;
// what is parallel is the B x H x V state columns, since S[:, v] evolves
// from r, k, w and v_t[v] alone and only y's sum over k couples its rows.
//
// Design (the first form of this kernel ran one CTA of 2 warps per
// (sequence, head), a thread walking a whole 64-entry column, 4 ops an
// entry, its staging between two barriers: 2.13 ms on an H100 at 700 W,
// 0.019 of the bound; chip_smoke.py, tools/trace_kernels.py --only ssm):
// - Work: L >= 16 runs wkv6_fwd, one CTA per (32-column group, head,
//   sequence): 2 x 64 = 128 CTAs of 256 threads at rwkv6's prefill. A
//   thread owns 4 rows x 2 columns of S in 8 registers, read from and
//   written to device memory directly: a column pair's K_P / 4 lanes (K
//   padded to 16, 32 or 64; 16 lanes at K 64) split its rows, lane i rows
//   4i..4i+3, so a step's r, k and w reach a lane as one float4 each and a
//   quarter warp reads 128 contiguous bytes.
// - Per step and lane: 3 float4s (r, k, w) and a float2 (v) from shared
//   memory, 8 FMAs for y's partials over the lane's rows, 8 multiplies and
//   8 FMAs for the update: 3 ops an entry. A tile's partials (32 steps x 2
//   columns) stay in registers, and y's sum over k is one reduce-scatter a
//   tile over the pair's lanes, each level halving what a lane keeps (62
//   shuffles a 32-step tile at K 64, none in the step loop, whose only
//   dependence is the state's own FMA); each lane then adds v a to the 4
//   sums it holds and writes them. Two columns a thread halve the
//   shared-memory bytes an entry against one.
// - Staging: all threads copy r, k, w and the group's v columns of TT = 32
//   steps raw (bf16 or f32) into a two-stage ring with cp.async (16-byte
//   copies where every base, stride and row is 16-byte aligned; 8 or 4
//   bytes otherwise; a bf16 view that is not 4-byte aligned by plain
//   loads), each thread's share of a tile fixed once so that a copy costs
//   no division; tile i + 1 is in flight while tile i's steps run, and
//   tile i + 2 is issued as soon as tile i is converted. The conversion,
//   between two CTA barriers, widens the tile to f32 (a warp 4 steps, a
//   lane two elements of a row, the loads before the stores) and computes
//   a_t once per step and CTA (one reduce-scatter over the warp for its 4
//   steps); rows past K get r = k = 0 and w = 1 (their S stays 0); steps
//   past L are skipped. The staging is per CTA, so it shrinks with fewer,
//   wider CTAs: at rwkv6's prefill 16-column CTAs of 16-step tiles read
//   0.35 ms, 32-column ones 0.28, with 32-step tiles 0.25 (the same H100;
//   PERF.md's findings).
//   Tried and dropped: a producer warp converting tile i + 1 while the
//   other warps ran tile i (warp specialisation with named barriers): one
//   warp staged a tile more slowly than four consumed it (0.64 ms); and 4
//   columns a thread (0.31 ms: half the warps to hide latency).
// - 64 KB of shared memory at K 64 in bf16 (86 KB f32), opted into past
//   the 48 KB default; one CTA an SM.
// - Decode (L < 16) runs wkv6_fwd_cols, that first column kernel with a
//   16-step tile: a call is one latency-bound read and write of the state,
//   and a thread per column with its 64 loads in flight read 0.0055 ms at
//   rwkv6's 4-slot decode against the split kernel's 0.0076.
// - Training calls (WKV6Fn's forward) run wkv6_fwd_ckpt, the same body
//   compiled with the checkpoints K5-bwd restarts from: the state at the
//   start of every CKT = 16-step chunk, written from the registers that
//   hold it, transposed (a thread's 4 rows of a column one 16-byte store,
//   a column pair's lanes a whole 256-byte column): 268 MB at rwkv6's 4,096
//   tokens for 0.01 ms more than wkv6_fwd (PERF.md); below 16 steps
//   wkv6_fwd_cols' CK instance, whose one checkpoint is the state carried
//   in. Inference keeps the instances compiled without them; y and the
//   state are the same bits.
// - No atomics: repeats are bit-identical. fp32 FFMAs only; no tensor
//   cores, no TF32. The next step past this is the chunked form
//   (intra-chunk products on the tensor cores in exact f32 emulation),
//   which this kernel does not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "wkv6_common.cuh"

namespace wkv {

constexpr int VC = 32;    // state columns per CTA
constexpr int CPT = 2;    // state columns per thread
constexpr int RPT = 4;    // state rows per thread (a float4 of r, k, w)

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;
  float* y;
  float* s_out;
  float* ck;              // null, or the state at each CKT-step chunk's start
  long long rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB, wsL, wsH;
  int B, L, H, K;
  int cb;                 // bytes a staging copy: 16, 8, 4, or 2 (plain)
};

template <typename T, int KP, int TT>
struct Tile {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int LG = KP / RPT;                 // lanes a column set
  static constexpr int NT = VC / CPT * LG;            // threads a CTA
  static constexpr int NW = NT / 32;
  // a raw stage: r, k (TT, KP) of T, w (TT, KP) f32, v (TT, VC) of T
  static constexpr int OK_ = TT * KP * ES, OW = 2 * OK_, OV = OW + TT * KP * 4;
  static constexpr int RAW = OV + TT * VC * ES;
  // the staging (floats): r, k, w (TT, KP), v (TT, VC), a (TT)
  static constexpr int STG = TT * (3 * KP + VC + 1);
  static constexpr int SMEM = 2 * RAW + 4 * STG;
  static_assert(NT % 32 == 0, "whole warps");
  static_assert(TT * CPT % LG == 0, "whole sums a lane keeps");
  static constexpr int SPW = TT / NW;        // steps a warp converts, 4 at
  static_assert(TT % NW == 0 && SPW % 4 == 0, "a time");
};

// CK: with checkpoint writes (a.ck set), an instance of its own, so that
// the inference kernel is compiled as it was: with `a` by reference its
// SASS is the kernel's before checkpoints (tools/sass_diff.py); by value
// ptxas allocates it anew
template <typename T, int KP, int TT, bool CK>
__device__ __forceinline__ void fwd_body(const Args& a) {
  using F = Tile<T, KP, TT>;
  constexpr int ES = F::ES, LG = F::LG, NT = F::NT, NW = F::NW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem + 2 * F::RAW);
  float* ks = rs + TT * KP;
  float* ws = ks + TT * KP;
  float* vs = ws + TT * KP;
  float* as = vs + TT * VC;

  const int c0 = blockIdx.x * VC, h = blockIdx.y, b = blockIdx.z;
  const int K = a.K, L = a.L, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nvc = min(VC, K - c0);            // this CTA's real columns
  const int ntile = (L + TT - 1) / TT;
  const int nck = (L + CKT - 1) / CKT;        // checkpoints a (b, h)
  static_assert(TT % CKT == 0, "checkpoints at tile steps");

  const unsigned char* R = static_cast<const unsigned char*>(a.r) +
                           (b * a.rsB + h * a.rsH) * ES;
  const unsigned char* Kp = static_cast<const unsigned char*>(a.k) +
                            (b * a.ksB + h * a.ksH) * ES;
  const unsigned char* V = static_cast<const unsigned char*>(a.v) +
                           (b * a.vsB + h * a.vsH + c0) * ES;
  const unsigned char* W =
      reinterpret_cast<const unsigned char*>(a.w + b * a.wsB + h * a.wsH);
  const RowCopy cr(K * ES, a.cb, tid, NT), cw(K * 4, a.cb, tid, NT),
      cv(nvc * ES, a.cb, tid, NT);
  auto issue = [&](int i) {                   // tile i into raw stage i % 2
    unsigned char* st = smem + (i & 1) * F::RAW;
    const long long t0 = (long long)i * TT;
    const int nt = min(TT, L - i * TT);
    cr.run(st, KP * ES, R + t0 * a.rsL * ES, a.rsL * ES, nt, a.cb);
    cr.run(st + F::OK_, KP * ES, Kp + t0 * a.ksL * ES, a.ksL * ES, nt, a.cb);
    cw.run(st + F::OW, KP * 4, W + t0 * a.wsL * 4, a.wsL * 4, nt, a.cb);
    cv.run(st + F::OV, VC * ES, V + t0 * a.vsL * ES, a.vsL * ES, nt, a.cb);
  };
  if (ntile > 0) issue(0);
  cp_commit();
  if (ntile > 1) issue(1);
  cp_commit();

  // S[c][j]: row RPT li + j, column c0 + CPT p + c, read while the first
  // tiles are in flight, all loads issued at once
  const int p = tid / LG, li = tid % LG;      // column set, lane in it
  const long long sbase = ((long long)b * a.H + h) * K * K;
  float S[CPT][RPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = RPT * li + j, col = CPT * p + c;
      S[c][j] = (row < K && col < nvc)
          ? a.s_in[sbase + (long long)row * K + c0 + col] : 0.f;
    }

  // widen tile i to f32 and a_t = sum r u k: warp w the steps [w TT / NW,
  // (w + 1) TT / NW) in groups of 4 (their loads before their stores), lane
  // l elements 2l and 2l + 1 of a row; rows past K get r = k = 0 and w = 1
  // (their S stays 0); a group's 4 a_t by one reduce-scatter over the warp
  const int x = 2 * lane;
  const float u0 = x < K ? a.u[h * K + x] : 0.f;
  const float u1 = x + 1 < K ? a.u[h * K + x + 1] : 0.f;
  constexpr int G = 4;                        // steps converted together
  const int abase = scatter_base<G, 1, 32>(lane);
  auto convert = [&](int i) {
    const unsigned char* st = smem + (i & 1) * F::RAW;
    const T* rr = reinterpret_cast<const T*>(st);
    const T* kk = reinterpret_cast<const T*>(st + F::OK_);
    const float* ww = reinterpret_cast<const float*>(st + F::OW);
    const T* vv = reinterpret_cast<const T*>(st + F::OV);
    const int nt = min(TT, L - i * TT);
    constexpr int SPW = F::SPW;
#pragma unroll
    for (int g = 0; g < SPW / G; ++g) {
      const int tg = warp * SPW + G * g;
      if (tg >= nt) break;
      float2 r2[G], k2[G], w2[G], v2[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const int t = tg + e;
        r2[e] = k2[e] = v2[e] = make_float2(0.f, 0.f);
        w2[e] = make_float2(1.f, 1.f);
        if (t < nt && x + 1 < K) {
          r2[e] = widen2(rr + t * KP + x);
          k2[e] = widen2(kk + t * KP + x);
          w2[e] = *reinterpret_cast<const float2*>(ww + t * KP + x);
        } else if (t < nt && x < K) {
          r2[e].x = widen(rr + t * KP + x);
          k2[e].x = widen(kk + t * KP + x);
          w2[e].x = ww[t * KP + x];
        }
        if (t < nt && x + 1 < nvc) {
          v2[e] = widen2(vv + t * VC + x);
        } else if (t < nt && x < nvc) {
          v2[e].x = widen(vv + t * VC + x);
        }
      }
      float part[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const int t = tg + e;
        part[e] = fmaf(r2[e].x * u0, k2[e].x, r2[e].y * u1 * k2[e].y);
        if (t < nt && x < KP) {
          *reinterpret_cast<float2*>(rs + t * KP + x) = r2[e];
          *reinterpret_cast<float2*>(ks + t * KP + x) = k2[e];
          *reinterpret_cast<float2*>(ws + t * KP + x) = w2[e];
        }
        if (t < nt && x < VC)
          *reinterpret_cast<float2*>(vs + t * VC + x) = v2[e];
      }
      reduce_scatter<G, 1, 32, G>(part, lane);
      if (lane < G && tg + abase < nt) as[tg + abase] = part[0];
    }
  };

  // after the reduce-scatter of y, lane li holds M of the tile's (step,
  // column) sums: flat index base + m, step = index / CPT
  constexpr int M = TT * CPT / LG;
  const int base = scatter_base<TT * CPT, 1, LG>(li);
  const long long yrow = (long long)a.H * K;
  for (int i = 0; i < ntile; ++i) {
    cp_wait1();                               // tile i has landed
    __syncthreads();                          // ... for every thread; the
    convert(i);                               // staging is free again
    __syncthreads();
    if (i + 2 < ntile) issue(i + 2);          // into the stage just read
    cp_commit();
    const int t0 = i * TT, nt = min(TT, L - t0);
    // the tile's steps: y's partial over the lane's rows, both columns,
    // from the state before each step, kept for the whole tile; the update
    float yp[TT * CPT];
#pragma unroll
    for (int m = 0; m < TT * CPT; ++m) yp[m] = 0.f;
    auto step = [&](int t) {
      const float2 v2 = *reinterpret_cast<const float2*>(vs + t * VC +
                                                         CPT * p);
      const float vc[CPT] = {v2.x, v2.y};
      const int o = t * KP + RPT * li;
      const float4 r4 = *reinterpret_cast<const float4*>(rs + o);
      const float4 k4 = *reinterpret_cast<const float4*>(ks + o);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + o);
      const float rr[RPT] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[RPT] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[RPT] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float y = rr[0] * S[c][0];
#pragma unroll
        for (int j = 1; j < RPT; ++j) y = fmaf(rr[j], S[c][j], y);
        yp[t * CPT + c] = y;
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          S[c][j] = fmaf(ww[j], S[c][j], kk[j] * vc[c]);
      }
    };
    // the state before step t0 + t, t a multiple of CKT, into its chunk's
    // checkpoint, stored transposed (column v's K rows contiguous): a
    // thread's 4 rows of a column are one 16-byte store, a column pair's
    // lanes a whole 256-byte column (stores to device memory do not hold
    // back the step loop's shared-memory loads)
    auto checkpoint = [&](int t) {
      float* dst = a.ck + ((((long long)b * a.H + h) * nck + (t0 + t) / CKT)
                           * K + c0 + CPT * p) * K + RPT * li;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (CPT * p + c >= nvc) continue;
        if (K % RPT == 0 && RPT * li < K) {
          *reinterpret_cast<float4*>(dst + c * K) =
              make_float4(S[c][0], S[c][1], S[c][2], S[c][3]);
        } else {
#pragma unroll
          for (int j = 0; j < RPT; ++j)
            if (RPT * li + j < K) dst[c * K + j] = S[c][j];
        }
      }
    };
    // a whole tile without a test a step: 0.248 ms at rwkv6's prefill
    // against 0.263 with one (the same H100)
    if (nt == TT) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (CK && t % CKT == 0) checkpoint(t);
        step(t);
      }
    } else {
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < nt) {
          if (CK && t % CKT == 0) checkpoint(t);
          step(t);
        }
    }
    // y's sum over k: a reduce-scatter over the pair's lanes
    reduce_scatter<TT * CPT, 1, LG, TT * CPT>(yp, li);
    float* yt = a.y + (((long long)b * L + t0) * a.H + h) * K + c0 + CPT * p;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int t = (base + m) / CPT, c = (base + m) % CPT;
      if (t < nt && CPT * p + c < nvc)
        yt[t * yrow + c] = fmaf(vs[t * VC + CPT * p + c], as[t], yp[m]);
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = RPT * li + j, col = CPT * p + c;
      if (row < K && col < nvc)
        a.s_out[sbase + (long long)row * K + c0 + col] = S[c][j];
    }
}

template <typename T, int KP, int TT>
__global__ void __launch_bounds__(Tile<T, KP, TT>::NT) wkv6_fwd(Args a) {
  fwd_body<T, KP, TT, false>(a);
}

// training calls: the same, and the state at every chunk's start
template <typename T, int KP, int TT>
__global__ void __launch_bounds__(Tile<T, KP, TT>::NT, 1)
    wkv6_fwd_ckpt(Args a) {
  fwd_body<T, KP, TT, true>(a);
}

// ---- decode (L < 16): the first column kernel. A call is one read and one
// write of the state, bound by its latency: one CTA per (head, sequence),
// thread j the state column S[:, j] in K_P registers, all 64 loads in
// flight at once, the L steps' r, k, w and v staged in shared memory
// (widened to f32; rows past K and steps past L 0) in one tile, then each
// step's y (the bonus added to each entry before the dot with r, 4 ops an
// entry) and update
constexpr int TD = 16;                        // steps it stages: L < TD

template <typename T, int KP, bool CK>    // CK: with checkpoint writes
__global__ void __launch_bounds__(KP < 32 ? 32 : KP) wkv6_fwd_cols(Args a) {
  constexpr int NT = KP < 32 ? 32 : KP;
  __shared__ __align__(16) float rs[TD][KP];
  __shared__ __align__(16) float ks[TD][KP];
  __shared__ __align__(16) float ws[TD][KP];
  __shared__ __align__(16) float vs[TD][KP];
  __shared__ __align__(16) float us[KP];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int K = a.K, L = a.L;
  const T* R = static_cast<const T*>(a.r) + b * a.rsB + h * a.rsH;
  const T* Kp = static_cast<const T*>(a.k) + b * a.ksB + h * a.ksH;
  const T* V = static_cast<const T*>(a.v) + b * a.vsB + h * a.vsH;
  const float* W = a.w + b * a.wsB + h * a.wsH;
  const long long sbase = ((long long)b * a.H + h) * K * K;

  float S[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i)
    S[i] = (j < K && i < K) ? a.s_in[sbase + (long long)i * K + j] : 0.f;
  if (CK && L > 0) {                  // one chunk: the state carried in,
#pragma unroll                        // transposed
    for (int i = 0; i < KP; ++i)
      if (j < K && i < K) a.ck[sbase + (long long)j * K + i] = S[i];
  }
  for (int i = j; i < KP; i += NT) us[i] = i < K ? a.u[h * K + i] : 0.f;
  for (int e = j; e < TD * KP; e += NT) {
    const int t = e / KP, i = e % KP;
    float rv = 0.f, kv = 0.f, wv = 0.f, vv = 0.f;
    if (t < L && i < K) {
      rv = widen(R + t * a.rsL + i);
      kv = widen(Kp + t * a.ksL + i);
      vv = widen(V + t * a.vsL + i);
      wv = W[t * a.wsL + i];
    }
    rs[t][i] = rv;
    ks[t][i] = kv;
    ws[t][i] = wv;
    vs[t][i] = vv;
  }
  __syncthreads();
  if (j < KP) {
    for (int t = 0; t < L; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < KP; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * vj;
          acc[c] = fmaf(rr[c], fmaf(uu[c], kv, S[i + c]), acc[c]);
          S[i + c] = fmaf(ww[c], S[i + c], kv);
        }
      }
      if (j < K)
        a.y[(((long long)b * L + t) * a.H + h) * K + j] =
            (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < KP; ++i)
    if (j < K && i < K) a.s_out[sbase + (long long)i * K + j] = S[i];
}

template <typename T, int KP, int TT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using F = Tile<T, KP, TT>;
  auto kern = a.ck ? wkv6_fwd_ckpt<T, KP, TT> : wkv6_fwd<T, KP, TT>;
  if (F::SMEM > 48 * 1024) {
    static bool opted[2][64] = {};            // per kernel and device
    int dev = 0;
    cudaGetDevice(&dev);
    if (!opted[a.ck != nullptr][dev & 63]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
      if (e != cudaSuccess) return e;
      opted[a.ck != nullptr][dev & 63] = true;
    }
  }
  dim3 grid((a.K + VC - 1) / VC, a.H, a.B);
  kern<<<grid, F::NT, F::SMEM, s>>>(a);
  return cudaGetLastError();
}

// L >= 16: the column-split kernel; decode (L < 16): the column kernel
template <typename T, int KP>
cudaError_t launch_k(const Args& a, cudaStream_t s) {
  if (a.L >= TD) return launch<T, KP, 32>(a, s);
  auto cols = a.ck ? wkv6_fwd_cols<T, KP, true> : wkv6_fwd_cols<T, KP, false>;
  cols<<<dim3(a.H, a.B), KP < 32 ? 32 : KP, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.K <= 16) return launch_k<T, 16>(a, s);
  if (a.K <= 32) return launch_k<T, 32>(a, s);
  return launch_k<T, 64>(a, s);
}

}  // namespace wkv

// r, k, v (B, L, H, K) bf16 (is_bf16) or f32 and w (B, L, H, K) f32, each
// with unit stride in the last dim and the given B/L/H element strides; u
// (H, K), s_in and s_out (B, H, K, K) f32 contiguous (s_out may alias
// s_in: each thread reads its entries of the state before it writes
// them); y contiguous (B, L, H, K) f32. ck: null, or (B, H, ceil(L / 16),
// K, K) f32 contiguous, which gets the state at the start of every 16-step
// chunk (chunk 0's is s_in), transposed (ck[b][h][c][v][k] = S[k][v]),
// for K5-bwd; y and s_out are the same bits with and without it. 1 <= K <= 64. Returns the launch's CUDA error (0 on
// success).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const float* w, const float* u, const float* s_in,
                    float* y, float* s_out, float* ck, long long rsB,
                    long long rsL,
                    long long rsH, long long ksB, long long ksL,
                    long long ksH, long long vsB, long long vsL,
                    long long vsH, long long wsB, long long wsL,
                    long long wsH, int B, int L, int H, int K, int is_bf16,
                    void* stream) {
  if (K < 1 || K > 64) return (int)cudaErrorInvalidValue;
  // the widest copy every base, stride and row (and the v column groups'
  // offsets and widths) allows
  const unsigned long long es = is_bf16 ? 2 : 4;
  unsigned long long m =
      reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w);
  for (long long st : {rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH})
    m |= (unsigned long long)st * es;
  for (long long st : {wsB, wsL, wsH}) m |= (unsigned long long)st * 4;
  m |= K * es | (unsigned long long)(K % wkv::VC) * es;
  int cb = 16;
  while (cb > 2 && m % cb) cb >>= 1;
  const wkv::Args a{r,   k,   v,   w,   u,   s_in, y,   s_out, ck,
                    rsB, rsL, rsH, ksB, ksL, ksH,  vsB, vsL,   vsH,
                    wsB, wsL, wsH, B,   L,   H,    K,   cb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? wkv::dispatch<__nv_bfloat16>(a, s)
                       : wkv::dispatch<float>(a, s));
}
