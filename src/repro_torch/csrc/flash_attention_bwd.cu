// K4-bwd: the backward of the prefill attention (K4) with GQA, causal,
// sliding window, bidirectional prefix, cross attention (Lq != Lkv) and an
// explicit q_offset: dq, dk and dv from q, k, v, K4's output o and the
// output's cotangent do.
//
// Replaces no TPU kernel: the Pallas kernel has no VJP, and the reference
// trains through its jnp blockwise attention (src/repro/models/layers.py
// flash_attention), which JAX differentiates. The port sends attention to
// K4 on the card, so its training path needs a backward of its own
// (ops.py FlashAttentionFn); this kernel is held against
// ref.py attention_bwd_ref and, through it, against jax.grad of the
// reference layer. The mask is ref.py attention_mask's, element by element.
//
// Recurrence (all sums in f32): LSE = m + log(l) over the masked, scaled
// scores S = Q K^T / sqrt(Dq); D = rowsum(do . o); P = exp(S - LSE);
// dV = P^T do; dP = do V^T; dS = P . (dP - D); dQ = dS K / sqrt(Dq);
// dK = dS^T Q / sqrt(Dq). A fully masked row has P = 0 everywhere.
//
// Two kernels, launched one after the other on the caller's stream, both
// deterministic (no atomics; every output element is written by one CTA
// after a fixed-order loop):
//   (a) dq: one CTA per (64-row q tile, head, batch). It computes D from
//       do and o and writes it, then pass 1 runs over the kv tiles for the
//       row max and sum and writes LSE, and pass 2 runs over them again
//       and accumulates dQ in f32.
//   (b) dk/dv: one CTA per (64-key kv tile, kv head, batch). It loops over
//       the G query heads of its kv head and over their q tiles, reads LSE
//       and D, and accumulates dK and dV in f32 (GQA's sum over the G
//       heads is this loop).
// Why this split: K4's forward (flash_attention.cu) stays as it is and
// writes no LSE, so (a) recomputes it in an extra Q K^T pass. Storing LSE
// from K4 is a later speed step, and it must leave K4's output
// bit-identical. Tiles that the mask hides entirely (causal, window) are
// skipped by an exact test on the tile's corner positions.
//
// Precision: bf16 inputs run every product on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, f32 accumulators), P and dS rounded to
// bf16 as operands; D, LSE and the softmax are f32. f32 inputs run in full
// fp32 FMAs on the CUDA cores, never TF32, as K4-f32's contract requires.
//
// What it takes: f32 and bf16; Dq = Dv up to 128, padded to 64 or 128 in
// shared memory (zeros past Dh), so any Dh <= 128 (zamba2's 112 included);
// contiguous (B, L, H, Dh) tensors (the wrapper makes them so). The
// wrapper raises on Dv != Dq, Dh > 128 and a kv_valid_len.
//
// Bound on an H100: the five products of a standard attention backward
// (S, dP, dV, dQ, dK) at qwen3-14b's L = 4,096, H = 40/8, Dh = 128, causal
// half, are 430 GFLOP, over 989 TFLOP/s 0.435 ms; the bytes of q, k, v, o,
// do, dq, dk and dv once are 0.15 ms: bound by operations. This simple
// kernel does eight products (the extra S of pass 1, and S and dP in both
// kernels), loads its tiles synchronously (16-byte loads, no cp.async or
// TMA) and reads the B operands of dS K, P^T do and dS^T Q as pairs of
// 16-bit shared loads. wgmma, TMA and an LSE stored by the forward are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fab {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;    // query rows of a (a) CTA; (b)'s q tile in f32
constexpr int BK = 64;    // keys of a (b) CTA; (a)'s kv tile
constexpr int BQB = 32;   // (b)'s q tile in bf16 (keeps its registers < 255)

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;      // (B, H, Lq) scratch: (a) writes, (b) reads
  int B, Lq, Lkv, H, Hkv, D, G;
  int causal, window, prefix_len, q_offset;
  int vec;                // 16-byte loads: aligned bases, D a multiple
  float scale;
};

// ref.py attention_mask: query row i (position q_offset + i) may attend to
// key j
__device__ __forceinline__ bool allowed(const Args& a, int i, int j) {
  if (i >= a.Lq || j >= a.Lkv) return false;
  if (j < a.prefix_len) return true;
  const int qpos = a.q_offset + i;
  if (a.causal && j > qpos) return false;
  if (a.window > 0 && qpos - j >= a.window) return false;
  return true;
}

// whether any (row, key) of rows [q0, q1) x keys [k0, k1) is allowed: the
// differences qpos - kpos of the tile cover [dmin, dmax] without gaps
__device__ __forceinline__ bool tile_live(const Args& a, int q0, int q1,
                                          int k0, int k1) {
  q1 = min(q1, a.Lq);
  k1 = min(k1, a.Lkv);
  if (q0 >= q1 || k0 >= k1) return false;
  if (k0 < a.prefix_len) return true;
  const long long dmin = (long long)a.q_offset + q0 - (k1 - 1);
  const long long dmax = (long long)a.q_offset + (q1 - 1) - k0;
  if (a.causal && dmax < 0) return false;
  if (a.window > 0 && dmin >= a.window) return false;
  return true;
}

template <typename T> __device__ __forceinline__ float f32(T x);
template <> __device__ __forceinline__ float f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename S> __device__ __forceinline__ S as(float x);
template <> __device__ __forceinline__ float as<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 as<bf16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + rows) of a (row stride ``stride``) into dst (row
// stride LD), columns [0, DP); zeros past D and past nvalid rows
template <typename T, typename S, int DP, int LD>
__device__ void load_rows(S* dst, const T* src, size_t stride, int row0,
                          int nvalid, int rows, int D, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = DP / VEC;
    for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
      const int r = idx / VPR, c = (idx % VPR) * VEC, gr = row0 + r;
      const uint4 u = gr < nvalid && c < D
          ? *reinterpret_cast<const uint4*>(src + gr * stride + c)
          : make_uint4(0, 0, 0, 0);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * LD + c + i] = as<S>(f32(e[i]));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += blockDim.x) {
      const int r = idx / DP, c = idx % DP, gr = row0 + r;
      dst[r * LD + c] = as<S>(gr < nvalid && c < D
                                   ? f32(src[gr * stride + c]) : 0.f);
    }
  }
}

// D = rowsum(do . o) for rows [q0, q0 + BQ) of one head, TPR threads a row
template <typename T, int TPR>
__device__ void row_dsum(const Args& a, const T* o, const T* dout,
                         size_t stride, int q0, float* Ds, float* dsum_row) {
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, gr = q0 + r;
  float acc = 0.f;
  if (gr < a.Lq)
    for (int c = part; c < a.D; c += TPR)
      acc += f32(dout[gr * stride + c]) * f32(o[gr * stride + c]);
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    Ds[r] = acc;
    if (gr < a.Lq) dsum_row[gr] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs; 256 threads as 16 x 16, a thread owns rows ty + 16 i
// and columns tx + 16 j of every 64 x 64 tile (shared rows padded by one
// float, so the 16 columns a half-warp reads fall in 16 banks)
// ---------------------------------------------------------------------------

template <int DP>
__device__ __forceinline__ void scores_f32(const float* A, const float* Bm,
                                           float s[4][4]) {
  constexpr int LD = DP + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < DP; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int DP>
__global__ void __launch_bounds__(256) bwd_dq_f32(Args a) {
  constexpr int LD = DP + 1, LS = BK + 1, NJ = DP / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* Ds = dSs + BQ * LS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G, q0 = blockIdx.x * BQ;
  const size_t qs = (size_t)a.H * a.D, ks = (size_t)a.Hkv * a.D;
  const size_t qoff = ((size_t)b * a.Lq * a.H + h) * a.D;
  const size_t koff = ((size_t)b * a.Lkv * a.Hkv + hk) * a.D;
  const float* q = static_cast<const float*>(a.q) + qoff;
  const float* o = static_cast<const float*>(a.o) + qoff;
  const float* dout = static_cast<const float*>(a.dout) + qoff;
  const float* k = static_cast<const float*>(a.k) + koff;
  const float* v = static_cast<const float*>(a.v) + koff;
  float* lse_row = a.lse + ((size_t)b * a.H + h) * a.Lq;
  load_rows<float, float, DP, LD>(Qs, q, qs, q0, a.Lq, BQ, a.D, a.vec);
  load_rows<float, float, DP, LD>(dOs, dout, qs, q0, a.Lq, BQ, a.D, a.vec);
  row_dsum<float, 4>(a, o, dout, qs, q0, Ds,
                     a.dsum + ((size_t)b * a.H + h) * a.Lq);
  __syncthreads();
  const int nkt = (a.Lkv + BK - 1) / BK;
  // pass 1: the row max m and sum l, online over the kv tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(a, q0, q0 + BQ, k0, k0 + BK)) continue;
    __syncthreads();
    load_rows<float, float, DP, LD>(Ks, k, ks, k0, a.Lkv, BK, a.D, a.vec);
    __syncthreads();
    float s[4][4];
    scores_f32<DP>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = allowed(a, q0 + ty + 16 * i, k0 + tx + 16 * j)
                      ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx), base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - base);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * (m[i] == -INFINITY ? 0.f : expf(m[i] - base)) + sum;
      m[i] = mn;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const int gr = q0 + ty + 16 * i;
    if (tx == 0 && gr < a.Lq) lse_row[gr] = lse[i];
  }
  // pass 2: dQ += dS K
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(a, q0, q0 + BQ, k0, k0 + BK)) continue;
    __syncthreads();
    load_rows<float, float, DP, LD>(Ks, k, ks, k0, a.Lkv, BK, a.D, a.vec);
    load_rows<float, float, DP, LD>(Vs, v, ks, k0, a.Lkv, BK, a.D, a.vec);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_f32<DP>(Qs, Ks, s);
    scores_f32<DP>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = allowed(a, q0 + r, k0 + c)
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dSs[r * LS + c] = p * (dp[i][j] - Ds[r]);
      }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dSs[(ty + 16 * i) * LS + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(d, kv[j], acc[i][j]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) dq[gr * qs + c] = acc[i][j] * a.scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(256) bwd_dkv_f32(Args a) {
  constexpr int LD = DP + 1, LS = BK + 1, NJ = DP / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LS;
  float* Ls = dSs + BQ * LS;
  float* Ds = Ls + BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  const size_t qs = (size_t)a.H * a.D, ks = (size_t)a.Hkv * a.D;
  const size_t koff = ((size_t)b * a.Lkv * a.Hkv + hk) * a.D;
  load_rows<float, float, DP, LD>(Ks, static_cast<const float*>(a.k) + koff,
                                  ks, k0, a.Lkv, BK, a.D, a.vec);
  load_rows<float, float, DP, LD>(Vs, static_cast<const float*>(a.v) + koff,
                                  ks, k0, a.Lkv, BK, a.D, a.vec);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int nqt = (a.Lq + BQ - 1) / BQ;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const size_t qoff = ((size_t)b * a.Lq * a.H + h) * a.D;
    const float* q = static_cast<const float*>(a.q) + qoff;
    const float* dout = static_cast<const float*>(a.dout) + qoff;
    const float* lse_row = a.lse + ((size_t)b * a.H + h) * a.Lq;
    const float* dsum_row = a.dsum + ((size_t)b * a.H + h) * a.Lq;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(a, q0, q0 + BQ, k0, k0 + BK)) continue;
      __syncthreads();
      load_rows<float, float, DP, LD>(Qs, q, qs, q0, a.Lq, BQ, a.D, a.vec);
      load_rows<float, float, DP, LD>(dOs, dout, qs, q0, a.Lq, BQ, a.D,
                                      a.vec);
      if (threadIdx.x < BQ) {
        const int gr = q0 + threadIdx.x;
        Ls[threadIdx.x] = gr < a.Lq ? lse_row[gr] : 0.f;
        Ds[threadIdx.x] = gr < a.Lq ? dsum_row[gr] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores_f32<DP>(Qs, Ks, s);    // s[i][j]: query ty + 16 i, key tx + 16 j
      scores_f32<DP>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = allowed(a, q0 + r, k0 + c)
                              ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
          Ps[r * LS + c] = p;
          dSs[r * LS + c] = p * (dp[i][j] - Ds[r]);
        }
      __syncthreads();
      for (int qq = 0; qq < BQ; ++qq) {
        float ov[NJ], qv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ov[j] = dOs[qq * LD + tx + 16 * j];
          qv[j] = Qs[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = Ps[qq * LS + ty + 16 * i];
          const float sv = dSs[qq * LS + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pv, ov[j], dv[i][j]);
            dk[i][j] = fmaf(sv, qv[j], dk[i][j]);
          }
        }
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk) + koff;
  float* dvp = static_cast<float*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = k0 + ty + 16 * i;
    if (gr >= a.Lkv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) {
        dkp[gr * ks + c] = dk[i][j] * a.scale;
        dvp[gr * ks + c] = dv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (bf16 x bf16 -> f32). 4 warps; a warp owns 16
// rows of the CTA's output tile. In a fragment, lane = 4 gid + tig: A
// holds rows gid and gid + 8, columns 2 tig (+1) and 8 + 2 tig (+1); B
// columns gid, rows 2 tig (+1) and 8 + 2 tig (+1); C rows gid and gid + 8,
// columns 2 tig (+1). The C fragments of two neighbouring 8-column tiles
// are the A fragment of one 16-deep slice, so P and dS feed the next
// product from registers. Shared rows are padded by 8 bf16 (16 bytes), so
// the 32-bit reads of a fragment fall in 32 banks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column from neighbouring rows, the first in the low half
__device__ __forceinline__ uint32_t ld_pair(const bf16* p0, const bf16* p1) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(p0) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(p1) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C[8 x NT columns] += A[rows row0.., DP] . B[rows n0.., DP]^T, both
// row-major in shared memory (S = Q K^T, dP = dO V^T and their transposes)
template <int DP, int NT>
__device__ __forceinline__ void rows_x_rows(const bf16* A, int row0,
                                            const bf16* Bm, float c[NT][4]) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bf16* a0p = A + (row0 + gid) * LD + 2 * tig;
  const bf16* a1p = a0p + 8 * LD;
#pragma unroll
  for (int kd = 0; kd < DP; kd += 16) {
    const uint32_t x0 = ld32(a0p + kd), x1 = ld32(a1p + kd),
                   x2 = ld32(a0p + kd + 8), x3 = ld32(a1p + kd + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bp = Bm + (nt * 8 + gid) * LD + kd + 2 * tig;
      mma16816(c[nt], x0, x1, x2, x3, ld32(bp), ld32(bp + 8));
    }
  }
}

// C[16 x DP] += A . M, A (16 x 16 KS) from the C fragments ``f`` (2 KS
// tiles of 8 columns), M (16 KS x DP) row-major in shared memory
template <int DP, int KS>
__device__ __forceinline__ void frags_x_rows(const float f[2 * KS][4],
                                             const bf16* M,
                                             float c[DP / 8][4]) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t x0 = pack(f[2 * kk][0], f[2 * kk][1]),
                   x1 = pack(f[2 * kk][2], f[2 * kk][3]),
                   x2 = pack(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                   x3 = pack(f[2 * kk + 1][2], f[2 * kk + 1][3]);
    const bf16* mp = M + (16 * kk + 2 * tig) * LD + gid;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const bf16* p = mp + nt * 8;
      mma16816(c[nt], x0, x1, x2, x3, ld_pair(p, p + LD),
               ld_pair(p + 8 * LD, p + 9 * LD));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128) bwd_dq_bf16(Args a) {
  constexpr int LD = DP + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* Ds = reinterpret_cast<float*>(Vs + BK * LD);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G, q0 = blockIdx.x * BQ;
  const size_t qs = (size_t)a.H * a.D, ks = (size_t)a.Hkv * a.D;
  const size_t qoff = ((size_t)b * a.Lq * a.H + h) * a.D;
  const size_t koff = ((size_t)b * a.Lkv * a.Hkv + hk) * a.D;
  const bf16* q = static_cast<const bf16*>(a.q) + qoff;
  const bf16* o = static_cast<const bf16*>(a.o) + qoff;
  const bf16* dout = static_cast<const bf16*>(a.dout) + qoff;
  const bf16* k = static_cast<const bf16*>(a.k) + koff;
  const bf16* v = static_cast<const bf16*>(a.v) + koff;
  load_rows<bf16, bf16, DP, LD>(Qs, q, qs, q0, a.Lq, BQ, a.D, a.vec);
  load_rows<bf16, bf16, DP, LD>(dOs, dout, qs, q0, a.Lq, BQ, a.D, a.vec);
  row_dsum<bf16, 2>(a, o, dout, qs, q0, Ds,
                    a.dsum + ((size_t)b * a.H + h) * a.Lq);
  __syncthreads();
  const int rw = warp * 16, rows[2] = {rw + gid, rw + gid + 8};
  const int nkt = (a.Lkv + BK - 1) / BK;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {       // pass 1: m and l
    const int k0 = kt * BK;
    if (!tile_live(a, q0, q0 + BQ, k0, k0 + BK)) continue;
    __syncthreads();
    load_rows<bf16, bf16, DP, LD>(Ks, k, ks, k0, a.Lkv, BK, a.D, a.vec);
    __syncthreads();
    float s[NT][4] = {};
    rows_x_rows<DP, NT>(Qs, rw, Ks, s);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * rr + e];
          x = allowed(a, q0 + rows[rr], k0 + nt * 8 + 2 * tig + e)
                  ? x * a.scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[rr], mx), base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sum += expf(s[nt][2 * rr] - base) + expf(s[nt][2 * rr + 1] - base);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = l[rr] * (m[rr] == -INFINITY ? 0.f : expf(m[rr] - base)) + sum;
      m[rr] = mn;
    }
  }
  float lse[2], dsr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lse[rr] = l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
    dsr[rr] = Ds[rows[rr]];
    const int gr = q0 + rows[rr];
    if (tig == 0 && gr < a.Lq)
      a.lse[((size_t)b * a.H + h) * a.Lq + gr] = lse[rr];
  }
  float acc[DP / 8][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {       // pass 2: dQ += dS K
    const int k0 = kt * BK;
    if (!tile_live(a, q0, q0 + BQ, k0, k0 + BK)) continue;
    __syncthreads();
    load_rows<bf16, bf16, DP, LD>(Ks, k, ks, k0, a.Lkv, BK, a.D, a.vec);
    load_rows<bf16, bf16, DP, LD>(Vs, v, ks, k0, a.Lkv, BK, a.D, a.vec);
    __syncthreads();
    float s[NT][4] = {}, dp[NT][4] = {};
    rows_x_rows<DP, NT>(Qs, rw, Ks, s);
    rows_x_rows<DP, NT>(dOs, rw, Vs, dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const float p =
            allowed(a, q0 + rows[rr], k0 + nt * 8 + 2 * tig + (e & 1))
                ? expf(s[nt][e] * a.scale - lse[rr]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dsr[rr]);      // dS
      }
    frags_x_rows<DP, BK / 16>(s, Ks, acc);
  }
  bf16* dq = static_cast<bf16*>(a.dq) + qoff;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gr = q0 + rows[e >> 1], c = nt * 8 + 2 * tig + (e & 1);
      if (gr < a.Lq && c < a.D)
        dq[gr * qs + c] = __float2bfloat16(acc[nt][e] * a.scale);
    }
}

template <int DP>
__global__ void __launch_bounds__(128) bwd_dkv_bf16(Args a) {
  constexpr int LD = DP + 8, NT = BQB / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQB * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BQB * LD);
  float* Ds = Ls + BQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  const size_t qs = (size_t)a.H * a.D, ks = (size_t)a.Hkv * a.D;
  const size_t koff = ((size_t)b * a.Lkv * a.Hkv + hk) * a.D;
  load_rows<bf16, bf16, DP, LD>(Ks, static_cast<const bf16*>(a.k) + koff, ks,
                                k0, a.Lkv, BK, a.D, a.vec);
  load_rows<bf16, bf16, DP, LD>(Vs, static_cast<const bf16*>(a.v) + koff, ks,
                                k0, a.Lkv, BK, a.D, a.vec);
  const int rw = warp * 16, rows[2] = {rw + gid, rw + gid + 8};
  float dk[DP / 8][4] = {}, dv[DP / 8][4] = {};
  const int nqt = (a.Lq + BQB - 1) / BQB;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const size_t qoff = ((size_t)b * a.Lq * a.H + h) * a.D;
    const bf16* q = static_cast<const bf16*>(a.q) + qoff;
    const bf16* dout = static_cast<const bf16*>(a.dout) + qoff;
    const float* lse_row = a.lse + ((size_t)b * a.H + h) * a.Lq;
    const float* dsum_row = a.dsum + ((size_t)b * a.H + h) * a.Lq;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQB;
      if (!tile_live(a, q0, q0 + BQB, k0, k0 + BK)) continue;
      __syncthreads();
      load_rows<bf16, bf16, DP, LD>(Qs, q, qs, q0, a.Lq, BQB, a.D, a.vec);
      load_rows<bf16, bf16, DP, LD>(dOs, dout, qs, q0, a.Lq, BQB, a.D,
                                    a.vec);
      if (threadIdx.x < BQB) {
        const int gr = q0 + threadIdx.x;
        Ls[threadIdx.x] = gr < a.Lq ? lse_row[gr] : 0.f;
        Ds[threadIdx.x] = gr < a.Lq ? dsum_row[gr] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: this warp's 16 keys x the tile's BQB queries
      float st[NT][4] = {}, dpt[NT][4] = {};
      rows_x_rows<DP, NT>(Ks, rw, Qs, st);
      rows_x_rows<DP, NT>(Vs, rw, dOs, dpt);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * tig + (e & 1);
          const float p = allowed(a, q0 + qc, k0 + rows[e >> 1])
                              ? expf(st[nt][e] * a.scale - Ls[qc]) : 0.f;
          st[nt][e] = p;                               // P^T
          dpt[nt][e] = p * (dpt[nt][e] - Ds[qc]);      // dS^T
        }
      frags_x_rows<DP, BQB / 16>(st, dOs, dv);
      frags_x_rows<DP, BQB / 16>(dpt, Qs, dk);
    }
  }
  bf16* dkp = static_cast<bf16*>(a.dk) + koff;
  bf16* dvp = static_cast<bf16*>(a.dv) + koff;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gr = k0 + rows[e >> 1], c = nt * 8 + 2 * tig + (e & 1);
      if (gr < a.Lkv && c < a.D) {
        dkp[gr * ks + c] = __float2bfloat16(dk[nt][e] * a.scale);
        dvp[gr * ks + c] = __float2bfloat16(dv[nt][e]);
      }
    }
}

template <typename Kern>
static cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                          const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DP>
static cudaError_t run(const Args& a, bool bf16_in, int part,
                       cudaStream_t s) {
  const dim3 gq((a.Lq + BQ - 1) / BQ, a.H, a.B);
  const dim3 gk((a.Lkv + BK - 1) / BK, a.Hkv, a.B);
  if (bf16_in) {
    constexpr int LD = DP + 8;
    if (part == 0)
      return launch(bwd_dq_bf16<DP>, gq, 128,
                    (size_t)(2 * BQ + 2 * BK) * LD * 2 + BQ * 4, a, s);
    return launch(bwd_dkv_bf16<DP>, gk, 128,
                  (size_t)(2 * BK + 2 * BQB) * LD * 2 + 2 * BQB * 4, a, s);
  }
  constexpr int LD = DP + 1, LS = BK + 1;
  if (part == 0)
    return launch(bwd_dq_f32<DP>, gq, 256,
                  ((size_t)(2 * BQ + 2 * BK) * LD + BQ * LS + BQ) * 4, a, s);
  return launch(bwd_dkv_f32<DP>, gk, 256,
                ((size_t)(2 * BK + 2 * BQ) * LD + 2 * BQ * LS + 2 * BQ) * 4,
                a, s);
}

}  // namespace fab

// part 0 launches (a), which writes dq, lse and dsum; part 1 launches (b),
// which reads lse and dsum and writes dk and dv. All tensors contiguous
// (B, L, H, Dh); lse and dsum (B, H, Lq) f32. Returns the launch's CUDA
// error code (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    long long B, long long Lq, long long Lkv, long long H, long long Hkv,
    long long D, long long causal, long long window, long long prefix_len,
    long long q_offset, long long is_bf16, long long part, void* stream) {
  using namespace fab;
  if (B == 0 || Lq == 0 || H == 0 || Lkv == 0) return 0;
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout);
  const int vec_elems = is_bf16 ? 8 : 4;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum,
         (int)B, (int)Lq, (int)Lkv, (int)H, (int)Hkv, (int)D, (int)(H / Hkv),
         (int)causal, (int)window, (int)prefix_len, (int)q_offset,
         (int)((bases & 15) == 0 && D % vec_elems == 0),
         1.0f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? run<64>(a, is_bf16 != 0, (int)part, s)
                                  : run<128>(a, is_bf16 != 0, (int)part, s);
  return (int)err;
}
