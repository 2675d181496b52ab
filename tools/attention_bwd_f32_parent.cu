// A probe, on no path of the port: the f32 tiled attention backward pair
// as it was before its Hopper redesign (bwd_dq_f32 / bwd_dkv_f32 of
// src/repro_torch/csrc/flash_attention_bwd.cu: 256 threads as 16 x 16, a
// thread owning rows ty + 16 i and columns tx + 16 j of each BT x BT tile,
// shared rows padded by one float and read one scalar at a time, tiles
// loaded synchronously, the grid's tile its fastest index). Kept to time
// the current pair against it in one run (tools/bwd_variants.py
// parent_f32_entry builds it; chip_smoke.py's timing child and
// tools/bwd_variants.py --f32 call it). Its namespace and C entry are
// renamed so that both libraries load side by side; the entry takes the
// port's arguments and launches part 0 ((a): dq, LSE and D) or 1 ((b): dk
// and dv) of an f32 call.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace fab_parent {

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;      // (B, H, ls) scratch: (a) writes, (b) reads; on
                          // the wgmma pairs ls is Lq rounded up to 64 and
                          // LSE is in log2 units
  const int* kvl;         // kv_valid_len (B,), or null
  int B, Lq, Lkv, H, Hkv;
  int D, Dv;              // q/k/dq/dk head dim; v/o/do/dv head dim
  int G, ls;
  int causal, window, prefix_len, q_offset;
  int vec;                // 16-byte loads: aligned bases, D and Dv multiples
  float scale;            // 1 / sqrt(the unpadded Dq)
};

// the end of batch row b's keys: min(Lkv, kv_valid_len[b]), at least 0
__device__ __forceinline__ int kv_end(const Args& a, int b) {
  return a.kvl ? max(0, min(a.Lkv, a.kvl[b])) : a.Lkv;
}

// ref.py attention_mask: query row i (position q_offset + i) may attend to
// key j of a batch row whose keys end at kend
__device__ __forceinline__ bool allowed(const Args& a, int i, int j,
                                        int kend) {
  if (i >= a.Lq || j >= kend) return false;
  if (j < a.prefix_len) return true;
  const int qpos = a.q_offset + i;
  if (a.causal && j > qpos) return false;
  if (a.window > 0 && qpos - j >= a.window) return false;
  return true;
}

// whether any (row, key) of rows [q0, q1) x keys [k0, k1) is allowed: the
// differences qpos - kpos of the tile cover [dmin, dmax] without gaps
__device__ __forceinline__ bool tile_live(const Args& a, int q0, int q1,
                                          int k0, int k1, int kend) {
  q1 = min(q1, a.Lq);
  k1 = min(k1, kend);
  if (q0 >= q1 || k0 >= k1) return false;
  if (k0 < a.prefix_len) return true;
  const long long dmin = (long long)a.q_offset + q0 - (k1 - 1);
  const long long dmax = (long long)a.q_offset + (q1 - 1) - k0;
  if (a.causal && dmax < 0) return false;
  if (a.window > 0 && dmin >= a.window) return false;
  return true;
}

// whether the mask allows every (row, key) of rows [q0, q1) x keys [k0,
// k1), rows clipped to Lq and keys to Lkv: such a tile runs without the
// per-element mask (keys past Lkv are the caller's to mask where they
// matter; keys in [kend, Lkv) make the tile an edge tile). RAGGED false:
// the call has no kv_valid_len (kend is Lkv), and the test is left out
template <bool RAGGED = true>
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int q1,
                                          int k0, int k1, int kend) {
  q1 = min(q1, a.Lq);
  k1 = min(k1, a.Lkv);
  if (RAGGED && k1 > kend) return false;
  if (k1 <= a.prefix_len) return true;
  const long long qlo = (long long)a.q_offset + q0;
  const long long qhi = (long long)a.q_offset + q1 - 1;
  return (!a.causal || k1 - 1 <= qlo) &&
         (a.window <= 0 || qhi - k0 < a.window);
}

// rows [row0, row0 + rows) of a (row stride ``stride``) into dst (row
// stride LD), columns [0, DP); zeros past D and past nvalid rows
template <int DP, int LD>
__device__ void load_rows(float* dst, const float* src, size_t stride,
                          int row0, int nvalid, int rows, int D, bool vec) {
  if (vec) {
    constexpr int VPR = DP / 4;
    for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
      const int r = idx / VPR, c = (idx % VPR) * 4, gr = row0 + r;
      const float4 u = gr < nvalid && c < D
          ? *reinterpret_cast<const float4*>(src + gr * stride + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[r * LD + c] = u.x;
      dst[r * LD + c + 1] = u.y;
      dst[r * LD + c + 2] = u.z;
      dst[r * LD + c + 3] = u.w;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += blockDim.x) {
      const int r = idx / DP, c = idx % DP, gr = row0 + r;
      dst[r * LD + c] = gr < nvalid && c < D ? src[gr * stride + c] : 0.f;
    }
  }
}

// D = rowsum(do . o) over Dv for rows [q0, q0 + 256 / TPR) of one head,
// TPR threads a row
template <int TPR>
__device__ void row_dsum(const Args& a, const float* o, const float* dout,
                         size_t stride, int q0, float* Ds, float* dsum_row) {
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, gr = q0 + r;
  float acc = 0.f;
  if (gr < a.Lq)
    for (int c = part; c < a.Dv; c += TPR)
      acc += dout[gr * stride + c] * o[gr * stride + c];
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    Ds[r] = acc;
    if (gr < a.Lq) dsum_row[gr] = acc;
  }
}

// ---------------------------------------------------------------------------
// The CUDA-core pair (f32 calls past the one-pass band): fp32 FMAs, no
// tensor cores. 256 threads as 16 x 16, a thread owns rows ty + 16 i and
// columns tx + 16 j of every BT x BT tile (shared rows padded by one
// float, so the 16 columns a half-warp reads fall in 16 banks). Q, K, V
// and dO are held at DP columns, DP the larger head dim padded to 64, 128,
// 192 or 256, zeros past each tensor's own (D for q/k, Dv for v/o/do), so
// S runs over Dq and dP over Dv; BT is 64 up to DP 128 and 32 past it (137
// KB of shared memory at DP 256).
// ---------------------------------------------------------------------------

template <int DP, int RI>
__device__ __forceinline__ void scores_cc(const float* A, const float* Bm,
                                          float (&s)[RI][RI]) {
  constexpr int LD = DP + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
  for (int d = 0; d < DP; ++d) {
    float av[RI], bv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) bv[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int DP, int BT>
struct CC {
  static constexpr int LD = DP + 1, LS = BT + 1;
  static constexpr int DQ_SMEM = (4 * BT * LD + BT * LS + BT) * 4;
  static constexpr int DKV_SMEM = (4 * BT * LD + 2 * BT * LS + 2 * BT) * 4;
};

// (a): dq, and LSE and D into the scratch, for a BT-row q tile of one head
template <int DP, int BT>
__device__ __forceinline__ void dq_cc(const Args& a, float* sm) {
  constexpr int LD = CC<DP, BT>::LD, LS = CC<DP, BT>::LS;
  constexpr int RI = BT / 16, NJ = DP / 16;
  float* Qs = sm;
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dSs = Vs + BT * LD;
  float* Ds = dSs + BT * LS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G, q0 = blockIdx.x * BT;
  const int kend = kv_end(a, b);
  const size_t qs = (size_t)a.H * a.D, os = (size_t)a.H * a.Dv;
  const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
  const size_t row = (size_t)b * a.Lq * a.H + h;
  const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
  const float* q = static_cast<const float*>(a.q) + row * a.D;
  const float* o = static_cast<const float*>(a.o) + row * a.Dv;
  const float* dout = static_cast<const float*>(a.dout) + row * a.Dv;
  const float* k = static_cast<const float*>(a.k) + krow * a.D;
  const float* v = static_cast<const float*>(a.v) + krow * a.Dv;
  float* lse_row = a.lse + ((size_t)b * a.H + h) * a.ls;
  load_rows<DP, LD>(Qs, q, qs, q0, a.Lq, BT, a.D, a.vec);
  load_rows<DP, LD>(dOs, dout, os, q0, a.Lq, BT, a.Dv, a.vec);
  row_dsum<256 / BT>(a, o, dout, os, q0, Ds,
                     a.dsum + ((size_t)b * a.H + h) * a.ls);
  __syncthreads();
  const int nkt = (a.Lkv + BT - 1) / BT;
  // pass 1: the row max m and sum l, online over the kv tiles
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BT;
    if (!tile_live(a, q0, q0 + BT, k0, k0 + BT, kend)) continue;
    __syncthreads();
    load_rows<DP, LD>(Ks, k, ks, k0, a.Lkv, BT, a.D, a.vec);
    __syncthreads();
    float s[RI][RI];
    scores_cc<DP, RI>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] = allowed(a, q0 + ty + 16 * i, k0 + tx + 16 * j, kend)
                      ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx), base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) sum += expf(s[i][j] - base);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * (m[i] == -INFINITY ? 0.f : expf(m[i] - base)) + sum;
      m[i] = mn;
    }
  }
  float lse[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const int gr = q0 + ty + 16 * i;
    if (tx == 0 && gr < a.Lq) lse_row[gr] = lse[i];
  }
  // pass 2: dQ += dS K
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BT;
    if (!tile_live(a, q0, q0 + BT, k0, k0 + BT, kend)) continue;
    __syncthreads();
    load_rows<DP, LD>(Ks, k, ks, k0, a.Lkv, BT, a.D, a.vec);
    load_rows<DP, LD>(Vs, v, vs, k0, a.Lkv, BT, a.Dv, a.vec);
    __syncthreads();
    float s[RI][RI], dp[RI][RI];
    scores_cc<DP, RI>(Qs, Ks, s);
    scores_cc<DP, RI>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = allowed(a, q0 + r, k0 + c, kend)
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dSs[r * LS + c] = p * (dp[i][j] - Ds[r]);
      }
    __syncthreads();
    for (int kk = 0; kk < BT; ++kk) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float d = dSs[(ty + 16 * i) * LS + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(d, kv[j], acc[i][j]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq) + row * a.D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) dq[gr * qs + c] = acc[i][j] * a.scale;
    }
  }
}

// (b): dk and dv for a BT-key tile of one kv head, over its G query heads
template <int DP, int BT>
__device__ __forceinline__ void dkv_cc(const Args& a, float* sm) {
  constexpr int LD = CC<DP, BT>::LD, LS = CC<DP, BT>::LS;
  constexpr int RI = BT / 16, NJ = DP / 16;
  float* Ks = sm;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LS;
  float* Ls = dSs + BT * LS;
  float* Ds = Ls + BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BT;
  const int kend = kv_end(a, b);
  const size_t qs = (size_t)a.H * a.D, os = (size_t)a.H * a.Dv;
  const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
  const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
  load_rows<DP, LD>(Ks, static_cast<const float*>(a.k) + krow * a.D, ks, k0,
                    a.Lkv, BT, a.D, a.vec);
  load_rows<DP, LD>(Vs, static_cast<const float*>(a.v) + krow * a.Dv, vs, k0,
                    a.Lkv, BT, a.Dv, a.vec);
  float dk[RI][NJ], dv[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int nqt = (a.Lq + BT - 1) / BT;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const size_t row = (size_t)b * a.Lq * a.H + h;
    const float* q = static_cast<const float*>(a.q) + row * a.D;
    const float* dout = static_cast<const float*>(a.dout) + row * a.Dv;
    const float* lse_row = a.lse + ((size_t)b * a.H + h) * a.ls;
    const float* dsum_row = a.dsum + ((size_t)b * a.H + h) * a.ls;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BT;
      if (!tile_live(a, q0, q0 + BT, k0, k0 + BT, kend)) continue;
      __syncthreads();
      load_rows<DP, LD>(Qs, q, qs, q0, a.Lq, BT, a.D, a.vec);
      load_rows<DP, LD>(dOs, dout, os, q0, a.Lq, BT, a.Dv, a.vec);
      if (threadIdx.x < BT) {
        const int gr = q0 + threadIdx.x;
        Ls[threadIdx.x] = gr < a.Lq ? lse_row[gr] : 0.f;
        Ds[threadIdx.x] = gr < a.Lq ? dsum_row[gr] : 0.f;
      }
      __syncthreads();
      float s[RI][RI], dp[RI][RI];
      // s[i][j]: query ty + 16 i, key tx + 16 j
      scores_cc<DP, RI>(Qs, Ks, s);
      scores_cc<DP, RI>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = allowed(a, q0 + r, k0 + c, kend)
                              ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
          Ps[r * LS + c] = p;
          dSs[r * LS + c] = p * (dp[i][j] - Ds[r]);
        }
      __syncthreads();
      for (int qq = 0; qq < BT; ++qq) {
        float ov[NJ], qv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ov[j] = dOs[qq * LD + tx + 16 * j];
          qv[j] = Qs[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
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
  float* dkp = static_cast<float*>(a.dk) + krow * a.D;
  float* dvp = static_cast<float*>(a.dv) + krow * a.Dv;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gr = k0 + ty + 16 * i;
    if (gr >= a.Lkv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) dkp[gr * ks + c] = dk[i][j] * a.scale;
      if (c < a.Dv) dvp[gr * vs + c] = dv[i][j];
    }
  }
}

template <int DP, int BT>
__global__ void __launch_bounds__(256) bwd_dq_f32(Args a) {
  extern __shared__ float sm[];
  dq_cc<DP, BT>(a, sm);
}
template <int DP, int BT>
__global__ void __launch_bounds__(256) bwd_dkv_f32(Args a) {
  extern __shared__ float sm[];
  dkv_cc<DP, BT>(a, sm);
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

// the CUDA-core pair (bwd_dq_f32 / bwd_dkv_f32) at BT-row tiles
template <int DP, int BT>
static cudaError_t run_cc(const Args& a, int part, cudaStream_t s) {
  using C = CC<DP, BT>;
  if (part == 0)
    return launch(bwd_dq_f32<DP, BT>, dim3((a.Lq + BT - 1) / BT, a.H, a.B),
                  256, C::DQ_SMEM, a, s);
  return launch(bwd_dkv_f32<DP, BT>, dim3((a.Lkv + BT - 1) / BT, a.Hkv, a.B),
                256, C::DKV_SMEM, a, s);
}

// DP: the larger head dim padded to 64, 128, 192 or 256
static cudaError_t run_cc_f32(const Args& a, int part, cudaStream_t s) {
  const int d = a.D > a.Dv ? a.D : a.Dv;
  if (d <= 64) return run_cc<64, 64>(a, part, s);
  if (d <= 128) return run_cc<128, 64>(a, part, s);
  if (d <= 192) return run_cc<192, 32>(a, part, s);
  return run_cc<256, 32>(a, part, s);
}

}  // namespace fab_parent

extern "C" int flash_attention_bwd_f32_parent(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    const int* kvl, long long B, long long Lq, long long Lkv, long long H,
    long long Hkv, long long D, long long Dv, long long scale_dim,
    long long causal, long long window, long long prefix_len,
    long long q_offset, long long is_bf16, long long part, void* stream) {
  using namespace fab_parent;
  if (B == 0 || Lq == 0 || H == 0 || Lkv == 0) return 0;
  if (is_bf16 || part < 0 || part > 1 || D < 1 || D > 256 || Dv < 1 ||
      Dv > 256 || scale_dim < 1 || Hkv < 1 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout);
  Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, kvl,
         (int)B, (int)Lq, (int)Lkv, (int)H, (int)Hkv, (int)D, (int)Dv,
         (int)(H / Hkv), (int)Lq,
         (int)causal, (int)window, (int)prefix_len, (int)q_offset,
         (int)((bases & 15) == 0 && D % 4 == 0 && Dv % 4 == 0),
         1.0f / sqrtf((float)scale_dim)};
  return (int)run_cc_f32(a, (int)part, static_cast<cudaStream_t>(stream));
}
