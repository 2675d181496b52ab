// Shared pieces of the cosine top-k lookup kernels (cosine_topk.cu,
// cosine_topk_q8.cu): pass 1's query bucket, its lane-group reduction and
// the per-tile top-k selection that ends it, and pass 2, the merge of the
// per-tile candidates under the early-exit rule of the reference kernel.
//
// Logical tiles follow the reference's block_n rule (min(512, ceil128(N))):
// the row that is served under early exit depends on it.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace ctk {

constexpr int KMAX = 16;           // largest k taken (serving: 1 and 16)
constexpr int QGROUP = 32;         // most queries a pass-1 CTA takes

// Pass 1's query bucket for a batch of B: 1, 2, 4, 8, 16 or 32 (larger B
// runs groups of 32 over grid.y), shrunk while the CTA's f32 queries and
// sims, nq * (Dp + block_n) floats, would not fit in shared memory.
inline int query_bucket(int B, int Dp, int block_n) {
  int nq = B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8
         : B <= 16 ? 16 : QGROUP;
  while (nq > 1 && sizeof(float) * (size_t)nq * (Dp + block_n) > 200 * 1024)
    nq /= 2;
  return nq;
}

// One step of the halving butterfly across the 8 lanes of a row group:
// each lane keeps half of its M sums, adds its partner's half, and passes
// on to the next offset; a single sum is added across the pair as is.
template <int M, int O>
__device__ __forceinline__ void fold(float* v, int sub) {
  if constexpr (M >= 2) {
    constexpr int H = M / 2;
    const bool up = sub & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if constexpr (O > 1) fold<H, O / 2>(v, sub);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    if constexpr (O > 1) fold<1, O / 2>(v, sub);
  }
}

// The index (into the 2 x NQ sums) of a lane's first sum after fold<M, 4>.
template <int M>
__device__ __forceinline__ int fold_base(int sub) {
  int off = 0, m = M;
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    if (m >= 2) { m /= 2; if (sub & o) off += m; }
  }
  return off;
}

// Raise a kernel's dynamic shared memory limit once per device and size,
// not on every call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, int* allowed) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem <= 48 * 1024 || smem <= allowed[dev & 63]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed[dev & 63] = smem;
  return e;
}

// Top-k of one query's tile of sims in shared memory, written to out_v/out_i
// (global row ids = base + column). Ties go to the lowest column, the
// lax.top_k rule. Called by one whole warp; destroys s_row.
__device__ inline void tile_topk(float* s_row, int tile, int k, int base,
                                 float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bv = s_row[lane];        // tile >= 128, so every lane has a column
    int bc = lane;
    for (int c = lane + 32; c < tile; c += 32) {
      const float v = s_row[c];
      if (v > bv) { bv = v; bc = c; }     // ascending c: first max kept
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ov > bv || (ov == bv && oc < bc)) { bv = ov; bc = oc; }
    }
    if (lane == 0) { out_v[r] = bv; out_i[r] = base + bc; }
    if (lane == (bc & 31)) s_row[bc] = -INFINITY;   // remove the winner
    __syncwarp();
  }
}

// Pass 2. The sequential reference walks the logical tiles in order and,
// with early_exit, stops before the first tile t > 0 at which every query's
// best so far is >= thr. That tile is t_end = min(F + 1, T), where F is the
// largest over the queries of the first tile whose best clears thr (T when
// some query never clears it): a prefix, found here by a parallel min/max
// over the B x T per-tile bests, which every block computes for itself.
// The result is then the top-k of the union of tiles [0, t_end), ordered by
// (value descending, row ascending). That equals the sequential merge: its
// running list holds lower rows than any later tile and wins ties, and each
// tile's list is already in that order.
//
// One block of 128 threads per query: all of them stage the tiles' lists
// in shared memory, up to MERGE_CAP candidates at a time behind the running
// list (one batch at the serving shape, T = 128 and k = 16), and one warp
// takes the top-k. Each lane keeps the best head of its lists; each of the
// k rounds takes the warp's best head (one butterfly) and advances the
// winner's list.
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_CAP = 2048;
constexpr int MERGE_QCAP = 256;       // queries the stop-tile search takes
                                      // at a time

__device__ __forceinline__ bool ahead(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

template <bool EARLY>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_tiles(const float* __restrict__ part_v, const int* __restrict__ part_i,
            int B, int T, int k, float thr, float* __restrict__ vals,
            int* __restrict__ idx, uint8_t* __restrict__ hit) {
  __shared__ float sv[KMAX + MERGE_CAP];
  __shared__ int si[KMAX + MERGE_CAP];
  __shared__ uint8_t sp[MERGE_CAP + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  int t_end = T;
  if constexpr (EARLY) {
    // F = the largest over queries of the first tile whose best >= thr.
    // Every (query, tile) best is tested by its own thread, with no load
    // waiting on another; first_s[q] takes the least tile that clears.
    __shared__ int first_s[MERGE_QCAP];
    __shared__ int last_first;
    if (threadIdx.x == 0) last_first = -1;
    for (int q0 = 0; q0 < B; q0 += MERGE_QCAP) {
      const int nqc = min(MERGE_QCAP, B - q0);
      for (int j = threadIdx.x; j < nqc; j += MERGE_THREADS) first_s[j] = T;
      __syncthreads();
      const float* pv = part_v + (size_t)q0 * T * k;
#pragma unroll 8
      for (int e = threadIdx.x; e < nqc * T; e += MERGE_THREADS)
        if (pv[(size_t)e * k] >= thr) atomicMin(&first_s[e / T], e % T);
      __syncthreads();
      for (int j = threadIdx.x; j < nqc; j += MERGE_THREADS)
        atomicMax(&last_first, first_s[j]);
      __syncthreads();
    }
    t_end = min(last_first + 1, T);
  }
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) {
    sv[j] = -INFINITY;
    si[j] = INT_MAX;
  }
  const int per_batch = MERGE_CAP / k;
  for (int t0 = 0; t0 < t_end; t0 += per_batch) {
    const int nt = min(per_batch, t_end - t0), L = nt + 1;   // list 0: running
    const size_t g0 = ((size_t)b * T + t0) * k;
    __syncthreads();                       // the previous batch is done
#pragma unroll 4
    for (int e = threadIdx.x; e < nt * k; e += MERGE_THREADS) {
      sv[k + e] = part_v[g0 + e];
      si[k + e] = part_i[g0 + e];
    }
    for (int l = threadIdx.x; l < L; l += MERGE_THREADS) sp[l] = 0;
    __syncthreads();
    if (warp != 0) continue;
    // this lane's best head over its lists l = lane, lane + 32, ...
    float bv = -INFINITY;
    int bi = INT_MAX, bl = -1;
    auto rescan = [&]() {
      bv = -INFINITY; bi = INT_MAX; bl = -1;
      for (int l = lane; l < L; l += 32) {
        const int p = sp[l];
        if (p < k && (bl < 0 || ahead(sv[l * k + p], si[l * k + p], bv, bi))) {
          bv = sv[l * k + p]; bi = si[l * k + p]; bl = l;
        }
      }
    };
    rescan();
    float rv = -INFINITY;
    int ri = INT_MAX;
    for (int r = 0; r < k; ++r) {
      float wv = bv;
      int wi = bi, wl = bl < 0 ? -1 : lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
        const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
        if (ol >= 0 && (wl < 0 || ahead(ov, oi, wv, wi) ||
                        (ov == wv && oi == wi && ol < wl))) {
          wv = ov; wi = oi; wl = ol;
        }
      }
      if (lane == r) { rv = wv; ri = wi; }     // k <= 16 < 32
      if (lane == wl) { sp[bl] += 1; rescan(); }
      __syncwarp();
    }
    if (lane < k) { sv[lane] = rv; si[lane] = ri; }   // the new running list
    __syncwarp();
  }
  if (warp == 0 && lane < k) {
    const float v = sv[lane];
    vals[(size_t)b * k + lane] = v;
    idx[(size_t)b * k + lane] = isfinite(v) ? si[lane] : -1;
    if (lane == 0) hit[b] = v >= thr;
  }
}

inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                int B, int T, int k, float thr,
                                int early_exit, float* vals, int* idx,
                                uint8_t* hit, cudaStream_t s) {
  if (early_exit && T > 1)
    merge_tiles<true><<<B, MERGE_THREADS, 0, s>>>(part_v, part_i, B, T, k,
                                                  thr, vals, idx, hit);
  else
    merge_tiles<false><<<B, MERGE_THREADS, 0, s>>>(part_v, part_i, B, T, k,
                                                   thr, vals, idx, hit);
  return cudaGetLastError();
}

}  // namespace ctk
