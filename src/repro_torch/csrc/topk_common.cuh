// Shared pieces of the cosine top-k lookup kernels (cosine_topk.cu,
// cosine_topk_q8.cu): the per-tile top-k selection that ends pass 1, and
// pass 2, the merge of the per-tile candidates under the early-exit rule of
// the reference kernel.
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
constexpr int QB = 8;              // queries per pass-1 block
constexpr int WARPS = 8;           // one warp selects for one query
constexpr int THREADS = WARPS * 32;

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

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

__device__ __forceinline__ bool ahead(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_tiles(const float* __restrict__ part_v, const int* __restrict__ part_i,
            int B, int T, int k, float thr, int early_exit,
            float* __restrict__ vals, int* __restrict__ idx,
            uint8_t* __restrict__ hit) {
  __shared__ float sv[KMAX + MERGE_CAP];
  __shared__ int si[KMAX + MERGE_CAP];
  __shared__ uint8_t sp[MERGE_CAP + 1];
  __shared__ int last_first;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  int t_end = T;
  if (early_exit && T > 1) {
    // F = the largest over queries of the first tile whose best >= thr
    if (threadIdx.x == 0) last_first = -1;
    __syncthreads();
    for (int q = warp; q < B; q += MERGE_THREADS / 32) {
      int first = T;
      for (int t = lane; t < T; t += 32)
        if (part_v[((size_t)q * T + t) * k] >= thr) { first = t; break; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      if (lane == 0) atomicMax(&last_first, first);
    }
    __syncthreads();
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
  merge_tiles<<<B, MERGE_THREADS, 0, s>>>(part_v, part_i, B, T, k, thr,
                                          early_exit, vals, idx, hit);
  return cudaGetLastError();
}

}  // namespace ctk
