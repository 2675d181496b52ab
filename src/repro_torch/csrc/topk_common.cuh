// Shared pieces of the cosine top-k lookup kernels (cosine_topk.cu,
// cosine_topk_q8.cu): the per-tile top-k selection that ends pass 1, and
// pass 2, the in-order merge of the per-tile candidates with the early-exit
// rule of the reference kernel.
//
// Logical tiles follow the reference's block_n rule (min(512, ceil128(N))):
// the row that is served under early exit depends on it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ctk {

constexpr int KMAX = 16;           // largest k taken (serving: 1 and 16)
constexpr int QB = 8;              // queries per pass-1 block
constexpr int WARPS = 8;           // one warp selects for one query
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_THREADS = 256;

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

__device__ inline float block_min(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = INFINITY;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fminf(m, red[w]);
  __syncthreads();                 // red is reused by the next call
  return m;
}

// Pass 2: one block walks the T logical tiles in order and merges each
// tile's top-k into the running top-k (run before tile on equal values,
// which with ascending tile order is the lowest-global-index tie rule).
// With early_exit it stops before the first tile t > 0 at which every
// query's running best is >= thr — the reference kernel's skip rule. A
// skip only ever drops later tiles, so this prefix merge equals the
// sequential kernel even though pass 1 computed every tile.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_tiles(const float* __restrict__ part_v, const int* __restrict__ part_i,
            int B, int T, int k, float thr, int early_exit,
            float* __restrict__ vals, int* __restrict__ idx,
            uint8_t* __restrict__ hit) {
  __shared__ float red[MERGE_THREADS / 32];
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    for (int j = 0; j < k; ++j) {
      vals[(size_t)b * k + j] = -INFINITY;
      idx[(size_t)b * k + j] = -1;
    }
  for (int t = 0; t < T; ++t) {
    if (early_exit && t > 0) {
      float m = INFINITY;
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        m = fminf(m, vals[(size_t)b * k]);
      if (block_min(m, red) >= thr) break;   // uniform over the block
    }
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      float rv[KMAX], nv[KMAX];
      int ri[KMAX], ni[KMAX];
      float* v = vals + (size_t)b * k;
      int* ix = idx + (size_t)b * k;
      const float* pv = part_v + ((size_t)b * T + t) * k;
      const int* pi = part_i + ((size_t)b * T + t) * k;
      for (int j = 0; j < k; ++j) { rv[j] = v[j]; ri[j] = ix[j]; }
      int i = 0, j = 0;
      for (int o = 0; o < k; ++o) {
        if (j >= k || (i < k && rv[i] >= pv[j])) {
          nv[o] = rv[i]; ni[o] = ri[i]; ++i;
        } else {
          nv[o] = pv[j]; ni[o] = pi[j]; ++j;
        }
      }
      for (int o = 0; o < k; ++o) { v[o] = nv[o]; ix[o] = ni[o]; }
    }
  }
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    for (int j = 0; j < k; ++j)
      if (!isfinite(vals[(size_t)b * k + j])) idx[(size_t)b * k + j] = -1;
    hit[b] = vals[(size_t)b * k] >= thr;
  }
}

}  // namespace ctk
