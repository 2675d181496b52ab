// K1: f32 cosine top-k with the theta_R hit mask and early exit.
//
// Replaces the Pallas kernel src/repro/kernels/cosine_topk/kernel.py
// (cosine_topk_kernel + _merge_topk), called through ops.py cosine_topk.
//
// Bound on an H100: at serving batch sizes (B <= 32) the lookup reads the
// whole centroid plane once, N * Dp * 4 bytes, and does 2 * B * N * Dp fp32
// FMA-flops on the CUDA cores (never tensor cores, never TF32: a TF32
// similarity can flip a theta decision). At B = 8 and Dp = 768 that is
// 2 flops per byte, under the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte), so it is bound by bytes.
//
// Design: pass 1 is a grid over (logical tile, block of 8 queries). Each
// warp streams whole rows with coalesced 16-byte loads and does the 8 dot
// products against queries held in shared memory, so each row is read
// once per 8 queries; the tile's sims stay in shared memory and one warp
// per query selects the tile's top-k. Pass 2 (topk_common.cuh, shared with
// K2) finds the early-exit stop tile from a prefix over the per-tile bests
// and takes the top-k of the tiles before it, one warp per query, which
// reproduces the sequential kernel's result. Work on tiles that early exit
// skips is not saved yet.
#include "topk_common.cuh"

namespace ctk {

__global__ void __launch_bounds__(THREADS)
sims_tile_f32(const float* __restrict__ q, const float* __restrict__ rows,
              const uint8_t* __restrict__ valid, int B, int N, int Dp, int k,
              int block_n, int T, float* __restrict__ part_v,
              int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // [QB][Dp]
  float* s_s = smem + QB * Dp;           // [QB][block_n]
  const int t = blockIdx.x, b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  for (int e = threadIdx.x; e < QB * Dp; e += blockDim.x) {
    const int qb = e / Dp;
    q_s[e] = qb < nq ? q[(size_t)(b0 + qb) * Dp + (e - qb * Dp)] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = t * block_n;
  const int nvec = Dp / 4;               // Dp % 128 == 0
  for (int r = warp; r < block_n; r += WARPS) {
    const int row = base + r;
    const bool ok = row < N && valid[row];   // uniform over the warp
    float acc[QB];
#pragma unroll
    for (int qb = 0; qb < QB; ++qb) acc[qb] = 0.f;
    if (ok) {
      const float4* rp =
          reinterpret_cast<const float4*>(rows + (size_t)row * Dp);
      for (int c = lane; c < nvec; c += 32) {
        const float4 x = __ldg(rp + c);
#pragma unroll
        for (int qb = 0; qb < QB; ++qb) {
          const float4 qv = reinterpret_cast<const float4*>(q_s + qb * Dp)[c];
          acc[qb] = fmaf(x.x, qv.x, acc[qb]);
          acc[qb] = fmaf(x.y, qv.y, acc[qb]);
          acc[qb] = fmaf(x.z, qv.z, acc[qb]);
          acc[qb] = fmaf(x.w, qv.w, acc[qb]);
        }
      }
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) acc[qb] = warp_sum(acc[qb]);
    }
    if (lane == 0) {
#pragma unroll
      for (int qb = 0; qb < QB; ++qb)
        s_s[qb * block_n + r] = ok ? acc[qb] : -INFINITY;
    }
  }
  __syncthreads();
  if (warp < nq)
    tile_topk(s_s + warp * block_n, block_n, k, base,
              part_v + ((size_t)(b0 + warp) * T + t) * k,
              part_i + ((size_t)(b0 + warp) * T + t) * k);
}

}  // namespace ctk

// q (B, Dp) f32, rows (>= N, Dp) f32, valid (N,) bytes; scratch
// part_v/part_i (B, T, k); outputs vals/idx (B, k), hit (B,). Returns the
// launch status (cudaGetLastError) as an int.
extern "C" int cosine_topk_f32(const float* q, const float* rows,
                               const uint8_t* valid, float* part_v,
                               int* part_i, float* vals, int* idx,
                               uint8_t* hit, int B, int N, int Dp, int k,
                               int block_n, float theta, int early_exit,
                               void* stream) {
  using namespace ctk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (N + block_n - 1) / block_n;
  if (T > 0) {
    const size_t smem = sizeof(float) * (size_t)QB * (Dp + block_n);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(sims_tile_f32,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid(T, (B + QB - 1) / QB);
    sims_tile_f32<<<grid, THREADS, smem, s>>>(q, rows, valid, B, N, Dp, k,
                                              block_n, T, part_v, part_i);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_merge(part_v, part_i, B, T, k, theta, early_exit,
                           vals, idx, hit, s);
}
