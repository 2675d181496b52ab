// K2: int8 dequant-cosine top-C for the exact margin rescore (DESIGN.md §15).
//
// Replaces the Pallas kernel src/repro/kernels/cosine_topk/kernel.py
// (cosine_topk_q8_kernel), called through ops.py cosine_topk_q8.
//
// The similarity of row j is (q . codes_j) * scale_j, with the scale applied
// once, after the reduction: the rescore proof assumes exactly this form,
// and QUANT_SLACK is the only room allowed for a different accumulation
// order. The hit mask and early exit compare against theta + margin.
//
// Bound on an H100: the codes are a quarter of the f32 bytes (N * Dp), but
// the flops are the same 2 * B * N * Dp fp32 FMAs on the CUDA cores, plus
// one int8 -> f32 widening per code and query block. At B = 32 and
// Dp = 768 that is 64 flops per byte, above the fp32 ridge of about 20, so
// it is bound by operations; at B = 1 it is bound by bytes.
//
// Design: as K1 (cosine_topk.cu), but each lane loads 16 codes (16 bytes)
// at a time, widens them to f32 and feeds 8 queries from shared memory, so
// each code is widened once per 8 queries. Pass 2 is shared with K1.
#include "topk_common.cuh"

namespace ctk {

__global__ void __launch_bounds__(THREADS)
sims_tile_q8(const float* __restrict__ q, const int8_t* __restrict__ codes,
             const float* __restrict__ scales,
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
  const int nchunk = Dp / 16;            // 16 codes per 16-byte load
  for (int r = warp; r < block_n; r += WARPS) {
    const int row = base + r;
    const bool ok = row < N && valid[row];   // uniform over the warp
    float acc[QB];
#pragma unroll
    for (int qb = 0; qb < QB; ++qb) acc[qb] = 0.f;
    if (ok) {
      const int4* rp = reinterpret_cast<const int4*>(codes + (size_t)row * Dp);
      for (int c = lane; c < nchunk; c += 32) {
        const int4 raw = __ldg(rp + c);
        const int w[4] = {raw.x, raw.y, raw.z, raw.w};
        float x[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          x[i] = (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xff);
#pragma unroll
        for (int qb = 0; qb < QB; ++qb) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + qb * Dp + c * 16);
#pragma unroll
          for (int v4 = 0; v4 < 4; ++v4) {
            const float4 qq = qv[v4];
            acc[qb] = fmaf(x[4 * v4 + 0], qq.x, acc[qb]);
            acc[qb] = fmaf(x[4 * v4 + 1], qq.y, acc[qb]);
            acc[qb] = fmaf(x[4 * v4 + 2], qq.z, acc[qb]);
            acc[qb] = fmaf(x[4 * v4 + 3], qq.w, acc[qb]);
          }
        }
      }
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) acc[qb] = warp_sum(acc[qb]);
    }
    if (lane == 0) {
      const float sc = ok ? scales[row] : 0.f;
#pragma unroll
      for (int qb = 0; qb < QB; ++qb)
        s_s[qb * block_n + r] = ok ? acc[qb] * sc : -INFINITY;
    }
  }
  __syncthreads();
  if (warp < nq)
    tile_topk(s_s + warp * block_n, block_n, k, base,
              part_v + ((size_t)(b0 + warp) * T + t) * k,
              part_i + ((size_t)(b0 + warp) * T + t) * k);
}

}  // namespace ctk

// q (B, Dp) f32, codes (>= N, Dp) int8, scales (N,) f32, valid (N,) bytes;
// scratch part_v/part_i (B, T, k); outputs vals/idx (B, k), hit (B,).
// thr = f32(theta) + f32(margin). Returns cudaGetLastError() as an int.
extern "C" int cosine_topk_q8(const float* q, const int8_t* codes,
                              const float* scales, const uint8_t* valid,
                              float* part_v, int* part_i, float* vals,
                              int* idx, uint8_t* hit, int B, int N, int Dp,
                              int k, int block_n, float thr, int early_exit,
                              void* stream) {
  using namespace ctk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (N + block_n - 1) / block_n;
  if (T > 0) {
    const size_t smem = sizeof(float) * (size_t)QB * (Dp + block_n);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(sims_tile_q8,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid(T, (B + QB - 1) / QB);
    sims_tile_q8<<<grid, THREADS, smem, s>>>(q, codes, scales, valid, B, N,
                                             Dp, k, block_n, T, part_v,
                                             part_i);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  merge_tiles<<<1, MERGE_THREADS, 0, s>>>(part_v, part_i, B, T, k, thr,
                                          early_exit, vals, idx, hit);
  return (int)cudaGetLastError();
}
