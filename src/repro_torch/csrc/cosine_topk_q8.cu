// K2: int8 dequant-cosine top-C for the exact margin rescore (DESIGN.md §15).
//
// Replaces the Pallas kernel src/repro/kernels/cosine_topk/kernel.py
// (cosine_topk_q8_kernel), called through ops.py cosine_topk_q8.
//
// The similarity of row j is (q . codes_j) * scale_j: fp32 FMAs of the
// widened codes against the f32 query, the scale applied once, after the
// reduction. The rescore proof assumes exactly this form, and QUANT_SLACK
// is the only room allowed for a different accumulation order. The hit mask
// and early exit compare against theta + margin.
//
// Bound on an H100: the codes are N * (Dp + 4) bytes (50.6 MB at N = 65,536,
// Dp = 768: 15 us at 3.35 TB/s); the work is 2 * B * N * Dp fp32 FMA-flops
// on the CUDA cores (never dp4a/IMMA on a quantised query, never TF32). Up
// to B = 8 that is bound by bytes; at B = 32 (64 flops a byte, above the
// fp32 ridge of about 20) by operations.
//
// Design. Pass 1 streams the code plane at the byte rate:
//   * one CTA of 16 warps per 512-row logical tile (128 CTAs at N = 65,536,
//     about one per SM); a warp takes 8 rows at a time, each row by a group
//     of 8 lanes, and each lane issues all its 16-byte loads for two rows
//     (12 at Dp = 768: 192 bytes a lane, about 96 KB a SM in flight) before
//     its first FMA;
//   * templated on the batch's query bucket NQ (1, 2, 4, 8, 16, 32; larger
//     B runs groups of 32 over grid.y): every code is widened once per
//     call, not once per 8-query block, with no FMA spent on a padded query
//     below the bucket. Widening is exact and costs a PRMT and an FADD
//     (2^23 + u - (2^23 + 128) for the biased byte u), not an I2F;
//   * queries sit in shared memory permuted so that the 8 lanes of a row
//     group read 128 contiguous bytes, which the 4 row groups share;
//   * the 2 x NQ (row, query) sums of a lane group are reduced by one
//     3-step halving butterfly (14 shuffles at NQ = 8, not 48), and the
//     tile's sims stay in shared memory for the per-query tile top-k.
// Pass 2 (topk_common.cuh, shared with K1) finds the early-exit stop tile
// from the per-tile bests in parallel and takes the top-k of the tiles
// before it, one block per query; it replaced a single-block sequential
// merge that took 63% of the old K2's device time at B = 4 on an H100
// (PERF.md).
#include "topk_common.cuh"

namespace ctk {

constexpr int Q8_WARPS = 16;
constexpr int Q8_THREADS = Q8_WARPS * 32;
constexpr int Q8_ROWS = 8;           // rows a warp takes at a time

// 4 int8 codes (one 32-bit word) to exact floats.
__device__ __forceinline__ void widen4(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;            // biased bytes, x + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i))
           - 8388736.0f;                           // 2^23 + 128
}

template <int NQ, int CPB>
__global__ void __launch_bounds__(Q8_THREADS, 1)
sims_tile_q8(const float* __restrict__ q, const int8_t* __restrict__ codes,
             const float* __restrict__ scales,
             const uint8_t* __restrict__ valid, int B, int N, int Dp, int k,
             int block_n, int T, float* __restrict__ part_v,
             int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // [NQ][Dp], permuted (see below)
  float* s_s = smem + NQ * Dp;           // [NQ][block_n]
  const int t = blockIdx.x, b0 = blockIdx.y * NQ;
  const int nq = min(NQ, B - b0);
  const int cpl = Dp / 128;              // 16-byte chunks a lane, a row
  // dim d = 16 (sub + 8 j) + 4 w + e lies at ((j * 4 + w) * 8 + sub) * 4 + e
  for (int e = threadIdx.x; e < NQ * Dp; e += blockDim.x) {
    const int qb = e / Dp, d = e - qb * Dp;
    const int c = d >> 4, w = (d >> 2) & 3, el = d & 3;
    const int sub = c & 7, j = c >> 3;
    q_s[qb * Dp + ((j * 4 + w) * 8 + sub) * 4 + el] =
        qb < nq ? q[(size_t)(b0 + qb) * Dp + d] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, sub = lane & 7;
  const int base = t * block_n;
  constexpr int M = 2 * NQ;
  for (int r0 = warp * Q8_ROWS; r0 < block_n; r0 += Q8_WARPS * Q8_ROWS) {
    const int ra = base + r0 + grp, rb = ra + 4;
    const bool oka = ra < N && r0 + grp < block_n && valid[ra];
    const bool okb = rb < N && r0 + grp + 4 < block_n && valid[rb];
    const int4* pa = reinterpret_cast<const int4*>(codes + (size_t)ra * Dp);
    const int4* pb = reinterpret_cast<const int4*>(codes + (size_t)rb * Dp);
    float acc[M];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < cpl; j0 += CPB) {
      int4 ca[CPB], cb[CPB];
#pragma unroll
      for (int j = 0; j < CPB; ++j) {      // every load before any FMA
        const bool in = j0 + j < cpl;
        const int c = sub + 8 * (j0 + j);
        ca[j] = in && oka ? __ldg(pa + c) : make_int4(0, 0, 0, 0);
        cb[j] = in && okb ? __ldg(pb + c) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < CPB; ++j) {
        if (j0 + j >= cpl) break;
        const int wa[4] = {ca[j].x, ca[j].y, ca[j].z, ca[j].w};
        const int wb[4] = {cb[j].x, cb[j].y, cb[j].z, cb[j].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float xa[4], xb[4];
          widen4((uint32_t)wa[w], xa);
          widen4((uint32_t)wb[w], xb);
          const float* qp = q_s + (((j0 + j) * 4 + w) * 8 + sub) * 4;
#pragma unroll
          for (int qb = 0; qb < NQ; ++qb) {
            const float4 qq = *reinterpret_cast<const float4*>(qp + qb * Dp);
            acc[qb] = fmaf(xa[0], qq.x, acc[qb]);
            acc[qb] = fmaf(xa[1], qq.y, acc[qb]);
            acc[qb] = fmaf(xa[2], qq.z, acc[qb]);
            acc[qb] = fmaf(xa[3], qq.w, acc[qb]);
            acc[NQ + qb] = fmaf(xb[0], qq.x, acc[NQ + qb]);
            acc[NQ + qb] = fmaf(xb[1], qq.y, acc[NQ + qb]);
            acc[NQ + qb] = fmaf(xb[2], qq.z, acc[NQ + qb]);
            acc[NQ + qb] = fmaf(xb[3], qq.w, acc[NQ + qb]);
          }
        }
      }
    }
    fold<M, 4>(acc, sub);
    // this lane now holds the sums off .. off + max(M / 8, 1) - 1; lanes
    // that share them after a plain step write the same values
    const int off = fold_base<M>(sub);
    constexpr int HOLD = M >= 8 ? M / 8 : 1;
#pragma unroll
    for (int i = 0; i < HOLD; ++i) {
      const int s_idx = off + i, r = s_idx / NQ, qb = s_idx - r * NQ;
      const int row = r ? rb : ra, col = r0 + grp + 4 * r;
      const bool ok = r ? okb : oka;
      if (col < block_n)
        s_s[qb * block_n + col] = ok ? acc[i] * scales[row] : -INFINITY;
    }
  }
  __syncthreads();
  for (int qb = warp; qb < nq; qb += Q8_WARPS)
    tile_topk(s_s + qb * block_n, block_n, k, base,
              part_v + ((size_t)(b0 + qb) * T + t) * k,
              part_i + ((size_t)(b0 + qb) * T + t) * k);
}

template <int NQ, int CPB>
cudaError_t launch_q8(const float* q, const int8_t* codes,
                      const float* scales, const uint8_t* valid, int B,
                      int N, int Dp, int k, int block_n, int T,
                      float* part_v, int* part_i, cudaStream_t s) {
  const int smem = (int)(sizeof(float) * (size_t)NQ * (Dp + block_n));
  static int allowed[64] = {};           // per device
  cudaError_t e = allow_smem(sims_tile_q8<NQ, CPB>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(T, (B + NQ - 1) / NQ);
  sims_tile_q8<NQ, CPB><<<grid, Q8_THREADS, smem, s>>>(
      q, codes, scales, valid, B, N, Dp, k, block_n, T, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace ctk

// q (B, Dp) f32, codes (>= N, Dp) int8, scales (N,) f32, valid (N,) bytes;
// Dp % 128 == 0; scratch part_v/part_i (B, T, k); outputs vals/idx (B, k),
// hit (B,). thr = f32(theta) + f32(margin). Returns cudaGetLastError() as
// an int.
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
    cudaError_t e;
    switch (query_bucket(B, Dp, block_n)) {
      case 1: e = launch_q8<1, 6>(q, codes, scales, valid, B, N, Dp, k,
                                  block_n, T, part_v, part_i, s); break;
      case 2: e = launch_q8<2, 6>(q, codes, scales, valid, B, N, Dp, k,
                                  block_n, T, part_v, part_i, s); break;
      case 4: e = launch_q8<4, 6>(q, codes, scales, valid, B, N, Dp, k,
                                  block_n, T, part_v, part_i, s); break;
      case 8: e = launch_q8<8, 6>(q, codes, scales, valid, B, N, Dp, k,
                                  block_n, T, part_v, part_i, s); break;
      case 16: e = launch_q8<16, 4>(q, codes, scales, valid, B, N, Dp, k,
                                    block_n, T, part_v, part_i, s); break;
      default: e = launch_q8<QGROUP, 2>(q, codes, scales, valid, B, N, Dp,
                                        k, block_n, T, part_v, part_i, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_merge(part_v, part_i, B, T, k, thr, early_exit, vals,
                           idx, hit, s);
}
