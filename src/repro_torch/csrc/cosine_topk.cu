// K1: f32 cosine top-k with the theta_R hit mask and early exit.
//
// Replaces the Pallas kernel src/repro/kernels/cosine_topk/kernel.py
// (cosine_topk_kernel + _merge_topk), called through ops.py cosine_topk.
//
// Bound on an H100: the lookup reads each valid row of the centroid plane
// once, Dp * 4 bytes a row (181.5 MB for the 59,089 valid rows of 65,536 at
// Dp = 768: 54 us at 3.35 TB/s), and does 2 * B * rows * Dp fp32 FMA-flops
// on the CUDA cores (never tensor cores, never TF32: a TF32 similarity can
// flip a theta decision). That is B / 2 flops a byte: bound by bytes up to
// B = 32, where the operations (67 TFLOP/s) take 80% of the bytes' time.
//
// Design. Pass 1 streams the plane at the byte rate:
//   * one CTA per 512-row logical tile (128 CTAs at N = 65,536, about one
//     per SM) of 16 warps (8 at B > 16, for registers). Each row is read
//     by a group of 8 lanes, each lane taking a 16-byte column of it every
//     128 bytes; a lane takes RG rows at a time and starts CPB loads for
//     each before its first FMA (8 a row at B <= 4: 256 bytes a lane, about
//     128 KB a SM in flight), the trip count fixed at compile time. A row
//     whose valid byte is 0 is never read;
//   * templated on the batch's query bucket NQ (1, 2, 4, 8, 16, 32; larger
//     B runs groups of 32 over grid.y), so no FMA or shared load is spent on
//     a query beyond the bucket;
//   * the queries sit in shared memory as they are: the 8 lanes of a group
//     read 128 contiguous bytes of a query, which the warp's other groups
//     share. For B > 8 the 4 groups split the bucket in two (QG = 2) and
//     take the same rows, so that each query float4 a lane loads feeds
//     RG = 4 rows: the load-to-FMA ratio, not the bytes, limits B = 32;
//   * the RG x NQ / QG sums of a lane group are reduced by one 3-step
//     halving butterfly (fold, topk_common.cuh), and the tile's sims stay
//     in shared memory for the per-query tile top-k (one pass for k = 1).
// Each logical tile hands pass 2 exactly one top-k list, so pass 2
// (topk_common.cuh, shared with K2) finds the early-exit stop tile from the
// per-tile bests and takes the top-k of the tiles before it, one block per
// query, which reproduces the sequential kernel's result. Work on tiles
// past the stop is not skipped: in a one-wave grid every tile starts at
// once.
#include "topk_common.cuh"

namespace ctk {

// Pass 1's shape for query bucket NQ (chip runs on an H100, PERF.md):
// WARPS a CTA; QG query groups the 4 lane groups of a warp split the bucket
// into (each group then takes the same rows with NQ / QG queries, so that
// each query float4 a lane loads from shared memory feeds RG rows); RG rows
// a lane takes at a time; CPB 16-byte loads a lane starts for each of its
// rows before its first FMA.
template <int NQ>
struct F32Shape {
  static constexpr int WARPS = NQ >= 32 ? 8 : 16;     // 32 takes 254 regs
  static constexpr int QG = NQ >= 16 ? 2 : 1;
  static constexpr int RG = NQ >= 16 ? 4 : 2;
  static constexpr int CPB = NQ <= 4 ? 8 : NQ <= 8 ? 6 : 4;
};

template <int NQ>
__global__ void __launch_bounds__(F32Shape<NQ>::WARPS * 32, 1)
sims_tile_f32(const float* __restrict__ q, const float* __restrict__ rows,
              const uint8_t* __restrict__ valid, int B, int N, int Dp, int k,
              int block_n, int T, float* __restrict__ part_v,
              int* __restrict__ part_i) {
  constexpr int WARPS = F32Shape<NQ>::WARPS, QG = F32Shape<NQ>::QG;
  constexpr int RG = F32Shape<NQ>::RG, CPB = F32Shape<NQ>::CPB;
  constexpr int SETS = 4 / QG;           // row sets a warp step covers
  constexpr int NQL = NQ / QG;           // queries a lane group takes
  constexpr int STEP = SETS * RG;        // rows a warp takes at a time
  constexpr int M = RG * NQL;            // sums a lane keeps
  static_assert(128 % (WARPS * STEP) == 0,
                "a CTA's row sweep must divide the 128-row tile unit");
  extern __shared__ float4 smem4[];
  const int nv = Dp / 4;                 // float4s a row
  float4* q_s = smem4;                   // [NQ][nv]
  float* s_s = reinterpret_cast<float*>(smem4 + NQ * nv);   // [NQ][block_n]
  const int t = blockIdx.x, b0 = blockIdx.y * NQ;
  const int nq = min(NQ, B - b0);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  for (int e = threadIdx.x; e < NQ * nv; e += blockDim.x) {
    const int qb = e / nv;
    q_s[e] = qb < nq ? __ldg(q4 + (size_t)b0 * nv + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, sub = lane & 7;
  const int set = grp % SETS, q0 = (grp / SETS) * NQL;
  const int base = t * block_n;
  const int cpl = Dp / 32;               // float4s a lane, a row
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const float4* qs = q_s + (size_t)q0 * nv + sub;
  // block_n is a multiple of 128, so every column lies inside the tile
  for (int r0 = warp * STEP; r0 < block_n; r0 += WARPS * STEP) {
    const float4* p[RG];
    bool ok[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int row = base + r0 + set + SETS * i;
      ok[i] = row < N && valid[row];
      p[i] = rows4 + (size_t)row * nv + sub;
    }
    float acc[M];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < cpl; j0 += CPB) {
      float4 x[RG][CPB];
#pragma unroll
      for (int j = 0; j < CPB; ++j) {      // every load before any FMA
        const bool in = j0 + j < cpl;
#pragma unroll
        for (int i = 0; i < RG; ++i)
          x[i][j] = in && ok[i] ? __ldg(p[i] + 8 * (j0 + j))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < CPB; ++j) {
        if (j0 + j >= cpl) break;
#pragma unroll
        for (int qb = 0; qb < NQL; ++qb) {
          const float4 qq = qs[qb * nv + 8 * (j0 + j)];
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            float& a = acc[i * NQL + qb];
            a = fmaf(x[i][j].x, qq.x, a);
            a = fmaf(x[i][j].y, qq.y, a);
            a = fmaf(x[i][j].z, qq.z, a);
            a = fmaf(x[i][j].w, qq.w, a);
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
    for (int h = 0; h < HOLD; ++h) {
      const int s_idx = off + h, i = s_idx / NQL, qb = s_idx - i * NQL;
      // ok[i] by selects, as i is not known at compile time
      bool oki = false;
#pragma unroll
      for (int r = 0; r < RG; ++r) oki = r == i ? ok[r] : oki;
      s_s[(q0 + qb) * block_n + r0 + set + SETS * i] =
          oki ? acc[h] : -INFINITY;
    }
  }
  __syncthreads();
  for (int qb = warp; qb < nq; qb += WARPS)
    tile_topk(s_s + qb * block_n, block_n, k, base,
              part_v + ((size_t)(b0 + qb) * T + t) * k,
              part_i + ((size_t)(b0 + qb) * T + t) * k);
}

template <int NQ>
cudaError_t launch_f32(const float* q, const float* rows,
                       const uint8_t* valid, int B, int N, int Dp, int k,
                       int block_n, int T, float* part_v, int* part_i,
                       cudaStream_t s) {
  const int smem = (int)(sizeof(float) * (size_t)NQ * (Dp + block_n));
  static int allowed[64] = {};           // per device
  cudaError_t e = allow_smem(sims_tile_f32<NQ>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(T, (B + NQ - 1) / NQ);
  sims_tile_f32<NQ><<<grid, F32Shape<NQ>::WARPS * 32, smem, s>>>(
      q, rows, valid, B, N, Dp, k, block_n, T, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace ctk

// q (B, Dp) f32, rows (>= N, Dp) f32, valid (N,) bytes; Dp % 128 == 0;
// scratch part_v/part_i (B, T, k); outputs vals/idx (B, k), hit (B,).
// Returns the launch status (cudaGetLastError) as an int.
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
    cudaError_t (*launch)(const float*, const float*, const uint8_t*, int,
                          int, int, int, int, int, float*, int*,
                          cudaStream_t);
    switch (query_bucket(B, Dp, block_n)) {
      case 1: launch = launch_f32<1>; break;
      case 2: launch = launch_f32<2>; break;
      case 4: launch = launch_f32<4>; break;
      case 8: launch = launch_f32<8>; break;
      case 16: launch = launch_f32<16>; break;
      default: launch = launch_f32<QGROUP>;
    }
    const cudaError_t e = launch(q, rows, valid, B, N, Dp, k, block_n, T,
                                 part_v, part_i, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_merge(part_v, part_i, B, T, k, theta, early_exit,
                           vals, idx, hit, s);
}
