// K3: flash-decoding. One query token per sequence against its KV cache,
// the G = H / Hkv query heads of a kv head batched together, per-sequence
// kv_len; the cache is bf16/f32, or int8 codes with per-(position, head)
// f16 scales dequantized inside the kernel.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel), called through ops.py decode_attention.
//
// Bound on an H100: decode reads the whole valid cache once and does
// 4 * H * Dh flops per cached position: at H = 40, Hkv = 8, Dh = 128 that is
// 20,480 flops per 4 KiB of bf16 k+v (5 flops per byte; 10 for int8), far
// under the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flops per byte):
// bound by bytes. What counts is reading each valid row once, in place,
// with enough CTAs in flight to fill the card.
//
// Design: pass 1 runs one CTA per (kv split, kv head, sequence). A split
// is a chunk of CHUNK cache positions; chunks at or past kv_len[b] exit at
// once, and positions >= kv_len[b] are neither read nor counted. The CTA
// holds the G query heads in shared memory, reads each K row once (a warp
// per row, lanes across Dh) for all G scores, takes the chunk's softmax
// (max m, sum l) and reads each V row once for the G partial outputs. With
// B = 4 and Hkv = 8 one CTA per (sequence, kv head) would occupy 32 of the
// 132 SMs; splitting the length gives 16 splits at kv_len 4,096. Pass 2
// combines the partial (m, l, acc) of the splits per head. The cache is
// read in place through its strides: no transposed or padded copy. In the
// int8 mode codes and f16 scales are widened to f32 and multiplied before
// the dot, the Pallas kernel's form. All arithmetic is fp32 on the CUDA
// cores; P is not rounded before P V.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace da {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int GMAX = 16;       // query heads per kv head
constexpr int DMAX = 256;      // head dim
constexpr int CHUNK = 256;     // cache positions per split

struct Args {
  const void* q;           // (B, H, Dh), q's dtype
  const void* k;           // (B, Lc, Hkv, Dh)
  const void* v;
  const __half* ks;        // (B, Lc, Hkv) or null
  const __half* vs;
  const int* kv_len;       // (B,)
  void* o;                 // contiguous (B, H, Dh), q's dtype
  float* part_ml;          // (B, Hkv, S, G, 2)
  float* part_acc;         // (B, Hkv, S, G, Dh)
  int B, H, Hkv, Dh, Lc;
  long long qsB, qsH, csB, csL, csH, ssB, ssL, ssH;
  int n_split, q_bf16;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename KT, bool Q8>
__global__ void __launch_bounds__(THREADS)
decode_split(Args a) {
  __shared__ float qs[GMAX * DMAX];
  __shared__ float ps[GMAX * CHUNK];
  __shared__ float vsc[CHUNK];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, Dh = a.Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(a.kv_len[b], 0), a.Lc);
  const int start = split * CHUNK, n = min(CHUNK, len - start);
  const long long pidx = ((long long)b * a.Hkv + hk) * a.n_split + split;
  float* ml = a.part_ml + pidx * G * 2;
  float* pacc = a.part_acc + pidx * G * Dh;
  if (n <= 0) {                            // chunk past kv_len: empty
    for (int e = threadIdx.x; e < G; e += THREADS) {
      ml[2 * e] = -INFINITY;
      ml[2 * e + 1] = 0.f;
    }
    return;                                // pass 2 never reads its acc
  }
  for (int e = threadIdx.x; e < G * Dh; e += THREADS) {
    const int g = e / Dh, d = e - g * Dh;
    const long long qi = b * a.qsB + (long long)(hk * G + g) * a.qsH + d;
    qs[g * DMAX + d] =
        a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                 : static_cast<const float*>(a.q)[qi];
  }
  const KT* kbase = static_cast<const KT*>(a.k) + b * a.csB +
                    (long long)start * a.csL + hk * a.csH;
  const KT* vbase = static_cast<const KT*>(a.v) + b * a.csB +
                    (long long)start * a.csL + hk * a.csH;
  const long long sbase = b * a.ssB + (long long)start * a.ssL + hk * a.ssH;
  if (Q8) {
    for (int j = threadIdx.x; j < n; j += THREADS)
      vsc[j] = __half2float(a.vs[sbase + j * a.ssL]);
  }
  __syncthreads();

  // scores: a warp per K row, lanes across Dh, all G heads at once
  for (int j = warp; j < n; j += WARPS) {
    const KT* kr = kbase + j * a.csL;
    const float ksc = Q8 ? __half2float(a.ks[sbase + j * a.ssL]) : 1.f;
    float part[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
    for (int d = lane; d < Dh; d += 32) {
      const float kf = Q8 ? to_f32(kr[d]) * ksc : to_f32(kr[d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) part[g] = fmaf(qs[g * DMAX + d], kf, part[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float s = warp_sum(part[g]);
        if (lane == 0) ps[g * CHUNK + j] = s * a.scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, a warp per head: p = exp(s - m), l = sum p
  for (int g = warp; g < G; g += WARPS) {
    float* pr = ps + g * CHUNK;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pr[j] - m);
      pr[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * g] = m;
      ml[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // partial P V: a thread per column, each V row read once for all heads
  for (int d = threadIdx.x; d < Dh; d += THREADS) {
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    for (int j = 0; j < n; ++j) {
      const KT x = vbase[j * a.csL + d];
      const float vf = Q8 ? to_f32(x) * vsc[j] : to_f32(x);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = fmaf(ps[g * CHUNK + j], vf, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) pacc[g * Dh + d] = acc[g];
  }
}

// pass 2: one CTA per (head, sequence) merges the splits' (m, l, acc)
__global__ void __launch_bounds__(THREADS)
decode_combine(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv, hk = h / G, g = h - hk * G, Dh = a.Dh;
  const long long p0 = ((long long)b * a.Hkv + hk) * a.n_split;
  float M = -INFINITY;
  for (int s = 0; s < a.n_split; ++s)
    M = fmaxf(M, a.part_ml[((p0 + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < Dh; d += THREADS) {
    float acc = 0.f, l = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float* ml = a.part_ml + ((p0 + s) * G + g) * 2;
      if (ml[0] == -INFINITY) continue;    // empty split
      const float w = expf(ml[0] - M);
      l = fmaf(ml[1], w, l);
      acc = fmaf(a.part_acc[((p0 + s) * G + g) * Dh + d], w, acc);
    }
    const float out = l > 0.f ? acc / l : 0.f;
    const long long oi = ((long long)b * a.H + h) * Dh + d;
    if (a.q_bf16)
      static_cast<__nv_bfloat16*>(a.o)[oi] = __float2bfloat16(out);
    else
      static_cast<float*>(a.o)[oi] = out;
  }
}

}  // namespace da

// q (B, H, Dh) with unit stride in Dh; k/v caches (B, Lc, Hkv, Dh) sharing
// the strides csB, csL, csH (unit stride in Dh); kv_kind 0 = f32,
// 1 = bf16, 2 = int8 codes with f16 scales ks/vs (B, Lc, Hkv) sharing
// ssB, ssL, ssH; kv_len (B,) int32; o contiguous (B, H, Dh) of q's dtype;
// part_ml (B, Hkv, n_split, G, 2) and part_acc (B, Hkv, n_split, G, Dh) f32
// scratch, n_split = ceil(Lc / chunk). Returns the launch status.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const int* kv_len, void* o, float* part_ml,
    float* part_acc, long long B, long long H, long long Hkv, long long Dh,
    long long Lc, long long qsB, long long qsH, long long csB, long long csL,
    long long csH, long long ssB, long long ssL, long long ssH,
    long long n_split, long long q_bf16, long long kv_kind,
    long long chunk, void* stream) {
  using namespace da;
  if (chunk != CHUNK || Dh > DMAX || H / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const __half*>(ks),
         static_cast<const __half*>(vs), kv_len, o, part_ml, part_acc,
         (int)B, (int)H, (int)Hkv, (int)Dh, (int)Lc, qsB, qsH, csB, csL, csH,
         ssB, ssL, ssH, (int)n_split, (int)q_bf16, 1.0f / sqrtf((float)Dh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  dim3 grid1((unsigned)n_split, (unsigned)Hkv, (unsigned)B);
  if (kv_kind == 2)
    decode_split<int8_t, true><<<grid1, THREADS, 0, s>>>(a);
  else if (kv_kind == 1)
    decode_split<__nv_bfloat16, false><<<grid1, THREADS, 0, s>>>(a);
  else
    decode_split<float, false><<<grid1, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<<<dim3((unsigned)H, (unsigned)B), THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
