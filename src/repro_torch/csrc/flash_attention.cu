// K4: prefill flash attention (online softmax) with GQA, causal, sliding
// window, bidirectional prefix and a ragged per-sequence kv length.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel), called through ops.py flash_attention; the mask
// is the model layer's (src/repro/models/layers.py flash_attention), which
// equals the Pallas kernel's wherever that one is defined.
//
// Bound on an H100: prefill at L = 4,096, H = 40, Dh = 128 does
// 4 * L^2 / 2 * H * Dh = 172 GFLOP per layer (the causal half) on 100 MB
// of q/k/v/o, about 1,700 flops per byte, far over the bf16 tensor-core
// ridge (989 TFLOP/s over 3.35 TB/s = 295 flops per byte): bound by
// operations. The embedder's f32 attention (L = 24) is tiny and bound by
// launch latency.
//
// Design: one CTA per (q tile, head, batch). Head h reads kv head
// h / (H / Hkv) in place, through the caller's strides: no transposed or
// padded copy. The CTA loops over kv tiles, keeping the running max m, sum
// l and accumulator in registers (bf16) or shared memory (f32), and divides
// by l at the end (0 for a fully masked row). The loop bounds skip the kv
// tiles that the causal mask or the window masks entirely, and tiles past
// the sequence's kv length.
//   * bf16: 4 warps, 16 query rows each (64-row q tile), 64 keys a tile
//     (32 at Dh = 256). S = Q K^T and O += P V on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate; the products are exact in
//     f32). P is rounded to bf16 before P V, as the model layer does; the
//     softmax and l stay f32. Plain loads into padded shared rows (no
//     cp.async, no TMA, no wgmma yet): simple first.
//   * f32: CUDA-core FMAs in full fp32, never TF32 (a TF32 score moves the
//     embedding and can flip a theta_R decision). 16-row q tile, 32-key kv
//     tile, one warp per query row in the softmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int THREADS = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                 // contiguous (B, Lq, H, Dh), q's dtype
  const int* kv_valid;     // (B,) or null
  int B, Lq, Lkv, H, Hkv, Dh;
  long long qsB, qsL, qsH, ksB, ksL, ksH, vsB, vsL, vsH;
  int causal, window, prefix_len, q_offset;   // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp,
                                        int kvlim) {
  if (kp >= kvlim) return false;
  bool ok = true;
  if (a.causal) ok = kp <= qp;
  if (a.window > 0) ok = ok && (qp - kp < a.window);
  return ok || kp < a.prefix_len;
}

// The kv range [k_begin, k_end) a q tile with positions [q_lo, q_hi] needs.
__device__ __forceinline__ void kv_range(const Args& a, int q_lo, int q_hi,
                                         int kvlim, int* k_begin,
                                         int* k_end) {
  int end = kvlim;
  if (a.causal) end = min(end, max(q_hi + 1, a.prefix_len));
  int begin = 0;
  if (a.window > 0 && a.prefix_len == 0) begin = max(0, q_lo - a.window + 1);
  *k_begin = begin;
  *k_end = max(end, 0);
}

// True when every (query, key) of the tile is masked: the tile lies wholly
// after the newest query (causal) or before the oldest one's window, and
// holds no prefix key.
__device__ __forceinline__ bool tile_masked(const Args& a, int q_lo, int q_hi,
                                            int k0, int k1) {
  if (k0 < a.prefix_len) return false;
  if (a.causal && k0 > q_hi) return true;
  return a.window > 0 && q_lo - (k1 - 1) >= a.window;
}

__device__ __forceinline__ int kv_limit(const Args& a, int b) {
  return a.kv_valid ? min(a.Lkv, max(a.kv_valid[b], 0)) : a.Lkv;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x DP tile of bf16 into shared rows of stride SD (zero past Dh and
// past n_valid rows). src points at row 0, element 0; rows are rs apart.
template <int DP, int SD>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long rs, int rows,
                                               int n_valid, int Dh,
                                               bool vec) {
  if (vec) {                              // 16-byte chunks, Dh % 8 == 0
    constexpr int CH = DP / 8;
    for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
      const int r = e / CH, d = (e - r * CH) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < n_valid && d < Dh)
        x = *reinterpret_cast<const uint4*>(src + r * rs + d);
      *reinterpret_cast<uint4*>(dst + r * SD + d) = x;
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
      const int r = e / DP, d = e - r * DP;
      dst[r * SD + d] = (r < n_valid && d < Dh) ? src[r * rs + d]
                                                : __float2bfloat16(0.f);
    }
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bf16(Args a, int vec) {
  constexpr int BQ = 64, SD = DP + 8, NT = BK / 8, NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * SD;
  __nv_bfloat16* Vs = Ks + BK * SD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * BQ;
  const int kvlim = kv_limit(a, b);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  load_rows_bf16<DP, SD>(Qs, q + b * a.qsB + row0 * a.qsL + h * a.qsH,
                         a.qsL, BQ, min(BQ, a.Lq - row0), a.Dh, vec);

  // this thread's two query rows: r0 = warp*16 + g, r1 = r0 + 8
  const int qp0 = a.q_offset + row0 + warp * 16 + g, qp1 = qp0 + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(row0 + BQ, a.Lq) - 1;
  int k_begin, k_end;
  kv_range(a, q_lo, q_hi, kvlim, &k_begin, &k_end);
  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    if (tile_masked(a, q_lo, q_hi, k0, k0 + BK)) continue;   // CTA-uniform
    __syncthreads();                       // previous tile fully consumed
    const int nk = min(BK, kvlim - k0);
    load_rows_bf16<DP, SD>(Ks, k + b * a.ksB + k0 * a.ksL + hk * a.ksH,
                           a.ksL, BK, nk, a.Dh, vec);
    load_rows_bf16<DP, SD>(Vs, v + b * a.vsB + k0 * a.vsL + hk * a.vsH,
                           a.vsL, BK, nk, a.Dh, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* qw = Qs + (warp * 16) * SD;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[4];
      const __nv_bfloat16* qb = qw + kk * 16 + t * 2;
      af[0] = *reinterpret_cast<const uint32_t*>(qb + g * SD);
      af[1] = *reinterpret_cast<const uint32_t*>(qb + (g + 8) * SD);
      af[2] = *reinterpret_cast<const uint32_t*>(qb + g * SD + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(qb + (g + 8) * SD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * SD + kk * 16 + t * 2;
        mma_bf16(s[n], af, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // scale, mask, online softmax (rows r0 and r1; a quad shares a row)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + t * 2 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        s[n][e] = allowed(a, qp, kp, kvlim) ? s[n][e] * a.scale : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    }
    float alpha[2], safe[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      safe[r] = mn == -INFINITY ? 0.f : mn;
      alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - safe[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f
                                             : expf(s[n][e] - safe[e >> 1]);
        s[n][e] = p;
        ls[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l[r] = alpha[r] * l[r] + ls[r];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }

    // O += P V: P from the S accumulators (bf16), V (keys x Dh) from smem
    const uint16_t* vs = reinterpret_cast<const uint16_t*>(Vs);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vk = vs + (kk * 16 + t * 2) * SD + g;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const uint16_t* vp = vk + i * 8;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[SD] << 16);
        const uint32_t b1 = (uint32_t)vp[8 * SD] | ((uint32_t)vp[9 * SD] << 16);
        mma_bf16(o[i], pf, b0, b1);
      }
    }
  }

  // out = O / l (0 for a fully masked row)
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= a.Lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = out + (((long long)b * a.Lq + row) * a.H + h) * a.Dh;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = i * 8 + t * 2 + e;
        if (d < a.Dh) orow[d] = __float2bfloat16(o[i][2 * r + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, no TF32
// ---------------------------------------------------------------------------

constexpr int BQF = 16, BKF = 32;

__global__ void __launch_bounds__(THREADS)
flash_f32(Args a) {
  extern __shared__ float fsm[];
  const int Dh = a.Dh;
  float* Qs = fsm;                        // [BQF][Dh]
  float* Ks = Qs + BQF * Dh;              // [BKF][Dh + 1]
  float* Vs = Ks + BKF * (Dh + 1);        // [BKF][Dh]
  float* Ps = Vs + BKF * Dh;              // [BQF][BKF]
  float* Acc = Ps + BQF * BKF;            // [BQF][Dh]
  float* Alpha = Acc + BQF * Dh;          // [BQF]
  float* Lsum = Alpha + BQF;              // [BQF]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = qt * BQF;
  const int kvlim = kv_limit(a, b);
  const float* q = static_cast<const float*>(a.q) + b * a.qsB + h * a.qsH;
  const float* k = static_cast<const float*>(a.k) + b * a.ksB + hk * a.ksH;
  const float* v = static_cast<const float*>(a.v) + b * a.vsB + hk * a.vsH;

  for (int e = threadIdx.x; e < BQF * Dh; e += THREADS) {
    const int r = e / Dh, d = e - r * Dh;
    Qs[e] = row0 + r < a.Lq ? q[(row0 + r) * a.qsL + d] : 0.f;
    Acc[e] = 0.f;
  }
  // warp w owns rows w, w + 4, w + 8, w + 12 in the softmax
  constexpr int RW = BQF / 4;
  float m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) { m[i] = -INFINITY; l[i] = 0.f; }

  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(row0 + BQF, a.Lq) - 1;
  int k_begin, k_end;
  kv_range(a, q_lo, q_hi, kvlim, &k_begin, &k_end);
  for (int k0 = k_begin / BKF * BKF; k0 < k_end; k0 += BKF) {
    if (tile_masked(a, q_lo, q_hi, k0, k0 + BKF)) continue;   // CTA-uniform
    __syncthreads();
    const int nk = min(BKF, kvlim - k0);
    for (int e = threadIdx.x; e < BKF * Dh; e += THREADS) {
      const int r = e / Dh, d = e - r * Dh;
      const bool in = r < nk;
      Ks[r * (Dh + 1) + d] = in ? k[(k0 + r) * a.ksL + d] : 0.f;
      Vs[e] = in ? v[(k0 + r) * a.vsL + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + 4 * i;
      const int qp = a.q_offset + row0 + r, kp = k0 + lane;
      const float* qr = Qs + r * Dh;
      const float* kr = Ks + lane * (Dh + 1);
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(qr[d], kr[d], acc);
      const float s = allowed(a, qp, kp, kvlim) ? acc * a.scale : -INFINITY;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float safe = mn == -INFINITY ? 0.f : mn;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      const float p = s == -INFINITY ? 0.f : expf(s - safe);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      m[i] = mn;
      l[i] = alpha * l[i] + ps;
      Ps[r * BKF + lane] = p;
      if (lane == 0) Alpha[r] = alpha;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BQF * Dh; e += THREADS) {
      const int r = e / Dh, d = e - r * Dh;
      const float* pr = Ps + r * BKF;
      float acc = Acc[e] * Alpha[r];
      for (int c = 0; c < BKF; ++c) acc = fmaf(pr[c], Vs[c * Dh + d], acc);
      Acc[e] = acc;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) Lsum[warp + 4 * i] = l[i];
  }
  __syncthreads();
  float* out = static_cast<float*>(a.o);
  for (int e = threadIdx.x; e < BQF * Dh; e += THREADS) {
    const int r = e / Dh, d = e - r * Dh;
    if (row0 + r >= a.Lq) continue;
    const float lr = Lsum[r];
    out[(((long long)b * a.Lq + row0 + r) * a.H + h) * Dh + d] =
        lr > 0.f ? Acc[e] / lr : 0.f;
  }
}

template <int DP, int BK>
cudaError_t launch_bf16(const Args& a, int vec, cudaStream_t s) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(64 + 2 * BK) * (DP + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + 63) / 64, a.H, a.B);
  flash_bf16<DP, BK><<<grid, THREADS, smem, s>>>(a, vec);
  return cudaGetLastError();
}

}  // namespace fa

// q (B, Lq, H, Dh), k/v (B, Lkv, Hkv, Dh), each with unit stride in Dh and
// the given element strides for B, L, H; o contiguous (B, Lq, H, Dh) of q's
// dtype (bf16 when is_bf16, else f32); kv_valid (B,) int32 or null;
// window <= 0 means none. Dh <= 256. Returns the launch status.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_valid,
    long long B, long long Lq, long long Lkv, long long H, long long Hkv,
    long long Dh, long long qsB, long long qsL, long long qsH, long long ksB,
    long long ksL, long long ksH, long long vsB, long long vsL, long long vsH,
    long long causal, long long window, long long prefix_len,
    long long q_offset, long long is_bf16, void* stream) {
  using namespace fa;
  Args a{q, k, v, o, kv_valid, (int)B, (int)Lq, (int)Lkv, (int)H, (int)Hkv,
         (int)Dh, qsB, qsL, qsH, ksB, ksL, ksH, vsB, vsL, vsH, (int)causal,
         (int)window, (int)prefix_len, (int)q_offset,
         1.0f / sqrtf((float)Dh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Lq == 0 || H == 0) return 0;
  if (is_bf16) {
    const bool vec =
        Dh % 8 == 0 && qsB % 8 == 0 && qsL % 8 == 0 && qsH % 8 == 0 &&
        ksB % 8 == 0 && ksL % 8 == 0 && ksH % 8 == 0 && vsB % 8 == 0 &&
        vsL % 8 == 0 && vsH % 8 == 0 &&
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    if (Dh <= 64) return (int)launch_bf16<64, 64>(a, vec, s);
    if (Dh <= 128) return (int)launch_bf16<128, 64>(a, vec, s);
    return (int)launch_bf16<256, 32>(a, vec, s);
  }
  const size_t smem = sizeof(float) *
      (size_t)(BQF * Dh + BKF * (Dh + 1) + BKF * Dh + BQF * BKF + BQF * Dh +
               2 * BQF);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((Lq + BQF - 1) / BQF), (unsigned)H, (unsigned)B);
  flash_f32<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}
