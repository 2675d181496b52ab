// K5: the RWKV6 (Finch) WKV recurrence. Per (sequence, head), with K = V:
//
//     y_t[v]    = sum_k r_t[k] (S[k][v] + u[k] k_t[k] v_t[v])
//     S[k][v]  <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// in f32, y before the update, the state carried in and out.
//
// Replaces no Pallas kernel: the reference runs this as a jnp step scan,
// src/repro/models/ssm.py:93 (rwkv6_linear_attention), which XLA compiles
// into one loop on the TPU. A port extension held against that function
// (kernels/wkv6/ref.py is its plain version). The reference pads L up to
// a multiple of its chunk with w = 1 and k = 0; those steps leave S as it
// was, so the kernel runs the L real steps only.
//
// Bound on an H100: the function needs 5 K V + O(K + V) flops a (token,
// head). The bonus factorises, y[v] = sum_k r[k] S[k][v] + v[v] sum_k
// r[k] u[k] k[k], so per state entry it is one FMA for y, then a multiply
// and an FMA for the update. At rwkv6-7b's prefill (B 1, L 2,048, H 64,
// K = V 64) that is 2.73 GFLOP of fp32 CUDA-core work (0.041 ms at 67
// TFLOP/s) against 119.5 MB read or written once (0.036 ms at 3.35
// TB/s): bound by operations. This kernel does 7 K V (it adds u k v to
// each entry before the dot with r). The recurrence is sequential in L,
// and at B = 1 only B x H = 64 (sequence, head) pairs are independent.
//
// Design (simple first; its speed is later work):
// - One CTA per (head, sequence); thread j owns the state column S[:, j]
//   in KP registers (KP = K padded to 16, 32 or 64; the padded rows stay 0
//   because their r, k and u are 0). Threads past K only help stage.
// - A tile of TT time steps' r, k, w and v (widened to f32; rows past K
//   and steps past L zero) is staged in shared memory by all threads, read
//   in place through the tensors' strides; u once. Each step then reads
//   r, k, w and u as float4 broadcasts and does, per k: kv = k v_j,
//   y += r (S + u kv), S = w S + kv, in the reference's order (y from
//   the state before the step). Four partial sums of y shorten the
//   dependence chain. y is written straight to device memory (consecutive
//   threads, consecutive columns).
// - fp32 FFMAs only; no tensor cores, no TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wkv {

constexpr int TT = 32;   // time steps staged per tile

__device__ __forceinline__ float widen(const float* p) { return *p; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;
  float* y;
  float* s_out;
  long long rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB, wsL, wsH;
  int B, L, H, K;
};

template <typename T, int KP>
__global__ void __launch_bounds__(KP < 32 ? 32 : KP) wkv6_fwd(Args a) {
  constexpr int NT = KP < 32 ? 32 : KP;
  __shared__ __align__(16) float rs[TT][KP];
  __shared__ __align__(16) float ks[TT][KP];
  __shared__ __align__(16) float ws[TT][KP];
  __shared__ __align__(16) float vs[TT][KP];
  __shared__ __align__(16) float us[KP];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int K = a.K;
  const T* R = static_cast<const T*>(a.r) + b * a.rsB + h * a.rsH;
  const T* Kp = static_cast<const T*>(a.k) + b * a.ksB + h * a.ksH;
  const T* V = static_cast<const T*>(a.v) + b * a.vsB + h * a.vsH;
  const float* W = a.w + b * a.wsB + h * a.wsH;
  const long long sbase = ((long long)b * a.H + h) * K * K;

  float S[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i)
    S[i] = (j < K && i < K) ? a.s_in[sbase + (long long)i * K + j] : 0.f;
  for (int i = j; i < KP; i += NT) us[i] = i < K ? a.u[h * K + i] : 0.f;

  for (int t0 = 0; t0 < a.L; t0 += TT) {
    const int nt = min(TT, a.L - t0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = j; e < TT * KP; e += NT) {
      const int tt = e / KP, i = e % KP;
      float rv = 0.f, kv = 0.f, wv = 0.f, vv = 0.f;
      if (tt < nt && i < K) {
        const long long t = t0 + tt;
        rv = widen(R + t * a.rsL + i);
        kv = widen(Kp + t * a.ksL + i);
        vv = widen(V + t * a.vsL + i);
        wv = W[t * a.wsL + i];
      }
      rs[tt][i] = rv;
      ks[tt][i] = kv;
      ws[tt][i] = wv;
      vs[tt][i] = vv;
    }
    __syncthreads();
    if (j < KP) {
      for (int tt = 0; tt < nt; ++tt) {
        const float vj = vs[tt][j];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < KP; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i]);
          const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float kv = kk[c] * vj;
            acc[c] = fmaf(rr[c], fmaf(uu[c], kv, S[i + c]), acc[c]);
            S[i + c] = fmaf(ww[c], S[i + c], kv);
          }
        }
        if (j < K)
          a.y[(((long long)b * a.L + t0 + tt) * a.H + h) * K + j] =
              (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KP; ++i)
    if (j < K && i < K) a.s_out[sbase + (long long)i * K + j] = S[i];
}

template <typename T, int KP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int threads = KP < 32 ? 32 : KP;
  dim3 grid(a.H, a.B);
  wkv6_fwd<T, KP><<<grid, threads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.K <= 16) return launch<T, 16>(a, s);
  if (a.K <= 32) return launch<T, 32>(a, s);
  return launch<T, 64>(a, s);
}

}  // namespace wkv

// r, k, v (B, L, H, K) bf16 (is_bf16) or f32 and w (B, L, H, K) f32, each
// with unit stride in the last dim and the given B/L/H element strides; u
// (H, K), s_in and s_out (B, H, K, K) f32 contiguous (s_out may alias
// s_in); y contiguous (B, L, H, K) f32. 1 <= K <= 64. Returns the launch's
// CUDA error (0 on success).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const float* w, const float* u, const float* s_in,
                    float* y, float* s_out, long long rsB, long long rsL,
                    long long rsH, long long ksB, long long ksL,
                    long long ksH, long long vsB, long long vsL,
                    long long vsH, long long wsB, long long wsL,
                    long long wsH, int B, int L, int H, int K, int is_bf16,
                    void* stream) {
  if (K < 1 || K > 64) return (int)cudaErrorInvalidValue;
  const wkv::Args a{r,   k,   v,   w,   u,   s_in, y,   s_out, rsB,
                    rsL, rsH, ksB, ksL, ksH, vsB,  vsL, vsH,   wsB,
                    wsL, wsH, B,   L,   H,   K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? wkv::dispatch<__nv_bfloat16>(a, s)
                       : wkv::dispatch<float>(a, s));
}
