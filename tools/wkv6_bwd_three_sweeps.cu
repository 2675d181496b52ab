// A probe, on no path of the port: K5-bwd's first design (three sweeps over
// L), kept to time the current kernel (src/repro_torch/csrc/wkv6_bwd.cu)
// against it in one process (tools/wkv6_bwd_probe.py builds it; its
// namespace and C entry are renamed so that both libraries load side by
// side). It takes the same arguments as the current C entry, its own
// scratch in place of the checkpoints (B x H x ceil(K / 32) x ceil(L / 16)
// x K_P x 32 floats, K_P: K rounded up to 8), and reruns the forward
// recurrence itself.
//
// K5-bwd: the backward of the RWKV6 (Finch) WKV recurrence (K5, wkv6.cu).
// Per (sequence, head), with K = V, 0-based steps t and P_t the state
// before step t (P_0 = s_in, P_L the final state):
//
//     y_t      = r_t (P_t + diag(u . k_t) v_t^T)
//     P_{t+1}  = diag(w_t) P_t + k_t v_t^T
//
// Given dy (B, L, H, V) and the final state's cotangent G_L (zero when the
// caller passes none), with G = G_{t+1} = dL/dP_{t+1}, walking t = L-1 .. 0:
//
//     dr_t[k] = sum_v dy_t[v] P_t[k][v] + u[k] k_t[k] (dy_t . v_t)
//     dk_t[k] = u[k] r_t[k] (dy_t . v_t) + sum_v G[k][v] v_t[v]
//     dv_t[v] = dy_t[v] a_t + sum_k G[k][v] k_t[k],  a_t = sum_k r_t u k_t
//     dw_t[k] = sum_v G[k][v] P_t[k][v]
//     du[k]  += r_t[k] k_t[k] (dy_t . v_t)        (over the batch and L)
//     G_t     = diag(w_t) G + r_t dy_t^T,          d(s_in) = G_0
//
// all in f32. Replaces no TPU kernel: the reference trains through its jnp
// step scan (src/repro/models/ssm.py:93, rwkv6_linear_attention) under
// jax.value_and_grad. The port runs the forward as K5, so its training
// path needs a backward of its own (kernels/wkv6/ops.py WKV6Fn); this
// kernel is held against kernels/wkv6/ref.py wkv6_bwd_ref, the same reverse
// recurrence as a plain step loop, and through it against jax.grad of the
// reference function.
//
// Contract: fp32 FFMAs only, no tensor cores, no TF32; no atomics: every
// output element is written by one thread after sums taken in a fixed
// order, so repeats are bit-identical. r, k and v are bf16 or f32 and read
// through their strides, as K5 reads them; w is f32; dr, dk and dv come out
// in r's dtype, dw, du and d(s_in) in f32. K <= 64.
//
// Bound on an H100: the function needs P_t once more (3 K V flops a
// (token, head): k v and w P + k v) and, per state entry, FMAs for dr, dk,
// dw and dv and a multiply and an FMA for G: 14 K V flops a (token, head).
// At rwkv6-7b's B 1 x 4,096, H 64, K 64 that is 15.0 GFLOP of fp32
// CUDA-core work, 0.224 ms at 67 TFLOP/s, against 403 MB read or written
// once (r, k, v, dr, dk, dv in bf16; w, dy, dw in f32), 0.120 ms at 3.35
// TB/s: bound by operations.
//
// Design:
// - P_t in reverse order without dividing by w (which reaches e^(-e^6)):
//   checkpoints. Phase A runs the recurrence forward from s_in and writes
//   the state at the start of every TT = 16-step chunk to a scratch (B x H
//   x ceil(L / 16) states: 268 MB at the shape above, allocated by the
//   wrapper for the call). Phase B walks the chunks in reverse: it reloads
//   the chunk's checkpoint, recomputes the chunk's 16 states into shared
//   memory (each thread its own slots), then runs the chunk's steps
//   backwards. K5's forward is unchanged.
// - Work: one cluster of NG = ceil(K / 32) CTAs per head, CTA g owning
//   state columns 32 g .. 32 g + 31 (G's columns, like P's, evolve
//   independently: G_t[:, v] needs only w, r and dy_t[v]); the CTAs loop
//   over the batch in order, so du sums over it inside the cluster. A CTA
//   has 4 x K_P threads (K_P: K rounded up to 8): warp w owns rows 8 w ..
//   8 w + 7, lane 4 i + j row 8 w + i and columns 8 j .. 8 j + 7, so a
//   thread holds 8 entries of P and 8 of G.
// - The sums over v (dr, dk, dw) are the thread's 8 columns, a butterfly
//   over the row's 4 lanes, and the other CTA's half, which it writes into
//   the first CTA's shared memory (distributed shared memory, one cluster
//   barrier a chunk); the first CTA adds the two in order and writes dr,
//   dk and dw. The sums over k (dv) are a reduce-scatter over a warp's 8
//   rows (7 shuffles a step) and, at the chunk's end, a sum over the warps
//   in order; each CTA writes its own columns of dv.
// - Staging: each chunk's r, k, w (all rows) and v, dy (the CTA's columns)
//   are widened to f32 in shared memory between two barriers, with a_t
//   computed once per step and CTA. The loads' latency is not hidden: a
//   prefetch ring as in K5 is later work.
// - 188 KB of shared memory a CTA (the states of a chunk are 128 KB); one
//   CTA an SM.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkvb3 {

namespace cg = cooperative_groups;

constexpr int TT = 16;      // steps a chunk (a checkpoint every TT steps)
constexpr int VC = 32;      // state columns a CTA
constexpr int CW = 8;       // state columns a thread
constexpr int KMAX = 64;
constexpr int NTMAX = 4 * KMAX;     // threads a CTA at K 64
constexpr int NWMAX = NTMAX / 32;

__device__ __forceinline__ float widen(const float* p) { return *p; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s_in, *dy, *ds_out;  // ds_out may be null
  void *dr, *dk, *dv;
  float *dw, *du, *ds_in, *ckpt;
  long long rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB, wsL, wsH;
  int B, L, H, K;
  int KP, NT, nc;           // rows padded to 8, threads, chunks
};

// shared memory, in floats
struct Smem {
  static constexpr int R = 0, Kk = R + TT * KMAX, W = Kk + TT * KMAX;
  static constexpr int V = W + TT * KMAX, DY = V + TT * VC;
  static constexpr int A = DY + TT * VC, U = A + TT;
  static constexpr int DV = U + KMAX;                   // [TT][NWMAX][VC]
  static constexpr int X = DV + TT * NWMAX * VC;        // [2][TT][KMAX][3]
  static constexpr int ST = X + 2 * TT * KMAX * 3;      // [TT][2][NTMAX] f4
  static constexpr int FLOATS = ST + TT * 2 * NTMAX * 4;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(ST % 4 == 0, "16-byte aligned states");
};

// one chunk's inputs (steps t0 .. t0 + TT - 1) widened to f32: k, w and the
// CTA's v columns; with ``all`` also r and dy. Rows past K get k = r = 0
// and w = 1, columns past K v = dy = 0, steps past L the same.
template <typename T>
__device__ __forceinline__ void stage(const Args& a, float* sm, int b, int h,
                                      int g, int t0, bool all) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int e = threadIdx.x; e < TT * a.KP; e += a.NT) {
    const int t = e / a.KP, row = e % a.KP, gt = t0 + t;
    const bool in = gt < a.L && row < a.K;
    const long long bo = (long long)b, to = gt, ho = h;
    sm[Smem::Kk + t * KMAX + row] =
        in ? widen(k + bo * a.ksB + to * a.ksL + ho * a.ksH + row) : 0.f;
    sm[Smem::W + t * KMAX + row] =
        in ? a.w[bo * a.wsB + to * a.wsL + ho * a.wsH + row] : 1.f;
    if (all)
      sm[Smem::R + t * KMAX + row] =
          in ? widen(r + bo * a.rsB + to * a.rsL + ho * a.rsH + row) : 0.f;
  }
  for (int e = threadIdx.x; e < TT * VC; e += a.NT) {
    const int t = e / VC, c = e % VC, col = g * VC + c, gt = t0 + t;
    const bool in = gt < a.L && col < a.K;
    sm[Smem::V + t * VC + c] =
        in ? widen(v + (long long)b * a.vsB + (long long)gt * a.vsL +
                   (long long)h * a.vsH + col)
           : 0.f;
    if (all)
      sm[Smem::DY + t * VC + c] =
          in ? a.dy[(((long long)b * a.L + gt) * a.H + h) * a.K + col] : 0.f;
  }
}

template <typename T, int NG>
__device__ __forceinline__ void body(const Args& a) {
  extern __shared__ __align__(16) float sm[];
  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rq = lane >> 2, cq = lane & 3;
  const int row = warp * 8 + rq;                  // this thread's state row
  const int c0 = cq * CW;                         // its first column (CTA)
  const int nw = a.NT / 32;
  float4* st = reinterpret_cast<float4*>(sm + Smem::ST);
  float* X = sm + Smem::X;
  // rows of dr/dk/dw: CTA g's partial sums land in the first CTA's slot g
  float* Xdst = X + g * TT * KMAX * 3;
  if constexpr (NG == 2) {
    if (g) Xdst = cg::this_cluster().map_shared_rank(X, 0) + TT * KMAX * 3;
  }
  auto cluster_sync = [] {
    if constexpr (NG == 2) cg::this_cluster().sync();
    else __syncthreads();
  };
  for (int e = tid; e < KMAX; e += a.NT)
    sm[Smem::U + e] = e < a.K ? a.u[(long long)h * a.K + e] : 0.f;
  __syncthreads();
  const float ur = sm[Smem::U + row];
  float du_acc = 0.f;
  for (int b = 0; b < a.B; ++b) {
    const long long sbase = (((long long)b * a.H + h) * a.K + row) * a.K +
                            g * VC + c0;    // this thread's (row, columns)
    const bool srow = row < a.K;
    float4* ck = reinterpret_cast<float4*>(a.ckpt) +
                 (((long long)b * a.H + h) * NG + g) * a.nc * 2 * a.NT;
    // ---- phase A: the state at each chunk's start ----
    float S[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      S[j] = srow && g * VC + c0 + j < a.K ? a.s_in[sbase + j] : 0.f;
    for (int c = 0; c < a.nc; ++c) {
      ck[(c * 2) * a.NT + tid] = make_float4(S[0], S[1], S[2], S[3]);
      ck[(c * 2 + 1) * a.NT + tid] = make_float4(S[4], S[5], S[6], S[7]);
      stage<T>(a, sm, b, h, g, c * TT, false);
      __syncthreads();
      const int n = min(TT, a.L - c * TT);
      for (int t = 0; t < n; ++t) {
        const float kk = sm[Smem::Kk + t * KMAX + row];
        const float ww = sm[Smem::W + t * KMAX + row];
        const float4 v0 = *reinterpret_cast<const float4*>(
            sm + Smem::V + t * VC + c0);
        const float4 v1 = *reinterpret_cast<const float4*>(
            sm + Smem::V + t * VC + c0 + 4);
        const float vv[CW] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int j = 0; j < CW; ++j) S[j] = fmaf(ww, S[j], kk * vv[j]);
      }
      __syncthreads();
    }
    // ---- phase B: the chunks in reverse ----
    float G[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      G[j] = a.ds_out && srow && g * VC + c0 + j < a.K ? a.ds_out[sbase + j]
                                                       : 0.f;
    for (int c = a.nc - 1; c >= 0; --c) {
      const int t0 = c * TT, n = min(TT, a.L - t0);
      const float4 s0 = ck[(c * 2) * a.NT + tid];
      const float4 s1 = ck[(c * 2 + 1) * a.NT + tid];
      float P[CW] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      stage<T>(a, sm, b, h, g, t0, true);
      __syncthreads();
      // a_t = sum_k r u k over every row, a warp per step
      for (int t = warp; t < n; t += nw) {
        float x = 0.f;
        for (int kk = lane; kk < a.KP; kk += 32)
          x = fmaf(sm[Smem::R + t * KMAX + kk] * sm[Smem::U + kk],
                   sm[Smem::Kk + t * KMAX + kk], x);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) sm[Smem::A + t] = x;
      }
      // the chunk's states P_t, recomputed from its checkpoint
      for (int t = 0; t < n; ++t) {
        st[(t * 2) * a.NT + tid] = make_float4(P[0], P[1], P[2], P[3]);
        st[(t * 2 + 1) * a.NT + tid] = make_float4(P[4], P[5], P[6], P[7]);
        const float kk = sm[Smem::Kk + t * KMAX + row];
        const float ww = sm[Smem::W + t * KMAX + row];
        const float4 v0 = *reinterpret_cast<const float4*>(
            sm + Smem::V + t * VC + c0);
        const float4 v1 = *reinterpret_cast<const float4*>(
            sm + Smem::V + t * VC + c0 + 4);
        const float vv[CW] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int j = 0; j < CW; ++j) P[j] = fmaf(ww, P[j], kk * vv[j]);
      }
      // the steps backwards
      for (int t = n - 1; t >= 0; --t) {
        const float4 p0 = st[(t * 2) * a.NT + tid];
        const float4 p1 = st[(t * 2 + 1) * a.NT + tid];
        const float pp[CW] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float rr = sm[Smem::R + t * KMAX + row];
        const float kk = sm[Smem::Kk + t * KMAX + row];
        const float ww = sm[Smem::W + t * KMAX + row];
        const float* vp = sm + Smem::V + t * VC + c0;
        const float* dp = sm + Smem::DY + t * VC + c0;
        const float4 v0 = *reinterpret_cast<const float4*>(vp);
        const float4 v1 = *reinterpret_cast<const float4*>(vp + 4);
        const float4 d0 = *reinterpret_cast<const float4*>(dp);
        const float4 d1 = *reinterpret_cast<const float4*>(dp + 4);
        const float vv[CW] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        const float dd[CW] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        float dyv = 0.f, pr = 0.f, pk = 0.f, pw = 0.f, dvp[CW];
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          dyv = fmaf(dd[j], vv[j], dyv);
          pr = fmaf(dd[j], pp[j], pr);
          pk = fmaf(G[j], vv[j], pk);
          pw = fmaf(G[j], pp[j], pw);
          dvp[j] = G[j] * kk;
        }
        pr = fmaf(ur * kk, dyv, pr);
        pk = fmaf(ur * rr, dyv, pk);
        du_acc = fmaf(rr * kk, dyv, du_acc);
#pragma unroll
        for (int j = 0; j < CW; ++j) G[j] = fmaf(ww, G[j], rr * dd[j]);
        // the row's sums over the 4 lanes of its columns
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          pr += __shfl_xor_sync(0xffffffffu, pr, off);
          pk += __shfl_xor_sync(0xffffffffu, pk, off);
          pw += __shfl_xor_sync(0xffffffffu, pw, off);
        }
        if (cq == 0) {
          float* x = Xdst + (t * KMAX + row) * 3;
          x[0] = pr;
          x[1] = pk;
          x[2] = pw;
        }
        // dv: a reduce-scatter over the warp's 8 rows (lanes xor 16, 8,
        // 4); lane 4 i + j ends with column 8 j + i
        float x4[4], x2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool hi = rq & 4;
          const float send = hi ? dvp[i] : dvp[i + 4];
          x4[i] = (hi ? dvp[i + 4] : dvp[i]) +
                  __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool hi = rq & 2;
          const float send = hi ? x4[i] : x4[i + 2];
          x2[i] = (hi ? x4[i + 2] : x4[i]) +
                  __shfl_xor_sync(0xffffffffu, send, 8);
        }
        const bool hi = rq & 1;
        const float x1 = (hi ? x2[1] : x2[0]) +
                         __shfl_xor_sync(0xffffffffu, hi ? x2[0] : x2[1], 4);
        sm[Smem::DV + (t * NWMAX + warp) * VC + c0 + rq] = x1;
      }
      cluster_sync();     // the other CTA's row sums, a_t and dv's partials
      const long long obase = (long long)b * a.L * a.H + h;   // (b, 0, h)
      if (g == 0) {
        for (int e = tid; e < n * a.K; e += a.NT) {
          const int t = e / a.K, kr = e % a.K;
          const float* x0 = X + (t * KMAX + kr) * 3;
          float s[3] = {x0[0], x0[1], x0[2]};
          if (NG == 2) {
            const float* x1p = x0 + TT * KMAX * 3;
            s[0] += x1p[0];
            s[1] += x1p[1];
            s[2] += x1p[2];
          }
          const long long at = (obase + (long long)(t0 + t) * a.H) * a.K + kr;
          narrow(static_cast<T*>(a.dr) + at, s[0]);
          narrow(static_cast<T*>(a.dk) + at, s[1]);
          a.dw[at] = s[2];
        }
      }
      for (int e = tid; e < n * VC; e += a.NT) {
        const int t = e / VC, cc = e % VC, col = g * VC + cc;
        if (col >= a.K) continue;
        float s = 0.f;
        for (int ww = 0; ww < nw; ++ww)
          s += sm[Smem::DV + (t * NWMAX + ww) * VC + cc];
        s = fmaf(sm[Smem::DY + t * VC + cc], sm[Smem::A + t], s);
        narrow(static_cast<T*>(a.dv) +
                   (obase + (long long)(t0 + t) * a.H) * a.K + col, s);
      }
      cluster_sync();     // before the next chunk overwrites what was read
    }
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (srow && g * VC + c0 + j < a.K) a.ds_in[sbase + j] = G[j];
  }
  // du: the row's sum over its 4 lanes, then the other CTA's
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, off);
  if (cq == 0) Xdst[row * 3] = du_acc;
  cluster_sync();
  if (g == 0 && cq == 0 && row < a.K) {
    float s = X[row * 3];
    if (NG == 2) s += X[TT * KMAX * 3 + row * 3];
    a.du[(long long)h * a.K + row] = s;
  }
  cluster_sync();     // the first CTA has read the other's shared memory
}

template <typename T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTMAX)
    wkv6_bwd_pair(Args a) {
  body<T, 2>(a);
}

template <typename T>
__global__ void __launch_bounds__(NTMAX) wkv6_bwd_one(Args a) {
  body<T, 1>(a);
}

template <typename T>
static cudaError_t run(const Args& a, cudaStream_t s) {
  auto kern = a.K > VC ? wkv6_bwd_pair<T> : wkv6_bwd_one<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.K > VC ? 2 : 1, a.H), a.NT, Smem::BYTES, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wkvb3

// r, k, v (B, L, H, K) bf16 or f32 (is_bf16) and w (B, L, H, K) f32, read
// through the given element strides (unit stride in the last dim); u (H,
// K), s_in (B, H, K, K), dy (B, L, H, K) and ds_out (B, H, K, K, or null
// for a zero cotangent) f32 contiguous. Writes dr, dk, dv (B, L, H, K) in
// r's dtype and dw (B, L, H, K) f32, contiguous; du (H, K) and ds_in (B,
// H, K, K) f32. ckpt: f32 scratch of B x H x ceil(K / 32) x ceil(L / 16) x
// K_P x 32 floats (K_P: K rounded up to 8). One launch; returns its CUDA
// error code (0 on success).
extern "C" int wkv6_bwd_three_sweeps(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s_in,
                        const float* dy, const float* ds_out, void* dr,
                        void* dk, void* dv, float* dw, float* du,
                        float* ds_in, float* ckpt, long long rsB,
                        long long rsL, long long rsH, long long ksB,
                        long long ksL, long long ksH, long long vsB,
                        long long vsL, long long vsH, long long wsB,
                        long long wsL, long long wsH, int B, int L, int H,
                        int K, int is_bf16, void* stream) {
  using namespace wkvb3;
  if (B < 1 || L < 1 || H < 1 || K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  const int KP = (K + 7) / 8 * 8;
  Args a{r, k, v, w, u, s_in, dy, ds_out, dr, dk, dv, dw, du, ds_in, ckpt,
         rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB, wsL, wsH,
         B, L, H, K, KP, 4 * KP, (L + TT - 1) / TT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<__nv_bfloat16>(a, s) : run<float>(a, s));
}
