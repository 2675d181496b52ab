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
// in r's dtype, dw, du and d(s_in) in f32. Any K <= 64, L >= 1, B >= 1. It
// never divides by w (which reaches e^(-e^6)).
//
// Bound on an H100: the function needs P_t once more (3 K V flops a
// (token, head): k v and w P + k v) and, per state entry, FMAs for dr, dk,
// dw and dv and a multiply and an FMA for G: 14 K V flops a (token, head).
// At rwkv6-7b's B 1 x 4,096, H 64, K 64 that is 15.0 GFLOP of fp32
// CUDA-core work, 0.224 ms at 67 TFLOP/s, against 403 MB read or written
// once (r, k, v, dr, dk, dv in bf16; w, dy, dw in f32), 0.120 ms at 3.35
// TB/s: bound by operations.
//
// Design. The first form of this kernel (tools/wkv6_bwd_three_sweeps.cu,
// 5.29 ms at the shape above on an H100 at 700 W) swept L three times
// (the forward recurrence again for its own checkpoints, each chunk's
// states into 128 KB of shared memory, the steps backwards), staged each
// chunk between two barriers, took 13 shuffles and shared-memory writes
// inside every step, two cluster barriers a chunk and a division an output
// element, with 8 warps an SM. Here (PERF.md, tools/wkv6_bwd_probe.py):
// - Checkpoints from the forward. K5 (wkv6.cu, its wkv6_fwd_ckpt
//   instance, which WKV6Fn's forward launches) writes the state at the
//   start of every CKT = 16-step chunk from the registers that hold it,
//   transposed, (B, H, ceil(L / 16), K, K) f32 (268 MB at the shape above,
//   0.005-0.01 ms more than K5 alone). A CTA's columns of a checkpoint
//   are then one contiguous block.
// - Work: one cluster of NG = ceil(K / 32) CTAs a head, CTA g owning state
//   columns 32 g .. 32 g + 31 (G's columns, like P's, evolve
//   independently: G_t[:, v] needs only w, r and dy_t[v]); the clusters
//   loop over the batch in order, so du sums over it in place. 8 compute
//   warps and a producer warp a CTA at K 64, one CTA an SM (128 CTAs).
//   A compute thread owns 2 rows x 4 columns of P and G: a row's 8 threads
//   are consecutive lanes, a warp 8 rows. 16 columns a CTA (4 CTAs a head)
//   measured slower (tools/wkv6_bwd_probe.py's vc16).
// - The producer warp stages chunk i + 1 while the compute warps run
//   chunk i: one tensor-map box (TMA) a tensor for r, k, v, w and dy (16
//   steps x K) and one bulk copy for the checkpoint's columns, completing
//   on mbarriers (cp.async where a view is not 16-byte aligned); it widens
//   the chunk to f32 once, a_t = r u k and dy_t . v_t by one reduce-scatter
//   a 4-step group, and hands it over on a named barrier (two buffers; the
//   compute warps free one after its outputs are written).
// - The step loop: the chunk's states live in registers half a chunk at a
//   time (P_8 .. P_15 from the checkpoint forward, walked backwards, then
//   P_0 .. P_7), so no state goes through shared memory; per step a thread
//   loads r, k, w of its rows and v, dy of its columns (broadcast f32
//   loads) and does 48 FFMA-pipe operations; G's update and the states'
//   recompute are the only dependences from one step to the next. The
//   step's sums are outputs only: dr, dk, dw over the thread's 4 columns
//   and dv over its 2 rows stay in registers for a group of 4 steps, then
//   one reduce-scatter over the row's lanes (24 values to 3 a lane) and one
//   over the warp's rows (16 to 4) leave whole sums over the warp, stored
//   to shared memory. No barrier inside a chunk.
// - Once a chunk: the CTA's row sums go to the CTA that owns the row,
//   16 bytes a store over distributed shared memory (a slot a source CTA);
//   one cluster barrier, whose wait comes half a chunk later; then the
//   owner adds its sources in order, the u terms and du, and writes dr, dk,
//   dw; each CTA adds dv's warps in order and dy a_t, and writes its
//   columns of dv. Each thread's (row, step) or (column, step) is set once:
//   no division an element.
// - 131 KB of shared memory a CTA (bf16; 137 KB f32), 167-168 registers.
// It reaches 0.16 of the bound above. The next step is the chunked form:
// intra-chunk products with per-row decays, parallel over chunks, which
// must stay exact in f32 without dividing by w: a decay product over a
// chunk underflows where w is small, so the products have to be formed
// from each step's end, never inverted.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "wkv6_common.cuh"

namespace wkvb {

namespace cg = cooperative_groups;
using wkv::CKT;

constexpr int TT = CKT;     // steps a chunk: one checkpoint each
constexpr int HT = TT / 2;  // steps a half chunk: its states in registers
constexpr int GS = 4;       // steps whose sums are reduced together
constexpr int KMAX = 64;
constexpr int VC = 32;      // state columns a CTA

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *dy, *ds_out, *ckpt;  // ds_out may be null
  void *dr, *dk, *dv;
  float *dw, *du, *ds_in;
  long long rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB, wsL, wsH;
  int B, L, H, K;
  int NT, NG, RO, nc, cb;   // threads, CTAs a head, rows a CTA owns (a
                            // multiple of 4), chunks, bytes a staging copy
  int tma;                  // 1: the tensor maps load; 0: cp.async
};

// a thread 2 rows x 4 columns, a row's NCG threads consecutive lanes,
// NRW row pairs a warp; then a producer warp
template <typename T>
struct Lay {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int NCG = VC / 4, NRW = 32 / NCG, RW = 2 * NRW;
  static constexpr int NTM = 32 * KMAX / RW, NWM = NTM / 32;
  static constexpr int NGM = KMAX / VC;           // CTAs a head at most
  // raw stage (bytes): r, k, v (TT, K) of T; w, dy (TT, K) f32, each in
  // room for K = KMAX (rows K apart from the tensor maps, KMAX apart from
  // cp.async)
  static constexpr int OK_ = TT * KMAX * ES, OV = 2 * OK_, OW = 3 * OK_;
  static constexpr int ODY = OW + TT * KMAX * 4, RAW = ODY + TT * KMAX * 4;
  // two buffers each (floats): the chunk's checkpoint, this CTA's columns
  // of the transposed state (VC, K); the chunk widened, r, k, w (TT,
  // KMAX), v, dy (TT, VC), a_t and dy_t . v_t; dv's sums of the warps,
  // [TT][warp][VC]
  static constexpr int CKF = KMAX * VC;
  static constexpr int CR = 0, CK = TT * KMAX, CW = 2 * TT * KMAX;
  static constexpr int CV = 3 * TT * KMAX, CDY = CV + TT * VC;
  static constexpr int CA = CDY + TT * VC, CDYV = CA + TT;
  static constexpr int CONV = CDYV + TT;
  static constexpr int DVF = TT * NWM * VC;
  // dr, dk, dw sums of this CTA's columns, [kind][TT][NG RO]; two buffers
  // of what the owner of RO rows receives, [source CTA][kind][TT][RO]
  // (NG RO <= KMAX)
  static constexpr int ROWF = 3 * TT * KMAX;
  static constexpr int O_CK = RAW, O_CONV = O_CK + 2 * 4 * CKF;
  static constexpr int O_DV = O_CONV + 2 * 4 * CONV;
  static constexpr int O_LOC = O_DV + 2 * 4 * DVF, O_ROW = O_LOC + 4 * ROWF;
  static constexpr int O_U = O_ROW + 2 * 4 * ROWF, O_BAR = O_U + 4 * KMAX;
  static constexpr int BYTES = O_BAR + 16;        // two mbarriers
  static_assert(RAW % 128 == 0 && (4 * CKF) % 128 == 0, "TMA alignment");
  static_assert((4 * CONV) % 16 == 0, "16-byte aligned");
  static_assert(DVF >= NTM, "dv's slots hold du's partials at the end");
};

// named barriers: the compute warps alone; chunk data ready (two
// buffers, the producer to the compute warps); chunk buffers free (two,
// the compute warps to the producer)
constexpr int B_COMPUTE = 1, B_READY = 2, B_FREE = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the tensor memory accelerator's loads, which complete on an mbarrier
__device__ __forceinline__ unsigned sa(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(sa(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int phase) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(sa(b)), "r"(phase) : "memory");
}
// one box of a 4-D tensor map into shared memory, completing on b
__device__ __forceinline__ void tma4(void* dst, const CUtensorMap* map,
                                     uint64_t* b, int c0, int c1, int c2,
                                     int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(sa(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(sa(b)) : "memory");
}
// `bytes` contiguous bytes into shared memory, completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(sa(dst)), "l"(src), "r"(bytes),
      "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows of `bytes` bytes in cb-byte chunks over one warp: a row's `per`
// chunks, 32 / per rows at a time where per <= 32, else a row at a time
struct WarpCopy {
  int r0, step, off, ostep, bytes;
  __device__ WarpCopy(int bytes_, int cb, int lane) : bytes(bytes_) {
    const int per = bytes / cb;
    if (per <= 32) {
      step = 32 / per;
      r0 = lane < per * step ? lane / per : 1 << 30;
      off = (lane % per) * cb;
      ostep = bytes;
    } else {
      step = 1;
      r0 = 0;
      off = lane * cb;
      ostep = 32 * cb;
    }
  }
  __device__ __forceinline__ void run(unsigned char* dst, int pitch,
                                      const unsigned char* src,
                                      long long stride, int rows,
                                      int cb) const {
    for (int r = r0; r < rows; r += step)
      for (int o = off; o < bytes; o += ostep)
        wkv::copy_chunk(dst + r * pitch + o, src + r * stride + o, cb);
  }
};

template <typename T>
__global__ void __launch_bounds__(Lay<T>::NTM + 32, 1)
    wkv6_bwd_chunks(const __grid_constant__ CUtensorMap mr,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mw,
                    const __grid_constant__ CUtensorMap mdy, Args a) {
  using F = Lay<T>;
  constexpr int ES = F::ES, NCG = F::NCG, NRW = F::NRW, NWM = F::NWM;
  constexpr int NGM = F::NGM;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;
  float* cks = reinterpret_cast<float*>(smem + F::O_CK);
  float* conv = reinterpret_cast<float*>(smem + F::O_CONV);
  float* dvb = reinterpret_cast<float*>(smem + F::O_DV);
  float* rloc = reinterpret_cast<float*>(smem + F::O_LOC);
  float* rowb = reinterpret_cast<float*>(smem + F::O_ROW);
  float* us = reinterpret_cast<float*>(smem + F::O_U);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + F::O_BAR);

  cg::cluster_group cl = cg::this_cluster();
  const int g = (int)cl.block_rank(), h = blockIdx.y;
  const int K = a.K, L = a.L, H = a.H, NT = a.NT, RO = a.RO, nc = a.nc;
  const int NG = a.NG, NW = NT / 32, nseq = a.B * nc, RP = NG * RO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long HK = (long long)H * K;

  for (int e = tid; e < KMAX; e += NT)
    us[e] = e < K ? a.u[(long long)h * K + e] : 0.f;
  if (tid == 0) {
    mbar_init(bars);        // the raw stage's copies
    mbar_init(bars + 1);    // the checkpoint's
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl.sync();      // every CTA of the cluster runs before any writes into it
  auto chunk = [&](int i, int& b, int& c) {   // sequence i: (b, chunk c)
    b = i / nc;
    c = nc - 1 - (i - b * nc);
  };

  if (warp == NW) {
    // ---- the producer warp: chunk i's inputs copied raw (one tensor-map
    // box a tensor; cp.async where a view is not 16-byte aligned) and
    // widened to f32 into buffer i % 2 (rows past K get r = k = 0 and w =
    // 1, columns past K v = dy = 0, steps past L the same, so that they
    // leave P and G as they were), a_t and dy_t . v_t by a reduce-scatter
    // a 4-step group; with its checkpoint, this CTA's columns (contiguous:
    // K5 stores each state transposed); once the compute warps are done
    // with chunk i - 2, all while they run chunk i - 1. The next chunk's
    // inputs are in flight while a chunk is widened and handed over. ----
    const int nvc = min(VC, K - g * VC);
    const WarpCopy cpt(K * ES, a.cb, lane), cpf(K * 4, a.cb, lane),
        cpk(nvc * K * 4, 4, lane);
    const unsigned char* R = static_cast<const unsigned char*>(a.r);
    const unsigned char* Kp = static_cast<const unsigned char*>(a.k);
    const unsigned char* V = static_cast<const unsigned char*>(a.v);
    const unsigned char* W = reinterpret_cast<const unsigned char*>(a.w);
    const unsigned char* DY = reinterpret_cast<const unsigned char*>(a.dy);
    const int x = 2 * lane, xc = x - g * VC;
    const float u0 = us[x], u1 = us[x + 1];
    const int abase = wkv::scatter_base<2 * GS, 1, 32>(lane);
    const int rp = a.tma ? K : KMAX;        // the raw rows' pitch
    auto issue_raw = [&](int i) {
      int b, c;
      chunk(i, b, c);
      const int t0 = c * TT;
      if (a.tma) {
        fence_async_shared();   // the stage's earlier reads come first
        if (lane == 0) {
          mbar_expect(bars, TT * K * (3 * ES + 2 * 4));
          tma4(raw, &mr, bars, 0, h, t0, b);
          tma4(raw + F::OK_, &mk, bars, 0, h, t0, b);
          tma4(raw + F::OV, &mv, bars, 0, h, t0, b);
          tma4(raw + F::OW, &mw, bars, 0, h, t0, b);
          tma4(raw + F::ODY, &mdy, bars, 0, h, t0, b);
        }
        return;
      }
      const long long bb = b, tt = t0;
      const int n = min(TT, L - t0);
      const unsigned char* src[5] = {
          R + (bb * a.rsB + tt * a.rsL + h * a.rsH) * ES,
          Kp + (bb * a.ksB + tt * a.ksL + h * a.ksH) * ES,
          V + (bb * a.vsB + tt * a.vsL + h * a.vsH) * ES,
          W + (bb * a.wsB + tt * a.wsL + h * a.wsH) * 4,
          DY + ((bb * L + tt) * H + h) * K * 4};
      const long long stride[5] = {a.rsL * ES, a.ksL * ES, a.vsL * ES,
                                   a.wsL * 4, HK * 4};
      const int off[5] = {0, F::OK_, F::OV, F::OW, F::ODY};
#pragma unroll
      for (int e = 0; e < 5; ++e)
        (e < 3 ? cpt : cpf).run(raw + off[e], KMAX * (e < 3 ? ES : 4),
                                src[e], stride[e], n, a.cb);
      wkv::cp_commit();
    };
    int phase = 0;
    issue_raw(0);
    for (int i = 0; i < nseq; ++i) {
      int b, c;
      chunk(i, b, c);
      const int n = min(TT, L - c * TT), buf = i & 1;
      if (i >= 2) bar_sync(B_FREE + buf, NT + 32);   // chunk i - 2 done
      const float* cksrc = a.ckpt +
          ((((long long)b * H + h) * nc + c) * K + g * VC) * K;
      if (a.tma) {
        fence_async_shared();
        if (lane == 0) {
          mbar_expect(bars + 1, nvc * K * 4);
          bulk_copy(cks + buf * F::CKF, cksrc, nvc * K * 4, bars + 1);
        }
        mbar_wait(bars, phase);
      } else {
        cpk.run(reinterpret_cast<unsigned char*>(cks + buf * F::CKF), 0,
                reinterpret_cast<const unsigned char*>(cksrc), 0, 1, 4);
        wkv::cp_commit();
        wkv::cp_wait0();
      }
      __syncwarp();
      float* cf = conv + buf * F::CONV;
#pragma unroll 1
      for (int t4 = 0; t4 < TT; t4 += GS) {
        float part[2 * GS];             // a_t, then dy_t . v_t
#pragma unroll
        for (int s = 0; s < GS; ++s) {
          const int t = t4 + s;
          float2 r2 = make_float2(0.f, 0.f), k2 = r2, v2 = r2, d2 = r2;
          float2 w2 = make_float2(1.f, 1.f);
          const T* rr = reinterpret_cast<const T*>(raw) + t * rp;
          const T* kk = reinterpret_cast<const T*>(raw + F::OK_) + t * rp;
          const T* vv = reinterpret_cast<const T*>(raw + F::OV) + t * rp;
          const float* ww = reinterpret_cast<const float*>(raw + F::OW) +
                            t * rp;
          const float* dd = reinterpret_cast<const float*>(raw + F::ODY) +
                            t * rp;
          if (t < n && x + 1 < K) {
            r2 = wkv::widen2(rr + x);
            k2 = wkv::widen2(kk + x);
            v2 = wkv::widen2(vv + x);
            w2 = *reinterpret_cast<const float2*>(ww + x);
            d2 = *reinterpret_cast<const float2*>(dd + x);
          } else if (t < n && x < K) {
            r2.x = wkv::widen(rr + x);
            k2.x = wkv::widen(kk + x);
            v2.x = wkv::widen(vv + x);
            w2.x = ww[x];
            d2.x = dd[x];
          }
          *reinterpret_cast<float2*>(cf + F::CR + t * KMAX + x) = r2;
          *reinterpret_cast<float2*>(cf + F::CK + t * KMAX + x) = k2;
          *reinterpret_cast<float2*>(cf + F::CW + t * KMAX + x) = w2;
          if (xc >= 0 && xc < VC) {
            *reinterpret_cast<float2*>(cf + F::CV + t * VC + xc) = v2;
            *reinterpret_cast<float2*>(cf + F::CDY + t * VC + xc) = d2;
          }
          part[s] = fmaf(r2.x * u0, k2.x, r2.y * u1 * k2.y);
          part[GS + s] = fmaf(d2.x, v2.x, d2.y * v2.y);
        }
        wkv::reduce_scatter<2 * GS, 1, 32, 2 * GS>(part, lane);
        if (lane < 2 * GS)      // CDYV = CA + TT
          cf[F::CA + (abase / GS) * TT + t4 + abase % GS] = part[0];
      }
      __syncwarp();     // every lane has read the raw stage
      if (i + 1 < nseq) issue_raw(i + 1);
      if (a.tma) mbar_wait(bars + 1, phase);
      phase ^= 1;
      __syncwarp();
      bar_arrive(B_READY + buf, NT + 32);
      if (i >= 1) {     // the cluster barrier's phase i - 1, as the
        cluster_arrive();   // compute warps'
        cluster_wait();
      }
    }
    cluster_arrive();
    cluster_wait();
    return;
  }

  // ---- the compute warps ----
  const int row0 = 2 * (warp * NRW + lane / NCG);   // rows row0, row0 + 1
  const int col0 = 4 * (lane % NCG), gcol0 = g * VC + col0;  // 4 columns
  const int rbase = wkv::scatter_base<6 * GS, 1, NCG>(lane);
  const int vbase = wkv::scatter_base<4 * GS, NCG, 32>(lane);
  constexpr int RM = 6 * GS / NCG, VM = 4 * GS / NRW;   // sums a lane keeps
  // the pushes of row sums to their owners, 16 bytes a thread: line
  // (kind, step) pl0, pl0 + plstep, ..., float4 pc of RO / 4
  const int r4 = RO / 4, plstep = NT / r4, pc = tid % r4;
  const int pl0 = tid < plstep * r4 ? tid / r4 : 3 * TT;
  float* dst[NGM];
#pragma unroll
  for (int d = 0; d < NGM; ++d)
    dst[d] = (d < NG ? cl.map_shared_rank(rowb, d) : rowb) + g * 3 * TT * RO
             + 4 * pc;
  // the epilogue's roles, set once: row g RO + erl at steps et0, et0 +
  // estep, ...; column vcol at vt0, vt0 + vstep, ...
  const int estep = NT / RO, erl = tid % RO;
  const int et0 = tid < estep * RO ? tid / RO : TT;
  const int erow = g * RO + erl;
  const bool eon = erow < K;
  const int vstep = NT / VC, vcol = tid % VC, vt0 = tid / VC;
  const bool von = g * VC + vcol < K;
  float du_acc = 0.f;

  // this thread's 2 x 4 entries of sequence i's checkpoint, transposed
  // (rows and columns past K: 0, which they stay): a row pair at once
  auto ck_read = [&](int i, float (&P)[2][4]) {
    const float* src = cks + (i & 1) * F::CKF + col0 * K + row0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 p2 = make_float2(0.f, 0.f);
      if (gcol0 + j < K && row0 + 1 < K && K % 2 == 0) {
        p2 = *reinterpret_cast<const float2*>(src + j * K);
      } else if (gcol0 + j < K && row0 < K) {   // odd K: 4-byte aligned
        p2.x = src[j * K];
        if (row0 + 1 < K) p2.y = src[j * K + 1];
      }
      P[0][j] = p2.x;
      P[1][j] = p2.y;
    }
  };
  // sequence j's outputs: its row sums over the sources, dv's over the
  // warps, in order, and the u terms
  auto epilogue = [&](int j) {
    int b, c;
    chunk(j, b, c);
    const int t0 = c * TT, n = min(TT, L - t0), buf = j & 1;
    const float* cf = conv + buf * F::CONV;
    if (eon) {
      const float* src = rowb + buf * F::ROWF + erl;
      const float uu = us[erow];
#pragma unroll 2
      for (int t = et0; t < n; t += estep) {
        const float* p = src + t * RO;
        float sr = p[0], sk = p[TT * RO], sw = p[2 * TT * RO];
#pragma unroll
        for (int s = 1; s < NGM; ++s)
          if (s < NG) {
            const float* q = p + s * 3 * TT * RO;
            sr += q[0];
            sk += q[TT * RO];
            sw += q[2 * TT * RO];
          }
        const float dyv = cf[F::CDYV + t], rr = cf[F::CR + t * KMAX + erow];
        const float kk = cf[F::CK + t * KMAX + erow];
        const long long o = ((long long)b * L + t0 + t) * HK +
                            (long long)h * K + erow;
        wkv::narrow(static_cast<T*>(a.dr) + o, fmaf(uu * kk, dyv, sr));
        wkv::narrow(static_cast<T*>(a.dk) + o, fmaf(uu * rr, dyv, sk));
        a.dw[o] = sw;
        du_acc = fmaf(rr * kk, dyv, du_acc);
      }
    }
    if (von) {
      const float* db = dvb + buf * F::DVF + vcol;
#pragma unroll 2
      for (int t = vt0; t < n; t += vstep) {
        const float* p = db + t * NWM * VC;
        float s = p[0];
#pragma unroll
        for (int w = 1; w < NWM; ++w)
          if (w < NW) s += p[w * VC];
        const long long o = ((long long)b * L + t0 + t) * HK +
                            (long long)h * K + g * VC + vcol;
        wkv::narrow(static_cast<T*>(a.dv) + o,
                    fmaf(cf[F::CDY + t * VC + vcol], cf[F::CA + t], s));
      }
    }
  };

  float G[2][4];
  for (int i = 0; i < nseq; ++i) {
    int b, c;
    chunk(i, b, c);
    const int buf = i & 1;
    const long long sb = ((long long)b * H + h) * K;   // (b, h, row 0)
    const float* cf = conv + buf * F::CONV;
    float* db = dvb + buf * F::DVF;
    bar_sync(B_READY + buf, NT + 32);   // chunk i staged
    if (c == nc - 1) {      // a new sequence: G_L
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = row0 + r, col = gcol0 + j;
          G[r][j] = a.ds_out && row < K && col < K
                        ? a.ds_out[(sb + row) * K + col] : 0.f;
        }
    }
    float P[2][4], P0[2][4], S[HT][2][4];
    ck_read(i, P0);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) P[r][j] = P0[r][j];
    // P_t -> P_{t+1}
    auto advance = [&](int t) {
      const float2 k2 = *reinterpret_cast<const float2*>(
          cf + F::CK + t * KMAX + row0);
      const float2 w2 = *reinterpret_cast<const float2*>(
          cf + F::CW + t * KMAX + row0);
      const float4 v4 = *reinterpret_cast<const float4*>(
          cf + F::CV + t * VC + col0);
      const float kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          P[r][j] = fmaf(ww[r], P[r][j], kk[r] * vv[j]);
    };
    // the half chunk's states from P: S[j] = P_{HT h2 + j} (h2 a
    // compile-time constant, so that S stays in registers)
    auto states = [&](auto half) {
      constexpr int h2 = decltype(half)::value;
#pragma unroll
      for (int j = 0; j < HT; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[j][r][e] = P[r][e];
        if (j + 1 < HT) advance(HT * h2 + j);
      }
    };
    // the half chunk's steps backwards, GS at a time: the sums of a group
    // reduced over lanes, then stored (kept in registers to the chunk's
    // end, they would not fit the 168 registers of 9 warps: 3 share a
    // scheduler's 16,384)
    auto walk = [&](auto half) {
      constexpr int h2 = decltype(half)::value;
#pragma unroll
      for (int q = (h2 + 1) * HT / GS - 1; q >= h2 * HT / GS; --q) {
        float rv[6 * GS], vs[4 * GS];   // [(kind 2 + row) GS + s], [col GS + s]
#pragma unroll
        for (int s = GS - 1; s >= 0; --s) {
          const int t = q * GS + s;
          const float(&pp)[2][4] = S[t - HT * h2];
          const float2 r2 = *reinterpret_cast<const float2*>(
              cf + F::CR + t * KMAX + row0);
          const float2 k2 = *reinterpret_cast<const float2*>(
              cf + F::CK + t * KMAX + row0);
          const float2 w2 = *reinterpret_cast<const float2*>(
              cf + F::CW + t * KMAX + row0);
          const float4 v4 = *reinterpret_cast<const float4*>(
              cf + F::CV + t * VC + col0);
          const float4 d4 = *reinterpret_cast<const float4*>(
              cf + F::CDY + t * VC + col0);
          const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y};
          const float ww[2] = {w2.x, w2.y};
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pr = dd[0] * pp[r][0], pk = G[r][0] * vv[0];
            float pw = G[r][0] * pp[r][0];
#pragma unroll
            for (int j = 1; j < 4; ++j) {
              pr = fmaf(dd[j], pp[r][j], pr);
              pk = fmaf(G[r][j], vv[j], pk);
              pw = fmaf(G[r][j], pp[r][j], pw);
            }
            rv[(0 + r) * GS + s] = pr;
            rv[(2 + r) * GS + s] = pk;
            rv[(4 + r) * GS + s] = pw;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            vs[j * GS + s] = fmaf(G[1][j], kk[1], G[0][j] * kk[0]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              G[r][j] = fmaf(ww[r], G[r][j], rr[r] * dd[j]);
        }
        // dr, dk, dw over the row's lanes, dv over the warp's rows
        wkv::reduce_scatter<6 * GS, 1, NCG, 6 * GS>(rv, lane);
        wkv::reduce_scatter<4 * GS, NCG, 32, 4 * GS>(vs, lane);
#pragma unroll
        for (int m = 0; m < RM; ++m) {
          const int f = rbase + m, kr = f / GS, t = q * GS + f % GS;
          rloc[((kr >> 1) * TT + t) * RP + row0 + (kr & 1)] = rv[m];
        }
#pragma unroll
        for (int m = 0; m < VM; ++m) {
          const int f = vbase + m, t = q * GS + f % GS;
          db[(t * NWM + warp) * VC + col0 + f / GS] = vs[m];
        }
      }
    };
    // the second half from P_HT, which the first half's steps reach; the
    // last chunk's outputs; the first half from the checkpoint
#pragma unroll
    for (int t = 0; t < HT; ++t) advance(t);
    states(std::integral_constant<int, 1>{});
    walk(std::integral_constant<int, 1>{});
    if (i > 0) {
      cluster_wait();       // chunk i - 1's row sums are in place
      epilogue(i - 1);
      if (i + 1 < nseq) bar_arrive(B_FREE + (buf ^ 1), NT + 32);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) P[r][j] = P0[r][j];
    states(std::integral_constant<int, 0>{});
    walk(std::integral_constant<int, 0>{});
    if (c == 0) {           // d(s_in) = G_0
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = row0 + r, col = gcol0 + j;
          if (row < K && col < K) a.ds_in[(sb + row) * K + col] = G[r][j];
        }
    }
    bar_sync(B_COMPUTE, NT);
    // each owner's rows to its slot g (over distributed shared memory but
    // for this CTA's own), 16 bytes a store
#pragma unroll
    for (int d = 0; d < NGM; ++d)
      if (d < NG)
        for (int l = pl0; l < 3 * TT; l += plstep)
          *reinterpret_cast<float4*>(dst[d] + buf * F::ROWF + l * RO) =
              *reinterpret_cast<const float4*>(rloc + l * RP + d * RO +
                                               4 * pc);
    cluster_arrive();
  }
  cluster_wait();
  epilogue(nseq - 1);
  // du: the row's partials over its epilogue threads, in order
  bar_sync(B_COMPUTE, NT);
  dvb[tid] = du_acc;
  bar_sync(B_COMPUTE, NT);
  if (tid < RO && g * RO + tid < K && tid < estep * RO) {
    float s = dvb[tid];
    for (int j = 1; j < estep; ++j) s += dvb[tid + j * RO];
    a.du[(long long)h * K + g * RO + tid] = s;
  }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a tensor of `rank` dims (innermost first) read in place with byte
// strides, boxes of `box`, no swizzle, zeros past its extent
static bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                   const void* ptr, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn && fn(map, type, rank, const_cast<void*>(ptr), dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor maps of r, k, v, w, dy ((K, H, L, B), a box of K x 16 steps);
// false where one does not encode
template <typename T>
static bool encode_maps(const Args& a, CUtensorMap* m) {
  const CUtensorMapDataType t = sizeof(T) == 2
      ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType f = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(T), K = a.K, H = a.H, L = a.L, B = a.B;
  const cuuint64_t dims[4] = {K, H, L, B};
  const cuuint32_t box[4] = {(cuuint32_t)K, 1, TT, 1};
  const cuuint64_t sr[3] = {a.rsH * es, a.rsL * es, a.rsB * es};
  const cuuint64_t sk[3] = {a.ksH * es, a.ksL * es, a.ksB * es};
  const cuuint64_t sv[3] = {a.vsH * es, a.vsL * es, a.vsB * es};
  const cuuint64_t sw[3] = {a.wsH * 4ull, a.wsL * 4ull, a.wsB * 4ull};
  const cuuint64_t sd[3] = {K * 4, H * K * 4, L * H * K * 4};
  return encode(m, t, 4, a.r, dims, sr, box) &&
         encode(m + 1, t, 4, a.k, dims, sk, box) &&
         encode(m + 2, t, 4, a.v, dims, sv, box) &&
         encode(m + 3, f, 4, a.w, dims, sw, box) &&
         encode(m + 4, f, 4, a.dy, dims, sd, box);
}

template <typename T>
static cudaError_t run(Args a, cudaStream_t s) {
  using F = Lay<T>;
  const int rw = F::RW;
  const int kp = (a.K + rw - 1) / rw * rw;      // rows padded to a warp's
  a.NT = 32 * kp / rw;
  a.NG = (a.K + VC - 1) / VC;
  a.RO = ((kp + a.NG - 1) / a.NG + 3) / 4 * 4;
  // the tensor maps and bulk copies need 16-byte aligned bases, strides
  // and rows: every row of r, k, v (cb 16), of w and dy, and the
  // checkpoints' columns (K % 4 == 0)
  alignas(64) CUtensorMap m[5] = {};
  a.tma = a.cb == 16 && a.K % 4 == 0 &&
          !(reinterpret_cast<uintptr_t>(a.ckpt) % 16) &&
          encode_maps<T>(a, m);
  auto kern = wkv6_bwd_chunks<T>;
  static bool opted[64] = {};                    // per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!opted[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (e != cudaSuccess) return e;
    opted[dev & 63] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.NG, a.H, 1);
  cfg.blockDim = dim3(a.NT + 32, 1, 1);      // and the producer warp
  cfg.dynamicSmemBytes = F::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.NG;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, m[0], m[1], m[2], m[3],
                                           m[4], a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace wkvb

// r, k, v (B, L, H, K) bf16 or f32 (is_bf16) and w (B, L, H, K) f32, read
// through the given element strides (unit stride in the last dim); u (H,
// K), dy (B, L, H, K), ds_out (B, H, K, K, or null for a zero cotangent)
// and ckpt ((B, H, ceil(L / 16), K, K): K5's checkpoints of the same
// inputs, each state transposed) f32 contiguous. Writes dr, dk, dv (B, L, H, K) in r's dtype and
// dw (B, L, H, K) f32, contiguous; du (H, K) and ds_in (B, H, K, K) f32.
// One launch; returns its CUDA error code (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* dy,
                        const float* ds_out, const float* ckpt, void* dr,
                        void* dk, void* dv, float* dw, float* du,
                        float* ds_in, long long rsB, long long rsL,
                        long long rsH, long long ksB, long long ksL,
                        long long ksH, long long vsB, long long vsL,
                        long long vsH, long long wsB, long long wsL,
                        long long wsH, int B, int L, int H, int K,
                        int is_bf16, void* stream) {
  using namespace wkvb;
  if (B < 1 || L < 1 || H < 1 || K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  // the widest copy every base, stride and row allows
  const unsigned long long es = is_bf16 ? 2 : 4;
  unsigned long long m =
      reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(dy);
  for (long long st : {rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH})
    m |= (unsigned long long)st * es;
  for (long long st : {wsB, wsL, wsH, (long long)H * K})
    m |= (unsigned long long)st * 4;
  m |= K * es;
  int cb = 16;
  while (cb > 2 && m % cb) cb >>= 1;
  Args a{r,   k,   v,   w,   u,   dy,  ds_out, ckpt, dr,  dk,  dv,  dw,
         du,  ds_in, rsB, rsL, rsH, ksB, ksL, ksH, vsB, vsL, vsH, wsB,
         wsL, wsH, B,   L,   H,   K,   0,   0,   0,   (L + TT - 1) / TT,
         cb,  0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<__nv_bfloat16>(a, s) : run<float>(a, s));
}
