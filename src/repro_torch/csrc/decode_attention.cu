// K3: flash-decoding. One query token per sequence against its KV cache,
// the G = H / Hkv query heads of a kv head batched together, per-sequence
// kv_len; the cache is bf16/f32, or int8 codes with per-(position, head)
// f16 scales.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py:25
// (decode_attention_kernel), called through ops.py:72 decode_attention.
//
// Bound on an H100: decode reads the whole valid cache once and does
// 4 * H * Dh flops per cached position: at H = 40, Hkv = 8, Dh = 128 that is
// 20,480 flops per 4 KiB of bf16 k+v (5 flops per byte; 10 for int8), under
// the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flops per byte): bound by
// bytes. What counts is keeping enough bytes in flight (some 20-30 KB an SM
// at 3.35 TB/s), reading each valid row once, in place, and spending few
// instructions per byte so that the arithmetic hides under the loads.
//
// Design (decode_fast: a bf16 q with a bf16 or int8 cache at Dq = Dv of 64,
// 128 or 256, or a bf16 cache at (Dq, Dv) = (96, 64), (192, 128) or (112,
// 112); K and V each through their own 16-byte aligned base and strides):
// - Work: one CTA of 4 warps per (split, kv head, sequence). The split
//   count follows kv_len on the device: the host sizes the grid to one wave
//   of resident CTAs (occupancy x SMs over B x Hkv), and each CTA reads
//   kv_len[b] and takes chunk = ceil(len / n_split) rounded up to 64
//   positions; CTAs past the last chunk exit at once. With three CTAs an
//   SM, B = 4 and Hkv = 8 give 12 splits: 11 non-empty (352 CTAs) at
//   kv_len 4,096, and 2,752 positions a split at 32,768, whose partials are
//   0.2% of the cache bytes.
// - Loads: each warp streams its own 16-position tiles (the CTA's tiles
//   dealt round-robin) through a private ring of 2-4 stages in shared
//   memory, 16-byte cp.async.cg copies issued stages ahead of their use,
//   rows past kv_len zero-filled. A warp waits only for its own copies, so
//   no CTA barrier sits in the loop. The cache is read in place through its
//   strides: no copy, no transpose. int8 scales come by ordinary loads, as
//   many tiles ahead as the ring.
// - Tensor cores (mma.sync m16n8k16, f32 accumulators). S^T = q K^T puts
//   the query heads on M (G <= 16 in one block), the tile's positions on N
//   and Dq on K; q's fragments are built once, and each lane reads K's as
//   whole 16-byte chunks of a row (the Dq index is permuted alike in both).
//   int8 codes become bf16 exactly (|code| <= 127; two bit masks and one
//   bf16x2 subtraction a pair) and the k scale multiplies the f32 dot
//   afterwards. The online softmax runs on S^T's accumulators in
//   registers, in log2 units; P (int8: times the position's v scale) stays
//   f32 and enters out^T += V^T P^T as two bf16 terms, hi + lo (error <=
//   2^-16 |p|), with Dv on M and the heads on N. Reads of K and V hit each
//   bank once (chunks XOR-swizzled as they are copied in). TF32 is never
//   used.
// - Merge: the 4 warps' states are merged in warp order; a CTA that is the
//   only split of its (sequence, kv head) writes the output, otherwise it
//   writes a partial (m, l, acc) and bumps an arrival counter, and the last
//   CTA to arrive merges the partials in split order (so the result does
//   not depend on arrival order) and resets the counter to 0. One launch.
//
// The Dv mode (a value head dim other than the q/k one: MLA's decode with
// its K/V materialised from the latent cache, Dq 96 and Dv 64 in
// minicpm3-4b, 192 and 128 in deepseek-v2-236b, G = 1; a port extension
// held against the model layer's jnp decode attention) is decode_fast
// templated on Dq and Dv apart: K and V rows of their own sizes (192 or 384
// and 128 or 256 bytes), each with its own base and strides; the copy deals
// a tile's chunks to the lanes in row-major order, so that a row need not
// divide 32 (Dq 96: 12 chunks, 192: 24); the K swizzle applies only where a
// row is a multiple of 128 bytes (at 192 bytes odd rows already start in
// the other half of the banks); the P V tiles, the partial record G x (2 +
// Dv), the merge and the output are sized by Dv; the scale stays
// 1 / sqrt(Dq). Why this and not a CUDA-core instance for G = 1, where 15
// of the 16 rows of S^T's m16n8k16 tile are empty: the work is bound by
// bytes (at G = 1 each position costs Dq + Dv multiply-adds a head for
// 2 (Dq + Dv) bytes), and what the tensor cores waste is instruction
// slots, not bytes. A warp spends some 100 instructions on a 5 KB tile at
// (96, 64) (20 mma, 10 shared loads, 10 copies, the softmax), where f32
// FMAs with bf16x2 unpacking would take about 160 per lane a tile; both
// are far under what an SM can dispatch at 3.35 TB/s / 132 SMs (~15 bytes
// a clock), and one kernel for every mode keeps one set of copy, softmax
// and merge code.
//
// Head dim 112 (zamba2-7b's shared attention block: 32 heads, MHA, G = 1)
// runs the 128 instance over rows padded in shared memory, as K4
// pads it with TMA's zero fill: each 224-byte K and V row comes in as its
// 14 chunks, and chunks 14-15 of the tile row are zero-filled by the same
// cp.async (src-size 0). q's fragments are 0 past 112, so S^T is exact; V's
// padded columns give accumulators of 0 that are never written: the
// partial records, the merge and the output are sized by the real Dv
// (G x (2 + 112) floats a split, (B, H, 112) out), and the scale stays
// 1 / sqrt(112). Device memory still sees 224 bytes a row; only shared
// memory and the tensor cores do 1/7 more, and the kernel is bound by
// bytes. A true 112 template (7 m-blocks of P V, 14-chunk rows, a phys_v
// for 28-byte lane segments) would save that 1/7 of instruction work, not
// a byte. The int8 cache at 112 stays on decode_generic: no config serves
// it (zamba2 decodes from a bf16 cache).
//
// decode_generic keeps the former two-pass design (256-position splits, a
// warp per K row, scalar loads) for every other shape: an f32 q or cache,
// any other Dq <= 256 and Dv <= 256, an int8 cache at 112, and views that
// are not 16-byte aligned. V has its own strides there too, the partial
// record is G x (2 + Dv) floats and the scale 1 / sqrt(Dq).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace da {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 16;          // cache positions in a warp's tile
constexpr int CTA_ROWS = WARPS * ROWS;
constexpr int GMAX = 16;          // query heads per kv head
constexpr int DMAX = 256;         // head dim
constexpr int GCHUNK = 256;       // decode_generic's split
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;           // (B, H, Dh), bf16 or f32
  const void* k;           // (B, Lc, Hkv, Dh)
  const void* v;           // (B, Lc, Hkv, Dv)
  const __half* ks;        // (B, Lc, Hkv) or null
  const __half* vs;
  const void* kv_len;      // (B,) int32 or int64
  void* o;                 // contiguous (B, H, Dv), q's dtype
  float* part;             // (B, Hkv, n_split, G, 2 + Dv): m, l, acc
  int* count;              // (B, Hkv) arrival counters, 0 between calls
  int B, H, Hkv, Dh, Dv, Lc, G;     // Dh: the q/k head dim
  long long qsB, qsH, csB, csL, csH, vsB, vsL, vsH, ssB, ssL, ssH;
  int n_split, q_bf16, kv64;
  float scale;             // 1 / sqrt(Dh)
};

__device__ __forceinline__ int seq_len(const Args& a, int b) {
  const long long n = a.kv64 ? static_cast<const long long*>(a.kv_len)[b]
                             : static_cast<const int*>(a.kv_len)[b];
  return (int)min(max(n, 0LL), (long long)a.Lc);
}

__device__ __forceinline__ float q_at(const Args& a, long long i) {
  return a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}

__device__ __forceinline__ void store_out(const Args& a, long long i,
                                          float x) {
  if (a.q_bf16)
    static_cast<__nv_bfloat16*>(a.o)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(a.o)[i] = x;
}

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

// ---- element conversion ---------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// bf16x2 (128, 128) in a register: with it, (x & mask) | 128 is one LOP3
__device__ __forceinline__ uint32_t bf16x2_128() {
  uint32_t r;
  asm volatile("mov.b32 %0, 0x43004300;" : "=r"(r));
  return r;
}

// two int8 codes, in bytes 0 and 2 of x, as exact bf16x2: per 16-bit half,
// (128 + (code & 127)) - (code < 0 ? 256 : 128), both terms bf16 built by a
// bit mask, and the difference an integer of at most 8 bits. k128 is
// bf16x2_128().
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t x, uint32_t k128) {
  uint32_t m, s;                         // (x & mask) | k128, one LOP3 each
  asm("lop3.b32 %0, %1, 0x007f007f, %2, 0xea;" : "=r"(m) : "r"(x), "r"(k128));
  asm("lop3.b32 %0, %1, 0x00800080, %2, 0xea;" : "=r"(s) : "r"(x), "r"(k128));
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
              *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---- async copies and the tensor-core product --------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- decode_fast -----------------------------------------------------------

template <typename KT, int DQ, int DV, int NB, int DQR, int DVR>
struct Fast {
  static constexpr int ES = (int)sizeof(KT);     // bf16 or int8
  static constexpr int RK = DQ * ES, RV = DV * ES;   // bytes of a K, V row
  static constexpr int NCK = RK / 16, NCV = RV / 16; // 16-byte chunks a row
  // of them, the chunks the cache holds (DQR, DVR: the real head dims; the
  // rest of a tile row is zero-filled)
  static constexpr int NCKR = DQR * ES / 16, NCVR = DVR * ES / 16;
  static constexpr int EPC = 16 / ES;            // elements a chunk
  static constexpr int SB = ROWS * (RK + RV);    // a stage: K and V tiles
  static constexpr int STAGES = SB <= 4096 ? 4 : 2;   // ~16 KB a warp
  static constexpr int GP = 8 * NB;              // heads, padded
  static constexpr int RING = WARPS * STAGES * SB;
  // P V as V^T P^T: Dv on M in m-blocks of 16; a lane row of the A
  // fragment owns DPL consecutive head-dim elements (SEG bytes)
  static constexpr int MB = DV / 16, DPL = DV / 8, SEG = DPL * ES;
  // after the ring (floats): each warp's running max and sum per head
  static constexpr int MRUN = 0, LSUM = MRUN + WARPS * GP,
                       NF = LSUM + WARPS * GP;
  static constexpr int SMEM = RING + 4 * NF + 16;
  static_assert(ES <= 2 && NCK % 4 == 0 && NCV >= 4,
                "bf16 or int8 rows, K's of 64-byte multiples");
  static_assert(ROWS * NCK % 32 == 0 && ROWS * NCV % 32 == 0,
                "a tile's chunks deal evenly to the lanes");
  static_assert(RING >= 4 * WARPS * GP * DV, "the merge reuses the ring");
  static_assert((DQR == DQ && DVR == DV) ||
                    (ES == 2 && DQR * 2 % 16 == 0 && DVR * 2 % 16 == 0 &&
                     DQR <= DQ && DVR <= DV),
                "padded rows: bf16 rows of whole 16-byte chunks");

  // Where chunk c of row r lies, so that a warp's 16-byte fragment reads
  // hit each bank once. K (rows g, g + 8, chunks 4i + t; a quarter warp
  // reads rows 2p and 2p + 1): where a row is a multiple of 128 bytes, odd
  // rows swap 64-byte halves (XOR 4 stays within a row of 8k chunks); a
  // row of 64 mod 128 bytes already puts odd rows in the other half.
  // V (rows 2t + {0, 1, 8, 9}, the lane's SEG bytes at g * SEG): chunks
  // XORed by a function of (r >> 1) & 3.
  __device__ static int phys_k(int r, int c) {
    return NCK % 8 == 0 ? (c ^ ((r & 1) << 2)) : c;
  }
  __device__ static int phys_v(int r, int c) {
    const int t = (r >> 1) & 3;
    constexpr int CPR = SEG / 16;
    const int x = CPR == 1 ? 2 * t
                : CPR == 2 ? ((t & 1) | ((t & 2) << 1))
                : CPR >= 4 ? t : ((t & 1) << 1);
    return c ^ x;
  }
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename KT, int DQ, int DV, int NB, int DQR, int DVR>
__global__ void __launch_bounds__(THREADS)
decode_fast(Args a) {
  using F = Fast<KT, DQ, DV, NB, DQR, DVR>;
  constexpr int ES = F::ES, RK = F::RK, RV = F::RV, EPC = F::EPC;
  constexpr int NCK = F::NCK, NCV = F::NCV;
  constexpr int SB = F::SB, STAGES = F::STAGES, GP = F::GP;
  constexpr bool Q8 = sizeof(KT) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem + F::RING);
  int* last_flag = reinterpret_cast<int*>(fs + F::NF);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.G, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long obase = ((long long)b * a.H + (long long)hk * G) * DVR;
  const int len = seq_len(a, b);
  if (len == 0) {                             // no valid position: output 0
    if (split == 0)
      for (int e = tid; e < G * DVR; e += THREADS) store_out(a, obase + e, 0.f);
    return;
  }
  int chunk = (len + a.n_split - 1) / a.n_split;
  chunk = (chunk + CTA_ROWS - 1) / CTA_ROWS * CTA_ROWS;
  const int ns = (len + chunk - 1) / chunk;
  if (split >= ns) return;                    // past kv_len: nothing to do
  const int start = split * chunk, end = min(len, start + chunk);
  const int ntile = (end - start + ROWS - 1) / ROWS;
  const int nt = warp < ntile ? (ntile - warp + WARPS - 1) / WARPS : 0;

  const unsigned char* kb = static_cast<const unsigned char*>(a.k) +
                            (b * a.csB + hk * a.csH) * ES;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v) +
                            (b * a.vsB + hk * a.vsH) * ES;
  const long long krs = a.csL * ES, vrs = a.vsL * ES;   // row strides
  unsigned char* ring = smem + warp * STAGES * SB;
  // int8 scales of (b, hk); a position's offset fits 32 bits (the host
  // checks)
  const __half* ksb = Q8 ? a.ks + b * a.ssB + hk * a.ssH : nullptr;
  const __half* vsb = Q8 ? a.vs + b * a.ssB + hk * a.ssH : nullptr;
  const int ssl = (int)a.ssL;

  // a lane copies chunks lane, lane + 32, ... of a tile's ROWS x NC
  // chunks in row-major order (NC need not divide 32)
  auto issue = [&](int i) {                   // this warp's i-th tile
    unsigned char* Ks = ring + (i % STAGES) * SB;
    unsigned char* Vs = Ks + ROWS * RK;
    const int p0 = start + (warp + WARPS * i) * ROWS;
    const unsigned char* kt = kb + p0 * krs;
    const unsigned char* vt = vb + p0 * vrs;
#pragma unroll
    for (int it = 0; it < ROWS * NCK / 32; ++it) {
      const int f = lane + 32 * it, r = f / NCK, c = f % NCK;
      const bool ok = p0 + r < end && c < F::NCKR;
      cp16(Ks + r * RK + F::phys_k(r, c) * 16,
           ok ? kt + r * krs + c * 16 : kb, ok);
    }
#pragma unroll
    for (int it = 0; it < ROWS * NCV / 32; ++it) {
      const int f = lane + 32 * it, r = f / NCV, c = f % NCV;
      const bool ok = p0 + r < end && c < F::NCVR;
      cp16(Vs + r * RV + F::phys_v(r, c) * 16,
           ok ? vt + r * vrs + c * 16 : vb, ok);
    }
  };
  for (int i = 0; i < STAGES; ++i) {
    if (i < nt) issue(i);
    cp_commit();
  }

  float* mrun = fs + F::MRUN;                 // (WARPS, GP), for the merge
  float* lsum = fs + F::LSUM;
  float* wacc = reinterpret_cast<float*>(smem);   // (WARPS, GP, DV), later
  const float sc2 = a.scale * LOG2E;
  const int g8 = lane >> 2, t4 = lane & 3;

  // ---- tensor cores. S^T = q K^T: the heads on M (16 rows: G <= 16),
  // the tile's 16 positions on N (two n-blocks: K rows g8 and g8 + 8), Dq
  // on K. Then out^T += V^T P^T: Dv on M, the heads on N (NB n-blocks of
  // 8), the 16 positions on K, with P from S^T's accumulators in
  // registers (split into bf16 hi + lo). Lane (g8, t4) keeps the softmax
  // state of heads g8 (and g8 + 8) and reads P for positions 2t4, 2t4 + 1,
  // 2t4 + 8, 2t4 + 9, the ones its V^T fragment holds.
  constexpr int SP = EPC / 4, MB = F::MB, DPL = F::DPL, SEG = F::SEG;
  // q as A fragments: k-step s, lane t4 holds slots 2t4, 2t4 + 1,
  // 2t4 + 8, 2t4 + 9 = four consecutive head-dim elements from d0, the
  // ones the same lane's B fragment takes from its 16-byte chunk of K
  uint32_t qa[DQ / 16][4];
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int n = g8 + 8 * hb;
    const uint16_t* qp = static_cast<const uint16_t*>(a.q) + b * a.qsB +
                         (long long)(hk * G + min(n, G - 1)) * a.qsH;
    const bool on = n < G;
#pragma unroll
    for (int s = 0; s < DQ / 16; ++s) {
      const int d0 = (s / SP) * 4 * EPC + t4 * EPC + 4 * (s % SP);
      const bool in = on && d0 < DQR;          // zero past the real Dq
      qa[s][hb] =
          in ? (uint32_t)qp[d0] | ((uint32_t)qp[d0 + 1] << 16) : 0u;
      qa[s][hb + 2] =
          in ? (uint32_t)qp[d0 + 2] | ((uint32_t)qp[d0 + 3] << 16) : 0u;
    }
  }
  const uint32_t k128 = bf16x2_128();
  float acc[NB][MB][4];
#pragma unroll
  for (int hb = 0; hb < NB; ++hb)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hb][mb][e] = 0.f;
  float m_run[NB], l_run[NB];
#pragma unroll
  for (int hb = 0; hb < NB; ++hb) { m_run[hb] = -INFINITY; l_run[hb] = 0.f; }

  // int8: k and v scales of the lane's positions, loaded as many tiles
  // ahead as the ring holds (a queue in registers), so that their
  // latency hides as the tiles' does
  constexpr int AHEAD = STAGES - 1;
  float qk[AHEAD][4], qv[AHEAD][4], sk[4], sv[4];
  auto fetch = [&](int i, float* k4, float* v4) {
    const int p0 = start + (warp + WARPS * i) * ROWS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = p0 + 2 * t4 + (e & 1) + 8 * (e >> 1);
      const bool ok = i < nt && pos < end;
      k4[e] = ok ? __half2float(ksb[pos * ssl]) : 0.f;
      v4[e] = ok ? __half2float(vsb[pos * ssl]) : 0.f;
    }
  };
  if constexpr (Q8) {
#pragma unroll
    for (int d = 0; d < AHEAD; ++d) fetch(d, qk[d], qv[d]);
  }

  for (int i = 0; i < nt; ++i) {
    if constexpr (Q8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) { sk[e] = qk[0][e] * sc2; sv[e] = qv[0][e]; }
#pragma unroll
      for (int d = 0; d + 1 < AHEAD; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qk[d][e] = qk[d + 1][e];
          qv[d][e] = qv[d + 1][e];
        }
      fetch(i + AHEAD, qk[AHEAD - 1], qv[AHEAD - 1]);
    }
    cp_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* Ks = ring + (i % STAGES) * SB;
    const unsigned char* Vs = Ks + ROWS * RK;
    const int nrow = min(ROWS, end - (start + (warp + WARPS * i) * ROWS));

    // S^T: c[nb] holds (head g8, positions 8nb + 2t4 + {0, 1}) and
    // (head g8 + 8, the same positions)
    float c[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
    const unsigned char* K0 = Ks + g8 * RK;
    const unsigned char* K1 = K0 + 8 * RK;
#pragma unroll
    for (int ci = 0; ci < NCK / 4; ++ci) {
      const int ch = F::phys_k(g8, 4 * ci + t4) * 16;
      const uint4 x0 = *reinterpret_cast<const uint4*>(K0 + ch);
      const uint4 x1 = *reinterpret_cast<const uint4*>(K1 + ch);
      const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
      if constexpr (ES == 2) {        // 8 bf16 a chunk: two k-steps
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* q4 = qa[2 * ci + h];
          mma_bf16(c[0], q4[0], q4[1], q4[2], q4[3], w0[2 * h],
                   w0[2 * h + 1]);
          mma_bf16(c[1], q4[0], q4[1], q4[2], q4[3], w1[2 * h],
                   w1[2 * h + 1]);
        }
      } else {                        // 16 codes a chunk: four k-steps
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // codes 0, 1 and 2, 3 of a word
          const uint32_t* q4 = qa[4 * ci + h];
          mma_bf16(c[0], q4[0], q4[1], q4[2], q4[3],
                   codes_bf16x2(__byte_perm(w0[h], 0, 0x4140), k128),
                   codes_bf16x2(__byte_perm(w0[h], 0, 0x4342), k128));
          mma_bf16(c[1], q4[0], q4[1], q4[2], q4[3],
                   codes_bf16x2(__byte_perm(w1[h], 0, 0x4140), k128),
                   codes_bf16x2(__byte_perm(w1[h], 0, 0x4342), k128));
        }
      }
    }

    // online softmax per head row, in log2 units; P as B fragments
    uint32_t phi[NB][2], plo[NB][2];
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
      const bool on = g8 + 8 * hb < G;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // positions 2t4 + (e&1) + 8 (e>>1)
        const int pos = 2 * t4 + (e & 1) + 8 * (e >> 1);
        const float s = c[e >> 1][2 * hb + (e & 1)] *
                        (Q8 ? sk[e] : sc2);
        x[e] = (on && pos < nrow) ? s : -INFINITY;
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run[hb], mx);
      const float al = mn == -INFINITY ? 1.f : exp2f(m_run[hb] - mn);
      m_run[hb] = mn;
      float p[4], ls = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = mn == -INFINITY ? 0.f : exp2f(x[e] - mn);
        ls += p[e];
        if constexpr (Q8) p[e] *= sv[e];
      }
      l_run[hb] = fmaf(l_run[hb], al, ls);
      // acc columns are heads 8hb + 2t4 (+1): their factors live in
      // lanes 8 t4 and 8 t4 + 4
      // (once the running max settles, every factor is 1: skipped)
      if (__any_sync(0xffffffffu, al != 1.f)) {
        const float a0 = __shfl_sync(0xffffffffu, al, 8 * t4);
        const float a1 = __shfl_sync(0xffffffffu, al, 8 * t4 + 4);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          acc[hb][mb][0] *= a0;
          acc[hb][mb][1] *= a1;
          acc[hb][mb][2] *= a0;
          acc[hb][mb][3] *= a1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {   // positions 2t4 + {0,1} (+8)
        const uint32_t h = bf16x2(p[2 * kk], p[2 * kk + 1]);
        phi[hb][kk] = h;
        plo[hb][kk] = bf16x2(p[2 * kk] - __uint_as_float(h << 16),
                             p[2 * kk + 1] -
                                 __uint_as_float(h & 0xffff0000u));
      }
    }

    // out^T += V^T P^T. The lane's V^T rows g8 and g8 + 8 of m-block mb
    // are v head-dim elements g8 DPL + 2 mb and + 1; its k slots the
    // positions 2t4, 2t4 + 1 (a0, a1) and 2t4 + 8, 2t4 + 9 (a2, a3)
    const unsigned char* Vr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Vr[e] = Vs + (2 * t4 + (e & 1) + 8 * (e >> 1)) * RV;
    constexpr int STEP = SEG < 16 ? SEG : 16;   // bytes a load
#pragma unroll
    for (int cs = 0; cs < SEG / STEP; ++cs) {
      uint32_t w[4][STEP / 4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * t4 + (e & 1) + 8 * (e >> 1);
        const int byte = g8 * SEG + cs * STEP;
        const unsigned char* src =
            Vr[e] + F::phys_v(r, byte / 16) * 16 + byte % 16;
        if constexpr (STEP == 16) {
          const uint4 x = *reinterpret_cast<const uint4*>(src);
          w[e][0] = x.x; w[e][1] = x.y; w[e][2] = x.z; w[e][3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(src);
          w[e][0] = x.x; w[e][1] = x.y;
        }
      }
      constexpr int MPS = STEP / (2 * ES);      // m-blocks a load
#pragma unroll
      for (int k = 0; k < MPS; ++k) {
        uint32_t av[4];                          // a0..a3
        if constexpr (ES == 2) {
          // word k of a position: elements 2 mb (low), 2 mb + 1 (high)
          av[0] = __byte_perm(w[0][k], w[1][k], 0x5410);
          av[1] = __byte_perm(w[0][k], w[1][k], 0x7632);
          av[2] = __byte_perm(w[2][k], w[3][k], 0x5410);
          av[3] = __byte_perm(w[2][k], w[3][k], 0x7632);
        } else {
          // codes 2k, 2k + 1 of the load: word k / 2, bytes 2 (k % 2)
          // and + 1; a pair takes a byte of each of two positions
          const int wi = k >> 1, by = 2 * (k & 1);
          const uint32_t s0 = ((4 + by) << 8) | by;
          const uint32_t s1 = ((5 + by) << 8) | (by + 1);
          av[0] = codes_bf16x2(__byte_perm(w[0][wi], w[1][wi], s0), k128);
          av[1] = codes_bf16x2(__byte_perm(w[0][wi], w[1][wi], s1), k128);
          av[2] = codes_bf16x2(__byte_perm(w[2][wi], w[3][wi], s0), k128);
          av[3] = codes_bf16x2(__byte_perm(w[2][wi], w[3][wi], s1), k128);
        }
        const int mb = cs * MPS + k;
#pragma unroll
        for (int hb = 0; hb < NB; ++hb) {
          mma_bf16(acc[hb][mb], av[0], av[1], av[2], av[3], phi[hb][0],
                   phi[hb][1]);
          mma_bf16(acc[hb][mb], av[0], av[1], av[2], av[3], plo[hb][0],
                   plo[hb][1]);
        }
      }
    }
    __syncwarp();
    if (i + STAGES < nt) issue(i + STAGES);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();                          // the ring is free: merge area

  // this warp's state to shared memory, heads in order
#pragma unroll
  for (int hb = 0; hb < NB; ++hb) {
    float l = l_run[hb];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t4 == 0) {
      mrun[warp * GP + 8 * hb + g8] = m_run[hb];
      lsum[warp * GP + 8 * hb + g8] = l;
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int d = g8 * DPL + 2 * mb, h = 8 * hb + 2 * t4;
      float* w0 = wacc + (warp * GP + h) * DV + d;
      *reinterpret_cast<float2*>(w0) =
          make_float2(acc[hb][mb][0], acc[hb][mb][2]);
      *reinterpret_cast<float2*>(w0 + DV) =
          make_float2(acc[hb][mb][1], acc[hb][mb][3]);
    }
  }
  __syncthreads();

  // ---- the CTA's (m, l, acc): warps merged in order
  const float* mw = fs + F::MRUN;
  const long long pair = (long long)b * a.Hkv + hk;
  float* part = a.part + (pair * a.n_split + split) * G * (2 + DVR);
  for (int e = tid; e < G * DVR; e += THREADS) {     // the real Dv only
    const int g = e / DVR, d = e - g * DVR;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * GP + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(mw[w * GP + g] - M);   // empty warp: 0
      L = fmaf(lsum[w * GP + g], wt, L);
      A = fmaf(wacc[(w * GP + g) * DV + d], wt, A);
    }
    if (ns == 1) {
      store_out(a, obase + e, A / L);
    } else {
      float* rec = part + g * (2 + DVR);
      rec[2 + d] = A;
      if (d == 0) { rec[0] = M; rec[1] = L; }
    }
  }
  if (ns == 1) return;

  // ---- arrival: the last CTA of (b, hk) merges the splits in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(a.count + pair, 1) == ns - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  // the splits' weights exp2(m - M) and 1 / L per head, in the free ring;
  // then each thread sums its outputs over the splits, its loads of one
  // split independent of each other
  const float* p0 = a.part + pair * a.n_split * G * (2 + DVR);
  float* wsp = reinterpret_cast<float*>(smem);     // (ns, G) m, then weight
  float* lsp = wsp + ns * G;                       // (ns, G) l
  float* linv = lsp + ns * G;                      // (G,)
  for (int e = tid; e < ns * G; e += THREADS) {
    wsp[e] = __ldcg(p0 + e * (2 + DVR));
    lsp[e] = __ldcg(p0 + e * (2 + DVR) + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = -INFINITY, L = 0.f;
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, wsp[sp * G + tid]);
    for (int sp = 0; sp < ns; ++sp) {
      const float wt = exp2f(wsp[sp * G + tid] - M);
      wsp[sp * G + tid] = wt;
      L = fmaf(lsp[sp * G + tid], wt, L);
    }
    linv[tid] = 1.f / L;
  }
  __syncthreads();
  constexpr int PER = (GP * DVR + THREADS - 1) / THREADS;
  float A[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) A[k] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < ns; ++sp) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS, g = e / DVR;
      if (g < G)
        A[k] = fmaf(__ldcg(p0 + (sp * G + g) * (2 + DVR) + 2 + (e - g * DVR)),
                    wsp[sp * G + g], A[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS, g = e / DVR;
    if (g < G) store_out(a, obase + e, A[k] * linv[g]);
  }
  if (tid == 0) a.count[pair] = 0;            // ready for the next call
}

// ---- decode_generic: any shape, two passes ------------------------------

template <typename KT, bool Q8>
__global__ void __launch_bounds__(THREADS)
decode_generic(Args a) {
  __shared__ float qs[GMAX * DMAX];
  __shared__ float ps[GMAX * GCHUNK];
  __shared__ float vsc[GCHUNK];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.G, Dh = a.Dh, Dv = a.Dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = seq_len(a, b);
  const int start = split * GCHUNK, n = min(GCHUNK, len - start);
  if (n <= 0) return;                      // pass 2 reads splits < kv_len
  float* rec = a.part + (((long long)b * a.Hkv + hk) * a.n_split + split) *
                            G * (2 + Dv);
  for (int e = threadIdx.x; e < G * Dh; e += THREADS) {
    const int g = e / Dh, d = e - g * Dh;
    qs[g * DMAX + d] = q_at(a, b * a.qsB + (long long)(hk * G + g) * a.qsH + d);
  }
  const KT* kbase = static_cast<const KT*>(a.k) + b * a.csB +
                    (long long)start * a.csL + hk * a.csH;
  const KT* vbase = static_cast<const KT*>(a.v) + b * a.vsB +
                    (long long)start * a.vsL + hk * a.vsH;
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
        if (lane == 0) ps[g * GCHUNK + j] = s * a.scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, a warp per head: p = exp(s - m), l = sum p
  for (int g = warp; g < G; g += WARPS) {
    float* pr = ps + g * GCHUNK;
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
      rec[g * (2 + Dv)] = m;
      rec[g * (2 + Dv) + 1] = l;
    }
  }
  __syncthreads();

  // partial P V: a thread per column, each V row read once for all heads
  for (int d = threadIdx.x; d < Dv; d += THREADS) {
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    for (int j = 0; j < n; ++j) {
      const KT x = vbase[j * a.vsL + d];
      const float vf = Q8 ? to_f32(x) * vsc[j] : to_f32(x);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = fmaf(ps[g * GCHUNK + j], vf, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) rec[g * (2 + Dv) + 2 + d] = acc[g];
  }
}

// pass 2: one CTA per (head, sequence) merges the splits below kv_len
__global__ void __launch_bounds__(THREADS)
decode_generic_combine(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.G, hk = h / G, g = h - hk * G, Dv = a.Dv;
  const int ns = (seq_len(a, b) + GCHUNK - 1) / GCHUNK;
  const float* p0 = a.part +
      ((long long)b * a.Hkv + hk) * a.n_split * G * (2 + Dv) + g * (2 + Dv);
  const long long stride = (long long)G * (2 + Dv);
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, p0[s * stride]);
  for (int d = threadIdx.x; d < Dv; d += THREADS) {
    float acc = 0.f, l = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* rec = p0 + s * stride;
      const float w = expf(rec[0] - M);
      l = fmaf(rec[1], w, l);
      acc = fmaf(rec[2 + d], w, acc);
    }
    store_out(a, ((long long)b * a.H + h) * Dv + d, l > 0.f ? acc / l : 0.f);
  }
}

// ---- launch ----------------------------------------------------------------

template <typename KT, int DQ, int DV, int NB, int DQR, int DVR>
cudaError_t launch_fast(Args& a, long long s_cap, cudaStream_t s) {
  using F = Fast<KT, DQ, DV, NB, DQR, DVR>;
  static int resident[64] = {};          // per device: CTAs of one wave
  int dev = 0;
  cudaGetDevice(&dev);
  if (!resident[dev & 63]) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_fast<KT, DQ, DV, NB, DQR, DVR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_fast<KT, DQ, DV, NB, DQR, DVR>, THREADS, F::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident[dev & 63] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  // one wave: splits per (sequence, kv head) from the resident CTAs; each
  // CTA then takes ceil(kv_len / n_split) positions, so a shorter kv_len
  // runs fewer splits and the rest exit at once
  long long want = resident[dev & 63] / ((long long)a.B * a.Hkv);
  want = want < 1 ? 1 : want;
  want = want > s_cap ? s_cap : want;
  long long most = (a.Lc + CTA_ROWS - 1) / CTA_ROWS;
  const long long fit = F::RING / (4 * 2 * GMAX + 4);   // the merge's m, l
  most = most < fit ? most : fit;
  a.n_split = (int)(want > most ? most : want);
  dim3 grid((unsigned)a.n_split, (unsigned)a.Hkv, (unsigned)a.B);
  decode_fast<KT, DQ, DV, NB, DQR, DVR><<<grid, THREADS, F::SMEM, s>>>(a);
  return cudaGetLastError();
}

template <typename KT, int DQ, int DV, int DQR = DQ, int DVR = DV>
cudaError_t launch_g(Args& a, long long s_cap, cudaStream_t s) {
  // the heads on two n-blocks of P V where G > 8
  return a.G > 8 ? launch_fast<KT, DQ, DV, 2, DQR, DVR>(a, s_cap, s)
                 : launch_fast<KT, DQ, DV, 1, DQR, DVR>(a, s_cap, s);
}

template <typename KT>
cudaError_t launch_dh(Args& a, long long s_cap, cudaStream_t s) {
  switch (a.Dh) {
    case 64: return launch_g<KT, 64, 64>(a, s_cap, s);
    case 128: return launch_g<KT, 128, 128>(a, s_cap, s);
    default: return launch_g<KT, 256, 256>(a, s_cap, s);
  }
}

// zamba2-7b's head dim 112 in a bf16 cache: the 128 instance over rows
// zero-filled past 112
cudaError_t launch_112(Args& a, long long s_cap, cudaStream_t s) {
  return launch_g<__nv_bfloat16, 128, 128, 112, 112>(a, s_cap, s);
}

// the Dv mode at MLA's head dims: minicpm3-4b's and deepseek-v2-236b's
cudaError_t launch_dv(Args& a, long long s_cap, cudaStream_t s) {
  return a.Dh == 96 ? launch_g<__nv_bfloat16, 96, 64>(a, s_cap, s)
                    : launch_g<__nv_bfloat16, 192, 128>(a, s_cap, s);
}

template <typename KT, bool Q8>
cudaError_t launch_generic(Args a, long long s_cap, cudaStream_t s) {
  a.n_split = (int)((a.Lc + GCHUNK - 1) / GCHUNK);
  if (a.n_split > s_cap) return cudaErrorInvalidValue;
  dim3 grid((unsigned)a.n_split, (unsigned)a.Hkv, (unsigned)a.B);
  decode_generic<KT, Q8><<<grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_generic_combine<<<dim3((unsigned)a.H, (unsigned)a.B), THREADS, 0,
                           s>>>(a);
  return cudaGetLastError();
}

}  // namespace da

// q (B, H, Dh) bf16 or f32 with unit stride in Dh; k cache (B, Lc, Hkv, Dh)
// with strides ksB, ksL, ksH and v cache (B, Lc, Hkv, Dv) with strides vsB,
// vsL, vsH (each with unit stride in its head dim); kv_kind 0 = f32, 1 =
// bf16, 2 = int8 codes with f16 scales ks/vs (B, Lc, Hkv) sharing ssB, ssL,
// ssH; kv_len (B,) int32, or int64 when kv64; o contiguous (B, H, Dv) of
// q's dtype; part f32 scratch of B * Hkv * s_cap * G * (2 + Dv) floats,
// s_cap >= ceil(Lc / 256); count (B * Hkv) int32 counters that are 0 on
// entry and are left 0. Writes the grid's splits per (sequence, kv head)
// to *n_split, 0 for the generic path. Returns the launch status.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kv_len, void* o, float* part, int* count,
    int* n_split, long long B, long long H, long long Hkv, long long Dh,
    long long Dv, long long Lc, long long qsB, long long qsH, long long ksB,
    long long ksL, long long ksH, long long vsB, long long vsL, long long vsH,
    long long ssB, long long ssL, long long ssH, long long s_cap,
    long long q_bf16, long long kv_kind, long long kv64, void* stream) {
  using namespace da;
  if (B == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv || H / Hkv > GMAX || Dh < 1 || Dh > DMAX ||
      Dv < 1 || Dv > DMAX)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const __half*>(ks),
         static_cast<const __half*>(vs), kv_len, o, part, count,
         (int)B, (int)H, (int)Hkv, (int)Dh, (int)Dv, (int)Lc, (int)(H / Hkv),
         qsB, qsH, ksB, ksL, ksH, vsB, vsL, vsH, ssB, ssL, ssH, 0,
         (int)q_bf16, (int)kv64, 1.0f / sqrtf((float)Dh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // decode_fast: a bf16 q with a bf16 or int8 cache at Dh = Dv of 64, 128
  // or 256, or a bf16 cache at (Dh, Dv) = (96, 64), (192, 128) or (112,
  // 112); K and V each with 16-byte aligned base and strides.
  // decode_generic: the rest
  const long long es = kv_kind == 0 ? 4 : (kv_kind == 1 ? 2 : 1);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
       16) == 0 && (ksB * es) % 16 == 0 && (ksL * es) % 16 == 0 &&
      (ksH * es) % 16 == 0 && (vsB * es) % 16 == 0 && (vsL * es) % 16 == 0 &&
      (vsH * es) % 16 == 0;
  const bool narrow =                  // int8 scale offsets fit 32 bits
      kv_kind != 2 || ssL * (Lc - 1) < (1LL << 31);
  const bool same_d = Dv == Dh && (Dh == 64 || Dh == 128 || Dh == 256);
  const bool mla = kv_kind == 1 && ((Dh == 96 && Dv == 64) ||
                                    (Dh == 192 && Dv == 128));
  const bool pad112 = kv_kind == 1 && Dh == 112 && Dv == 112;
  const bool fast = q_bf16 && kv_kind != 0 && aligned && narrow &&
                    (same_d || mla || pad112);
  cudaError_t e;
  if (fast)
    e = mla ? launch_dv(a, s_cap, s)
        : pad112 ? launch_112(a, s_cap, s)
        : kv_kind == 2 ? launch_dh<int8_t>(a, s_cap, s)
                       : launch_dh<__nv_bfloat16>(a, s_cap, s);
  else
    e = kv_kind == 2 ? launch_generic<int8_t, true>(a, s_cap, s)
        : kv_kind == 1 ? launch_generic<__nv_bfloat16, false>(a, s_cap, s)
                       : launch_generic<float, false>(a, s_cap, s);
  *n_split = fast ? a.n_split : 0;
  return (int)e;
}
