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
// operations, 2 H (Dq + Dv) flops a (query, key) pair (minicpm3's 40 x (96
// + 64): 0.109 ms; zamba2's 32 x 224: 0.122 ms). At Dv 64 the softmax
// nearly matches the products: a pair's exp2 takes 1/16 of an SM's clock
// on the SFU, its 320 flops 0.078 clocks on the tensor cores. The
// embedder's f32 attention (L = 24) is tiny and bound by launch latency.
//
// Contract (both bf16 templates and f32): every mask mode (causal,
// window, prefix, q_offset, a ragged kv_valid_len) and GQA; scale 1 /
// sqrt(Dq); P rounded to bf16 before P V, l summing the unrounded P;
// output (B, Lq, H, Dv) contiguous, nothing padded or sliced in device
// memory; a view TMA cannot describe is refused by the wrapper; no
// atomics and a static order of work, so repeats are bit-identical.
//
// Design: head h reads kv head h / (H / Hkv) in place, through the
// caller's strides: no transposed or padded copy. A CTA loops over kv
// tiles, keeping the running max m and sum l in f32, and divides by l at
// the end (0 for a fully masked row). The loop bounds skip the kv tiles that
// the causal mask or the window masks entirely, and tiles past the
// sequence's kv length. bf16 has two templates; the dispatch at the end of
// this file (mirrored by ops.py fwd_route) picks one a call.
//   * bf16, flash_bf16 (the pairs whose widths pad alike to 64, 128 or 256
//     but zamba2's 112: qwen3's 128), warp-specialised for Hopper. A CTA
//     takes a 128-row q tile with
//     three warpgroups: one producer thread keeps TMA loads in flight (Q
//     once; K and V into a two-stage ring, 128 keys a tile, 64 at
//     Dh = 256, with full/empty mbarriers), and two consumer warpgroups of
//     64 rows each run S = Q K^T on wgmma with both operands in shared
//     memory and O += P V on wgmma with P from registers and V read as a
//     transposed (MN-major) operand. setmaxnreg moves registers from the
//     producer (40) to the consumers (232), which hold S, O and P. The two
//     consumers take the tensor cores in turn (named barriers): each turn
//     issues P V of the previous tile and S of this one, so one consumer's
//     softmax runs under the other's products. Loads are
//     4-D tensor maps (Dh, heads, positions, batch) with byte strides and
//     128-byte swizzle (a 128-column row is two 64-column boxes), encoded on
//     the host per call; TMA zero-fills past the tensor's extent, and keys
//     past kv_valid_len are masked here. Only edge tiles (the causal
//     diagonal, the window's far edge, the kv_valid_len edge, the prefix
//     boundary) evaluate the per-element mask. Scores go to the exp2
//     domain with scale * log2(e) folded into one FFMA before ex2; P is
//     rounded to bf16 before P V, as the model layer does, and l sums the
//     unrounded f32 P. The q tile is the
//     slowest grid index, reversed, so the longest causal tiles start first.
//     The old mma.sync kernel waited on synchronous loads before each tile's
//     products; here the next tile's K and V land while this one computes.
//   * bf16, flash_bf16_persistent (zamba2's (112, 112) at <112, 112, 128>;
//     MLA's pairs: Dq <= 96 with Dv <= 64 at <96, 64, 192>, minicpm3's,
//     the others at <192, 128, 96>, deepseek-v2's). The same producer and
//     two ping-pong consumers of 64 rows, redesigned where the old template
//     lost time at these widths:
//     - exact widths: S takes ceil(Dq / 16) k-steps (6 at 96, 7 at 112, 12
//       at 192) and P V runs at N = Dv (64, 112, 128); shared memory stays
//       in 64-column slabs, TMA zero-filling the last one past the width.
//     - products under the softmax inside a consumer: one turn issues S(j)
//       and P V(j - 1) as two commit groups, wgmma.wait_group 1 retires S
//       alone, the softmax of j runs while P V(j - 1) does, and O is
//       rescaled after wait_group 0 (one S register set; P stays f32 in it
//       until the P V that reads the previous P fragments has retired).
//     - the softmax: the mask only on edge tiles (tile_full), as per-row
//       bounds with selects, one branch a tile (flash_bf16's mask compiles
//       to a branch an element, which at these widths more than doubled
//       the kernel's time); the row's max and sum in four partials, so the
//       reductions are not one chain.
//     - a persistent grid: one CTA an SM walks a static order of units,
//       each a (sequence, head) and the pair of q tiles NQ - 1 - i and i
//       (the longer first), equal work for causal calls; consecutive units
//       are one head's, so the CTAs in flight share the K and V of about
//       grid / NP heads in L2 (NP = 16 units a head at 4,096 tokens;
//       deepseek-v2's 128 heads hold 335 MB of K and V).
//       Two Q buffers: the producer loads the next tile's Q while this one
//       runs; each consumer's half of a spent Q tile stages its O, which
//       one thread writes by TMA store (rows past Lq and columns past Dv
//       clipped), so the epilogue runs under the next tile.
//     - kv tiles of 192 keys at Dv 64 (fewer, longer turns for a softmax
//       that nearly matches its products), 128 at 112, 96 at (192, 128),
//       where the two Q buffers leave room for two stages of 96 keys.
//     No write to a wgmma accumulator between the groups that ptxas cannot
//     order: chip_smoke fails on a spill or on ptxas's "wgmma ...
//     serialized" warning for these instances.
//     - training calls at <96, 64, 192> (minicpm3's MLA; ops.py
//       FlashAttentionFn) take flash_bf16_persistent_lse, the same body
//       with each row's LSE (m + log2 l in the exp2 domain, +inf where the
//       row sees no key or lies past Lq) written into a (B, H, Lq rounded
//       up to 64) f32 buffer for the backward's exact-width pair, which
//       then runs no pass 1 (flash_attention_bwd.cu). O is the same bits;
//       the serving instance is compiled as before (persistent_body takes
//       its arguments by reference).
//   * f32: CUDA-core FMAs in full fp32, never TF32 and no tensor cores (a
//     TF32 score moves the embedding and can flip a theta_R decision). The
//     embedder's call (B = 4 or 1, L = 24, H = 12, Dh = 64) is 0.4 us of
//     bytes: it is bound by latency, the chain from the loads to the
//     stores. Calls with Lkv <= 128 (64 at Dh > 128) take a one-pass kernel:
//     a CTA of 4 warps takes 16 query rows of one head (8 where the grid
//     would be thinner than the card's 132 SMs), loads Q and its whole kv
//     span with 16-byte cp.async into shared memory at once, and computes
//     S, an exact softmax (the row's max and sum over the whole row,
//     nothing rescaled) and P V as register micro-tiles (each half-warp RQ
//     = 2 or 1 rows; each lane RQ x KJ scores, then RQ rows x 16-byte
//     chunks of O), so every 16-byte shared read feeds several independent
//     FFMA chains, with one __syncthreads. Longer calls take the tiled
//     form of the same code: 32 rows a CTA, 64-key tiles (32 at Dh > 128)
//     in a two-stage cp.async ring, online softmax. A view that is not
//     16-byte aligned takes the 4-byte-copy instance of the same
//     templates. Scores go to the exp2 domain with scale * log2(e) in one
//     FFMA before ex2, as in bf16. The host side is one ctypes argument
//     (the packed int64s below) and no shared-memory attribute call for
//     the embedder's instance (23 KB).
//   * A value head dim Dv other than the q/k one Dq (MLA: Dq 96 and Dv 64
//     in minicpm3, 192 and 128 in deepseek-v2; a port extension, held
//     against the model layer's jnp attention, which takes a separate Dv).
//     The templates take the q/k width and the v width apart: V has its
//     own tensor map, shared tile and row width, O and the epilogue are
//     sized by Dv, and the scale stays 1 / sqrt(Dq). In bf16 the MLA pairs
//     take flash_bf16_persistent at their exact widths (above); f32 pads
//     each width to a multiple of 64, the zero-filling copies putting zeros
//     past Dq in both Q and K, which add nothing to S. Nothing is padded or
//     sliced in device memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int THREADS = 128;          // f32 kernels

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                 // contiguous (B, Lq, H, Dv), q's dtype
  const int* kv_valid;     // (B,) or null
  int B, Lq, Lkv, H, Hkv, Dq, Dv;     // q/k head dim, v head dim
  long long qsB, qsL, qsH, ksB, ksL, ksH, vsB, vsL, vsH;
  int causal, window, prefix_len, q_offset;   // window <= 0: none
  float scale;
  float* lse;              // null, or the row LSE a training call writes
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
// bf16: warp-specialised TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BQ = 128;                 // q rows a CTA: two consumers of 64
constexpr int WG = 128;                 // threads in a warpgroup
constexpr int FA_THREADS = 3 * WG;      // producer + two consumers
constexpr int STAGES = 2;               // K and V ring depth
constexpr int SLAB = 64;                // bf16 columns of one 128-byte box
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (Dh, heads, positions, batch) into shared
// memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int l,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
         "r"(h), "r"(l), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (Q, K:
// rows of 128 bytes, 8-row groups 1,024 bytes apart) use only the stride
// byte offset; the MN-major V uses the leading byte offset between its
// 64-column slabs too.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16
       | (uint64_t)((sbo & 0x3FFFF) >> 4) << 32
       | 1ull << 62;
}

// Named barriers over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins wgmma operand registers to this point: before wgmma.fence, so that
// no write to them moves below it (ptxas would then fence and serialise the
// wgmma itself), and after the wait, so that no read moves above it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// 2^x on the SFU (relative error about 2^-22; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, f32 accumulate; each accumulator register
// spelled out as an operand (written by the generator these lines came
// from: one specialisation per N the kernel uses).
// S = Q K^T: A and B from shared memory, both K-major; scale-d from acc.
template <int N>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
}

// O += P V: A (P, bf16) from registers, B (V) from shared memory,
// MN-major (trans-b = 1), accumulating.
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float* d, const uint32_t* a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55}"
      ", {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}


// DQ: the q/k width, DV: the v width, each padded to a multiple of 64
template <int DQ, int DV, int BK>
struct Layout {
  static constexpr int SLABS_Q = DQ / SLAB;
  static constexpr int SLABS_V = DV / SLAB;
  static constexpr int Q_HALF = SLABS_Q * 64 * 128;     // one consumer's Q
  static constexpr int Q_BYTES = 2 * Q_HALF;
  static constexpr int K_BYTES = BK * DQ * 2;            // one K tile
  static constexpr int V_BYTES = BK * DV * 2;            // one V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES);
};

// True when the mask allows every (query, key) of rows with positions
// [q_lo, q_hi] and keys [k0, k1): such a tile runs unmasked.
__device__ __forceinline__ bool tile_full(const Args& a, int q_lo, int q_hi,
                                          int k0, int k1, int kvlim) {
  if (k1 > kvlim) return false;
  if (k1 <= a.prefix_len) return true;
  return (!a.causal || k1 - 1 <= q_lo) &&
         (a.window <= 0 || q_hi - k0 < a.window);
}

template <int DQ, int DV, int BK>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Args a) {
  using LY = Layout<DQ, DV, BK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  // 128-byte swizzled boxes need 1,024-byte aligned destinations
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + LY::Q_BYTES;   // [STAGES][SLABS_Q][BK][128 B]
  unsigned char* Vs = Ks + STAGES * LY::K_BYTES;   // [STAGES][SLABS_V]...
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  // heaviest causal q tiles first: the q tile is the slowest grid index
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int row0 = qt * BQ;
  const int kvlim = kv_limit(a, b);
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(row0 + BQ, a.Lq) - 1;
  int k_begin, k_end;
  kv_range(a, q_lo, q_hi, kvlim, &k_begin, &k_end);
  const int n_begin = k_begin / BK, n_end = (k_end + BK - 1) / BK;
  int ntiles = 0;
  for (int n = n_begin; n < n_end; ++n)
    ntiles += !tile_masked(a, q_lo, q_hi, n * BK, n * BK + BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);           // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, LY::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int sl = 0; sl < LY::SLABS_Q; ++sl)
          tma_load(Qs + half * LY::Q_HALF + sl * 64 * 128, &tq, q_full,
                   sl * SLAB, h, row0 + 64 * half, b);
      int it = 0;
      for (int n = n_begin; n < n_end; ++n) {
        const int k0 = n * BK;
        if (tile_masked(a, q_lo, q_hi, k0, k0 + BK)) continue;
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        ++it;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, LY::K_BYTES);
        for (int sl = 0; sl < LY::SLABS_Q; ++sl)
          tma_load(Ks + st * LY::K_BYTES + sl * BK * 128, &tk, k_full + st,
                   sl * SLAB, hk, k0, b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, LY::V_BYTES);
        for (int sl = 0; sl < LY::SLABS_V; ++sl)
          tma_load(Vs + st * LY::V_BYTES + sl * BK * 128, &tv, v_full + st,
                   sl * SLAB, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each, S and P V on wgmma ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / WG - 1;
    const int tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int rl0 = 64 * cw + 16 * warp + g;          // row in the q tile
    const int qp0 = a.q_offset + row0 + rl0, qp1 = qp0 + 8;
    const int wq_lo = a.q_offset + row0 + 64 * cw;
    const int wq_hi = a.q_offset + min(row0 + 64 * cw + 64, a.Lq) - 1;
    const float sl2 = a.scale * LOG2E;                // exp2 domain
    const uint32_t q_addr = smem_u32(Qs + cw * LY::Q_HALF);
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[BK / 2];
    uint32_t pf[BK / 16][4];                          // P, bf16 A fragments
    // The kv tiles this CTA takes, in order: n_begin .. n_end, less the
    // wholly masked ones.
    auto next_tile = [&](int n) {
      while (n < n_end && tile_masked(a, q_lo, q_hi, n * BK, n * BK + BK)) ++n;
      return n;
    };
    // S = Q K^T (64 x BK), both operands in shared memory
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = smem_u32(Ks + st * LY::K_BYTES);
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;           // 16 columns a k-step
        wgmma_ss<BK>(s,
                     desc_sw128(q_addr + (kk / 4) * 64 * 128 + off, 16, 1024),
                     desc_sw128(k_addr + (kk / 4) * BK * 128 + off, 16, 1024),
                     kk > 0);
      }
    };
    // O += P V: P from registers, V (keys x Dv) read MN-major
    auto gemm_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(Vs + st * LY::V_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DV>(o, pf[kk],
                     desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024));
    };
    // S to P for the tile at k0: scale into the exp2 domain, mask (edge
    // tiles only), online softmax (a quad shares a row), rescale O, round
    // P to bf16 in the A-fragment layout of m64nNk16
    auto softmax = [&](int k0) {
      const bool full = tile_full(a, wq_lo, wq_hi, k0, k0 + BK, kvlim);
      float mt[2] = {-INFINITY, -INFINITY};          // raw scores' max
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int kp = k0 + 8 * i + 2 * t + (e & 1);
            if (!allowed(a, e < 2 ? qp0 : qp1, kp, kvlim))
              s[4 * i + e] = -INFINITY;
          }
          mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * i + e]);
        }
      }
      float alpha[2], safe[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float mn = fmaxf(m[r], mt[r] * sl2);    // exp2 domain
        safe[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = ex2(m[r] - safe[r]);                // 0 while m is -inf
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(fmaf(s[i], sl2, -safe[(i >> 1) & 1]));
        s[i] = p;
        ls[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
        l[r] = alpha[r] * l[r] + ls[r];
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // The two consumers take the tensor cores in turn (named barriers 1
    // and 2), consumer 0 first: one turn issues P V of the previous tile
    // and S of this one, so that one consumer's softmax runs under the
    // other's products. Every wgmma sequence is straight-line code (the
    // first tile is peeled), which lets ptxas keep them in flight together.
    if (cw == 1 && ntiles > 0) bar_arrive(1);
    mbar_wait(q_full, 0);
    if (ntiles > 0) {
      int n = next_tile(n_begin);
      mbar_wait(k_full, 0);
      bar_sync(1 + cw);
      keep(s);
      wgmma_fence();
      gemm_s(0);
      wgmma_commit();
      if (!(cw == 1 && ntiles == 1)) bar_arrive(2 - cw);
      wgmma_wait0();
      keep(s);
      if (lane == 0) mbar_arrive(k_empty);
      softmax(n * BK);
      for (int it = 1; it < ntiles; ++it) {
        n = next_tile(n + 1);
        const int st = it % STAGES, pst = (it - 1) % STAGES;
        const uint32_t ph = (it / STAGES) & 1, pph = ((it - 1) / STAGES) & 1;
        mbar_wait(k_full + st, ph);
        mbar_wait(v_full + pst, pph);
        bar_sync(1 + cw);
        keep(o);
        keep(s);
        keep(pf);
        wgmma_fence();
        gemm_pv(pst);
        gemm_s(st);
        wgmma_commit();
        if (!(cw == 1 && it == ntiles - 1)) bar_arrive(2 - cw);
        wgmma_wait0();
        keep(o);
        keep(s);
        if (lane == 0) {
          mbar_arrive(k_empty + st);
          mbar_arrive(v_empty + pst);
        }
        softmax(n * BK);
      }
      const int pst = (ntiles - 1) % STAGES;           // the last tile's P V
      mbar_wait(v_full + pst, ((ntiles - 1) / STAGES) & 1);
      keep(o);
      keep(pf);
      wgmma_fence();
      gemm_pv(pst);
      wgmma_commit();
      wgmma_wait0();
      keep(o);
      if (lane == 0) mbar_arrive(v_empty + pst);
    }

    // out = O / l (0 for a fully masked row); nothing past Lq or Dv
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + rl0 + 8 * r;
      if (row >= a.Lq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* orow =
          out + (((long long)b * a.Lq + row) * a.H + h) * a.Dv;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        const int d = 8 * i + 2 * t;
        if (d < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
              o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
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

// A (B, L, Hn, Dh) bf16 tensor read in place as a 4-D map (Dh, Hn, L, B)
// with byte strides; boxes of 64 columns x ``rows`` positions, 128-byte
// swizzle, zero fill past the tensor's extent.
static bool encode_map(CUtensorMap* map, const void* ptr, int Dh, int Hn,
                       int L, int B, long long sH, long long sL,
                       long long sB, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  // an empty kv range still needs a valid map; the kernel loads nothing
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)Hn,
                              (cuuint64_t)(L > 0 ? L : 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sH * 2, (cuuint64_t)sL * 2,
                                 (cuuint64_t)sB * 2};
  const cuuint32_t box[4] = {SLAB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV, int BK>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  alignas(64) CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, a.q, a.Dq, a.H, a.Lq, a.B, a.qsH, a.qsL, a.qsB, 64) ||
      !encode_map(&tk, a.k, a.Dq, a.Hkv, a.Lkv, a.B, a.ksH, a.ksL, a.ksB,
                  BK) ||
      !encode_map(&tv, a.v, a.Dv, a.Hkv, a.Lkv, a.B, a.vsH, a.vsL, a.vsB,
                  BK))
    return cudaErrorInvalidValue;
  const int smem = Layout<DQ, DV, BK>::SMEM;
  static bool raised[64] = {};           // per device: once, not on every
  int dev = 0;                           // call
  cudaGetDevice(&dev);
  if (!raised[dev & 63]) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16<DQ, DV, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    raised[dev & 63] = true;
  }
  dim3 grid(a.H, a.B, (a.Lq + BQ - 1) / BQ);
  flash_bf16<DQ, DV, BK><<<grid, FA_THREADS, smem, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at exact widths: persistent, products under the softmax
// ---------------------------------------------------------------------------

// DQ, DV: the q/k and v widths the products take (multiples of 16 and 8);
// BK: keys a kv tile. Q/K and V/O live in 128-byte swizzled 64-column slabs,
// the last one zero-filled by TMA past the width. Two Q buffers (the next
// tile's Q lands while this one runs; each consumer's half doubles as its
// O staging for the TMA store) and a K/V ring of as many stages (2 or 3)
// as the rest of the 227 KB holds.
template <int DQ, int DV, int BK>
struct PCfg {
  static constexpr int SQ = (DQ + SLAB - 1) / SLAB;
  static constexpr int SV = (DV + SLAB - 1) / SLAB;
  static constexpr int KSTEPS = (DQ + 15) / 16;       // S's k-steps
  static constexpr int Q_HALF = SQ * 64 * 128;         // one consumer's rows
  static constexpr int Q_BYTES = 2 * Q_HALF;
  static constexpr int K_BYTES = BK * SQ * 128;
  static constexpr int V_BYTES = BK * SV * 128;
  static constexpr int ROOM = 232448 - 1024 - 512 - 2 * Q_BYTES;
  static constexpr int STAGES = ROOM / (K_BYTES + V_BYTES) >= 3 ? 3 : 2;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static_assert(DQ % 16 == 0 && DV % 8 == 0 && SV <= SQ, "widths");
  static_assert(ROOM >= 2 * (K_BYTES + V_BYTES), "shared memory");
};

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Named barrier over one consumer warpgroup (128 threads).
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// One 64-column box of shared memory to a 4-D tensor map (the output);
// TMA clips what lies past the tensor's extent.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int d, int h,
                                          int l, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(d),
         "r"(h), "r"(l), "r"(b)
      : "memory");
}

// A q tile of one (sequence, head): its rows, kv limit and live kv tiles.
struct PTile {
  int b, h, hk, row0, q_lo, q_hi, kvlim, n_begin, n_end, ntiles;
};

template <int BK>
__device__ __forceinline__ PTile p_tile(const Args& a, int bh, int qt) {
  PTile t;
  t.b = bh / a.H;
  t.h = bh % a.H;
  t.hk = t.h / (a.H / a.Hkv);
  t.row0 = qt * BQ;
  t.kvlim = kv_limit(a, t.b);
  t.q_lo = a.q_offset + t.row0;
  t.q_hi = a.q_offset + min(t.row0 + BQ, a.Lq) - 1;
  int k_begin, k_end;
  kv_range(a, t.q_lo, t.q_hi, t.kvlim, &k_begin, &k_end);
  t.n_begin = k_begin / BK;
  t.n_end = (k_end + BK - 1) / BK;
  t.ntiles = 0;
  for (int n = t.n_begin; n < t.n_end; ++n)
    t.ntiles += !tile_masked(a, t.q_lo, t.q_hi, n * BK, n * BK + BK);
  return t;
}

// The static tile order: unit u is (sequence, head) u / NP with the pair of
// q tiles NQ - 1 - i and i (i = u % NP; the longer first; the middle one
// alone when NQ is odd), so a causal unit holds NQ + 1 kv tiles whatever
// i is. CTA c takes units c, c + grid, ...: the CTAs in flight hold about
// grid / NP consecutive heads, whose K and V stay in L2. Sets T to the
// CTA's next q tile (k counts them); false past the last.
template <int BK>
__device__ __forceinline__ bool next_q_tile(const Args& a, int& k,
                                            PTile& T) {
  const int nq = (a.Lq + BQ - 1) / BQ, np = (nq + 1) / 2;
  for (;; ++k) {
    const int u = blockIdx.x + (k >> 1) * gridDim.x;
    if (u >= a.B * a.H * np) return false;
    const int i = u % np;
    if ((k & 1) && i >= nq - 1 - i) continue;
    T = p_tile<BK>(a, u / np, k & 1 ? i : nq - 1 - i);
    ++k;
    return true;
  }
}

// LSE: also each row's log-sum-exp into a.lse (flash_bf16_persistent_lse,
// a training call's), an instance of its own, so that the serving kernel
// is compiled as it was: with the arguments by reference its SASS is the
// kernel's before the write (tools/sass_diff.py)
template <int DQ, int DV, int BK, bool LSE>
__device__ __forceinline__ void persistent_body(const CUtensorMap& tq,
                                                const CUtensorMap& tk,
                                                const CUtensorMap& tv,
                                                const CUtensorMap& to,
                                                const Args& a) {
  using C = PCfg<DQ, DV, BK>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 + 4 * ST];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + 2 * C::Q_BYTES;      // [ST][SQ][BK][128 B]
  unsigned char* Vs = Ks + ST * C::K_BYTES;     // [ST][SV][BK][128 B]
  uint64_t* q_full = bars;                      // [2]
  uint64_t* q_empty = bars + 2;                 // [2]
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2);          // one thread a consumer
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);          // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int it = 0, qi = 0;
    PTile T;
    for (int k = 0; next_q_tile<BK>(a, k, T);) {
      const int qb = qi & 1;
      mbar_wait(q_empty + qb, ((qi >> 1) & 1) ^ 1);
      ++qi;
      mbar_expect_tx(q_full + qb, C::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int sl = 0; sl < C::SQ; ++sl)
          tma_load(Qs + qb * C::Q_BYTES + half * C::Q_HALF + sl * 64 * 128,
                   &tq, q_full + qb, sl * SLAB, T.h, T.row0 + 64 * half, T.b);
      for (int n = T.n_begin; n < T.n_end; ++n) {
        const int k0 = n * BK;
        if (tile_masked(a, T.q_lo, T.q_hi, k0, k0 + BK)) continue;
        const int st = it % ST;
        const uint32_t ph = (it / ST) & 1;
        ++it;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, C::K_BYTES);
        for (int sl = 0; sl < C::SQ; ++sl)
          tma_load(Ks + st * C::K_BYTES + sl * BK * 128, &tk, k_full + st,
                   sl * SLAB, T.hk, k0, T.b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, C::V_BYTES);
        for (int sl = 0; sl < C::SV; ++sl)
          tma_load(Vs + st * C::V_BYTES + sl * BK * 128, &tv, v_full + st,
                   sl * SLAB, T.hk, k0, T.b);
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each, S and P V on wgmma ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / WG - 1;
  const int tid = threadIdx.x % WG;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                     // row in the half
  const float sl2 = a.scale * LOG2E;                // exp2 domain
  float o[DV / 2];
  float s[BK / 2];
  uint32_t pf[BK / 16][4];                          // P, bf16 A fragments
  float m[2], l[2];

  // The two consumers take the tensor cores in turn (named barriers 1 and
  // 2), consumer 0 first, over every kv tile of every q tile of the CTA:
  // count the turns, so that consumer 1 leaves no arrival behind its last.
  int turns = 0;
  PTile T;
  for (int k = 0; next_q_tile<BK>(a, k, T);) turns += T.ntiles;
  if (cw == 1 && turns > 0) bar_arrive(1);
  int turn = 0, it = 0, qi = 0, pend = -1;

  // the O store of the previous q tile (buffer pend) has been read out of
  // shared memory: its Q buffer may take a later tile's Q
  auto release_pending = [&]() {
    if (pend >= 0) {
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty + pend);
      }
      pend = -1;
    }
  };

  for (int k = 0; next_q_tile<BK>(a, k, T);) {
    const int qb = qi & 1;
    const uint32_t qph = (qi >> 1) & 1;
    ++qi;
    unsigned char* qh = Qs + qb * C::Q_BYTES + cw * C::Q_HALF;
    const uint32_t q_addr = smem_u32(qh);
    const int qp0 = a.q_offset + T.row0 + 64 * cw + rl, qp1 = qp0 + 8;
    const int wq_lo = a.q_offset + T.row0 + 64 * cw;
    const int wq_hi = a.q_offset + min(T.row0 + 64 * cw + 64, a.Lq) - 1;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    auto next_tile = [&](int n) {
      while (n < T.n_end && tile_masked(a, T.q_lo, T.q_hi, n * BK, n * BK + BK))
        ++n;
      return n;
    };
    // S = Q K^T (64 x BK) over the exact width: ceil(DQ / 16) k-steps
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = smem_u32(Ks + st * C::K_BYTES);
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32;           // 16 columns a k-step
        wgmma_ss<BK>(s,
                     desc_sw128(q_addr + (kk / 4) * 64 * 128 + off, 16, 1024),
                     desc_sw128(k_addr + (kk / 4) * BK * 128 + off, 16, 1024),
                     kk > 0);
      }
    };
    // O += P V at N = DV: P from registers, V (keys x Dv) read MN-major
    auto gemm_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(Vs + st * C::V_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DV>(o, pf[kk],
                     desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024));
    };
    // S to P for the tile at k0: the mask (edge tiles only, as per-row
    // bounds: one branch a tile, none an element), online softmax in the
    // exp2 domain (a quad shares a row; four partial maxima and sums a row,
    // so the reductions are not one chain); O's factor in alpha. P stays
    // f32 in s until the previous P V has retired.
    auto softmax = [&](int k0, float (&alpha)[2]) {
      if (!tile_full(a, wq_lo, wq_hi, k0, k0 + BK, T.kvlim)) {
        // key kp is seen when lo <= kp < hi, or kp < pre (allowed())
        const int pre = min(a.prefix_len, T.kvlim);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r ? qp1 : qp0;
          const int lo = a.window > 0 ? qp - a.window + 1 : INT_MIN;
          const int hi = a.causal ? min(T.kvlim, qp + 1) : T.kvlim;
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * i + 2 * t + c;
              const bool ok = (kp >= lo && kp < hi) || kp < pre;
              s[4 * i + 2 * r + c] = ok ? s[4 * i + 2 * r + c] : -INFINITY;
            }
        }
      }
      float mx[2][4], ls[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mx[r][j] = -INFINITY;
          ls[r][j] = 0.f;
        }
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1][2 * (i & 1) + (e & 1)] =
              fmaxf(mx[e >> 1][2 * (i & 1) + (e & 1)], s[4 * i + e]);
      float safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(m[r], mt * sl2);
        safe[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = ex2(m[r] - safe[r]);                // 0 while m is -inf
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = ex2(fmaf(s[i], sl2, -safe[(i >> 1) & 1]));
        ls[(i >> 1) & 1][(i >> 2) & 3] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        l[r] = alpha[r] * l[r] + lt;
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    mbar_wait(q_full + qb, qph);
    if (T.ntiles > 0) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      // first kv tile: S alone
      int n = next_tile(T.n_begin);
      int st = it % ST;
      mbar_wait(k_full + st, (it / ST) & 1);
      bar_sync(1 + cw);
      keep(s);
      wgmma_fence();
      gemm_s(st);
      wgmma_commit();
      if (!(cw == 1 && turn == turns - 1)) bar_arrive(2 - cw);
      ++turn;
      wgmma_wait0();
      keep(s);
      if (lane == 0) mbar_arrive(k_empty + st);
      release_pending();
      float alpha[2];
      softmax(n * BK, alpha);
      pack();
      int pst = st;
      ++it;
      // S(j) and P V(j - 1) in one turn; the softmax of j runs under P V(j
      // - 1) (wait_group 1 retires S alone), then O is rescaled once P V
      // has retired
      for (int j = 1; j < T.ntiles; ++j) {
        n = next_tile(n + 1);
        st = it % ST;
        mbar_wait(k_full + st, (it / ST) & 1);
        mbar_wait(v_full + pst, ((it - 1) / ST) & 1);
        bar_sync(1 + cw);
        keep(o);
        keep(s);
        keep(pf);
        wgmma_fence();
        gemm_s(st);
        wgmma_commit();
        gemm_pv(pst);
        wgmma_commit();
        if (!(cw == 1 && turn == turns - 1)) bar_arrive(2 - cw);
        ++turn;
        wgmma_wait1();
        keep(s);
        if (lane == 0) mbar_arrive(k_empty + st);
        softmax(n * BK, alpha);
        wgmma_wait0();
        keep(o);
        keep(pf);
        if (lane == 0) mbar_arrive(v_empty + pst);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack();
        pst = st;
        ++it;
      }
      mbar_wait(v_full + pst, ((it - 1) / ST) & 1);   // the last P V
      keep(o);
      keep(pf);
      wgmma_fence();
      gemm_pv(pst);
      wgmma_commit();
      wgmma_wait0();
      keep(o);
      if (lane == 0) mbar_arrive(v_empty + pst);
    }
    release_pending();

    // out = O / l (0 for a row that sees no key), bf16, into this
    // consumer's half of the Q buffer (its Q is spent) in the swizzled
    // layout of the output's tensor map; one thread stores it by TMA,
    // which clips rows past Lq and columns past Dv
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        const uint32_t v = l[r] > 0.f ? pack_bf16(o[4 * i + 2 * r] * inv,
                                                  o[4 * i + 2 * r + 1] * inv)
                                      : 0u;
        *reinterpret_cast<uint32_t*>(qh + (i / 8) * 64 * 128 + row * 128 +
                                     (((i % 8) ^ (row & 7)) << 4) + 4 * t) = v;
      }
    }
    if constexpr (LSE) {
      // the backward's LSE (flash_attention_bwd.cu's scratch, (B, H, Lq
      // rounded up to 64)): log2 units with the scale folded, m + log2(l),
      // +inf where a row sees no key or lies past Lq
      const int Lqp = (a.Lq + 63) / 64 * 64;
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = T.row0 + 64 * cw + rl + 8 * r;
          if (row < Lqp)
            a.lse[((size_t)T.b * a.H + T.h) * Lqp + row] =
                row < a.Lq && l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync_wg(3 + cw);
    if (tid == 0) {
      for (int sl = 0; sl < C::SV; ++sl)
        tma_store(&to, qh + sl * 64 * 128, sl * SLAB, T.h,
                  T.row0 + 64 * cw, T.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    pend = qb;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DQ, int DV, int BK>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_bf16_persistent(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, const Args a) {
  persistent_body<DQ, DV, BK, false>(tq, tk, tv, to, a);
}

// training calls: the same O, and each row's LSE into a.lse
template <int DQ, int DV, int BK>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_bf16_persistent_lse(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          const Args a) {
  persistent_body<DQ, DV, BK, true>(tq, tk, tv, to, a);
}

// the instance a call takes: with the LSE write or without (no other
// width's _lse instance is compiled)
template <int DQ, int DV, int BK, bool LSE>
static auto persistent_kernel() {
  if constexpr (LSE)
    return flash_bf16_persistent_lse<DQ, DV, BK>;
  else
    return flash_bf16_persistent<DQ, DV, BK>;
}

template <int DQ, int DV, int BK, bool LSE = false>
cudaError_t launch_persistent(const Args& a, cudaStream_t s) {
  using C = PCfg<DQ, DV, BK>;
  const auto kern = persistent_kernel<DQ, DV, BK, LSE>();
  alignas(64) CUtensorMap tq, tk, tv, to;
  const long long so = a.Dv;                     // o contiguous
  if (!encode_map(&tq, a.q, a.Dq, a.H, a.Lq, a.B, a.qsH, a.qsL, a.qsB, 64) ||
      !encode_map(&tk, a.k, a.Dq, a.Hkv, a.Lkv, a.B, a.ksH, a.ksL, a.ksB,
                  BK) ||
      !encode_map(&tv, a.v, a.Dv, a.Hkv, a.Lkv, a.B, a.vsH, a.vsL, a.vsB,
                  BK) ||
      !encode_map(&to, a.o, a.Dv, a.H, a.Lq, a.B, so, so * a.H,
                  so * a.H * a.Lq, 64))
    return cudaErrorInvalidValue;
  static bool raised[64] = {};           // per device: once, not on every
  static int sms[64] = {};               // call
  int dev = 0;
  cudaGetDevice(&dev);
  if (!raised[dev & 63]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev & 63],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    raised[dev & 63] = true;
  }
  const long long nq = (a.Lq + BQ - 1) / BQ;
  const long long units = (long long)a.B * a.H * ((nq + 1) / 2);
  const int grid = (int)(units < sms[dev & 63] ? units : sms[dev & 63]);
  kern<<<grid, FA_THREADS, C::SMEM, s>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, no TF32
// ---------------------------------------------------------------------------

// A CTA of 4 warps takes BQ = 8 * RQ query rows of one (sequence, head):
// each half-warp owns RQ consecutive rows. In S = Q K^T lane tl of a
// half-warp holds the RQ x KJ micro-tile of keys tl + 16 j, so one 16-byte
// read of Q (a broadcast across the half-warp) and one of K feed 4 RQ KJ
// FFMAs; the row's max and sum are reduced over the half-warp by shuffles.
// P goes to shared memory (read back only by the same half-warp) and, in
// O = P V, lane tl holds the RQ rows x 16-byte column chunks tl + 16 c.
// K is stored with its 16-byte chunks XOR-swizzled by the row, so the 8
// lanes of a quarter-warp that read 8 keys' same chunk hit 8 distinct
// bank groups; Q, P and V reads are broadcasts or consecutive chunks and
// need no swizzle. DQ: the q/k width, DV: the v width (each padded).
template <int DQ, int DV, int RQ, int BK, bool ONE_PASS>
struct F32Cfg {
  static constexpr int BQ = 8 * RQ;
  static constexpr int KJ = BK / 16;         // keys a lane in S
  static constexpr int NC = DV / 64;         // 16-byte chunks a lane in O
  static constexpr int PS = BK + 16 / RQ;    // P row stride: the two
                                             // half-warps' stores apart
  static constexpr int NST = ONE_PASS ? 1 : 2;   // K/V stages
  static constexpr int KV = BK * (DQ + DV);  // a stage's K and V tiles
  static constexpr int SMEM = 4 * (BQ * DQ + BQ * PS + NST * KV);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, rows) of a [rows][DP] shared tile from global rows src + r *
// stride: rows past nvalid and columns past Dh are zero-filled (cp.async
// with a source size of 0 reads nothing). VEC: 16-byte copies (16-byte
// aligned base and strides, Dh % 4 == 0); else 4-byte ones. SWZ: chunk c
// of row r lands at chunk c ^ (r & 7).
template <int DP, bool VEC, bool SWZ>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int rows,
                                          int nvalid, int Dh,
                                          const void* safe) {
  if constexpr (VEC) {
    constexpr int CH = DP / 4;
    for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = r < nvalid && 4 * c < Dh;
      cp_async16(dst + r * DP + ((SWZ ? c ^ (r & 7) : c) << 2),
                 in ? src + r * stride + 4 * c : safe, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      const bool in = r < nvalid && d < Dh;
      const int c = d >> 2;
      cp_async4(dst + r * DP + ((SWZ ? c ^ (r & 7) : c) << 2) + (d & 3),
                in ? src + r * stride + d : safe, in ? 4 : 0);
    }
  }
}

// One kv tile of a half-warp's RQ rows: keys k0 .. k0 + n - 1 at shared
// rows 0 .. n - 1 of Ks/Vs (rows of DQ and DV floats; V zero up to a
// multiple of 4). Computes S,
// masks it (unless full), takes the rows' max and sum in the exp2 domain
// and adds P V into o. ONE_PASS: the tile is the whole row, so m starts at
// -inf and nothing is rescaled; else the running m, l and o are rescaled.
template <int DQ, int DV, int RQ, int BK, bool ONE_PASS>
__device__ __forceinline__ void f32_tile(
    const Args& a, const float* Qs, const float* Ks, const float* Vs,
    float* Ps, int rg, int tl, int qpos0, int k0, int n, int kvlim,
    bool full, float sl2, float (&o)[RQ][DV / 64][4], float (&m)[RQ],
    float (&l)[RQ]) {
  using C = F32Cfg<DQ, DV, RQ, BK, ONE_PASS>;
  constexpr int KJ = C::KJ, NC = C::NC;
  float s[RQ][KJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  const float* qrow = Qs + rg * RQ * DQ;
#pragma unroll
  for (int lo = 0; lo < 8; ++lo) {
    const float* kp = Ks + tl * DQ + ((lo ^ (tl & 7)) << 2);
    const float* qp = qrow + (lo << 2);
#pragma unroll
    for (int hi = 0; hi < DQ / 32; ++hi) {
      float4 qv[RQ], kv[KJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qp + i * DQ + hi * 32);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kp + j * 16 * DQ + hi * 32);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
  }
  // the mask as per-row bounds: key kp is seen when lo_b <= kp < hi_b, or
  // when it is a prefix key (kp < pre); keys at or past the tile's n lie at
  // or past the CTA's kv end, which every row's hi_b or pre excludes
  const int pre = min(a.prefix_len, kvlim);
  float mx[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = qpos0 + i;
    const int lo_b = a.window > 0 ? qp - a.window + 1 : INT_MIN;
    const int hi_b = a.causal ? min(kvlim, qp + 1) : kvlim;
    mx[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kp = k0 + tl + 16 * j;
      const bool ok = full || (kp >= lo_b && kp < hi_b) || kp < pre;
      s[i][j] = ok ? s[i][j] : -INFINITY;
      mx[i] = fmaxf(mx[i], s[i][j]);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
  float sum[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float mn = ONE_PASS ? mx[i] : fmaxf(m[i], mx[i]);
    const float neg = mn == -INFINITY ? 0.f : -mn * sl2;   // 0: all masked
    if (!ONE_PASS) {
      const float alpha = ex2(fmaf(m[i], sl2, neg));      // 0 while m = -inf
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
    }
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const float p = ex2(fmaf(s[i][j], sl2, neg));       // masked: 0
      sum[i] += p;
      Ps[(rg * RQ + i) * C::PS + tl + 16 * j] = p;
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
#pragma unroll
  for (int i = 0; i < RQ; ++i) l[i] += sum[i];
  __syncwarp();
  // O += P V over the tile's keys, four at a time
  const float* prow = Ps + rg * RQ * C::PS;
#pragma unroll
  for (int g = 0; g < BK / 4; ++g) {
    if (4 * g >= n) break;
    float4 p4[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      p4[i] = *reinterpret_cast<const float4*>(prow + i * C::PS + 4 * g);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + (4 * g + kk) * DV + (tl + 16 * c) * 4);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float p = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y
                        : kk == 2 ? p4[i].z : p4[i].w;
          o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
          o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
          o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
          o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
        }
      }
    }
  }
}

// grid (q tiles, H, B), 128 threads. ONE_PASS: the CTA's whole kv span
// (at most BK keys; the host sends only Lkv <= BK here) is loaded at once
// and the softmax is exact in one pass. Else kv tiles of BK keys stream
// through a two-stage cp.async ring under an online softmax.
template <int DQ, int DV, int RQ, int BK, bool VEC, bool ONE_PASS>
__global__ void __launch_bounds__(THREADS)
flash_f32(Args a) {
  using C = F32Cfg<DQ, DV, RQ, BK, ONE_PASS>;
  constexpr int NC = C::NC;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                              // [BQ][DQ]
  float* Ps = Qs + C::BQ * DQ;                  // [BQ][PS]
  float* KV = Ps + C::BQ * C::PS;   // NST x {K [BK][DQ], V [BK][DV]}
  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl = lane & 15, rg = warp * 2 + (lane >> 4);
  const int row0 = qt * C::BQ;
  const int kvlim = kv_limit(a, b);
  const float* q = static_cast<const float*>(a.q) + b * a.qsB + h * a.qsH +
                   row0 * a.qsL;
  const float* k = static_cast<const float*>(a.k) + b * a.ksB + hk * a.ksH;
  const float* v = static_cast<const float*>(a.v) + b * a.vsB + hk * a.vsH;
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(row0 + C::BQ, a.Lq) - 1;
  int k_begin, k_end;
  kv_range(a, q_lo, q_hi, kvlim, &k_begin, &k_end);
  // the warp's rows, for its own skip and mask decisions
  const int wrow0 = row0 + warp * 2 * RQ;
  const bool active = wrow0 < a.Lq;
  const int wq_lo = a.q_offset + wrow0;
  const int wq_hi = a.q_offset + min(wrow0 + 2 * RQ, a.Lq) - 1;
  const int qpos0 = a.q_offset + row0 + rg * RQ;
  const float sl2 = a.scale * LOG2E;              // exp2 domain

  float o[RQ][NC][4], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }
  load_rows<DQ, VEC, false>(Qs, q, a.qsL, C::BQ, a.Lq - row0, a.Dq, a.q);
  if constexpr (ONE_PASS) {
    const int nk = max(k_end - k_begin, 0), nk4 = (nk + 3) & ~3;
    load_rows<DQ, VEC, true>(KV, k + k_begin * a.ksL, a.ksL, nk4, nk, a.Dq,
                             a.k);
    load_rows<DV, VEC, false>(KV + BK * DQ, v + k_begin * a.vsL, a.vsL, nk4,
                              nk, a.Dv, a.v);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) return;
    f32_tile<DQ, DV, RQ, BK, true>(a, Qs, KV, KV + BK * DQ, Ps, rg, tl,
                                   qpos0, k_begin, nk, kvlim, false, sl2, o,
                                   m, l);
  } else {
    auto next = [&](int k0) {      // the next tile that holds a seen key
      while (k0 < k_end && tile_masked(a, q_lo, q_hi, k0, k0 + BK)) k0 += BK;
      return k0;
    };
    auto load_kv = [&](int st, int k0) {
      const int n = min(BK, k_end - k0), n4 = (n + 3) & ~3;
      float* Ks = KV + st * C::KV;
      load_rows<DQ, VEC, true>(Ks, k + k0 * a.ksL, a.ksL, n4, n, a.Dq, a.k);
      load_rows<DV, VEC, false>(Ks + BK * DQ, v + k0 * a.vsL, a.vsL, n4, n,
                                a.Dv, a.v);
    };
    int k0 = next(k_begin), st = 0;
    if (k0 < k_end) load_kv(0, k0);
    cp_async_commit();
    while (k0 < k_end) {
      const int kn = next(k0 + BK);
      if (kn < k_end) load_kv(st ^ 1, kn);
      cp_async_commit();
      cp_async_wait<1>();                 // this tile (and Q) have landed
      __syncthreads();
      if (active) {
        const float* Ks = KV + st * C::KV;
        f32_tile<DQ, DV, RQ, BK, false>(
            a, Qs, Ks, Ks + BK * DQ, Ps, rg, tl, qpos0, k0,
            min(BK, k_end - k0), kvlim,
            tile_full(a, wq_lo, wq_hi, k0, k0 + BK, kvlim), sl2, o, m, l);
      }
      __syncthreads();                    // the stage is refilled next
      st ^= 1;
      k0 = kn;
    }
    cp_async_wait<0>();
    if (!active) return;
  }
  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = row0 + rg * RQ + i;
    if (row >= a.Lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // fully masked: 0
    float* orow = out + (((long long)b * a.Lq + row) * a.H + h) * a.Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = (tl + 16 * c) * 4;
      if (d0 >= a.Dv) continue;
      const float4 r = make_float4(o[i][c][0] * inv, o[i][c][1] * inv,
                                   o[i][c][2] * inv, o[i][c][3] * inv);
      if (VEC) {
        *reinterpret_cast<float4*>(orow + d0) = r;
      } else {
        const float rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < a.Dv) orow[d0 + e] = rr[e];
      }
    }
  }
}

template <int DQ, int DV, int RQ, int BK, bool VEC, bool ONE_PASS>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  using C = F32Cfg<DQ, DV, RQ, BK, ONE_PASS>;
  if constexpr (C::SMEM > 48 * 1024) {   // raised once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (!raised[dev & 63]) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_f32<DQ, DV, RQ, BK, VEC, ONE_PASS>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
      if (e != cudaSuccess) return e;
      raised[dev & 63] = true;
    }
  }
  dim3 grid((unsigned)((a.Lq + C::BQ - 1) / C::BQ), (unsigned)a.H,
            (unsigned)a.B);
  flash_f32<DQ, DV, RQ, BK, VEC, ONE_PASS><<<grid, THREADS, C::SMEM, s>>>(
      a);
  return cudaGetLastError();
}

// Lkv <= 128 (<= 64 at Dh > 128) takes the one-pass kernel with the
// smallest kv width that holds it; 2 rows a half-warp, or 1 where the grid
// would otherwise hold fewer CTAs than the card has SMs (the embedder's
// one-answer call: more CTAs, each with half the chain). The
// 4-byte-copy instance has one width and 2 rows. Longer calls take the
// tiled kernel.
constexpr int H100_SMS = 132;

template <int DP, int RQ, bool VEC>
cudaError_t one_pass_f32(const Args& a, cudaStream_t s) {
  constexpr int ONE_MAX = DP > 128 ? 64 : 128;
  if (a.Lkv <= 32) return launch_f32<DP, DP, RQ, 32, VEC, true>(a, s);
  if (ONE_MAX == 64 || a.Lkv <= 64)
    return launch_f32<DP, DP, RQ, 64, VEC, true>(a, s);
  return launch_f32<DP, DP, RQ, ONE_MAX, VEC, true>(a, s);
}

template <int DP, bool VEC>
cudaError_t dispatch_f32(const Args& a, cudaStream_t s) {
  constexpr int ONE_MAX = DP > 128 ? 64 : 128;
  if (a.Lkv > ONE_MAX)
    return launch_f32<DP, DP, 4, (DP > 128 ? 32 : 64), VEC, false>(a, s);
  if (!VEC) return launch_f32<DP, DP, 2, ONE_MAX, false, true>(a, s);
  if ((long long)((a.Lq + 7) / 8) * a.H * a.B <= H100_SMS)
    return one_pass_f32<DP, 1, true>(a, s);
  return one_pass_f32<DP, 2, true>(a, s);
}

// The padded widths of the pairs the kernels take: Dq and Dv each to 64, 128
// or 256 when they pad alike; else the two MLA classes, Dq <= 128 with Dv <=
// 64 and Dq <= 192 with Dv <= 128. 0 when no instance takes (Dq, Dv).
inline int pad_dh(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }
inline int dq_instance(int Dq, int Dv) {
  const int pq = pad_dh(Dq), pv = pad_dh(Dv);
  if (pq == pv) return pq;
  if (pq == 128 && pv == 64) return 128;
  if (pv == 128 && Dq <= 192) return 192;
  return 0;
}

// f32: the pairs with Dq != Dv take the tiled kernel at any Lkv
template <bool VEC>
cudaError_t dispatch_f32(const Args& a, cudaStream_t s) {
  const int pq = dq_instance(a.Dq, a.Dv), pv = pad_dh(a.Dv);
  if (pq == 0) return cudaErrorInvalidValue;
  if (pq == pv) {
    if (pq == 64) return dispatch_f32<64, VEC>(a, s);
    if (pq == 128) return dispatch_f32<128, VEC>(a, s);
    return dispatch_f32<256, VEC>(a, s);
  }
  if (pq == 128) return launch_f32<128, 64, 4, 64, VEC, false>(a, s);
  return launch_f32<192, 128, 4, 32, VEC, false>(a, s);
}

// 16-byte copies need a 16-byte aligned base and B/L/H strides (of dims
// longer than 1) that are multiples of 4 elements.
inline bool f32_aligned(const void* p, long long sB, long long sL,
                        long long sH, long long B, long long L, long long H) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (B == 1 || sB % 4 == 0) && (L == 1 || sL % 4 == 0) &&
         (H == 1 || sH % 4 == 0);
}

}  // namespace fa

// The arguments come packed as 30 int64 (one ctypes argument instead of 28:
// converting each costs the host more than the launch itself):
//   [0..4]   q, k, v, o, kv_valid (pointers; kv_valid 0 for none)
//   [5..11]  B, Lq, Lkv, H, Hkv, Dq, Dv
//   [12..23] the element strides of q, k, v, four each (B, L, H, head dim)
//   [24..28] causal, window, prefix_len, q_offset, is_bf16
//   [29]     lse (pointer, 0 for none): a training call's (B, H, Lq rounded
//            up to 64) f32 row LSE, bf16 at Dq in (64, 96] with Dv <= 64
//            alone (the backward's exact-width pair reads it)
// q (B, Lq, H, Dq), k (B, Lkv, Hkv, Dq), v (B, Lkv, Hkv, Dv), each with unit
// stride in its head dim and the given strides for B, L, H; o contiguous
// (B, Lq, H, Dv) of q's dtype (bf16 when is_bf16, else f32); kv_valid (B,)
// int32; window <= 0 means none. Dq, Dv <= 256, a pair that dq_instance
// takes.
static fa::Args unpack(const long long* p) {
  const long long *qs = p + 12, *ks = p + 16, *vs = p + 20;
  return fa::Args{reinterpret_cast<const void*>(p[0]),
                  reinterpret_cast<const void*>(p[1]),
                  reinterpret_cast<const void*>(p[2]),
                  reinterpret_cast<void*>(p[3]),
                  reinterpret_cast<const int*>(p[4]), (int)p[5], (int)p[6],
                  (int)p[7], (int)p[8], (int)p[9], (int)p[10], (int)p[11],
                  qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
                  vs[2], (int)p[24], (int)p[25], (int)p[26], (int)p[27],
                  1.0f / sqrtf((float)p[10]),
                  reinterpret_cast<float*>(p[29])};
}

// The kernel a call takes (ops.py fwd_route mirrors it). bf16: (Dq, Dv) =
// (112, 112) and the MLA classes take flash_bf16_persistent, (96, 64) and
// (192, 128) at their exact widths and the rest of each class padded to
// them (Dq <= 96 with Dv <= 64 to <96, 64>, every other MLA pair to <192,
// 128>); the other pairs pad alike to 64, 128 or 256 and take flash_bf16.
// f32: flash_f32 (dispatch_f32). Returns the launch status.
extern "C" int flash_attention(const long long* p, void* stream) {
  using namespace fa;
  const Args a = unpack(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lse_class = p[28] && a.Dq > 64 && a.Dq <= 96 && a.Dv <= 64;
  if (a.lse && !lse_class) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Lq == 0 || a.H == 0) return 0;
  if (a.lse) return (int)launch_persistent<96, 64, 192, true>(a, s);
  if (p[28]) {
    if (a.Dq == 112 && a.Dv == 112)
      return (int)launch_persistent<112, 112, 128>(a, s);
    const int pq = dq_instance(a.Dq, a.Dv), pv = pad_dh(a.Dv);
    if (pq == pv) {
      if (pq == 64) return (int)launch_bf16<64, 64, 128>(a, s);
      if (pq == 128) return (int)launch_bf16<128, 128, 128>(a, s);
      return (int)launch_bf16<256, 256, 64>(a, s);
    }
    if (pq == 128 && a.Dq <= 96)
      return (int)launch_persistent<96, 64, 192>(a, s);
    if (pq != 0) return (int)launch_persistent<192, 128, 96>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = a.Dq % 4 == 0 && a.Dv % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.o) & 15) == 0 &&
                   f32_aligned(a.q, a.qsB, a.qsL, a.qsH, a.B, a.Lq, a.H) &&
                   f32_aligned(a.k, a.ksB, a.ksL, a.ksH, a.B, a.Lkv, a.Hkv) &&
                   f32_aligned(a.v, a.vsB, a.vsL, a.vsH, a.B, a.Lkv, a.Hkv);
  return (int)(vec ? dispatch_f32<true>(a, s) : dispatch_f32<false>(a, s));
}

// Not routed: flash_bf16_persistent at qwen3's padded width <128, 128>
// (bf16, Dq and Dv <= 128), for tools/trace_kernels.py to time beside the
// routed flash_bf16<128, 128, 128> on the same call.
extern "C" int flash_attention_probe(const long long* p, void* stream) {
  using namespace fa;
  const Args a = unpack(p);
  if (!p[28] || a.Dq > 128 || a.Dv > 128 || a.lse)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Lq == 0 || a.H == 0) return 0;
  return (int)launch_persistent<128, 128, 128>(
      a, static_cast<cudaStream_t>(stream));
}
