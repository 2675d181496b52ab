// K4-bwd: the backward of the prefill attention (K4) with GQA, causal,
// sliding window, bidirectional prefix, cross attention (Lq != Lkv), an
// explicit q_offset and a ragged kv_valid_len: dq, dk and dv from q, k, v,
// K4's output o and the output's cotangent do.
//
// Replaces no TPU kernel: the Pallas kernel has no VJP, and the reference
// trains through its jnp blockwise attention (src/repro/models/layers.py
// flash_attention), which JAX differentiates. The port sends attention to
// K4 on the card, so its training path needs a backward of its own
// (ops.py FlashAttentionFn); this kernel is held against
// ref.py attention_bwd_ref and, through it, against jax.grad of the
// reference layer. The mask is ref.py attention_mask's, element by element.
//
// Contract. q and k have head dim Dq, v (and o, do) Dv: every pair the
// forward takes (MLA's (96, 64), (192, 128), (24, 16)) and Dq = Dv up to
// 256. Recurrence (all sums in f32): LSE = m + log(l) over the masked,
// scaled scores S = Q K^T / sqrt(Dq) (a sum over Dq); P = exp(S - LSE);
// dV = P^T do; dP = do V^T (over Dv); D = rowsum(P . dP), which is
// rowsum(do . o) (over Dv) of the exact o; dS = P . (dP - D); dQ = dS K /
// sqrt(Dq); dK = dS^T Q / sqrt(Dq). The f32 kernels form D from o, which
// they read in f32. The bf16 (a) with pass 1 sums P . dP there: from the
// bf16 o, D would carry o's rounding (2^-9 of |do| |o|) into every dS of
// the row alike, and where a row's P is nearly uniform over keys with a
// large common part (whisper-base's decoder) that error in dQ and dK,
// and in a key bias whose exact gradient is 0, outgrew the gradient's own
// rounding. (a) from a saved LSE (minicpm3's class, no pass 1) forms D
// from the bf16 o. A row that sees
// no key has P = 0 everywhere, never NaN. kv_valid_len (int32 (B,), or
// null) ends row b's keys at kend = min(Lkv, kv_valid_len[b]) (kv_end):
// every family ANDs it onto causal, window and prefix in allowed,
// tile_live and tile_full; keys in [kend, Lkv) get zero dK and dV. Every
// kernel here is deterministic (no atomics; every output element is
// written by one CTA after a fixed-order loop, so repeats are
// bit-identical). An f32 call with Lq and Lkv <= 64 (<= 32 where a head dim
// is over 128) takes one fused kernel (below); every other call takes two,
// launched one after the other on the caller's stream:
//   (a) dq: a CTA owns a q tile of one head. It runs pass 1 over the kv
//       tiles for the row max and sum (and, in bf16, D), writes LSE and D
//       to a (B, H, Lq) scratch, and runs pass 2 over the kv tiles again,
//       accumulating dQ.
//   (b) dk/dv: a CTA owns a kv tile of one kv head. It loops over the G
//       query heads of the kv head in order g = 0 .. G - 1 and over their
//       live q tiles, reads LSE and D, and accumulates dK and dV (GQA's sum
//       over the G heads is this loop).
// K4's forward (flash_attention.cu) writes no LSE at most widths, so (a)
// recomputes it in pass 1. At minicpm3's (96, 64) class (Dq in (64, 96],
// Dv <= 64) a training forward (flash_bf16_persistent_lse, O bit-identical
// to the serving kernel's) writes it into the scratch's lse, in the units
// below, and (a) from it (bwd_dq_lse_bf16, part 3) runs pass 2 alone; a
// call of that class without a saved LSE takes (a) at <128, 64>, passes 1
// and 2. Tiles that the mask hides entirely (causal, window, past
// kend) are skipped by an exact test on the tile's corner positions
// (tile_live). Routes (ops.bwd_route mirrors the dispatch at the end of
// this file): bf16 with Dq, Dv <= 128 takes the wgmma pair at DQP, DVP of
// 64 or 128 each (qwen3's 128/128, the reduced MLA's (24, 16) at <64,
// 64>), but minicpm3's class at the exact widths <96, 64> (S and S^T in 6
// k-steps, dQ and dK at N = 96, the MN-major operand one and a half
// slabs); bf16 past 128 the wide wgmma pair (deepseek-v2's (192, 128) at
// <192, 128>, paligemma's 256 and every other pair at <256, 256>); f32 the
// CUDA-core pair or the one-pass kernel. Each head dim is padded in shared
// memory (zeros past it), so any Dq, Dv <= 256. Tensors are contiguous (B,
// L, H, D); scale_dim is the head dim of the scale (the wrapper gives bf16
// rows of a head dim that is not a multiple of 8 as a zero-padded copy,
// each tensor to its own width, with the scale of the unpadded Dq).
//
// Bound on an H100: the five products of a standard backward (S and dQ
// and dK over Dq, dP and dV over Dv) at qwen3-14b's L = 4,096, H = 40/8,
// Dh = 128, causal half, are 430 GFLOP, 0.435 ms at 989 TFLOP/s bf16; q,
// k, v, o, do, dq, dk and dv once are 0.15 ms of bytes: bound by
// operations, on the tensor cores. The same holds at every width here
// (paligemma's 256 with its prefix: 0.174 ms of products over 8 query
// heads; deepseek-v2's 128 heads of (192, 128): 1.81 ms).
//
// bf16 (the training path's): warp-specialised for Hopper, as K4's
// forward. A CTA has three warpgroups: one producer thread keeps TMA loads
// in flight (4-D tensor maps with 128-byte swizzle, boxes of 64 columns x
// 64 or 32 rows, zero fill past each tensor's head dim and past the
// sequence) into a ring on full/empty mbarriers, and two consumer
// warpgroups run every product on wgmma, bf16 operands and f32
// accumulators; setmaxnreg moves registers from the producer (24) to the
// consumers (240). Q and K tiles are DQP wide, V and dO tiles DVP wide,
// and each product runs at its own width (S over DQP, dP over DVP, dQ and
// dK with DQP columns, dV with DVP).
//   (a) (bwd_dq_bf16, and bwd_dq_wide_bf16 past 128: one template, dq_tma)
//       takes 128 q rows, 64 a consumer. Q and dO load once; each pass
//       streams one K and one V tile a stage: pass 1 computes S and dP for
//       the row max, the sum and D, pass 2 S and dP again for dS. S = Q
//       K^T and dP = dO V^T
//       have both operands in shared memory (K and V read K-major); dQ +=
//       dS K takes dS from registers (the accumulator rounded to bf16 A
//       fragments, as K4 does with P) and reads K MN-major from the same
//       swizzled tile. A tile's dQ product is waited for after the next
//       tile's S and dP are issued. Pass 1's row max and sum run through
//       four partials a row. BK is 64 where three stages fit beside Q and
//       dO, and 32 at <256, 256> (Q and dO alone take 128 KB there): dQ's
//       128 f32 registers a thread leave room for S and dP at 16 each.
//   (b) up to 128 (bwd_dkv_bf16) takes 128 keys, 64 a consumer. K and V
//       load once; Q, dO and the 64 LSE and D of each live 64-row q tile
//       of each of the G heads stream through the ring. S^T = K Q^T and
//       dP^T = V dO^T are shared-memory products; dV += P^T dO and dK +=
//       dS^T Q take P^T and dS^T from registers and read dO and Q MN-major
//       from the tiles that fed the K-major products. The two consumers
//       take the tensor cores in turn (named barriers), so that one's
//       softmax runs under the other's products; in (a) the turns measured
//       slower and are not taken.
//   (b) past 128 (bwd_dkv_wide_bf16) takes 64 keys. One consumer's dK and
//       dV at 256 columns would take 256 f32 registers a thread, so the
//       two consumers split the outputs instead of the keys: the P side
//       computes S^T = K Q^T, P^T, and dV += P^T dO; the dS side dP^T = V
//       dO^T, then dS^T = P^T . (dP^T - D) with P^T read from a shared
//       buffer that the P side fills (f32, in the accumulator's own layout,
//       handed over on two named barriers), and dK += dS^T Q. Each side
//       holds one output (128 + 32 + 16 registers at 256) and runs two of
//       the four products, no product twice. Two ring stages at <256, 256>,
//       three at <192, 128>. Where one CTA a key tile would fill at most
//       the SMs (paligemma's one kv head and 4,352 keys: 68 CTAs of 132),
//       <256, 256> splits dK's and dV's columns across two CTAs (SPLIT),
//       each computing S^T and dP^T over the full depth: twice the CTAs
//       at 1.5x the products, measured faster up to a grid of one CTA an
//       SM and slower past it (PERF.md).
//   The exact-width pair <96, 64> (minicpm3's class) is (a) and (b) above
//   at DQ 96: S and S^T in 6 k-steps, dQ and dK at N = 96 as one wgmma
//   whose MN-major descriptor steps across the two 64-column slabs
//   (N = 64 then N = 32 measured slower, PERF.md). Its (a)
//   (bwd_dq_lse_bf16) reads the LSE K4's training forward saved and runs
//   pass 2 alone, one batch of products a tile, tile j's S and dP with
//   tile j - 1's dQ, so that tile j's dS runs under dQ(j - 1)
//   (DQ_PIPELINE); its (b) the same, one turn a tile, tile j's S^T and
//   dP^T with tile j - 1's dV and dK (DKV_PIPELINE). Its CTAs take the
//   (sequence, head) pairs in groups of 8, each group's tiles heaviest
//   first, so that the K and V ((a)) or Q and dO ((b)) of the CTAs in
//   flight stay in L2 (grouped_unit).
// Scores go to the exp2 domain with scale * log2(e) folded into one FFMA
// before ex2; the scratch LSE is in log2 units and +inf where a row sees no
// key or lies past Lq, so P is 0 there without a mask. The per-element
// mask runs only on edge tiles (the causal diagonal, the window's far
// edge, the prefix boundary, kend, the sequence's end: tile_full), one
// branch a tile; interior tiles take none. Keys past Lkv are zeros from
// TMA's fill; keys in [kend, Lkv) are real data, so a tile that reaches
// past kend takes the mask. The pair up to 128 keeps an instance without
// kv_valid_len (RAGGED false: kend is Lkv and tile_full skips its test),
// the one every training path takes: with the test it measured about 3%
// slower (PERF.md). The heaviest causal tiles start first: (a)'s
// q tile is its slowest grid index, reversed, and (b)'s kv tile its
// slowest, kv tile 0 (the longest) first. Every consumer runs every live
// tile of its CTA (where its own rows or keys see none of the tile, the
// mask gives P = 0), so that both wait on and release each stage. An
// instruction that writes a wgmma's accumulator registers where ptxas
// cannot prove the product retired makes it serialise every wgmma of the
// kernel (pass 1's mask writes a copy for that reason; chip_smoke fails
// on the warning).
//
// f32: full fp32 FMAs on the CUDA cores, never TF32 and no tensor cores,
// as K4-f32's contract requires (a TF32 gradient moves the embedder).
//   One pass (bwd_one_pass_f32, Lq <= 64 and Lkv <= 64: the embedder's B
//   48 x 24 tokens, 12 heads of 64, bidirectional). The tiled pair would
//   run 64-row tiles of which 24 x 24 are live, compute S twice in (a) and
//   S and dP again in (b), and pass LSE and D through a global scratch:
//   about 11x the arithmetic the backward needs, in two launches of 576
//   CTAs at two an SM. Here one launch does it all: a CTA owns one
//   (sequence, kv head), loads K and V once with cp.async (16 bytes where
//   aligned, else 4), and for each of its G query heads in order loads Q
//   and dO, forms D = rowsum(dO . O) from O in global memory, computes S =
//   Q K^T and dP = dO V^T, an exact softmax over the whole row (the row's
//   max and sum at once: no LSE, no rescale), P and dS = P . (dP - D),
//   writes dQ = dS K / sqrt(Dh), and adds P^T dO into dV and dS^T Q into
//   dK in registers; dK / sqrt(Dh) and dV are written at the end. The tile
//   is 32 x 32 where both lengths are at most 32 (128 threads, 41,984
//   bytes of shared memory at Dh <= 64: five CTAs an SM, so the embedder's
//   576 run in one wave), else 64 x 64 (256 threads). The products are
//   register micro-tiles (each 16-byte shared read feeds several
//   independent FFMA chains), with K and V swizzled by 16-byte chunk. The
//   bound of the embedder's call is its bytes: q, k, v, o, do read and dq,
//   dk, dv written once, 28.3 MB, 0.0085 ms at 3.35 TB/s (its five
//   products, 0.21 GFLOP, take 0.0032 ms at 67 TFLOP/s). At Dv != Dq the
//   tiles take the larger head dim padded to 64 or 128, zeros past each
//   tensor's own; past 128 the 32 x 32 tile alone, at 256 (140 KB of
//   shared memory, 255 registers a thread: one CTA an SM).
//   Tiled (longer calls, the CUDA-core pair bwd_dq_f32 / bwd_dkv_f32):
//   (a) then (b) as above, with the LSE (log2 units) and D scratch, one
//   CTA of 256 threads an SM. Each tile of Q, K, V and dO is held in shared
//   memory at DP columns, the larger head dim padded to 64, 128 or 256
//   (zeros past each tensor's own; a call in (128, 192] at 256), swizzled
//   by 16-byte chunk and copied by cp.async into two stages, the next
//   tile's under this one's products. Every product is an 8 x 8 register
//   micro-tile, 4 FFMAs a 4-byte shared read; the score products split the
//   head dim across lanes and sum by shuffles. (a) takes 64 q rows and 64
//   keys a step (32 and 32 at DP 256), (b) 32 keys a CTA, the heaviest
//   causal tiles first in both grids (the section before the tensor maps).
//   Bound at phase 13 (a)'s B 1 x 1,024, 40/8 heads of 128, causal: the
//   products of (a)'s outputs (S, dP, dQ) 0.24 ms at 67 TFLOP/s fp32,
//   (b)'s (S, dP, dV, dK) 0.32 ms; (a) also reruns S for the LSE (K4-f32
//   writes none).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace fab {

typedef __nv_bfloat16 bf16;

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;      // (B, H, ls) scratch: (a) writes, (b) reads; on
                          // the wgmma pairs ls is Lq rounded up to 64 and
                          // LSE is in log2 units
  const int* kvl;         // kv_valid_len (B,), or null
  int B, Lq, Lkv, H, Hkv;
  int D, Dv;              // q/k/dq/dk head dim; v/o/do/dv head dim
  int G, ls;
  int causal, window, prefix_len, q_offset;
  int vec;                // 16-byte loads: aligned bases, D and Dv multiples
  float scale;            // 1 / sqrt(the unpadded Dq)
};

// the end of batch row b's keys: min(Lkv, kv_valid_len[b]), at least 0
__device__ __forceinline__ int kv_end(const Args& a, int b) {
  return a.kvl ? max(0, min(a.Lkv, a.kvl[b])) : a.Lkv;
}

// ref.py attention_mask: query row i (position q_offset + i) may attend to
// key j of a batch row whose keys end at kend
__device__ __forceinline__ bool allowed(const Args& a, int i, int j,
                                        int kend) {
  if (i >= a.Lq || j >= kend) return false;
  if (j < a.prefix_len) return true;
  const int qpos = a.q_offset + i;
  if (a.causal && j > qpos) return false;
  if (a.window > 0 && qpos - j >= a.window) return false;
  return true;
}

// whether any (row, key) of rows [q0, q1) x keys [k0, k1) is allowed: the
// differences qpos - kpos of the tile cover [dmin, dmax] without gaps
__device__ __forceinline__ bool tile_live(const Args& a, int q0, int q1,
                                          int k0, int k1, int kend) {
  q1 = min(q1, a.Lq);
  k1 = min(k1, kend);
  if (q0 >= q1 || k0 >= k1) return false;
  if (k0 < a.prefix_len) return true;
  const long long dmin = (long long)a.q_offset + q0 - (k1 - 1);
  const long long dmax = (long long)a.q_offset + (q1 - 1) - k0;
  if (a.causal && dmax < 0) return false;
  if (a.window > 0 && dmin >= a.window) return false;
  return true;
}

// whether the mask allows every (row, key) of rows [q0, q1) x keys [k0,
// k1), rows clipped to Lq and keys to Lkv: such a tile runs without the
// per-element mask (keys past Lkv are the caller's to mask where they
// matter; keys in [kend, Lkv) make the tile an edge tile). RAGGED false:
// the call has no kv_valid_len (kend is Lkv), and the test is left out
template <bool RAGGED = true>
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int q1,
                                          int k0, int k1, int kend) {
  q1 = min(q1, a.Lq);
  k1 = min(k1, a.Lkv);
  if (RAGGED && k1 > kend) return false;
  if (k1 <= a.prefix_len) return true;
  const long long qlo = (long long)a.q_offset + q0;
  const long long qhi = (long long)a.q_offset + q1 - 1;
  return (!a.causal || k1 - 1 <= qlo) &&
         (a.window <= 0 || qhi - k0 < a.window);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma. A CTA has three warpgroups: one
// producer thread keeps TMA loads in flight into a ring on full/empty
// mbarriers, and two consumer warpgroups run the products on wgmma. Every
// shared tile is 64 rows (q tiles, and the keys of (b)) or BK rows ((a)'s
// key tiles) of a head dim padded to a multiple of 64 columns (DQP for q
// and k, DVP for v and do), stored as slabs of rows x 128 bytes with
// 128-byte swizzle; TMA zero-fills the columns past each tensor's head dim
// and the rows past the sequence. In an m64nN accumulator, thread (warp w,
// lane 4 g + t) of a warpgroup holds rows 16 w + g and 16 w + g + 8,
// columns 8 j + 2 t and 8 j + 2 t + 1: element 4 j + e is row (e >> 1),
// column (e & 1).
// ---------------------------------------------------------------------------

constexpr int WG = 128;                 // threads in a warpgroup
constexpr int HTHREADS = 3 * WG;        // producer + two consumers
constexpr int TR = 64;                  // rows of a q tile (a consumer's)
constexpr int STAGES = 3;               // ring depth
constexpr int SLAB = 64;                // bf16 columns of one 128-byte row
constexpr int SMEM_MAX = 232448 - 1024; // dynamic shared memory a block
                                        // gets, less the static barriers
constexpr float LOG2E = 1.4426950408889634f;

template <int DQP, int DVP, int BK = TR>
struct Tiles {
  // slabs a row: DQP 96 (the exact-width pair) takes two, TMA zero-filling
  // the second past column 96
  static constexpr int SQ = (DQP + SLAB - 1) / SLAB;
  static constexpr int SV = (DVP + SLAB - 1) / SLAB;
  static constexpr int TQ = SQ * TR * 128;      // one 64-row tile of q or k
  static constexpr int TV = SV * TR * 128;      // one of v or do
  static constexpr int KQ = SQ * BK * 128;      // (a)'s BK-row K tile
  static constexpr int KV = SV * BK * 128;      // (a)'s BK-row V tile
  // (a): Q and dO (a tile per consumer each), then a stage of K and V
  static constexpr int DQ_SMEM = 1024 + 2 * TQ + 2 * TV + STAGES * (KQ + KV);
  // (b): K and V (a tile per consumer each), then a stage of Q, dO, and
  // 64 LSE and 64 D, padded to keep the next stage 1,024-byte aligned
  static constexpr int STAT = TR * 4;
  static constexpr int DKV_STAGE = TQ + TV + 1024;
  static constexpr int DKV_SMEM = 1024 + 2 * TQ + 2 * TV + STAGES * DKV_STAGE;
};

// (a)'s key tile: 64 rows where three stages of them fit beside Q and dO,
// else 32 (<256, 256>)
template <int DQP, int DVP>
__host__ __device__ constexpr int dq_bk() {
  return Tiles<DQP, DVP, TR>::DQ_SMEM <= SMEM_MAX ? TR : TR / 2;
}

// the wide (b): K and V of its 64 keys, a ring of NS stages of Q, dO and
// the stats (three where they fit), and P^T (64 x 64 f32) for the dS side
template <int DQP, int DVP>
struct WideKV {
  using T = Tiles<DQP, DVP>;
  static constexpr int STAGE = T::TQ + T::TV + 1024;
  static constexpr int PBUF = TR * TR * 4;
  static constexpr int BASE = 1024 + T::TQ + T::TV + PBUF;
  static constexpr int NS = BASE + 3 * STAGE <= SMEM_MAX ? 3 : 2;
  static constexpr int SMEM = BASE + NS * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
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

// One 64-column x 64-row box of a 4-D tensor map (Dh, heads, positions,
// batch) into shared memory, completing on ``bar``.
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

// ``bytes`` contiguous bytes (16-byte aligned, a multiple of 16) into
// shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (rows
// of 128 bytes, 8-row groups 1,024 bytes apart) use only the stride byte
// offset; an MN-major one uses the leading byte offset between its
// 64-column slabs too.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16
       | (uint64_t)((sbo & 0x3FFFF) >> 4) << 32
       | 1ull << 62;
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
// dK/dV's two consumers take the tensor cores in turn, consumer 0 first
// (named barriers 1 and 2 over their 256 threads): a turn issues one batch
// of wgmma and hands on, so that one consumer's softmax runs under the
// other's products. Both take the same number of turns, ``left``;
// consumer 1 does not hand on its last.
struct Turns {
  int cw, left;
  __device__ __forceinline__ Turns(int cw_, int n) : cw(cw_), left(n) {
    if (cw == 1 && n > 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
  __device__ __forceinline__ void take() const {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
  }
  __device__ __forceinline__ void pass() {
    --left;
    if (cw == 0 || left > 0)
      asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
  }
};


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

// wgmma with both operands from shared memory, K-major (A 64 rows, B N
// rows): m64nNk16, bf16 in, f32 accumulate (each accumulator register an
// operand). FIRST overwrites d, which is then no input, so the previous
// tile's values are dead before the product starts.
template <int N, bool FIRST>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b);

// C += A M: A (bf16) from registers, M from shared memory read MN-major
// (trans-b = 1); m64nNk16, accumulating.
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32, true>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),
        "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<32, false>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, true>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),
        "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, false>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// C (64 x N) = A B^T over DP columns: A a 64-row and B an N-row tile in
// shared memory, both read K-major (S = Q K^T, dP = dO V^T and their
// transposes)
template <int DP, int N>
__device__ __forceinline__ void gemm_rows(float (&c)[N / 2], uint32_t a,
                                          uint32_t b) {
  wgmma_ss<N, true>(c, desc_sw128(a, 16, 1024), desc_sw128(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < DP / 16; ++kk) {
    const uint32_t ka = (kk / 4) * TR * 128 + (kk % 4) * 32;
    const uint32_t kb = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma_ss<N, false>(c, desc_sw128(a + ka, 16, 1024),
                       desc_sw128(b + kb, 16, 1024));
  }
}

// C (64 x DP) += F M: F (64 x K) bf16 A fragments in registers, M a K-row
// tile in shared memory read MN-major (dQ += dS K, dV += P^T dO, dK +=
// dS^T Q). At DP 96 M spans one and a half 64-column slabs: one N = 96
// product whose descriptor steps to the second slab by its leading byte
// offset
template <int DP, int K>
__device__ __forceinline__ void gemm_frags(float (&c)[DP / 2],
                                           uint32_t (&f)[K / 16][4],
                                           uint32_t m) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<DP>(c, f[kk], desc_sw128(m + kk * 16 * 128, K * 128, 1024));
}

// the 16 columns 16 kk .. 16 kk + 15 of a 64 x N accumulator as the A
// fragment of one k-step (rounded to bf16)
template <int N>
__device__ __forceinline__ void to_frag(const float (&s)[N], int kk,
                                        uint32_t (&f)[4]) {
  f[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  f[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  f[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  f[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// whether kv tile n (BK keys) holds a key that a row of the CTA's 128 sees
template <int BK>
__device__ __forceinline__ bool kv_live(const Args& a, int row0, int n,
                                        int kend) {
  return tile_live(a, row0, row0 + 2 * TR, n * BK, n * BK + BK, kend);
}

template <int BK>
__device__ __forceinline__ int next_kv(const Args& a, int row0, int n,
                                       int nkt, int kend) {
  while (n < nkt && !kv_live<BK>(a, row0, n, kend)) ++n;
  return n;
}

// The exact-width pair's order of CTAs: the (sequence, head) pairs in
// groups of GROUP_BH, each group's tiles in turn from the heaviest causal
// one, head by head within a tile, so that the CTAs in flight read the K
// and V ((a)) or the Q and dO ((b)) of about GROUP_BH heads, which stay in
// L2 (all 40 of minicpm3's, 52 MB, do not). The other instances take the
// grid as it comes (the slowest index the tile).
constexpr int GROUP_BH = 8;

// this CTA's (sequence, head) pair bh of n_bh, and its tile of n_t in
// that order (0 the first)
__device__ __forceinline__ void grouped_unit(int n_bh, int n_t, int& bh,
                                             int& tile) {
  const int u =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int g0 = u / (GROUP_BH * n_t) * GROUP_BH;   // the group's first bh
  const int gn = min(GROUP_BH, n_bh - g0);          // and its size
  const int r = u - g0 * n_t;
  tile = r / gn;
  bh = g0 + r % gn;
}

// (a)'s CTA: the first of its 128 q rows, its head and sequence
struct DqUnit {
  int row0, h, b;
};
template <int DQP>
__device__ __forceinline__ DqUnit dq_unit(const Args& a) {
  if constexpr (DQP == 96) {
    const int nqt = (a.Lq + 2 * TR - 1) / (2 * TR);
    int bh, tile;
    grouped_unit(a.B * a.H, nqt, bh, tile);
    return {(nqt - 1 - tile) * 2 * TR, bh % a.H, bh / a.H};
  } else {
    // the heaviest causal q tiles first: the q tile is the slowest grid
    // index, reversed
    return {(int)((gridDim.z - 1 - blockIdx.z) * 2 * TR), (int)blockIdx.x,
            (int)blockIdx.y};
  }
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// (a) from a saved LSE takes one batch of products a tile: S and dP of
// tile j, then dQ of tile j - 1, as two commit groups; wait_group 1
// retires the first, and tile j's dS runs in place (f32) under dQ(j - 1),
// whose fragments it may not overwrite until wait_group 0, as K4's
// persistent forward overlaps its softmax with P V (false: S and dP
// issued and waited for, then dQ, as the other instances;
// tools/bwd_variants.py's dq-nopipeline). Issuing S and dP of tile j + 1
// into a second register set before tile j's softmax measured 0.5982 ms
// against 0.4441 at minicpm3's call on an H100: ptxas serialised every
// wgmma of the kernel.
constexpr bool DQ_PIPELINE = true;

// the pass 2 of (a) from a saved LSE, one consumer's 64 rows (rl, rl + 8
// a thread's), as DQ_PIPELINE says. ``it`` counts the stages taken;
// ``held`` is left at the stage the last dQ, in flight, reads.
template <int DQP, int DVP, int BK, bool RAGGED>
__device__ __forceinline__ void dq_pipelined_loop(
    const Args& a, float (&s)[2][BK / 2], float (&acc)[DQP / 2],
    uint32_t (&dsf)[BK / 16][4], const float (&lse2)[2],
    const float (&dsr)[2], unsigned char* Ks, unsigned char* Vs,
    uint64_t* full, uint64_t* empty, uint32_t q_addr, uint32_t do_addr,
    int row0, int r0, int rl, int t, int lane, int nkt, int kend, int& it,
    int& held) {
  using T = Tiles<DQP, DVP, BK>;
  const float sl2 = a.scale * LOG2E;
  float (&p)[BK / 2] = s[0];
  float (&dp)[BK / 2] = s[1];
  auto issue_s = [&](int st) {                           // S and dP
    gemm_rows<DQP, BK>(p, q_addr, smem_u32(Ks + st * T::KQ));
    gemm_rows<DVP, BK>(dp, do_addr, smem_u32(Vs + st * T::KV));
  };
  // dS = P (dP - D) of the tile at k0, in place in p
  auto ds = [&](int k0) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      p[i] = ex2(fmaf(p[i], sl2, -lse2[(i >> 1) & 1]));
    if (!(k0 + BK <= a.Lkv &&
          tile_full<RAGGED>(a, r0, r0 + TR, k0, k0 + BK, kend)))
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)           // an edge tile: the mask
        if (!allowed(a, rl + 8 * ((i >> 1) & 1),
                     k0 + 8 * (i >> 2) + 2 * t + (i & 1), kend))
          p[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) p[i] *= dp[i] - dsr[(i >> 1) & 1];
  };
  int n = next_kv<BK>(a, row0, 0, nkt, kend);
  if (n >= nkt) return;
  int st = it % STAGES;
  mbar_wait(full + st, (it / STAGES) & 1);
  ++it;
  keep(p);
  keep(dp);
  wgmma_fence();
  issue_s(st);
  wgmma_commit();
  wgmma_wait0();
  keep(p);
  keep(dp);
  ds(n * BK);
  for (int nn = next_kv<BK>(a, row0, n + 1, nkt, kend); nn < nkt;
       nn = next_kv<BK>(a, row0, nn + 1, nkt, kend)) {
    const int st2 = it % STAGES;
    mbar_wait(full + st2, (it / STAGES) & 1);
    ++it;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_frag(p, kk, dsf[kk]);
    keep(p);
    keep(dp);
    keep(acc);
    keep(dsf);
    wgmma_fence();
    issue_s(st2);
    wgmma_commit();
    gemm_frags<DQP, BK>(acc, dsf, smem_u32(Ks + st * T::KQ));  // MN-major
    wgmma_commit();
    wgmma_wait1();                            // S and dP of tile nn
    keep(p);
    keep(dp);
    ds(nn * BK);
    wgmma_wait0();                            // dQ of tile n
    keep(acc);
    keep(dsf);
    if (lane == 0) mbar_arrive(empty + st);
    n = nn;
    st = st2;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) to_frag(p, kk, dsf[kk]);
  keep(acc);
  keep(dsf);
  wgmma_fence();
  gemm_frags<DQP, BK>(acc, dsf, smem_u32(Ks + st * T::KQ));
  wgmma_commit();
  held = st;
}

// (a) for a 128-row q tile (two consumers of 64 rows) with BK-key tiles:
// the body of bwd_dq_bf16 (BK 64), bwd_dq_wide_bf16 and bwd_dq_lse_bf16.
// RAGGED false: the call has no kv_valid_len. PASS1: pass 1 finds each
// row's LSE and D = sum_k P dP; PASS1 false: the LSE comes from the
// forward (a.lse, which K4's flash_bf16_persistent_lse wrote), pass 1 is
// not run, and D = rowsum(dO . O) is read from the bf16 O and written
template <int DQP, int DVP, int BK, bool RAGGED, bool PASS1 = true>
__device__ __forceinline__ void dq_tma(const CUtensorMap& tq,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       const CUtensorMap& tdo, const Args& a,
                                       unsigned char* smem_raw,
                                       uint64_t* bars) {
  using T = Tiles<DQP, DVP, BK>;
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + 2 * T::TQ;
  unsigned char* Ks = dOs + 2 * T::TV;            // [STAGES] K tiles
  unsigned char* Vs = Ks + STAGES * T::KQ;        // [STAGES] V slots
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  const DqUnit unit = dq_unit<DQP>(a);
  const int row0 = unit.row0;
  const int h = unit.h, b = unit.b, hk = h / a.G;
  const int nkt = (a.Lkv + BK - 1) / BK;
  const int kend = RAGGED ? kv_end(a, b) : a.Lkv;
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);               // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each pass takes the live kv tiles one at a time, K and V a stage.
  if (threadIdx.x < WG) {
    // ---- producer: Q and dO once; K and V (pass 1, then pass 2) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * T::TQ + 2 * T::TV);
      for (int half = 0; half < 2; ++half) {
        for (int sl = 0; sl < T::SQ; ++sl)
          tma_load(Qs + half * T::TQ + sl * TR * 128, &tq, qd_full,
                   sl * SLAB, h, row0 + TR * half, b);
        for (int sl = 0; sl < T::SV; ++sl)
          tma_load(dOs + half * T::TV + sl * TR * 128, &tdo, qd_full,
                   sl * SLAB, h, row0 + TR * half, b);
      }
      int it = 0;
      for (int pass = PASS1 ? 0 : 1; pass < 2; ++pass)
        for (int n = next_kv<BK>(a, row0, 0, nkt, kend); n < nkt;
             n = next_kv<BK>(a, row0, n + 1, nkt, kend)) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          ++it;
          mbar_wait(empty + st, ph ^ 1);
          mbar_expect_tx(full + st, T::KQ + T::KV);
          for (int sl = 0; sl < T::SQ; ++sl)
            tma_load(Ks + st * T::KQ + sl * BK * 128, &tk, full + st,
                     sl * SLAB, hk, n * BK, b);
          for (int sl = 0; sl < T::SV; ++sl)
            tma_load(Vs + st * T::KV + sl * BK * 128, &tv, full + st,
                     sl * SLAB, hk, n * BK, b);
        }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = row0 + TR * cw;                // this consumer's rows
    const int rl = r0 + 16 * warp + g;            // a thread's: rl, rl + 8
    const float sl2 = a.scale * LOG2E;            // exp2 domain
    const uint32_t q_addr = smem_u32(Qs + cw * T::TQ);
    const uint32_t do_addr = smem_u32(dOs + cw * T::TV);
    const size_t qs = (size_t)a.H * a.D, os = (size_t)a.H * a.Dv;
    const size_t hrow = (size_t)b * a.Lq * a.H + h;
    // D of rows rl and rl + 8: without pass 1, rowsum(do . o) over Dv (a
    // quad splits the columns), read while Q and dO land
    float dsr[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2 && !PASS1; ++r) {
      const int row = rl + 8 * r;
      float acc = 0.f;
      if (row < a.Lq) {
        const bf16* op =
            static_cast<const bf16*>(a.o) + hrow * a.Dv + row * os;
        const bf16* dp =
            static_cast<const bf16*>(a.dout) + hrow * a.Dv + row * os;
        for (int c = 8 * t; c < a.Dv; c += 32) {
          const uint4 x = *reinterpret_cast<const uint4*>(op + c);
          const uint4 y = *reinterpret_cast<const uint4*>(dp + c);
          const __nv_bfloat162* xe =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ye =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 xf = __bfloat1622float2(xe[i]);
            const float2 yf = __bfloat1622float2(ye[i]);
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dsr[r] = acc;
    }
    float lse2[2];
    if constexpr (!PASS1) {
      // the forward's LSE, in the same units, +inf past Lq, read while Q
      // and dO land; rows past Lqp (the second consumer of a last 64-row
      // tile) read none
      const int Lqp = (a.Lq + TR - 1) / TR * TR;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rl + 8 * r;
        const size_t at = ((size_t)b * a.H + h) * Lqp + row;
        lse2[r] = row < Lqp ? a.lse[at] : INFINITY;
        if (t == 0 && row < Lqp) a.dsum[at] = row < a.Lq ? dsr[r] : 0.f;
      }
    }
    // Both consumers run every live kv tile of the CTA (where one's rows
    // see no key of it, the mask gives P = 0).
    mbar_wait(qd_full, 0);
    float s[2][BK / 2];
    int it = 0;
    if constexpr (PASS1) {
      // pass 1: the row max m, the sum l and dl = sum_k 2^(S' - m) dP (S'
      // the scaled score in the exp2 domain), online, over one kv tile a
      // stage (S = Q K^T and dP = dO V^T); then D = dl / l = sum_k P dP in
      // f32 (the contract above says why not from O). Row sums and maxima
      // go through four partials each, so that no dependent chain is
      // longer than 8.
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float dl[2] = {0.f, 0.f};
      float (&dp)[BK / 2] = s[1];
      for (int n = next_kv<BK>(a, row0, 0, nkt, kend); n < nkt;
           n = next_kv<BK>(a, row0, n + 1, nkt, kend)) {
        const int k0 = n * BK;
        const int st = it % STAGES;
        mbar_wait(full + st, (it / STAGES) & 1);
        ++it;
        wgmma_fence();
        gemm_rows<DQP, BK>(s[0], q_addr, smem_u32(Ks + st * T::KQ));   // S
        gemm_rows<DVP, BK>(dp, do_addr, smem_u32(Vs + st * T::KV));   // dP
        wgmma_commit();
        wgmma_wait0();
        keep(s[0]);
        keep(dp);
        if (lane == 0) mbar_arrive(empty + st);
        // The mask writes a copy: an instruction that writes the
        // accumulator registers themselves makes ptxas serialise every
        // wgmma of the kernel.
        float x[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) x[i] = s[0][i];
        if (!(k0 + BK <= a.Lkv &&
              tile_full<RAGGED>(a, r0, r0 + TR, k0, k0 + BK, kend)))
          // an edge tile: the causal diagonal, the window's far edge, the
          // prefix boundary, kend, the sequence's end
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (!allowed(a, rl + 8 * ((i >> 1) & 1),
                         k0 + 8 * (i >> 2) + 2 * t + (i & 1), kend))
              x[i] = -INFINITY;
        float mp[2][4], lp[2][4], dlp[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mp[r][c] = -INFINITY, lp[r][c] = 0.f, dlp[r][c] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float& mx = mp[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
          mx = fmaxf(mx, x[i]);
        }
        float safe[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = fmaxf(fmaxf(mp[r][0], mp[r][1]),
                           fmaxf(mp[r][2], mp[r][3]));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float mn = fmaxf(m[r], mt * sl2);
          safe[r] = mn == -INFINITY ? 0.f : mn;
          const float c = ex2(m[r] - safe[r]);        // 0 while m is -inf
          l[r] *= c;
          dl[r] *= c;
          m[r] = mn;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1, c = ((i >> 2) & 1) * 2 + (i & 1);
          const float e = ex2(fmaf(x[i], sl2, -safe[r]));
          lp[r][c] += e;
          dlp[r][c] = fmaf(e, dp[i], dlp[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ls = (lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]);
          float ds = (dlp[r][0] + dlp[r][1]) + (dlp[r][2] + dlp[r][3]);
          ls += __shfl_xor_sync(0xffffffffu, ls, 1);
          ds += __shfl_xor_sync(0xffffffffu, ds, 1);
          ls += __shfl_xor_sync(0xffffffffu, ls, 2);
          ds += __shfl_xor_sync(0xffffffffu, ds, 2);
          l[r] += ls;
          dl[r] += ds;
        }
      }
      // LSE in log2 units; +inf where a row sees no key (and past Lq), so
      // that P = 2^(S log2e scale - LSE) is 0 there without a mask; D 0
      // there
      const int Lqp = (a.Lq + TR - 1) / TR * TR;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rl + 8 * r;
        lse2[r] = l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
        dsr[r] = l[r] > 0.f ? dl[r] / l[r] : 0.f;
        if (t == 0 && row < Lqp) {
          const size_t at = ((size_t)b * a.H + h) * Lqp + row;
          a.lse[at] = row < a.Lq ? lse2[r] : INFINITY;
          a.dsum[at] = row < a.Lq ? dsr[r] : 0.f;
        }
      }
    }
    // pass 2: dS = P (dP - D); dQ += dS K. A tile's dQ product is waited
    // for, and its stage released, after the next tile's S and dP.
    float (&dp)[BK / 2] = s[1];
    float acc[DQP / 2];
#pragma unroll
    for (int i = 0; i < DQP / 2; ++i) acc[i] = 0.f;
    uint32_t dsf[BK / 16][4];
    int held = -1;                          // the stage the last dQ reads
    if constexpr (!PASS1 && DQ_PIPELINE) {
      dq_pipelined_loop<DQP, DVP, BK, RAGGED>(
          a, s, acc, dsf, lse2, dsr, Ks, Vs, full, empty, q_addr, do_addr,
          row0, r0, rl, t, lane, nkt, kend, it, held);
    } else {
    for (int n = next_kv<BK>(a, row0, 0, nkt, kend); n < nkt;
         n = next_kv<BK>(a, row0, n + 1, nkt, kend)) {
      const int k0 = n * BK;
      const int st = it % STAGES;
      mbar_wait(full + st, (it / STAGES) & 1);
      ++it;
      const uint32_t k_addr = smem_u32(Ks + st * T::KQ);
      wgmma_fence();
      gemm_rows<DQP, BK>(s[0], q_addr, k_addr);                      // S
      gemm_rows<DVP, BK>(dp, do_addr, smem_u32(Vs + st * T::KV)); // dP
      wgmma_commit();
      wgmma_wait0();
      keep(s[0]);
      keep(dp);
      if (held >= 0 && lane == 0) mbar_arrive(empty + held);
      float (&p)[BK / 2] = s[0];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        p[i] = ex2(fmaf(p[i], sl2, -lse2[(i >> 1) & 1]));
      if (!(k0 + BK <= a.Lkv &&
            tile_full<RAGGED>(a, r0, r0 + TR, k0, k0 + BK, kend)))
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)         // an edge tile: the mask
          if (!allowed(a, rl + 8 * ((i >> 1) & 1),
                       k0 + 8 * (i >> 2) + 2 * t + (i & 1), kend))
            p[i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        p[i] *= dp[i] - dsr[(i >> 1) & 1];                      // dS
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_frag(p, kk, dsf[kk]);
      keep(acc);
      keep(dsf);
      wgmma_fence();
      gemm_frags<DQP, BK>(acc, dsf, k_addr);       // K read MN-major
      wgmma_commit();
      held = st;
    }
    }
    wgmma_wait0();
    keep(acc);
    if (held >= 0 && lane == 0) mbar_arrive(empty + held);
    bf16* dq = static_cast<bf16*>(a.dq) + hrow * a.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      if (row >= a.Lq) continue;
#pragma unroll
      for (int j = 0; j < DQP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.D)
          *reinterpret_cast<__nv_bfloat162*>(dq + row * qs + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * a.scale,
                                    acc[4 * j + 2 * r + 1] * a.scale);
      }
    }
  }
}

// (a), Dq and Dv <= 128: 64-key tiles; RAGGED false for a call without
// kv_valid_len
template <int DQP, int DVP, bool RAGGED>
__global__ void __launch_bounds__(HTHREADS, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  dq_tma<DQP, DVP, TR, RAGGED>(tq, tk, tv, tdo, a, smem_raw, bars);
}

// (a) at the exact widths <96, 64> from the LSE that K4's training forward
// wrote: pass 2 alone; RAGGED as bwd_dq_bf16's
template <int DQP, int DVP, bool RAGGED>
__global__ void __launch_bounds__(HTHREADS, 1)
bwd_dq_lse_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  dq_tma<DQP, DVP, TR, RAGGED, false>(tq, tk, tv, tdo, a, smem_raw, bars);
}

// (a) past 128: <192, 128> at 64-key tiles, <256, 256> at 32
template <int DQP, int DVP>
__global__ void __launch_bounds__(HTHREADS, 1)
bwd_dq_wide_bf16(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  dq_tma<DQP, DVP, dq_bk<DQP, DVP>(), true>(tq, tk, tv, tdo, a, smem_raw,
                                             bars);
}

// (b) at <96, 64> issues one batch a tile: S^T and dP^T of tile j, then
// dV and dK of tile j - 1, as two commit groups; wait_group 1 retires the
// first, and tile j's softmax runs in place (f32) under dV and dK(j - 1),
// whose fragments it may not overwrite until wait_group 0 (false: two
// turns a tile, each waited for, as the other instances;
// tools/bwd_variants.py's dkv-nopipeline)
constexpr bool DKV_PIPELINE = true;

// (b)'s loop over the n live (head, q tile)s of the CTA at <96, 64>, one
// consumer's 64 keys (kr0; a thread's kl, kl + 8), in the producer's order;
// its two consumers issue freely, without (b)'s turns elsewhere (measured
// faster, PERF.md)
template <int DQP, int DVP, bool RAGGED>
__device__ __forceinline__ void dkv_pipelined_loop(
    const Args& a, float (&dk)[DQP / 2], float (&dv)[DVP / 2],
    float (&s)[TR / 2], float (&dp)[TR / 2], uint32_t (&pf)[TR / 16][4],
    uint32_t (&dsf)[TR / 16][4], unsigned char* ring, uint64_t* full,
    uint64_t* empty, uint64_t* kv_full, uint32_t k_addr, uint32_t v_addr,
    int k0, int kr0, int kl, int t, int lane, int nqt, int n, int kend) {
  using T = Tiles<DQP, DVP>;
  const float sl2 = a.scale * LOG2E;
  mbar_wait(kv_full, 0);
  if (n == 0) return;
  int qt = -1;                          // the live q tiles, head by head
  auto next_q0 = [&]() {
    do {
      qt = qt + 1 == nqt ? 0 : qt + 1;
    } while (!tile_live(a, qt * TR, qt * TR + TR, k0, k0 + 2 * TR, kend));
    return qt * TR;
  };
  auto stage = [&](int j) { return ring + (j % STAGES) * T::DKV_STAGE; };
  auto issue_s = [&](int j) {                     // S^T = K Q^T, dP^T
    gemm_rows<DQP, TR>(s, k_addr, smem_u32(stage(j)));
    gemm_rows<DVP, TR>(dp, v_addr, smem_u32(stage(j) + T::TQ));
  };
  auto issue_kv = [&](int j) {          // dV += P^T dO, dK += dS^T Q
    gemm_frags<DVP, TR>(dv, pf, smem_u32(stage(j) + T::TQ));
    gemm_frags<DQP, TR>(dk, dsf, smem_u32(stage(j)));
  };
  // P^T and dS^T of tile j (queries q0..) in place, as the other
  // instances compute them
  auto softmax = [&](int j, int q0) {
    const float* Ls =
        reinterpret_cast<const float*>(stage(j) + T::TQ + T::TV);
    const float* Ds = Ls + TR;
#pragma unroll
    for (int jj = 0; jj < TR / 8; ++jj) {         // P^T
      const float2 lv = *reinterpret_cast<const float2*>(Ls + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * jj + e];
        x = ex2(fmaf(x, sl2, (e & 1) ? -lv.y : -lv.x));
      }
    }
    if (!tile_full<RAGGED>(a, q0, q0 + TR, kr0, kr0 + TR, kend))
#pragma unroll
      for (int i = 0; i < TR / 2; ++i)           // an edge tile: the mask
        if (!allowed(a, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                     kl + 8 * ((i >> 1) & 1), kend))
          s[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < TR / 8; ++jj) {
      const float2 dd = *reinterpret_cast<const float2*>(Ds + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {                        // dS^T
        float& x = dp[4 * jj + e];
        x = s[4 * jj + e] * (x - ((e & 1) ? dd.y : dd.x));
      }
    }
  };
  auto frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      to_frag(s, kk, pf[kk]);
      to_frag(dp, kk, dsf[kk]);
    }
  };
  int q0 = next_q0();
  mbar_wait(full, 0);
  keep(s);
  keep(dp);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait0();
  keep(s);
  keep(dp);
  softmax(0, q0);
  frags();
  for (int j = 1; j < n; ++j) {
    q0 = next_q0();
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
    keep(s);
    keep(dp);
    keep(dk);
    keep(dv);
    keep(pf);
    keep(dsf);
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    issue_kv(j - 1);
    wgmma_commit();
    wgmma_wait1();                            // S^T and dP^T of tile j
    keep(s);
    keep(dp);
    softmax(j, q0);
    wgmma_wait0();                            // dV and dK of tile j - 1
    keep(dk);
    keep(dv);
    keep(pf);
    keep(dsf);
    if (lane == 0) mbar_arrive(empty + (j - 1) % STAGES);
    frags();
  }
  keep(dk);
  keep(dv);
  keep(pf);
  keep(dsf);
  wgmma_fence();
  issue_kv(n - 1);
  wgmma_commit();
  wgmma_wait0();
  keep(dk);
  keep(dv);
  if (lane == 0) mbar_arrive(empty + (n - 1) % STAGES);
}

// (b), Dq and Dv <= 128: 128 keys, 64 a consumer; RAGGED as (a)'s
template <int DQP, int DVP, bool RAGGED>
__global__ void __launch_bounds__(HTHREADS, 1)
bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const Args a) {
  using T = Tiles<DQP, DVP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + 2 * T::TQ;
  unsigned char* ring = Vs + 2 * T::TV;       // [STAGES][Q | dO | LSE | D]
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  // the heaviest causal kv tiles (the first) first: the kv tile is the
  // slowest grid index (at <96, 64> in groups of heads, grouped_unit)
  int k0 = blockIdx.z * 2 * TR;
  int hk = blockIdx.x, b = blockIdx.y;
  if constexpr (DQP == 96) {
    int bh, tile;
    grouped_unit(a.B * a.Hkv, (a.Lkv + 2 * TR - 1) / (2 * TR), bh, tile);
    k0 = tile * 2 * TR;
    hk = bh % a.Hkv;
    b = bh / a.Hkv;
  }
  const int nqt = (a.Lq + TR - 1) / TR, Lqp = nqt * TR;
  const int kend = RAGGED ? kv_end(a, b) : a.Lkv;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);               // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer: K and V once; Q, dO, LSE and D of each live q tile of
    // each of the G heads, in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::TQ + 2 * T::TV);
      for (int half = 0; half < 2; ++half) {
        for (int sl = 0; sl < T::SQ; ++sl)
          tma_load(Ks + half * T::TQ + sl * TR * 128, &tk, kv_full,
                   sl * SLAB, hk, k0 + TR * half, b);
        for (int sl = 0; sl < T::SV; ++sl)
          tma_load(Vs + half * T::TV + sl * TR * 128, &tv, kv_full,
                   sl * SLAB, hk, k0 + TR * half, b);
      }
      int it = 0;
      for (int gq = 0; gq < a.G; ++gq) {
        const int h = hk * a.G + gq;
        const size_t srow = ((size_t)b * a.H + h) * Lqp;
        for (int qt = 0; qt < nqt; ++qt) {
          const int q0 = qt * TR;
          if (!tile_live(a, q0, q0 + TR, k0, k0 + 2 * TR, kend)) continue;
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          ++it;
          unsigned char* sp = ring + st * T::DKV_STAGE;
          mbar_wait(empty + st, ph ^ 1);
          mbar_expect_tx(full + st, T::TQ + T::TV + 2 * T::STAT);
          for (int sl = 0; sl < T::SQ; ++sl)
            tma_load(sp + sl * TR * 128, &tq, full + st, sl * SLAB, h, q0, b);
          for (int sl = 0; sl < T::SV; ++sl)
            tma_load(sp + T::TQ + sl * TR * 128, &tdo, full + st, sl * SLAB,
                     h, q0, b);
          unsigned char* stats = sp + T::TQ + T::TV;
          bulk_load(stats, a.lse + srow + q0, T::STAT, full + st);
          bulk_load(stats + T::STAT, a.dsum + srow + q0, T::STAT, full + st);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each; S^T and dP^T (keys x queries), then
    // dV += P^T dO and dK += dS^T Q ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kr0 = k0 + TR * cw;                 // this consumer's keys
    const int kl = kr0 + 16 * warp + g;           // a thread's: kl, kl + 8
    const float sl2 = a.scale * LOG2E;
    const uint32_t k_addr = smem_u32(Ks + cw * T::TQ);
    const uint32_t v_addr = smem_u32(Vs + cw * T::TV);
    float dk[DQP / 2], dv[DVP / 2];
#pragma unroll
    for (int i = 0; i < DQP / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) dv[i] = 0.f;
    float s[TR / 2], dp[TR / 2];
    uint32_t pf[TR / 16][4], dsf[TR / 16][4];
    // Both consumers run every q tile of the CTA (where one's keys see no
    // query of it, the mask gives P = 0), two turns a tile: S^T and dP^T,
    // then dV and dK.
    int nlive = 0;
    for (int qt = 0; qt < nqt; ++qt)
      nlive += tile_live(a, qt * TR, qt * TR + TR, k0, k0 + 2 * TR, kend);
    if constexpr (DQP == 96 && DKV_PIPELINE) {
      dkv_pipelined_loop<DQP, DVP, RAGGED>(
          a, dk, dv, s, dp, pf, dsf, ring, full, empty, kv_full, k_addr,
          v_addr, k0, kr0, kl, t, lane, nqt, a.G * nlive, kend);
    } else {
    Turns turns(cw, 2 * a.G * nlive);
    mbar_wait(kv_full, 0);
    int it = 0;
    for (int gq = 0; gq < a.G; ++gq) {
      for (int qt = 0; qt < nqt; ++qt) {
        const int q0 = qt * TR;
        if (!tile_live(a, q0, q0 + TR, k0, k0 + 2 * TR, kend)) continue;
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        ++it;
        mbar_wait(full + st, ph);
        const unsigned char* sp = ring + st * T::DKV_STAGE;
        const uint32_t q_addr = smem_u32(sp);
        const uint32_t do_addr = smem_u32(sp + T::TQ);
        const float* Ls = reinterpret_cast<const float*>(sp + T::TQ + T::TV);
        const float* Ds = Ls + TR;
        turns.take();
        wgmma_fence();
        gemm_rows<DQP, TR>(s, k_addr, q_addr);    // S^T = K Q^T
        gemm_rows<DVP, TR>(dp, v_addr, do_addr);  // dP^T = V dO^T
        wgmma_commit();
        turns.pass();
        wgmma_wait0();
        keep(s);
        keep(dp);
        // S^T's rows are keys and its columns queries: the mask takes them
        // swapped, LSE and D are the column's. Queries past Lq have LSE
        // +inf, so P is 0 there without the mask; keys past Lkv give rows
        // that are not stored, keys in [kend, Lkv) take the mask.
#pragma unroll
        for (int j = 0; j < TR / 8; ++j) {          // P^T
          const float2 lv =
              *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * j + e];
            x = ex2(fmaf(x, sl2, (e & 1) ? -lv.y : -lv.x));
          }
        }
        if (!tile_full<RAGGED>(a, q0, q0 + TR, kr0, kr0 + TR, kend))
#pragma unroll
          for (int i = 0; i < TR / 2; ++i)       // an edge tile: the mask
            if (!allowed(a, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                         kl + 8 * ((i >> 1) & 1), kend))
              s[i] = 0.f;
#pragma unroll
        for (int j = 0; j < TR / 8; ++j) {
          const float2 dd =
              *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {                    // dS^T
            float& x = dp[4 * j + e];
            x = s[4 * j + e] * (x - ((e & 1) ? dd.y : dd.x));
          }
        }
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          to_frag(s, kk, pf[kk]);
          to_frag(dp, kk, dsf[kk]);
        }
        keep(dk);
        keep(dv);
        keep(pf);
        keep(dsf);
        turns.take();
        wgmma_fence();
        gemm_frags<DVP, TR>(dv, pf, do_addr);     // dO read MN-major
        gemm_frags<DQP, TR>(dk, dsf, q_addr);     // Q read MN-major
        wgmma_commit();
        turns.pass();
        wgmma_wait0();
        keep(dk);
        keep(dv);
        if (lane == 0) mbar_arrive(empty + st);
      }
    }
    }
    const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
    const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
    bf16* dkp = static_cast<bf16*>(a.dk) + krow * a.D;
    bf16* dvp = static_cast<bf16*>(a.dv) + krow * a.Dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kl + 8 * r;
      if (key >= a.Lkv) continue;
#pragma unroll
      for (int j = 0; j < DQP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.D)
          *reinterpret_cast<__nv_bfloat162*>(dkp + key * ks + c) =
              __floats2bfloat162_rn(dk[4 * j + 2 * r] * a.scale,
                                    dk[4 * j + 2 * r + 1] * a.scale);
      }
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(dvp + key * vs + c) =
              __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}


// the wide (b)'s hand-over of P^T from the P side to the dS side: named
// barriers over both consumers (256 threads), FULL after the P side wrote
// the buffer, EMPTY after the dS side read it
constexpr int P_FULL = 1, P_EMPTY = 2;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// (b) past 128: 64 keys of one kv head, and 1 / SPLIT of dK's and dV's
// columns (SPLIT CTAs share the keys where one CTA a key tile would fill
// at most the SMs; each computes S^T and dP^T over the full depth);
// the P side (consumer 0) holds dV, the dS side (consumer 1) dK, each over
// every live q tile of the G heads
template <int DQP, int DVP, int SPLIT>
__global__ void __launch_bounds__(HTHREADS, 1)
bwd_dkv_wide_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const Args a) {
  using T = Tiles<DQP, DVP>;
  using W = WideKV<DQP, DVP>;
  constexpr int NS = W::NS;
  constexpr int DQH = DQP / SPLIT, DVH = DVP / SPLIT;  // a CTA's columns
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NS];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + T::TQ;
  unsigned char* ring = Vs + T::TV;       // [NS][Q | dO | LSE | D]
  float* Pbuf = reinterpret_cast<float*>(ring + NS * W::STAGE);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + NS;
  // the heaviest causal kv tiles (the first) first: the kv tile is the
  // slowest grid index
  const int k0 = blockIdx.z * TR;
  const int hk = blockIdx.x / SPLIT, col = blockIdx.x % SPLIT;
  const int b = blockIdx.y;
  const int nqt = (a.Lq + TR - 1) / TR, Lqp = nqt * TR;
  const int kend = kv_end(a, b);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);               // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer: K and V once; Q, dO, LSE and D of each live q tile of
    // each of the G heads, in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, T::TQ + T::TV);
      for (int sl = 0; sl < T::SQ; ++sl)
        tma_load(Ks + sl * TR * 128, &tk, kv_full, sl * SLAB, hk, k0, b);
      for (int sl = 0; sl < T::SV; ++sl)
        tma_load(Vs + sl * TR * 128, &tv, kv_full, sl * SLAB, hk, k0, b);
      int it = 0;
      for (int gq = 0; gq < a.G; ++gq) {
        const int h = hk * a.G + gq;
        const size_t srow = ((size_t)b * a.H + h) * Lqp;
        for (int qt = 0; qt < nqt; ++qt) {
          const int q0 = qt * TR;
          if (!tile_live(a, q0, q0 + TR, k0, k0 + TR, kend)) continue;
          const int st = it % NS;
          const uint32_t ph = (it / NS) & 1;
          ++it;
          unsigned char* sp = ring + st * W::STAGE;
          mbar_wait(empty + st, ph ^ 1);
          mbar_expect_tx(full + st, T::TQ + T::TV + 2 * T::STAT);
          for (int sl = 0; sl < T::SQ; ++sl)
            tma_load(sp + sl * TR * 128, &tq, full + st, sl * SLAB, h, q0, b);
          for (int sl = 0; sl < T::SV; ++sl)
            tma_load(sp + T::TQ + sl * TR * 128, &tdo, full + st, sl * SLAB,
                     h, q0, b);
          unsigned char* stats = sp + T::TQ + T::TV;
          bulk_load(stats, a.lse + srow + q0, T::STAT, full + st);
          bulk_load(stats + T::STAT, a.dsum + srow + q0, T::STAT, full + st);
        }
      }
    }
  } else {
    // ---- consumers: the same 64 keys; S^T, dP^T (keys x queries), dV
    // and dK split between them ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kl = k0 + 16 * warp + g;            // a thread's: kl, kl + 8
    const float sl2 = a.scale * LOG2E;
    int nlive = 0;
    for (int qt = 0; qt < nqt; ++qt)
      nlive += tile_live(a, qt * TR, qt * TR + TR, k0, k0 + TR, kend);
    int left = a.G * nlive;                       // tiles to hand over
    const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
    const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
    mbar_wait(kv_full, 0);
    if (cw == 0) {
      // the P side: S^T = K Q^T, P^T into the buffer, dV += P^T dO
      const uint32_t k_addr = smem_u32(Ks);
      float dv[DVH / 2];
#pragma unroll
      for (int i = 0; i < DVH / 2; ++i) dv[i] = 0.f;
      float s[TR / 2];
      uint32_t pf[TR / 16][4];
      int it = 0;
      for (int gq = 0; gq < a.G; ++gq) {
        for (int qt = 0; qt < nqt; ++qt) {
          const int q0 = qt * TR;
          if (!tile_live(a, q0, q0 + TR, k0, k0 + TR, kend)) continue;
          const int st = it % NS;
          const uint32_t ph = (it / NS) & 1;
          ++it;
          mbar_wait(full + st, ph);
          const unsigned char* sp = ring + st * W::STAGE;
          const uint32_t q_addr = smem_u32(sp);
          const uint32_t do_addr = smem_u32(sp + T::TQ);
          const float* Ls =
              reinterpret_cast<const float*>(sp + T::TQ + T::TV);
          wgmma_fence();
          gemm_rows<DQP, TR>(s, k_addr, q_addr);          // S^T = K Q^T
          wgmma_commit();
          wgmma_wait0();
          keep(s);
          // S^T's rows are keys and its columns queries: the mask takes
          // them swapped, LSE is the column's. Queries past Lq have LSE
          // +inf, so P is 0 there without the mask; keys past Lkv give rows
          // that are not stored, keys in [kend, Lkv) take the mask.
#pragma unroll
          for (int j = 0; j < TR / 8; ++j) {              // P^T
            const float2 lv =
                *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = s[4 * j + e];
              x = ex2(fmaf(x, sl2, (e & 1) ? -lv.y : -lv.x));
            }
          }
          if (!tile_full(a, q0, q0 + TR, k0, k0 + TR, kend))
#pragma unroll
            for (int i = 0; i < TR / 2; ++i)     // an edge tile: the mask
              if (!allowed(a, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                           kl + 8 * ((i >> 1) & 1), kend))
                s[i] = 0.f;
          // the buffer in the accumulator's layout: the dS side's thread
          // tid holds the same (key, query) pairs as this one
          named_sync(P_EMPTY);
#pragma unroll
          for (int i = 0; i < TR / 2; ++i) Pbuf[i * WG + tid] = s[i];
          named_arrive(P_FULL);
#pragma unroll
          for (int kk = 0; kk < TR / 16; ++kk) to_frag(s, kk, pf[kk]);
          keep(dv);
          keep(pf);
          wgmma_fence();
          gemm_frags<DVH, TR>(dv, pf, do_addr +       // dO read MN-major
                              col * (DVH / SLAB) * TR * 128);
          wgmma_commit();
          wgmma_wait0();
          keep(dv);
          if (lane == 0) mbar_arrive(empty + st);
        }
      }
      bf16* dvp = static_cast<bf16*>(a.dv) + krow * a.Dv;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = kl + 8 * r;
        if (key >= a.Lkv) continue;
#pragma unroll
        for (int j = 0; j < DVH / 8; ++j) {
          const int c = col * DVH + 8 * j + 2 * t;
          if (c < a.Dv)
            *reinterpret_cast<__nv_bfloat162*>(dvp + key * vs + c) =
                __floats2bfloat162_rn(dv[4 * j + 2 * r],
                                      dv[4 * j + 2 * r + 1]);
        }
      }
    } else {
      // the dS side: dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q
      const uint32_t v_addr = smem_u32(Vs);
      float dk[DQH / 2];
#pragma unroll
      for (int i = 0; i < DQH / 2; ++i) dk[i] = 0.f;
      float dp[TR / 2];
      uint32_t dsf[TR / 16][4];
      if (left > 0) named_arrive(P_EMPTY);        // the buffer starts empty
      int it = 0;
      for (int gq = 0; gq < a.G; ++gq) {
        for (int qt = 0; qt < nqt; ++qt) {
          const int q0 = qt * TR;
          if (!tile_live(a, q0, q0 + TR, k0, k0 + TR, kend)) continue;
          const int st = it % NS;
          const uint32_t ph = (it / NS) & 1;
          ++it;
          mbar_wait(full + st, ph);
          const unsigned char* sp = ring + st * W::STAGE;
          const uint32_t q_addr = smem_u32(sp);
          const uint32_t do_addr = smem_u32(sp + T::TQ);
          const float* Ds =
              reinterpret_cast<const float*>(sp + T::TQ + T::TV) + TR;
          wgmma_fence();
          gemm_rows<DVP, TR>(dp, v_addr, do_addr);        // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait0();
          keep(dp);
          named_sync(P_FULL);
#pragma unroll
          for (int j = 0; j < TR / 8; ++j) {              // dS^T
            const float2 dd =
                *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = dp[4 * j + e];
              x = Pbuf[(4 * j + e) * WG + tid] *
                  (x - ((e & 1) ? dd.y : dd.x));
            }
          }
          if (--left > 0) named_arrive(P_EMPTY);
#pragma unroll
          for (int kk = 0; kk < TR / 16; ++kk) to_frag(dp, kk, dsf[kk]);
          keep(dk);
          keep(dsf);
          wgmma_fence();
          gemm_frags<DQH, TR>(dk, dsf, q_addr +       // Q read MN-major
                              col * (DQH / SLAB) * TR * 128);
          wgmma_commit();
          wgmma_wait0();
          keep(dk);
          if (lane == 0) mbar_arrive(empty + st);
        }
      }
      bf16* dkp = static_cast<bf16*>(a.dk) + krow * a.D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = kl + 8 * r;
        if (key >= a.Lkv) continue;
#pragma unroll
        for (int j = 0; j < DQH / 8; ++j) {
          const int c = col * DQH + 8 * j + 2 * t;
          if (c < a.D)
            *reinterpret_cast<__nv_bfloat162*>(dkp + key * ks + c) =
                __floats2bfloat162_rn(dk[4 * j + 2 * r] * a.scale,
                                      dk[4 * j + 2 * r + 1] * a.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32, one pass: a call with Lq <= 64 and Lkv <= 64 (the embedder's 24
// tokens) in one launch, with no scratch. A CTA owns one (sequence, kv head)
// and a T x T tile, T = 32 where both lengths are at most 32, else 64: T / 8
// warps; thread (warp w, lane 8 q + tl) has the slots r0 = 8 w + 2 q and r0
// + 1. In S and dP it holds rows r0, r0 + 1 x keys tl + 8 j; in dQ the same
// rows x 16-byte chunks tl + 8 c of the head dim; in dK and dV keys r0, r0 +
// 1 x the same chunks. A quarter-warp reads one Q (dO) row as a broadcast
// and 8 keys' same chunk of K (V), whose rows are stored with chunk c of row
// r at c ^ (r & 7), so the 8 reads fall in 8 bank groups. Warps whose rows
// (keys) all lie past Lq (Lkv) skip their share, and S and dP take only the
// 8-key groups below Lkv: at L = 24 the tile's dead quarter costs nothing.
// ---------------------------------------------------------------------------

template <int T, int DP, bool GQA>
struct OnePass {
  static constexpr int NT = 4 * T;          // threads: T / 8 warps
  static constexpr int KJ = T / 8;          // keys a lane in S and dP
  static constexpr int NC = DP / 32;        // 16-byte chunks a lane
  static constexpr int LDP = T + 4;         // P and dS row stride
  static constexpr int SMEM = 4 * (4 * T * DP + 2 * T * LDP);
  // the embedder's instance (41,984 bytes, one query head a kv head): five
  // CTAs an SM, so that its 576 CTAs run in one wave (four an SM measured
  // slower), at <= 96 registers a thread with no spill, which holds only
  // because dK and dV's 32 accumulators live in their own phase (with G >
  // 1 they carry across the heads: four an SM)
  static constexpr int MINB = T == 32 && DP == 64 ? (GQA ? 4 : 5) : 1;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// rows [0, rows) of a [rows][DP] shared tile from global rows src + r *
// stride, issued as cp.async (a source size of 0 reads nothing and
// zero-fills): zeros past nvalid rows and past D columns. VEC: 16-byte
// copies (16-byte aligned bases, D a multiple of 4); else 4-byte ones. SWZ:
// chunk c of row r lands at chunk c ^ (r & 7).
template <int DP, bool VEC, bool SWZ>
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           size_t stride, int rows,
                                           int nvalid, int D) {
  if constexpr (VEC) {
    constexpr int CH = DP / 4;
    for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
      const int r = e / CH, c = e % CH;
      const bool in = r < nvalid && 4 * c < D;
      cp_async16(dst + r * DP + ((SWZ ? c ^ (r & 7) : c) << 2),
                 in ? src + r * stride + 4 * c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += blockDim.x) {
      const int r = e / DP, d = e % DP, c = d >> 2;
      const bool in = r < nvalid && d < D;
      cp_async4(dst + r * DP + ((SWZ ? c ^ (r & 7) : c) << 2) + (d & 3),
                in ? src + r * stride + d : src, in ? 4 : 0);
    }
  }
}

// s[i][j] += row r0 + i of A . row tl + 8 j of Bm (swizzled) over DP
// columns, for the first NJ key groups: each 16-byte read feeds 2 NJ or 2
// independent FFMA chains
template <int DP, int KJ, int NJ>
__device__ __forceinline__ void dots(const float* A, const float* Bm, int r0,
                                     int tl, float (&s)[2][KJ]) {
  const float* ap = A + r0 * DP;
  const float* bp = Bm + tl * DP;
#pragma unroll 4    // fully unrolled, the 96-register instance spills
  for (int c = 0; c < DP / 4; ++c) {
    float4 av[2], bv[NJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      av[i] = *reinterpret_cast<const float4*>(ap + i * DP + 4 * c);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(bp + j * 8 * DP +
                                               ((c ^ tl) << 2));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// dots over the nj key groups that hold a key below Lkv (1 <= nj <= KJ),
// each count its own unrolled instance
template <int DP, int KJ, int NJ = KJ>
__device__ __forceinline__ void dots_upto(int nj, const float* A,
                                          const float* Bm, int r0, int tl,
                                          float (&s)[2][KJ]) {
  if constexpr (NJ > 1) {
    if (nj < NJ) {
      dots_upto<DP, KJ, NJ - 1>(nj, A, Bm, r0, tl, s);
      return;
    }
  }
  dots<DP, KJ, NJ>(A, Bm, r0, tl, s);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// dV += P^T dO and dK += dS^T Q at keys r0, r0 + 1 x chunks tl + 8 c, over
// rows [0, nr) in order (rows past Lq hold P = dS = 0)
template <int DP, int LDP, int NC>
__device__ __forceinline__ void kv_rows(const float* Ps, const float* dSs,
                                        const float* Qs, const float* dOs,
                                        int nr, int r0, int tl,
                                        float (&dk)[2][NC][4],
                                        float (&dv)[2][NC][4]) {
#pragma unroll 2    // 4 deep, the 96-register instance spills
  for (int r = 0; r < nr; ++r) {
    const float2 p2 = *reinterpret_cast<const float2*>(Ps + r * LDP + r0);
    const float2 s2 = *reinterpret_cast<const float2*>(dSs + r * LDP + r0);
    const float pv[2] = {p2.x, p2.y}, sv[2] = {s2.x, s2.y};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 ov = *reinterpret_cast<const float4*>(
          dOs + r * DP + (tl + 8 * c) * 4);
      const float4 qv = *reinterpret_cast<const float4*>(
          Qs + r * DP + (tl + 8 * c) * 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dv[i][c][0] = fmaf(pv[i], ov.x, dv[i][c][0]);
        dv[i][c][1] = fmaf(pv[i], ov.y, dv[i][c][1]);
        dv[i][c][2] = fmaf(pv[i], ov.z, dv[i][c][2]);
        dv[i][c][3] = fmaf(pv[i], ov.w, dv[i][c][3]);
        dk[i][c][0] = fmaf(sv[i], qv.x, dk[i][c][0]);
        dk[i][c][1] = fmaf(sv[i], qv.y, dk[i][c][1]);
        dk[i][c][2] = fmaf(sv[i], qv.z, dk[i][c][2]);
        dk[i][c][3] = fmaf(sv[i], qv.w, dk[i][c][3]);
      }
    }
  }
}

// dk / sqrt(Dq) and dv of keys r0, r0 + 1 (those below Lkv) at chunks tl +
// 8 c (those below D, and below Dv)
template <bool VEC, int NC>
__device__ __forceinline__ void store_kv(const Args& a, size_t krow, int r0,
                                         int tl, const float (&dk)[2][NC][4],
                                         const float (&dv)[2][NC][4]) {
  const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
  float* dkp = static_cast<float*>(a.dk) + krow * a.D;
  float* dvp = static_cast<float*>(a.dv) + krow * a.Dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = r0 + i;
    if (key >= a.Lkv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = (tl + 8 * c) * 4;
      const float rk[4] = {dk[i][c][0] * a.scale, dk[i][c][1] * a.scale,
                           dk[i][c][2] * a.scale, dk[i][c][3] * a.scale};
      if (VEC) {
        if (d0 < a.D)
          *reinterpret_cast<float4*>(dkp + key * ks + d0) =
              make_float4(rk[0], rk[1], rk[2], rk[3]);
        if (d0 < a.Dv)
          *reinterpret_cast<float4*>(dvp + key * vs + d0) = make_float4(
              dv[i][c][0], dv[i][c][1], dv[i][c][2], dv[i][c][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (d0 + e < a.D) dkp[key * ks + d0 + e] = rk[e];
          if (d0 + e < a.Dv) dvp[key * vs + d0 + e] = dv[i][c][e];
        }
      }
    }
  }
}

// grid (Hkv, B), OnePass<T, DP, GQA>::NT threads. GQA: G query heads a kv
// head, G >= 1; else G = 1, and the head loop runs once
template <int T, int DP, bool VEC, bool GQA>
__global__ void __launch_bounds__(OnePass<T, DP, GQA>::NT,
                                  OnePass<T, DP, GQA>::MINB)
bwd_one_pass_f32(Args a) {
  using C = OnePass<T, DP, GQA>;
  constexpr int KJ = C::KJ, NC = C::NC, LDP = C::LDP;
  extern __shared__ __align__(16) float osm[];
  float* Qs = osm;                  // [T][DP], as loaded
  float* dOs = Qs + T * DP;         // [T][DP], as loaded
  float* Ks = dOs + T * DP;         // [T][DP], chunks swizzled
  float* Vs = Ks + T * DP;          // [T][DP], chunks swizzled
  float* Ps = Vs + T * DP;          // [T][LDP]: P, row-major
  float* dSs = Ps + T * LDP;        // [T][LDP]: dS, row-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl = lane & 7, r0 = warp * 8 + (lane >> 3) * 2;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t qs = (size_t)a.H * a.D, ks = (size_t)a.Hkv * a.D;
  const size_t os = (size_t)a.H * a.Dv, vs = (size_t)a.Hkv * a.Dv;
  const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
  const float* o = static_cast<const float*>(a.o);
  // the rows and keys read: up to the next multiple of 8 (a warp's slots)
  // past Lq and Lkv, zero-filled past them
  const int nr = min(T, (a.Lq + 7) & ~7), nk = min(T, (a.Lkv + 7) & ~7);
  const bool rows_live = warp * 8 < a.Lq, keys_live = warp * 8 < a.Lkv;
  const int kend = kv_end(a, b);
  const bool full = tile_full(a, 0, T, 0, T, kend);
  const int pre = min(a.prefix_len, kend);
  const float sl2 = a.scale * LOG2E;              // exp2 domain
  async_rows<DP, VEC, true>(Ks, static_cast<const float*>(a.k) + krow * a.D,
                            ks, nk, a.Lkv, a.D);
  async_rows<DP, VEC, true>(Vs, static_cast<const float*>(a.v) + krow * a.Dv,
                            vs, nk, a.Lkv, a.Dv);
  float dk[2][NC][4] = {}, dv[2][NC][4] = {};   // over the G heads (GQA)
  for (int g = 0; g < (GQA ? a.G : 1); ++g) {
    const size_t hrow = (size_t)b * a.Lq * a.H + hk * a.G + g;
    const size_t qoff = hrow * a.D, ooff = hrow * a.Dv;
    if (g) __syncthreads();       // the last head's dK/dV reads are done
    async_rows<DP, VEC, false>(Qs, static_cast<const float*>(a.q) + qoff, qs,
                               nr, a.Lq, a.D);
    async_rows<DP, VEC, false>(dOs, static_cast<const float*>(a.dout) + ooff,
                               os, nr, a.Lq, a.Dv);
    // O at the thread's rows and chunks, from global memory while the
    // copies land, for D = rowsum(dO . O)
    float4 ov[2][NC];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int row = r0 + i, d0 = (tl + 8 * c) * 4;
        const float* op = o + ooff + row * os + d0;
        ov[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < a.Lq && d0 < a.Dv) {
          if (VEC) {
            ov[i][c] = *reinterpret_cast<const float4*>(op);
          } else {
            ov[i][c].x = op[0];
            if (d0 + 1 < a.Dv) ov[i][c].y = op[1];
            if (d0 + 2 < a.Dv) ov[i][c].z = op[2];
            if (d0 + 3 < a.Dv) ov[i][c].w = op[3];
          }
        }
      }
    cp_async_wait_all();
    __syncthreads();
    if (rows_live) {
      float D[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 dd = *reinterpret_cast<const float4*>(
              dOs + (r0 + i) * DP + (tl + 8 * c) * 4);
          acc = fmaf(dd.x, ov[i][c].x, acc);
          acc = fmaf(dd.y, ov[i][c].y, acc);
          acc = fmaf(dd.z, ov[i][c].z, acc);
          acc = fmaf(dd.w, ov[i][c].w, acc);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        D[i] = acc;
      }
      float s[2][KJ], dp[2][KJ];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
      dots_upto<DP, KJ>(nk >> 3, Qs, Ks, r0, tl, s);
      dots_upto<DP, KJ>(nk >> 3, dOs, Vs, r0, tl, dp);
      // the mask (ref.py attention_mask) as per-row bounds: key j is seen
      // when lo <= j < hi or j < pre (both within kend); a tile the mask
      // shows whole tests only j < kend. Then an exact softmax over the
      // whole row: no online rescale, no LSE kept
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + i, qp = a.q_offset + row;
        const bool rv = row < a.Lq;
        const int hi = a.causal ? min(kend, qp + 1) : kend;
        const int lo = a.window > 0 ? qp - a.window + 1 : INT_MIN;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int key = tl + 8 * j;
          const bool ok = rv && (full ? key < kend
                                      : key < pre || (key >= lo && key < hi));
          s[i][j] = ok ? s[i][j] : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float neg = mx == -INFINITY ? 0.f : -mx * sl2;  // 0: no key
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = ex2(fmaf(s[i][j], sl2, neg));             // masked: 0
          sum += s[i][j];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float p = s[i][j] * inv;
          Ps[row * LDP + tl + 8 * j] = p;
          dSs[row * LDP + tl + 8 * j] = p * (dp[i][j] - D[i]);
        }
      }
      __syncwarp();       // a quarter-warp reads back only its own rows
      // dQ = dS K: rows r0, r0 + 1 x chunks tl + 8 c, over keys < nk
      float acc[2][NC][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < nk; kk += 4) {
        float4 d4[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          d4[i] = *reinterpret_cast<const float4*>(dSs + (r0 + i) * LDP + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* kr = Ks + (kk + e) * DP;
          const int sw = (kk + e) & 7;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                kr + (((tl + 8 * c) ^ sw) << 2));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float d = lane4(d4[i], e);
              acc[i][c][0] = fmaf(d, kv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(d, kv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(d, kv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(d, kv.w, acc[i][c][3]);
            }
          }
        }
      }
      float* dq = static_cast<float*>(a.dq) + qoff;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + i;
        if (row >= a.Lq) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d0 = (tl + 8 * c) * 4;
          if (d0 >= a.D) continue;
          const float r[4] = {acc[i][c][0] * a.scale, acc[i][c][1] * a.scale,
                              acc[i][c][2] * a.scale, acc[i][c][3] * a.scale};
          if (VEC) {
            *reinterpret_cast<float4*>(dq + row * qs + d0) =
                make_float4(r[0], r[1], r[2], r[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (d0 + e < a.D) dq[row * qs + d0 + e] = r[e];
          }
        }
      }
    }
    __syncthreads();      // every row's P and dS are in shared memory
    if (keys_live) {
      if constexpr (GQA) {
        kv_rows<DP, LDP>(Ps, dSs, Qs, dOs, nr, r0, tl, dk, dv);
      } else {            // one head: the accumulators live here alone
        float dk1[2][NC][4] = {}, dv1[2][NC][4] = {};
        kv_rows<DP, LDP>(Ps, dSs, Qs, dOs, nr, r0, tl, dk1, dv1);
        store_kv<VEC>(a, krow, r0, tl, dk1, dv1);
      }
    }
  }
  if (GQA && keys_live) store_kv<VEC>(a, krow, r0, tl, dk, dv);
}

// ---------------------------------------------------------------------------
// f32, tiled: the CUDA-core pair for calls past the one-pass band, fp32
// FFMAs only. A CTA is 256 threads as two groups of four warps, A (threads
// 0-127) and B (128-255), one CTA an SM (its shared memory).
//   Tiles of Q, dO, K and V are [rows][DP] f32 in shared memory, DP the
// larger head dim padded to 64, 128 or 256 (zeros past each tensor's own),
// chunk c (16 bytes) of row r stored at chunk c ^ (r & 7); they arrive by
// cp.async (16 bytes where aligned, else 4; a thread copies one chunk of
// every few rows) into two stages, the next tile's copy issued when this
// one's products start.
//   Score products (S, dP, and (b)'s S^T, dP^T) are dot products along the
// head dim: a thread holds an 8 x 8 register micro-tile, rows pr + FR i x
// columns pc + FC j of the score tile, and per 16-byte chunk reads 8 + 8
// float4 for 256 FFMAs (4 FFMAs a 4-byte read). Eight lanes of a warp
// share pr and read 8 distinct columns' rows (8 bank groups under the
// swizzle); the score tile has too few micro-tiles for a group, so SK
// lanes of a warp split the head dim and a butterfly of shuffles
// (reduce_scatter) leaves each with 64 / SK of the summed elements. Group A
// computes S (S^T), group B dP (dP^T) on the same positions; the two swap
// halves through shared memory (swap_halves), so that each forms P and dS
// = P . (dP - D) for half the rows.
//   Output products (dQ, dK, dV) are outer products: a thread holds 8 rows x
// 8 columns (16-byte chunks dg and dg + DP / 8) and per step of the
// reduction reads 8 values of dS (P) as two float4 and two float4 of K (dO,
// Q): 64 FFMAs. Where the output has fewer micro-tiles than threads the
// reduction is split (dQ's keys in KS slices, dK's and dV's rows in RS),
// and the partials are summed once, in slice order, at the end.
//   (a) bwd_dq_f32: a CTA owns BM q rows of one head; Q and dO load once, D
//       comes from O in global memory. Pass 1 streams two K tiles a stage
//       (A scores the first, B the second) for each row's max and sum in
//       the exp2 domain (each lane's own, merged once at the end) into the
//       LSE (log2 units, +inf for a row that sees no key) written to the
//       scratch; pass 2 streams K and V, writes dS transposed to shared
//       memory, and all eight warps add dS K into dQ.
//   (b) bwd_dkv_f32: a CTA owns BNB keys of one kv head; K and V load once,
//       Q, dO and the LSE and D rows of each live BMB-row q tile of its G
//       query heads (g = 0 .. G - 1 in order) stream. P^T and dS^T go to
//       shared memory; A adds P^T dO into dV, B dS^T Q into dK. BNB = 32
//       keys: at a causal call the key tile's work falls with its index,
//       and 32 keys make enough CTAs that the heavy ones (first in the
//       grid) do not set the kernel's time.
// The mask runs only on edge tiles (tile_full; tiles past Lkv in (a)'s
// sums, past Lq in (b)), one test a tile.
// ---------------------------------------------------------------------------

constexpr int TT = 256;                // threads of a tiled f32 CTA
constexpr int TG = 128;                // of a group
constexpr bool F32_HEAVY_FIRST = true; // grid: the tile its slowest index,
                                       // the heaviest causal tiles first

template <int DP>
struct Tf32 {
  // (a): BM q rows a CTA, BN keys a step; (b): BNB keys a CTA, BMB q rows
  // a step. Past 128 the tiles halve (Q, dO and two K/V stages at DP 256)
  static constexpr int BM = DP > 128 ? 32 : 64;
  static constexpr int BN = DP > 128 ? 32 : 64;
  static constexpr int BNB = 32;
  static constexpr int BMB = DP > 128 ? 32 : 64;
  static constexpr int SKA = 8192 / (BM * BN);    // head-dim splits of S, dP
  static constexpr int KS = 64 * TT / (BM * DP);  // key splits of dQ
  static constexpr int LDT = BM + 4;              // dS^T row stride
  static constexpr int SKB = 8192 / (BNB * BMB);  // of S^T, dP^T
  static constexpr int RS = 64 * TG / (BNB * DP); // row splits of dK, dV
  static constexpr int LDP = BNB + 4;             // P, dS row stride
  // the score products' chunk loop unrolled 2 deep, where that spills
  // nothing ((a) past 128 and at 64 spills at 2: 1 there)
  static constexpr int UNR_A = DP == 128 ? 2 : 1;
  static constexpr int UNR_B = 2;
  // Q, dO; two stages of two K (V) tiles; the swapped halves (and pass
  // 1's statistics); dS^T; LSE and D
  static constexpr int DQ_SMEM =
      4 * (2 * BM * DP + 4 * BN * DP + BM * BN + BN * LDT + 2 * BM);
  // K, V; two stages of Q, dO, LSE and D; P and dS; the swapped halves
  static constexpr int DKV_SMEM = 4 * (2 * BNB * DP + 4 * BMB * DP +
                                       4 * BMB + 2 * BMB * LDP + 8192 / SKB);
  static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");
  static_assert(KS >= 1 && RS >= 1 && SKA <= 8 && SKB <= 8, "splits");
};

// rows [0, ROWS) of a [ROWS][DP] tile from global rows src + r * stride,
// zeros past nvalid rows and past D columns, chunk c of row r stored at
// chunk c ^ (r & 7), by cp.async from all TT threads. A thread copies the
// same 16-byte chunk (VEC; else the same 4 bytes) of every RS-th row, so
// the unrolled loop only steps the row.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void async_tile(float* dst, const float* src,
                                           size_t stride, int nvalid,
                                           int D) {
  constexpr int CH = DP / 4, PER = VEC ? CH : DP, RS = TT / PER;
  static_assert(TT % PER == 0 && ROWS % RS == 0, "whole passes");
  const int e = threadIdx.x % PER, r0 = threadIdx.x / PER;
  const int c = VEC ? e : e >> 2;
  const bool cin = VEC ? 4 * c < D : e < D;
  const float* sp = src + r0 * stride + (VEC ? 4 * c : e);
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
    const int r = r0 + RS * i;
    // r & 7 is (r0 & 7) ^ ((RS i) & 7): r0 < RS, a power of two
    float* dp = dst + r * DP + ((c ^ (r0 & 7) ^ ((RS * i) & 7)) << 2);
    const bool in = cin && r < nvalid;
    const float* s = in ? sp + RS * i * stride : src;
    if constexpr (VEC)
      cp_async16(dp, s, in ? 16 : 0);
    else
      cp_async4(dp + (e & 3), s, in ? 4 : 0);
  }
}

// acc[i][j] = row pr + FR i of A . row pc + FC j of Bm over head-dim split
// s of SK (chunks [s CS, (s + 1) CS)); both tiles swizzled, pr < FR and pc
// < FC powers of two, so row (p + F i) & 7 is (p & 7) ^ ((F i) & 7)
template <int DP, int FR, int FC, int SK, int UNR>
__device__ __forceinline__ void score_frag(const float* A, const float* Bm,
                                           int pr, int pc, int s,
                                           float (&acc)[8][8]) {
  constexpr int CS = DP / 4 / SK;
  const float* ap = A + pr * DP;
  const float* bp = Bm + pc * DP;
  const int swa = pr & 7, swb = pc & 7;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll UNR
  for (int cc = 0; cc < CS; ++cc) {
    const int c = s * CS + cc;
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          ap + i * FR * DP + ((c ^ swa ^ ((FR * i) & 7)) << 2));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(
          bp + j * FC * DP + ((c ^ swb ^ ((FC * j) & 7)) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// The SK lanes of a split (lane bits log2(P) up) sum their micro-tiles:
// each round halves the elements a lane keeps (rows, then columns, then
// rows), sending the other half to the lane that keeps it. After it lane
// split s holds elements [0, RI) x [0, CJ) of acc as fragment rows roff + i
// and columns coff + j (Split<SK>::rows, Split<SK>::cols).
template <int SK, int P>
__device__ __forceinline__ void reduce_scatter(float (&acc)[8][8], int s) {
  if constexpr (SK >= 2) {
    const bool hi = s & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float send = hi ? acc[i][j] : acc[i + 4][j];
        const float keep = hi ? acc[i + 4][j] : acc[i][j];
        acc[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, P);
      }
  }
  if constexpr (SK >= 4) {
    const bool hi = (s >> 1) & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = hi ? acc[i][j] : acc[i][j + 4];
        const float keep = hi ? acc[i][j + 4] : acc[i][j];
        acc[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * P);
      }
  }
  if constexpr (SK >= 8) {
    const bool hi = (s >> 2) & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = hi ? acc[i][j] : acc[i + 2][j];
        const float keep = hi ? acc[i + 2][j] : acc[i][j];
        acc[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 4 * P);
      }
  }
}

template <int SK>
struct Split {
  static constexpr int RI = SK >= 8 ? 2 : SK >= 2 ? 4 : 8;
  static constexpr int CJ = SK >= 4 ? 4 : 8;
  static __device__ __forceinline__ int rows(int s) {
    return (SK >= 2 ? 4 * (s & 1) : 0) + (SK >= 8 ? 2 * ((s >> 2) & 1) : 0);
  }
  static __device__ __forceinline__ int cols(int s) {
    return SK >= 4 ? 4 * ((s >> 1) & 1) : 0;
  }
};

// The group pair's micro-tiles (same positions; A's holds S, B's dP) split
// by rows: A keeps rows [0, RI / 2) and sends the rest through X ([RI CJ][TG]
// floats), B the reverse; then f(i, j, S, dP) runs on each element of the
// rows this thread keeps, so both groups do half the elementwise work
template <int RI, int CJ, typename F>
__device__ __forceinline__ void swap_halves(const float (&acc)[8][8],
                                            float* X, int grp, int gt,
                                            F f) {
  constexpr int RH = RI / 2;
  if (grp == 0) {
#pragma unroll
    for (int i = RH; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) X[(i * CJ + j) * TG + gt] = acc[i][j];
  } else {
#pragma unroll
    for (int i = 0; i < RH; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) X[(i * CJ + j) * TG + gt] = acc[i][j];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < RH; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        f(i, j, acc[i][j], X[(i * CJ + j) * TG + gt]);
  } else {
#pragma unroll
    for (int i = RH; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        f(i, j, X[(i * CJ + j) * TG + gt], acc[i][j]);
  }
}

// o[i][e] += X[n][x0 + i] Y[n][chunk dg + (e >> 2) DP / 8] over n in [n0,
// n0 + NN): X rows of stride LDX, Y rows of DP swizzled
template <int DP, int LDX, int NN>
__device__ __forceinline__ void outer_frag(const float* X, const float* Y,
                                           int n0, int dg,
                                           float (&o)[8][8]) {
  constexpr int DG = DP / 8;
#pragma unroll 2
  for (int nn = 0; nn < NN; ++nn) {
    const int n = n0 + nn, sw = n & 7;
    const float4 x0 = *reinterpret_cast<const float4*>(X + n * LDX);
    const float4 x1 = *reinterpret_cast<const float4*>(X + n * LDX + 4);
    const float4 y0 = *reinterpret_cast<const float4*>(
        Y + n * DP + ((dg ^ sw) << 2));
    const float4 y1 = *reinterpret_cast<const float4*>(
        Y + n * DP + (((dg + DG) ^ sw) << 2));
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] = fmaf(xv[i], y0.x, o[i][0]);
      o[i][1] = fmaf(xv[i], y0.y, o[i][1]);
      o[i][2] = fmaf(xv[i], y0.z, o[i][2]);
      o[i][3] = fmaf(xv[i], y0.w, o[i][3]);
      o[i][4] = fmaf(xv[i], y1.x, o[i][4]);
      o[i][5] = fmaf(xv[i], y1.y, o[i][5]);
      o[i][6] = fmaf(xv[i], y1.z, o[i][6]);
      o[i][7] = fmaf(xv[i], y1.w, o[i][7]);
    }
  }
}

// The output micro-tiles of NS splits (thread t of NP positions a split:
// split t / NP) summed in split order into split 0's registers through
// buf (NS - 1) x NP x 64 floats; every thread of the CTA calls it
template <int NS, int NP>
__device__ __forceinline__ void sum_splits(float (&o)[8][8], int t,
                                           float* buf) {
  if constexpr (NS > 1) {
    const int sp = t / NP, p = t % NP;
    if (sp > 0) {
      float4* dst = reinterpret_cast<float4*>(buf) + ((sp - 1) * 16) * NP + p;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[(2 * i + h) * NP] = make_float4(o[i][4 * h], o[i][4 * h + 1],
                                              o[i][4 * h + 2], o[i][4 * h + 3]);
    }
    __syncthreads();
    if (sp == 0)
#pragma unroll 1
      for (int q = 1; q < NS; ++q) {
        const float4* src =
            reinterpret_cast<const float4*>(buf) + ((q - 1) * 16) * NP + p;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 u = src[(2 * i + h) * NP];
            o[i][4 * h] += u.x;
            o[i][4 * h + 1] += u.y;
            o[i][4 * h + 2] += u.z;
            o[i][4 * h + 3] += u.w;
          }
      }
  }
}

// rows r0 + i (below nrows) x columns 4 dg + e and 4 (dg + DP / 8) + e (below
// D) of a row-major output of row stride ld, times mul
template <int DP>
__device__ __forceinline__ void store_frag(float* out, size_t ld, int r0,
                                           int nrows, int dg, int D,
                                           float mul,
                                           const float (&o)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 + i >= nrows) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 4 * (dg + (e >> 2) * (DP / 8)) + (e & 3);
      if (c < D) out[(r0 + i) * ld + c] = o[i][e] * mul;
    }
  }
}

// D = rowsum(do . o) over Dv for rows [q0, q0 + BM) of one head (TT / BM
// threads a row, 16-byte loads where VEC holds, all issued before the
// sums): into Ds and the scratch row
template <int DP, int BM, bool VEC>
__device__ __forceinline__ void dsum_rows(const Args& a, const float* o,
                                          const float* dout, size_t stride,
                                          int q0, float* Ds,
                                          float* dsum_row) {
  constexpr int TPR = TT / BM, NC = DP / 4 / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, gr = q0 + r;
  float acc = 0.f;
  if (gr < a.Lq) {
    const float* op = o + gr * stride;
    const float* dp = dout + gr * stride;
    if constexpr (VEC) {
      float4 x[NC], y[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = 4 * (part + TPR * i);
        x[i] = y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < a.Dv) {
          x[i] = *reinterpret_cast<const float4*>(dp + c);
          y[i] = *reinterpret_cast<const float4*>(op + c);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
        acc += x[i].x * y[i].x + x[i].y * y[i].y + x[i].z * y[i].z +
               x[i].w * y[i].w;
    } else {
      for (int c = part; c < a.Dv; c += TPR) acc += dp[c] * op[c];
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    Ds[r] = acc;
    if (gr < a.Lq) dsum_row[gr] = acc;
  }
}

// the tile's unit: (head, sequence, tile index, tiles) from the grid
__device__ __forceinline__ void f32_unit(int& head, int& b, int& tile,
                                         int& nt) {
  if (F32_HEAVY_FIRST) {
    head = blockIdx.x, b = blockIdx.y, tile = blockIdx.z, nt = gridDim.z;
  } else {
    head = blockIdx.y, b = blockIdx.z, tile = blockIdx.x, nt = gridDim.x;
  }
}

// (a): dq, and LSE and D into the scratch, for BM q rows of one head
template <int DP, bool VEC>
__global__ void __launch_bounds__(TT, 1) bwd_dq_f32(Args a) {
  using T = Tf32<DP>;
  constexpr int BM = T::BM, BN = T::BN, SK = T::SKA, KS = T::KS;
  constexpr int FR = BM / 8, FC = BN / 8, P = 32 / SK, LDT = T::LDT;
  constexpr int RI = Split<SK>::RI, CJ = Split<SK>::CJ;
  constexpr int NPOS = BM * DP / 64, DG = DP / 8;
  static_assert(P % FC == 0, "a row's lanes within a warp");
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                      // [BM][DP]
  float* dOs = Qs + BM * DP;            // [BM][DP]
  float* ring = dOs + BM * DP;          // 2 x [2][BN][DP]
  float* Pb = ring + 4 * BN * DP;       // [RI CJ][TG]: swapped halves
  float* dSt = Pb + BM * BN;            // [BN][LDT]: dS^T
  float* Ls = dSt + BN * LDT;           // [BM] LSE, log2 units
  float* Ds = Ls + BM;                  // [BM] D
  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & (TG - 1);
  int h, b, tile, nt;
  f32_unit(h, b, tile, nt);
  const int qt = F32_HEAVY_FIRST ? nt - 1 - tile : tile;
  const int q0 = qt * BM, hk = h / a.G, kend = kv_end(a, b);
  const size_t qs = (size_t)a.H * a.D, os = (size_t)a.H * a.Dv;
  const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
  const size_t row = (size_t)b * a.Lq * a.H + h;
  const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
  const float* q = static_cast<const float*>(a.q) + row * a.D;
  const float* o = static_cast<const float*>(a.o) + row * a.Dv;
  const float* dout = static_cast<const float*>(a.dout) + row * a.Dv;
  const float* k = static_cast<const float*>(a.k) + krow * a.D;
  const float* v = static_cast<const float*>(a.v) + krow * a.Dv;
  float* lse_row = a.lse + ((size_t)b * a.H + h) * a.ls;
  const float sl2 = a.scale * LOG2E;
  // score positions: warp-local lane l of split s = l / P
  const int lane = gt & 31, pos = (gt >> 5) * P + lane % P, s = lane / P;
  const int pr = pos / FC, pc = pos % FC;
  const int roff = Split<SK>::rows(s), coff = Split<SK>::cols(s);
  // dQ positions: rows 8 rg .. 8 rg + 7, chunks dg and dg + DG; key split kq
  const int dg = tid % NPOS % DG, rg = tid % NPOS / DG, kq = tid / NPOS;
  async_tile<DP, BM, VEC>(Qs, q + q0 * qs, qs, a.Lq - q0, a.D);
  async_tile<DP, BM, VEC>(dOs, dout + q0 * os, os, a.Lq - q0, a.Dv);
  const int nkt = (a.Lkv + BN - 1) / BN;
  auto next_live = [&](int kt) {
    while (kt < nkt && !tile_live(a, q0, q0 + BM, kt * BN, kt * BN + BN, kend))
      ++kt;
    return kt;
  };
  // a stage's job: pass 1 tiles t0 and t1 (t1 == nkt: none), pass 2 tile
  // t0; pass 0: none
  struct Job { int pass, t0, t1; };
  auto next_job = [&](Job j) -> Job {
    if (j.pass == 1) {
      const int t0 = j.t1 < nkt ? next_live(j.t1 + 1) : nkt;
      if (t0 < nkt) return {1, t0, next_live(t0 + 1)};
      return {2, next_live(0), nkt};
    }
    if (j.pass == 2) {
      const int t = next_live(j.t0 + 1);
      return t < nkt ? Job{2, t, nkt} : Job{0, 0, 0};
    }
    return j;
  };
  auto issue = [&](Job j, int st) {
    if (!j.pass) return;
    float* K0 = ring + st * 2 * BN * DP;
    float* K1 = K0 + BN * DP;
    const int k0 = j.t0 * BN;
    async_tile<DP, BN, VEC>(K0, k + k0 * ks, ks, a.Lkv - k0, a.D);
    if (j.pass == 2) {
      async_tile<DP, BN, VEC>(K1, v + k0 * vs, vs, a.Lkv - k0, a.Dv);
    } else if (j.t1 < nkt) {
      const int k1 = j.t1 * BN;
      async_tile<DP, BN, VEC>(K1, k + k1 * ks, ks, a.Lkv - k1, a.D);
    }
  };
  const int first = next_live(0);
  Job cur = first < nkt ? Job{1, first, next_live(first + 1)} : Job{0, 0, 0};
  issue(cur, 0);
  dsum_rows<DP, BM, VEC>(a, o, dout, os, q0, Ds,
                         a.dsum + ((size_t)b * a.H + h) * a.ls);
  // pass 1 state: each row's max and sum over this lane's keys
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) m[i] = -INFINITY, l[i] = 0.f;
  // (m, l) of two key sets merged into (m[i], l[i])
  auto merge = [&](int i, float mo, float lo) {
    const float mx = fmaxf(m[i], mo), base = mx == -INFINITY ? 0.f : mx;
    l[i] = l[i] * ex2(m[i] - base) + lo * ex2(mo - base);
    m[i] = mx;
  };
  // the LSE from the lanes' statistics and from A's and B's (B's through
  // Pb), into Ls and the scratch
  auto finish_lse = [&]() {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int off = 1; off < FC; off <<= 1)
        merge(i, __shfl_xor_sync(0xffffffffu, m[i], off),
              __shfl_xor_sync(0xffffffffu, l[i], off));
      if constexpr (SK >= 4)
        merge(i, __shfl_xor_sync(0xffffffffu, m[i], 2 * P),
              __shfl_xor_sync(0xffffffffu, l[i], 2 * P));
    }
    const bool writer = pc == 0 && coff == 0;
    if (grp == 1 && writer)
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = pr + FR * (roff + i);
        Pb[r] = m[i];
        Pb[BM + r] = l[i];
      }
    __syncthreads();
    if (grp == 0 && writer)
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = pr + FR * (roff + i);
        merge(i, Pb[r], Pb[BM + r]);
        const float lse = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;
        Ls[r] = lse;
        if (q0 + r < a.Lq) lse_row[q0 + r] = lse;
      }
    __syncthreads();
  };
  float dq[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[i][e] = 0.f;
  bool lse_done = false;
  int st = 0;
  while (cur.pass) {
    cp_async_wait_all();
    __syncthreads();          // stage st landed; stage st ^ 1 is free
    const Job nx = next_job(cur);
    issue(nx, st ^ 1);
    const float* K0 = ring + st * 2 * BN * DP;
    const float* K1 = K0 + BN * DP;
    float acc[8][8];
    if (cur.pass == 1) {
      const int t = grp ? cur.t1 : cur.t0;
      if (t < nkt) {
        score_frag<DP, FR, FC, SK, T::UNR_A>(Qs, grp ? K1 : K0, pr, pc, s,
                                             acc);
        reduce_scatter<SK, P>(acc, s);
        const int k0 = t * BN;
        const bool edge = !tile_full(a, q0, q0 + BM, k0, k0 + BN, kend) ||
                          k0 + BN > a.Lkv;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int r = pr + FR * (roff + i);
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            float x = acc[i][j] * sl2;
            if (edge && !allowed(a, q0 + r, k0 + pc + FC * (coff + j), kend))
              x = -INFINITY;
            acc[i][j] = x;
            mx = fmaxf(mx, x);
          }
          const float mn = fmaxf(m[i], mx), base = mn == -INFINITY ? 0.f : mn;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < CJ; ++j) sum += ex2(acc[i][j] - base);
          l[i] = l[i] * ex2(m[i] - base) + sum;
          m[i] = mn;
        }
      }
    } else {
      if (!lse_done) finish_lse(), lse_done = true;
      // A: S = Q K^T and P; B: dP = dO V^T and dS = P . (dP - D)
      score_frag<DP, FR, FC, SK, T::UNR_A>(grp ? dOs : Qs, grp ? K1 : K0, pr,
                                           pc, s, acc);
      reduce_scatter<SK, P>(acc, s);
      const int k0 = cur.t0 * BN;
      const bool edge = !tile_full(a, q0, q0 + BM, k0, k0 + BN, kend);
      swap_halves<RI, CJ>(acc, Pb, grp, gt,
                          [&](int i, int j, float sv, float dpv) {
        const int r = pr + FR * (roff + i), n = pc + FC * (coff + j);
        float p = ex2(fmaf(sv, sl2, -Ls[r]));
        if (edge && !allowed(a, q0 + r, k0 + n, kend)) p = 0.f;
        dSt[n * LDT + r] = p * (dpv - Ds[r]);
      });
      __syncthreads();
      outer_frag<DP, LDT, BN / KS>(dSt + 8 * rg, K0, kq * (BN / KS), dg, dq);
    }
    st ^= 1;
    cur = nx;
  }
  if (!lse_done) finish_lse();      // no live tile: every LSE is +inf
  cp_async_wait_all();
  __syncthreads();
  sum_splits<KS, NPOS>(dq, tid, ring);
  if (kq == 0)
    store_frag<DP>(static_cast<float*>(a.dq) + row * a.D + q0 * qs, qs,
                   8 * rg, a.Lq - q0, dg, a.D, a.scale, dq);
}

// (b): dk and dv for BNB keys of one kv head, over its G query heads
template <int DP, bool VEC>
__global__ void __launch_bounds__(TT, 1) bwd_dkv_f32(Args a) {
  using T = Tf32<DP>;
  constexpr int BN = T::BNB, BM = T::BMB, SK = T::SKB, RS = T::RS;
  constexpr int FR = BN / 8, FC = BM / 8, P = 32 / SK, LDP = T::LDP;
  constexpr int RI = Split<SK>::RI, CJ = Split<SK>::CJ;
  constexpr int NPOS = BN * DP / 64, DG = DP / 8;
  constexpr int STAGE = 2 * BM * DP + 2 * BM;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                      // [BN][DP]
  float* Vs = Ks + BN * DP;             // [BN][DP]
  float* ring = Vs + BN * DP;           // 2 x (Q, dO [BM][DP]; LSE, D [BM])
  float* Ps = ring + 2 * STAGE;         // [BM][LDP]: P
  float* dSs = Ps + BM * LDP;           // [BM][LDP]: dS
  float* Xb = dSs + BM * LDP;           // [RI CJ][TG]: swapped halves
  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & (TG - 1);
  int hk, b, kt, nt;
  f32_unit(hk, b, kt, nt);
  const int k0 = kt * BN, kend = kv_end(a, b);
  const size_t qs = (size_t)a.H * a.D, os = (size_t)a.H * a.Dv;
  const size_t ks = (size_t)a.Hkv * a.D, vs = (size_t)a.Hkv * a.Dv;
  const size_t krow = (size_t)b * a.Lkv * a.Hkv + hk;
  const float sl2 = a.scale * LOG2E;
  const int lane = gt & 31, pos = (gt >> 5) * P + lane % P, s = lane / P;
  const int pr = pos / FC, pc = pos % FC;
  const int roff = Split<SK>::rows(s), coff = Split<SK>::cols(s);
  // output positions: keys 8 kg .. 8 kg + 7, chunks dg and dg + DG; row
  // split rq
  const int dg = gt % NPOS % DG, kg = gt % NPOS / DG, rq = gt / NPOS;
  async_tile<DP, BN, VEC>(Ks, static_cast<const float*>(a.k) + krow * a.D +
                                  k0 * ks, ks, a.Lkv - k0, a.D);
  async_tile<DP, BN, VEC>(Vs, static_cast<const float*>(a.v) + krow * a.Dv +
                                  k0 * vs, vs, a.Lkv - k0, a.Dv);
  const int nqt = (a.Lq + BM - 1) / BM;
  auto next_live = [&](int qt) {
    while (qt < nqt && !tile_live(a, qt * BM, qt * BM + BM, k0, k0 + BN, kend))
      ++qt;
    return qt;
  };
  const int qfirst = next_live(0);
  // a stage's job: q tile qt of query head g; g == G: none
  struct Job { int g, qt; };
  auto next_job = [&](Job j) -> Job {
    const int t = next_live(j.qt + 1);
    return t < nqt ? Job{j.g, t} : Job{j.g + 1, qfirst};
  };
  auto issue = [&](Job j, int st) {
    if (j.g >= a.G) return;
    float* Qd = ring + st * STAGE;
    float* dOd = Qd + BM * DP;
    float* Ld = dOd + BM * DP;
    const int h = hk * a.G + j.g, q0 = j.qt * BM;
    const size_t row = (size_t)b * a.Lq * a.H + h;
    async_tile<DP, BM, VEC>(Qd, static_cast<const float*>(a.q) +
                                    row * a.D + q0 * qs, qs, a.Lq - q0, a.D);
    async_tile<DP, BM, VEC>(dOd, static_cast<const float*>(a.dout) +
                                     row * a.Dv + q0 * os, os, a.Lq - q0,
                            a.Dv);
    if (tid < 2 * BM) {
      const int r = tid % BM;
      const float* src = (tid < BM ? a.lse : a.dsum) +
                         ((size_t)b * a.H + h) * a.ls + q0 + r;
      cp_async4(Ld + tid, q0 + r < a.Lq ? src : a.lse,
                q0 + r < a.Lq ? 4 : 0);
    }
  };
  float acc[8][8], out[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) out[i][e] = 0.f;
  Job cur = qfirst < nqt ? Job{0, qfirst} : Job{a.G, 0};
  issue(cur, 0);
  int st = 0;
  while (cur.g < a.G) {
    cp_async_wait_all();
    __syncthreads();          // stage st landed; stage st ^ 1, P, dS free
    const Job nx = next_job(cur);
    issue(nx, st ^ 1);
    const float* Qt = ring + st * STAGE;
    const float* dOt = Qt + BM * DP;
    const float* Lt = dOt + BM * DP;
    const float* Dt = Lt + BM;
    // A: S^T = K Q^T and P^T; B: dP^T = V dO^T and dS^T
    score_frag<DP, FR, FC, SK, T::UNR_B>(grp ? Vs : Ks, grp ? dOt : Qt, pr, pc,
                                         s, acc);
    reduce_scatter<SK, P>(acc, s);
    const int q0 = cur.qt * BM;
    const bool edge = !tile_full(a, q0, q0 + BM, k0, k0 + BN, kend) ||
                      q0 + BM > a.Lq;
    swap_halves<RI, CJ>(acc, Xb, grp, gt,
                        [&](int i, int j, float sv, float dpv) {
      const int n = pr + FR * (roff + i), r = pc + FC * (coff + j);
      float p = ex2(fmaf(sv, sl2, -Lt[r]));
      if (edge && !allowed(a, q0 + r, k0 + n, kend)) p = 0.f;
      Ps[r * LDP + n] = p;
      dSs[r * LDP + n] = p * (dpv - Dt[r]);
    });
    __syncthreads();
    // A: dV += P^T dO; B: dK += dS^T Q
    outer_frag<DP, LDP, BM / RS>((grp ? dSs : Ps) + 8 * kg, grp ? Qt : dOt,
                                 rq * (BM / RS), dg, out);
    st ^= 1;
    cur = nx;
  }
  cp_async_wait_all();
  __syncthreads();
  sum_splits<RS, NPOS>(out, gt, ring + grp * (RS - 1) * NPOS * 64);
  if (rq == 0) {
    if (grp == 0)
      store_frag<DP>(static_cast<float*>(a.dv) + krow * a.Dv + k0 * vs, vs,
                     8 * kg, a.Lkv - k0, dg, a.Dv, 1.f, out);
    else
      store_frag<DP>(static_cast<float*>(a.dk) + krow * a.D + k0 * ks, ks,
                     8 * kg, a.Lkv - k0, dg, a.D, a.scale, out);
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

// A contiguous (B, L, Hn, D) bf16 tensor as a 4-D map (D, Hn, L, B): boxes
// of 64 columns x ``rows`` positions, 128-byte swizzle, zero fill past the
// tensor's extent (columns past D, positions past L).
static bool encode_rows(CUtensorMap* map, const void* ptr, int D, int Hn,
                        int L, int B, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hn, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[3] = {row, row * Hn, row * Hn * L};
  const cuuint32_t box[4] = {SLAB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one wgmma kernel: q and do in boxes of 64 rows, k and v of ``kv_rows``
template <typename Kern>
static cudaError_t run_tma(Kern kern, dim3 grid, int smem, int kv_rows,
                           const Args& a, cudaStream_t s) {
  // a runtime call first: it makes the device's primary context current
  // on this thread (autograd runs the backward on a thread of its own,
  // where none may be yet), which the driver's map encoding needs
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(&tq, a.q, a.D, a.H, a.Lq, a.B, TR) ||
      !encode_rows(&tk, a.k, a.D, a.Hkv, a.Lkv, a.B, kv_rows) ||
      !encode_rows(&tv, a.v, a.Dv, a.Hkv, a.Lkv, a.B, kv_rows) ||
      !encode_rows(&tdo, a.dout, a.Dv, a.H, a.Lq, a.B, TR))
    return cudaErrorInvalidValue;
  kern<<<grid, HTHREADS, smem, s>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

// the dynamic shared memory of the wgmma kernel of part 0 ((a)), 1 ((b))
// or 3 ((a) from a saved LSE, <96, 64> alone) at <DQP, DVP>: the pair up to
// 128, the wide pair past it; part 0 at <96, 64> launches (a) at <128, 64>
template <int DQP, int DVP>
constexpr int tma_smem(int part) {
  if constexpr (DQP > 128)
    return part ? WideKV<DQP, DVP>::SMEM
                : Tiles<DQP, DVP, dq_bk<DQP, DVP>()>::DQ_SMEM;
  else if constexpr (DQP == 96)
    return part == 3 ? Tiles<DQP, DVP>::DQ_SMEM
         : part ? Tiles<DQP, DVP>::DKV_SMEM : Tiles<128, DVP>::DQ_SMEM;
  else
    return part ? Tiles<DQP, DVP>::DKV_SMEM : Tiles<DQP, DVP>::DQ_SMEM;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<DQP>(), Int<DVP>()) at the widths a bf16 call at head dims D and
// Dv takes: 64 or 128 each up to 128, but Dq in (64, 96] with Dv <= 64
// (minicpm3's MLA) at the exact widths <96, 64>; past 128 <192, 128> or
// <256, 256>
template <typename F>
static auto at_widths(int D, int Dv, F f) {
  if (D > 128 || Dv > 128)
    return D <= 192 && Dv <= 128 ? f(Int<192>(), Int<128>())
                                 : f(Int<256>(), Int<256>());
  if (D <= 64)
    return Dv <= 64 ? f(Int<64>(), Int<64>()) : f(Int<64>(), Int<128>());
  if (D <= 96 && Dv <= 64) return f(Int<96>(), Int<64>());
  return Dv <= 64 ? f(Int<128>(), Int<64>()) : f(Int<128>(), Int<128>());
}

// the wgmma pair, Dq and Dv <= 128, with or without kv_valid_len. At
// <96, 64> (a) from a saved LSE is part 3, and part 0 (a call without one)
// takes (a) at <128, 64>: pass 1 recovers the LSE there
template <int DQP, int DVP, bool RAGGED>
static cudaError_t run_pair(const Args& a, int part, cudaStream_t s) {
  const dim3 qgrid(a.H, a.B, (a.Lq + 2 * TR - 1) / (2 * TR));
  if constexpr (DQP == 96) {
    if (part == 3)
      return run_tma(bwd_dq_lse_bf16<DQP, DVP, RAGGED>, qgrid,
                     tma_smem<DQP, DVP>(3), TR, a, s);
    if (part == 0)
      return run_tma(bwd_dq_bf16<128, DVP, RAGGED>, qgrid,
                     tma_smem<DQP, DVP>(0), TR, a, s);
  } else {
    if (part == 3) return cudaErrorInvalidValue;
    if (part == 0)
      return run_tma(bwd_dq_bf16<DQP, DVP, RAGGED>, qgrid,
                     tma_smem<DQP, DVP>(0), TR, a, s);
  }
  return run_tma(bwd_dkv_bf16<DQP, DVP, RAGGED>,
                 dim3(a.Hkv, a.B, (a.Lkv + 2 * TR - 1) / (2 * TR)),
                 tma_smem<DQP, DVP>(1), TR, a, s);
}

template <int DQP, int DVP>
static cudaError_t run_bf16(const Args& a, int part, cudaStream_t s) {
  return a.kvl ? run_pair<DQP, DVP, true>(a, part, s)
               : run_pair<DQP, DVP, false>(a, part, s);
}

// (b) at <256, 256> splits dK's and dV's columns across two CTAs where its
// grid of one CTA a key tile is at most SPLIT_PCT % of the SMs: twice the
// CTAs at 1.5x the products, faster at grids of 64-132 CTAs on 132 SMs and
// slower at 144 and more (PERF.md)
constexpr unsigned SPLIT_PCT = 100;

// the wide (b)'s SPLIT at <256, 256> for a grid of one CTA a key tile
static cudaError_t wide_split(dim3 grid, int* split) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *split = grid.x * grid.y * grid.z * 100 <= SPLIT_PCT * (unsigned)sms ? 2 : 1;
  return err;
}

// the wide wgmma pair, a head dim over 128
template <int DQP, int DVP>
static cudaError_t run_wide(const Args& a, int part, cudaStream_t s) {
  if (part == 0)
    return run_tma(bwd_dq_wide_bf16<DQP, DVP>,
                   dim3(a.H, a.B, (a.Lq + 2 * TR - 1) / (2 * TR)),
                   tma_smem<DQP, DVP>(0), dq_bk<DQP, DVP>(), a, s);
  const dim3 grid(a.Hkv, a.B, (a.Lkv + TR - 1) / TR);
  if constexpr (DQP == 256 && DVP == 256) {
    int split = 1;
    const cudaError_t err = wide_split(grid, &split);
    if (err != cudaSuccess) return err;
    if (split == 2)
      return run_tma(bwd_dkv_wide_bf16<DQP, DVP, 2>,
                     dim3(2 * grid.x, grid.y, grid.z),
                     tma_smem<DQP, DVP>(1), TR, a, s);
  }
  return run_tma(bwd_dkv_wide_bf16<DQP, DVP, 1>, grid,
                 tma_smem<DQP, DVP>(1), TR, a, s);
}

template <typename Kern>
static cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                          const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// the one-pass kernel's instance for the call: a 32 x 32 tile where both
// lengths are at most 32, else 64 x 64; the larger head dim padded to 64,
// 128 or (32 x 32 only) 256; one query head a kv head (the embedder's) or G
template <int T, int DP, bool GQA = true>
static cudaError_t run_one_pass(const Args& a, cudaStream_t s) {
  using C = OnePass<T, DP, GQA>;
  auto kern = a.vec ? bwd_one_pass_f32<T, DP, true, GQA>
                    : bwd_one_pass_f32<T, DP, false, GQA>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(a.Hkv, a.B), C::NT, C::SMEM, s>>>(a);
  return cudaGetLastError();
}

static cudaError_t run_one_pass_f32(const Args& a, cudaStream_t s) {
  const bool small = a.Lq <= 32 && a.Lkv <= 32;
  const int d = a.D > a.Dv ? a.D : a.Dv;
  if (d > 128)
    return small ? run_one_pass<32, 256>(a, s) : cudaErrorInvalidValue;
  if (d <= 64 && small && a.G == 1) return run_one_pass<32, 64, false>(a, s);
  if (d <= 64)
    return small ? run_one_pass<32, 64>(a, s) : run_one_pass<64, 64>(a, s);
  return small ? run_one_pass<32, 128>(a, s) : run_one_pass<64, 128>(a, s);
}

// the CUDA-core pair at the larger head dim padded to DP: (a) on a grid of
// one CTA a (q tile, head, sequence), (b) one a (key tile, kv head,
// sequence), the tile the slowest index where F32_HEAVY_FIRST holds
template <int DP>
static cudaError_t run_f32(const Args& a, int part, cudaStream_t s) {
  using T = Tf32<DP>;
  const int nt = part == 0 ? (a.Lq + T::BM - 1) / T::BM
                           : (a.Lkv + T::BNB - 1) / T::BNB;
  const int heads = part == 0 ? a.H : a.Hkv;
  const dim3 grid = F32_HEAVY_FIRST ? dim3(heads, a.B, nt)
                                    : dim3(nt, heads, a.B);
  if (part == 0)
    return launch(a.vec ? bwd_dq_f32<DP, true> : bwd_dq_f32<DP, false>,
                  grid, TT, T::DQ_SMEM, a, s);
  return launch(a.vec ? bwd_dkv_f32<DP, true> : bwd_dkv_f32<DP, false>,
                grid, TT, T::DKV_SMEM, a, s);
}

// DP: the larger head dim padded to 64, 128 or 256 (a call in (128, 192]
// runs at 256, zeros past its width)
static cudaError_t run_cc_f32(const Args& a, int part, cudaStream_t s) {
  const int d = a.D > a.Dv ? a.D : a.Dv;
  if (d <= 64) return run_f32<64>(a, part, s);
  if (d <= 128) return run_f32<128>(a, part, s);
  return run_f32<256>(a, part, s);
}

}  // namespace fab

// part 0 launches (a), which writes dq, lse and dsum; part 1 launches (b),
// which reads lse and dsum and writes dk and dv; part 2 launches the f32
// one-pass kernel, which writes dq, dk and dv and takes no lse or dsum
// (null), for Lq, Lkv <= 64 at head dims up to 128 and Lq, Lkv <= 32 up to
// 256; part 3 launches (a) from a saved LSE (bf16, Dq in (64, 96] with Dv
// <= 64 alone: lse holds what K4's training forward wrote), which reads lse
// and writes dq and dsum. All tensors contiguous (B, L, H, D) for q, k,
// dq, dk and (B, L, H, Dv) for v, o, do, dv; lse and dsum (B, H, Lq) f32,
// in bf16 (the wgmma pairs) (B, H, Lq rounded up to 64). kvl:
// kv_valid_len, int32 (B,), or null. bf16 takes D and Dv multiples of 8
// and 16-byte aligned bases; a bf16 call with D or Dv over 128 takes the
// wide pair. scale_dim is the
// head dim of the scale 1 / sqrt(scale_dim). Returns the launch's CUDA
// error code (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    const int* kvl, long long B, long long Lq, long long Lkv, long long H,
    long long Hkv, long long D, long long Dv, long long scale_dim,
    long long causal, long long window, long long prefix_len,
    long long q_offset, long long is_bf16, long long part, void* stream) {
  using namespace fab;
  if (B == 0 || Lq == 0 || H == 0 || Lkv == 0) return 0;
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || scale_dim < 1 || Hkv < 1 ||
      H % Hkv)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dq) |
                         reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv) |
                         reinterpret_cast<uintptr_t>(lse) |
                         reinterpret_cast<uintptr_t>(dsum);
  if (is_bf16 && (D % 8 || Dv % 8 || ((bases | outs) & 15)))
    return (int)cudaErrorInvalidValue;
  if (part < 0 || part > 3 ||
      (part == 3 && !(is_bf16 && D > 64 && D <= 96 && Dv <= 64)))
    return (int)cudaErrorInvalidValue;
  const int lmax = Lq > Lkv ? (int)Lq : (int)Lkv;
  if (part == 2 && (is_bf16 || lmax > (D > 128 || Dv > 128 ? 32 : 64)))
    return (int)cudaErrorInvalidValue;
  const int vec_elems = is_bf16 ? 8 : 4;
  // the one-pass kernel stores dq/dk/dv 16 bytes at a time where vec is
  // set, so its outputs' alignment counts too; the tiled pairs' does not
  const uintptr_t vec_ptrs = part == 2 ? (bases | outs) : bases;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, kvl,
         (int)B, (int)Lq, (int)Lkv, (int)H, (int)Hkv, (int)D, (int)Dv,
         (int)(H / Hkv), is_bf16 ? (int)((Lq + TR - 1) / TR * TR) : (int)Lq,
         (int)causal, (int)window, (int)prefix_len, (int)q_offset,
         (int)((vec_ptrs & 15) == 0 && D % vec_elems == 0 &&
               Dv % vec_elems == 0),
         1.0f / sqrtf((float)scale_dim)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = at_widths(a.D, a.Dv, [&](auto dq, auto dv) {
      constexpr int DQP = decltype(dq)::value, DVP = decltype(dv)::value;
      if constexpr (DQP > 128)
        return run_wide<DQP, DVP>(a, (int)part, s);
      else
        return run_bf16<DQP, DVP>(a, (int)part, s);
    });
  else if (part == 2)
    err = run_one_pass_f32(a, s);
  else
    err = run_cc_f32(a, (int)part, s);
  return (int)err;
}

// the dynamic shared memory (bytes) of the bf16 wgmma kernel that part 0
// ((a)), 1 ((b)) or 3 ((a) from a saved LSE) of a call at head dims D and
// Dv launches, or -1 outside them; nothing is launched (a build's checks
// log it beside ptxas's report)
extern "C" int flash_attention_bwd_smem(long long D, long long Dv,
                                        long long part) {
  using namespace fab;
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || part < 0 || part == 2 ||
      part > 3 || (part == 3 && !(D > 64 && D <= 96 && Dv <= 64)))
    return -1;
  return at_widths((int)D, (int)Dv, [&](auto dq, auto dv) {
    return tma_smem<decltype(dq)::value, decltype(dv)::value>((int)part);
  });
}

// the SPLIT (1 or 2) that (b) at <256, 256> runs a call of B sequences, Hkv
// kv heads and Lkv keys with on this device, or a negative CUDA error;
// nothing is launched (a check that a timed call took the instance the
// main path takes)
extern "C" int flash_attention_bwd_split(long long B, long long Hkv,
                                         long long Lkv) {
  using namespace fab;
  int split = 1;
  const cudaError_t err = wide_split(
      dim3((unsigned)Hkv, (unsigned)B, (unsigned)((Lkv + TR - 1) / TR)),
      &split);
  return err == cudaSuccess ? split : -(int)err;
}
