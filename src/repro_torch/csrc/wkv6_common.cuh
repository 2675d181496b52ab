// What K5 (wkv6.cu) and K5-bwd (wkv6_bwd.cu) share: the state checkpoint
// interval, f32 widening, cp.async row copies into a staging ring, and the
// reduce-scatter over a warp's lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv {

// K5 writes the state at the start of every CKT-step chunk when it is given
// a checkpoint buffer, (B, H, ceil(L / CKT), K, K) f32; K5-bwd restarts its
// recomputation of the states there
constexpr int CKT = 16;

__device__ __forceinline__ float widen(const float* p) { return *p; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// two consecutive elements (4- or 8-byte aligned)
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int cb) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  switch (cb) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
      break;
    default:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// A thread's share of copying rows in cb-byte chunks over n threads, fixed
// once per kernel so that a tile's copies cost no division: a row's `per`
// chunks (per <= n), n / per rows at a time, chunk `off` of rows r0,
// r0 + step, ...
struct RowCopy {
  int r0, step, off;
  __device__ RowCopy(int bytes, int cb, int tid, int n) {
    const int per = bytes / cb;
    step = n / per;
    r0 = tid < per * step ? tid / per : 1 << 30;   // the rest: nothing
    off = (tid % per) * cb;
  }
  __device__ __forceinline__ void run(unsigned char* dst, int pitch,
                                      const unsigned char* src,
                                      long long stride, int rows,
                                      int cb) const {
    for (int r = r0; r < rows; r += step)
      copy_chunk(dst + r * pitch + off, src + r * stride + off, cb);
  }
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A sum over the lanes whose index bits O, 2 O, ... below LG differ, of N
// values a lane: at lane bit O a lane keeps one half of its values (the
// upper where the bit is set), sends the other and adds what its partner
// sent; once one value is left, the remaining levels add it whole. Lane l
// ends with the sums of flat indices scatter_base<N, O, LG>(l) + m,
// m < max(1, N / (LG / O)), in yp[m].
template <int N, int O, int LG, int S>
__device__ __forceinline__ void reduce_scatter(float (&yp)[S], int lane) {
  if constexpr (O < LG) {
    if constexpr (N >= 2) {
      const bool hi = lane & O;
#pragma unroll
      for (int m = 0; m < N / 2; ++m) {
        const float send = hi ? yp[m] : yp[m + N / 2];
        const float keep = hi ? yp[m + N / 2] : yp[m];
        yp[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N / 2, 2 * O, LG, S>(yp, lane);
    } else {
      yp[0] += __shfl_xor_sync(0xffffffffu, yp[0], O);
      reduce_scatter<1, 2 * O, LG, S>(yp, lane);
    }
  }
}

template <int N, int O, int LG>
__device__ __forceinline__ int scatter_base(int lane) {
  int base = 0;
#pragma unroll
  for (int o = O, n = N; o < LG && n >= 2; o <<= 1, n >>= 1)
    if (lane & o) base += n / 2;
  return base;
}

}  // namespace wkv
