// Helpers shared by the hand-written kernels: order-preserving u32 keys of
// IEEE-754 floats (`key_of`: the total order a sort gives, NaNs high) and
// warp scans.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdr {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t key_from_f32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// The key of x in a sort's order: every NaN, whatever its sign, above +inf.
__device__ __forceinline__ uint32_t key_of(float x) {
  return isnan(x) ? 0xffffffffu : key_from_f32(x);
}

__device__ __forceinline__ float f32_from_key(uint32_t k) {
  uint32_t raw = (k >> 31) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(raw);
}

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int o = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ uint32_t warp_min_u32(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o = __shfl_xor_sync(kFullMask, v, off);
    v = o < v ? o : v;
  }
  return v;
}

}  // namespace sdr
