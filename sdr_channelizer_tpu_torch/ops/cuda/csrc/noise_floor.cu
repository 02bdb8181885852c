// Exact per-channel median of the channel-major magnitude stream.
//
// Replaces the TPU kernel `_nf_kernel`
// (sdr_channelizer_tpu/ops/pallas/nf_kernel.py, `pallas_noise_floor_cm`).
//
// What it computes: for each row of mag_cm (R, row_stride), over its first
// t_len columns, lo = the order statistic of rank (t_len-1)/2, hi = that of
// rank t_len/2, and 0.5 * (lo + hi): bit for bit the median a sort gives.
// NaN for t_len = 0.
//
// What bounds it on an H100: bytes.  The function reads each value once
// (R * t_len * 4 bytes) and writes R floats; a selection has to see the row
// several times, and a row of a few hundred thousand floats is too large for
// shared memory but stays in the 50 MB L2 between passes.
//
// Design: a radix select on order-preserving u32 keys, eight bits a pass.
// One block owns one row.  Each pass histograms the byte below the prefix
// found so far, of the keys that match that prefix, into per-warp shared
// memory histograms (int32 counts, so no 2^24 bound), then the block walks
// the 256 bins to the one that holds the wanted rank.  After four passes
// the prefix is lo's key, and the passes have also counted the keys <= lo.
// Only when that count does not cover rank t_len/2 a fifth pass takes the
// smallest key above lo.  One block a row fills R of the card's 132
// multiprocessors; splitting rows over blocks is left for later.

#include "common.cuh"
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__global__ void __launch_bounds__(kThreads)
noise_floor_kernel(const float* __restrict__ mag_cm, float* __restrict__ out,
                   long long row_stride, int t_len) {
  __shared__ int hist[kWarps][kBins];
  __shared__ int bins[kBins];
  __shared__ uint32_t s_prefix;
  __shared__ int s_rank;     // rank still wanted among the matching keys
  __shared__ int s_cnt_le;   // keys <= the selected key, once known
  __shared__ uint32_t s_min[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = mag_cm + (size_t)blockIdx.x * row_stride;

  if (t_len <= 0) {
    if (tid == 0) out[blockIdx.x] = nanf("");
    return;
  }
  const int k_lo = (t_len - 1) / 2, k_hi = t_len / 2;
  if (tid == 0) {
    s_prefix = 0u;
    s_rank = k_lo;
    s_cnt_le = 0;
  }

  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = lane; b < kBins; b += 32) hist[warp][b] = 0;
    __syncthreads();  // also publishes s_prefix / s_rank of the last pass
    const uint32_t prefix = s_prefix;
    // bits above the byte under examination
    const uint32_t himask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    for (int t = tid; t < t_len; t += kThreads) {
      const uint32_t key = sdr::key_from_f32(row[t]);
      if ((key & himask) == prefix)
        atomicAdd(&hist[warp][(key >> shift) & 0xff], 1);
    }
    __syncthreads();
    if (tid < kBins) {
      int c = 0;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) c += hist[w][tid];
      bins[tid] = c;
    }
    __syncthreads();
    if (tid == 0) {
      int rank = s_rank, below = 0, b = 0;
      while (b < kBins - 1 && below + bins[b] <= rank) below += bins[b++];
      s_rank = rank - below;
      s_prefix = prefix | ((uint32_t)b << shift);
      // keys below the chosen bin are below lo whatever follows
      s_cnt_le += below;
      if (pass == 3) s_cnt_le += bins[b];  // the keys equal to lo
    }
    __syncthreads();
  }

  const uint32_t lo_key = s_prefix;
  const float lo = sdr::f32_from_key(lo_key);
  float hi = lo;
  if (s_cnt_le <= k_hi) {
    // rank k_hi lies above every copy of lo: the smallest key above it
    uint32_t m = 0xffffffffu;
    for (int t = tid; t < t_len; t += kThreads) {
      const uint32_t key = sdr::key_from_f32(row[t]);
      if (key > lo_key && key < m) m = key;
    }
    m = sdr::warp_min_u32(m);
    if (lane == 0) s_min[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = s_min[lane];
      m = sdr::warp_min_u32(m);
      if (lane == 0) s_min[0] = m;
    }
    __syncthreads();
    hi = sdr::f32_from_key(s_min[0]);
  }
  if (tid == 0) out[blockIdx.x] = 0.5f * (lo + hi);
}

}  // namespace

// mag_cm: (rows, row_stride) float32, the first t_len columns of each row
// are read; out: (rows,) float32.  Returns the launch's cudaError_t.
extern "C" int sdr_noise_floor_cm(const void* mag_cm, void* out, int rows,
                                  long long row_stride, int t_len,
                                  void* stream) {
  if (rows <= 0) return 0;
  noise_floor_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag_cm), static_cast<float*>(out), row_stride,
      t_len);
  return (int)cudaGetLastError();
}
