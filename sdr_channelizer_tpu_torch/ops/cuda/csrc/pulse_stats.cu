// Per-pulse median magnitude, median phase difference and saturated flag.
//
// Replaces the TPU kernel `_stats_kernel`
// (sdr_channelizer_tpu/ops/pallas/pulse_stats_kernel.py, `pulse_stats` and
// `pulse_stats_dense`).
//
// What it computes, for each slot (toa, te) of channel c: with
// plen = min(te - toa + 1, window), the median of mag_cm[c] over samples
// toa .. toa+plen-1 (the trailing edge included) and the median of dph_cm[c]
// over toa .. toa+plen-2, both cut at t_len; a median is the mean of the two
// middle order statistics, NaN over nothing.  With a saturation mask sat_cm
// it also yields 1 when any sample strictly inside the pulse, toa+1 ..
// toa+plen-2 cut at t_len, is saturated (> 0.5), else 0.  A slot with toa
// outside [0, t_len) is dead and yields 0 in every output.  The channel of
// slot s is chan[s] where a channel list is given (a flat slot list mixing
// channels), else the slot grid's row s / p_slots.
//
// What bounds it on an H100: bytes in principle (every live sample read
// once, eight bytes written per slot), but the work is a few kilobytes per
// pulse, so what is paid is the latency of the selection.
//
// Design: a warp per slot, no block-wide synchronisation.  Dead slots leave
// at once, so the grid is simply every slot and no list of live slots has
// to be built on the host.  A live slot's samples are a contiguous run of
// its channel's row: the warp reads them coalesced, turns them into
// order-preserving u32 keys and keeps them in its own stretch of shared
// memory (window * 4 bytes a warp, so any window up to the shared memory of
// a block works: no bound like the TPU's row count).  The median is a radix
// select over the key bits, most significant first: per bit each lane counts
// its candidates with the bit clear, a shuffle reduction sums the counts,
// and the wanted rank decides the bit.  That yields the lower middle; one
// more sweep counts the keys <= it and takes the smallest key above it,
// which gives the upper middle without a second descent.  The saturated
// flag is one more coalesced sweep over the interior and a ballot: no
// selection pass.

#include "common.cuh"
#include <math.h>

namespace {

// Median of the n keys in `keys` (one warp's shared memory stretch).
__device__ float warp_median(const uint32_t* keys, int n, int lane) {
  if (n <= 0) return nanf("");
  const int k_lo = (n - 1) / 2, k_hi = n / 2;
  uint32_t prefix = 0u;
  int rank = k_lo;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t b = 1u << bit;
    const uint32_t himask = bit == 31 ? 0u : (0xffffffffu << (bit + 1));
    int c = 0;  // candidates (matching the prefix) whose bit is clear
    for (int i = lane; i < n; i += 32) {
      const uint32_t k = keys[i];
      c += ((k & himask) == prefix && (k & b) == 0u) ? 1 : 0;
    }
    c = sdr::warp_sum(c);
    if (rank >= c) {
      rank -= c;
      prefix |= b;
    }
  }
  // prefix is the key of rank k_lo
  int cnt_le = 0;
  uint32_t above = 0xffffffffu;
  for (int i = lane; i < n; i += 32) {
    const uint32_t k = keys[i];
    cnt_le += k <= prefix ? 1 : 0;
    if (k > prefix && k < above) above = k;
  }
  cnt_le = sdr::warp_sum(cnt_le);
  above = sdr::warp_min_u32(above);
  const float lo = sdr::f32_from_key(prefix);
  const float hi = cnt_le > k_hi ? lo : sdr::f32_from_key(above);
  return 0.5f * (lo + hi);
}

__global__ void pulse_stats_kernel(const float* __restrict__ mag_cm,
                                   const float* __restrict__ dph_cm,
                                   const int* __restrict__ toa,
                                   const int* __restrict__ te,
                                   const float* __restrict__ sat_cm,  // or null
                                   const int* __restrict__ chan,      // or null
                                   float* __restrict__ med_mag,
                                   float* __restrict__ med_dph,
                                   float* __restrict__ sat_any,  // with sat_cm
                                   long long row_stride, int n_slots,
                                   int p_slots, int window, int t_len) {
  extern __shared__ uint32_t s_keys[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slot = blockIdx.x * warps + warp;
  if (slot >= n_slots) return;
  const int i0 = toa[slot];
  if (i0 < 0 || i0 >= t_len) {  // dead slot
    if (lane == 0) {
      med_mag[slot] = 0.0f;
      med_dph[slot] = 0.0f;
      if (sat_cm != nullptr) sat_any[slot] = 0.0f;
    }
    return;
  }
  const int plen = min(te[slot] - i0 + 1, window);
  const int n_mag = max(min(i0 + plen, t_len) - i0, 0);
  const int n_dph = max(min(i0 + plen - 1, t_len) - i0, 0);
  const int row = chan != nullptr ? chan[slot] : slot / p_slots;
  const size_t base = (size_t)row * row_stride + i0;
  uint32_t* keys = s_keys + (size_t)warp * window;

  for (int i = lane; i < n_mag; i += 32)
    keys[i] = sdr::key_from_f32(mag_cm[base + i]);
  __syncwarp();
  const float mm = warp_median(keys, n_mag, lane);
  __syncwarp();
  for (int i = lane; i < n_dph; i += 32)
    keys[i] = sdr::key_from_f32(dph_cm[base + i]);
  __syncwarp();
  const float dd = warp_median(keys, n_dph, lane);
  if (lane == 0) {
    med_mag[slot] = mm;
    med_dph[slot] = dd;
  }
  if (sat_cm != nullptr) {
    // strictly inside: positions 1 .. plen-2, which is 1 .. n_dph-1 once cut
    // at t_len (n_dph = min(plen-1, t_len-i0))
    bool hit = false;
    for (int i = 1 + lane; i < n_dph; i += 32)
      hit |= sat_cm[base + i] > 0.5f;
    const unsigned any = __ballot_sync(sdr::kFullMask, hit);
    if (lane == 0) sat_any[slot] = any != 0u ? 1.0f : 0.0f;
  }
}

}  // namespace

// mag_cm, dph_cm and, where given, sat_cm: (rows, row_stride) float32; toa,
// te: n_slots int32, a contiguous (M, p_slots) grid whose row is the channel
// when chan is null, else a flat list with chan: n_slots int32 (p_slots is
// then unused); med_mag, med_dph and, with sat_cm, sat_any: n_slots float32.
// warps_per_block * window * 4 bytes of dynamic shared memory must fit a
// block.  Returns the cudaError_t of the first failing call.
extern "C" int sdr_pulse_stats(const void* mag_cm, const void* dph_cm,
                               const void* sat_cm, const void* toa,
                               const void* te, const void* chan, void* med_mag,
                               void* med_dph, void* sat_any,
                               long long row_stride, int n_slots, int p_slots,
                               int window, int t_len, int warps_per_block,
                               void* stream) {
  if (n_slots <= 0) return 0;
  const size_t bytes = (size_t)warps_per_block * window * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pulse_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_slots + warps_per_block - 1) / warps_per_block;
  pulse_stats_kernel<<<blocks, warps_per_block * 32, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag_cm), static_cast<const float*>(dph_cm),
      static_cast<const int*>(toa), static_cast<const int*>(te),
      static_cast<const float*>(sat_cm), static_cast<const int*>(chan),
      static_cast<float*>(med_mag), static_cast<float*>(med_dph),
      static_cast<float*>(sat_any), row_stride, n_slots, p_slots > 0 ? p_slots : 1,
      window, t_len);
  return (int)cudaGetLastError();
}
