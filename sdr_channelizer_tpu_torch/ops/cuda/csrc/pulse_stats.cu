// Per-pulse median magnitude, median phase difference and saturated flag.
//
// Replaces two TPU kernels of sdr_channelizer_tpu/ops/pallas/
// pulse_stats_kernel.py, both behind its `pulse_stats` and
// `pulse_stats_dense`: `_stats_kernel` (K4, one slot tile a step) with
// `pulse_stats_kernel`, and `_stats_kernel_batched` (B10, `batch_tiles > 1`:
// nt live tiles a step over a compacted list of live tiles) with
// `pulse_stats_batched_kernel`.  Both give the same bits.
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
// Design: a warp per slot, no block-wide synchronisation.  A live slot's
// samples are a contiguous run of its channel's row: the warp reads them
// coalesced, turns them into order-preserving u32 keys and keeps them in its
// own stretch of shared memory.  The median is a radix select over the key
// bits, most significant first: per bit each lane counts its candidates with
// the bit clear, a shuffle reduction sums the counts, and the wanted rank
// decides the bit.  That yields the lower middle; one more sweep counts the
// keys <= it and takes the smallest key above it, which gives the upper
// middle without a second descent.  The saturated flag is one more coalesced
// sweep over the interior and a ballot: no selection pass.
//
// Any window: the stretch is sized by what fits (`stretch` keys a warp, the
// wrapper's choice), not by the window.  A slot whose run is longer than
// the stretch is selected the same way with its keys made on the fly from
// the stream in device memory (each pass a coalesced sweep of the run; the
// run stays in L2), so no window is refused and short pulses keep the
// shared-memory path whatever the window.
//
// B10: the grid is one block per batch of nt slot tiles (128 slots a
// tile).  The list of live tiles is built on the device before the launch
// (a cumsum rank and a scatter, no host sync); a block reads the live count
// and leaves when its batch lies past it, and its warps take the batch's
// nt * 128 slots in turn, each through K4's per-slot code.  Dead tiles are
// never visited: the wrapper hands in zeroed outputs.

#include "common.cuh"
#include <math.h>

namespace {

constexpr int kTile = 128;  // slots a tile, as the TPU kernel's TILE

// Keys from a warp's stretch of shared memory.
struct SmemKeys {
  const uint32_t* k;
  __device__ __forceinline__ uint32_t operator()(int i) const { return k[i]; }
};

// Keys made on the fly from a run of a stream in device memory.
struct GlobalKeys {
  const float* p;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return sdr::key_from_f32(__ldg(p + i));
  }
};

// Median of the n keys that `keys(i)` yields, by one warp.
template <class Keys>
__device__ float warp_median(Keys keys, int n, int lane) {
  if (n <= 0) return nanf("");
  const int k_lo = (n - 1) / 2, k_hi = n / 2;
  uint32_t prefix = 0u;
  int rank = k_lo;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t b = 1u << bit;
    const uint32_t himask = bit == 31 ? 0u : (0xffffffffu << (bit + 1));
    int c = 0;  // candidates (matching the prefix) whose bit is clear
    for (int i = lane; i < n; i += 32) {
      const uint32_t k = keys(i);
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
    const uint32_t k = keys(i);
    cnt_le += k <= prefix ? 1 : 0;
    if (k > prefix && k < above) above = k;
  }
  cnt_le = sdr::warp_sum(cnt_le);
  above = sdr::warp_min_u32(above);
  const float lo = sdr::f32_from_key(prefix);
  const float hi = cnt_le > k_hi ? lo : sdr::f32_from_key(above);
  return 0.5f * (lo + hi);
}

struct StatsArgs {
  const float* mag_cm;
  const float* dph_cm;
  const int* toa;
  const int* te;
  const float* sat_cm;  // or null
  const int* chan;      // or null
  float* med_mag;
  float* med_dph;
  float* sat_any;  // with sat_cm
  long long row_stride;
  int n_slots;
  int p_slots;
  int window;
  int t_len;
  int stretch;  // keys a warp holds in shared memory
};

// The statistics of one slot, by one warp; `keys` is the warp's stretch.
__device__ void stats_slot(const StatsArgs& a, int slot, uint32_t* keys,
                           int lane) {
  const int i0 = a.toa[slot];
  if (i0 < 0 || i0 >= a.t_len) {  // dead slot
    if (lane == 0) {
      a.med_mag[slot] = 0.0f;
      a.med_dph[slot] = 0.0f;
      if (a.sat_cm != nullptr) a.sat_any[slot] = 0.0f;
    }
    return;
  }
  const int plen = min(a.te[slot] - i0 + 1, a.window);
  const int n_mag = max(min(i0 + plen, a.t_len) - i0, 0);
  const int n_dph = max(min(i0 + plen - 1, a.t_len) - i0, 0);
  const int row = a.chan != nullptr ? a.chan[slot] : slot / a.p_slots;
  const size_t base = (size_t)row * a.row_stride + i0;

  float mm, dd;
  if (n_mag <= a.stretch) {
    for (int i = lane; i < n_mag; i += 32)
      keys[i] = sdr::key_from_f32(a.mag_cm[base + i]);
    __syncwarp();
    mm = warp_median(SmemKeys{keys}, n_mag, lane);
    __syncwarp();
    for (int i = lane; i < n_dph; i += 32)
      keys[i] = sdr::key_from_f32(a.dph_cm[base + i]);
    __syncwarp();
    dd = warp_median(SmemKeys{keys}, n_dph, lane);
    __syncwarp();  // the stretch is free for the warp's next slot
  } else {
    mm = warp_median(GlobalKeys{a.mag_cm + base}, n_mag, lane);
    dd = warp_median(GlobalKeys{a.dph_cm + base}, n_dph, lane);
  }
  if (lane == 0) {
    a.med_mag[slot] = mm;
    a.med_dph[slot] = dd;
  }
  if (a.sat_cm != nullptr) {
    // strictly inside: positions 1 .. plen-2, which is 1 .. n_dph-1 once cut
    // at t_len (n_dph = min(plen-1, t_len-i0))
    bool hit = false;
    for (int i = 1 + lane; i < n_dph; i += 32)
      hit |= a.sat_cm[base + i] > 0.5f;
    const unsigned any = __ballot_sync(sdr::kFullMask, hit);
    if (lane == 0) a.sat_any[slot] = any != 0u ? 1.0f : 0.0f;
  }
}

// K4: a warp per slot over every slot.
__global__ void pulse_stats_kernel(StatsArgs a) {
  extern __shared__ uint32_t s_keys[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slot = blockIdx.x * warps + warp;
  if (slot >= a.n_slots) return;
  stats_slot(a, slot, s_keys + (size_t)warp * a.stretch, lane);
}

// B10: block b takes the live tiles tile_ids[b*nt .. b*nt+nt-1] (-1 past
// the live ones) and leaves when b*nt is past the live count.
__global__ void pulse_stats_batched_kernel(StatsArgs a,
                                           const int* __restrict__ tile_ids,
                                           const int* __restrict__ n_live,
                                           int nt) {
  extern __shared__ uint32_t s_keys[];
  const int b = blockIdx.x;
  if (b * nt >= *n_live) return;  // a batch past the live count does nothing
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t* keys = s_keys + (size_t)warp * a.stretch;
  for (int s = warp; s < nt * kTile; s += warps) {
    const int tile = tile_ids[b * nt + s / kTile];
    if (tile < 0) continue;
    const int slot = tile * kTile + s % kTile;
    if (slot >= a.n_slots) continue;
    stats_slot(a, slot, keys, lane);
  }
}

StatsArgs make_args(const void* mag_cm, const void* dph_cm,
                    const void* sat_cm, const void* toa, const void* te,
                    const void* chan, void* med_mag, void* med_dph,
                    void* sat_any, long long row_stride, int n_slots,
                    int p_slots, int window, int t_len, int stretch) {
  StatsArgs a;
  a.mag_cm = static_cast<const float*>(mag_cm);
  a.dph_cm = static_cast<const float*>(dph_cm);
  a.toa = static_cast<const int*>(toa);
  a.te = static_cast<const int*>(te);
  a.sat_cm = static_cast<const float*>(sat_cm);
  a.chan = static_cast<const int*>(chan);
  a.med_mag = static_cast<float*>(med_mag);
  a.med_dph = static_cast<float*>(med_dph);
  a.sat_any = static_cast<float*>(sat_any);
  a.row_stride = row_stride;
  a.n_slots = n_slots;
  a.p_slots = p_slots > 0 ? p_slots : 1;
  a.window = window;
  a.t_len = t_len;
  a.stretch = stretch;
  return a;
}

}  // namespace

// mag_cm, dph_cm and, where given, sat_cm: (rows, row_stride) float32; toa,
// te: n_slots int32, a contiguous (M, p_slots) grid whose row is the channel
// when chan is null, else a flat list with chan: n_slots int32 (p_slots is
// then unused); med_mag, med_dph and, with sat_cm, sat_any: n_slots float32.
// Each warp holds `stretch` keys in shared memory (warps_per_block * stretch
// * 4 bytes of dynamic shared memory must fit a block); a slot longer than
// that is selected from device memory.  Returns the cudaError_t of the first
// failing call.
extern "C" int sdr_pulse_stats(const void* mag_cm, const void* dph_cm,
                               const void* sat_cm, const void* toa,
                               const void* te, const void* chan, void* med_mag,
                               void* med_dph, void* sat_any,
                               long long row_stride, int n_slots, int p_slots,
                               int window, int t_len, int stretch,
                               int warps_per_block, void* stream) {
  if (n_slots <= 0) return 0;
  const size_t bytes = (size_t)warps_per_block * stretch * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pulse_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_slots + warps_per_block - 1) / warps_per_block;
  pulse_stats_kernel<<<blocks, warps_per_block * 32, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      make_args(mag_cm, dph_cm, sat_cm, toa, te, chan, med_mag, med_dph,
                sat_any, row_stride, n_slots, p_slots, window, t_len,
                stretch));
  return (int)cudaGetLastError();
}

// B10, the same arguments plus: tile_ids, n_batches * nt int32 live tile
// indices in order, -1 past the live ones; n_live, one int32 (the live tile
// count) in device memory.  The outputs must be zeroed: dead tiles are not
// visited.
extern "C" int sdr_pulse_stats_batched(
    const void* mag_cm, const void* dph_cm, const void* sat_cm,
    const void* toa, const void* te, const void* chan, void* med_mag,
    void* med_dph, void* sat_any, long long row_stride, int n_slots,
    int p_slots, int window, int t_len, int stretch, int warps_per_block,
    const void* tile_ids, const void* n_live, int nt, int n_batches,
    void* stream) {
  if (n_slots <= 0 || n_batches <= 0) return 0;
  const size_t bytes = (size_t)warps_per_block * stretch * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pulse_stats_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  pulse_stats_batched_kernel<<<n_batches, warps_per_block * 32, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      make_args(mag_cm, dph_cm, sat_cm, toa, te, chan, med_mag, med_dph,
                sat_any, row_stride, n_slots, p_slots, window, t_len,
                stretch),
      static_cast<const int*>(tile_ids), static_cast<const int*>(n_live), nt);
  return (int)cudaGetLastError();
}
