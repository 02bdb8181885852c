// Per-pulse median magnitude, median phase difference and saturated flag.
//
// Replaces two TPU kernels of sdr_channelizer_tpu/ops/pallas/
// pulse_stats_kernel.py, both behind its `pulse_stats` and
// `pulse_stats_dense`: `_stats_kernel` (K4, one slot tile a step), and
// `_stats_kernel_batched` (B10, `batch_tiles > 1`: live tiles only, from a
// list compacted on the device).  Both give the same bits.
//
// What it computes, for each slot (toa, te) of channel c: with
// plen = min(te - toa + 1, window), the median of mag_cm[c] over samples
// toa .. toa+plen-1 (the trailing edge included) and the median of dph_cm[c]
// over toa .. toa+plen-2, both cut at t_len; a median is the mean of the two
// middle order statistics in a sort's order (NaNs high, whatever their
// sign), NaN over nothing.  With a saturation mask sat_cm it also yields 1
// when any sample strictly inside the pulse, toa+1 .. toa+plen-2 cut at
// t_len, is saturated (> 0.5), else 0.  A slot with toa outside [0, t_len)
// is dead and yields 0 in every output.  The channel of slot s is chan[s]
// where a channel list is given (a flat slot list mixing channels), else the
// slot grid's row s / p_slots.
//
// What bounds it on an H100: bytes in principle (every live sample read
// once, a few bytes written per slot), but those take well under one
// launch; what is paid is the latency of the selection and of the launches.
//
// Design: the selection is sized to each pulse, and only live slots get
// work.
//  - The chunk kernel: a block of 16 warps takes a chunk of 32 slots (K4:
//    chunk blockIdx.x; B10: a quarter of the live tile that is entry
//    blockIdx.x / 4 of the list of live tiles, the block leaving past the
//    live count).  Its first warp reads the chunk's slots: a dead slot is
//    written 0 there; a live run of up to kShortKeys samples goes to one of
//    the chunk's lists in shared memory by its length (at most 8, 16, 32,
//    64 or 128 samples; a ballot each), a longer one to the list of the
//    select kernel in device memory (one atomic a warp).  The 16 warps then
//    take the chunk's short runs: four runs of up to 8 samples a warp, two
//    of up to 16, else one.  The keys stay in registers (one to four a
//    lane) and are sorted by a bitonic network over shuffles, in segments
//    of 8, 16 or 32 lanes or across the warp, and the two middle ranks are
//    read: no loop over bits, no shared memory for the keys.
//  - The select kernel: a persistent grid of blocks strides the list of
//    longer runs (its length read from device memory), a block a stream of
//    a slot.  The keys' top 12 bits are histogrammed in shared memory while
//    the run is read; the bins that hold ranks (n-1)/2 and n/2 are found;
//    then two digits of 10 bits over the keys under the lower middle's
//    prefix.  A run of up to kStretch keys is read once and kept in shared
//    memory; a longer one is read a second time, and only the keys of the
//    lower middle's 12-bit bin are compacted (into shared memory where they
//    fit, else into the block's scratch in device memory) and finished
//    there.  The upper middle follows the lower one while they share the
//    digits found; once its bin parts, it is that bin's least key (a min
//    during the next sweep), or at the last digit the bin itself.  A lane
//    adds a run of equal bins to the histogram with one atomic.
//  - The saturated flag is read in the same sweep as the interior's phase
//    steps: a ballot (short runs) or a block-wide OR (longer runs).
// No run length is refused.

#include "common.cuh"
#include <math.h>

namespace {

constexpr int kTile = 128;          // slots a tile, as the TPU kernel's TILE
constexpr int kChunk = 32;          // slots a chunk: a block of the chunk kernel
constexpr int kChunksPerTile = kTile / kChunk;
constexpr int kChunkWarps = 16;
constexpr int kChunkThreads = kChunkWarps * 32;
constexpr int kShortKeys = 128;     // runs up to this long stay in registers
constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kStretch = 8192;      // keys a select block holds in shared
constexpr int kBins = 4096;         // the first digit: key bits [31:20]
constexpr int kBins2 = 1024;        // the next two: [19:10] and [9:0]

struct StatsArgs {
  const float* mag_cm;
  const float* dph_cm;
  const int* toa;
  const int* te;
  const float* sat_cm;  // or null
  const int* chan;      // or null
  float* med_mag;
  float* med_dph;
  float* sat_any;       // with sat_cm
  int* n_big;           // runs longer than kShortKeys: their count ...
  int* big;             // ... and their slots
  long long row_stride;
  int n_slots;
  int p_slots;
  int window;
  int t_len;
};

// A slot's run: where it starts and its two lengths.
struct Run {
  size_t base;
  int n_mag;
  int n_dph;
  bool live;
};

__device__ __forceinline__ Run run_of(const StatsArgs& a, int slot) {
  Run r{0, 0, 0, false};
  const int i0 = a.toa[slot];
  if (i0 < 0 || i0 >= a.t_len) return r;
  const long long plen =
      min((long long)a.te[slot] - i0 + 1, (long long)a.window);
  r.live = true;
  r.n_mag = (int)max(min(i0 + plen, (long long)a.t_len) - i0, 0ll);
  r.n_dph = (int)max(min(i0 + plen - 1, (long long)a.t_len) - i0, 0ll);
  const int row = a.chan != nullptr ? a.chan[slot] : slot / a.p_slots;
  r.base = (size_t)row * a.row_stride + i0;
  return r;
}

// ------------------------------------------------------------- short runs

// Sorts keys held r*32+lane in k[r], ascending, in segments of W keys (W
// <= 32: W lanes, one register; else the whole warp, W / 32 registers): a
// bitonic network, the exchanges across lanes by shuffles, those across
// registers inside the lane.
template <int R, int W>
__device__ __forceinline__ void warp_sort(uint32_t (&k)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= W; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // the last merge of a segment ascends in every segment
        const bool up = size == W || ((r * 32 + lane) & size) == 0;
        if (stride >= 32) {
          const int rp = r ^ (stride >> 5);
          if (rp > r) {
            const uint32_t lo = min(k[r], k[rp]), hi = max(k[r], k[rp]);
            k[r] = up ? lo : hi;
            k[rp] = up ? hi : lo;
          }
        } else {
          const uint32_t o = __shfl_xor_sync(sdr::kFullMask, k[r], stride);
          const bool lower = (lane & stride) == 0;
          k[r] = lower == up ? min(k[r], o) : max(k[r], o);
        }
      }
    }
  }
}

// The key at place i (r*32+lane order) of the keys sorted by warp_sort; i
// may differ from lane to lane.
template <int R>
__device__ __forceinline__ uint32_t key_at(const uint32_t (&k)[R], int i) {
  uint32_t v = k[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if ((i >> 5) == r) v = k[r];
  return __shfl_sync(sdr::kFullMask, v, i & 31);
}

// The statistics of up to G = 32 / W slots whose runs hold at most W <= 32
// samples, W lanes a slot, or of one slot of at most W samples (W = 64,
// 128), by one warp.  A lane holds key q*32+j of its slot's runs in
// register q (j its place in the slot's lanes); places past a run hold the
// greatest key, so the run's keys sort first.  Both streams and the mask's
// interior are loaded before the sorts.
template <int W>
__device__ void stats_unit(const StatsArgs& a, const int* slots, int n_slots,
                           int lane) {
  constexpr int R = W < 32 ? 1 : W / 32;
  constexpr int L = W < 32 ? W : 32;  // lanes a slot
  const int g = lane / L, j = lane % L;
  const int slot = g < n_slots ? slots[g] : -1;
  const Run r = slot >= 0 ? run_of(a, slot) : Run{0, 0, 0, false};
  uint32_t km[R], kd[R];
  bool hit = false;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * 32 + j;
    km[q] = i < r.n_mag ? sdr::key_of(__ldg(a.mag_cm + r.base + i))
                        : 0xffffffffu;
    kd[q] = i < r.n_dph ? sdr::key_of(__ldg(a.dph_cm + r.base + i))
                        : 0xffffffffu;
    // strictly inside: positions 1 .. plen-2, which is 1 .. n_dph-1 once
    // cut at t_len (n_dph = min(plen-1, t_len-i0))
    if (a.sat_cm != nullptr)
      hit |= i >= 1 && i < r.n_dph && __ldg(a.sat_cm + r.base + i) > 0.5f;
  }
  warp_sort<R, W>(km, lane);
  warp_sort<R, W>(kd, lane);
  const int at = g * L;  // the slot's first lane
  const uint32_t m_lo = key_at<R>(km, at + (max(r.n_mag, 1) - 1) / 2);
  const uint32_t m_hi = key_at<R>(km, at + r.n_mag / 2);
  const uint32_t d_lo = key_at<R>(kd, at + (max(r.n_dph, 1) - 1) / 2);
  const uint32_t d_hi = key_at<R>(kd, at + r.n_dph / 2);
  const unsigned any = __ballot_sync(sdr::kFullMask, hit);
  if (slot < 0 || j != 0) return;
  a.med_mag[slot] = r.n_mag > 0 ? 0.5f * (sdr::f32_from_key(m_lo) +
                                          sdr::f32_from_key(m_hi))
                                : nanf("");
  a.med_dph[slot] = r.n_dph > 0 ? 0.5f * (sdr::f32_from_key(d_lo) +
                                          sdr::f32_from_key(d_hi))
                                : nanf("");
  if (a.sat_cm != nullptr) {
    const unsigned mine = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << at;
    a.sat_any[slot] = (any & mine) != 0u ? 1.0f : 0.0f;
  }
}

// the short runs' classes by length: at most 8, 16, 32, 64, 128 samples
constexpr int kClasses = 5;
__device__ __forceinline__ int class_of(int n) {
  return n <= 8 ? 0 : n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 3 : 4;
}
// slots a warp takes at once, by class
__host__ __device__ constexpr int per_unit(int c) {
  return c == 0 ? 4 : c == 1 ? 2 : 1;
}

// K4 (kBatched = false): chunk blockIdx.x.  B10: a quarter of the live tile
// tile_ids[blockIdx.x / 4]; blocks past the live count leave.
template <bool kBatched>
__global__ void __launch_bounds__(kChunkThreads)
    pulse_stats_chunk_kernel(StatsArgs a, const int* __restrict__ tile_ids,
                             const int* __restrict__ n_live) {
  __shared__ int s_list[kClasses][kChunk];
  __shared__ int s_cnt[kClasses];
  __shared__ int s_units[kClasses + 1];  // units before each class
  int chunk = blockIdx.x;
  if (kBatched) {
    if (chunk / kChunksPerTile >= *n_live) return;
    chunk = tile_ids[chunk / kChunksPerTile] * kChunksPerTile +
            chunk % kChunksPerTile;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const int slot = chunk * kChunk + lane;
    int cls = -1;
    bool is_big = false;
    if (slot < a.n_slots) {
      const Run r = run_of(a, slot);
      if (!r.live) {
        a.med_mag[slot] = 0.0f;
        a.med_dph[slot] = 0.0f;
        if (a.sat_cm != nullptr) a.sat_any[slot] = 0.0f;
      } else if (r.n_mag <= kShortKeys) {
        cls = class_of(r.n_mag);
      } else {
        is_big = true;
      }
    }
    const unsigned below = (1u << lane) - 1u;
    int units = 0;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      const unsigned bc = __ballot_sync(sdr::kFullMask, cls == c);
      if (cls == c) s_list[c][__popc(bc & below)] = slot;
      if (lane == 0) {
        s_cnt[c] = __popc(bc);
        s_units[c] = units;
      }
      units += (__popc(bc) + per_unit(c) - 1) / per_unit(c);
    }
    if (lane == 0) s_units[kClasses] = units;
    const unsigned bb = __ballot_sync(sdr::kFullMask, is_big);
    int at = 0;
    if (lane == 0 && bb != 0u) at = atomicAdd(a.n_big, __popc(bb));
    at = __shfl_sync(sdr::kFullMask, at, 0);
    if (is_big) a.big[at + __popc(bb & below)] = slot;
  }
  __syncthreads();
  const int n_units = s_units[kClasses];
  for (int u = warp; u < n_units; u += kChunkWarps) {
    int c = 0;
    while (u >= s_units[c + 1]) ++c;
    const int k = (u - s_units[c]) * per_unit(c);
    const int* list = s_list[c] + k;
    const int n = min(per_unit(c), s_cnt[c] - k);
    switch (c) {
      case 0: stats_unit<8>(a, list, n, lane); break;
      case 1: stats_unit<16>(a, list, n, lane); break;
      case 2: stats_unit<32>(a, list, n, lane); break;
      case 3: stats_unit<64>(a, list, n, lane); break;
      default: stats_unit<128>(a, list, n, lane); break;
    }
  }
}

// ------------------------------------------------------------ longer runs

// the select block's shared state
enum { kA, kBelow, kCntA, kB, kCnt, kNState };

// The bins of hist (n_bins, by the whole block) that hold ranks ra <= rb:
// s_st[kA] ra's bin, s_st[kBelow] the count below it, s_st[kCntA] its
// count, s_st[kB] rb's bin.  The bins are left zero for the next digit.
__device__ void find_bins(int* hist, int n_bins, int ra, int rb,
                          int* s_st, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = n_bins / kSelThreads;
  const int b0 = tid * per;
  int sum = 0;
  for (int j = 0; j < per; ++j) sum += hist[b0 + j];
  const int incl = sdr::warp_inclusive_sum(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = incl - sum;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  for (int j = 0; j < per; ++j) {
    const int c = hist[b0 + j];
    hist[b0 + j] = 0;
    if (ra >= base && ra < base + c) {
      s_st[kA] = b0 + j;
      s_st[kBelow] = base;
      s_st[kCntA] = c;
    }
    if (rb >= base && rb < base + c) s_st[kB] = b0 + j;
    base += c;
  }
  __syncthreads();
}

struct SelectShared {
  uint32_t* keys;  // kStretch keys (dynamic shared memory)
  int* hist;       // kBins
  int* st;         // kNState
  int* warp;       // kSelWarps
  uint32_t* min;   // one word
};

// A lane's adds to a histogram, one atomic for each run of adds to one bin
// (the samples of a pulse of steady amplitude share a bin or two, and one
// atomic a sample would queue on it).
struct BinRun {
  uint32_t bin = 0xffffffffu;
  int count = 0;
  __device__ __forceinline__ void add(int* hist, uint32_t b) {
    if (b == bin) {
      ++count;
      return;
    }
    if (count > 0) atomicAdd(&hist[bin], count);
    bin = b;
    count = 1;
  }
  __device__ __forceinline__ void flush(int* hist) {
    if (count > 0) atomicAdd(&hist[bin], count);
    count = 0;
  }
};

// f(i, valid, p[i], q[i]) for every i < n (valid) and a few past it (not
// valid, called so that a whole warp takes part), by the whole block with
// kSweep loads a thread in flight; q may be null (0 then).
constexpr int kSweep = 4;
template <class F>
__device__ __forceinline__ void sweep_run(const float* __restrict__ p,
                                          const float* __restrict__ q, int n,
                                          F f) {
  for (int i0 = 0; i0 < n; i0 += kSelThreads * kSweep) {
    float x[kSweep], y[kSweep];
#pragma unroll
    for (int j = 0; j < kSweep; ++j) {
      const int i = i0 + j * kSelThreads + (int)threadIdx.x;
      x[j] = i < n ? __ldg(p + i) : 0.0f;
      y[j] = q != nullptr && i < n ? __ldg(q + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSweep; ++j) {
      const int i = i0 + j * kSelThreads + (int)threadIdx.x;
      f(i, i < n, x[j], y[j]);
    }
  }
}

// Median of the n samples at p, by the whole block; with sat, *hit is
// whether a sample of sat[1 .. n-1] is saturated.  buf: the block's scratch
// in device memory (n keys), for a run longer than kStretch whose lower
// middle's 12-bit bin holds more than kStretch keys.
__device__ float block_median(const float* __restrict__ p, int n,
                              const float* __restrict__ sat, bool* hit,
                              uint32_t* buf, const SelectShared& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    *s.min = 0xffffffffu;
    s.st[kCnt] = 0;
  }
  __syncthreads();
  // the first read: the top 12 bits, the keys kept where they fit, the
  // mask's interior
  const bool keep = n <= kStretch;
  bool any = false;
  BinRun run;
  sweep_run(p, sat, n, [&](int i, bool valid, float x, float y) {
    if (!valid) return;
    const uint32_t k = sdr::key_of(x);
    run.add(s.hist, k >> 20);
    if (keep) s.keys[i] = k;
    any |= i >= 1 && y > 0.5f;
  });
  run.flush(s.hist);
  *hit = __syncthreads_or(any) != 0;
  if (n <= 0) return nanf("");
  const int k_lo = (n - 1) / 2, k_hi = n / 2;
  find_bins(s.hist, kBins, k_lo, k_hi, s.st, s.warp);
  const uint32_t a0 = s.st[kA], b0 = s.st[kB];
  const int c_a = s.st[kCntA];
  int rank = k_lo - s.st[kBelow];
  const int d = k_hi - k_lo;
  uint32_t pref = a0 << 20;
  // where hi's bin parts from lo's, hi is the least key under hi_pref
  int parted = b0 == a0 ? -1 : 0;
  uint32_t hi_pref = b0 << 20;
  __syncthreads();

  // digit 1, bits [19:10], of the keys under lo's 12-bit prefix; a long run
  // read a second time, those keys compacted
  const uint32_t* src = s.keys;
  int n_src = n;
  uint32_t least = 0xffffffffu;  // hi's least key, where it parted
  if (keep) {
    for (int i = tid; i < n; i += kSelThreads) {
      const uint32_t k = s.keys[i];
      if ((k >> 20) == a0) run.add(s.hist, (k >> 10) & 1023u);
      if (parted == 0 && (k >> 20) == b0) least = min(least, k);
    }
  } else {
    // a warp reserves its place in the buffer once for kSweep keys a lane
    uint32_t* dst = c_a <= kStretch ? s.keys : buf;
    for (int i0 = 0; i0 < n; i0 += kSelThreads * kSweep) {
      float x[kSweep];
#pragma unroll
      for (int j = 0; j < kSweep; ++j) {
        const int i = i0 + j * kSelThreads + tid;
        x[j] = i < n ? __ldg(p + i) : 0.0f;
      }
      unsigned take = 0u;
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kSweep; ++j) {
        const int i = i0 + j * kSelThreads + tid;
        const uint32_t k = sdr::key_of(x[j]);
        if (i < n && (k >> 20) == a0) {
          take |= 1u << j;
          ++mine;
          run.add(s.hist, (k >> 10) & 1023u);
        }
        if (parted == 0 && i < n && (k >> 20) == b0) least = min(least, k);
      }
      const int incl = sdr::warp_inclusive_sum(mine, lane);
      int at = 0;
      if (lane == 31 && incl > 0) at = atomicAdd(&s.st[kCnt], incl);
      at = __shfl_sync(sdr::kFullMask, at, 31) + incl - mine;
#pragma unroll
      for (int j = 0; j < kSweep; ++j)
        if (take & (1u << j)) dst[at++] = sdr::key_of(x[j]);
    }
    src = dst;
    n_src = c_a;
  }
  run.flush(s.hist);
  if (least != 0xffffffffu) atomicMin(s.min, least);
  __syncthreads();
  find_bins(s.hist, kBins2, rank, rank + (parted < 0 ? d : 0), s.st, s.warp);
  const uint32_t a1 = s.st[kA], b1 = s.st[kB];
  rank -= s.st[kBelow];
  if (parted < 0 && b1 != a1) {
    parted = 1;
    hi_pref = pref | (b1 << 10);
  }
  pref |= a1 << 10;
  __syncthreads();

  // digit 2, bits [9:0], of the keys under lo's 22-bit prefix
  for (int i = tid; i < n_src; i += kSelThreads) {
    const uint32_t k = src[i];
    if ((k & 0xfffffc00u) == pref) run.add(s.hist, k & 1023u);
    if (parted == 1 && (k & 0xfffffc00u) == hi_pref) least = min(least, k);
  }
  run.flush(s.hist);
  if (least != 0xffffffffu) atomicMin(s.min, least);
  __syncthreads();
  find_bins(s.hist, kBins2, rank, rank + (parted < 0 ? d : 0), s.st, s.warp);
  const uint32_t lo = pref | (uint32_t)s.st[kA];
  const uint32_t hi = parted < 0 ? pref | (uint32_t)s.st[kB] : *s.min;
  __syncthreads();  // the shared state is free for the block's next run
  return 0.5f * (sdr::f32_from_key(lo) + sdr::f32_from_key(hi));
}

// The runs longer than kShortKeys: task t is stream t & 1 (0 magnitude, 1
// phase step and the flag) of slot big[t >> 1], a block a task, the grid
// striding the 2 * n_big tasks.
__global__ void __launch_bounds__(kSelThreads)
    pulse_stats_select_kernel(StatsArgs a, uint32_t* scratch,
                              long long scratch_stride) {
  extern __shared__ uint32_t s_keys[];
  __shared__ int s_hist[kBins];
  __shared__ int s_st[kNState];
  __shared__ int s_warp[kSelWarps];
  __shared__ uint32_t s_min;
  const SelectShared s{s_keys, s_hist, s_st, s_warp, &s_min};
  uint32_t* buf = scratch != nullptr
                      ? scratch + (size_t)blockIdx.x * scratch_stride
                      : nullptr;
  for (int i = threadIdx.x; i < kBins; i += kSelThreads) s_hist[i] = 0;
  const int n_tasks = 2 * *a.n_big;
  for (int t = blockIdx.x; t < n_tasks; t += gridDim.x) {
    const int slot = a.big[t >> 1];
    const Run r = run_of(a, slot);
    const bool dph = (t & 1) != 0;
    const float* sat = dph && a.sat_cm != nullptr ? a.sat_cm + r.base
                                                  : nullptr;
    bool hit;
    const float med = block_median(
        (dph ? a.dph_cm : a.mag_cm) + r.base, dph ? r.n_dph : r.n_mag, sat,
        &hit, buf, s);
    if (threadIdx.x == 0) {
      (dph ? a.med_dph : a.med_mag)[slot] = med;
      if (sat != nullptr) a.sat_any[slot] = hit ? 1.0f : 0.0f;
    }
  }
}

// B10's list of live tiles (a tile: kTile slots, live where a slot's toa
// lies in [0, t_len)), by one block: tile_ids[0 .. n_live-1] the live
// tiles in order, -1 in the rest of its len places, *n_live the count.  A
// round takes kRoundTiles tiles: every thread reads its share of their
// slots (all loads in flight), marks their tiles, and a block scan ranks
// them.
constexpr int kListThreads = 1024;
constexpr int kRoundTiles = 256;
__global__ void __launch_bounds__(kListThreads)
    live_tiles_kernel(const int* __restrict__ toa, int n_slots, int t_len,
                      int len, int* __restrict__ tile_ids,
                      int* __restrict__ n_live) {
  constexpr int kPer = kRoundTiles * kTile / kListThreads;  // slots a thread
  __shared__ int s_flag[kRoundTiles];
  __shared__ int s_warp[kListThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (n_slots + kTile - 1) / kTile;
  int base = 0;  // live tiles before this round
  for (int t0 = 0; t0 < n_tiles; t0 += kRoundTiles) {
    if (tid < kRoundTiles) s_flag[tid] = 0;
    __syncthreads();
    const int s0 = t0 * kTile;
    int v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int slot = s0 + j * kListThreads + tid;
      v[j] = slot < n_slots ? __ldg(toa + slot) : -1;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (v[j] >= 0 && v[j] < t_len) s_flag[(j * kListThreads + tid) / kTile] = 1;
    __syncthreads();
    const int f = tid < kRoundTiles ? s_flag[tid] : 0;
    const int incl = sdr::warp_inclusive_sum(f, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < kListThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (f) tile_ids[before + incl - 1] = t0 + tid;
    base += total;
    __syncthreads();
  }
  for (int i = base + tid; i < len; i += kListThreads) tile_ids[i] = -1;
  if (tid == 0) *n_live = base;
}

}  // namespace

// mag_cm, dph_cm and, where given, sat_cm: (rows, row_stride) float32; toa,
// te: n_slots int32, a contiguous (M, p_slots) grid whose row is the channel
// when chan is null, else a flat list with chan: n_slots int32 (p_slots is
// then unused); med_mag, med_dph and, with sat_cm, sat_any: n_slots float32.
// big: n_slots + 1 int32 of scratch (the count of runs longer than
// kShortKeys, then their slots), needed where window > kShortKeys; scratch:
// select_blocks * scratch_stride uint32 (scratch_stride >= min(window,
// t_len)), needed where window > kStretch; select_blocks: the select
// kernel's persistent grid.  B10 where tiles is given: tile count + 1 int32
// of scratch for its list of live tiles (the count, then the tiles); the
// outputs of dead tiles are zeroed here.  Returns the cudaError_t of the
// first failing call.
extern "C" int sdr_pulse_stats(const void* mag_cm, const void* dph_cm,
                               const void* sat_cm, const void* toa,
                               const void* te, const void* chan, void* med_mag,
                               void* med_dph, void* sat_any,
                               long long row_stride, int n_slots, int p_slots,
                               int window, int t_len, void* big, void* scratch,
                               long long scratch_stride, int select_blocks,
                               void* tiles, void* stream) {
  if (n_slots <= 0) return 0;
  const bool longer = window > kShortKeys;
  const int reach = window < t_len ? window : t_len;
  if ((longer && (big == nullptr || select_blocks <= 0)) ||
      (window > kStretch && (scratch == nullptr || scratch_stride < reach)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  a.n_big = static_cast<int*>(big);
  a.big = longer ? static_cast<int*>(big) + 1 : nullptr;
  a.row_stride = row_stride;
  a.n_slots = n_slots;
  a.p_slots = p_slots > 0 ? p_slots : 1;
  a.window = window;
  a.t_len = t_len;
  cudaError_t err;
  if (longer && (err = cudaMemsetAsync(big, 0, sizeof(int), s)) != cudaSuccess)
    return (int)err;
  const int n_tiles = (n_slots + kTile - 1) / kTile;
  const int chunks = n_tiles * kChunksPerTile;
  if (tiles != nullptr) {
    // the outputs of dead tiles stay 0: one memset where they lie end to
    // end, as the wrapper allocates them
    const size_t bytes = (size_t)n_slots * sizeof(float);
    float* const ends[3] = {a.med_mag, a.med_dph, a.sat_any};
    const int n_out = sat_cm != nullptr ? 3 : 2;
    bool joined = true;
    for (int i = 1; i < n_out; ++i) joined &= ends[i] == ends[0] + i * (size_t)n_slots;
    for (int i = 0; i < (joined ? 1 : n_out); ++i)
      if ((err = cudaMemsetAsync(ends[i], 0, joined ? n_out * bytes : bytes,
                                 s)) != cudaSuccess)
        return (int)err;
    int* const list = static_cast<int*>(tiles);
    live_tiles_kernel<<<1, kListThreads, 0, s>>>(a.toa, n_slots, t_len,
                                                 n_tiles, list + 1, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pulse_stats_chunk_kernel<true><<<chunks, kChunkThreads, 0, s>>>(
        a, list + 1, list);
  } else {
    pulse_stats_chunk_kernel<false><<<chunks, kChunkThreads, 0, s>>>(
        a, nullptr, nullptr);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (!longer) return 0;
  const int bytes = kStretch * sizeof(uint32_t);
  err = cudaFuncSetAttribute(pulse_stats_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  pulse_stats_select_kernel<<<select_blocks, kSelThreads, bytes, s>>>(
      a, static_cast<uint32_t*>(scratch), scratch_stride);
  return (int)cudaGetLastError();
}

// B10's list of live tiles on the device, no host sync: toa, n_slots int32;
// tile_ids, len >= the tile count int32 (-1 past the live tiles); n_live,
// one int32.  Returns the cudaError_t of the launch.
extern "C" int sdr_live_tiles(const void* toa, int n_slots, int t_len,
                              int len, void* tile_ids, void* n_live,
                              void* stream) {
  live_tiles_kernel<<<1, kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(toa), n_slots, t_len, len,
      static_cast<int*>(tile_ids), static_cast<int*>(n_live));
  return (int)cudaGetLastError();
}
