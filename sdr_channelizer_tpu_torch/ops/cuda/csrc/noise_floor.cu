// Exact median of each row of a float32 matrix: the channel-major noise
// floor, and any 1-D magnitude viewed as one row.
//
// Replaces the TPU kernel `_nf_kernel`
// (sdr_channelizer_tpu/ops/pallas/nf_kernel.py, `pallas_noise_floor_cm`).
//
// What it computes: for each row of mag (R, row_stride), over its first
// t_len columns, lo = the order statistic of rank (t_len-1)/2, hi = that of
// rank t_len/2, and 0.5 * (lo + hi): bit for bit the median a sort gives,
// NaNs sorting high.  The wrapper answers t_len = 0 with NaN.
//
// What bounds it on an H100: bytes.  The function reads each value once
// (R * t_len * 4 bytes) and writes R floats.  A select sees a row more than
// once unless it knows where the median lies, and at the main shape the 67
// MB of magnitude do not fit the 50 MB L2, so each pass over the rows is
// paid in HBM.
//
// Design: a radix select on order-preserving u32 keys, digit by digit
// ([31:20], [19:12], [11:0]), whose passes each spread every row over many
// blocks (grid: blocks x rows, sized to fill the card; a block walks its
// row's chunks of kChunk values and keeps one histogram for them all), so
// that one row of 16M values fills the card as well as 64 rows of 262,144.
// The row is read once where it can be:
//  - a sample (64 runs of 128 values spread over the row, one block a row)
//    names a window of 12-bit bins that should hold the median, six
//    standard deviations of a sample quantile wide;
//  - pass 0 reads every value once (the next chunk's loads in flight while
//    a chunk is worked on): each block histograms the top 12 bits in shared
//    memory and adds its non-zero bins to the row's histogram in device
//    memory, and compacts the keys of the window's bins into the row's
//    candidate buffer (one atomic a warp and chunk where a row spans few
//    blocks, one a block where it spans many, so that one row of 16M values
//    does not queue its blocks' atomics on one word).  The last block of the
//    row to finish (a counter per row and pass, after a fence) finds the
//    bins that hold the ranks of lo and hi and writes the row's state: the
//    key bits found, the rank left inside them, and whether the buffer holds
//    every key that carries them;
//  - pass 1 reads the row again only where the window missed or the buffer
//    overflowed: it compacts the keys of lo's 12-bit prefix (where they fit)
//    or histograms the next digit of the row (where they do not: quantized
//    or constant rows, which then take the last digit from the row too);
//  - pass 2 finishes a row whose candidates fit one block's shared memory
//    (the last two digits there, no further launch); a larger set (one row
//    of 16M values) takes passes 2 and 3, each a digit histogrammed from the
//    buffer (a few percent of the row, in L2) by many blocks.
// A missed window or an overflow costs time, never an exit from the kernel:
// the sample only predicts, the counts decide.  While hi follows lo (its
// rank is lo's or lo's + 1) both are found in the same bins.  Where a pick
// puts hi's rank in a later bin than lo's, hi is the least key of that bin:
// a later pass takes it with a min (an atomic max of the inverted key), and
// at the last digit the bin is the key.  Counts are int32 (t_len < 2^31).

#include "common.cuh"
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                  // values a thread reads a chunk
constexpr int kChunk = kThreads * kPerThread;   // values a block reads a chunk
constexpr int kBins = 4096;                     // the widest digit
// blocks a row up to which the compaction takes one atomic a warp
constexpr int kFewBlocks = 16;
// a row's candidates that one block finishes in shared memory
constexpr int kFinishKeys = 40960;
constexpr int kFinishBytes = kFinishKeys * 4;
constexpr int kMaxDevices = 64;
// the sample that predicts the median's 12-bit bins: runs of contiguous
// values spread evenly over the row
constexpr int kSampleRuns = 64, kSampleRun = 128;
constexpr int kSample = kSampleRuns * kSampleRun;

// words of a row's scratch: a histogram per digit, then the state
constexpr int kSt = 3 * kBins;
constexpr int kRowWords = kSt + 16;
// the state's words
enum {
  kLevel,     // digits found so far
  kPrefix,    // lo's key bits found so far
  kRank,      // lo's rank among the keys that carry them
  kHiOff,     // hi's rank - lo's rank, while hi follows lo
  kHiMode,    // kFollow, kMin or kKnown
  kHiPrefix,  // hi's key bits, once it no longer follows lo
  kHiInv,     // ~(the least key that carries hi's bits), 0 = none seen yet
  kHiPass,    // the pass that takes that least key
  kCompact,   // kNone, kInPass1 or kInPass0: where the buffer was filled
  kNBuf,      // keys in the buffer
  kWinLo,     // the 12-bit bins the sample puts the median in: first
  kWinHi,     //   and last
  kDone       // blocks finished, one word per pass
};
enum { kFollow = 0, kMin = 1, kKnown = 2 };
// the buffer holds every key of lo's 12-bit prefix: not at all (the row is
// read again), from pass 1, or from pass 0 (the sample's window held lo)
enum { kNone = 0, kInPass1 = 1, kInPass0 = 2 };

__host__ __device__ constexpr int shift_of(int level) {
  return level == 0 ? 20 : level == 1 ? 12 : 0;
}
__host__ __device__ constexpr int bins_of(int level) {
  return level == 1 ? 256 : 4096;
}
// the key bits known before the digit of `level`
__host__ __device__ constexpr uint32_t known_mask(int level) {
  return level == 0 ? 0u : level == 1 ? 0xfff00000u
                         : level == 2 ? 0xfffff000u : 0xffffffffu;
}

// Up to kPerThread 32-bit words of a chunk of `cnt` items as they lie
// (float bits, or keys); bit j of the result marks word j as present.
// Thread tid owns items 4 * (tid + i * kThreads) + e, so that the 16-byte
// loads of a warp are contiguous.
__device__ __forceinline__ uint32_t load_words(const uint32_t* base, int cnt,
                                               uint32_t (&w)[kPerThread]) {
  const int tid = threadIdx.x;
  const bool vec = (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < kPerThread / 4; ++i) {
    const int at = 4 * (tid + i * kThreads);
    if (vec && at + 3 < cnt) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(base + at));
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
      ok |= 0xfu << (4 * i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[4 * i + e] = at + e < cnt ? __ldg(base + at + e) : 0u;
        ok |= (at + e < cnt ? 1u : 0u) << (4 * i + e);
      }
    }
  }
  return ok;
}

// The bins of a histogram (in device memory, or shared with kShared) that
// hold ranks a and b (a <= b), by the whole block: out[0] a's bin, out[1]
// the count below it, out[3] b's bin.
template <bool kShared>
__device__ void find_bins(const int* __restrict__ hist, int n_bins, int a,
                          int b, int* s_out, int* s_warp) {
  constexpr int kPer = kBins / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = tid * kPer;
  int c[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = b0 + j >= n_bins ? 0
           : kShared        ? hist[b0 + j]
                            : __ldcg(hist + b0 + j);
    sum += c[j];
  }
  const int incl = sdr::warp_inclusive_sum(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = incl - sum;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (a >= base && a < base + c[j]) {
      s_out[0] = b0 + j;
      s_out[1] = base;
      s_out[2] = c[j];
    }
    if (b >= base && b < base + c[j]) s_out[3] = b0 + j;
    base += c[j];
  }
  __syncthreads();
}

// The least of the block's `least`, by the whole block.
__device__ uint32_t block_min(uint32_t least, uint32_t* s_min) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  least = sdr::warp_min_u32(least);
  if (lane == 0) s_min[warp] = least;
  __syncthreads();
  least = sdr::warp_min_u32(s_min[lane & (kWarps - 1)]);
  __syncthreads();
  return least;
}

// The last two digits of a row whose candidates (n <= kFinishKeys keys, all
// with lo's 12-bit prefix) fit shared memory, by one block; writes the
// median.
__device__ void finish_in_shared(const uint32_t* __restrict__ row_buf, int n,
                                 int* st, int* s_hist, int* s_pick,
                                 int* s_warp, uint32_t* s_min, float* out) {
  extern __shared__ uint4 s_keys4[];
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_keys4);
  const int tid = threadIdx.x;
  // 16-byte loads, eight in flight a thread (the buffer's rows are 16-byte
  // aligned)
  const uint4* src4 = reinterpret_cast<const uint4*>(row_buf);
  const int n4 = n / 4;
  for (int i = tid; i < n4; i += 8 * kThreads) {
    uint4 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i + e * kThreads < n4) v[e] = __ldcg(src4 + i + e * kThreads);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i + e * kThreads < n4) s_keys4[i + e * kThreads] = v[e];
  }
  for (int i = 4 * n4 + tid; i < n; i += kThreads)
    s_keys[i] = __ldcg(row_buf + i);
  __syncthreads();
  uint32_t prefix = (uint32_t)st[kPrefix];
  int rank = st[kRank];
  const int hi_off = st[kHiOff];
  int hi_mode = st[kHiMode];
  uint32_t hi_key = 0;
  if (hi_mode == kMin && st[kHiPass] == 2) {
    // hi is the least key of a later 12-bit bin of the sample's window
    const uint32_t hi_want = (uint32_t)st[kHiPrefix];
    uint32_t least = 0xffffffffu;
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t key = s_keys[i];
      if ((key & known_mask(1)) == hi_want && key < least) least = key;
    }
    hi_key = block_min(least, s_min);
  } else if (hi_mode == kMin) {
    hi_key = ~(uint32_t)st[kHiInv];
  }
  for (int level = 1; level < 3; ++level) {
    const int shift = shift_of(level), n_bins = bins_of(level);
    const uint32_t mask = known_mask(level);
    for (int b = tid; b < n_bins; b += kThreads) s_hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t key = s_keys[i];
      if ((key & mask) == prefix)
        atomicAdd(&s_hist[(key >> shift) & (n_bins - 1)], 1);
    }
    __syncthreads();
    const bool follows = hi_mode == kFollow && hi_off > 0;
    find_bins<true>(s_hist, n_bins, rank, follows ? rank + hi_off : rank,
                    s_pick, s_warp);
    const int bin = s_pick[0], below = s_pick[1], hi_bin = s_pick[3];
    if (follows && hi_bin != bin) {
      // hi's rank lies in a later bin: hi is that bin's least key
      hi_key = prefix | ((uint32_t)hi_bin << shift);
      hi_mode = kKnown;
      if (level == 1) {
        uint32_t least = 0xffffffffu;
        for (int i = tid; i < n; i += kThreads) {
          const uint32_t key = s_keys[i];
          if ((key & known_mask(2)) == hi_key && key < least) least = key;
        }
        hi_key = block_min(least, s_min);
      }
    }
    prefix |= (uint32_t)bin << shift;
    rank -= below;
  }
  if (tid == 0) {
    if (hi_mode == kFollow) hi_key = prefix;
    st[kLevel] = 3;
    out[0] = 0.5f * (sdr::f32_from_key(prefix) + sdr::f32_from_key(hi_key));
  }
}

// The window of 12-bit bins in which a sample of each row puts the ranks of
// lo and hi, widened by six standard deviations of a sample quantile; the
// whole row where it is no longer than the sample.  Grid (1, rows).
__global__ void __launch_bounds__(kThreads)
nf_sample(const float* __restrict__ mag, long long row_stride, int t_len,
          int* __restrict__ scratch) {
  __shared__ int s_hist[kBins];
  __shared__ int s_warp[kWarps];
  __shared__ int s_pick[4];
  __shared__ int s_run[kSampleRuns];
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  int* words = scratch + (size_t)row * kRowWords;
  int* st = words + kSt;
  const float* src = mag + (size_t)row * row_stride;
  // the row's histograms and state start at zero: the passes follow
  for (int i = tid; i < kRowWords; i += kThreads) words[i] = 0;
  for (int b = tid; b < kBins; b += kThreads) s_hist[b] = 0;
  const bool whole = t_len <= kSample;
  const int n = whole ? t_len : kSample;
  if (tid < kSampleRuns)
    s_run[tid] = whole ? tid * kSampleRun
                       : (int)((long long)tid * (t_len - kSampleRun) /
                               (kSampleRuns - 1));
  __syncthreads();
  // every load in flight before the first atomic
  constexpr int kEach = kSample / kThreads;
  float v[kEach];
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int i = tid + e * kThreads;
    v[e] = i < n ? __ldg(src + s_run[i / kSampleRun] + i % kSampleRun) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kEach; ++e)
    if (tid + e * kThreads < n) atomicAdd(&s_hist[sdr::key_of(v[e]) >> 20], 1);
  __syncthreads();
  const int k_lo = (t_len - 1) / 2, k_hi = t_len / 2;
  const int margin = whole ? 0 : (int)(6.0f * sqrtf(0.25f * n)) + 8;
  const int a = max(0, (int)((long long)k_lo * n / t_len) - margin);
  const int b = min(n - 1, (int)(((long long)k_hi * n + t_len - 1) / t_len) +
                               margin);
  find_bins<true>(s_hist, kBins, a, b, s_pick, s_warp);
  if (tid == 0) {
    st[kWinLo] = s_pick[0];
    st[kWinHi] = s_pick[3];
  }
}

// One pass of the select; grid (blocks a row, rows).  What a row does in
// pass P follows from its state: pass 0 histograms digit 0 of the row and
// compacts the keys of the sample's window into the buffer; pass 1
// compacts the keys of lo's 12-bit prefix where the window missed it (and
// they fit the buffer), or histograms digit 1 of the row (where they do
// not); pass 2 finishes a row whose candidates fit one block's shared
// memory, else passes 2 and 3 histogram the row's next digit from the
// buffer; for a row that did not fit the buffer, pass 2 histograms the last
// digit from the row.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
nf_pass(const float* __restrict__ mag, long long row_stride, int t_len,
        uint32_t* __restrict__ buf, int cap, int* __restrict__ scratch,
        float* __restrict__ out) {
  __shared__ int s_hist[kBins];
  __shared__ int s_warp[kWarps];
  __shared__ int s_counts[2][kWarps];
  __shared__ int s_base[2];
  __shared__ uint32_t s_min[kWarps];
  __shared__ int s_pick[4];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  int* st = scratch + (size_t)row * kRowWords + kSt;

  // this row's work in this pass, from the picks of the passes before it
  const int level = P == 0 ? 0 : st[kLevel];
  const int filled = P == 0 ? kNone : st[kCompact];
  const bool fits = filled != kNone;
  const bool compact = P == 0 || (P == 1 && filled == kInPass1);
  const bool hist_pass =
      level < 3 && (P == 0 || (P == 1 && !fits) || P == 2 || (P == 3 && fits));
  const bool hi_min = P > 0 && st[kHiMode] == kMin && st[kHiPass] == P;
  if (!hist_pass && !compact && !hi_min) return;  // nothing left to do
  const bool from_buf = P >= 2 && fits;
  const int n = from_buf ? st[kNBuf] : t_len;
  uint32_t* row_buf = buf + (size_t)row * cap;
  if (P == 2 && from_buf && n <= kFinishKeys) {
    if (blockIdx.x == 0)
      finish_in_shared(row_buf, n, st, s_hist, s_pick, s_warp, s_min,
                       out + row);
    return;
  }
  const uint32_t want_mask = known_mask(level);
  const uint32_t want = P == 0 ? 0u : (uint32_t)st[kPrefix];
  const uint32_t hi_want = hi_min ? (uint32_t)st[kHiPrefix] : 0u;
  // pass 0 compacts the keys of the window's bins, pass 1 those of lo's
  const uint32_t win_lo = P == 0 ? (uint32_t)st[kWinLo] : 0u;
  const uint32_t win_hi = P == 0 ? (uint32_t)st[kWinHi] : 0u;
  const int shift = shift_of(level), n_bins = bins_of(level);
  int* hist = scratch + (size_t)row * kRowWords + level * kBins;
  const float* row_mag = mag + (size_t)row * row_stride;

  if (hist_pass) {
    for (int b = tid; b < kBins; b += kThreads) s_hist[b] = 0;
    __syncthreads();
  }
  uint32_t least = 0xffffffffu;  // the least key that carries hi's bits
  const unsigned lanes_below = (1u << lane) - 1u;
  const int n_chunks = (int)(((long long)n + kChunk - 1) / kChunk);
  const uint32_t* src =
      from_buf ? row_buf : reinterpret_cast<const uint32_t*>(row_mag);
  auto fetch = [&](int ch, uint32_t (&w)[kPerThread]) {
    const long long start = (long long)ch * kChunk;
    return load_words(src + start, (int)min((long long)kChunk, n - start), w);
  };
  // the next chunk's loads are in flight while a chunk is worked on
  uint32_t cur[kPerThread], nxt[kPerThread];
  uint32_t ok = 0, ok_nxt = 0;
  int parity = 0;
  const bool per_warp = gridDim.x <= kFewBlocks;
  if ((int)blockIdx.x < n_chunks) ok = fetch(blockIdx.x, cur);
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    if (ch + (int)gridDim.x < n_chunks) ok_nxt = fetch(ch + gridDim.x, nxt);
    uint32_t k[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      k[j] = from_buf ? cur[j] : sdr::key_of(__uint_as_float(cur[j]));
    uint32_t take = 0;  // keys that carry lo's bits
    uint32_t keep = 0;  // keys for the buffer
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool present = (ok >> j) & 1u;
      if (present && (k[j] & want_mask) == want) take |= 1u << j;
      if (P == 0 && present && (k[j] >> 20) - win_lo <= win_hi - win_lo)
        keep |= 1u << j;
      if (hi_min && present && (k[j] & want_mask) == hi_want && k[j] < least)
        least = k[j];
    }
    if (P != 0) keep = take;
    if (hist_pass) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if ((take >> j) & 1u)
          atomicAdd(&s_hist[(k[j] >> shift) & (n_bins - 1)], 1);
    }
    if (compact) {
      // the keys' place in the buffer: where a row spans few blocks, one
      // atomic a warp and chunk (no barrier); where it spans many, one a
      // block and chunk, since all of a row's atomics meet on one word (the
      // block's counts alternate between two sets of words, so one barrier
      // a chunk does).  The keys of one j of a warp land next to each
      // other; past the buffer's end nothing is written: the pick sees the
      // count.
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        mine += __popc(__ballot_sync(sdr::kFullMask, (keep >> j) & 1u));
      int at = 0;
      if (per_warp) {
        if (lane == 0 && mine) at = atomicAdd(&st[kNBuf], mine);
        at = __shfl_sync(sdr::kFullMask, at, 0);
      } else {
        int* counts = s_counts[parity];
        if (lane == 0) counts[warp] = mine;
        __syncthreads();
        int total = 0;
        for (int w = 0; w < kWarps; ++w) {
          at += w < warp ? counts[w] : 0;
          total += counts[w];
        }
        if (tid == 0) s_base[parity] = total ? atomicAdd(&st[kNBuf], total) : 0;
        __syncthreads();
        at += s_base[parity];
        parity ^= 1;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const bool t = (keep >> j) & 1u;
        const unsigned bal = __ballot_sync(sdr::kFullMask, t);
        const int pos = at + __popc(bal & lanes_below);
        if (t && pos < cap) row_buf[pos] = k[j];
        at += __popc(bal);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) cur[j] = nxt[j];
    ok = ok_nxt;
  }
  if (hist_pass) {
    __syncthreads();
    for (int b = tid; b < n_bins; b += kThreads)
      if (s_hist[b]) atomicAdd(&hist[b], s_hist[b]);
  }
  if (hi_min) {
    least = block_min(least, s_min);
    if (tid == 0 && least != 0xffffffffu)
      atomicMax(reinterpret_cast<unsigned*>(&st[kHiInv]), ~least);
  }
  if (!hist_pass) return;

  // the last block of the row to finish makes the pick
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&st[kDone + P], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  int rank, hi_off, hi_mode;
  if (P == 0) {
    rank = (t_len - 1) / 2;
    hi_off = t_len / 2 - rank;
    hi_mode = kFollow;
  } else {
    rank = __ldcg(&st[kRank]);
    hi_off = __ldcg(&st[kHiOff]);
    hi_mode = __ldcg(&st[kHiMode]);
  }
  const bool follows = hi_mode == kFollow && hi_off > 0;
  find_bins<false>(hist, n_bins, rank, follows ? rank + hi_off : rank, s_pick,
                   s_warp);
  if (tid != 0) return;
  const int bin = s_pick[0], below = s_pick[1], in_bin = s_pick[2];
  uint32_t prefix = want;
  const bool split = follows && s_pick[3] != bin;
  if (split) {
    // hi's rank lies in a later bin: hi is that bin's least key
    st[kHiPrefix] = (int)(prefix | ((uint32_t)s_pick[3] << shift));
    st[kHiPass] = P + 1;
    hi_mode = level == 2 ? kKnown : kMin;
  }
  if (P == 0) {
    // the buffer already holds lo's prefix (and hi's, where hi split off)
    // when the window held them and nothing overflowed; else pass 1 reads
    // the row again
    const int wl = st[kWinLo], wh = st[kWinHi];
    const bool held = __ldcg(&st[kNBuf]) <= cap && bin >= wl && bin <= wh &&
                      (!split || s_pick[3] <= wh);
    st[kCompact] = held ? kInPass0 : in_bin <= cap ? kInPass1 : kNone;
    if (!held) st[kNBuf] = 0;
    if (split && held) st[kHiPass] = 2;
  }
  prefix |= (uint32_t)bin << shift;
  if (level < 2) {
    st[kLevel] = level + 1;
    st[kPrefix] = (int)prefix;
    st[kRank] = rank - below;
    st[kHiOff] = hi_off;
    st[kHiMode] = hi_mode;
    return;
  }
  st[kLevel] = 3;
  const uint32_t hi_key = hi_mode == kFollow ? prefix
                          : hi_mode == kKnown ? (uint32_t)st[kHiPrefix]
                                              : ~(uint32_t)__ldcg(&st[kHiInv]);
  out[row] = 0.5f * (sdr::f32_from_key(prefix) + sdr::f32_from_key(hi_key));
}

template <int P>
int launch_pass(dim3 grid, int smem, cudaStream_t s, const float* m,
                long long stride, int t_len, uint32_t* b, int cap, int* w,
                float* o) {
  nf_pass<P><<<grid, kThreads, smem, s>>>(m, stride, t_len, b, cap, w, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Words of int32 scratch for `rows` rows (any contents: the first launch
// zeroes them).
extern "C" long long sdr_noise_floor_scratch_words(int rows) {
  return (long long)rows * kRowWords;
}

// Candidate keys the buffer holds a row, for t_len columns: a quarter of
// the row, a multiple of 4 (16-byte rows).
extern "C" int sdr_noise_floor_cap(int t_len) {
  return ((t_len / 4 + 1) + 3) / 4 * 4;
}

// mag: (rows, row_stride) float32, the first t_len >= 1 columns of each
// row are read; out: (rows,) float32; scratch:
// sdr_noise_floor_scratch_words(rows) int32 (any contents); buf: rows * cap
// uint32 (any contents), cap = sdr_noise_floor_cap(t_len).  Five launches
// on `stream`; returns the first failing launch's cudaError_t.
extern "C" int sdr_noise_floor_cm(const void* mag, void* out, int rows,
                                  long long row_stride, int t_len,
                                  void* scratch, void* buf, int cap,
                                  void* stream) {
  if (rows <= 0 || t_len <= 0) return 0;
  // blocks enough to fill the card once, spread over the rows; the finish
  // pass's shared-memory limit is a setting of the device, so both are
  // taken once per device (shards of one process may run on several)
  static int resident_on[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident_on[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, nf_pass<0>, kThreads, 0)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             nf_pass<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kFinishBytes)) != cudaSuccess)
      return (int)err;
    resident_on[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int resident = resident_on[dev];
  const long long n_chunks = ((long long)t_len + kChunk - 1) / kChunk;
  const long long per_row = resident / rows > 0 ? resident / rows : 1;
  const dim3 grid((unsigned)(n_chunks < per_row ? n_chunks : per_row), rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mag);
  float* o = static_cast<float*>(out);
  int* w = static_cast<int*>(scratch);
  uint32_t* b = static_cast<uint32_t*>(buf);
  nf_sample<<<dim3(1, rows), kThreads, 0, s>>>(m, row_stride, t_len, w);
  int code = (int)cudaGetLastError();
  if (!code)
    code = launch_pass<0>(grid, 0, s, m, row_stride, t_len, b, cap, w, o);
  if (!code)
    code = launch_pass<1>(grid, 0, s, m, row_stride, t_len, b, cap, w, o);
  if (!code)
    code = launch_pass<2>(grid, kFinishBytes, s, m, row_stride, t_len, b, cap,
                          w, o);
  if (!code)
    code = launch_pass<3>(grid, 0, s, m, row_stride, t_len, b, cap, w, o);
  return code;
}
