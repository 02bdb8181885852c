// Hysteresis latch and the edge cumulative counts, from channel-major or
// time-major magnitudes.
//
// Replaces the TPU kernels `_latch_cm_kernel` (`pallas_latch_cumsums_cm`,
// channel-major in) and `_latch_kernel` (`pallas_latch_cumsums`, time-major
// in) of sdr_channelizer_tpu/ops/pallas/latch_kernel.py.
//
// What it computes, per row r of mag_cm (R, T): each sample's transfer
// t = (mag >= lead[r]) - (mag <= trail[r]) in {+1 set, -1 reset, 0 hold};
// two steps compose as `later != 0 ? later : earlier` (the three-state rule:
// a sample that is both >= lead and <= trail holds, it does not toggle); the
// latch enters in entry[r].  A leading edge is a 0 -> 1 step of the state, a
// trailing edge a 1 -> 0 step.  Out: (2R, T) float32, rows [0, R) the
// inclusive count of leading edges, rows [R, 2R) that of trailing edges.
//
// What bounds it on an H100: bytes (4 read, 8 written per sample).
//
// Design: one kernel serves both layouts.  It is a scan across time that is
// parallel over segments of it, so that its grid grows with T: a block owns
// one segment of seg_frames<G>() frames of G neighbouring rows (G = 1 for
// the channel-major form and for the time-major one at M = 1, where a
// segment is 4096 frames of one contiguous row; else 8 channels and 512
// frames, each row of the tile read as one 32-byte sector).  The carry from
// segment to segment is a summary of the segment that does not depend on
// the state it enters in: f, its first non-hold transfer (0 if none); l, its
// last; L and R, the leading and trailing edges strictly after the position
// of f, where the state is known inside the segment.  Two summaries compose
// as f = A.f ? A.f : B.f, l = B.l ? B.l : A.l, the counts add, and B's first
// transfer makes an edge when A.l is its opposite.  Applied to an entry
// state s, a prefix adds the edge at f given s, and leaves the state
// l ? l > 0 : s.  The summaries of a row's segments are chained by a
// single-pass scan with decoupled look-back (Merrill and Garland, NVIDIA
// 2016): a block takes its (row group, segment) from an atomic ticket,
// segment-major, so that every earlier segment of its rows is already
// running and all rows progress together; it publishes its own aggregate,
// walks back over its row's predecessors' published words 32 at a time until
// it meets an inclusive prefix (the row's first segment publishes one at
// once: its entry is the row's entry state, never the previous row's last
// segment), and publishes its own inclusive prefix.  Flag and summary are
// one 64-bit word, stored with release and read with acquire semantics;
// counts inside a segment and its prefix are full ints.  Then the block
// walks its samples from the known entry state and base: every sample is
// read once and both counts written once, 12 bytes a sample, which bound it
// on an H100.  The tile passes through shared memory both ways, so that
// global loads and stores are coalesced (16 bytes a thread where a row's
// segment starts on a 16-byte boundary, one float a thread where it does
// not); the wrapper zeroes the ticket and status words for each call.  Counts
// leave as float32, exact below 2^24.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;               // samples a thread owns
constexpr int kChunk = kItems + 1;       // a thread's stretch, padded
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

template <int G>
__host__ __device__ constexpr int seg_frames() {
  return kThreads / G * kItems;
}

// a row of the tile: padded so that the channels of a frame row land in
// different banks
template <int G>
__host__ __device__ constexpr int tile_row() {
  return kThreads / G * kChunk + (G > 1 ? 8 : 0);
}

__device__ __forceinline__ int slot(int t) {
  return (t / kItems) * kChunk + (t % kItems);
}

struct Summary {
  int f, l;  // first and last non-hold transfer, 0 if none
  int L, R;  // leading and trailing edges strictly after f
};

__device__ __forceinline__ Summary combine(const Summary& a, const Summary& b) {
  Summary c;
  c.f = a.f ? a.f : b.f;
  c.l = b.l ? b.l : a.l;
  c.L = a.L + b.L + (a.l == -1 && b.f == 1 ? 1 : 0);
  c.R = a.R + b.R + (a.l == 1 && b.f == -1 ? 1 : 0);
  return c;
}

// bits 0-1 flag, 2-3 f + 1, 4-5 l + 1, 6-29 L, 30-53 R (counts < T < 2^24)
__device__ __forceinline__ unsigned long long pack(const Summary& s,
                                                   unsigned long long flag) {
  return flag | (unsigned long long)(s.f + 1) << 2 |
         (unsigned long long)(s.l + 1) << 4 | (unsigned long long)s.L << 6 |
         (unsigned long long)s.R << 30;
}

__device__ __forceinline__ Summary unpack_summary(unsigned long long w) {
  Summary s;
  s.f = (int)((w >> 2) & 3) - 1;
  s.l = (int)((w >> 4) & 3) - 1;
  s.L = (int)((w >> 6) & 0xffffff);
  s.R = (int)((w >> 30) & 0xffffff);
  return s;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The state a prefix leaves and the edges it holds, entered in state s.
__device__ __forceinline__ void apply(const Summary& p, int& s, int& lead,
                                      int& trail) {
  lead += p.L + (s == 0 && p.f == 1 ? 1 : 0);
  trail += p.R + (s == 1 && p.f == -1 ? 1 : 0);
  if (p.l != 0) s = p.l > 0 ? 1 : 0;
}

// The exclusive prefix of segment `seg` of one row, by one warp: publish
// the segment's aggregate, walk back over the predecessors' words until an
// inclusive prefix, publish the inclusive prefix.  `st` is the row's own
// status words: the walk ends at its segment 0.
__device__ Summary look_back(unsigned long long* st, int seg,
                             const Summary& total, int lane) {
  const Summary none = {0, 0, 0, 0};
  if (seg == 0) {
    if (lane == 0) store_release(st, pack(total, kInclusive));
    return none;
  }
  if (lane == 0) store_release(st + seg, pack(total, kAggregate));
  Summary run = none;  // the composition of the segments walked so far
  for (int base = seg - 1;; base -= 32) {
    const int j = base - lane;  // lane 0 the nearest predecessor
    unsigned long long w;
    do {
      w = j >= 0 ? load_acquire(st + j) : pack(none, kInclusive);
    } while (!__all_sync(sdr::kFullMask, (w & 3) != 0));
    const unsigned incl = __ballot_sync(sdr::kFullMask, (w & 3) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 32;
    unsigned long long v = pack(lane <= stop ? unpack_summary(w) : none, 0);
    // the window in time order: higher lanes are earlier segments
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long o = __shfl_down_sync(sdr::kFullMask, v, off);
      if (lane + off < 32)
        v = pack(combine(unpack_summary(o), unpack_summary(v)), 0);
    }
    run = combine(unpack_summary(__shfl_sync(sdr::kFullMask, v, 0)), run);
    if (stop < 32) break;
  }
  if (lane == 0) store_release(st + seg, pack(combine(run, total), kInclusive));
  return run;
}

// Sample (t, c) of the magnitude lies at mag[t * ts + c * cs]: time-major
// (T, M) has ts = M, cs = 1; channel-major (R, T) has ts = 1, cs = T.
// Rows c >= m_real get +inf thresholds: they reset always, never open.
template <int G>
__global__ void __launch_bounds__(kThreads)
latch_scan_kernel(const float* __restrict__ mag, long long ts, long long cs,
                  const float* __restrict__ lead,
                  const float* __restrict__ trail,
                  const float* __restrict__ entry, float* __restrict__ out,
                  // the ticket, then (R, n_seg) status words
                  unsigned long long* __restrict__ status,
                  int R, int m_real, int T, int n_seg) {
  constexpr int kTpc = kThreads / G;  // threads a row
  constexpr int kWpc = kTpc / 32;     // warps a row
  constexpr int kSeg = seg_frames<G>();
  constexpr int kRow = tile_row<G>();
  // s_a holds the magnitudes, then the leading-edge counts
  __shared__ float s_a[G * kRow];
  __shared__ float s_b[G * kRow];
  __shared__ unsigned long long s_warp[kThreads / 32];
  __shared__ unsigned long long s_prefix[G];
  __shared__ int s_ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = (int)atomicAdd(status, 1ull);
  __syncthreads();
  // segment-major: every row group's segment s before any segment s + 1
  const int n_groups = (R + G - 1) / G;
  const int seg = s_ticket / n_groups, grp = s_ticket - seg * n_groups;
  const int c0 = grp * G, nc = min(G, R - c0);
  const int t0 = seg * kSeg, n = min(kSeg, T - t0);
  const int g = tid / kTpc, r = tid % kTpc;  // row in the group, rank
  const bool live = g < nc;                  // the same for a whole warp
  const int c = c0 + (live ? g : 0);

  // the tile: element i is frame i / nc, row i % nc
  const float* src = mag + t0 * ts + c0 * cs;
  if (G == 1 && ts == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < n / 4; i += kThreads) {
      const float4 v = src4[i];
      float* d = s_a + slot(4 * i);  // four slots of one stretch
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    for (int t = n / 4 * 4 + tid; t < n; t += kThreads)
      s_a[slot(t)] = src[t];
  } else {
    for (int i = tid; i < n * nc; i += kThreads) {
      const int t = i / nc, gg = i - t * nc;
      s_a[gg * kRow + slot(t)] = src[t * ts + gg * cs];
    }
  }
  __syncthreads();

  // this thread's transfers and their summary
  const float inf = __int_as_float(0x7f800000);
  const bool real = live && c < m_real;
  const float th_lead = real ? lead[c] : inf;
  const float th_trail = real ? trail[c] : inf;
  float* mine_a = s_a + g * kRow + r * kChunk;
  float* mine_b = s_b + g * kRow + r * kChunk;
  int tr[kItems];
  Summary own = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int t = 0;
    if (live && r * kItems + i < n) {
      const float m = mine_a[i];
      t = (m >= th_lead ? 1 : 0) - (m <= th_trail ? 1 : 0);
    }
    tr[i] = t;
    if (t != 0) {
      if (own.f == 0) {
        own.f = t;
      } else {
        own.L += (own.l == -1 && t == 1) ? 1 : 0;
        own.R += (own.l == 1 && t == -1) ? 1 : 0;
      }
      own.l = t;
    }
  }

  // scan of the summaries over the row's threads
  unsigned long long incl = pack(own, 0);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long o = __shfl_up_sync(sdr::kFullMask, incl, off);
    if (lane >= off)
      incl = pack(combine(unpack_summary(o), unpack_summary(incl)), 0);
  }
  unsigned long long excl_w = __shfl_up_sync(sdr::kFullMask, incl, 1);
  if (lane == 0) excl_w = pack(Summary{0, 0, 0, 0}, 0);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  const int w0 = g * kWpc;  // the row's first warp
  Summary before = {0, 0, 0, 0};
  for (int w = w0; w < warp; ++w)
    before = combine(before, unpack_summary(s_warp[w]));
  const Summary excl = combine(before, unpack_summary(excl_w));

  // the prefix of the row's segments before this one, by its first warp
  if (warp == w0 && live) {
    Summary total = before;  // before is empty in the first warp
    for (int w = w0; w < w0 + kWpc; ++w)
      total = combine(total, unpack_summary(s_warp[w]));
    const Summary pre =
        look_back(status + 1 + (size_t)c * n_seg, seg, total, lane);
    if (lane == 0) s_prefix[g] = pack(pre, 0);
  }
  __syncthreads();

  if (live) {
    int state = (entry != nullptr && real && entry[c] > 0.5f) ? 1 : 0;
    int n_lead = 0, n_trail = 0;
    apply(unpack_summary(s_prefix[g]), state, n_lead, n_trail);
    apply(excl, state, n_lead, n_trail);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int prev = state;
      if (tr[i] != 0) state = tr[i] > 0 ? 1 : 0;
      n_lead += state & (1 - prev);
      n_trail += prev & (1 - state);
      mine_a[i] = (float)n_lead;
      mine_b[i] = (float)n_trail;
    }
  }
  __syncthreads();
  if (live) {
    float* out_lead = out + (size_t)c * T + t0;
    float* out_trail = out + (size_t)(R + c) * T + t0;
    const float* row_a = s_a + g * kRow;
    const float* row_b = s_b + g * kRow;
    for (int t = r; t < n; t += kTpc) {
      out_lead[t] = row_a[slot(t)];
      out_trail[t] = row_b[slot(t)];
    }
  }
}

// rows a block of the time-major scan owns
inline int tm_group(int M) { return M == 1 ? 1 : 8; }

inline int segments(int G, int T) {
  const int seg = G == 1 ? seg_frames<1>() : seg_frames<8>();
  return (T + seg - 1) / seg;
}

int launch(const void* mag, long long ts, long long cs, const void* lead,
           const void* trail, const void* entry, void* out, void* scratch,
           int R, int m_real, int T, int G, void* stream) {
  const int n_seg = segments(G, T);
  const int blocks = n_seg * ((R + G - 1) / G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mag);
  const float* l = static_cast<const float*>(lead);
  const float* t = static_cast<const float*>(trail);
  const float* e = static_cast<const float*>(entry);
  float* o = static_cast<float*>(out);
  unsigned long long* st = static_cast<unsigned long long*>(scratch);
  if (G == 1)
    latch_scan_kernel<1><<<blocks, kThreads, 0, s>>>(m, ts, cs, l, t, e, o,
                                                     st, R, m_real, T, n_seg);
  else
    latch_scan_kernel<8><<<blocks, kThreads, 0, s>>>(m, ts, cs, l, t, e, o,
                                                     st, R, m_real, T, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace

// 64-bit words of scratch the time-major scan needs, zeroed, for (T, M):
// the ticket, then one status word per channel and segment.
extern "C" long long sdr_latch_tm_scratch_words(int M, int T) {
  if (M <= 0 || T <= 0) return 1;
  return 1 + (long long)M * segments(tm_group(M), T);
}

// The same for the channel-major scan of (R, T): one word per row and
// segment of seg_frames<1>() frames.
extern "C" long long sdr_latch_cm_scratch_words(int R, int T) {
  if (R <= 0 || T <= 0) return 1;
  return 1 + (long long)R * segments(1, T);
}

// mag: (T, M) float32 contiguous, time-major; lead, trail: (M,) float32;
// entry: (M,) float32 (> 0.5 = the latch enters active) or null; out:
// (2M, T) float32, rows [0, M) leading-edge counts, [M, 2M) trailing;
// scratch: sdr_latch_tm_scratch_words(M, T) 64-bit words, all zero.
extern "C" int sdr_latch_cumsums_tm(const void* mag, const void* lead,
                                    const void* trail, const void* entry,
                                    void* out, void* scratch, int M, int T,
                                    void* stream) {
  if (M <= 0 || T <= 0) return 0;
  return launch(mag, M, 1, lead, trail, entry, out, scratch, M, M, T,
                tm_group(M), stream);
}

// mag_cm: (R, T) float32 contiguous; lead, trail: (m_real,) float32, the
// thresholds of the first m_real rows; entry: (m_real,) float32 (> 0.5 = the
// latch enters active) or null for all inactive; out: (2R, T) float32;
// scratch: sdr_latch_cm_scratch_words(R, T) 64-bit words, all zero.
extern "C" int sdr_latch_cumsums_cm(const void* mag_cm, const void* lead,
                                    const void* trail, const void* entry,
                                    void* out, void* scratch, int R,
                                    int m_real, int T, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  return launch(mag_cm, 1, T, lead, trail, entry, out, scratch, R, m_real, T,
                1, stream);
}
