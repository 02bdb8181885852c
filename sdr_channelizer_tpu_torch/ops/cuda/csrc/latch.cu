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
// What bounds it on an H100: bytes (4 read, 8 written per sample), but the
// scan along time is a dependency chain, so in this first form latency is
// what is paid.
//
// Design: one block per row walks time in tiles of kThreads * kItems
// samples and carries (state, lead count, trail count) from tile to tile in
// registers: the loop inside the block takes the place of the TPU's
// sequential grid.  In a tile every thread owns kItems consecutive samples;
// a block scan of the "last non-hold transfer" gives the state before the
// thread's first sample, the thread walks its samples, and a second block
// scan of its (leading, trailing) edge counts, packed into one int, gives
// its base.  Tiles pass through shared memory so that global loads and
// stores are coalesced.  Counts are int32 and leave as float32, exact below
// 2^24.  R blocks fill R of the 132 multiprocessors.
//
// The time-major form (`latch_tm_kernel`) reads mag (T, M).  A block per
// channel walking one column would read 4 bytes at a stride of 4*M: every
// load its own sector.  So a block owns kTmWarps neighbouring channels and
// walks time in tiles of kTmTile frames: the tile's rows are read with the
// channel index fastest (one 32-byte sector a row for eight channels) and
// land transposed in shared memory; then one warp per channel runs the same
// scan with shuffles only, a lane owning kTmItems consecutive samples, and
// carries the same three values in registers.  A lane's stretch is padded
// by one float so that the lanes of a warp hit different banks.  Outputs
// leave channel-major through the same shared rows, 128 bytes a warp.
// ceil(M / kTmWarps) blocks: fewer multiprocessors still than the
// channel-major form, and the same latency-bound chain along time.  The
// chain is what costs, so the next tile's magnitudes are read into
// registers (kTmItems a thread) before the current tile is scanned, and
// their latency hides behind the scan.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// later over earlier: the last transfer that is not a hold
__device__ __forceinline__ int compose(int earlier, int later) {
  return later != 0 ? later : earlier;
}

__global__ void __launch_bounds__(kThreads)
latch_cm_kernel(const float* __restrict__ mag_cm,
                const float* __restrict__ lead, const float* __restrict__ trail,
                const float* __restrict__ entry, float* __restrict__ out,
                int R, int m_real, int T) {
  __shared__ float s_in[kTile];
  __shared__ float s_lead[kTile];
  __shared__ float s_trail[kTile];
  __shared__ int s_warp[kWarps];

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rows past m_real get +inf thresholds: they reset always, never open
  const float inf = __int_as_float(0x7f800000);
  const float th_lead = r < m_real ? lead[r] : inf;
  const float th_trail = r < m_real ? trail[r] : inf;
  const float* row = mag_cm + (size_t)r * T;
  float* out_lead = out + (size_t)r * T;
  float* out_trail = out + (size_t)(R + r) * T;

  // carried across tiles
  int state_in = (entry != nullptr && r < m_real && entry[r] > 0.5f) ? 1 : 0;
  int lead_base = 0, trail_base = 0;

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    for (int i = tid; i < n; i += kThreads) s_in[i] = row[t0 + i];
    __syncthreads();

    // transfers of this thread's samples and their composition
    int tr[kItems];
    int agg = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid * kItems + i;
      int t = 0;
      if (idx < n) {
        const float m = s_in[idx];
        t = (m >= th_lead ? 1 : 0) - (m <= th_trail ? 1 : 0);
      }
      tr[i] = t;
      agg = compose(agg, t);
    }
    // block scan (exclusive) of the composition
    int incl = agg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(sdr::kFullMask, incl, off);
      if (lane >= off) incl = compose(o, incl);
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0;  // composition of all earlier warps
    for (int w = 0; w < warp; ++w) before = compose(before, s_warp[w]);
    int excl = __shfl_up_sync(sdr::kFullMask, incl, 1);
    if (lane == 0) excl = 0;
    excl = compose(before, excl);
    int state = excl != 0 ? (excl > 0 ? 1 : 0) : state_in;
    int tile_tr = before;  // whole tile's composition, for the carry
    for (int w = warp; w < kWarps; ++w) tile_tr = compose(tile_tr, s_warp[w]);

    // walk the samples: states, edges, local counts
    int cnt = 0;  // leading edges in the low half, trailing in the high
    int edge[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int prev = state;
      if (tr[i] != 0) state = tr[i] > 0 ? 1 : 0;
      const int le = state & (1 - prev), te = prev & (1 - state);
      cnt += le + (te << 16);
      edge[i] = cnt;
    }
    __syncthreads();  // s_warp is read above, rewritten below
    int cincl = sdr::warp_inclusive_sum(cnt, lane);
    if (lane == 31) s_warp[warp] = cincl;
    __syncthreads();
    int cbefore = 0, ctotal = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_warp[w];
      if (w < warp) cbefore += v;
      ctotal += v;
    }
    const int cexcl = cbefore + cincl - cnt;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid * kItems + i;
      const int c = cexcl + edge[i];
      s_lead[idx] = (float)(lead_base + (c & 0xffff));
      s_trail[idx] = (float)(trail_base + (c >> 16));
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      out_lead[t0 + i] = s_lead[i];
      out_trail[t0 + i] = s_trail[i];
    }
    // carry (every thread computes the same values)
    if (tile_tr != 0) state_in = tile_tr > 0 ? 1 : 0;
    lead_base += ctotal & 0xffff;
    trail_base += ctotal >> 16;
    __syncthreads();  // tile buffers and s_warp are reused by the next tile
  }
}

constexpr int kTmWarps = 8;                 // channels a block owns
constexpr int kTmItems = 16;                // samples a lane owns in a tile
constexpr int kTmTile = 32 * kTmItems;      // frames a tile
constexpr int kTmChunk = kTmItems + 1;      // a lane's stretch, padded
constexpr int kTmRow = 32 * kTmChunk + 1;   // a channel's row, padded

__device__ __forceinline__ int tm_slot(int t) {
  return (t / kTmItems) * kTmChunk + (t % kTmItems);
}

__global__ void __launch_bounds__(kTmWarps * 32)
latch_tm_kernel(const float* __restrict__ mag,  // (T, M)
                const float* __restrict__ lead, const float* __restrict__ trail,
                const float* __restrict__ entry, float* __restrict__ out,
                int M, int T) {
  // s_a holds the tile's magnitudes, then the leading-edge counts
  __shared__ float s_a[kTmWarps * kTmRow];
  __shared__ float s_trail[kTmWarps * kTmRow];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kTmWarps;
  const int nc = min(kTmWarps, M - c0);
  const bool live = warp < nc;  // the same for a whole warp
  const int c = c0 + warp;
  const float th_lead = live ? lead[c] : 0.0f;
  const float th_trail = live ? trail[c] : 0.0f;
  float* out_lead = out + (size_t)(live ? c : 0) * T;
  float* out_trail = out + (size_t)(M + (live ? c : 0)) * T;
  float* mine_a = s_a + warp * kTmRow;
  float* mine_t = s_trail + warp * kTmRow;

  int state_in = (live && entry != nullptr && entry[c] > 0.5f) ? 1 : 0;
  int lead_base = 0, trail_base = 0;

  // element j of a thread is element tid + j * blockDim of the tile, rows of
  // nc channels laid end to end: frame i / nc, channel i % nc
  float pre[kTmItems];
  auto fetch = [&](int t0) {
    const int n_el = min(kTmTile, T - t0) * nc;
    const float* src = mag + (size_t)t0 * M + c0;
#pragma unroll
    for (int j = 0; j < kTmItems; ++j) {
      const int i = tid + j * kTmWarps * 32;
      const int t = i / nc;
      pre[j] = i < n_el ? src[(size_t)t * M + (i - t * nc)] : 0.0f;
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < T; t0 += kTmTile) {
    const int n = min(kTmTile, T - t0);
#pragma unroll
    for (int j = 0; j < kTmItems; ++j) {
      const int i = tid + j * kTmWarps * 32;
      const int t = i / nc, g = i - t * nc;
      if (i < n * nc) s_a[g * kTmRow + tm_slot(t)] = pre[j];
    }
    __syncthreads();
    if (t0 + kTmTile < T) fetch(t0 + kTmTile);

    if (live) {
      int tr[kTmItems];
      int agg = 0;
#pragma unroll
      for (int i = 0; i < kTmItems; ++i) {
        int t = 0;
        if (lane * kTmItems + i < n) {
          const float m = mine_a[lane * kTmChunk + i];
          t = (m >= th_lead ? 1 : 0) - (m <= th_trail ? 1 : 0);
        }
        tr[i] = t;
        agg = compose(agg, t);
      }
      int incl = agg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(sdr::kFullMask, incl, off);
        if (lane >= off) incl = compose(o, incl);
      }
      int excl = __shfl_up_sync(sdr::kFullMask, incl, 1);
      if (lane == 0) excl = 0;
      const int tile_tr = __shfl_sync(sdr::kFullMask, incl, 31);
      int state = excl != 0 ? (excl > 0 ? 1 : 0) : state_in;

      int cnt = 0;  // leading edges in the low half, trailing in the high
      int edge[kTmItems];
#pragma unroll
      for (int i = 0; i < kTmItems; ++i) {
        const int prev = state;
        if (tr[i] != 0) state = tr[i] > 0 ? 1 : 0;
        const int le = state & (1 - prev), te = prev & (1 - state);
        cnt += le + (te << 16);
        edge[i] = cnt;
      }
      const int cincl = sdr::warp_inclusive_sum(cnt, lane);
      const int cexcl = cincl - cnt;
      const int ctotal = __shfl_sync(sdr::kFullMask, cincl, 31);
#pragma unroll
      for (int i = 0; i < kTmItems; ++i) {
        const int cc = cexcl + edge[i];
        mine_a[lane * kTmChunk + i] = (float)(lead_base + (cc & 0xffff));
        mine_t[lane * kTmChunk + i] = (float)(trail_base + (cc >> 16));
      }
      __syncwarp();
      for (int i = lane; i < n; i += 32) {
        out_lead[t0 + i] = mine_a[tm_slot(i)];
        out_trail[t0 + i] = mine_t[tm_slot(i)];
      }
      if (tile_tr != 0) state_in = tile_tr > 0 ? 1 : 0;
      lead_base += ctotal & 0xffff;
      trail_base += ctotal >> 16;
    }
    __syncthreads();  // the rows are refilled by the next tile
  }
}

}  // namespace

// mag: (T, M) float32 contiguous, time-major; lead, trail: (M,) float32;
// entry: (M,) float32 (> 0.5 = the latch enters active) or null; out:
// (2M, T) float32, rows [0, M) leading-edge counts, [M, 2M) trailing.
extern "C" int sdr_latch_cumsums_tm(const void* mag, const void* lead,
                                    const void* trail, const void* entry,
                                    void* out, int M, int T, void* stream) {
  if (M <= 0 || T <= 0) return 0;
  const int blocks = (M + kTmWarps - 1) / kTmWarps;
  latch_tm_kernel<<<blocks, kTmWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag), static_cast<const float*>(lead),
      static_cast<const float*>(trail), static_cast<const float*>(entry),
      static_cast<float*>(out), M, T);
  return (int)cudaGetLastError();
}

// mag_cm: (R, T) float32 contiguous; lead, trail: (m_real,) float32, the
// thresholds of the first m_real rows; entry: (m_real,) float32 (> 0.5 = the
// latch enters active) or null for all inactive; out: (2R, T) float32.
extern "C" int sdr_latch_cumsums_cm(const void* mag_cm, const void* lead,
                                    const void* trail, const void* entry,
                                    void* out, int R, int m_real, int T,
                                    void* stream) {
  if (R <= 0 || T <= 0) return 0;
  latch_cm_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag_cm), static_cast<const float*>(lead),
      static_cast<const float*>(trail), static_cast<const float*>(entry),
      static_cast<float*>(out), R, m_real, T);
  return (int)cudaGetLastError();
}
