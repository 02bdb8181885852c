// Time-major detection streams -> channel-major, with the phase difference;
// and the one-channel detection streams straight from a wideband capture.
//
// Replaces the TPU kernel `_cm_kernel`
// (sdr_channelizer_tpu/ops/pallas/transpose_kernel.py, reached through
// `pallas_cm_streams`), and the elementwise prep that XLA fused ahead of it
// on the wideband path (sdr_channelizer_tpu/dsp/pdw.py, `_prep_streams`).
//
// What the flip computes: from the (T, M) magnitude, phase in degrees and
// saturation mask, the (M, T) streams the statistics kernel reads:
// mag_cm = mag^T, sat_cm = sat^T (as 0/1 float32) and
// dph_cm[k, t] = wrap(ph[t + 1, k] - ph[t, k]), the difference wrapped once
// into [-180, 180] (subtract; below -180 add 360; then above 180 subtract
// 360) and zero from column T - 1 on.  The two flips move bits, so they
// equal `.T` exactly; the difference is taken in the order the reference
// takes it.
//
// What bounds it on an H100: memory.  Three streams are read once and three
// written once (21 bytes a sample with a bool mask, 24 with a float one);
// nothing is computed but one subtraction.  At M = 1 the flips are views:
// only the phase (and a bool mask) is read and only `dph_cm` (and the float
// mask) written, 8 to 13 bytes a sample.
//
// Three forms.
//
// 1. The flip, M >= 2 (`flip_kernel`).  A persistent grid, as many blocks
//    as fit on the card (two a multiprocessor), walks tiles of 128 frames x
//    32 channels (sizes fixed at compile time: no division in the inner
//    loops).  Each block keeps a ring of stages in shared memory: while it
//    stores one tile it has the next one or two tiles' loads in flight
//    (`cp.async`, 16 bytes a copy where M % 4 == 0 and the streams are
//    16-byte aligned, else 4 bytes a copy; a bool mask four samples a copy,
//    or a byte at a time through registers), 74-98 KB a multiprocessor.  A
//    tile row of 32 channels is eight 16-byte chunks; chunk q of frame t
//    sits at chunk q ^ (t / 4 % 8), so both the copies in (a row's eight
//    chunks) and the reads out (four frames of one channel a lane, eight
//    lanes on consecutive frame groups) touch 32 different banks.  A lane
//    stores four consecutive frames of one channel as one 16-byte store
//    where T % 4 == 0 (every row then starts 16-byte aligned), else four
//    4-byte ones.
// 2. The flip at M = 1 (`dph_1ch_kernel`): no shared memory, a streaming
//    pass, four samples a lane with 16-byte loads and stores where the
//    phase is 16-byte aligned (else one sample a lane); the look-ahead phase
//    is the next lane's first sample, by a shuffle, and the warp's last lane
//    loads it.  `mag_cm` and a float mask are returned as views by the
//    wrapper, exactly as the plain version's `.T.contiguous()` returns them.
// 3. The one-channel streams from the capture (`wideband_streams_kernel`):
//    the complex64 capture read once as interleaved pairs, `mag` (T,) =
//    `mag_cm`, `dph_cm` and the float mask written once: 20 bytes a sample.
//    The arithmetic is the plain version's, op for op: |x| = hypotf(re, im)
//    (c10's complex abs on the card); the phase atan2f(im, re) times the
//    float32 degrees-per-radian as one rounded product (`__fmul_rn`, which
//    nvcc does not contract); the mask |re| >= level or |im| >= level.  The
//    source is built without fast math.
// The C entries pick each form's variant from the pointers and M: 16-byte
// accesses where they fit, else 4-byte ones (8-byte pairs), so any view
// the wrappers are given launches a kernel.
// Any M from 1 and any T: the ragged tiles are masked, nothing is padded.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileFrames = 128;
constexpr int kTileChannels = 32;
constexpr int kChunks = kTileChannels / 4;   // 16-byte chunks of a tile row
constexpr int kPhRows = kTileFrames + 1;     // the look-ahead frame
constexpr int kGroupsPerLane = 2;            // the streaming forms' unroll
constexpr int kMaxDevices = 64;

// float (or byte) offset of frame t, channel c in a stage's tile
__device__ __forceinline__ int swz(int t, int c) {
  return t * kTileChannels +
         ((((c >> 2) ^ (t >> 2)) & (kChunks - 1)) << 2) + (c & 3);
}

__device__ __forceinline__ float wrap_step(float next, float cur) {
  float d = next - cur;
  if (d < -180.0f) d += 360.0f;
  if (d > 180.0f) d -= 360.0f;  // strict: exactly +-180 stays
  return d;
}

__device__ __forceinline__ float as_mask(float v) { return v; }
__device__ __forceinline__ float as_mask(unsigned char v) {
  return v ? 1.0f : 0.0f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest n has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

template <typename SatT>
struct Stage {
  static constexpr int kMagFloats = kTileFrames * kTileChannels;
  static constexpr int kPhFloats = kPhRows * kTileChannels;
  static constexpr int kBytes =
      4 * (kMagFloats + kPhFloats) +
      (int)sizeof(SatT) * kTileFrames * kTileChannels;
  // tiles a block holds at once: three with a bool mask (108 KB, two
  // blocks a multiprocessor), two with a float one (97 KB, two blocks);
  // the faster of two and three for each, measured on an H100
  static constexpr int kCount = sizeof(SatT) == 1 ? 3 : 2;
  float* mag;
  float* ph;
  SatT* sat;
  __device__ explicit Stage(unsigned char* base)
      : mag(reinterpret_cast<float*>(base)),
        ph(mag + kMagFloats),
        sat(reinterpret_cast<SatT*>(ph + kPhFloats)) {}
};

struct Tile {
  long long t0;
  int c0, nt, nc, nph;  // frames, channels, phase rows present
};

__device__ __forceinline__ Tile tile_at(long long id, int n_ct, int M,
                                        int T) {
  Tile tl;
  const long long tt = id / n_ct;  // once a tile, not in the inner loops
  tl.c0 = (int)(id - tt * n_ct) * kTileChannels;
  tl.t0 = tt * kTileFrames;
  tl.nt = (int)min((long long)kTileFrames, (long long)T - tl.t0);
  tl.nph = (int)min((long long)kPhRows, (long long)T - tl.t0);
  tl.nc = min(kTileChannels, M - tl.c0);
  return tl;
}

// Start the copies of one tile into a stage.  A bool mask read a byte at a
// time comes through `pre` (registers) and is written by `put_bytes`.
template <bool kVec, typename SatT>
__device__ __forceinline__ void start_tile(
    const Stage<SatT>& st, const Tile& tl, const float* __restrict__ mag,
    const float* __restrict__ ph, const SatT* __restrict__ sat, int M,
    unsigned char (&pre)[kTileFrames * kTileChannels / kThreads]) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    // 16-byte chunks: chunk p is row p / 8, channels 4 (p % 8) .. + 3
    for (int p = tid; p < kPhRows * kChunks; p += kThreads) {
      const int t = p >> 3, c = (p & (kChunks - 1)) << 2;
      if (t >= tl.nph || c >= tl.nc) continue;
      const size_t g = (size_t)(tl.t0 + t) * M + tl.c0 + c;
      const int s = swz(t, c);
      cp_async16(st.ph + s, ph + g);
      if (t < tl.nt) {
        cp_async16(st.mag + s, mag + g);
        if constexpr (sizeof(SatT) == 4)
          cp_async16(st.sat + s, sat + g);
        else
          cp_async4(st.sat + s, sat + g);  // four mask bytes
      }
    }
  } else {
    // one sample a copy: element e is row e / 32, channel e % 32
    for (int e = tid; e < kPhRows * kTileChannels; e += kThreads) {
      const int t = e >> 5, c = e & (kTileChannels - 1);
      if (t >= tl.nph || c >= tl.nc) continue;
      const size_t g = (size_t)(tl.t0 + t) * M + tl.c0 + c;
      const int s = swz(t, c);
      cp_async4(st.ph + s, ph + g);
      if (t < tl.nt) {
        cp_async4(st.mag + s, mag + g);
        if constexpr (sizeof(SatT) == 4) cp_async4(st.sat + s, sat + g);
      }
    }
    if constexpr (sizeof(SatT) == 1) {
#pragma unroll
      for (int r = 0; r < kTileFrames * kTileChannels / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int t = e >> 5, c = e & (kTileChannels - 1);
        pre[r] = (t < tl.nt && c < tl.nc)
                     ? (unsigned char)sat[(size_t)(tl.t0 + t) * M + tl.c0 + c]
                     : 0;
      }
    }
  }
}

template <bool kVec, typename SatT>
__device__ __forceinline__ void put_bytes(
    const Stage<SatT>& st,
    const unsigned char (&pre)[kTileFrames * kTileChannels / kThreads]) {
  if constexpr (!kVec && sizeof(SatT) == 1) {
#pragma unroll
    for (int r = 0; r < kTileFrames * kTileChannels / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      st.sat[swz(e >> 5, e & (kTileChannels - 1))] = pre[r];
    }
  }
}

// Store one tile from a stage: group q is channel q / 8 % 32, frames
// 4 (q % 8 + 8 (q / 256)) .. + 3.
template <bool kVecStore, typename SatT>
__device__ __forceinline__ void store_tile(
    const Stage<SatT>& st, const Tile& tl, float* __restrict__ mag_cm,
    float* __restrict__ dph_cm, float* __restrict__ sat_cm, int T) {
#pragma unroll
  for (int h = 0; h < kTileFrames * kTileChannels / 4 / kThreads; ++h) {
    const int q = threadIdx.x + h * kThreads;
    const int c = (q >> 3) & (kTileChannels - 1);
    const int tb = ((q & 7) | ((q >> 8) << 3)) << 2;
    if (c >= tl.nc || tb >= tl.nt) continue;
    float m[4], s[4], d[4], p[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) p[j] = st.ph[swz(tb + j, c)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = st.mag[swz(tb + j, c)];
      s[j] = as_mask(st.sat[swz(tb + j, c)]);
      d[j] = wrap_step(p[j + 1], p[j]);
      if (tl.t0 + tb + j >= (long long)T - 1) d[j] = 0.0f;
    }
    const size_t g = (size_t)(tl.c0 + c) * (size_t)T + tl.t0 + tb;
    if (kVecStore && tb + 4 <= tl.nt) {
      *reinterpret_cast<float4*>(mag_cm + g) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(dph_cm + g) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(sat_cm + g) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tb + j >= tl.nt) break;
        mag_cm[g + j] = m[j];
        dph_cm[g + j] = d[j];
        sat_cm[g + j] = s[j];
      }
    }
  }
}

template <bool kVec, bool kVecStore, typename SatT>
__global__ void __launch_bounds__(kThreads)
flip_kernel(const float* __restrict__ mag,  // (T, M)
            const float* __restrict__ ph,   // (T, M)
            const SatT* __restrict__ sat,   // (T, M)
            float* __restrict__ mag_cm,     // (M, T)
            float* __restrict__ dph_cm, float* __restrict__ sat_cm, int M,
            int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto stage = [&](int i) {
    return Stage<SatT>(smem + i * Stage<SatT>::kBytes);
  };
  const int n_ct = (M + kTileChannels - 1) / kTileChannels;
  const long long n_tiles =
      ((long long)T + kTileFrames - 1) / kTileFrames * n_ct;
  const long long step = gridDim.x;
  constexpr int kStages = Stage<SatT>::kCount;
  unsigned char pre[kTileFrames * kTileChannels / kThreads];

  // the block's first kStages - 1 tiles in flight
  for (int i = 0; i < kStages - 1; ++i) {
    const long long id = blockIdx.x + i * step;
    if (id < n_tiles) {
      start_tile<kVec>(stage(i), tile_at(id, n_ct, M, T), mag, ph, sat, M,
                       pre);
      put_bytes<kVec>(stage(i), pre);
    }
    cp_async_commit();
  }
  int k = 0;
  for (long long id = blockIdx.x; id < n_tiles; id += step, ++k) {
    // start the tile kStages - 1 ahead, into the stage read last time round
    const long long ahead = id + (kStages - 1) * step;
    const int sa = (k + kStages - 1) % kStages;
    if (ahead < n_tiles)
      start_tile<kVec>(stage(sa), tile_at(ahead, n_ct, M, T), mag, ph, sat,
                       M, pre);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's copies have landed
    __syncthreads();
    store_tile<kVecStore>(stage(k % kStages), tile_at(id, n_ct, M, T),
                          mag_cm, dph_cm, sat_cm, T);
    if (ahead < n_tiles) put_bytes<kVec>(stage(sa), pre);
    __syncthreads();
  }
}

// ---- the streaming forms, one channel -------------------------------------

// whether the group of V samples at t is whole and taken by 16-byte accesses
template <int V>
__device__ __forceinline__ bool full(long long t, long long T) {
  return V == 4 && t + 4 <= T;
}

template <int V>
__device__ __forceinline__ void store4(float* dst, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// dph_cm (and a float mask from a bool one) of the (T, 1) streams.
template <int V, bool kBoolSat>
__global__ void __launch_bounds__(kThreads)
dph_1ch_kernel(const float* __restrict__ ph, const unsigned char* __restrict__ sat,
               float* __restrict__ dph, float* __restrict__ sat_cm,
               long long T) {
  const int lane = threadIdx.x & 31;
  const long long n_groups = (T + V - 1) / V;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long span = 32LL * kGroupsPerLane;
  for (long long base = ((long long)blockIdx.x * (kThreads / 32) +
                         (threadIdx.x >> 5)) * span;
       base < n_groups; base += warps * span) {
    float v[kGroupsPerLane][V];
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u) {
      const long long t = (base + u * 32 + lane) * V;
      if (full<V>(t, T)) {
        if constexpr (V == 4) {
          const float4 q = *reinterpret_cast<const float4*>(ph + t);
          v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = t + i < T ? ph[t + i] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u) {
      const long long t = (base + u * 32 + lane) * V;
      float nxt = __shfl_down_sync(sdr::kFullMask, v[u][0], 1);
      if (lane == 31) nxt = t + V < T ? ph[t + V] : 0.0f;
      if (t >= T) continue;
      float d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        d[i] = wrap_step(i + 1 < V ? v[u][(i + 1) % V] : nxt, v[u][i]);
        if (t + i >= T - 1) d[i] = 0.0f;
      }
      float s[V];
      if constexpr (kBoolSat) {
        if (full<V>(t, T)) {
          const unsigned w = *reinterpret_cast<const unsigned*>(sat + t);
#pragma unroll
          for (int i = 0; i < V; ++i) s[i] = (w >> (8 * i)) & 0xffu ? 1.0f : 0.0f;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) s[i] = t + i < T && sat[t + i] ? 1.0f : 0.0f;
        }
      }
      if (full<V>(t, T)) {
        store4<V>(dph + t, d);
        if constexpr (kBoolSat) store4<V>(sat_cm + t, s);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (t + i >= T) break;
          dph[t + i] = d[i];
          if (kBoolSat) sat_cm[t + i] = s[i];
        }
      }
    }
  }
}

// sample t of the capture, an interleaved (re, im) pair
__device__ __forceinline__ float2 sample_at(const float* __restrict__ x,
                                            long long t) {
  return *reinterpret_cast<const float2*>(x + 2 * t);
}

__device__ __forceinline__ float phase_deg(float2 x, float rad2deg) {
  return __fmul_rn(atan2f(x.y, x.x), rad2deg);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
wideband_streams_kernel(const float* __restrict__ x,  // (T,) pairs
                        float level, float rad2deg,
                        float* __restrict__ mag, float* __restrict__ dph,
                        float* __restrict__ sat, long long T) {
  const int lane = threadIdx.x & 31;
  const long long n_groups = (T + V - 1) / V;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long span = 32LL * kGroupsPerLane;
  for (long long base = ((long long)blockIdx.x * (kThreads / 32) +
                         (threadIdx.x >> 5)) * span;
       base < n_groups; base += warps * span) {
    float2 v[kGroupsPerLane][V];
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u) {
      const long long t = (base + u * 32 + lane) * V;
      if (full<V>(t, T)) {
        if constexpr (V == 4) {
          const float4 p = *reinterpret_cast<const float4*>(x + 2 * t);
          const float4 q = *reinterpret_cast<const float4*>(x + 2 * t + 4);
          v[u][0] = {p.x, p.y}; v[u][1] = {p.z, p.w};
          v[u][2] = {q.x, q.y}; v[u][3] = {q.z, q.w};
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[u][i] = t + i < T ? sample_at(x, t + i) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u) {
      const long long t = (base + u * 32 + lane) * V;
      float m[V], p[V], s[V], d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        m[i] = hypotf(v[u][i].x, v[u][i].y);
        p[i] = phase_deg(v[u][i], rad2deg);
        s[i] = fabsf(v[u][i].x) >= level || fabsf(v[u][i].y) >= level
                   ? 1.0f : 0.0f;
      }
      float nxt = __shfl_down_sync(sdr::kFullMask, p[0], 1);
      if (lane == 31)
        nxt = t + V < T ? phase_deg(sample_at(x, t + V), rad2deg) : 0.0f;
      if (t >= T) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        d[i] = wrap_step(i + 1 < V ? p[(i + 1) % V] : nxt, p[i]);
        if (t + i >= T - 1) d[i] = 0.0f;
      }
      if (full<V>(t, T)) {
        store4<V>(mag + t, m);
        store4<V>(dph + t, d);
        store4<V>(sat + t, s);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (t + i >= T) break;
          mag[t + i] = m[i];
          dph[t + i] = d[i];
          sat[t + i] = s[i];
        }
      }
    }
  }
}

// ---- launches ---------------------------------------------------------------

// blocks of `kernel` resident on the card, with `smem` bytes each, from the
// caller's table (one a kernel, filled once per device); sets the kernel's
// shared-memory limit the first time
template <typename K>
int resident_blocks(K kernel, int smem, int (&table)[kMaxDevices], int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (table[dev] == 0) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess)
      return (int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, (size_t)smem)) != cudaSuccess)
      return (int)err;
    table[dev] = max(per_sm, 1) * sms;
  }
  *out = table[dev];
  return 0;
}

template <bool kVec, bool kVecStore, typename SatT>
int launch_flip(const float* mag, const float* ph, const void* sat,
                float* mag_cm, float* dph_cm, float* sat_cm, int M, int T,
                cudaStream_t stream) {
  auto kernel = flip_kernel<kVec, kVecStore, SatT>;
  const int smem = Stage<SatT>::kCount * Stage<SatT>::kBytes;
  static int table[kMaxDevices];
  int resident = 0;
  if (int err = resident_blocks(kernel, smem, table, &resident)) return err;
  const long long n_tiles = ((long long)T + kTileFrames - 1) / kTileFrames *
                            ((M + kTileChannels - 1) / kTileChannels);
  const int grid = (int)min(n_tiles, (long long)resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      mag, ph, static_cast<const SatT*>(sat), mag_cm, dph_cm, sat_cm, M, T);
  return (int)cudaGetLastError();
}

template <typename SatT>
int flip_variant(const float* mag, const float* ph, const void* sat,
                 float* mag_cm, float* dph_cm, float* sat_cm, int M, int T,
                 bool vec, cudaStream_t s) {
  const bool vs = T % 4 == 0;
  if (vec && vs)
    return launch_flip<true, true, SatT>(mag, ph, sat, mag_cm, dph_cm, sat_cm, M, T, s);
  if (vec)
    return launch_flip<true, false, SatT>(mag, ph, sat, mag_cm, dph_cm, sat_cm, M, T, s);
  if (vs)
    return launch_flip<false, true, SatT>(mag, ph, sat, mag_cm, dph_cm, sat_cm, M, T, s);
  return launch_flip<false, false, SatT>(mag, ph, sat, mag_cm, dph_cm, sat_cm, M, T, s);
}

// a grid of a streaming form: one pass of whole blocks, at most as many
// blocks as are resident
template <typename K>
int streaming_grid(K kernel, int (&table)[kMaxDevices], long long T, int V,
                   int* grid) {
  int resident = 0;
  if (int err = resident_blocks(kernel, 0, table, &resident)) return err;
  const long long per_block = (long long)kThreads * kGroupsPerLane * V;
  *grid = (int)min((T + per_block - 1) / per_block, (long long)resident);
  return 0;
}

template <int V, bool kBoolSat>
int launch_dph_1ch(const float* ph, const unsigned char* sat, float* dph,
                   float* sat_cm, long long T, cudaStream_t stream) {
  auto kernel = dph_1ch_kernel<V, kBoolSat>;
  static int table[kMaxDevices];
  int grid = 0;
  if (int err = streaming_grid(kernel, table, T, V, &grid)) return err;
  kernel<<<grid, kThreads, 0, stream>>>(ph, sat, dph, sat_cm, T);
  return (int)cudaGetLastError();
}

template <int V>
int launch_wideband(const float* x, float level, float rad2deg, float* mag,
                    float* dph, float* sat, long long T, cudaStream_t stream) {
  auto kernel = wideband_streams_kernel<V>;
  static int table[kMaxDevices];
  int grid = 0;
  if (int err = streaming_grid(kernel, table, T, V, &grid)) return err;
  kernel<<<grid, kThreads, 0, stream>>>(x, level, rad2deg, mag, dph, sat, T);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The flip.  mag, ph: (T, M) float32 contiguous; sat: (T, M), float32 0/1
// when sat_bytes = 4, one byte a sample (zero or not) when sat_bytes = 1;
// the three outputs (M, T) float32.  The loads are 16 bytes wide where they
// fit (M % 4 == 0 and 16-byte aligned streams, a bool mask 4-byte aligned;
// at M = 1 the phase 16-byte aligned and a bool mask 4-byte aligned), else
// 4 bytes wide.  At M = 1 only dph_cm is written, and sat_cm from a bool
// mask: mag_cm and a float mask's sat_cm are the inputs' views (pass null).
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int sdr_cm_streams(const void* mag, const void* ph, const void* sat,
                              int sat_bytes, void* mag_cm, void* dph_cm,
                              void* sat_cm, int M, int T, void* stream) {
  if (M <= 0 || T <= 0) return 0;
  if (sat_bytes != 1 && sat_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(mag);
  const float* fp = static_cast<const float*>(ph);
  float* om = static_cast<float*>(mag_cm);
  float* od = static_cast<float*>(dph_cm);
  float* os = static_cast<float*>(sat_cm);
  const bool bool_sat = sat_bytes == 1;
  const bool sat_ok = aligned(sat, bool_sat ? 4 : 16);
  if (M == 1) {
    const bool vec = aligned(ph, 16) && (!bool_sat || sat_ok);
    const unsigned char* sb = static_cast<const unsigned char*>(sat);
    if (vec)
      return bool_sat ? launch_dph_1ch<4, true>(fp, sb, od, os, T, s)
                      : launch_dph_1ch<4, false>(fp, sb, od, os, T, s);
    return bool_sat ? launch_dph_1ch<1, true>(fp, sb, od, os, T, s)
                    : launch_dph_1ch<1, false>(fp, sb, od, os, T, s);
  }
  const bool vec =
      M % 4 == 0 && aligned(mag, 16) && aligned(ph, 16) && sat_ok;
  if (!bool_sat)
    return flip_variant<float>(fm, fp, sat, om, od, os, M, T, vec, s);
  return flip_variant<unsigned char>(fm, fp, sat, om, od, os, M, T, vec, s);
}

// The one-channel streams from a complex64 capture of T samples, `x` its
// interleaved float32 pairs (8-byte aligned): writes mag, dph and the 0/1
// mask, each (T,) float32.  The loads are 16 bytes wide where `x` is
// 16-byte aligned, else one pair at a time.
extern "C" int sdr_wideband_streams(const void* x, float level, float rad2deg,
                                    void* mag, void* dph, void* sat,
                                    long long T, void* stream) {
  if (T <= 0) return 0;
  if (!aligned(x, 8)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  float* om = static_cast<float*>(mag);
  float* od = static_cast<float*>(dph);
  float* os = static_cast<float*>(sat);
  return aligned(x, 16)
             ? launch_wideband<4>(fx, level, rad2deg, om, od, os, T, s)
             : launch_wideband<1>(fx, level, rad2deg, om, od, os, T, s);
}
