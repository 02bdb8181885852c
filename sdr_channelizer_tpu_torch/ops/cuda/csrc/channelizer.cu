// Fused channelizer: capture -> detection streams, or the complex bands.
//
// Replaces the TPU kernels `_streams_kernel` in its cm2, cm and flat modes
// and `_kernel` (sdr_channelizer_tpu/ops/pallas/channelizer_kernel.py,
// reached through `pallas_channelize_streams[_packed]_cm2`,
// `pallas_channelize_streams[_packed]_cm`,
// `pallas_channelize_streams[_packed]` and `pallas_channelize`).
//
// What it computes, per frame t of M (I, Q) samples: sign-extend and
// dequantize by `scale`; the P-tap polyphase branch FIR over the P-1 frames
// before the block (`hist`, the tail of the previous block, or zeros); the
// shift-folded M-point DFT as four real float32 products; then one of four
// epilogues.  cm2 and cm, channel-major (M, T): |y|, the wrapped phase
// difference to the next frame in degrees (zero from column T-1 on) and the
// saturation stream.  In cm2 mode that stream is the inclusive per-channel
// cumulative count of saturated samples.  In cm mode it is the 0/1 mask
// itself, and |y| is also written time-major (T, M).  flat, time-major
// (T, M): |y|, the phase itself in degrees and the 0/1 mask.  complex: y
// itself, (T, M) interleaved (re, im).  All modes are one kernel body: the
// FIR, the DFT and their order of operations are shared, so |y| and the
// phase of a frame are the same bits whichever mode computed them.  The
// ingest is a second template parameter of that body: packed pairs (one
// int32 holding an int16 (I, Q) pair, or one int16 holding an int8 pair), or
// two planes (int16 or float32, with an element stride, so that a complex64
// capture is read in place as planes of stride 2).
//
// What bounds it on an H100: the DFT.  Per frame it is 4*M*M fused
// multiply-adds against 4*M bytes read and 12*M bytes written, so at M = 64
// the float32 CUDA-core rate, not the memory, is the limit.
//
// Design.  One block owns a tile of FT frames and all M channels.
//   1. The FT + P frames the tile needs (P-1 of history, one of look-ahead
//      for the phase difference) are read once, coalesced, dequantized and
//      kept in shared memory; frames before the capture or past it are zero.
//   2. The FIR runs out of shared memory and leaves U transposed,
//      U[rho][t], so the product can read four frames as one float4.
//   3. The product is register tiled: a thread owns 4 frames x 4 channels
//      of yr and yi (32 accumulators) and walks rho; per step it reads two
//      float4 of U from shared memory and two float4 of W through L1 and
//      does 64 FMAs.  Plain float32 FMAs in a fixed order (rho ascending):
//      no TF32, no tensor cores.  The look-ahead frame is one extra dot
//      product per channel.
//   4. |y|, the phase (Cephes atan2 polynomial, as the TPU kernel) and the
//      saturation flag go to shared memory channel-major; a warp per
//      channel then writes the three streams with time contiguous (the
//      tiled transpose), taking the phase difference and a warp-shuffle
//      scan of the flags on the way.
// Blocks run in no order, so the saturation count is cumulative inside the
// tile only; each tile leaves its total, `scan_tiles` (one block a channel)
// turns the totals into exclusive offsets, and `add_offsets` adds them,
// touching only tiles whose offset is not zero (a capture that never clips
// costs nothing there).  The ragged last tile and any M are masked; nothing
// is padded to a lane width.  The cm mode needs no count, so none of the
// two small kernels runs there; its time-major |y| leaves shared memory with
// the channel index fastest, which is again coalesced.  The flat and complex
// modes need no look-ahead frame and no step 4 transposition: their tile
// leaves shared memory time-major the same way, and the complex mode skips
// the stream math and stores (re, im) as one float2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float atan_poly(float z) {
  float s = z * z;
  return ((((8.05374449538e-2f * s - 1.38776856032e-1f) * s +
            1.99777106478e-1f) * s - 3.33329491539e-1f) * s * z + z);
}

// atan2 from compares and the Cephes single-precision polynomial, the same
// three-interval reduction as the TPU kernel: x = y = 0 -> 0, y = 0 and
// x < 0 -> +pi.
__device__ __forceinline__ float atan2_cephes(float y, float x) {
  const float pi = 3.14159265358979323846f;
  const float t_hi = 2.414213562373095f;
  const float t_lo = 0.4142135623730950f;
  float ay = fabsf(y), ax = fabsf(x);
  float z = (ax == 0.0f) ? __int_as_float(0x7f800000) : ay / ax;
  float t;
  if (z > t_hi) {
    t = pi / 2 - atan_poly(1.0f / fmaxf(z, 1e-30f));
  } else if (z > t_lo) {
    t = pi / 4 + atan_poly((z - 1.0f) / (z + 1.0f));
  } else {
    t = atan_poly(z);
  }
  if (isinf(z)) t = pi / 2;
  float ang = (x < 0.0f) ? pi - t : t;
  ang = (y < 0.0f) ? -ang : ang;
  if (y == 0.0f && x < 0.0f) ang = pi;
  if (y == 0.0f && x == 0.0f) ang = 0.0f;
  return ang;
}

__device__ __forceinline__ void unpack(int32_t v, float& i, float& q) {
  i = (float)(int16_t)(v & 0xffff);  // low half = I
  q = (float)(v >> 16);              // high half = Q, arithmetic shift
}

__device__ __forceinline__ void unpack(int16_t v, float& i, float& q) {
  int w = v;
  i = (float)(int8_t)(w & 0xff);  // low byte = I
  q = (float)(w >> 8);            // high byte = Q
}

// Packed pairs: element g is sample g; `hist` holds the (P-1) * M samples
// before the block, or is null.
template <typename T>
struct PackedIn {
  const T* x;
  const T* hist;
  __device__ __forceinline__ bool has_hist() const { return hist != nullptr; }
  __device__ __forceinline__ void load(long long g, float& i, float& q) const {
    unpack(x[g], i, q);
  }
  __device__ __forceinline__ void load_hist(long long g, float& i,
                                            float& q) const {
    unpack(hist[g], i, q);
  }
};

// Two planes, sample g at element g * stride of each; the history planes
// are dense.
template <typename T>
struct PlanesIn {
  const T* xr;
  const T* xi;
  const T* hr;
  const T* hi;
  int stride;
  __device__ __forceinline__ bool has_hist() const { return hr != nullptr; }
  __device__ __forceinline__ void load(long long g, float& i, float& q) const {
    i = (float)xr[g * stride];
    q = (float)xi[g * stride];
  }
  __device__ __forceinline__ void load_hist(long long g, float& i,
                                            float& q) const {
    i = (float)hr[g];
    q = (float)hi[g];
  }
};

enum Mode { kCm2 = 0, kCm = 1, kFlat = 2, kComplex = 3 };

struct Smem {
  int off_b;    // floats before U
  int us;       // U row stride (frames, multiple of 4)
  int ps;       // mag/phase row stride
  int n_float;  // floats in all
};

__host__ __device__ inline Smem smem_layout(int M, int P, int FT) {
  Smem s;
  s.us = FT + 4;
  s.ps = FT + 1;
  int a = 2 * (FT + P) * M;
  s.off_b = (a + 3) & ~3;
  s.n_float = s.off_b + 2 * M * s.us;
  return s;
}

// kCm2: sat_out = cumulative count inside the tile, tile_tot written, tm0-2
// unused.  kCm: sat_out = 0/1 mask, tm0 = time-major |y|, tile_tot unused.
// kFlat: tm0, tm1, tm2 = time-major |y|, phase, mask; nothing channel-major.
// kComplex: tm0 = (T, M) float2 of (re, im); nothing else.
template <typename In, int kMode>
__global__ void __launch_bounds__(kThreads)
channelize_kernel(const In in,
                  const float* __restrict__ taps,    // (P, M)
                  const float* __restrict__ wr,      // (M, MP)
                  const float* __restrict__ wi,      // (M, MP)
                  float* __restrict__ tm0,           // (T, M)
                  float* __restrict__ tm1,
                  float* __restrict__ tm2,
                  float* __restrict__ mag_cm,        // (M, T)
                  float* __restrict__ dph_cm,
                  float* __restrict__ sat_out,
                  int* __restrict__ tile_tot,        // (M, n_tiles)
                  int M, int MP, int P, int T, int FT, float scale,
                  float sat_level) {
  constexpr bool kCmOut = kMode == kCm2 || kMode == kCm;  // look-ahead too
  extern __shared__ __align__(16) float smem[];
  const Smem lay = smem_layout(M, P, FT);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile_idx = blockIdx.x;
  const int t0 = tile_idx * FT;
  const int US = lay.us, PS = lay.ps;

  float* Xr = smem;
  float* Xi = smem + (FT + P) * M;
  float* Ur = smem + lay.off_b;
  float* Ui = Ur + M * US;
  unsigned char* sat_s = reinterpret_cast<unsigned char*>(smem + lay.n_float);
  // after the FIR the X region is dead and holds these instead
  float* mag_s = smem;
  float* ph_s = smem + M * PS;

  // 1. frames t0-(P-1) .. t0+FT, dequantized; the frames before the block
  //    come from `hist` (only the first tile reaches them)
  {
    const long long base = (long long)(t0 - (P - 1)) * M;
    const long long n_all = (long long)T * M;
    const long long n_hist = (long long)(P - 1) * M;
    const int n_x = (FT + P - (kCmOut ? 0 : 1)) * M;
    for (int i = tid; i < n_x; i += kThreads) {
      long long g = base + i;
      float vi = 0.0f, vq = 0.0f;
      if (g >= 0 && g < n_all) {
        in.load(g, vi, vq);
      } else if (g < 0 && in.has_hist()) {
        in.load_hist(g + n_hist, vi, vq);
      }
      Xr[i] = vi * scale;
      Xi[i] = vq * scale;
    }
  }
  __syncthreads();

  // 2. branch FIR: u[t, rho] = sum_p taps[p, rho] * x[t - p, rho]
  {
    const int n_u = (FT + (kCmOut ? 1 : 0)) * M;
    for (int i = tid; i < n_u; i += kThreads) {
      int t = i / M, rho = i - t * M;
      float ar = 0.0f, ai = 0.0f;
      for (int p = 0; p < P; ++p) {
        float tap = __ldg(taps + p * M + rho);
        int xi = (t + P - 1 - p) * M + rho;
        ar = fmaf(tap, Xr[xi], ar);
        ai = fmaf(tap, Xi[xi], ai);
      }
      Ur[rho * US + t] = ar;
      Ui[rho * US + t] = ai;
    }
  }
  __syncthreads();

  // 3. DFT, register tiled 4 frames x 4 channels
  const float rad2deg = 57.29577951308232f;
  {
    const int TG = FT / 4, KG = MP / 4;
    for (int tile = tid; tile < TG * KG; tile += kThreads) {
      const int tg = tile % TG, kg = tile / TG;
      float yr[4][4], yi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yr[i][j] = yi[i][j] = 0.0f;
      const float* ur_p = Ur + tg * 4;
      const float* ui_p = Ui + tg * 4;
      const float* wr_p = wr + kg * 4;
      const float* wi_p = wi + kg * 4;
      for (int rho = 0; rho < M; ++rho) {
        const float4 a4 = *reinterpret_cast<const float4*>(ur_p + rho * US);
        const float4 b4 = *reinterpret_cast<const float4*>(ui_p + rho * US);
        const float4 c4 =
            __ldg(reinterpret_cast<const float4*>(wr_p + (size_t)rho * MP));
        const float4 d4 =
            __ldg(reinterpret_cast<const float4*>(wi_p + (size_t)rho * MP));
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            yr[i][j] = fmaf(a[i], c[j], yr[i][j]);
            yr[i][j] = fmaf(-b[i], d[j], yr[i][j]);
            yi[i][j] = fmaf(a[i], d[j], yi[i][j]);
            yi[i][j] = fmaf(b[i], c[j], yi[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kg * 4 + j;
        if (k >= M) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tg * 4 + i;
          const float re = yr[i][j], im = yi[i][j];
          if (kMode == kComplex) {
            mag_s[k * PS + t] = re;
            ph_s[k * PS + t] = im;
            continue;
          }
          mag_s[k * PS + t] = sqrtf(re * re + im * im);
          ph_s[k * PS + t] = atan2_cephes(im, re) * rad2deg;
          sat_s[k * FT + t] =
              (fabsf(re) >= sat_level || fabsf(im) >= sat_level) ? 1 : 0;
        }
      }
    }
    // the look-ahead frame's phase: one dot product per channel
    for (int k = tid; kCmOut && k < M; k += kThreads) {
      float re = 0.0f, im = 0.0f;
      for (int rho = 0; rho < M; ++rho) {
        const float a = Ur[rho * US + FT], b = Ui[rho * US + FT];
        const float c = __ldg(wr + (size_t)rho * MP + k);
        const float d = __ldg(wi + (size_t)rho * MP + k);
        re = fmaf(a, c, re);
        re = fmaf(-b, d, re);
        im = fmaf(a, d, im);
        im = fmaf(b, c, im);
      }
      ph_s[k * PS + FT] = atan2_cephes(im, re) * rad2deg;
    }
  }
  __syncthreads();

  // 4a. the time-major outputs, the channel index fastest
  if (kMode != kCm2) {
    const int n_t = min(FT, T - t0);
    for (int i = tid; i < n_t * M; i += kThreads) {
      const int t = i / M, k = i - t * M;
      const size_t g = (size_t)(t0 + t) * M + k;
      if (kMode == kComplex) {
        reinterpret_cast<float2*>(tm0)[g] =
            make_float2(mag_s[k * PS + t], ph_s[k * PS + t]);
        continue;
      }
      tm0[g] = mag_s[k * PS + t];
      if (kMode == kFlat) {
        tm1[g] = ph_s[k * PS + t];
        tm2[g] = (float)sat_s[k * FT + t];
      }
    }
  }
  if (!kCmOut) return;
  constexpr bool kMask = kMode == kCm;

  // 4b. channel-major write, a warp per channel, time across the lanes
  for (int k = warp; k < M; k += kWarps) {
    int carry = 0;
    const size_t row = (size_t)k * T;
    for (int c0 = 0; c0 < FT; c0 += 32) {
      const int t = c0 + lane;
      const int ta = t0 + t;
      const bool in = t < FT && ta < T;
      const int s = in ? sat_s[k * FT + t] : 0;
      const int incl = kMask ? s : sdr::warp_inclusive_sum(s, lane);
      if (in) {
        mag_cm[row + ta] = mag_s[k * PS + t];
        float d = ph_s[k * PS + t + 1] - ph_s[k * PS + t];
        if (d < -180.0f) d += 360.0f;
        if (d > 180.0f) d -= 360.0f;  // strict: exactly +-180 stays
        if (ta >= T - 1) d = 0.0f;
        dph_cm[row + ta] = d;
        sat_out[row + ta] = (float)(carry + incl);
      }
      if (!kMask) carry += __shfl_sync(sdr::kFullMask, incl, 31);
    }
    if (!kMask && lane == 0) tile_tot[(size_t)k * gridDim.x + tile_idx] = carry;
  }
}

// Per channel: tile totals -> exclusive offsets, in place.  One block a
// channel; a thread sums a contiguous chunk of tiles, the block scans the
// chunk sums, and the thread writes its chunk's running offsets.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int* __restrict__ tile_tot, int n_tiles) {
  __shared__ int s_warp[kScanThreads / 32];
  int* row = tile_tot + (size_t)blockIdx.x * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += row[i];
  const int incl = sdr::warp_inclusive_sum(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  int run = before + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = row[i];
    row[i] = run;
    run += v;
  }
}

constexpr int kAddCols = 1024;

__global__ void add_offsets_kernel(float* __restrict__ satcs_cm,
                                   const int* __restrict__ offs, int M, int T,
                                   int FT) {
  const int k = blockIdx.y;
  for (int t = blockIdx.x * kAddCols + threadIdx.x;
       t < min(T, (int)(blockIdx.x + 1) * kAddCols); t += blockDim.x) {
    const int o = offs[(size_t)k * ((T + FT - 1) / FT) + t / FT];
    if (o != 0) satcs_cm[(size_t)k * T + t] += (float)o;
  }
}

struct Args {
  const float* taps;
  const float* wr;
  const float* wi;
  float* out[6];  // tm0, tm1, tm2, mag_cm, dph_cm, sat_out
  int* tile_tot;
  int M, MP, P, T, FT;
  float scale, sat_level;
  cudaStream_t stream;
};

template <typename In, int kMode>
int launch(const In& in, const Args& a) {
  const Smem lay = smem_layout(a.M, a.P, a.FT);
  const size_t bytes =
      (size_t)lay.n_float * sizeof(float) + (size_t)a.M * a.FT;
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel<In, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (a.T + a.FT - 1) / a.FT;
  channelize_kernel<In, kMode><<<n_tiles, kThreads, bytes, a.stream>>>(
      in, a.taps, a.wr, a.wi, a.out[0], a.out[1], a.out[2], a.out[3],
      a.out[4], a.out[5], a.tile_tot, a.M, a.MP, a.P, a.T, a.FT, a.scale,
      a.sat_level);
  err = cudaGetLastError();
  if (err != cudaSuccess || kMode != kCm2) return (int)err;
  scan_tiles_kernel<<<a.M, kScanThreads, 0, a.stream>>>(a.tile_tot, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + kAddCols - 1) / kAddCols, a.M);
  add_offsets_kernel<<<grid, 256, 0, a.stream>>>(a.out[5], a.tile_tot, a.M,
                                                 a.T, a.FT);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_mode(int mode, const In& in, const Args& a) {
  switch (mode) {
    case kCm2: return launch<In, kCm2>(in, a);
    case kCm: return launch<In, kCm>(in, a);
    case kFlat: return launch<In, kFlat>(in, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block, in bytes, for the wrapper's choice of
// the tile length FT.
extern "C" long long sdr_channelize_smem(int M, int P, int FT) {
  const Smem lay = smem_layout(M, P, FT);
  return (long long)lay.n_float * sizeof(float) + (long long)M * FT;
}

// mode: 0 = cm2, 1 = cm, 2 = flat, 3 = complex (float32 planes only).
// ingest: 0 = x0 packed int32 (an int16 (I, Q) pair an element), 1 = x0
// packed int16 (an int8 pair), 2 = x0, x1 int16 planes, 3 = x0, x1 float32
// planes; a plane's sample g is its element g * stride.  h0 (and h1 for
// planes): the (P-1, M) samples that precede the block, dense, or null for
// zeros.  out0..out5: time-major (T, M) |y| (cm, flat) or interleaved y
// (complex); time-major phase and mask (flat); channel-major (M, T) |y|,
// phase difference and saturation count or mask (cm2, cm); unused ones may
// be null.  MP = M rounded up to 4 (row stride of wr, wi); FT a multiple of
// 4.  Returns the cudaError_t of the first failing call, 0 if none.
extern "C" int sdr_channelize(int mode, int ingest, const void* x0,
                              const void* x1, const void* h0, const void* h1,
                              int stride, const void* taps, const void* wr,
                              const void* wi, void* out0, void* out1,
                              void* out2, void* out3, void* out4, void* out5,
                              void* tile_tot, int M, int MP, int P, int T,
                              int FT, float scale, float sat_level,
                              void* stream) {
  Args a;
  a.taps = (const float*)taps;
  a.wr = (const float*)wr;
  a.wi = (const float*)wi;
  void* outs[6] = {out0, out1, out2, out3, out4, out5};
  for (int i = 0; i < 6; ++i) a.out[i] = (float*)outs[i];
  a.tile_tot = (int*)tile_tot;
  a.M = M; a.MP = MP; a.P = P; a.T = T; a.FT = FT;
  a.scale = scale;
  a.sat_level = sat_level;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (ingest) {
    case 0:
      return launch_mode(mode, PackedIn<int32_t>{(const int32_t*)x0,
                                                 (const int32_t*)h0}, a);
    case 1:
      return launch_mode(mode, PackedIn<int16_t>{(const int16_t*)x0,
                                                 (const int16_t*)h0}, a);
    case 2:
      return launch_mode(
          mode, PlanesIn<int16_t>{(const int16_t*)x0, (const int16_t*)x1,
                                  (const int16_t*)h0, (const int16_t*)h1,
                                  stride}, a);
    case 3: {
      const PlanesIn<float> in{(const float*)x0, (const float*)x1,
                               (const float*)h0, (const float*)h1, stride};
      if (mode == kComplex) return launch<PlanesIn<float>, kComplex>(in, a);
      return launch_mode(mode, in, a);
    }
  }
  return (int)cudaErrorInvalidValue;
}
