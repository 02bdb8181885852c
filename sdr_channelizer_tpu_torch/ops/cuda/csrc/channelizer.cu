// Fused packed-ingest channelizer -> channel-major detection streams.
//
// Replaces the TPU kernel `_streams_kernel` in its cm2 and cm modes
// (sdr_channelizer_tpu/ops/pallas/channelizer_kernel.py, reached through
// `pallas_channelize_streams_packed_cm2` and
// `pallas_channelize_streams_packed_cm`).
//
// What it computes, per frame t of M packed (I, Q) samples: sign-extend and
// dequantize by `scale`; the P-tap polyphase branch FIR over the P-1 frames
// before the block (`hist`, the packed tail of the previous block, or zeros);
// the shift-folded M-point DFT as four real float32 products; then,
// channel-major (M, T): |y|, the wrapped phase difference to the next frame
// in degrees (zero from column T-1 on) and the saturation stream.  In cm2
// mode that stream is the inclusive per-channel cumulative count of
// saturated samples.  In cm mode it is the 0/1 mask itself, and |y| is also
// written time-major (T, M).  Both modes are one kernel body: the FIR, the
// DFT and their order of operations are shared, so |y| and the phase of a
// frame are the same bits whichever mode computed them.
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
// the channel index fastest, which is again coalesced.

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

// kCm = false: cm2 mode (sat_out = cumulative count inside the tile,
// tile_tot written, mag_tm unused).  kCm = true: cm mode (sat_out = 0/1
// mask, mag_tm written, tile_tot unused).
template <typename PackedT, bool kCm>
__global__ void __launch_bounds__(kThreads)
channelize_kernel(const PackedT* __restrict__ xq,
                  const PackedT* __restrict__ hist,  // (P-1, M) or null
                  const float* __restrict__ taps,    // (P, M)
                  const float* __restrict__ wr,      // (M, MP)
                  const float* __restrict__ wi,      // (M, MP)
                  float* __restrict__ mag_tm,        // (T, M)
                  float* __restrict__ mag_cm,        // (M, T)
                  float* __restrict__ dph_cm,
                  float* __restrict__ sat_out,
                  int* __restrict__ tile_tot,        // (M, n_tiles)
                  int M, int MP, int P, int T, int FT, float scale,
                  float sat_level) {
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
    const int n_x = (FT + P) * M;
    for (int i = tid; i < n_x; i += kThreads) {
      long long g = base + i;
      float vi = 0.0f, vq = 0.0f;
      if (g >= 0 && g < n_all) {
        unpack(xq[g], vi, vq);
      } else if (g < 0 && hist != nullptr) {
        unpack(hist[g + n_hist], vi, vq);
      }
      Xr[i] = vi * scale;
      Xi[i] = vq * scale;
    }
  }
  __syncthreads();

  // 2. branch FIR: u[t, rho] = sum_p taps[p, rho] * x[t - p, rho]
  {
    const int n_u = (FT + 1) * M;
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
          mag_s[k * PS + t] = sqrtf(re * re + im * im);
          ph_s[k * PS + t] = atan2_cephes(im, re) * rad2deg;
          sat_s[k * FT + t] =
              (fabsf(re) >= sat_level || fabsf(im) >= sat_level) ? 1 : 0;
        }
      }
    }
    // the look-ahead frame's phase: one dot product per channel
    for (int k = tid; k < M; k += kThreads) {
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

  // 4a. cm mode: |y| time-major, the channel index fastest
  if (kCm) {
    const int n_t = min(FT, T - t0);
    for (int i = tid; i < n_t * M; i += kThreads) {
      const int t = i / M, k = i - t * M;
      mag_tm[(size_t)(t0 + t) * M + k] = mag_s[k * PS + t];
    }
  }

  // 4b. channel-major write, a warp per channel, time across the lanes
  for (int k = warp; k < M; k += kWarps) {
    int carry = 0;
    const size_t row = (size_t)k * T;
    for (int c0 = 0; c0 < FT; c0 += 32) {
      const int t = c0 + lane;
      const int ta = t0 + t;
      const bool in = t < FT && ta < T;
      const int s = in ? sat_s[k * FT + t] : 0;
      const int incl = kCm ? s : sdr::warp_inclusive_sum(s, lane);
      if (in) {
        mag_cm[row + ta] = mag_s[k * PS + t];
        float d = ph_s[k * PS + t + 1] - ph_s[k * PS + t];
        if (d < -180.0f) d += 360.0f;
        if (d > 180.0f) d -= 360.0f;  // strict: exactly +-180 stays
        if (ta >= T - 1) d = 0.0f;
        dph_cm[row + ta] = d;
        sat_out[row + ta] = (float)(carry + incl);
      }
      if (!kCm) carry += __shfl_sync(sdr::kFullMask, incl, 31);
    }
    if (!kCm && lane == 0) tile_tot[(size_t)k * gridDim.x + tile_idx] = carry;
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

template <typename PackedT, bool kCm>
int launch(const void* xq, const void* hist, const float* taps,
           const float* wr, const float* wi, float* mag_tm, float* mag,
           float* dph, float* sat, int* tile_tot, int M, int MP, int P, int T,
           int FT, float scale, float sat_level, cudaStream_t stream) {
  const Smem lay = smem_layout(M, P, FT);
  const size_t bytes = (size_t)lay.n_float * sizeof(float) + (size_t)M * FT;
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel<PackedT, kCm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + FT - 1) / FT;
  channelize_kernel<PackedT, kCm><<<n_tiles, kThreads, bytes, stream>>>(
      static_cast<const PackedT*>(xq), static_cast<const PackedT*>(hist), taps,
      wr, wi, mag_tm, mag, dph, sat, tile_tot, M, MP, P, T, FT, scale,
      sat_level);
  err = cudaGetLastError();
  if (err != cudaSuccess || kCm) return (int)err;
  scan_tiles_kernel<<<M, kScanThreads, 0, stream>>>(tile_tot, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kAddCols - 1) / kAddCols, M);
  add_offsets_kernel<<<grid, 256, 0, stream>>>(sat, tile_tot, M, T, FT);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes, for the wrapper's choice of
// the tile length FT.
extern "C" long long sdr_channelize_cm2_smem(int M, int P, int FT) {
  const Smem lay = smem_layout(M, P, FT);
  return (long long)lay.n_float * sizeof(float) + (long long)M * FT;
}

// packed_bytes: 4 = int32 holding an int16 (I, Q) pair, 2 = int16 holding an
// int8 pair.  hist: (P-1, M) packed frames that precede the block, or null
// for zeros.  MP = M rounded up to 4 (row stride of wr, wi); FT a multiple
// of 4.  Returns the cudaError_t of the first failing call, 0 if none.
extern "C" int sdr_channelize_cm2(const void* xq, int packed_bytes,
                                  const void* hist, const void* taps,
                                  const void* wr, const void* wi, void* mag,
                                  void* dph, void* satcs, void* tile_tot,
                                  int M, int MP, int P, int T, int FT,
                                  float scale, float sat_level, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed_bytes == 4)
    return launch<int32_t, false>(
        xq, hist, (const float*)taps, (const float*)wr, (const float*)wi,
        nullptr, (float*)mag, (float*)dph, (float*)satcs, (int*)tile_tot, M,
        MP, P, T, FT, scale, sat_level, s);
  if (packed_bytes == 2)
    return launch<int16_t, false>(
        xq, hist, (const float*)taps, (const float*)wr, (const float*)wi,
        nullptr, (float*)mag, (float*)dph, (float*)satcs, (int*)tile_tot, M,
        MP, P, T, FT, scale, sat_level, s);
  return (int)cudaErrorInvalidValue;
}

// The cm mode: mag_tm (T, M) time-major |y|; mag, dph, sat (M, T), sat the
// 0/1 saturation mask.  Other arguments as sdr_channelize_cm2.
extern "C" int sdr_channelize_cm(const void* xq, int packed_bytes,
                                 const void* hist, const void* taps,
                                 const void* wr, const void* wi, void* mag_tm,
                                 void* mag, void* dph, void* sat, int M,
                                 int MP, int P, int T, int FT, float scale,
                                 float sat_level, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed_bytes == 4)
    return launch<int32_t, true>(
        xq, hist, (const float*)taps, (const float*)wr, (const float*)wi,
        (float*)mag_tm, (float*)mag, (float*)dph, (float*)sat, nullptr, M, MP,
        P, T, FT, scale, sat_level, s);
  if (packed_bytes == 2)
    return launch<int16_t, true>(
        xq, hist, (const float*)taps, (const float*)wr, (const float*)wi,
        (float*)mag_tm, (float*)mag, (float*)dph, (float*)sat, nullptr, M, MP,
        P, T, FT, scale, sat_level, s);
  return (int)cudaErrorInvalidValue;
}
