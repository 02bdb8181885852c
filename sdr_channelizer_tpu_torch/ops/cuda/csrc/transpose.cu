// Time-major detection streams -> channel-major, with the phase difference.
//
// Replaces the TPU kernel `_cm_kernel`
// (sdr_channelizer_tpu/ops/pallas/transpose_kernel.py, reached through
// `pallas_cm_streams`).
//
// What it computes: from the (T, M) magnitude, phase in degrees and
// saturation mask, the (M, T) streams the statistics kernel reads:
// mag_cm = mag^T, sat_cm = sat^T (as 0/1 float32) and
// dph_cm[k, t] = wrap(ph[t + 1, k] - ph[t, k]), the difference wrapped once
// into [-180, 180] (subtract; below -180 add 360; then above 180 subtract
// 360) and zero from column T - 1 on.  The two flips move bits, so they
// equal `.T` exactly; the difference is taken in the order the reference
// takes it.
//
// What bounds it on an H100: memory.  Three streams are read once and three
// written once, 24 bytes a sample, and nothing is computed but one
// subtraction.
//
// Design.  A block owns a tile of TT frames x MT channels, MT = min(M, 32)
// and TT * MT about 2048 samples, so a tile is a long run of time at M = 1
// and 64 frames x 32 channels at M = 64.
//   1. The tile of the three streams is read with the channel index
//      fastest (rows of MT consecutive floats: whole 128-byte lines at
//      MT = 32, one contiguous stretch when MT = M) into shared memory, the
//      phase with one more row, the look-ahead frame (zero past the end).
//   2. The tile is read back with time fastest and written to the (M, T)
//      rows, 32 consecutive columns a warp.  The shared rows have an odd
//      stride, so both the store of step 1 and the load of step 2 touch 32
//      different banks.  The difference is formed on the way out.
// Any M from 1 and any T: the ragged tiles are masked, nothing is padded.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;

__host__ __device__ inline int tile_channels(int M) { return M < 32 ? M : 32; }
__host__ __device__ inline int tile_frames(int M) {
  return kTileElems / tile_channels(M);
}
__host__ __device__ inline int row_stride(int M) { return tile_channels(M) | 1; }

__device__ __forceinline__ float as_mask(float v) { return v; }
__device__ __forceinline__ float as_mask(unsigned char v) {
  return v ? 1.0f : 0.0f;
}

template <typename SatT>
__global__ void __launch_bounds__(kThreads)
cm_streams_kernel(const float* __restrict__ mag,  // (T, M)
                  const float* __restrict__ ph,   // (T, M)
                  const SatT* __restrict__ sat,   // (T, M)
                  float* __restrict__ mag_cm,     // (M, T)
                  float* __restrict__ dph_cm, float* __restrict__ sat_cm,
                  int M, int T) {
  extern __shared__ float smem[];
  const int MT = tile_channels(M), TT = tile_frames(M), RS = row_stride(M);
  float* s_mag = smem;
  float* s_sat = s_mag + TT * RS;
  float* s_ph = s_sat + TT * RS;  // TT + 1 rows

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * TT;
  const int c0 = blockIdx.y * MT;
  const int nc = min(MT, M - c0);
  const int nt = (int)min((long long)TT, T - t0);

  // 1. time-major read, the channel index fastest
  for (int i = tid; i < (nt + 1) * nc; i += kThreads) {
    const int t = i / nc, c = i - t * nc;
    const long long ta = t0 + t;
    const size_t g = (size_t)ta * M + c0 + c;
    s_ph[t * RS + c] = ta < T ? ph[g] : 0.0f;
    if (t < nt) {
      s_mag[t * RS + c] = mag[g];
      s_sat[t * RS + c] = as_mask(sat[g]);
    }
  }
  __syncthreads();

  // 2. channel-major write, time fastest
  for (int i = tid; i < nc * TT; i += kThreads) {
    const int c = i / TT, t = i - c * TT;
    if (t >= nt) continue;
    const long long ta = t0 + t;
    const size_t g = (size_t)(c0 + c) * T + ta;
    mag_cm[g] = s_mag[t * RS + c];
    sat_cm[g] = s_sat[t * RS + c];
    float d = s_ph[(t + 1) * RS + c] - s_ph[t * RS + c];
    if (d < -180.0f) d += 360.0f;
    if (d > 180.0f) d -= 360.0f;  // strict: exactly +-180 stays
    if (ta >= (long long)T - 1) d = 0.0f;
    dph_cm[g] = d;
  }
}

template <typename SatT>
int launch(const float* mag, const float* ph, const void* sat, float* mag_cm,
           float* dph_cm, float* sat_cm, int M, int T, cudaStream_t stream) {
  const int MT = tile_channels(M), TT = tile_frames(M), RS = row_stride(M);
  const size_t bytes = (size_t)(3 * TT + 1) * RS * sizeof(float);
  dim3 grid((unsigned)(((long long)T + TT - 1) / TT), (M + MT - 1) / MT);
  cm_streams_kernel<SatT><<<grid, kThreads, bytes, stream>>>(
      mag, ph, static_cast<const SatT*>(sat), mag_cm, dph_cm, sat_cm, M, T);
  return (int)cudaGetLastError();
}

}  // namespace

// mag, ph: (T, M) float32 contiguous; sat: (T, M), float32 0/1 when
// sat_bytes = 4, one byte a sample (zero or not) when sat_bytes = 1; the
// three outputs (M, T) float32.  Returns the cudaError_t of the launch.
extern "C" int sdr_cm_streams(const void* mag, const void* ph, const void* sat,
                              int sat_bytes, void* mag_cm, void* dph_cm,
                              void* sat_cm, int M, int T, void* stream) {
  if (M <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sat_bytes == 4)
    return launch<float>((const float*)mag, (const float*)ph, sat,
                         (float*)mag_cm, (float*)dph_cm, (float*)sat_cm, M, T,
                         s);
  if (sat_bytes == 1)
    return launch<unsigned char>((const float*)mag, (const float*)ph, sat,
                                 (float*)mag_cm, (float*)dph_cm,
                                 (float*)sat_cm, M, T, s);
  return (int)cudaErrorInvalidValue;
}
