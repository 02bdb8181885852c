// Fused channelizer: capture -> detection streams, or the complex bands.
// The bands emitted may be all M, or N of them: a column slice of the DFT
// (a band slice), as the channel-sharded pipeline hands each mesh column.
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
// shift-folded M-point DFT as four real products; then one of four
// epilogues.  cm2 and cm, channel-major (M, T): |y|, the wrapped phase
// difference to the next frame in degrees (zero from column T-1 on) and the
// saturation stream.  In cm2 mode that stream is the inclusive per-channel
// cumulative count of saturated samples.  In cm mode it is the 0/1 mask
// itself, and |y| is also written time-major (T, M).  flat, time-major
// (T, M): |y|, the phase itself in degrees and the 0/1 mask.  complex: y
// itself, (T, M) interleaved (re, im).  All modes are one kernel body: the
// FIR, the DFT and their order of operations are shared, and a frame's
// result does not depend on its place in the tile (as far as 3 below
// says), so |y| and the phase of a frame are the same bits whichever mode
// or tile length computed them.
// The ingest is a second template parameter of that body: packed pairs (one
// int32 holding an int16 (I, Q) pair, or one int16 holding an int8 pair), or
// two planes (int16 or float32, with an element stride, so that a complex64
// capture is read in place as planes of stride 2).
//
// What bounds it on an H100: bytes.  Per frame the DFT is 8*M*M flops; on
// the tensor cores, as the three TF32 products below, that is 0.052 ms at
// M = 64 x 262144 frames against 0.080 ms for the 16 bytes a sample the cm2
// form moves (on the CUDA cores in float32 it would take 0.13 ms).
//
// Design.  A block is persistent: it walks tiles of FT frames and all M
// channels, R = FT rows a tile, or FT + 1 where the phase difference needs
// the next frame (cm2, cm); R is a multiple of 16, the rows of one mma.
//   1. The R + P - 1 frames the tile needs are read, 16 bytes a thread where
//      M and the alignment allow it, dequantized and kept in shared memory
//      (X); frames before the capture or past it are zero.
//   2. The FIR runs out of X, four channels a thread as float4, and leaves
//      U (R x KP, KP = M rounded up to 8, the pad columns zero) row-major.
//   3. The DFT runs on the tensor cores, mma.sync m16n8k8 in TF32, with
//      float32 accuracy kept by a split: x = hi + lo, hi = rna_tf32(x), lo =
//      rna_tf32(x - hi), and a product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
//      the two small terms summed in their own float32 accumulator and added
//      to the large one at the end.  U is split as its fragments are loaded;
//      W is split once per device by the wrapper and laid out in fragment
//      order (n-tile, k-step, lane, 8 floats: wr hi, wr lo, wi hi, wi lo for
//      the lane's two k), so that a lane reads its B fragments as two
//      float4.  W comes through shared memory by cp.async in chunks of
//      n-tiles x k-steps; at M <= 64 one chunk holds all of it, and it is
//      staged once per block and stays for every tile.  Every row takes the
//      same sequence of mma (k ascending), and the look-ahead frame is
//      computed as row FT of the tile.  That it has the bits that row 0 of
//      the next tile gives it also needs the tensor core to sum every row
//      of an m16n8k8 in the same order, which PTX does not document: it is
//      a property observed on sm_90 (CUDA 12.8) and checked by
//      chip_smoke.py's tile-boundary cases, not a guarantee of the design;
//      another architecture or toolkit must run those cases again.  A warp
//      owns one m-tile x two n-tiles of a chunk.
//      A band slice.  W is then the (M, N) column slice the wrapper is given,
//      split and laid out the same way: NT = N / 8 n-tiles (rounded up) over
//      the KS = M / 8 k-steps (rounded up) of the full contraction, the k
//      order unchanged.  Each emitted band sums the same products of the
//      same split W entries in the same order as in the full kernel; that
//      its bits are the full kernel's row, whatever column of an n-tile it
//      lands in, needs the tensor core to sum every column of an m16n8k8 in
//      the same order too: the same property observed on sm_90, and checked
//      by chip_smoke.py with slices that start on and off a multiple of 8.
//   4. Per chunk of channels the accumulators become |y| (sqrtf), the phase
//      (Cephes atan2 polynomial, as the TPU kernel) and the saturation flag,
//      in shared memory channel-major (over X, dead by then); then the
//      time-major outputs leave with the channel index fastest, and the
//      channel-major ones a warp per channel with time across the lanes (the
//      tiled transpose), taking the phase difference and counting the flags
//      (a ballot and a population count) on the way.
// Blocks run in no order, so the saturation count is cumulative inside the
// tile only; each tile leaves its total, `scan_tiles` (one block a channel)
// turns the totals into exclusive offsets, and `add_offsets` adds them,
// touching only tiles whose offset is not zero (a capture that never clips
// costs nothing there).  The ragged last tile and any M are masked; the
// mma's K and N are padded with zeros in shared memory.  The cm mode needs
// no count, so neither small kernel runs there.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrag = 256;          // floats of one (n-tile, k-step) of W
constexpr int kWChunkBlocks = 64;   // (n-tile, k-step) blocks a chunk, 64 KB
constexpr int kTileRows[] = {64, 48, 32, 16};  // rows a tile, by preference
// two blocks a multiprocessor: 228 KB of shared memory, 1 KB kept a block
constexpr long long kSmemTarget = 113 * 1024;
constexpr long long kSmemMax = 227 * 1024;  // what one block may use, sm_90
constexpr int kIngest = 3;          // ingest loads a thread keeps in flight
constexpr int kMaxDevices = 64;

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
// before the block, or is null.  load4 reads samples g .. g+3 at once
// (16 bytes of int16 pairs, 8 of int8 pairs).
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
  __device__ __forceinline__ void load4(long long g, float* i, float* q) const {
    if constexpr (sizeof(T) == 4) {
      const int4 v = *reinterpret_cast<const int4*>(x + g);
      unpack((int32_t)v.x, i[0], q[0]);
      unpack((int32_t)v.y, i[1], q[1]);
      unpack((int32_t)v.z, i[2], q[2]);
      unpack((int32_t)v.w, i[3], q[3]);
    } else {
      const int2 v = *reinterpret_cast<const int2*>(x + g);
      unpack((int16_t)(v.x & 0xffff), i[0], q[0]);
      unpack((int16_t)(v.x >> 16), i[1], q[1]);
      unpack((int16_t)(v.y & 0xffff), i[2], q[2]);
      unpack((int16_t)(v.y >> 16), i[3], q[3]);
    }
  }
};

// Two planes, sample g at element g * stride of each; the history planes
// are dense.  load4 needs stride 1, or stride 2 with xi = xr + 1 (a
// complex64 capture: 32 bytes of interleaved pairs).
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
  __device__ __forceinline__ void load4(long long g, float* i, float* q) const {
    if constexpr (sizeof(T) == 2) {
      const int2 a = *reinterpret_cast<const int2*>(xr + g);
      const int2 b = *reinterpret_cast<const int2*>(xi + g);
      i[0] = (float)(int16_t)(a.x & 0xffff); i[1] = (float)(a.x >> 16);
      i[2] = (float)(int16_t)(a.y & 0xffff); i[3] = (float)(a.y >> 16);
      q[0] = (float)(int16_t)(b.x & 0xffff); q[1] = (float)(b.x >> 16);
      q[2] = (float)(int16_t)(b.y & 0xffff); q[3] = (float)(b.y >> 16);
    } else if (stride == 1) {
      const float4 a = *reinterpret_cast<const float4*>(xr + g);
      const float4 b = *reinterpret_cast<const float4*>(xi + g);
      i[0] = (float)a.x; i[1] = (float)a.y; i[2] = (float)a.z; i[3] = (float)a.w;
      q[0] = (float)b.x; q[1] = (float)b.y; q[2] = (float)b.z; q[3] = (float)b.w;
    } else {
      const float4 a = *reinterpret_cast<const float4*>(xr + 2 * g);
      const float4 b = *reinterpret_cast<const float4*>(xr + 2 * g + 4);
      i[0] = (float)a.x; q[0] = (float)a.y; i[1] = (float)a.z; q[1] = (float)a.w;
      i[2] = (float)b.x; q[2] = (float)b.y; i[3] = (float)b.z; q[3] = (float)b.w;
    }
  }
};

enum Mode { kCm2 = 0, kCm = 1, kFlat = 2, kComplex = 3 };

// The shapes of a block's work and its shared memory, in floats.
struct Plan {
  int R;         // rows a tile, a multiple of 16
  int MX;        // X row stride: M rounded up to 4
  int KP;        // the mma's K: M rounded up to 8
  int NT, KS;    // n-tiles (emitted bands N / 8, up) and k-steps (KP / 8)
  int SU;        // U row stride, KP + 4: conflict-free fragment loads
  int PS;        // staging row stride (channel-major), R + 1
  int nct, kcs;  // a chunk of W: n-tiles x k-steps
  int off_w;     // W chunk after U (2 * R * SU)
  int off_x;     // X, later the staging, after the W chunk
  long long bytes;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline Plan make_plan(int M, int N, int P, int R,
                                          int nct, int kcs) {
  Plan p;
  p.R = R;
  p.MX = (M + 3) / 4 * 4;
  p.KP = (M + 7) / 8 * 8;
  p.NT = (N + 7) / 8;
  p.KS = p.KP / 8;
  p.SU = p.KP + 4;
  p.PS = R + 1;
  p.nct = nct;
  p.kcs = kcs;
  p.off_w = 2 * R * p.SU;
  p.off_x = p.off_w + nct * kcs * kFrag;
  const int x = 2 * (R + P - 1) * p.MX;
  const int staging = 2 * nct * 8 * p.PS + ceil_div(nct * 8 * R, 4);
  p.bytes = 4LL * (p.off_x + (x > staging ? x : staging));
  return p;
}

// The plan for R rows within `cap` bytes: all of W resident, or with
// `chunks` the largest chunk of it that fits.  bytes < 0: none fits.
inline Plan plan_for(int M, int N, int P, int R, long long cap, int chunks) {
  const int NT = (N + 7) / 8, KS = (M + 7) / 8, MT = R / 16;
  Plan p = make_plan(M, N, P, R, NT, KS);
  // a warp holds the accumulators of one unit (m-tile x two n-tiles)
  const int units = kWarps;
  if (p.bytes <= cap && MT * ceil_div(NT, 2) <= units) return p;
  p.bytes = -1;
  if (!chunks || MT > units) return p;
  int nct = NT < 2 * (units / MT) ? NT : 2 * (units / MT);
  for (; nct >= 1; nct /= 2) {
    const int k_max = kWChunkBlocks / nct > 1 ? kWChunkBlocks / nct : 1;
    for (int kcs = KS < k_max ? KS : k_max; kcs >= 1; kcs /= 2) {
      p = make_plan(M, N, P, R, nct, kcs);
      if (MT * ceil_div(nct, 2) <= units && p.bytes <= cap) return p;
    }
  }
  p.bytes = -1;
  return p;
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo, each a TF32 value (low 13 bits zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// kCm2: sat_out = cumulative count inside the tile, tile_tot written, tm0-2
// unused.  kCm: sat_out = 0/1 mask, tm0 = time-major |y|, tile_tot unused.
// kFlat: tm0, tm1, tm2 = time-major |y|, phase, mask; nothing channel-major.
// kComplex: tm0 = (T, M) float2 of (re, im); nothing else.
template <typename In, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
channelize_kernel(const In in, const int vec,
                  const float* __restrict__ taps,    // (P, MX), pad zero
                  const float* __restrict__ wfrag,   // (NT, KS, 32, 8)
                  float* __restrict__ tm0,           // (T, N)
                  float* __restrict__ tm1,
                  float* __restrict__ tm2,
                  float* __restrict__ mag_cm,        // (N, T)
                  float* __restrict__ dph_cm,
                  float* __restrict__ sat_out,
                  int* __restrict__ tile_tot,        // (N, n_tiles)
                  const Plan pl, int M, int N, int P, int T, int FT,
                  int n_tiles,
                  float scale, float sat_level) {
  constexpr bool kCmOut = kMode == kCm2 || kMode == kCm;  // look-ahead too
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the mma's groupID, thread
  const int R = pl.R, SU = pl.SU, PS = pl.PS, MX = pl.MX;

  float* Ur = smem;
  float* Ui = smem + R * SU;
  float* Wsm = smem + pl.off_w;
  float* Xr = smem + pl.off_x;
  float* Xi = Xr + (R + P - 1) * MX;
  // after the FIR the X region is dead and holds these instead
  float* mag_s = smem + pl.off_x;
  float* ph_s = mag_s + pl.nct * 8 * PS;
  unsigned char* sat_s =
      reinterpret_cast<unsigned char*>(ph_s + pl.nct * 8 * PS);

  const int n_nc = ceil_div(pl.NT, pl.nct), n_kc = ceil_div(pl.KS, pl.kcs);
  const int MT = R / 16;
  const int NG = (pl.nct + 1) / 2;  // n-tile pairs a chunk
  const float rad2deg = 57.29577951308232f;
  int staged = -1;  // the chunk of W in shared memory

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * FT;

    // 1. frames t0-(P-1) .. t0+R-1, dequantized; the frames before the
    //    block come from `hist` (only the first tile reaches them)
    {
      const long long base = (long long)(t0 - (P - 1)) * M;
      const long long n_all = (long long)T * M;
      const long long n_hist = (long long)(P - 1) * M;
      const int rows = R + P - 1;
      auto scalar = [&](long long g, float& vi, float& vq) {
        vi = vq = 0.0f;
        if (g >= 0 && g < n_all) {
          in.load(g, vi, vq);
        } else if (g < 0 && in.has_hist()) {
          in.load_hist(g + n_hist, vi, vq);
        }
      };
      if (vec) {  // M % 4 == 0 and aligned: a group of four never straddles
        const int q_row = M / 4, n_q = rows * q_row;
        // kIngest loads a thread in flight before the first is used
        for (int i0 = 0; i0 < n_q; i0 += kIngest * kThreads) {
          float vi[kIngest][4], vq[kIngest][4];
#pragma unroll
          for (int j = 0; j < kIngest; ++j) {
            const int i = i0 + j * kThreads + tid;
            const int row = i / q_row, col = (i - row * q_row) * 4;
            const long long g = base + (long long)row * M + col;
            if (i >= n_q) continue;
            if (g >= 0 && g + 3 < n_all) {
              in.load4(g, vi[j], vq[j]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) scalar(g + e, vi[j][e], vq[j][e]);
            }
          }
#pragma unroll
          for (int j = 0; j < kIngest; ++j) {
            const int i = i0 + j * kThreads + tid;
            if (i >= n_q) continue;
            const int row = i / q_row, col = (i - row * q_row) * 4;
            *reinterpret_cast<float4*>(Xr + row * MX + col) =
                make_float4(vi[j][0] * scale, vi[j][1] * scale,
                            vi[j][2] * scale, vi[j][3] * scale);
            *reinterpret_cast<float4*>(Xi + row * MX + col) =
                make_float4(vq[j][0] * scale, vq[j][1] * scale,
                            vq[j][2] * scale, vq[j][3] * scale);
          }
        }
      } else {
        for (int i = tid; i < rows * MX; i += kThreads) {
          const int row = i / MX, col = i - row * MX;
          float vi = 0.0f, vq = 0.0f;
          if (col < M) scalar(base + (long long)row * M + col, vi, vq);
          Xr[i] = vi * scale;
          Xi[i] = vq * scale;
        }
      }
    }
    __syncthreads();

    // 2. branch FIR, four channels a thread:
    //    u[t, rho] = sum_p taps[p, rho] * x[t - p, rho]
    {
      const int q_row = pl.KP / 4;
      for (int i = tid; i < R * q_row; i += kThreads) {
        const int t = i / q_row, c = (i - t * q_row) * 4;
        float4 ar = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ai = ar;
        if (c < MX) {
          for (int p = 0; p < P; ++p) {
            const float4 tap =
                __ldg(reinterpret_cast<const float4*>(taps + p * MX + c));
            const int xi = (t + P - 1 - p) * MX + c;
            const float4 xr4 = *reinterpret_cast<const float4*>(Xr + xi);
            const float4 xi4 = *reinterpret_cast<const float4*>(Xi + xi);
            ar.x = fmaf(tap.x, xr4.x, ar.x);
            ar.y = fmaf(tap.y, xr4.y, ar.y);
            ar.z = fmaf(tap.z, xr4.z, ar.z);
            ar.w = fmaf(tap.w, xr4.w, ar.w);
            ai.x = fmaf(tap.x, xi4.x, ai.x);
            ai.y = fmaf(tap.y, xi4.y, ai.y);
            ai.z = fmaf(tap.z, xi4.z, ai.z);
            ai.w = fmaf(tap.w, xi4.w, ai.w);
          }
        }
        *reinterpret_cast<float4*>(Ur + t * SU + c) = ar;
        *reinterpret_cast<float4*>(Ui + t * SU + c) = ai;
      }
    }
    __syncthreads();

    // 3-4. per chunk of channels: the DFT, then its outputs.  A warp owns
    // one unit: m-tile mt (16 rows) x n-tiles 2 np and 2 np + 1 of the chunk
    const bool busy = warp < MT * NG;
    const int mt = warp / NG, np = warp - mt * NG;
    for (int nc = 0; nc < n_nc; ++nc) {
      // acc[n-tile][yr small, yi small, yr large, yi large][element]
      float acc[2][4][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.0f;

      for (int kc = 0; kc < n_kc; ++kc) {
        const int id = nc * n_kc + kc;
        if (id != staged) {  // the same for the whole block
          if (staged >= 0) __syncthreads();  // the last chunk is read
          const int k0 = kc * pl.kcs, nk = min(pl.kcs, pl.KS - k0);
          for (int ln = 0; ln < pl.nct; ++ln) {
            const int nt = nc * pl.nct + ln;
            if (nt >= pl.NT) break;
            const float* src = wfrag + ((size_t)nt * pl.KS + k0) * kFrag;
            float* dst = Wsm + (size_t)ln * pl.kcs * kFrag;
            for (int i = tid; i < nk * kFrag / 4; i += kThreads)
              cp_async16(dst + 4 * i, src + 4 * i);
          }
          cp_async_wait_all();
          __syncthreads();
          staged = id;
        }
        const int nks = busy ? min(pl.kcs, pl.KS - kc * pl.kcs) : 0;
        for (int ks = 0; ks < nks; ++ks) {
          const int kcol = (kc * pl.kcs + ks) * 8 + tig;
          const int r0 = mt * 16 + gid;
          uint32_t ur_hi[4], ur_lo[4], ui_hi[4], ui_lo[4], nui_hi[4],
              nui_lo[4];
          const int offs[4] = {r0 * SU + kcol, (r0 + 8) * SU + kcol,
                               r0 * SU + kcol + 4, (r0 + 8) * SU + kcol + 4};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split(Ur[offs[e]], ur_hi[e], ur_lo[e]);
            split(Ui[offs[e]], ui_hi[e], ui_lo[e]);
            nui_hi[e] = ui_hi[e] ^ 0x80000000u;  // exact negation
            nui_lo[e] = ui_lo[e] ^ 0x80000000u;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ln = 2 * np + j;
            if (ln >= pl.nct || nc * pl.nct + ln >= pl.NT) break;
            const float* b =
                Wsm + ((size_t)ln * pl.kcs + ks) * kFrag + lane * 8;
            const float4 w_r = *reinterpret_cast<const float4*>(b);
            const float4 w_i = *reinterpret_cast<const float4*>(b + 4);
            const uint32_t wr_h0 = __float_as_uint(w_r.x),
                           wr_h1 = __float_as_uint(w_r.y),
                           wr_l0 = __float_as_uint(w_r.z),
                           wr_l1 = __float_as_uint(w_r.w);
            const uint32_t wi_h0 = __float_as_uint(w_i.x),
                           wi_h1 = __float_as_uint(w_i.y),
                           wi_l0 = __float_as_uint(w_i.z),
                           wi_l1 = __float_as_uint(w_i.w);
            // yr = ur wr - ui wi, yi = ur wi + ui wr: the small terms into
            // a[0] (yr) and a[1] (yi), the large ones into a[2] and a[3],
            // in an order where no product waits on the one just before it
            float(&a)[4][4] = acc[j];
            mma_tf32(a[0], ur_lo, wr_h0, wr_h1);
            mma_tf32(a[1], ur_lo, wi_h0, wi_h1);
            mma_tf32(a[2], ur_hi, wr_h0, wr_h1);
            mma_tf32(a[3], ur_hi, wi_h0, wi_h1);
            mma_tf32(a[0], ur_hi, wr_l0, wr_l1);
            mma_tf32(a[1], ur_hi, wi_l0, wi_l1);
            mma_tf32(a[2], nui_hi, wi_h0, wi_h1);
            mma_tf32(a[3], ui_hi, wr_h0, wr_h1);
            mma_tf32(a[0], nui_lo, wi_h0, wi_h1);
            mma_tf32(a[1], ui_lo, wr_h0, wr_h1);
            mma_tf32(a[0], nui_hi, wi_l0, wi_l1);
            mma_tf32(a[1], ui_hi, wr_l0, wr_l1);
          }
        }
      }

      // the chunk's channels [kb, kb + nk): |y|, phase, flag to shared
      const int kb = nc * pl.nct * 8, nk = min(pl.nct * 8, N - kb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = mt * 16 + gid + (e >= 2 ? 8 : 0);
          const int kl = (2 * np + j) * 8 + 2 * tig + (e & 1);
          if (!busy || kl >= nk) continue;
          const float re = acc[j][2][e] + acc[j][0][e];
          const float im = acc[j][3][e] + acc[j][1][e];
          if (kMode == kComplex) {
            mag_s[kl * PS + t] = re;
            ph_s[kl * PS + t] = im;
            continue;
          }
          mag_s[kl * PS + t] = sqrtf(re * re + im * im);
          ph_s[kl * PS + t] = atan2_cephes(im, re) * rad2deg;
          sat_s[kl * R + t] =
              (fabsf(re) >= sat_level || fabsf(im) >= sat_level) ? 1 : 0;
        }
      }
      __syncthreads();

      // the time-major outputs, the channel index fastest
      if (kMode != kCm2) {
        const int n_t = min(FT, T - t0);
        for (int i = tid; i < n_t * nk; i += kThreads) {
          const int t = i / nk, kl = i - t * nk;
          const size_t g = (size_t)(t0 + t) * N + kb + kl;
          if (kMode == kComplex) {
            reinterpret_cast<float2*>(tm0)[g] =
                make_float2(mag_s[kl * PS + t], ph_s[kl * PS + t]);
            continue;
          }
          tm0[g] = mag_s[kl * PS + t];
          if (kMode == kFlat) {
            tm1[g] = ph_s[kl * PS + t];
            tm2[g] = (float)sat_s[kl * R + t];
          }
        }
      }
      // the channel-major outputs, a warp per channel, time across the lanes
      if (kCmOut) {
        constexpr bool kMask = kMode == kCm;
        for (int kl = warp; kl < nk; kl += kWarps) {
          int carry = 0;
          const size_t row = (size_t)(kb + kl) * T;
          for (int c0 = 0; c0 < FT; c0 += 32) {
            const int t = c0 + lane;
            const int ta = t0 + t;
            const bool live = t < FT && ta < T;
            const int sv = live ? sat_s[kl * R + t] : 0;
            // a 0/1 flag: the inclusive count is a population count
            const unsigned flags = __ballot_sync(sdr::kFullMask, sv != 0);
            const unsigned upto = 0xffffffffu >> (31 - lane);
            const int incl = kMask ? sv : carry + __popc(flags & upto);
            if (live) {
              mag_cm[row + ta] = mag_s[kl * PS + t];
              float d = ph_s[kl * PS + t + 1] - ph_s[kl * PS + t];
              if (d < -180.0f) d += 360.0f;
              if (d > 180.0f) d -= 360.0f;  // strict: exactly +-180 stays
              if (ta >= T - 1) d = 0.0f;
              dph_cm[row + ta] = d;
              sat_out[row + ta] = (float)incl;
            }
            carry += __popc(flags);
          }
          if (!kMask && lane == 0)
            tile_tot[(size_t)(kb + kl) * n_tiles + tile] = carry;
        }
      }
      __syncthreads();  // the staging (over X) is rewritten next
    }
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
                                   const int* __restrict__ offs, int T,
                                   int FT) {
  const int k = blockIdx.y;
  for (int t = blockIdx.x * kAddCols + threadIdx.x;
       t < min(T, (int)(blockIdx.x + 1) * kAddCols); t += blockDim.x) {
    const int o = offs[(size_t)k * ((T + FT - 1) / FT) + t / FT];
    if (o != 0) satcs_cm[(size_t)k * T + t] += (float)o;
  }
}

struct Args {
  int vec;
  const float* taps;
  const float* wfrag;
  float* out[6];  // tm0, tm1, tm2, mag_cm, dph_cm, sat_out
  int* tile_tot;
  int M, N, P, T, FT;
  Plan plan;
  float scale, sat_level;
  cudaStream_t stream;
};

template <typename In, int kMode>
int launch(const In& in, const Args& a) {
  const Plan& pl = a.plan;
  auto kernel = channelize_kernel<In, kMode>;
  // the kernel's attributes and its blocks a multiprocessor, set and asked
  // once per device and shared-memory size
  static long long configured[kMaxDevices];
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (configured[dev] != pl.bytes + 1) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (err != cudaSuccess) return (int)err;
    // all of the unified L1 / shared memory as shared: two blocks fit
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, (size_t)pl.bytes)) != cudaSuccess)
      return (int)err;
    resident[dev] = max(per_sm, 1) * sms;
    configured[dev] = pl.bytes + 1;
  }
  const int n_tiles = (a.T + a.FT - 1) / a.FT;
  const int grid = min(n_tiles, resident[dev]);
  kernel<<<grid, kThreads, pl.bytes, a.stream>>>(
      in, a.vec, a.taps, a.wfrag, a.out[0], a.out[1], a.out[2], a.out[3],
      a.out[4], a.out[5], a.tile_tot, pl, a.M, a.N, a.P, a.T, a.FT, n_tiles,
      a.scale, a.sat_level);
  err = cudaGetLastError();
  if (err != cudaSuccess || kMode != kCm2) return (int)err;
  scan_tiles_kernel<<<a.N, kScanThreads, 0, a.stream>>>(a.tile_tot, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((a.T + kAddCols - 1) / kAddCols, a.N);
  add_offsets_kernel<<<grid2, 256, 0, a.stream>>>(a.out[5], a.tile_tot, a.T,
                                                  a.FT);
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

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The plan of a block for tiles of R rows (FT frames, plus one in the cm2
// and cm modes), R a positive multiple of 16, or with R = 0 the most rows
// of kTileRows that fit, for M branches and N emitted bands.  Preferred in turn: W resident with room for two
// blocks a multiprocessor, W resident in one block's most, then W staged a
// chunk at a time within each.  Returns the bytes of shared memory, or -1
// if nothing fits; plan[0..2]: R, and the n-tiles and k-steps of a chunk,
// for sdr_channelize.
extern "C" long long sdr_channelize_plan(int M, int N, int P, int R,
                                         int* plan) {
  if (M <= 0 || N <= 0 || P <= 0 || R < 0 || R % 16) return -1;
  const long long caps[2] = {kSmemTarget, kSmemMax};
  const int n_rows = R ? 1 : sizeof(kTileRows) / sizeof(kTileRows[0]);
  for (int chunks = 0; chunks < 2; ++chunks)
    for (int c = 0; c < 2; ++c)
      for (int i = 0; i < n_rows; ++i) {
        const int r = R ? R : kTileRows[i];
        const Plan p = plan_for(M, N, P, r, caps[c], chunks);
        if (p.bytes > 0) {
          plan[0] = r;
          plan[1] = p.nct;
          plan[2] = p.kcs;
          return p.bytes;
        }
      }
  return -1;
}

// mode: 0 = cm2, 1 = cm, 2 = flat, 3 = complex (float32 planes only).
// ingest: 0 = x0 packed int32 (an int16 (I, Q) pair an element), 1 = x0
// packed int16 (an int8 pair), 2 = x0, x1 int16 planes, 3 = x0, x1 float32
// planes; a plane's sample g is its element g * stride.  h0 (and h1 for
// planes): the (P-1, M) samples that precede the block, dense, or null for
// zeros.  taps: (P, MX) float32, MX = M rounded up to 4, the pad columns
// zero.  N: the bands emitted, M or a band slice's width.  wfrag: the split
// DFT planes (or the slice's) in fragment order, (NT, KS, 32, 8) float32
// (see the wrapper).  out0..out5: time-major (T, N) |y| (cm, flat) or
// interleaved y (complex); time-major phase and mask (flat); channel-major
// (N, T) |y|, phase difference and saturation count or mask (cm2, cm);
// unused ones may be null.  FT: frames a tile; R = FT + 1 in the
// cm2 and cm modes, else FT, a multiple of 16; nct, kcs: the chunk of W
// that sdr_channelize_plan gave for R.  Returns the cudaError_t of the
// first failing call, 0 if none.
extern "C" int sdr_channelize(int mode, int ingest, const void* x0,
                              const void* x1, const void* h0, const void* h1,
                              int stride, const void* taps, const void* wfrag,
                              void* out0, void* out1, void* out2, void* out3,
                              void* out4, void* out5, void* tile_tot, int M,
                              int N, int P, int T, int FT, int nct, int kcs,
                              float scale, float sat_level, void* stream) {
  Args a;
  a.taps = (const float*)taps;
  a.wfrag = (const float*)wfrag;
  void* outs[6] = {out0, out1, out2, out3, out4, out5};
  for (int i = 0; i < 6; ++i) a.out[i] = (float*)outs[i];
  a.tile_tot = (int*)tile_tot;
  a.M = M; a.N = N; a.P = P; a.T = T; a.FT = FT;
  const int R = FT + (mode == kCm2 || mode == kCm ? 1 : 0);
  if (FT <= 0 || R % 16 || nct <= 0 || kcs <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  a.plan = make_plan(M, N, P, R, nct, kcs);
  a.scale = scale;
  a.sat_level = sat_level;
  a.stream = static_cast<cudaStream_t>(stream);
  // four samples at once where M keeps a group of four inside a frame and
  // the pointers are aligned to it
  const int esize = ingest == 0 || ingest == 3 ? 4 : 2;
  const int vbytes = 4 * esize * stride;
  const int vb = vbytes > 16 ? 16 : vbytes;
  a.vec = M % 4 == 0 && aligned(x0, vb) &&
          (stride == 1 ? aligned(x1, vb)
                       : ingest == 3 && stride == 2 &&
                             (const float*)x1 == (const float*)x0 + 1);
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
