// VIF kernels: scales 1-3 of the quality chunk (rtvqa_vif_tail), and VIF at
// one scale with the next scale's inputs (rtvqa_vif_scale). Both run one
// stencil, vif_tail_kernel<T, R, R2>: from one staged tile of a scale's
// pair, the VIF statistics at 2R+1 taps and, for R2 > 0, the next scale's
// (2R2+1)-tap filter at the even rows and columns.
//
// rtvqa_vif_tail, from the scale-1 inputs (the 9-tap filtered,
// 2x-decimated luma pair that csrc/quality.cu writes).
//
// Replaces: rtvqa_tpu/kernels/vif_pallas.py::vif_tail_pallas (kernel body
// _vif_tail_kernel). The TPU kernel held a whole frame pair per grid cell in
// VMEM and ran the three scales back to back, with band-matrix filters on
// the MXU. Here one launch of vif_tail_kernel per scale computes both the
// statistics and, below scale 3, the next scale's pair, which it writes to
// a device scratch (at 1080p the scale-2 pair is 2 x 64 x 270 x 480 f32 =
// 66 MB, mostly served from the 50 MB L2). So each scale's pair is read
// once: 9+5 taps, 5+3, then 3, then one fixed-order reduce of the three
// scales' per-tile sums.
//
// rtvqa_vif_scale, one scale s of 0-3 on a (b, h, w) pair, u8 or f32.
//
// Replaces: rtvqa_tpu/kernels/vif_pallas.py::vif_scale_pallas (kernel body
// _vif_scale_kernel), which the JAX package chains over scales 0-3 for
// frames wider than 3840 (vif_features_pallas). The TPU kernel DMA'd
// 8-aligned row windows of the raw frame per strip and ran the moment and
// decimation filters as banded MXU matmuls. Here one launch of
// vif_tail_kernel at 2^(4-s)+1 taps with (s < 3) the next scale's
// 2^(3-s)+1-tap decimation, writing the cropped (b, ceil(h/2), ceil(w/2))
// f32 pair, then one reduce_rows_kernel. Scales 1-3 are kernel 5's
// instantiations; scale 0 is the same stencil on u8 at R = 8, R2 = 4.
//
// The stencil (kernel 3's, csrc/quality.cu): a block owns an 8 x 240 tile.
// It stages the tile's window of ref and dis once (common.cuh stage_tile:
// 16-byte cp.async pieces, the side halo rounded up to whole pieces, border
// tiles mirrored in shared memory, unaligned frames gathered). Its vertical
// pass gives one column per thread (240 + 2R <= 256 columns) and keeps the
// five moments of the tile's 8 rows and the 4 even decimation rows in
// registers; its horizontal pass computes runs of 8 outputs per thread from
// 16-byte loads of padded moment rows. The moment taps are FMAs. A tile in
// which any pixel's ref window is flat (sigma1^2 < kFlatTol * E[x^2];
// letterbox bars, flat areas) redoes its moments with separate multiplies
// and adds in the plain version's order (see csrc/quality.cu, "Numerics").
// The decimation taps keep the plain version's order, so the next scale
// sees the plain version's inputs bit for bit. The registers' outputs go to
// a moment buffer that overlays the stage once every thread has read its
// column; the buffer (55 KB) is larger than any stage (13 KB for u8 at
// R = 8, 48 KB for f32 at R = 8), so it sizes the block's shared memory.
//
// Bound on the H100: operations. Per 64-frame 1080p chunk the tail reads
// the 265 MB scale-1 pair once (~0.08 ms at 3.35 TB/s; the scratch round
// trips add ~0.1 GB) and does ~200 f32 operations per scale-1 pixel (five
// 9-tap moment filters dominate): ~7e9, ~0.1 ms at 67 TFLOP/s. At DCI 4K
// scale 0 (14 frames of 2160 x 4096, u8 pair) a kernel-4 call reads 248 MB
// and writes 248 MB of dec planes (~0.15 ms) and does 363 operations per
// pixel for the five 17-tap moment filters and the statistics, plus ~25 per
// pixel for the 9-tap decimation of both frames: ~4.8e10, ~0.72 ms.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// ----- The stencil: one kernel per scale --------------------------------------

constexpr int kTailTH = kThreads / 32;           // 8 output rows: one warp per row
constexpr int kTailTW = 240;                     // output columns (960 = 4 tiles)
constexpr int kTailPitch = kThreads + kThreads / 8;  // vertical-pass columns, padded (pc)
constexpr int kTailRun = 8;                      // horizontal outputs per thread
constexpr int kTailRuns = kTailTW / kTailRun;    // 30 runs per row
constexpr int kTailDecRows = kTailTH / 2;        // even rows of the tile
constexpr int kTailQ = 2;                        // per-tile sums: num, den

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint8_t v) { return u8f(v); }

// The vertical pass holds its outputs in registers until every thread has
// read its stage column, so they overwrite the stage. A flat tile's retry
// stages its window again.
template <typename T, int R>
struct TailSmem {
  static constexpr int kPE = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte piece
  static constexpr int kHX = (R + kPE - 1) / kPE * kPE;          // staged columns each side
  static constexpr int kRows = kTailTH + 2 * R;
  static constexpr int kCols = kTailTW + 2 * kHX;
  static_assert(kTailTW + 2 * R <= kThreads, "one vertical-pass column per thread");
  struct Passes {
    float mom[5][kTailTH][kTailPitch];       // vertical pass: mu1, mu2, E[r^2], E[d^2], E[rd]
    float dec[2][kTailDecRows][kTailPitch];  // vertical (2R2+1)-tap of ref, dis at the even rows
  };
  union {
    T stage[2][kRows * kCols];  // ref, dis: rows y0 - R .., columns x0 - kHX ..
    Passes v;
  };
  double red[kTailQ][kThreads / 32];
};

// The vertical pass on this thread's column (image column x0 - R +
// threadIdx.x), one walk down its staged rows: the five (2R+1)-tap moments
// of the tile's rows into mom; unless kExact, also the (2R2+1)-tap filter
// of ref and dis at the even rows into dec, in the plain version's order.
template <typename T, int R, int R2, bool kExact>
__device__ __forceinline__ void tail_vert(TailSmem<T, R>& s, const Taps& tv, const Taps& td) {
  using S = TailSmem<T, R>;
  const int c = threadIdx.x;
  const bool active = c < kTailTW + 2 * R;
  const T* pr = s.stage[0] + c + (S::kHX - R);
  const T* pd = s.stage[1] + c + (S::kHX - R);
  float acc[5][kTailTH], dr[kTailDecRows], dd[kTailDecRows];
#pragma unroll
  for (int j = 0; j < S::kRows; ++j) {
    if (!active) break;
    const float x = to_f(pr[j * S::kCols]), y = to_f(pd[j * S::kCols]);
    const float p[5] = {x, y, mul(x, x), mul(y, y), mul(x, y)};
#pragma unroll
    for (int i = 0; i < kTailTH; ++i) {
      const int k = j - i;
      if (k < 0 || k > 2 * R) continue;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        acc[q][i] = k == 0 ? mul(tv.t[0], p[q]) : tap<kExact>(acc[q][i], tv.t[k], p[q]);
      }
    }
    if (kExact || R2 == 0) continue;
#pragma unroll
    for (int m = 0; m < kTailDecRows; ++m) {  // even row 2m: stage rows R - R2 + 2m .. + 2 R2
      const int k = j - (R - R2) - 2 * m;
      if (k < 0 || k > 2 * R2) continue;
      const float pr_ = mul(td.t[k], x), pd_ = mul(td.t[k], y);
      dr[m] = k == 0 ? pr_ : add(dr[m], pr_);
      dd[m] = k == 0 ? pd_ : add(dd[m], pd_);
    }
  }
  __syncthreads();  // every stage column read: the outputs may overwrite the stage
  if (!active) return;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int i = 0; i < kTailTH; ++i) s.v.mom[q][i][pc(c)] = acc[q][i];
  }
  if (kExact || R2 == 0) return;
#pragma unroll
  for (int m = 0; m < kTailDecRows; ++m) {
    s.v.dec[0][m][pc(c)] = dr[m];
    s.v.dec[1][m][pc(c)] = dd[m];
  }
}

// Horizontal (2R+1)-tap pass and the VIF statistics for this thread's run
// (row warp, columns 8 * lane .. + 7 of the tile): adds its num and den
// sums over the n_valid valid pixels; flat |= a flat ref window among them.
template <typename T, int R, bool kExact>
__device__ __forceinline__ void tail_horiz(const TailSmem<T, R>& s, const Taps& tv, float egl, int has_egl,
                                           int n_valid, double& num_acc, double& den_acc, bool& flat) {
  constexpr int kN = (kTailRun + 2 * R + 3) / 4;  // float4 loads per moment row
  const int i = threadIdx.x >> 5, r = threadIdx.x & 31;
  if (r >= kTailRuns || n_valid <= 0) return;
  float m[5][kTailRun];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    float v[4 * kN];
    load_row<kN>(s.v.mom[q][i], kTailRun * r, v);
#pragma unroll
    for (int k = 0; k < kTailRun; ++k) m[q][k] = mul(tv.t[0], v[k]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) {
#pragma unroll
      for (int k = 0; k < kTailRun; ++k) m[q][k] = tap<kExact>(m[q][k], tv.t[t], v[k + t]);
    }
  }
  float num_run = 0.0f, den_run = 0.0f;
#pragma unroll
  for (int k = 0; k < kTailRun; ++k) {
    if (k >= n_valid) break;
    float num, den;
    flat |= vif_pixel<kExact>(m[0][k], m[1][k], m[2][k], m[3][k], m[4][k], egl, has_egl, num, den);
    num_run += num;
    den_run += den;
  }
  num_acc += num_run;
  den_acc += den_run;
}

// Horizontal (2R2+1)-tap at the even columns, in the plain version's
// order: warp w filters dec row w / 2 of ref (w even) or dis (w odd); lane
// r writes output columns ox0 + 4r .. + 3. Output k's taps are
// vertical-pass columns 8r + 2k + R - R2 + t; the 16 loaded columns start
// at the multiple of 4 below 8r + R - R2.
template <typename T, int R, int R2>
__device__ __forceinline__ void tail_dec(const TailSmem<T, R>& s, const Taps& td, float* out_ref,
                                         float* out_dis, int h2, int w2, int oy0, int ox0) {
  constexpr int kOff = (R - R2) / 4 * 4, kRem = R - R2 - kOff;
  static_assert(kTailRun - 2 + kRem + 2 * R2 < 16, "the taps lie in the 16 loaded columns");
  const int wp = threadIdx.x >> 5, r = threadIdx.x & 31;
  const int m = wp >> 1, img = wp & 1;
  if (r >= kTailRuns || oy0 + m >= h2) return;
  float v[16];
  load_row<4>(s.v.dec[img][m], kTailRun * r + kOff, v);
  float* out = (img ? out_dis : out_ref) + static_cast<size_t>(oy0 + m) * w2;
#pragma unroll
  for (int k = 0; k < kTailRun / 2; ++k) {
    float acc = mul(td.t[0], v[2 * k + kRem]);
#pragma unroll
    for (int t = 1; t <= 2 * R2; ++t) acc = add(acc, mul(td.t[t], v[2 * k + kRem + t]));
    const int ox = ox0 + (kTailRun / 2) * r + k;
    if (ox < w2) out[ox] = acc;
  }
}

// One scale on a (b, h, w) pair of T (u8 or f32). Grid: (tiles across,
// tiles down, frames). Per-tile sums into part (frames, 2, n_tiles); below
// scale 3 (R2 > 0) the next scale's pair into dec_* (b, ceil(h/2), ceil(w/2)).
template <typename T, int R, int R2>
__global__ void __launch_bounds__(kThreads, 3)
vif_tail_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w, int aligned,
                Taps tv, Taps td, float egl, int has_egl, double* __restrict__ part,
                float* __restrict__ dec_ref, float* __restrict__ dec_dis) {
  using S = TailSmem<T, R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int x0 = blockIdx.x * kTailTW, y0 = blockIdx.y * kTailTH;
  const int ry0 = y0 - R, cx0 = x0 - S::kHX;
  const size_t plane = static_cast<size_t>(h) * w;

  const auto stage = [&]() {
    stage_tile<T, S::kRows, S::kCols>(s.stage[0], s.stage[1], ref + blockIdx.z * plane,
                                      dis + blockIdx.z * plane, h, w, ry0, cx0, aligned);
    cp_async_wait<0>();
    __syncthreads();
    if (aligned && stage_at_border<S::kRows, S::kCols>(h, w, ry0, cx0)) {
      stage_mirror<T, S::kRows, S::kCols>(s.stage[0], s.stage[1], h, w, ry0, cx0);
      __syncthreads();
    }
  };
  stage();
  tail_vert<T, R, R2, false>(s, tv, td);
  __syncthreads();
  if constexpr (R2 > 0) {
    const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
    const size_t o = static_cast<size_t>(blockIdx.z) * h2 * w2;
    tail_dec<T, R, R2>(s, td, dec_ref + o, dec_dis + o, h2, w2, y0 / 2, x0 / 2);
  }
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_valid = y0 + row < h ? min(kTailRun, w - x0 - kTailRun * lane) : 0;
  double v[kTailQ] = {0.0, 0.0};
  bool flat = false;
  tail_horiz<T, R, false>(s, tv, egl, has_egl, n_valid, v[0], v[1], flat);
  if (__syncthreads_or(flat)) {
    // Flat ref windows: the moments again, in the plain version's order.
    stage();
    tail_vert<T, R, R2, true>(s, tv, td);
    __syncthreads();
    v[0] = v[1] = 0.0;
    tail_horiz<T, R, true>(s, tv, egl, has_egl, n_valid, v[0], v[1], flat);
  }
  double total;
  block_sums<kTailQ>(v, s.red, total);
  if (threadIdx.x < kTailQ) {
    const int n_tiles = gridDim.x * gridDim.y;
    part[(static_cast<size_t>(blockIdx.z) * kTailQ + threadIdx.x) * n_tiles + blockIdx.y * gridDim.x +
         blockIdx.x] = total;
  }
}

inline dim3 tail_grid(int b, int h, int w) { return dim3(cdiv(w, kTailTW), cdiv(h, kTailTH), b); }

inline int tail_tiles(int h, int w) { return cdiv(w, kTailTW) * cdiv(h, kTailTH); }

template <typename T, int R, int R2>
int tail_launch(const T* ref, const T* dis, int b, int h, int w, const Taps& tv, const Taps& td, float egl,
                int has_egl, double* part, float* dec_ref, float* dec_dis, cudaStream_t stream) {
  constexpr int kSmem = sizeof(TailSmem<T, R>);
  const cudaError_t e = smem_opt_in<vif_tail_kernel<T, R, R2>>(kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  vif_tail_kernel<T, R, R2><<<tail_grid(b, h, w), kThreads, kSmem, stream>>>(
      ref, dis, h, w, stage_aligned(ref, dis, w), tv, td, egl, has_egl, part, dec_ref, dec_dis);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// ----- Kernel 4: one scale -------------------------------------------------------

// One scale: stats at 2R+1 taps into sums (b, 2) = [num, den]; below scale
// 3 (R2 > 0) the next scale's 2R2+1-tap filter + decimation into dec_*.
template <typename T, int R, int R2>
int vif_scale_launch(const void* ref, const void* dis, int b, int h, int w, const float* taps_stats,
                     const float* taps_dec, float egl, int has_egl, double* part, double* sums,
                     float* dec_ref, float* dec_dis, cudaStream_t stream) {
  const int code = tail_launch<T, R, R2>(
      static_cast<const T*>(ref), static_cast<const T*>(dis), b, h, w, make_taps(taps_stats, 2 * R + 1),
      R2 > 0 ? make_taps(taps_dec, 2 * R2 + 1) : Taps{}, egl, has_egl, part, dec_ref, dec_dis, stream);
  if (code != 0) return code;
  reduce_rows_kernel<<<b * kTailQ, kThreads, 0, stream>>>(part, tail_tiles(h, w), sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// Kernel 4's launch figures at one scale on the current device: out[0]
// blocks per SM (occupancy API), out[1] registers per thread, out[2]
// dynamic shared bytes per block, out[3] local (spill) bytes per thread.
template <typename T, int R, int R2>
int vif_scale_occupancy(int* out) {
  constexpr int kSmem = sizeof(TailSmem<T, R>);
  cudaError_t e = smem_opt_in<vif_tail_kernel<T, R, R2>>(kSmem);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], vif_tail_kernel<T, R, R2>, kThreads, kSmem);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, vif_tail_kernel<T, R, R2>);
  out[1] = attr.numRegs;
  out[2] = kSmem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

template <typename T>
int vif_scale_dispatch(const void* ref, const void* dis, int b, int h, int w, int scale, const float* ts,
                       const float* td, float egl, int has_egl, double* part, double* sums, float* dec_ref,
                       float* dec_dis, cudaStream_t stream) {
  switch (scale) {
    case 0:
      return vif_scale_launch<T, 8, 4>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums, dec_ref, dec_dis,
                                       stream);
    case 1:
      return vif_scale_launch<T, 4, 2>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums, dec_ref, dec_dis,
                                       stream);
    case 2:
      return vif_scale_launch<T, 2, 1>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums, dec_ref, dec_dis,
                                       stream);
    case 3:
      return vif_scale_launch<T, 1, 0>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums, dec_ref, dec_dis,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int vif_occupancy_dispatch(int scale, int* out) {
  switch (scale) {
    case 0: return vif_scale_occupancy<T, 8, 4>(out);
    case 1: return vif_scale_occupancy<T, 4, 2>(out);
    case 2: return vif_scale_occupancy<T, 2, 1>(out);
    case 3: return vif_scale_occupancy<T, 1, 0>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of image scratch and doubles of partial scratch for rtvqa_vif_tail.
extern "C" long long rtvqa_vif_tail_scratch_floats(int b, int h1, int w1) {
  const int h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  return 2 * plane_floats(b, h2, w2) + 2 * plane_floats(b, (h2 + 1) / 2, (w2 + 1) / 2);
}

extern "C" long long rtvqa_vif_tail_scratch_doubles(int b, int h1, int w1) {
  long long n = 0;
  for (int s = 0; s < 3; ++s, h1 = (h1 + 1) / 2, w1 = (w1 + 1) / 2) n += 1LL * b * kTailQ * tail_tiles(h1, w1);
  return n;
}

// dref/ddis: (b, h1, w1) f32 contiguous on the device. taps9/taps5/taps3:
// host arrays of the scale windows. img: rtvqa_vif_tail_scratch_floats()
// floats; part: rtvqa_vif_tail_scratch_doubles() doubles. sums: (b, 6) f64
// [num1, den1, num2, den2, num3, den3]. Returns the first failing launch's
// cudaError_t (0 = all launched).
extern "C" int rtvqa_vif_tail(const float* dref, const float* ddis, int b, int h1, int w1,
                              const float* taps9, const float* taps5, const float* taps3,
                              float egl, int has_egl, float* img, double* part, double* sums,
                              void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  const int h3 = (h2 + 1) / 2, w3 = (w2 + 1) / 2;
  float* r2 = img;
  float* d2 = r2 + plane_floats(b, h2, w2);
  float* r3 = d2 + plane_floats(b, h2, w2);
  float* d3 = r3 + plane_floats(b, h3, w3);
  const Taps t9 = make_taps(taps9, 9), t5 = make_taps(taps5, 5), t3 = make_taps(taps3, 3);
  const Segments tiles{{tail_tiles(h1, w1), tail_tiles(h2, w2), tail_tiles(h3, w3)}};
  double* p2 = part + 1LL * b * kTailQ * tiles.n[0];
  double* p3 = p2 + 1LL * b * kTailQ * tiles.n[1];
  int code = tail_launch<float, 4, 2>(dref, ddis, b, h1, w1, t9, t5, egl, has_egl, part, r2, d2, stream);
  if (code == 0) code = tail_launch<float, 2, 1>(r2, d2, b, h2, w2, t5, t3, egl, has_egl, p2, r3, d3, stream);
  if (code == 0) {
    code = tail_launch<float, 1, 0>(r3, d3, b, h3, w3, t3, t3, egl, has_egl, p3, nullptr, nullptr, stream);
  }
  if (code != 0) return code;
  reduce_segments_kernel<<<b * 3 * kTailQ, kThreads, 0, stream>>>(part, b, kTailQ, tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// Doubles of per-tile partial scratch for rtvqa_vif_scale: (b, 2, tiles) at
// the scale's own (h, w).
extern "C" long long rtvqa_vif_scale_scratch(int b, int h, int w) {
  return 1LL * b * kTailQ * tail_tiles(h, w);
}

// ref/dis: (b, h, w) uint8 (is_u8 = 1) or f32, contiguous on the device.
// scale: 0-3. taps_stats: host array of the scale's 2^(4-scale)+1 taps;
// taps_dec: the next scale's 2^(3-scale)+1 taps (unused at scale 3).
// part: rtvqa_vif_scale_scratch() doubles. sums: (b, 2) f64 [num, den].
// dec_ref/dec_dis: (b, ceil(h/2), ceil(w/2)) f32, written below scale 3.
// Needs h, w >= 2^(3-scale)+1 (one reflection of the stats window).
// Returns the first failing launch's cudaError_t (0 = all launched).
extern "C" int rtvqa_vif_scale(const void* ref, const void* dis, int is_u8, int b, int h, int w,
                               int scale, const float* taps_stats, const float* taps_dec,
                               float egl, int has_egl, double* part, double* sums,
                               float* dec_ref, float* dec_dis, void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_u8) {
    return vif_scale_dispatch<uint8_t>(ref, dis, b, h, w, scale, taps_stats, taps_dec, egl, has_egl, part,
                                       sums, dec_ref, dec_dis, stream);
  }
  return vif_scale_dispatch<float>(ref, dis, b, h, w, scale, taps_stats, taps_dec, egl, has_egl, part, sums,
                                   dec_ref, dec_dis, stream);
}

// Kernel 4's launch figures at one scale on the current device: out[0]
// blocks per SM (occupancy API), out[1] registers per thread, out[2]
// dynamic shared bytes per block, out[3] local (spill) bytes per thread.
// Returns a cudaError_t.
extern "C" int rtvqa_vif_scale_occupancy(int is_u8, int scale, int* out) {
  return is_u8 ? vif_occupancy_dispatch<uint8_t>(scale, out) : vif_occupancy_dispatch<float>(scale, out);
}
