// VIF kernels: scales 1-3 of the quality chunk (rtvqa_vif_tail), and VIF at
// one scale with the next scale's inputs (rtvqa_vif_scale).
//
// rtvqa_vif_tail, from the scale-1 inputs (the 9-tap filtered,
// 2x-decimated luma pair that csrc/quality.cu writes).
//
// Replaces: rtvqa_tpu/kernels/vif_pallas.py::vif_tail_pallas (kernel body
// _vif_tail_kernel). The TPU kernel held a whole frame pair per grid cell in
// VMEM and ran the three scales back to back, with band-matrix filters on
// the MXU. Here one launch of vif_tail_kernel per scale computes, from one
// staged tile of the scale's pair (common.cuh stage_tile: 16-byte cp.async
// pieces, border tiles mirrored in shared memory), both the VIF statistics
// at 2R+1 taps and, below scale 3, the next scale's (2R2+1)-tap filter at
// the even rows and columns, which it writes to a device scratch (at 1080p
// the scale-2 pair is 2 x 64 x 270 x 480 f32 = 66 MB, mostly served from
// the 50 MB L2). So each scale's pair is read once: 9+5 taps, 5+3, then 3,
// then one fixed-order reduce of the three scales' per-tile sums. The
// stencils are kernel 3's (csrc/quality.cu): a block owns an 8 x 240 tile,
// its vertical pass gives one column per thread and keeps the five moments
// of the tile's 8 rows in registers, its horizontal pass computes runs of 8
// outputs per thread from 16-byte loads of padded moment rows, and the
// moment taps are FMAs. A tile in which any pixel's ref window is flat
// (sigma1^2 < kFlatTol * E[x^2]; letterbox bars, flat areas) redoes its
// moments with separate multiplies and adds in the plain version's order
// (see csrc/quality.cu, "Numerics"). The decimation taps keep the plain
// version's order, so scales 2 and 3 see the plain version's inputs bit for
// bit. A block holds one tile, and the vertical pass's outputs overwrite
// its stage, so three blocks fit on an SM (a second f32 stage buffer would
// cost one).
//
// Bound on the H100: operations, narrowly. Per 64-frame 1080p chunk the
// tail reads the 265 MB scale-1 pair once (~0.08 ms at 3.35 TB/s; the
// scratch round trips add ~0.1 GB) and does ~200 f32 operations per scale-1
// pixel (five 9-tap moment filters dominate): ~7e9, ~0.1 ms at 67 TFLOP/s.
//
// rtvqa_vif_scale, one scale s of 0-3 on a (b, h, w) pair, u8 or f32.
//
// Replaces: rtvqa_tpu/kernels/vif_pallas.py::vif_scale_pallas (kernel body
// _vif_scale_kernel), which the JAX package chains over scales 0-3 for
// frames wider than 3840 (vif_features_pallas). The TPU kernel DMA'd
// 8-aligned row windows of the raw frame per strip and ran the moment and
// decimation filters as banded MXU matmuls. Here three tiled kernels from
// csrc/common.cuh run per scale: vif_stats_kernel at 2^(4-s)+1 taps, then
// (s < 3) filter_decimate_kernel with the next scale's 2^(3-s)+1 taps,
// writing the cropped (b, ceil(h/2), ceil(w/2)) f32 pair, then
// reduce_rows_kernel. Each stats block writes its own partial, so the
// partial scratch needs no clearing.
//
// Bound on the H100: operations. At DCI 4K scale 0 (14 frames of
// 2160 x 4096, u8 pair) the call reads 248 MB and writes 248 MB of dec
// planes (~0.15 ms at 3.35 TB/s) and does 363 operations per pixel for the
// five 17-tap moment filters and the statistics, plus ~25 per pixel for the
// 9-tap decimation of both frames: ~4.8e10, ~0.72 ms at 67 TFLOP/s. Taps are separate multiplies
// and adds (no FMA), so the kernel's per-pixel values equal the plain
// version's; that halves the f32 issue rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// ----- The tail: one kernel per scale ---------------------------------------

constexpr int kTailTH = kThreads / 32;           // 8 output rows: one warp per row
constexpr int kTailTW = 240;                     // output columns (960 = 4 tiles)
constexpr int kTailHX = 4;                       // staged columns each side (one f32 piece)
constexpr int kTailCols = kTailTW + 2 * kTailHX;  // 248 staged columns
constexpr int kTailPitch = kThreads + kThreads / 8;  // vertical-pass columns, padded (pc)
constexpr int kTailRun = 8;                      // horizontal outputs per thread
constexpr int kTailRuns = kTailTW / kTailRun;    // 30 runs per row
constexpr int kTailDecRows = kTailTH / 2;        // even rows of the tile
constexpr int kTailQ = 2;                        // per-tile sums: num, den

// The vertical pass holds its outputs in registers until every thread has
// read its stage column, so they overwrite the stage: three blocks per SM
// instead of two. A flat tile's retry stages its window again.
template <int R>
struct TailSmem {
  static_assert(R <= kTailHX && kTailTW + 2 * R <= kThreads, "one vertical-pass column per thread");
  struct Passes {
    float mom[5][kTailTH][kTailPitch];       // vertical pass: mu1, mu2, E[r^2], E[d^2], E[rd]
    float dec[2][kTailDecRows][kTailPitch];  // vertical (2R2+1)-tap of ref, dis at the even rows
  };
  union {
    float stage[2][(kTailTH + 2 * R) * kTailCols];  // ref, dis: rows y0 - R .., columns x0 - kTailHX ..
    Passes v;
  };
  double red[kTailQ][kThreads / 32];
};

// The vertical pass on this thread's column (image column x0 - R +
// threadIdx.x), one walk down its staged rows: the five (2R+1)-tap moments
// of the tile's rows into mom; unless kExact, also the (2R2+1)-tap filter
// of ref and dis at the even rows into dec, in the plain version's order.
template <int R, int R2, bool kExact>
__device__ __forceinline__ void tail_vert(TailSmem<R>& s, const Taps& tv, const Taps& td) {
  const int c = threadIdx.x;
  const bool active = c < kTailTW + 2 * R;
  const float* pr = s.stage[0] + c + (kTailHX - R);
  const float* pd = s.stage[1] + c + (kTailHX - R);
  float acc[5][kTailTH], dr[kTailDecRows], dd[kTailDecRows];
#pragma unroll
  for (int j = 0; j < kTailTH + 2 * R; ++j) {
    if (!active) break;
    const float x = pr[j * kTailCols], y = pd[j * kTailCols];
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
template <int R, bool kExact>
__device__ __forceinline__ void tail_horiz(const TailSmem<R>& s, const Taps& tv, float egl, int has_egl,
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
// r writes output columns ox0 + 4r .. + 3.
template <int R, int R2>
__device__ __forceinline__ void tail_dec(const TailSmem<R>& s, const Taps& td, float* out_ref,
                                         float* out_dis, int h2, int w2, int oy0, int ox0) {
  const int wp = threadIdx.x >> 5, r = threadIdx.x & 31;
  const int m = wp >> 1, img = wp & 1;
  if (r >= kTailRuns || oy0 + m >= h2) return;
  float v[16];
  load_row<4>(s.v.dec[img][m], kTailRun * r, v);  // output k's taps at 8r + 2k + R - R2 + t
  float* out = (img ? out_dis : out_ref) + static_cast<size_t>(oy0 + m) * w2;
#pragma unroll
  for (int k = 0; k < kTailRun / 2; ++k) {
    float acc = mul(td.t[0], v[2 * k + R - R2]);
#pragma unroll
    for (int t = 1; t <= 2 * R2; ++t) acc = add(acc, mul(td.t[t], v[2 * k + R - R2 + t]));
    const int ox = ox0 + (kTailRun / 2) * r + k;
    if (ox < w2) out[ox] = acc;
  }
}

// One scale of the tail on a (b, h, w) f32 pair. Grid: (tiles across,
// tiles down, frames). Per-tile sums into part (frames, 2, n_tiles); below
// scale 3 (R2 > 0) the next scale's pair into dec_* (b, ceil(h/2), ceil(w/2)).
template <int R, int R2>
__global__ void __launch_bounds__(kThreads, 3)
vif_tail_kernel(const float* __restrict__ ref, const float* __restrict__ dis, int h, int w, int aligned,
                Taps tv, Taps td, float egl, int has_egl, double* __restrict__ part,
                float* __restrict__ dec_ref, float* __restrict__ dec_dis) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TailSmem<R>& s = *reinterpret_cast<TailSmem<R>*>(smem_raw);
  constexpr int kRows = kTailTH + 2 * R;
  const int x0 = blockIdx.x * kTailTW, y0 = blockIdx.y * kTailTH;
  const int ry0 = y0 - R, cx0 = x0 - kTailHX;
  const size_t plane = static_cast<size_t>(h) * w;

  const auto stage = [&]() {
    stage_tile<float, kRows, kTailCols>(s.stage[0], s.stage[1], ref + blockIdx.z * plane,
                                        dis + blockIdx.z * plane, h, w, ry0, cx0, aligned);
    cp_async_wait<0>();
    __syncthreads();
    if (aligned && stage_at_border<kRows, kTailCols>(h, w, ry0, cx0)) {
      stage_mirror<float, kRows, kTailCols>(s.stage[0], s.stage[1], h, w, ry0, cx0);
      __syncthreads();
    }
  };
  stage();
  tail_vert<R, R2, false>(s, tv, td);
  __syncthreads();
  if constexpr (R2 > 0) {
    const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
    const size_t o = static_cast<size_t>(blockIdx.z) * h2 * w2;
    tail_dec<R, R2>(s, td, dec_ref + o, dec_dis + o, h2, w2, y0 / 2, x0 / 2);
  }
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_valid = y0 + row < h ? min(kTailRun, w - x0 - kTailRun * lane) : 0;
  double v[kTailQ] = {0.0, 0.0};
  bool flat = false;
  tail_horiz<R, false>(s, tv, egl, has_egl, n_valid, v[0], v[1], flat);
  if (__syncthreads_or(flat)) {
    // Flat ref windows: the moments again, in the plain version's order.
    stage();
    tail_vert<R, R2, true>(s, tv, td);
    __syncthreads();
    v[0] = v[1] = 0.0;
    tail_horiz<R, true>(s, tv, egl, has_egl, n_valid, v[0], v[1], flat);
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

template <int R, int R2>
int tail_launch(const float* ref, const float* dis, int b, int h, int w, const Taps& tv, const Taps& td,
                float egl, int has_egl, double* part, float* dec_ref, float* dec_dis,
                cudaStream_t stream) {
  const cudaError_t e = smem_opt_in<vif_tail_kernel<R, R2>>(sizeof(TailSmem<R>));
  if (e != cudaSuccess) return static_cast<int>(e);
  vif_tail_kernel<R, R2><<<tail_grid(b, h, w), kThreads, sizeof(TailSmem<R>), stream>>>(
      ref, dis, h, w, stage_aligned(ref, dis, w), tv, td, egl, has_egl, part, dec_ref, dec_dis);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// ----- Kernel 4: one scale -----------------------------------------------------

// One scale: stats at 2R+1 taps into sums (b, 2) = [num, den]; below scale
// 3 (R2 > 0) the next scale's 2R2+1-tap filter + decimation into dec_*.
template <typename T, int R, int R2>
int vif_scale_launch(const void* ref_ptr, const void* dis_ptr, int b, int h, int w,
                     const float* taps_stats, const float* taps_dec, float egl, int has_egl,
                     double* part, double* sums, float* dec_ref, float* dec_dis,
                     cudaStream_t stream) {
  const T* ref = static_cast<const T*>(ref_ptr);
  const T* dis = static_cast<const T*>(dis_ptr);
  const int n_tiles = stats_tiles(h, w);
  vif_stats_kernel<T, R><<<stats_grid(b, h, w), kThreads, 0, stream>>>(
      ref, dis, h, w, make_taps(taps_stats, 2 * R + 1), egl, has_egl, part, 2, 0, n_tiles);
  RTVQA_LAUNCH_CHECK();
  if constexpr (R2 > 0) {
    filter_decimate_kernel<T, R2><<<dec_grid(b, h, w), kThreads, 0, stream>>>(
        ref, dis, h, w, make_taps(taps_dec, 2 * R2 + 1), dec_ref, dec_dis);
    RTVQA_LAUNCH_CHECK();
  }
  reduce_rows_kernel<<<b * 2, kThreads, 0, stream>>>(part, n_tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

template <typename T>
int vif_scale_dispatch(const void* ref, const void* dis, int b, int h, int w, int scale,
                       const float* ts, const float* td, float egl, int has_egl, double* part,
                       double* sums, float* dec_ref, float* dec_dis, cudaStream_t stream) {
  switch (scale) {
    case 0:
      return vif_scale_launch<T, 8, 4>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums,
                                       dec_ref, dec_dis, stream);
    case 1:
      return vif_scale_launch<T, 4, 2>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums,
                                       dec_ref, dec_dis, stream);
    case 2:
      return vif_scale_launch<T, 2, 1>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums,
                                       dec_ref, dec_dis, stream);
    case 3:
      return vif_scale_launch<T, 1, 0>(ref, dis, b, h, w, ts, td, egl, has_egl, part, sums,
                                       dec_ref, dec_dis, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
  int code = tail_launch<4, 2>(dref, ddis, b, h1, w1, t9, t5, egl, has_egl, part, r2, d2, stream);
  if (code == 0) code = tail_launch<2, 1>(r2, d2, b, h2, w2, t5, t3, egl, has_egl, p2, r3, d3, stream);
  if (code == 0) code = tail_launch<1, 0>(r3, d3, b, h3, w3, t3, t3, egl, has_egl, p3, nullptr, nullptr, stream);
  if (code != 0) return code;
  reduce_segments_kernel<<<b * 3 * kTailQ, kThreads, 0, stream>>>(part, b, kTailQ, tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// Doubles of per-tile partial scratch for rtvqa_vif_scale: (b, 2, tiles) at
// the scale's own (h, w).
extern "C" long long rtvqa_vif_scale_scratch(int b, int h, int w) {
  return 2LL * b * stats_tiles(h, w);
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
    return vif_scale_dispatch<uint8_t>(ref, dis, b, h, w, scale, taps_stats, taps_dec, egl,
                                       has_egl, part, sums, dec_ref, dec_dis, stream);
  }
  return vif_scale_dispatch<float>(ref, dis, b, h, w, scale, taps_stats, taps_dec, egl, has_egl,
                                   part, sums, dec_ref, dec_dis, stream);
}
