// VIF kernels: scales 1-3 of the quality chunk (rtvqa_vif_tail), and VIF at
// one scale with the next scale's inputs (rtvqa_vif_scale).
//
// rtvqa_vif_tail, from the scale-1 inputs (the 9-tap filtered,
// 2x-decimated luma pair that csrc/quality.cu writes).
//
// Replaces: rtvqa_tpu/kernels/vif_pallas.py::vif_tail_pallas (kernel body
// _vif_tail_kernel). The TPU kernel held a whole frame pair per grid cell in
// VMEM and ran the three scales back to back, with band-matrix filters on
// the MXU. Here each step is a tiled kernel from csrc/common.cuh and the
// inter-scale images live in a device scratch (at 1080p the scale-2 pair is
// 2 x 64 x 270 x 480 f32 = 66 MB, mostly served from the 50 MB L2 and HBM):
//   stats at 9 taps (scale 1) -> 5-tap filter + decimate -> stats at 5 taps
//   (scale 2) -> 3-tap filter + decimate -> stats at 3 taps (scale 3) ->
//   per-frame fixed-order sums. vif_stats_kernel is the generic per-scale
//   statistics kernel, shared with VIF scale 0 in csrc/quality.cu.
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
// decimation filters as banded MXU matmuls. Here the same three tiled
// kernels as above run per scale: vif_stats_kernel at 2^(4-s)+1 taps, then
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
// and adds (no FMA), as in the other VIF kernels, so the kernel's per-pixel
// values equal the plain version's; that halves the f32 issue rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kQ = 6;  // num1, den1, num2, den2, num3, den3

int vif_tail_tiles(int h1, int w1) {
  return stats_tiles(h1, w1);  // the largest of the three scales
}

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
  const long long h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  const long long h3 = (h2 + 1) / 2, w3 = (w2 + 1) / 2;
  return 2LL * b * (h2 * w2 + h3 * w3);
}

extern "C" long long rtvqa_vif_tail_scratch_doubles(int b, int h1, int w1) {
  return static_cast<long long>(b) * kQ * vif_tail_tiles(h1, w1);
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
  const int n_tiles = vif_tail_tiles(h1, w1);
  const int h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  const int h3 = (h2 + 1) / 2, w3 = (w2 + 1) / 2;
  float* r2 = img;
  float* d2 = r2 + static_cast<size_t>(b) * h2 * w2;
  float* r3 = d2 + static_cast<size_t>(b) * h2 * w2;
  float* d3 = r3 + static_cast<size_t>(b) * h3 * w3;
  const Taps t9 = make_taps(taps9, 9), t5 = make_taps(taps5, 5), t3 = make_taps(taps3, 3);

  cudaMemsetAsync(part, 0, sizeof(double) * rtvqa_vif_tail_scratch_doubles(b, h1, w1), stream);
  RTVQA_LAUNCH_CHECK();
  vif_stats_kernel<float, 4><<<stats_grid(b, h1, w1), kThreads, 0, stream>>>(
      dref, ddis, h1, w1, t9, egl, has_egl, part, kQ, 0, n_tiles);
  RTVQA_LAUNCH_CHECK();
  filter_decimate_kernel<float, 2><<<dec_grid(b, h1, w1), kThreads, 0, stream>>>(
      dref, ddis, h1, w1, t5, r2, d2);
  RTVQA_LAUNCH_CHECK();
  vif_stats_kernel<float, 2><<<stats_grid(b, h2, w2), kThreads, 0, stream>>>(
      r2, d2, h2, w2, t5, egl, has_egl, part, kQ, 2, n_tiles);
  RTVQA_LAUNCH_CHECK();
  filter_decimate_kernel<float, 1><<<dec_grid(b, h2, w2), kThreads, 0, stream>>>(
      r2, d2, h2, w2, t3, r3, d3);
  RTVQA_LAUNCH_CHECK();
  vif_stats_kernel<float, 1><<<stats_grid(b, h3, w3), kThreads, 0, stream>>>(
      r3, d3, h3, w3, t3, egl, has_egl, part, kQ, 4, n_tiles);
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b * kQ, kThreads, 0, stream>>>(part, n_tiles, sums);
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
