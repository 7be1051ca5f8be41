// The quality chunk's per-frame pass over YUV420 pairs: plane SSEs (PSNR),
// x264 SSIM window sums for Y/U/V, the FILTER_5 blur of ref luma and its
// SAD against the previous frame's blur (VMAF motion), VIF scale 0 (17-tap
// moments and statistics), the 9-tap filtered, 2x-decimated scale-1 inputs
// of ref and dis luma, and the blurred last frame (the next chunk's carry).
//
// Replaces: rtvqa_tpu/kernels/quality_pallas.py::quality_fused_pallas
// (kernel body _fused_q_kernel). The TPU kernel did all of this in one
// strip pass because each Mosaic grid cell cost ~15 us and it evaluated
// every filter as banded MXU matmuls; it carried the previous frame's blur
// in VMEM across sequentially ordered grid cells. A CUDA grid has no order,
// and on Hopper a stencil is a shared-memory tile, so the pass is split
// into one simple tiled kernel per job, each reading its inputs once per
// tile:
//  * ssim_sse_kernel (launched for Y, U and V): a 32 x 128-pixel tile plus
//    a 4-pixel halo to shared memory; integer SSE of the core pixels;
//    integer 4x4 block sums (exact); one 8x8 window per thread with x264's
//    ssim_end1 in f32, in the plain version's order.
//  * blur_sad_kernel: FILTER_5 blur of the tile for frame b and for frame
//    b-1 (recomputed, identically, rather than carried: no ordering needed
//    and no (B, H, W) scratch), frame 0 against prev_blur; |diff| summed;
//    the last frame's blur is written out as the carry.
//  * vif_stats_kernel<uint8_t, 8> and filter_decimate_kernel<uint8_t, 4>
//    (csrc/common.cuh; the VIF tail reuses them at scales 1-3).
//  * reduce_rows_kernel: per-frame fixed-order sums of the per-tile
//    partials (float64), so repeat runs give identical bits.
//
// Bound on the H100: operations. Per 64-frame 1080p chunk the pass moves
// ~0.68 GB (u8 planes in, two f32 quarter-size planes and the carry out:
// ~0.20 ms at 3.35 TB/s) but does ~450 f32 operations per luma pixel —
// five 17-tap separable moment filters dominate — ~6e10 in all, ~0.9 ms at
// 67 TFLOP/s. Taps are applied as separate multiplies and adds (no FMA), so
// the kernel's per-pixel values equal the plain version's; that halves the
// f32 rate and is the first thing to give up in a later, faster version.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kQ = 9;  // per-frame sums, in this order:
constexpr int kSseY = 0, kSseU = 1, kSseV = 2, kSsimY = 3, kSsimU = 4, kSsimV = 5;
constexpr int kSad = 6, kVifNum = 7;  // kVifNum + 1 = VIF den

constexpr int kSsimC1 = 416;      // int(.01*.01*255*255*64 + .5)
constexpr int kSsimC2 = 235963;   // int(.03*.03*255*255*64*63 + .5)

// ----- SSE + x264 SSIM of one plane -----------------------------------------

constexpr int kSsimBY = 8, kSsimBX = 32;              // windows per tile
constexpr int kSsimPH = 4 * kSsimBY + 4;              // staged pixel rows
constexpr int kSsimPW = 4 * kSsimBX + 4;              // staged pixel cols
constexpr int kSsimNB = (kSsimBY + 1) * (kSsimBX + 1);  // 4x4 blocks staged

__global__ void __launch_bounds__(kThreads)
ssim_sse_kernel(const uint8_t* __restrict__ ref, const uint8_t* __restrict__ dis, int h, int w,
                double* __restrict__ part, int n_q, int q_sse, int q_ssim, int n_tiles) {
  __shared__ uint8_t sr[kSsimPH * kSsimPW];
  __shared__ uint8_t sd[kSsimPH * kSsimPW];
  __shared__ int bs[4][kSsimNB];
  __shared__ double red[kThreads];

  const int tid = threadIdx.x;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * 4 * kSsimBY, x0 = blockIdx.x * 4 * kSsimBX;
  for (int i = tid; i < kSsimPH * kSsimPW; i += kThreads) {
    const int y = y0 + i / kSsimPW, x = x0 + i % kSsimPW;
    const bool in = y < h && x < w;
    const size_t g = frame + static_cast<size_t>(y) * w + x;
    sr[i] = in ? ref[g] : 0;
    sd[i] = in ? dis[g] : 0;
  }
  __syncthreads();

  long long sse = 0;
  for (int i = tid; i < 16 * kSsimBY * kSsimBX; i += kThreads) {
    const int r = i / (4 * kSsimBX), c = i % (4 * kSsimBX);
    if (y0 + r < h && x0 + c < w) {
      const int d = static_cast<int>(sr[r * kSsimPW + c]) - static_cast<int>(sd[r * kSsimPW + c]);
      sse += d * d;
    }
  }
  for (int k = tid; k < kSsimNB; k += kThreads) {
    const int by = k / (kSsimBX + 1), bx = k % (kSsimBX + 1);
    int s1 = 0, s2 = 0, ss = 0, s12 = 0;
    for (int dy = 0; dy < 4; ++dy) {
      for (int dx = 0; dx < 4; ++dx) {
        const int p = (4 * by + dy) * kSsimPW + 4 * bx + dx;
        const int a = sr[p], b = sd[p];
        s1 += a;
        s2 += b;
        ss += a * a + b * b;
        s12 += a * b;
      }
    }
    bs[0][k] = s1;
    bs[1][k] = s2;
    bs[2][k] = ss;
    bs[3][k] = s12;
  }
  __syncthreads();

  double ssim = 0.0;
  const int wy = tid / kSsimBX, wx = tid % kSsimBX;
  if (blockIdx.y * kSsimBY + wy < h / 4 - 1 && blockIdx.x * kSsimBX + wx < w / 4 - 1) {
    const int k = wy * (kSsimBX + 1) + wx;
    float win[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int* s = bs[m];
      win[m] = static_cast<float>(s[k] + s[k + 1] + s[k + kSsimBX + 1] + s[k + kSsimBX + 2]);
    }
    const float w1 = win[0], w2 = win[1], wss = win[2], w12 = win[3];
    const float vars = sub(sub(mul(wss, 64.0f), mul(w1, w1)), mul(w2, w2));
    const float covar = sub(mul(w12, 64.0f), mul(w1, w2));
    const float num = mul(add(mul(mul(2.0f, w1), w2), static_cast<float>(kSsimC1)),
                          add(mul(2.0f, covar), static_cast<float>(kSsimC2)));
    const float den = mul(add(add(mul(w1, w1), mul(w2, w2)), static_cast<float>(kSsimC1)),
                          add(vars, static_cast<float>(kSsimC2)));
    ssim = __fdiv_rn(num, den);
  }
  const double sse_sum = block_sum(static_cast<double>(sse), red);
  const double ssim_sum = block_sum(ssim, red);
  put_partial(part, n_q, q_sse, n_tiles, sse_sum);
  put_partial(part, n_q, q_ssim, n_tiles, ssim_sum);
}

inline dim3 ssim_grid(int b, int h, int w) {
  return dim3(cdiv(w, 4 * kSsimBX), cdiv(h, 4 * kSsimBY), b);
}

// ----- FILTER_5 blur + SAD against the previous frame's blur ----------------

constexpr int kBlurTH = 16, kBlurTW = 64, kBlurR = 2;
constexpr int kBlurRH = kBlurTH + 2 * kBlurR, kBlurRW = kBlurTW + 2 * kBlurR;
constexpr int kBlurPer = kBlurTH * kBlurTW / kThreads;

// Blur of one frame's tile (rows then columns, reflect borders) into
// out[k] for the thread's outputs i = tid + k * kThreads.
__device__ void blur_tile(const uint8_t* __restrict__ img, int h, int w, int y0, int x0,
                          const Taps& taps, float* raw, float* vert, float out[kBlurPer]) {
  constexpr int K = 2 * kBlurR + 1;
  const int tid = threadIdx.x;
  for (int i = tid; i < kBlurRH * kBlurRW; i += kThreads) {
    const int r = i / kBlurRW, c = i % kBlurRW;
    raw[i] = static_cast<float>(
        img[static_cast<size_t>(reflect_idx(y0 + r - kBlurR, h)) * w + reflect_idx(x0 + c - kBlurR, w)]);
  }
  __syncthreads();
  for (int i = tid; i < kBlurTH * kBlurRW; i += kThreads) {
    const int r = i / kBlurRW, c = i % kBlurRW;
    float acc = mul(taps.t[0], raw[r * kBlurRW + c]);
#pragma unroll
    for (int t = 1; t < K; ++t) acc = add(acc, mul(taps.t[t], raw[(r + t) * kBlurRW + c]));
    vert[i] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBlurPer; ++k) {
    const int i = tid + k * kThreads;
    const float* row = vert + (i / kBlurTW) * kBlurRW + i % kBlurTW;
    float acc = mul(taps.t[0], row[0]);
#pragma unroll
    for (int t = 1; t < K; ++t) acc = add(acc, mul(taps.t[t], row[t]));
    out[k] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
blur_sad_kernel(const uint8_t* __restrict__ ry, const float* __restrict__ prev_blur, int n_frames,
                int h, int w, Taps taps, double* __restrict__ part, int n_q, int q, int n_tiles,
                float* __restrict__ blur_carry) {
  __shared__ float raw[kBlurRH * kBlurRW];
  __shared__ float vert[kBlurTH * kBlurRW];
  __shared__ double red[kThreads];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kBlurTH, x0 = blockIdx.x * kBlurTW;
  const size_t plane = static_cast<size_t>(h) * w;
  float cur[kBlurPer], prv[kBlurPer];
  blur_tile(ry + b * plane, h, w, y0, x0, taps, raw, vert, cur);
  if (b > 0) blur_tile(ry + (b - 1) * plane, h, w, y0, x0, taps, raw, vert, prv);

  double sad = 0.0;
#pragma unroll
  for (int k = 0; k < kBlurPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int y = y0 + i / kBlurTW, x = x0 + i % kBlurTW;
    if (y >= h || x >= w) continue;
    const size_t g = static_cast<size_t>(y) * w + x;
    const float p = b > 0 ? prv[k] : prev_blur[g];
    sad += fabsf(sub(cur[k], p));
    if (b == n_frames - 1) blur_carry[g] = cur[k];
  }
  put_partial(part, n_q, q, n_tiles, block_sum(sad, red));
}

int quality_tiles(int h, int w, int hc, int wc) {
  int n = stats_tiles(h, w);  // the blur uses the same 16 x 64 tiles
  const int s = cdiv(w, 4 * kSsimBX) * cdiv(h, 4 * kSsimBY);
  const int sc = cdiv(wc, 4 * kSsimBX) * cdiv(hc, 4 * kSsimBY);
  if (s > n) n = s;
  if (sc > n) n = sc;
  return n;
}

}  // namespace

// Doubles of per-tile partial scratch that rtvqa_quality_fused needs.
extern "C" long long rtvqa_quality_scratch(int b, int h, int w, int hc, int wc) {
  return static_cast<long long>(b) * kQ * quality_tiles(h, w, hc, wc);
}

// ry/dy: (b, h, w) uint8; ru/rv/du/dv: (b, hc, wc) uint8; prev_blur: (h, w)
// f32; all contiguous on the device. taps17/taps9/taps_blur: host arrays of
// 17, 9 and 5 f32 taps. scratch: rtvqa_quality_scratch() doubles.
// Outputs: sums (b, 9) f64 [sse_y, sse_u, sse_v, ssim_y, ssim_u, ssim_v,
// sad, vif_num, vif_den]; dec_ref/dec_dis (b, ceil(h/2), ceil(w/2)) f32;
// blur_carry (h, w) f32. Needs h, w >= 9 (17-tap reflect borders). Returns
// the first failing launch's cudaError_t (0 = all launched).
extern "C" int rtvqa_quality_fused(const uint8_t* ry, const uint8_t* ru, const uint8_t* rv,
                                   const uint8_t* dy, const uint8_t* du, const uint8_t* dv,
                                   const float* prev_blur, int b, int h, int w, int hc, int wc,
                                   const float* taps17, const float* taps9, const float* taps_blur,
                                   float egl, int has_egl, double* scratch, double* sums,
                                   float* dec_ref, float* dec_dis, float* blur_carry,
                                   void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = quality_tiles(h, w, hc, wc);
  cudaMemsetAsync(scratch, 0, sizeof(double) * rtvqa_quality_scratch(b, h, w, hc, wc), stream);
  RTVQA_LAUNCH_CHECK();
  ssim_sse_kernel<<<ssim_grid(b, h, w), kThreads, 0, stream>>>(
      ry, dy, h, w, scratch, kQ, kSseY, kSsimY, n_tiles);
  RTVQA_LAUNCH_CHECK();
  ssim_sse_kernel<<<ssim_grid(b, hc, wc), kThreads, 0, stream>>>(
      ru, du, hc, wc, scratch, kQ, kSseU, kSsimU, n_tiles);
  RTVQA_LAUNCH_CHECK();
  ssim_sse_kernel<<<ssim_grid(b, hc, wc), kThreads, 0, stream>>>(
      rv, dv, hc, wc, scratch, kQ, kSseV, kSsimV, n_tiles);
  RTVQA_LAUNCH_CHECK();
  blur_sad_kernel<<<stats_grid(b, h, w), kThreads, 0, stream>>>(
      ry, prev_blur, b, h, w, make_taps(taps_blur, 5), scratch, kQ, kSad, n_tiles, blur_carry);
  RTVQA_LAUNCH_CHECK();
  vif_stats_kernel<uint8_t, 8><<<stats_grid(b, h, w), kThreads, 0, stream>>>(
      ry, dy, h, w, make_taps(taps17, 17), egl, has_egl, scratch, kQ, kVifNum, n_tiles);
  RTVQA_LAUNCH_CHECK();
  filter_decimate_kernel<uint8_t, 4><<<dec_grid(b, h, w), kThreads, 0, stream>>>(
      ry, dy, h, w, make_taps(taps9, 9), dec_ref, dec_dis);
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b * kQ, kThreads, 0, stream>>>(scratch, n_tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}
