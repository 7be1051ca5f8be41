// Planar YUV420 (uint8) -> full-range gray (float32), BT.601 limited range.
//
// Replaces: rtvqa_tpu/kernels/gray_pallas.py::yuv420_to_gray_pallas
// (kernel body _gray_kernel). The TPU kernel upsampled chroma with banded
// 0/1 matmuls because Mosaic has no cheap lane gather; on Hopper a thread
// simply reads U/V at (r/2, c/2).
//
// Bound on the H100: memory. Per pixel it reads 1 B of luma and 0.5 B of
// chroma (each chroma byte serves 4 pixels, mostly from L1/L2) and writes
// 4 B of f32 — ~5.5 B for ~20 flops. At 128 x 1080p that is ~1.46 GB of
// traffic, ~0.45 ms at the 3.35 TB/s peak.
//
// Design: one thread per output pixel, a 2-D grid of (column tiles, rows)
// per frame, so each warp reads 32 consecutive luma bytes and writes 128
// consecutive output bytes (coalesced). Any H and W, odd ones included: no
// padding and no small-frame fallback.
//
// Numerics: the same f32 constants and expression order as
// rtvqa_tpu_torch/ops/color.py, with every multiply and add rounded
// separately (__fmul_rn/__fadd_rn, no FMA contraction), so the result is
// the plain PyTorch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// f32 roundings of the doubles in ops/color.py (9 significant digits
// round-trip an f32 exactly).
constexpr float kYScale = 1.16438353f;   // 255/219
constexpr float kVR = 1.59602678f;       // 255/224 * 1.402
constexpr float kUG = -0.391761959f;     // -255/224 * 0.344136
constexpr float kVG = -0.8129673f;       // -255/224 * 0.714136
constexpr float kUB = 2.01723218f;       // 255/224 * 1.772
constexpr float kGrayR = 0.298999995f;   // 0.299
constexpr float kGrayG = 0.587000012f;   // 0.587
constexpr float kGrayB = 0.114f;         // 0.114

constexpr int kThreads = 256;

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

__global__ void yuv420_to_gray_kernel(const uint8_t* __restrict__ y,
                                      const uint8_t* __restrict__ u,
                                      const uint8_t* __restrict__ v,
                                      float* __restrict__ out,
                                      int h, int w, int hc, int wc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int r = blockIdx.y;
  const int64_t f = blockIdx.z;
  const int64_t yi = (f * h + r) * w + c;
  const int64_t ci = (f * hc + (r >> 1)) * wc + (c >> 1);

  const float yf = __fsub_rn(static_cast<float>(y[yi]), 16.0f);
  const float uf = __fsub_rn(static_cast<float>(u[ci]), 128.0f);
  const float vf = __fsub_rn(static_cast<float>(v[ci]), 128.0f);
  const float ys = __fmul_rn(kYScale, yf);

  const float rr = clip255(__fadd_rn(ys, __fmul_rn(kVR, vf)));
  const float gg = clip255(__fadd_rn(__fadd_rn(ys, __fmul_rn(kUG, uf)), __fmul_rn(kVG, vf)));
  const float bb = clip255(__fadd_rn(ys, __fmul_rn(kUB, uf)));
  out[yi] = __fadd_rn(__fadd_rn(__fmul_rn(rr, kGrayR), __fmul_rn(gg, kGrayG)),
                      __fmul_rn(bb, kGrayB));
}

}  // namespace

// y: (b, h, w), u/v: (b, hc, wc) uint8 contiguous, hc = ceil(h/2),
// wc = ceil(w/2); out: (b, h, w) float32 contiguous. Returns the
// cudaGetLastError() code of the launch (0 = launched).
extern "C" int rtvqa_yuv420_to_gray(const uint8_t* y, const uint8_t* u,
                                    const uint8_t* v, float* out, int b,
                                    int h, int w, int hc, int wc,
                                    void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + kThreads - 1) / kThreads, h, b);
  yuv420_to_gray_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, u, v, out, h, w, hc, wc);
  return static_cast<int>(cudaGetLastError());
}
