// Planar YUV420 (uint8) -> full-range gray (float32), BT.601 limited range.
//
// Replaces: rtvqa_tpu/kernels/gray_pallas.py::yuv420_to_gray_pallas
// (kernel body _gray_kernel). The TPU kernel upsampled chroma with banded
// 0/1 matmuls because Mosaic has no cheap lane gather; on Hopper a thread
// reads U/V at (r/2, c/2) itself.
//
// Bound on the H100: bytes. Per pixel the function reads 1 B of luma and
// 0.5 B of chroma and writes 4 B of f32, 5.5 B for ~20 operations
// (obs/roofline.py::gray_work): 1.46 GB at 128 x 1080p, 0.4358 ms at
// 3.35 TB/s.
//
// Design: a streaming pass that keeps every warp access contiguous and
// enough reads in flight to run near the memory rate (one thread per pixel
// kept ~2 KB of reads in flight per SM and was bound by read latency). A
// thread of the vector path takes 2-row x 4-column quads: rows 2k and 2k+1
// of a frame under chroma row k. Per quad it reads 4 luma bytes of each row
// and 2 bytes of U and of V through the non-coherent path, so each chroma
// byte is read from memory once, forms each chroma sample's four products
// once for its four pixels, and writes each row's 4 gray values as one
// 16-byte streaming store (the output never fits in L2). Lanes take
// neighbouring quads, so a warp's load covers 128 luma bytes of a row and
// its store 512 contiguous output bytes. A thread loads kVectorQuads quads,
// a grid stride apart, before it computes the first. Both paths launch a
// flat grid-stride grid of one resident wave (SMs x blocks per SM), so no
// frame or row count sits on a grid axis.
//
// Wider pieces per thread lose on this card: a 2 x 16 patch (16-byte luma
// loads, four 16-byte stores per row) puts a lane's stores 64 bytes apart,
// so each store instruction of a warp writes half of 32 sectors; on the
// H100 it ran slower than one thread per pixel (PERF.md, Findings).
//
// Path rule (chosen by kernels/gray.py::gray_path from the width and the
// data pointers): the vector path runs where w % 4 == 0, y is 4-byte and
// u and v are 2-byte aligned, which makes every row aligned too; an odd h
// leaves a last row pair of one row, which the quad masks. Every other
// frame (w % 4 != 0, e.g. 480p's 854 columns, or a view at an odd offset)
// takes the general path: a warp takes a 32-column run of a row pair, a
// thread one column of its two rows, with byte loads.
//
// Numerics: the same f32 constants and expression order as
// rtvqa_tpu_torch/ops/color.py, with every multiply and add rounded
// separately (__fmul_rn/__fadd_rn/__fsub_rn, no FMA contraction), so the
// result is the plain PyTorch version's bit for bit. A byte b becomes
// float(2^23 + b) by a byte permute; subtracting 2^23 + 16 (or + 128) is
// exact, so it equals float(b) - 16 (or - 128).

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
constexpr float kLumaBias = 8388624.0f;  // 2^23 + 16
constexpr float kChromaBias = 8388736.0f;  // 2^23 + 128

constexpr int kThreads = 256;
constexpr int kVectorQuads = 2;  // quads in flight per thread

// Byte `i` of `word` minus `bias` - 2^23, exactly.
__device__ __forceinline__ float unbias(uint32_t word, int i, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | i)), bias);
}

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// One chroma sample's products, shared by the four pixels it covers.
struct Chroma {
  float vr, ug, vg, ub;
};

__device__ __forceinline__ Chroma chroma(uint32_t u, uint32_t v, int i) {
  const float uf = unbias(u, i, kChromaBias), vf = unbias(v, i, kChromaBias);
  return {__fmul_rn(kVR, vf), __fmul_rn(kUG, uf), __fmul_rn(kVG, vf), __fmul_rn(kUB, uf)};
}

__device__ __forceinline__ float gray(uint32_t y, int i, const Chroma& c) {
  const float ys = __fmul_rn(kYScale, unbias(y, i, kLumaBias));
  const float rr = clip255(__fadd_rn(ys, c.vr));
  const float gg = clip255(__fadd_rn(__fadd_rn(ys, c.ug), c.vg));
  const float bb = clip255(__fadd_rn(ys, c.ub));
  return __fadd_rn(__fadd_rn(__fmul_rn(rr, kGrayR), __fmul_rn(gg, kGrayG)), __fmul_rn(bb, kGrayB));
}

// The 4 gray values of one quad row, luma bytes 0-3 over chroma samples 0, 0, 1, 1.
__device__ __forceinline__ float4 gray4(uint32_t y, const Chroma& c0, const Chroma& c1) {
  return float4{gray(y, 0, c0), gray(y, 1, c0), gray(y, 2, c1), gray(y, 3, c1)};
}

// Row pair rp = f * hc + k of the batch: rows 2k and 2k+1 of frame f over
// chroma row rp. The element offsets of luma row 2k and of chroma row rp,
// and whether row 2k+1 exists.
struct RowPair {
  long long y, c;
  bool two;
};

__device__ __forceinline__ RowPair row_pair(unsigned rp, int h, int w, int hc, int wc) {
  const unsigned f = rp / hc;
  const int r = 2 * static_cast<int>(rp - f * hc);
  return {(static_cast<long long>(f) * h + r) * w, static_cast<long long>(rp) * wc, r + 1 < h};
}

// Quad i = rp * quads + q: columns [4q, 4q + 4) of row pair rp; quads =
// w / 4, n = b * hc * quads.
__global__ void __launch_bounds__(kThreads) gray_vector_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u, const uint8_t* __restrict__ v,
    float* __restrict__ out, int h, int w, int hc, int quads, unsigned n) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < n; base += kVectorQuads * stride) {
    long long off[kVectorQuads];
    bool two[kVectorQuads];
    uint32_t y0[kVectorQuads], y1[kVectorQuads], cu[kVectorQuads], cv[kVectorQuads];
#pragma unroll
    for (int j = 0; j < kVectorQuads; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n) break;
      const unsigned rp = i / quads;
      const int col = 4 * static_cast<int>(i - rp * quads);
      const RowPair p = row_pair(rp, h, w, hc, w / 2);
      off[j] = p.y + col;
      two[j] = p.two;
      y0[j] = __ldg(reinterpret_cast<const uint32_t*>(y + off[j]));
      y1[j] = two[j] ? __ldg(reinterpret_cast<const uint32_t*>(y + off[j] + w)) : 0u;
      cu[j] = __ldg(reinterpret_cast<const uint16_t*>(u + p.c + col / 2));
      cv[j] = __ldg(reinterpret_cast<const uint16_t*>(v + p.c + col / 2));
    }
#pragma unroll
    for (int j = 0; j < kVectorQuads; ++j) {
      if (base + j * stride >= n) break;
      const Chroma c0 = chroma(cu[j], cv[j], 0), c1 = chroma(cu[j], cv[j], 1);
      __stcs(reinterpret_cast<float4*>(out + off[j]), gray4(y0[j], c0, c1));
      if (two[j]) __stcs(reinterpret_cast<float4*>(out + off[j] + w), gray4(y1[j], c0, c1));
    }
  }
}

// Run i = rp * runs + m: a warp takes columns [32m, 32m + 32) of row pair
// rp, a lane one column; runs = ceil(w / 32), n = b * hc * runs.
__global__ void __launch_bounds__(kThreads) gray_general_kernel(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u, const uint8_t* __restrict__ v,
    float* __restrict__ out, int h, int w, int hc, int wc, int runs, unsigned n) {
  const int lane = threadIdx.x & 31;
  const unsigned stride = gridDim.x * (kThreads / 32);
  for (unsigned i = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; i < n; i += stride) {
    const unsigned rp = i / runs;
    const int col = 32 * static_cast<int>(i - rp * runs) + lane;
    if (col >= w) continue;
    const RowPair p = row_pair(rp, h, w, hc, wc);
    const long long off = p.y + col;
    const uint32_t y0 = __ldg(y + off), y1 = p.two ? __ldg(y + off + w) : 0u;
    const Chroma c = chroma(__ldg(u + p.c + col / 2), __ldg(v + p.c + col / 2), 0);
    __stcs(out + off, gray(y0, 0, c));
    if (p.two) __stcs(out + off + w, gray(y1, 0, c));
  }
}

// Blocks of each path's kernel resident on one SM, and the SM count, of the
// current device, cached per device once every query has succeeded.
struct GrayLaunch {
  int sms, vector_blocks, general_blocks;
};

cudaError_t gray_launch(GrayLaunch* out) {
  static GrayLaunch cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    GrayLaunch l{};
    e = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.vector_blocks, gray_vector_kernel, kThreads, 0);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.general_blocks, gray_general_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    if (l.sms <= 0 || l.vector_blocks <= 0 || l.general_blocks <= 0) return cudaErrorInvalidConfiguration;
    cache[dev] = l;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// One resident wave, or fewer blocks where the work is smaller.
unsigned grid_blocks(int sms, int per_sm, unsigned long long threads) {
  const unsigned long long needed = (threads + kThreads - 1) / kThreads;
  const unsigned long long wave = static_cast<unsigned long long>(sms) * per_sm;
  return static_cast<unsigned>(needed < wave ? needed : wave);
}

}  // namespace

// y: (b, h, w), u/v: (b, hc, wc) uint8 contiguous, hc = ceil(h/2),
// wc = ceil(w/2); out: (b, h, w) float32 contiguous. vector != 0 takes the
// vector path, which needs w % 4 == 0, y 4-byte and u, v 2-byte aligned
// (else cudaErrorInvalidValue); the caller keeps each path's item count,
// b * hc * (w / 4) or b * hc * ceil(w / 32), below 2^31. Returns the
// launch's cudaGetLastError() code (0 = launched).
extern "C" int rtvqa_yuv420_to_gray(const uint8_t* y, const uint8_t* u, const uint8_t* v, float* out,
                                    int b, int h, int w, int hc, int wc, int vector, void* stream_ptr) {
  if (b == 0 || h == 0 || w == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  GrayLaunch l;
  const cudaError_t e = gray_launch(&l);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long rows = static_cast<unsigned long long>(b) * hc;
  if (vector) {
    const bool aligned = w % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(u) % 2 == 0 && reinterpret_cast<uintptr_t>(v) % 2 == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned n = static_cast<unsigned>(rows * (w / 4));
    gray_vector_kernel<<<grid_blocks(l.sms, l.vector_blocks, n), kThreads, 0, stream>>>(y, u, v, out, h, w, hc,
                                                                                       w / 4, n);
  } else {
    const int runs = (w + 31) / 32;
    const unsigned n = static_cast<unsigned>(rows * runs);
    gray_general_kernel<<<grid_blocks(l.sms, l.general_blocks, 32ull * n), kThreads, 0, stream>>>(
        y, u, v, out, h, w, hc, wc, runs, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch figures of one path's kernel on the current device: out[0] blocks
// per SM (occupancy API), out[1] registers per thread, out[2] local (spill)
// bytes per thread. Returns a cudaError_t code.
extern "C" int rtvqa_gray_occupancy(int vector, int* out) {
  GrayLaunch l;
  cudaError_t e = gray_launch(&l);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr{};
  e = vector ? cudaFuncGetAttributes(&attr, gray_vector_kernel) : cudaFuncGetAttributes(&attr, gray_general_kernel);
  out[0] = vector ? l.vector_blocks : l.general_blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
