// Pieces shared by the quality, VIF, ADM and block-match kernels
// (csrc/quality.cu, csrc/vif.cu, csrc/adm.cu, csrc/motion.cu). Everything
// here has internal linkage, so each translation unit that includes it gets
// its own copy.
//
// Numerics: mul/add/sub round one f32 operation each (__fmul_rn/__fadd_rn
// stop FMA contraction), so code written with them rounds as the plain
// PyTorch version does (one multiply, then one add per tap, in tap order);
// the VIF moment filters of kernels 3, 4 and 5 use FMA taps instead (tap<>,
// below) and fall back to the plain order on flat windows. Sums are taken
// per tile in float64 in a fixed order, written as per-tile partials, and
// reduced per frame by reduce_rows_kernel or reduce_segments_kernel in a
// fixed order: no float atomics, so repeat runs give identical bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RTVQA_LAUNCH_CHECK()                                   \
  do {                                                         \
    const cudaError_t rtvqa_err_ = cudaGetLastError();         \
    if (rtvqa_err_ != cudaSuccess) return static_cast<int>(rtvqa_err_); \
  } while (0)

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 17;

// Filter taps passed by value (they land in the kernel's parameter bank).
struct Taps {
  float t[kMaxTaps];
};

inline Taps make_taps(const float* host, int n) {
  Taps taps{};
  for (int i = 0; i < n && i < kMaxTaps; ++i) taps.t[i] = host[i];
  return taps;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Exact u8 -> f32 (2^23 + v, minus 2^23) without a conversion instruction.
__device__ __forceinline__ float u8f(uint8_t v) {
  return __int_as_float(0x4B000000 | v) - 8388608.0f;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// 16-byte global -> shared copy that bypasses L1 (both addresses 16-byte
// aligned); groups of them are committed and waited for as below.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sum of one double per thread over a kThreads-thread block, in a fixed
// tree order; every thread gets the result.
__device__ __forceinline__ double block_sum(double v, double* buf) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] += buf[tid + s];
    __syncthreads();
  }
  const double r = buf[0];
  __syncthreads();
  return r;
}

// Block totals of Q doubles per thread (v[q]): a shuffle tree per warp,
// then the warps in order by thread q, which gets total q; the other
// threads get 0.
template <int Q>
__device__ __forceinline__ void block_sums(const double* v, double (*red)[kThreads / 32], double& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    double x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[q][warp] = x;
  }
  __syncthreads();
  total = 0.0;
  if (threadIdx.x < Q) {
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += red[threadIdx.x][k];
  }
}

// Floats of a (b, h, w) plane in a scratch of several planes, rounded up
// to whole 16-byte pieces so that every plane starts aligned.
inline long long plane_floats(int b, int h, int w) {
  return (static_cast<long long>(b) * h * w + 3) / 4 * 4;
}

// Per-tile partial q of frame blockIdx.z, tile (blockIdx.x, blockIdx.y),
// in a (frames, n_q, n_tiles) array.
__device__ __forceinline__ void put_partial(double* part, int n_q, int q, int n_tiles, double v) {
  if (threadIdx.x != 0) return;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  part[(static_cast<size_t>(blockIdx.z) * n_q + q) * n_tiles + tile] = v;
}

// out[row] = sum over the row's n_tiles partials, in a fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const double* __restrict__ part, int n_tiles, double* __restrict__ out) {
  __shared__ double buf[kThreads];
  const double* p = part + static_cast<size_t>(blockIdx.x) * n_tiles;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_tiles; i += kThreads) acc += p[i];
  const double s = block_sum(acc, buf);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Raises kernel K's dynamic shared memory limit to `bytes`, once per device.
template <auto K>
cudaError_t smem_opt_in(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev >= 0 && dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

// Per-frame sums of per-tile partials held in three segments, one per
// scale: segment s is a (b, n_q, tiles.n[s]) array right after segment
// s - 1. Block `row` = (f * 3 + s) * n_q + q writes out[row], so out is
// (b, 3 * n_q). Each row is summed in a fixed order, as in reduce_rows_kernel.
struct Segments {
  int n[3];
};

__global__ void __launch_bounds__(kThreads)
reduce_segments_kernel(const double* __restrict__ part, int b, int n_q, Segments tiles,
                       double* __restrict__ out) {
  __shared__ double buf[kThreads];
  const int q = blockIdx.x % n_q, s = blockIdx.x / n_q % 3, f = blockIdx.x / (3 * n_q);
  size_t off = 0;
  for (int k = 0; k < s; ++k) off += static_cast<size_t>(b) * n_q * tiles.n[k];
  const int n = tiles.n[s];
  const double* p = part + off + (static_cast<size_t>(f) * n_q + q) * n;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += p[i];
  const double total = block_sum(acc, buf);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// A tile's window of ref and dis in shared memory (csrc/quality.cu,
// csrc/adm.cu, csrc/vif.cu). A stage holds ROWS x COLS elements of T per image: frame rows ry0 ..
// ry0 + ROWS - 1 and columns cx0 .. cx0 + COLS - 1 (cx0 a multiple of a
// 16-byte piece's elements), reflected at the frame's borders (numpy
// "reflect"). In a frame whose rows and bases are 16-byte aligned each
// piece inside the frame is copied by one cp.async, and a tile at a border
// then fills the rest from the copied elements in shared memory
// (stage_mirror); in any other frame every piece is gathered element by
// element from global memory. No index pays an integer modulo.
// ---------------------------------------------------------------------------

// numpy's "reflect" border (mirror without repeating the edge sample),
// without an integer modulo: fold at the nearer border until inside (once
// for an index within n - 1 of the frame, which is the usual case).
__device__ __forceinline__ int reflect_out(int i, int n) {
  if (n == 1) return 0;
  while (static_cast<unsigned>(i) >= static_cast<unsigned>(n)) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

template <typename T>
inline bool stage_aligned(const T* ref, const T* dis, int w) {
  return static_cast<size_t>(w) * sizeof(T) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(dis)) & 15) == 0;
}

// Whether a stage at (ry0, cx0) has pieces outside the frame.
template <int ROWS, int COLS>
__device__ __forceinline__ bool stage_at_border(int h, int w, int ry0, int cx0) {
  return ry0 < 0 || ry0 + ROWS > h || cx0 < 0 || cx0 + COLS > w;
}

// The 16 bytes of frame row `row` at columns gx .. gx + 16/sizeof(T) - 1,
// each reflected at the frame's width.
template <typename T>
__device__ __forceinline__ uint4 gather_piece(const T* row, int gx, int w) {
  constexpr int kPE = 16 / sizeof(T);
  union {
    uint4 v;
    T e[kPE];
  } piece;
#pragma unroll
  for (int e = 0; e < kPE; ++e) piece.e[e] = row[reflect_out(gx + e, w)];
  return piece.v;
}

// Starts one stage's copies (ref, dis: the frame's first element) and
// commits them as one cp.async group; in an unaligned frame every piece is
// gathered with plain loads instead. Either is visible to the block after
// the wait and the next __syncthreads.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(T* sr, T* sd, const T* ref, const T* dis, int h, int w,
                                           int ry0, int cx0, bool aligned) {
  constexpr int kPE = 16 / sizeof(T), kPieces = COLS / kPE;
  static_assert(COLS % kPE == 0, "stage rows are whole 16-byte pieces");
  for (int i = threadIdx.x; i < 2 * ROWS * kPieces; i += kThreads) {
    const int img = i >= ROWS * kPieces;
    const int j = i - img * ROWS * kPieces;
    const int r = j / kPieces, k = j - r * kPieces;
    const int gy = ry0 + r, gx = cx0 + kPE * k;
    T* dst = (img ? sd : sr) + r * COLS + kPE * k;
    const T* src = img ? dis : ref;
    if (!aligned) {
      *reinterpret_cast<uint4*>(dst) = gather_piece(src + static_cast<size_t>(reflect_out(gy, h)) * w, gx, w);
    } else if (gy >= 0 && gy < h && gx >= 0 && gx + kPE <= w) {
      cp_async16(dst, src + static_cast<size_t>(gy) * w + gx);
    }
  }
  cp_async_commit();
}

// Fills the elements of an aligned frame's stage that stage_tile did not
// copy, once the copies have landed: each takes the staged element of the
// frame pixel it reflects to, clamped into the copied part of the window
// (exact wherever that pixel is staged, which holds for every element a
// valid output reads). The copied elements are rows [r0, r1) x columns
// [c0, c1) of the stage; the others (rows outside [r0, r1), then the
// columns outside [c0, c1) of the rows inside) are numbered and shared out
// one element per thread and step.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_mirror(T* sr, T* sd, int h, int w, int ry0, int cx0) {
  const int r_lo = max(ry0, 0), r_hi = min(ry0 + ROWS, h) - 1;
  const int c_lo = max(cx0, 0), c_hi = min(cx0 + COLS, w) - 1;
  const int r0 = r_lo - ry0, r1 = r_hi + 1 - ry0, c0 = c_lo - cx0, c1 = c_hi + 1 - cx0;
  const int outer = (ROWS - (r1 - r0)) * COLS;  // elements of the rows outside
  const int side = COLS - (c1 - c0);            // elements outside per row inside
  const int per_img = outer + (r1 - r0) * side;
  for (int t = threadIdx.x; t < 2 * per_img; t += kThreads) {
    const int img = t >= per_img;
    const int u = t - img * per_img;
    int r, c;
    if (u < outer) {
      r = u / COLS;
      c = u - r * COLS;
      if (r >= r0) r += r1 - r0;  // the rows below the copied ones
    } else {
      const int v = u - outer;
      r = r0 + v / side;
      c = v - (r - r0) * side;
      if (c >= c0) c += c1 - c0;  // the columns right of the copied ones
    }
    T* stage = img ? sd : sr;
    const int sy = min(max(reflect_out(ry0 + r, h), r_lo), r_hi) - ry0;
    const int sx = min(max(reflect_out(cx0 + c, w), c_lo), c_hi) - cx0;
    stage[r * COLS + c] = stage[sy * COLS + sx];
  }
}

// ---------------------------------------------------------------------------
// Register-blocked VIF stencils (csrc/quality.cu, csrc/vif.cu): filter taps
// as FMAs, or (kExact) as a multiply then an add in the plain version's
// order; moment rows padded so that 16-byte loads at a stride of 8 columns
// across a quarter-warp hit distinct banks.
// ---------------------------------------------------------------------------

constexpr float kVifEps = 1e-10f;
constexpr float kSigmaNsq = 2.0f;
// A pixel whose computed sigma1^2 is below kFlatTol * E[x^2] sits in a flat
// ref window (10x the worst-case f32 rounding of that difference).
constexpr float kFlatTol = 1e-4f;

// Padded index of vertical-pass column c.
__device__ __forceinline__ int pc(int c) { return c + ((c >> 5) << 2); }

// Load n float4 of a padded vertical-pass row from column c0 (a multiple of 4).
template <int N>
__device__ __forceinline__ void load_row(const float* row, int c0, float* v) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const float4 f = *reinterpret_cast<const float4*>(row + pc(c0 + 4 * s));
    v[4 * s] = f.x;
    v[4 * s + 1] = f.y;
    v[4 * s + 2] = f.z;
    v[4 * s + 3] = f.w;
  }
}

template <bool kExact>
__device__ __forceinline__ float tap(float acc, float t, float v) {
  return kExact ? add(acc, mul(t, v)) : fmaf(t, v, acc);
}

// The plain-order path divides and takes log2 as the plain version does
// (IEEE division, log2f); the FMA path uses the hardware reciprocal and
// log2 (a few ulp): a small share of VIF's error against the plain
// version, far below its tolerance, for ~10% of kernel 3's time at 1080p
// (PERF.md section 6).
template <bool kExact>
__device__ __forceinline__ float quot(float a, float b) {
  return kExact ? __fdiv_rn(a, b) : __fdividef(a, b);
}

template <bool kExact>
__device__ __forceinline__ float lg2(float x) {
  return kExact ? log2f(x) : __log2f(x);
}

// float_vif's statistics at one pixel from its five moments (mu1, mu2,
// E[r^2], E[d^2], E[rd]): the num and den log terms. Returns whether the
// ref window is flat (sigma1^2 < kFlatTol * E[r^2]).
template <bool kExact>
__device__ __forceinline__ bool vif_pixel(float mu1, float mu2, float e11, float e22, float e12,
                                          float egl, int has_egl, float& num, float& den) {
  float sigma1 = sub(e11, mul(mu1, mu1));
  float sigma2 = sub(e22, mul(mu2, mu2));
  const float sigma12 = sub(e12, mul(mu1, mu2));
  const bool flat = sigma1 < kFlatTol * e11;
  sigma1 = fmaxf(sigma1, 0.0f);
  sigma2 = fmaxf(sigma2, 0.0f);
  float g = quot<kExact>(sigma12, add(sigma1, kVifEps));
  float sv_sq = sub(sigma2, mul(g, sigma12));
  if (sigma1 < kVifEps) {
    g = 0.0f;
    sv_sq = sigma2;
    sigma1 = 0.0f;
  }
  if (sigma2 < kVifEps) {
    g = 0.0f;
    sv_sq = 0.0f;
  }
  if (g < 0.0f) {
    sv_sq = sigma2;
    g = 0.0f;
  }
  sv_sq = fmaxf(sv_sq, kVifEps);
  if (has_egl) g = fminf(g, egl);
  num = lg2<kExact>(add(1.0f, quot<kExact>(mul(mul(g, g), sigma1), add(sv_sq, kSigmaNsq))));
  den = lg2<kExact>(add(1.0f, mul(sigma1, 1.0f / kSigmaNsq)));  // = sigma1 / 2, exactly
  return flat;
}

}  // namespace
