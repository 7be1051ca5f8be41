// Pieces shared by the quality, VIF and ADM kernels (csrc/quality.cu,
// csrc/vif.cu, csrc/adm.cu). Everything here has internal linkage, so each
// translation unit that includes it gets its own copy.
//
// Numerics: every filter tap, moment product and statistic is rounded the
// way the plain PyTorch version rounds it (one f32 multiply, then one f32
// add per tap, in tap order; __fmul_rn/__fadd_rn stop FMA contraction), so
// the per-pixel values of a kernel equal its plain version's bit for bit up
// to the last ULP of log2f. Sums are taken per tile in float64 in a fixed
// order (thread-local, then a shared-memory tree), written as per-tile
// partials, and reduced per frame by reduce_rows_kernel in a fixed order:
// no float atomics, so repeat runs give identical bits.

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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// numpy's "reflect" border (mirror without repeating the edge sample), for
// any offset: the index sequence is periodic with period 2(n-1).
__device__ __forceinline__ int reflect_idx(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
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

template <typename T>
__device__ __forceinline__ float load_f(const T* p, size_t i) {
  return static_cast<float>(p[i]);
}

// ---------------------------------------------------------------------------
// VIF statistics at one scale: the five moments (mu1, mu2, E[r^2], E[d^2],
// E[rd]) through a (2R+1)-tap separable window with reflect borders, then
// the float_vif clamps and the per-pixel num/den terms, summed per tile.
// One block computes a kStatsTH x kStatsTW tile of one frame: the raw
// (TH+2R) x (TW+2R) window of ref and dis goes to shared memory once, the
// vertical pass writes the five moments for TH rows x (TW+2R) columns, the
// horizontal pass and the statistics run per output pixel.
// Partials: q0 = num, q0 + 1 = den.
// ---------------------------------------------------------------------------

constexpr int kStatsTH = 16;
constexpr int kStatsTW = 64;
constexpr float kVifEps = 1e-10f;
constexpr float kSigmaNsq = 2.0f;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
vif_stats_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w,
                 Taps taps, float egl, int has_egl, double* __restrict__ part,
                 int n_q, int q0, int n_tiles) {
  constexpr int K = 2 * R + 1;
  constexpr int TH = kStatsTH, TW = kStatsTW;
  constexpr int RH = TH + 2 * R, RW = TW + 2 * R;
  __shared__ float sr[RH * RW];
  __shared__ float sd[RH * RW];
  __shared__ float sv[5 * TH * RW];
  __shared__ double red[kThreads];

  const int tid = threadIdx.x;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = tid; i < RH * RW; i += kThreads) {
    const int r = i / RW, c = i % RW;
    const size_t g = frame + static_cast<size_t>(reflect_idx(y0 + r - R, h)) * w +
                     reflect_idx(x0 + c - R, w);
    sr[i] = load_f(ref, g);
    sd[i] = load_f(dis, g);
  }
  __syncthreads();

  // Vertical pass (rows first, as the plain version filters axis -2 first).
  for (int i = tid; i < TH * RW; i += kThreads) {
    const int r = i / RW, c = i % RW;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float x = sr[(r + t) * RW + c], y = sd[(r + t) * RW + c];
      const float k = taps.t[t];
      const float p0 = mul(k, x), p1 = mul(k, y), p2 = mul(k, mul(x, x)),
                  p3 = mul(k, mul(y, y)), p4 = mul(k, mul(x, y));
      if (t == 0) {
        a0 = p0; a1 = p1; a2 = p2; a3 = p3; a4 = p4;
      } else {
        a0 = add(a0, p0); a1 = add(a1, p1); a2 = add(a2, p2);
        a3 = add(a3, p3); a4 = add(a4, p4);
      }
    }
    sv[(0 * TH + r) * RW + c] = a0;
    sv[(1 * TH + r) * RW + c] = a1;
    sv[(2 * TH + r) * RW + c] = a2;
    sv[(3 * TH + r) * RW + c] = a3;
    sv[(4 * TH + r) * RW + c] = a4;
  }
  __syncthreads();

  double num_acc = 0.0, den_acc = 0.0;
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int r = i / TW, c = i % TW;
    if (y0 + r >= h || x0 + c >= w) continue;
    float m[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float* row = sv + (q * TH + r) * RW + c;
      float acc = mul(taps.t[0], row[0]);
#pragma unroll
      for (int t = 1; t < K; ++t) acc = add(acc, mul(taps.t[t], row[t]));
      m[q] = acc;
    }
    const float mu1 = m[0], mu2 = m[1];
    float sigma1 = sub(m[2], mul(mu1, mu1));
    float sigma2 = sub(m[3], mul(mu2, mu2));
    const float sigma12 = sub(m[4], mul(mu1, mu2));
    sigma1 = fmaxf(sigma1, 0.0f);
    sigma2 = fmaxf(sigma2, 0.0f);
    float g = __fdiv_rn(sigma12, add(sigma1, kVifEps));
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
    const float num = log2f(add(1.0f, __fdiv_rn(mul(mul(g, g), sigma1), add(sv_sq, kSigmaNsq))));
    const float den = log2f(add(1.0f, __fdiv_rn(sigma1, kSigmaNsq)));
    num_acc += num;
    den_acc += den;
  }
  const double num_sum = block_sum(num_acc, red);
  const double den_sum = block_sum(den_acc, red);
  put_partial(part, n_q, q0, n_tiles, num_sum);
  put_partial(part, n_q, q0 + 1, n_tiles, den_sum);
}

inline dim3 stats_grid(int b, int h, int w) {
  return dim3(cdiv(w, kStatsTW), cdiv(h, kStatsTH), b);
}

inline int stats_tiles(int h, int w) { return cdiv(w, kStatsTW) * cdiv(h, kStatsTH); }

// ---------------------------------------------------------------------------
// (2R+1)-tap separable filter (reflect borders) of ref and dis, keeping the
// even rows and columns: out is (ceil(h/2), ceil(w/2)) — decimate2 of
// filter1d_sep. One block computes a kDecTH x kDecTW tile of outputs; the
// vertical pass runs only on the even rows, the horizontal only at the even
// columns.
// ---------------------------------------------------------------------------

constexpr int kDecTH = 8;
constexpr int kDecTW = 32;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
filter_decimate_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w,
                       Taps taps, float* __restrict__ out_ref, float* __restrict__ out_dis) {
  constexpr int K = 2 * R + 1;
  constexpr int TH = kDecTH, TW = kDecTW;
  constexpr int RH = 2 * TH - 1 + 2 * R, RW = 2 * TW - 1 + 2 * R;
  __shared__ float sr[RH * RW];
  __shared__ float sd[RH * RW];
  __shared__ float vr[TH * RW];
  __shared__ float vd[TH * RW];

  const int tid = threadIdx.x;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int ys = 2 * i0 - R, xs = 2 * j0 - R;

  for (int i = tid; i < RH * RW; i += kThreads) {
    const int r = i / RW, c = i % RW;
    const size_t g = frame + static_cast<size_t>(reflect_idx(ys + r, h)) * w + reflect_idx(xs + c, w);
    sr[i] = load_f(ref, g);
    sd[i] = load_f(dis, g);
  }
  __syncthreads();

  for (int i = tid; i < TH * RW; i += kThreads) {
    const int r = i / RW, c = i % RW;
    float ar = 0.f, ad = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float pr = mul(taps.t[t], sr[(2 * r + t) * RW + c]);
      const float pd = mul(taps.t[t], sd[(2 * r + t) * RW + c]);
      ar = t == 0 ? pr : add(ar, pr);
      ad = t == 0 ? pd : add(ad, pd);
    }
    vr[i] = ar;
    vd[i] = ad;
  }
  __syncthreads();

  const int r = tid / TW, c = tid % TW;
  const int oi = i0 + r, oj = j0 + c;
  if (oi >= h2 || oj >= w2) return;
  float ar = 0.f, ad = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float pr = mul(taps.t[t], vr[r * RW + 2 * c + t]);
    const float pd = mul(taps.t[t], vd[r * RW + 2 * c + t]);
    ar = t == 0 ? pr : add(ar, pr);
    ad = t == 0 ? pd : add(ad, pd);
  }
  const size_t o = static_cast<size_t>(blockIdx.z) * h2 * w2 + static_cast<size_t>(oi) * w2 + oj;
  out_ref[o] = ar;
  out_dis[o] = ad;
}

inline dim3 dec_grid(int b, int h, int w) {
  return dim3(cdiv((w + 1) / 2, kDecTW), cdiv((h + 1) / 2, kDecTH), b);
}

}  // namespace
