// ADM (VMAF's detail loss metric) at one DWT scale: one db2 DWT level of ref
// and dis (reflect borders, 2 taps before and 1 after, even-phase
// decimation), decoupling of the detail bands (gain clip to [0, 1], the
// cos(1 deg) angle test, optional NEG gain cap), Watson CSF weighting, the
// 3x3 edge-replicated masking threshold of the CSF-weighted additive
// residual (center weight 2, /30), and the six center-crop L3 sums (num and
// den for h, v, d) per frame, plus the next scale's approximation bands.
//
// Replaces: rtvqa_tpu/kernels/adm_pallas.py::adm_scale_pallas at scale 0
// (kernel body _adm0_kernel, u8 input) and, launched for scales 1-3 on f32
// input, adm_pallas.py::adm_tail_pallas (kernel body _adm_tail_kernel).
// adm_input_kernel replaces adm_scale_pallas(stages=0) (kernel body
// _adm0_dma_only_kernel): kernel 6's input path and a checksum, nothing
// else (bound: its input bytes, ~0.08 ms per 64-frame 1080p u8 pair).
// The TPU kernels built every border into banded selection matrices and
// lane rolls because Mosaic has no dynamic slicing; here a block stages
// the raw (2*8+6) x (2*32+6) window of both frames in shared memory with
// reflected indices, runs the vertical then the horizontal db2 pass for an
// (8+2) x (32+2) subband region (the 1-sample ring is the masking halo,
// computed at clamped positions = edge replication), then masks and pools
// its 8 x 32 core. Pooling is the literal form sum(|o*f|^3) — the TPU
// kernel's reassociated den (sum(|o|^3)*f^3) is not carried over. The cube
// roots and the cbrt(area/32) offsets are applied after the per-frame sums,
// by the caller.
//
// Bound on the H100: bytes, narrowly. Per 64-frame 1080p chunk scale 0
// reads 265 MB of u8 luma and writes 265 MB of f32 approximation bands
// (~0.16 ms at 3.35 TB/s) against ~50 f32 operations per input pixel
// (~7e9, ~0.1 ms at 67 TFLOP/s); scales 1-3 add a quarter of that. Per-tile
// partials (float64) are reduced per frame in a fixed order.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kAdmQ = 6;  // num_h, den_h, num_v, den_v, num_d, den_d
constexpr int kAdmTH = 8, kAdmTW = 32;                       // core subband tile
constexpr int kAdmHR = kAdmTH + 2, kAdmHC = kAdmTW + 2;      // with the mask halo
constexpr int kAdmRR = 2 * kAdmTH + 6, kAdmRC = 2 * kAdmTW + 6;  // raw window
constexpr float kAdmEps = 1e-30f;

struct Bands {
  float a, h, v, d;
};

// Horizontal db2 pass at one position from the vertical lo/hi rows.
__device__ __forceinline__ Bands h_pass(const float* lo, const float* hi, const Taps& db2) {
  Bands out;
  out.a = mul(db2.t[0], lo[0]);
  out.h = mul(db2.t[4], lo[0]);
  out.v = mul(db2.t[0], hi[0]);
  out.d = mul(db2.t[4], hi[0]);
#pragma unroll
  for (int t = 1; t < 4; ++t) {
    out.a = add(out.a, mul(db2.t[t], lo[t]));
    out.h = add(out.h, mul(db2.t[4 + t], lo[t]));
    out.v = add(out.v, mul(db2.t[t], hi[t]));
    out.d = add(out.d, mul(db2.t[4 + t], hi[t]));
  }
  return out;
}

__device__ __forceinline__ float restore(float o, float t, bool angle_ok, float egl, int has_egl) {
  const float ratio = __fdiv_rn(t, add(o, o >= 0.0f ? kAdmEps : -kAdmEps));
  const float rst = mul(fminf(fmaxf(ratio, 0.0f), 1.0f), o);
  if (!has_egl) return angle_ok ? t : rst;
  return angle_ok ? mul(fminf(fmaxf(ratio, 0.0f), egl), o) : rst;
}

// The input path of one block: the raw (2*8+6) x (2*32+6) window of ref
// and dis for the subband tile at (i0, j0) of frame blockIdx.z, from raw
// row rs = 2*i0 - 4 and column cs = 2*j0 - 4 (reflected), into shared
// memory as f32. Shared by adm_scale_kernel and adm_input_kernel, so the
// input-only kernel (6a) moves exactly what kernel 6 moves.
template <typename T>
__device__ __forceinline__ void adm_stage_window(const T* __restrict__ ref, const T* __restrict__ dis,
                                                 int h, int w, int i0, int j0, float* so, float* st) {
  const int rs = 2 * (i0 - 1) - 2, cs = 2 * (j0 - 1) - 2;
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  for (int i = threadIdx.x; i < kAdmRR * kAdmRC; i += kThreads) {
    const int r = i / kAdmRC, c = i % kAdmRC;
    const size_t g = frame + static_cast<size_t>(reflect_idx(rs + r, h)) * w + reflect_idx(cs + c, w);
    so[i] = load_f(ref, g);
    st[i] = load_f(dis, g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adm_scale_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w, Taps db2,
                 float fh, float fv, float fd, float cos1sq, int top, int left, float egl,
                 int has_egl, double* __restrict__ part, int n_tiles, float* __restrict__ a_ref,
                 float* __restrict__ a_dis) {
  __shared__ float so[kAdmRR * kAdmRC];
  __shared__ float st[kAdmRR * kAdmRC];
  __shared__ float lo_o[kAdmHR * kAdmRC], hi_o[kAdmHR * kAdmRC];
  __shared__ float lo_t[kAdmHR * kAdmRC], hi_t[kAdmHR * kAdmRC];
  __shared__ float spread[kAdmHR * kAdmHC];
  __shared__ float core[6][kAdmTH * kAdmTW];  // rh, rv, rd, oh, ov, od
  __shared__ double red[kThreads];

  const int tid = threadIdx.x;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const int i0 = blockIdx.y * kAdmTH, j0 = blockIdx.x * kAdmTW;
  const int rs = 2 * (i0 - 1) - 2, cs = 2 * (j0 - 1) - 2;

  adm_stage_window(ref, dis, h, w, i0, j0, so, st);
  __syncthreads();

  // Vertical pass at the (clamped) even rows of the halo'd subband rows.
  for (int i = tid; i < kAdmHR * kAdmRC; i += kThreads) {
    const int hr = i / kAdmRC, c = i % kAdmRC;
    const int base = 2 * clamp_idx(i0 - 1 + hr, h2) - 2 - rs;
    float lo = 0.f, hi = 0.f, lt = 0.f, ht = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float xo = so[(base + t) * kAdmRC + c], xt = st[(base + t) * kAdmRC + c];
      const float plo = mul(db2.t[t], xo), phi = mul(db2.t[4 + t], xo);
      const float plt = mul(db2.t[t], xt), pht = mul(db2.t[4 + t], xt);
      lo = t == 0 ? plo : add(lo, plo);
      hi = t == 0 ? phi : add(hi, phi);
      lt = t == 0 ? plt : add(lt, plt);
      ht = t == 0 ? pht : add(ht, pht);
    }
    lo_o[i] = lo;
    hi_o[i] = hi;
    lo_t[i] = lt;
    hi_t[i] = ht;
  }
  __syncthreads();

  // Horizontal pass, decoupling and CSF at every halo'd subband position.
  for (int i = tid; i < kAdmHR * kAdmHC; i += kThreads) {
    const int hr = i / kAdmHC, hc = i % kAdmHC;
    const int off = hr * kAdmRC + 2 * clamp_idx(j0 - 1 + hc, w2) - 2 - cs;
    const Bands o = h_pass(lo_o + off, hi_o + off, db2);
    const Bands t = h_pass(lo_t + off, hi_t + off, db2);
    const float ot_dp = add(mul(o.h, t.h), mul(o.v, t.v));
    const float o_mag = add(mul(o.h, o.h), mul(o.v, o.v));
    const float t_mag = add(mul(t.h, t.h), mul(t.v, t.v));
    const bool angle_ok = ot_dp >= 0.0f && mul(ot_dp, ot_dp) >= mul(mul(cos1sq, o_mag), t_mag);
    const float rh = restore(o.h, t.h, angle_ok, egl, has_egl);
    const float rv = restore(o.v, t.v, angle_ok, egl, has_egl);
    const float rd = restore(o.d, t.d, angle_ok, egl, has_egl);
    spread[i] = add(add(fabsf(mul(sub(t.h, rh), fh)), fabsf(mul(sub(t.v, rv), fv))),
                    fabsf(mul(sub(t.d, rd), fd)));
    if (hr >= 1 && hr <= kAdmTH && hc >= 1 && hc <= kAdmTW) {
      const int k = (hr - 1) * kAdmTW + (hc - 1);
      core[0][k] = rh;
      core[1][k] = rv;
      core[2][k] = rd;
      core[3][k] = o.h;
      core[4][k] = o.v;
      core[5][k] = o.d;
      const int gi = i0 + hr - 1, gj = j0 + hc - 1;
      if (gi < h2 && gj < w2) {
        const size_t g = static_cast<size_t>(blockIdx.z) * h2 * w2 + static_cast<size_t>(gi) * w2 + gj;
        a_ref[g] = o.a;
        a_dis[g] = t.a;
      }
    }
  }
  __syncthreads();

  // Masking threshold and the center-crop L3 terms, one core position each.
  double acc[kAdmQ] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int cr = tid / kAdmTW, cc = tid % kAdmTW;
  const int gi = i0 + cr, gj = j0 + cc;
  if (gi < h2 && gj < w2 && gi >= top && gi < h2 - top && gj >= left && gj < w2 - left) {
    const float* s = spread + (cr + 1) * kAdmHC + (cc + 1);
    float thr = mul(2.0f, s[0]);
    thr = add(thr, s[-kAdmHC - 1]);
    thr = add(thr, s[-kAdmHC]);
    thr = add(thr, s[-kAdmHC + 1]);
    thr = add(thr, s[-1]);
    thr = add(thr, s[1]);
    thr = add(thr, s[kAdmHC - 1]);
    thr = add(thr, s[kAdmHC]);
    thr = add(thr, s[kAdmHC + 1]);
    thr = __fdiv_rn(thr, 30.0f);
    const float f[3] = {fh, fv, fd};
#pragma unroll
    for (int band = 0; band < 3; ++band) {
      const float m = fmaxf(sub(fabsf(mul(core[band][tid], f[band])), thr), 0.0f);
      const float a = fabsf(mul(core[3 + band][tid], f[band]));
      acc[2 * band] = mul(mul(m, m), m);
      acc[2 * band + 1] = mul(mul(a, a), a);
    }
  }
#pragma unroll
  for (int q = 0; q < kAdmQ; ++q) put_partial(part, kAdmQ, q, n_tiles, block_sum(acc[q], red));
}

// Kernel 6a, the input path alone: every block stages its window exactly
// as adm_scale_kernel does and computes nothing else but a checksum, and it
// is launched at kernel 6's blocks per SM (adm_input_pad), so its time is
// what kernel 6 pays to load its windows. The checksum is the TPU
// kernel's (adm_pallas.py::_adm0_dma_only_kernel): per frame, the sum over
// the TPU strip plan of ref[st_s, 0] + dis[st_s, 0], with st_s =
// clip(floor((2*s*strip - 4) / 8), 0, st_cap8) * 8 (adm_pallas.py::
// _dma_row_start). Row st_s < h always, and lies in exactly one tile's
// interior rows [2*i0, 2*i0 + 16); that tile of column 0 adds it from its
// staged window. Per-tile partials (float64, exact for these values) are
// reduced per frame in a fixed order, as kernel 6 reduces its sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adm_input_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w, int strip,
                 int n_strips, int st_cap8, double* __restrict__ part, int n_tiles) {
  __shared__ float so[kAdmRR * kAdmRC];
  __shared__ float st[kAdmRR * kAdmRC];
  __shared__ double red[kThreads];

  const int i0 = blockIdx.y * kAdmTH, j0 = blockIdx.x * kAdmTW;
  adm_stage_window(ref, dis, h, w, i0, j0, so, st);
  __syncthreads();
  if (blockIdx.x != 0) {
    put_partial(part, 1, 0, n_tiles, 0.0);
    return;
  }
  const int rs = 2 * (i0 - 1) - 2, cs = 2 * (j0 - 1) - 2;
  double acc = 0.0;
  for (int s = threadIdx.x; s < n_strips; s += kThreads) {
    const int q = 2 * s * strip - 4;
    const int row = min(max(q >= 0 ? q / 8 : -((7 - q) / 8), 0), st_cap8) * 8;
    if (row >= 2 * i0 && row < 2 * i0 + 2 * kAdmTH) {
      const int k = (row - rs) * kAdmRC - cs;
      acc += static_cast<double>(so[k]) + static_cast<double>(st[k]);
    }
  }
  put_partial(part, 1, 0, n_tiles, block_sum(acc, red));
}

inline dim3 adm_grid(int b, int h, int w) {
  return dim3(cdiv((w + 1) / 2, kAdmTW), cdiv((h + 1) / 2, kAdmTH), b);
}

inline int adm_tiles(int h, int w) { return cdiv((w + 1) / 2, kAdmTW) * cdiv((h + 1) / 2, kAdmTH); }

// Kernel 6a's blocks hold a third of kernel 6's shared memory and fewer
// registers, so more of them would fit on an SM, and its time would be the
// staging cost at another occupancy. It is launched with unused dynamic
// shared memory, padded in 256-byte steps until no more of its blocks fit
// per SM than of kernel 6's. *pad: the bytes, found once per input type.
template <typename T>
cudaError_t adm_input_pad(int* pad) {
  static const auto found = []() -> std::pair<cudaError_t, int> {
    int k6 = 0, dev = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k6, adm_scale_kernel<T>, kThreads, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, adm_input_kernel<T>);
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(adm_input_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    for (int bytes = 0; e == cudaSuccess && bytes <= room; bytes += 256) {
      int k6a = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k6a, adm_input_kernel<T>, kThreads, bytes);
      if (e == cudaSuccess && k6a <= k6) return {k6a == k6 ? cudaSuccess : cudaErrorInvalidConfiguration, bytes};
    }
    return {e == cudaSuccess ? cudaErrorInvalidConfiguration : e, 0};
  }();
  *pad = found.second;
  return found.first;
}

}  // namespace

// Doubles of per-tile partial scratch that rtvqa_adm_scale needs.
extern "C" long long rtvqa_adm_scratch(int b, int h, int w) {
  return static_cast<long long>(b) * kAdmQ * adm_tiles(h, w);
}

// ref/dis: (b, h, w) contiguous on the device, uint8 when is_u8 else f32.
// db2: host array [LO0..LO3, HI0..HI3] f32. fh/fv/fd: the scale's CSF
// weights; cos1sq: cos^2(1 deg) as f32; top/left: the center crop of the
// (ceil(h/2), ceil(w/2)) subband grid. part: rtvqa_adm_scratch() doubles.
// Outputs: sums (b, 6) f64 [num_h, den_h, num_v, den_v, num_d, den_d]
// (before the cube roots); a_ref/a_dis (b, ceil(h/2), ceil(w/2)) f32.
// Returns the first failing launch's cudaError_t (0 = all launched).
extern "C" int rtvqa_adm_scale(const void* ref, const void* dis, int is_u8, int b, int h, int w,
                               const float* db2, float fh, float fv, float fd, float cos1sq,
                               int top, int left, float egl, int has_egl, double* part,
                               double* sums, float* a_ref, float* a_dis, void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = adm_tiles(h, w);
  const Taps taps = make_taps(db2, 8);
  if (is_u8) {
    adm_scale_kernel<uint8_t><<<adm_grid(b, h, w), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(dis), h, w, taps, fh, fv,
        fd, cos1sq, top, left, egl, has_egl, part, n_tiles, a_ref, a_dis);
  } else {
    adm_scale_kernel<float><<<adm_grid(b, h, w), kThreads, 0, stream>>>(
        static_cast<const float*>(ref), static_cast<const float*>(dis), h, w, taps, fh, fv, fd,
        cos1sq, top, left, egl, has_egl, part, n_tiles, a_ref, a_dis);
  }
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b * kAdmQ, kThreads, 0, stream>>>(part, n_tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// Kernel 6a. ref/dis as for rtvqa_adm_scale; strip, n_strips, st_cap8: the
// TPU strip plan (kernels/adm.py::adm_strip_plan). part: b * adm_tiles
// doubles (rtvqa_adm_scratch(b, h, w) / 6 suffices). Output: sums (b,) f64.
// Returns cudaErrorInvalidConfiguration if no padding gives 6a kernel 6's
// blocks per SM, else as rtvqa_adm_scale.
extern "C" int rtvqa_adm_input(const void* ref, const void* dis, int is_u8, int b, int h, int w,
                               int strip, int n_strips, int st_cap8, double* part, double* sums,
                               void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = adm_tiles(h, w);
  int pad = 0;
  const cudaError_t e = is_u8 ? adm_input_pad<uint8_t>(&pad) : adm_input_pad<float>(&pad);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (is_u8) {
    adm_input_kernel<uint8_t><<<adm_grid(b, h, w), kThreads, pad, stream>>>(
        static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(dis), h, w, strip, n_strips,
        st_cap8, part, n_tiles);
  } else {
    adm_input_kernel<float><<<adm_grid(b, h, w), kThreads, pad, stream>>>(
        static_cast<const float*>(ref), static_cast<const float*>(dis), h, w, strip, n_strips,
        st_cap8, part, n_tiles);
  }
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b, kThreads, 0, stream>>>(part, n_tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}
