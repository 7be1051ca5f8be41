// ADM (VMAF's detail loss metric) at one DWT scale: one db2 DWT level of ref
// and dis (reflect borders, 2 taps before and 1 after, even-phase
// decimation), decoupling of the detail bands (gain clip to [0, 1], the
// cos(1 deg) angle test, optional NEG gain cap), Watson CSF weighting, the
// 3x3 edge-replicated masking threshold of the CSF-weighted additive
// residual (center weight 2, /30), and the six center-crop L3 sums (num and
// den for h, v, d) per frame, plus the next scale's approximation bands.
//
// Replaces: rtvqa_tpu/kernels/adm_pallas.py::adm_scale_pallas at scale 0
// (kernel body _adm0_kernel, u8 input; rtvqa_adm_scale) and
// adm_pallas.py::adm_tail_pallas (kernel body _adm_tail_kernel; scales 1-3
// on f32 input, rtvqa_adm_tail). adm_input_kernel replaces
// adm_scale_pallas(stages=0) (kernel body _adm0_dma_only_kernel): kernel
// 6's input path and a checksum, nothing else (bound: its input bytes,
// ~0.08 ms per 64-frame 1080p u8 pair).
//
// The TPU kernels built every border into banded selection matrices and
// lane rolls because Mosaic has no dynamic slicing. Here a block owns a
// column band 32 subband columns wide and walks down it, kAdmRun tiles of
// 16 subband rows. For each tile it stages the raw (2*16+6)-row window of
// both frames (common.cuh stage_tile: 16-byte cp.async pieces into the
// other of two buffers while the tile before computes, border tiles
// mirrored in shared memory, no modulo inside the frame), runs the vertical
// db2 pass, then the horizontal pass with decoupling and CSF for the
// (16+2) x (32+2) subband region (the 1-sample ring is the masking halo;
// its positions outside the frame are read back clamped = edge
// replication), masks and pools the 16 x 32 core, and reduces its six sums
// with warp shuffles and one cross-warp step. Each thread keeps its two
// core positions' bands in registers from the horizontal pass to the mask.
// Every pixel's arithmetic is the plain version's, in its order. Pooling is
// the literal form sum(|o*f|^3) — the TPU kernel's reassociated den
// (sum(|o|^3)*f^3) is not carried over. The cube roots and the
// cbrt(area/32) offsets are applied after the per-frame sums, by the caller.
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
constexpr int kAdmTH = 16, kAdmTW = 32;                   // core subband tile
constexpr int kAdmHR = kAdmTH + 2, kAdmHC = kAdmTW + 2;   // with the mask halo
constexpr int kAdmVC = 2 * kAdmHC + 2;                    // vertical-pass columns (raw 2*j0 - 4 ..)
constexpr int kAdmRows = 2 * kAdmTH + 6;                  // staged raw rows (2*i0 - 4 ..)
constexpr int kAdmRun = 4;                                // tiles per block, down its band
constexpr int kAdmMinBlocks = 4;                          // per SM (registers <= 64)
constexpr int kAdmCore = kAdmTH * kAdmTW / kThreads;      // core positions per thread
constexpr int kAdmRing = 2 * kAdmHC + 2 * kAdmTH;         // halo positions
constexpr float kAdmEps = 1e-30f;
static_assert(kAdmCore * kThreads == kAdmTH * kAdmTW && kAdmRing <= kThreads, "thread plan");

// The stage of one tile: raw rows 2*i0 - 4 .. and columns 2*j0 - kHX ..
// of ref and dis, in two buffers. kHX is a 16-byte piece (at least the 4
// columns the db2 pass reaches left of the tile).
template <typename T>
struct AdmStage {
  static constexpr int kHX = 16 / sizeof(T) > 4 ? 16 / sizeof(T) : 4;
  static constexpr int kCols = 2 * kAdmTW + 2 * kHX;
  T img[2][2][kAdmRows * kCols];  // [buffer][ref, dis]
};

template <typename T>
struct AdmSmem {
  AdmStage<T> stage;
  float lohi[4][kAdmHR * kAdmVC];  // vertical pass: lo, hi of ref, then of dis
  float spread[kAdmHR * kAdmHC];   // summed |CSF-weighted additive| bands
  double red[kAdmQ][kThreads / 32];
};

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

struct AdmParams {
  Taps db2;
  float f[3];  // CSF weights h, v, d
  float cos1sq, egl;
  int has_egl, top, left;
};

// One halo'd subband position (hr, hc) of the tile: the approximation
// bands, the restored and original detail bands (rh, rv, rd, oh, ov, od
// into core), and its spread value into s.spread.
template <typename T>
__device__ __forceinline__ Bands adm_position(AdmSmem<T>& s, int hr, int hc, const AdmParams& p,
                                              float* core, float& a_t) {
  const int off = hr * kAdmVC + 2 * hc;
  const Bands o = h_pass(s.lohi[0] + off, s.lohi[1] + off, p.db2);
  const Bands t = h_pass(s.lohi[2] + off, s.lohi[3] + off, p.db2);
  const float ot_dp = add(mul(o.h, t.h), mul(o.v, t.v));
  const float o_mag = add(mul(o.h, o.h), mul(o.v, o.v));
  const float t_mag = add(mul(t.h, t.h), mul(t.v, t.v));
  const bool angle_ok = ot_dp >= 0.0f && mul(ot_dp, ot_dp) >= mul(mul(p.cos1sq, o_mag), t_mag);
  const float rh = restore(o.h, t.h, angle_ok, p.egl, p.has_egl);
  const float rv = restore(o.v, t.v, angle_ok, p.egl, p.has_egl);
  const float rd = restore(o.d, t.d, angle_ok, p.egl, p.has_egl);
  s.spread[hr * kAdmHC + hc] = add(add(fabsf(mul(sub(t.h, rh), p.f[0])), fabsf(mul(sub(t.v, rv), p.f[1]))),
                                   fabsf(mul(sub(t.d, rd), p.f[2])));
  core[0] = rh;
  core[1] = rv;
  core[2] = rd;
  core[3] = o.h;
  core[4] = o.v;
  core[5] = o.d;
  a_t = t.a;
  return o;
}

// The walk of one block down its column band (shared by adm_scale_kernel
// and adm_input_kernel, so that kernel 6a moves exactly what kernel 6
// moves): stages tile ty0's window, then for each tile starts the next
// tile's copies and calls tile(ty, stage of ref, stage of dis).
template <typename T, typename Tile>
__device__ __forceinline__ void adm_walk(AdmStage<T>& st, const T* ref, const T* dis, int h, int w,
                                         bool aligned, int tiles_y, Tile tile) {
  constexpr int kCols = AdmStage<T>::kCols;
  const size_t plane = static_cast<size_t>(h) * w;
  ref += blockIdx.z * plane;
  dis += blockIdx.z * plane;
  const int cx0 = 2 * static_cast<int>(blockIdx.x) * kAdmTW - AdmStage<T>::kHX;
  const int ty0 = blockIdx.y * kAdmRun, ty1 = min(tiles_y, ty0 + kAdmRun);
  const auto ry0 = [](int ty) { return 2 * ty * kAdmTH - 4; };
  const auto mirror = [&](int ty) { return aligned && stage_at_border<kAdmRows, kCols>(h, w, ry0(ty), cx0); };
  stage_tile<T, kAdmRows, kCols>(st.img[0][0], st.img[0][1], ref, dis, h, w, ry0(ty0), cx0, aligned);
  cp_async_wait<0>();
  __syncthreads();
  if (mirror(ty0)) {
    stage_mirror<T, kAdmRows, kCols>(st.img[0][0], st.img[0][1], h, w, ry0(ty0), cx0);
    __syncthreads();
  }
  for (int ty = ty0, k = 0; ty < ty1; ++ty, ++k) {
    T* nr = st.img[(k + 1) & 1][0];
    T* nd = st.img[(k + 1) & 1][1];
    if (ty + 1 < ty1) stage_tile<T, kAdmRows, kCols>(nr, nd, ref, dis, h, w, ry0(ty + 1), cx0, aligned);
    tile(ty, st.img[k & 1][0], st.img[k & 1][1]);
    cp_async_wait<0>();
    __syncthreads();  // tile ty is done with its buffers; tile ty + 1's copies have landed
    if (ty + 1 < ty1 && mirror(ty + 1)) {
      stage_mirror<T, kAdmRows, kCols>(nr, nd, h, w, ry0(ty + 1), cx0);
      __syncthreads();
    }
  }
}

// Grid: (column bands, runs of kAdmRun tiles down a band, frames). Writes
// the six per-tile sums of every tile (frames, 6, bands * tiles_y) and,
// unless a_ref is null, the approximation bands.
template <typename T>
__global__ void __launch_bounds__(kThreads, kAdmMinBlocks)
adm_scale_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w, int aligned,
                 AdmParams p, double* __restrict__ part, float* __restrict__ a_ref,
                 float* __restrict__ a_dis) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AdmSmem<T>& s = *reinterpret_cast<AdmSmem<T>*>(smem_raw);
  constexpr int kHX = AdmStage<T>::kHX, kCols = AdmStage<T>::kCols;
  const int tid = threadIdx.x;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const int tiles_y = cdiv(h2, kAdmTH), n_tiles = gridDim.x * tiles_y;
  const int j0 = blockIdx.x * kAdmTW;
  const size_t a_frame = static_cast<size_t>(blockIdx.z) * h2 * w2;

  adm_walk<T>(s.stage, ref, dis, h, w, aligned, tiles_y, [&](int ty, const T* sr, const T* sd) {
    const int i0 = ty * kAdmTH;
    // Vertical pass at the even rows 2i of subband rows i = i0 - 1 .. i0 +
    // kAdmTH (stage rows 2hr .. 2hr + 3) and raw columns 2*j0 - 4 + c.
    for (int i = tid; i < kAdmHR * kAdmVC; i += kThreads) {
      const int hr = i / kAdmVC, c = i - hr * kAdmVC;
      const T* po = sr + 2 * hr * kCols + c + kHX - 4;
      const T* pt = sd + 2 * hr * kCols + c + kHX - 4;
      float lo = 0.f, hi = 0.f, lt = 0.f, ht = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xo = static_cast<float>(po[t * kCols]), xt = static_cast<float>(pt[t * kCols]);
        const float plo = mul(p.db2.t[t], xo), phi = mul(p.db2.t[4 + t], xo);
        const float plt = mul(p.db2.t[t], xt), pht = mul(p.db2.t[4 + t], xt);
        lo = t == 0 ? plo : add(lo, plo);
        hi = t == 0 ? phi : add(hi, phi);
        lt = t == 0 ? plt : add(lt, plt);
        ht = t == 0 ? pht : add(ht, pht);
      }
      s.lohi[0][i] = lo;
      s.lohi[1][i] = hi;
      s.lohi[2][i] = lt;
      s.lohi[3][i] = ht;
    }
    __syncthreads();

    // Horizontal pass, decoupling and CSF: this thread's core positions
    // (kept in registers), then the halo ring, shared out.
    float core[kAdmCore][6], ring[6], a_t;
#pragma unroll
    for (int k = 0; k < kAdmCore; ++k) {
      const int q = tid + k * kThreads, r = q / kAdmTW, c = q % kAdmTW;
      const Bands o = adm_position(s, r + 1, c + 1, p, core[k], a_t);
      const int gi = i0 + r, gj = j0 + c;
      if (a_ref != nullptr && gi < h2 && gj < w2) {
        const size_t g = a_frame + static_cast<size_t>(gi) * w2 + gj;
        a_ref[g] = o.a;
        a_dis[g] = a_t;
      }
    }
    if (tid < kAdmRing) {
      int hr, hc;
      if (tid < 2 * kAdmHC) {
        hr = tid < kAdmHC ? 0 : kAdmHR - 1;
        hc = tid % kAdmHC;
      } else {
        hr = 1 + (tid - 2 * kAdmHC) / 2;
        hc = tid & 1 ? kAdmHC - 1 : 0;
      }
      adm_position(s, hr, hc, p, ring, a_t);
    }
    __syncthreads();

    // Masking threshold (neighbours at clamped subband positions) and the
    // center-crop L3 terms of this thread's core positions.
    double acc[kAdmQ] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int k = 0; k < kAdmCore; ++k) {
      const int q = tid + k * kThreads, r = q / kAdmTW, c = q % kAdmTW;
      const int gi = i0 + r, gj = j0 + c;
      if (gi < h2 && gj < w2 && gi >= p.top && gi < h2 - p.top && gj >= p.left && gj < w2 - p.left) {
        const int ym = clamp_idx(gi - 1, h2) - i0 + 1, yp = clamp_idx(gi + 1, h2) - i0 + 1;
        const int xm = clamp_idx(gj - 1, w2) - j0 + 1, xp = clamp_idx(gj + 1, w2) - j0 + 1;
        const float* sp = s.spread;
        float thr = mul(2.0f, sp[(r + 1) * kAdmHC + c + 1]);
        thr = add(thr, sp[ym * kAdmHC + xm]);
        thr = add(thr, sp[ym * kAdmHC + c + 1]);
        thr = add(thr, sp[ym * kAdmHC + xp]);
        thr = add(thr, sp[(r + 1) * kAdmHC + xm]);
        thr = add(thr, sp[(r + 1) * kAdmHC + xp]);
        thr = add(thr, sp[yp * kAdmHC + xm]);
        thr = add(thr, sp[yp * kAdmHC + c + 1]);
        thr = add(thr, sp[yp * kAdmHC + xp]);
        thr = __fdiv_rn(thr, 30.0f);
#pragma unroll
        for (int band = 0; band < 3; ++band) {
          const float m = fmaxf(sub(fabsf(mul(core[k][band], p.f[band])), thr), 0.0f);
          const float a = fabsf(mul(core[k][3 + band], p.f[band]));
          acc[2 * band] += mul(mul(m, m), m);
          acc[2 * band + 1] += mul(mul(a, a), a);
        }
      }
    }
    double total;
    block_sums<kAdmQ>(acc, s.red, total);
    if (tid < kAdmQ) {
      part[(static_cast<size_t>(blockIdx.z) * kAdmQ + tid) * n_tiles + ty * gridDim.x + blockIdx.x] = total;
    }
  });
}

// Kernel 6a, the input path alone: every block walks its band and stages
// each tile's window exactly as adm_scale_kernel does (adm_walk), computes
// nothing else but a checksum, and is launched at kernel 6's blocks per SM
// (adm_input_smem), so its time is what kernel 6 pays to load its windows.
// The checksum is the TPU kernel's (adm_pallas.py::_adm0_dma_only_kernel):
// per frame, the sum over the TPU strip plan of ref[st_s, 0] + dis[st_s,
// 0], with st_s = clip(floor((2*s*strip - 4) / 8), 0, st_cap8) * 8
// (adm_pallas.py::_dma_row_start). Row st_s < h always, and lies in
// exactly one tile's interior rows [2*i0, 2*i0 + 2*kAdmTH); that tile of
// band 0 adds it from its stage. Per-tile partials (float64, exact for
// these values) are reduced per frame in a fixed order, as kernel 6's sums.
template <typename T>
__global__ void __launch_bounds__(kThreads, kAdmMinBlocks)
adm_input_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int h, int w, int aligned,
                 int strip, int n_strips, int st_cap8, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AdmStage<T>& st = *reinterpret_cast<AdmStage<T>*>(smem_raw);
  __shared__ double red[1][kThreads / 32];
  constexpr int kCols = AdmStage<T>::kCols;
  const int tiles_y = cdiv((h + 1) / 2, kAdmTH), n_tiles = gridDim.x * tiles_y;

  adm_walk<T>(st, ref, dis, h, w, aligned, tiles_y, [&](int ty, const T* sr, const T* sd) {
    const int i0 = ty * kAdmTH;
    double acc = 0.0;
    if (blockIdx.x == 0) {
      for (int s = threadIdx.x; s < n_strips; s += kThreads) {
        const int q = 2 * s * strip - 4;
        const int row = min(max(q >= 0 ? q / 8 : -((7 - q) / 8), 0), st_cap8) * 8;
        if (row >= 2 * i0 && row < 2 * i0 + 2 * kAdmTH) {
          const int k = (row - (2 * i0 - 4)) * kCols + AdmStage<T>::kHX;  // column 0
          acc += static_cast<double>(sr[k]) + static_cast<double>(sd[k]);
        }
      }
    }
    double total;
    block_sums<1>(&acc, red, total);
    if (threadIdx.x == 0) part[static_cast<size_t>(blockIdx.z) * n_tiles + ty * gridDim.x + blockIdx.x] = total;
  });
}

inline int adm_bands(int w) { return cdiv((w + 1) / 2, kAdmTW); }

inline int adm_tiles(int h, int w) { return adm_bands(w) * cdiv((h + 1) / 2, kAdmTH); }

inline dim3 adm_grid(int b, int h, int w) {
  return dim3(adm_bands(w), cdiv(cdiv((h + 1) / 2, kAdmTH), kAdmRun), b);
}

// Kernel 6a's blocks hold only kernel 6's stage and fewer registers, so
// more of them would fit on an SM, and its time would be the staging cost
// at another occupancy. It is launched with its stage plus unused dynamic
// shared memory, padded in 256-byte steps until no more of its blocks fit
// per SM than of kernel 6's. *bytes: the dynamic shared memory of a 6a
// block, found once per input type.
template <typename T>
cudaError_t adm_input_smem(int* bytes) {
  static const auto found = []() -> std::pair<cudaError_t, int> {
    int k6 = 0, dev = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t e = smem_opt_in<adm_scale_kernel<T>>(sizeof(AdmSmem<T>));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k6, adm_scale_kernel<T>, kThreads, sizeof(AdmSmem<T>));
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, adm_input_kernel<T>);
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(adm_input_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    for (int b = sizeof(AdmStage<T>); e == cudaSuccess && b <= room; b += 256) {
      int k6a = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k6a, adm_input_kernel<T>, kThreads, b);
      if (e == cudaSuccess && k6a <= k6) return {k6a == k6 ? cudaSuccess : cudaErrorInvalidConfiguration, b};
    }
    return {e == cudaSuccess ? cudaErrorInvalidConfiguration : e, 0};
  }();
  *bytes = found.second;
  return found.first;
}

// One scale: the kernel's per-tile sums into part, their per-frame
// reduction into sums (b, 6) unless sums is null, the approximation bands
// unless a_ref is null.
template <typename T>
int adm_launch(const T* ref, const T* dis, int b, int h, int w, const AdmParams& p, double* part,
               double* sums, float* a_ref, float* a_dis, cudaStream_t stream) {
  const cudaError_t e = smem_opt_in<adm_scale_kernel<T>>(sizeof(AdmSmem<T>));
  if (e != cudaSuccess) return static_cast<int>(e);
  adm_scale_kernel<T><<<adm_grid(b, h, w), kThreads, sizeof(AdmSmem<T>), stream>>>(
      ref, dis, h, w, stage_aligned(ref, dis, w), p, part, a_ref, a_dis);
  RTVQA_LAUNCH_CHECK();
  if (sums != nullptr) {
    reduce_rows_kernel<<<b * kAdmQ, kThreads, 0, stream>>>(part, adm_tiles(h, w), sums);
    RTVQA_LAUNCH_CHECK();
  }
  return 0;
}

AdmParams adm_params(const float* db2, const float* csf, float cos1sq, int top, int left, float egl,
                     int has_egl) {
  AdmParams p;
  p.db2 = make_taps(db2, 8);
  for (int i = 0; i < 3; ++i) p.f[i] = csf[i];
  p.cos1sq = cos1sq;
  p.egl = egl;
  p.has_egl = has_egl;
  p.top = top;
  p.left = left;
  return p;
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
  const float csf[3] = {fh, fv, fd};
  const AdmParams p = adm_params(db2, csf, cos1sq, top, left, egl, has_egl);
  if (is_u8) {
    return adm_launch(static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(dis), b, h, w, p,
                      part, sums, a_ref, a_dis, stream);
  }
  return adm_launch(static_cast<const float*>(ref), static_cast<const float*>(dis), b, h, w, p, part,
                    sums, a_ref, a_dis, stream);
}

// Floats of image scratch and doubles of partial scratch for rtvqa_adm_tail.
extern "C" long long rtvqa_adm_tail_scratch_floats(int b, int h1, int w1) {
  const int h2 = (h1 + 1) / 2, w2 = (w1 + 1) / 2;
  return 2 * plane_floats(b, h2, w2) + 2 * plane_floats(b, (h2 + 1) / 2, (w2 + 1) / 2);
}

extern "C" long long rtvqa_adm_tail_scratch_doubles(int b, int h1, int w1) {
  long long n = 0;
  for (int s = 0; s < 3; ++s, h1 = (h1 + 1) / 2, w1 = (w1 + 1) / 2) n += rtvqa_adm_scratch(b, h1, w1);
  return n;
}

// Kernel 7, ADM scales 1-3. ref/dis: the (b, h1, w1) f32 scale-1 inputs
// (scale 0's approximation bands), contiguous on the device. db2 as for
// rtvqa_adm_scale; csf: host f32 [fh, fv, fd] of scales 1, 2, 3; crop: host
// [top, left] of scales 1, 2, 3. img: rtvqa_adm_tail_scratch_floats()
// floats, the scale-2 and scale-3 inputs (scale 3 writes no bands); part:
// rtvqa_adm_tail_scratch_doubles() doubles. Output: sums (b, 18) f64, per
// frame the six sums of scale 1, then 2, then 3. Returns the first failing
// launch's cudaError_t (0 = all launched).
extern "C" int rtvqa_adm_tail(const float* ref, const float* dis, int b, int h1, int w1,
                              const float* db2, const float* csf, const int* crop, float cos1sq,
                              float egl, int has_egl, float* img, double* part, double* sums,
                              void* stream_ptr) {
  if (b == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Segments tiles{};
  const float* in_r = ref;
  const float* in_d = dis;
  float* out = img;
  double* seg = part;
  int h = h1, w = w1;
  for (int s = 0; s < 3; ++s) {
    const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
    const long long n = plane_floats(b, h2, w2);
    float* a_r = s < 2 ? out : nullptr;
    float* a_d = s < 2 ? out + n : nullptr;
    const AdmParams p = adm_params(db2, csf + 3 * s, cos1sq, crop[2 * s], crop[2 * s + 1], egl, has_egl);
    const int code = adm_launch(in_r, in_d, b, h, w, p, seg, nullptr, a_r, a_d, stream);
    if (code != 0) return code;
    tiles.n[s] = adm_tiles(h, w);
    seg += rtvqa_adm_scratch(b, h, w);
    in_r = a_r;
    in_d = a_d;
    out += 2 * n;
    h = h2;
    w = w2;
  }
  reduce_segments_kernel<<<b * 3 * kAdmQ, kThreads, 0, stream>>>(part, b, kAdmQ, tiles, sums);
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
  int bytes = 0;
  const cudaError_t e = is_u8 ? adm_input_smem<uint8_t>(&bytes) : adm_input_smem<float>(&bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (is_u8) {
    const auto* r = static_cast<const uint8_t*>(ref);
    const auto* d = static_cast<const uint8_t*>(dis);
    adm_input_kernel<uint8_t><<<adm_grid(b, h, w), kThreads, bytes, stream>>>(
        r, d, h, w, stage_aligned(r, d, w), strip, n_strips, st_cap8, part);
  } else {
    const auto* r = static_cast<const float*>(ref);
    const auto* d = static_cast<const float*>(dis);
    adm_input_kernel<float><<<adm_grid(b, h, w), kThreads, bytes, stream>>>(
        r, d, h, w, stage_aligned(r, d, w), strip, n_strips, st_cap8, part);
  }
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b, kThreads, 0, stream>>>(part, adm_tiles(h, w), sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}
