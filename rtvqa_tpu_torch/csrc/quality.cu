// The quality chunk's per-frame pass over YUV420 pairs: plane SSEs (PSNR),
// x264 SSIM window sums for Y/U/V, the FILTER_5 blur of ref luma and its
// SAD against the previous frame's blur (VMAF motion), VIF scale 0 (17-tap
// moments and statistics), the 9-tap filtered, 2x-decimated scale-1 inputs
// of ref and dis luma, and the blurred last frame (the next chunk's carry).
//
// Replaces: rtvqa_tpu/kernels/quality_pallas.py::quality_fused_pallas
// (kernel body _fused_q_kernel). The TPU kernel did all of this in one
// strip pass over an ordered grid, carrying the previous frame's blur in
// VMEM and evaluating every filter as banded MXU matmuls. Here:
//  * quality_luma_kernel: one block owns one kLumaTH x kLumaTW tile of the frame
//    and walks a run of consecutive frames, so it stages each frame's u8
//    ref/dis tile (plus halo) once and computes everything from it, and
//    keeps its pixels' FILTER_5 blur in registers from one frame to the
//    next (a run that starts at frame b0 > 0 first blurs frame b0 - 1;
//    frame 0 is compared with prev_blur; the chunk's last frame writes the
//    carry). Staging (common.cuh stage_tile, stage_mirror, which kernels 5,
//    6 and 7 share): the 16-byte row pieces inside the frame are copied
//    with cp.async into the other of two buffers while the current frame
//    computes; a tile at a border then fills its pieces outside the frame
//    by mirroring staged bytes in shared memory (frames whose rows are not
//    16-byte aligned gather every piece from global memory instead). Each
//    staged pixel is converted to f32 and its moment products x^2, y^2, xy
//    are formed once. Stencils are register-blocked: in the vertical pass a
//    thread owns one column and keeps the 8 output rows of all five
//    moments in registers, so each staged word is read once per column; in
//    the horizontal pass a thread computes a run of 8 outputs of one row
//    from 16-byte loads of the (bank-conflict-free, padded) moment rows.
//    Filter taps are FMAs. From the one staged tile: the integer-exact SSE
//    and x264 4x4 block sums (as f32, exact below 2^24), the ssim_end1
//    windows, the blur and SAD, VIF scale 0 and the 9-tap filter at the
//    even rows and columns.
//  * ssim_sse_kernel: the chroma planes' SSE and SSIM, U and V in one
//    launch (a 32 x 128-pixel tile plus a 4-pixel halo per block).
//  * reduce_rows_kernel: per-frame fixed-order sums of the per-tile
//    partials (float64), so repeat runs give identical bits.
//
// Numerics. FMA taps round differently from the plain version's separate
// multiply and add, which only moves results by f32 rounding, except where
// the ref window is flat: there sigma1^2 = E[x^2] - mu1^2 is pure rounding
// noise (up to ~1e-5 E[x^2]), so the plain version's noise, not the signal,
// decides the sigma < 1e-10 branches and the log terms, and an FMA form
// gives other noise (VIF scale 0 then misses its tolerance on frames with
// large flat areas). So a tile in which any pixel has sigma1^2 < kFlatTol * E[x^2]
// recomputes its VIF moments with separate multiplies and adds in the plain
// version's order, whose per-pixel values equal the plain version's.
//
// Bound on the H100: operations. Per 64-frame 1080p chunk the pass moves
// ~0.68 GB (u8 planes in, two f32 quarter-size planes and the carry out:
// ~0.20 ms at 3.35 TB/s) but does ~450 f32 operations per luma pixel (FMA
// counted as two) — five 17-tap separable moment filters dominate — ~6e10
// in all, ~0.85 ms at 67 TFLOP/s.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kQ = 9;  // per-frame sums, in this order:
constexpr int kSseY = 0, kSseU = 1, kSsimY = 3, kSsimU = 4;  // then V at U + 1
constexpr int kSad = 6, kVifNum = 7, kVifDen = 8;

constexpr int kSsimC1 = 416;      // int(.01*.01*255*255*64 + .5)
constexpr int kSsimC2 = 235963;   // int(.03*.03*255*255*64*63 + .5)

// x264's ssim_end1 of one 8x8 window's sums, in the plain version's order.
__device__ __forceinline__ float ssim_end1(float w1, float w2, float wss, float w12) {
  const float vars = sub(sub(mul(wss, 64.0f), mul(w1, w1)), mul(w2, w2));
  const float covar = sub(mul(w12, 64.0f), mul(w1, w2));
  const float num = mul(add(mul(mul(2.0f, w1), w2), static_cast<float>(kSsimC1)),
                        add(mul(2.0f, covar), static_cast<float>(kSsimC2)));
  const float den = mul(add(add(mul(w1, w1), mul(w2, w2)), static_cast<float>(kSsimC1)),
                        add(vars, static_cast<float>(kSsimC2)));
  return __fdiv_rn(num, den);
}

// Per-tile partial q of frame f in a (frames, kQ, n_tiles) array.
__device__ __forceinline__ void put_part(double* part, int f, int q, int n_tiles, int tile, double v) {
  part[(static_cast<size_t>(f) * kQ + q) * n_tiles + tile] = v;
}

// ----- SSE + x264 SSIM of the chroma planes ---------------------------------

constexpr int kSsimBY = 8, kSsimBX = 32;              // windows per tile
constexpr int kSsimPH = 4 * kSsimBY + 4;              // staged pixel rows
constexpr int kSsimPW = 4 * kSsimBX + 4;              // staged pixel cols
constexpr int kSsimNB = (kSsimBY + 1) * (kSsimBX + 1);  // 4x4 blocks staged
static_assert(kSsimPW % 4 == 0, "staged rows are whole words");

// blockIdx.z < b: frame blockIdx.z of (ref0, dis0) into q_sse/q_ssim; else
// frame blockIdx.z - b of (ref1, dis1) into q_sse + 1/q_ssim + 1.
__global__ void __launch_bounds__(kThreads)
ssim_sse_kernel(const uint8_t* __restrict__ ref0, const uint8_t* __restrict__ dis0,
                const uint8_t* __restrict__ ref1, const uint8_t* __restrict__ dis1, int b, int h,
                int w, double* __restrict__ part, int q_sse, int q_ssim, int n_tiles) {
  __shared__ __align__(4) uint8_t sr[kSsimPH * kSsimPW];
  __shared__ __align__(4) uint8_t sd[kSsimPH * kSsimPW];
  __shared__ int bs[4][kSsimNB];
  __shared__ double red[2][kThreads / 32];

  const int tid = threadIdx.x;
  const int plane = blockIdx.z >= b, f = blockIdx.z - plane * b;
  const uint8_t* ref = plane ? ref1 : ref0;
  const uint8_t* dis = plane ? dis1 : dis0;
  const size_t frame = static_cast<size_t>(f) * h * w;
  const int y0 = blockIdx.y * 4 * kSsimBY, x0 = blockIdx.x * 4 * kSsimBX;
  if ((w & 3) == 0 && ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(dis)) & 3) == 0) {
    // 4-byte rows and bases: whole words, each inside the plane or past it.
    constexpr int kWords = kSsimPW / 4;
    for (int i = tid; i < kSsimPH * kWords; i += kThreads) {
      const int y = y0 + i / kWords, x = x0 + 4 * (i % kWords);
      const bool in = y < h && x < w;
      const size_t g = frame + static_cast<size_t>(y) * w + x;
      reinterpret_cast<uint32_t*>(sr)[i] = in ? *reinterpret_cast<const uint32_t*>(ref + g) : 0u;
      reinterpret_cast<uint32_t*>(sd)[i] = in ? *reinterpret_cast<const uint32_t*>(dis + g) : 0u;
    }
  } else {
    for (int i = tid; i < kSsimPH * kSsimPW; i += kThreads) {
      const int y = y0 + i / kSsimPW, x = x0 + i % kSsimPW;
      const bool in = y < h && x < w;
      const size_t g = frame + static_cast<size_t>(y) * w + x;
      sr[i] = in ? ref[g] : 0;
      sd[i] = in ? dis[g] : 0;
    }
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
        const int a = sr[p], c = sd[p];
        s1 += a;
        s2 += c;
        ss += a * a + c * c;
        s12 += a * c;
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
    ssim = ssim_end1(win[0], win[1], win[2], win[3]);
  }
  const double v[2] = {static_cast<double>(sse), ssim};
  double total;
  block_sums<2>(v, red, total);
  if (tid < 2) {
    put_part(part, f, (tid == 0 ? q_sse : q_ssim) + plane, n_tiles, blockIdx.y * gridDim.x + blockIdx.x, total);
  }
}

inline dim3 ssim_grid(int planes_x_frames, int h, int w) {
  return dim3(cdiv(w, 4 * kSsimBX), cdiv(h, 4 * kSsimBY), planes_x_frames);
}

// ----- The luma pass ---------------------------------------------------------

constexpr int kLumaTH = kThreads / 32;      // 8 output rows: one warp per row
constexpr int kLumaTW = 240;                // output columns (1920 = 8 tiles)
constexpr int kR = 8;                       // 17-tap VIF window radius
constexpr int kHaloX = 16;                  // staged columns each side (16-byte aligned)
constexpr int kStageRows = kLumaTH + 2 * kR;          // 24
constexpr int kStageCols = kLumaTW + 2 * kHaloX;      // 272
constexpr int kStageBytes = kStageRows * kStageCols;  // per image
constexpr int kCols = kLumaTW + 2 * kR;     // 256 vertical-pass columns, one per thread
constexpr int kPitch = kCols + kCols / 8;   // 4 floats of padding per 32 columns
constexpr int kRun = 8;                     // horizontal outputs per thread
constexpr int kRuns = kLumaTW / kRun;       // 30 runs per row
constexpr int kDecRows = kLumaTH / 2;       // even rows of the tile
constexpr int kBlk = kLumaTW / 4 + 1;       // 4x4 blocks per block row the windows need
constexpr int kWin = kLumaTW / 4;           // SSIM windows per block row the tile owns
static_assert(kCols == kThreads, "one vertical-pass column per thread");
static_assert(kLumaTW % 16 == 0 && kLumaTH % 4 == 0, "tiles align with 4x4 blocks and 16-byte rows");

struct LumaSmem {
  uint8_t stage[2][2][kStageBytes];  // [buffer][ref, dis], rows y0-8.., columns x0-16..
  float mom[5][kLumaTH][kPitch];     // vertical pass: mu1, mu2, E[r^2], E[d^2], E[rd]
  float blur[kLumaTH][kPitch];       // vertical FILTER_5 of ref
  float dec[2][kDecRows][kPitch];    // vertical 9-tap of ref, dis at the even rows
  float4 blk[3][kBlk];               // 4x4 block sums: ref, dis, ref^2 + dis^2, ref*dis
  double sums[5][kThreads];          // per thread: sse, ssim, sad, vif num, vif den
};

// The vertical pass on this thread's column (image column x0 - 8 +
// threadIdx.x), one walk down its staged rows: the five 17-tap VIF moments
// of all kLumaTH rows into mom; with kRest also the FILTER_5 blur of ref,
// the 9-tap filter of ref and dis at the even rows, the 4x4 block sums of
// the three block rows the tile's windows need, and the squared
// differences of the tile's own pixels.
template <bool kExact, bool kRest>
__device__ __forceinline__ void vert_pass(const uint8_t* sr, const uint8_t* sd, LumaSmem& s,
                                          const Taps& t17, const Taps& t9, const Taps& t5,
                                          bool sse_col, int rows_valid, double& sse_acc) {
  const int c = threadIdx.x;
  const uint8_t* pr = sr + c + (kHaloX - kR);
  const uint8_t* pd = sd + c + (kHaloX - kR);
  float acc[5][kLumaTH], bl[kLumaTH], dr[kDecRows], dd[kDecRows], bs[3][4] = {}, sse = 0.0f;
#pragma unroll
  for (int j = 0; j < kStageRows; ++j) {
    const float x = u8f(pr[j * kStageCols]), y = u8f(pd[j * kStageCols]);
    const float p[5] = {x, y, mul(x, x), mul(y, y), mul(x, y)};
#pragma unroll
    for (int i = 0; i < kLumaTH; ++i) {
      const int k = j - i;
      if (k < 0 || k > 2 * kR) continue;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        acc[q][i] = k == 0 ? mul(t17.t[0], p[q]) : tap<kExact>(acc[q][i], t17.t[k], p[q]);
      }
    }
    if (!kRest) continue;
#pragma unroll
    for (int i = 0; i < kLumaTH; ++i) {  // blur taps: stage rows kR - 2 + i .. + 4
      const int k = j - (kR - 2) - i;
      if (k < 0 || k > 4) continue;
      bl[i] = k == 0 ? mul(t5.t[0], x) : fmaf(t5.t[k], x, bl[i]);
    }
#pragma unroll
    for (int m = 0; m < kDecRows; ++m) {  // 9-tap at even row 2m: stage rows kR - 4 + 2m .. + 8
      const int k = j - (kR - 4) - 2 * m;
      if (k < 0 || k > 8) continue;
      dr[m] = k == 0 ? mul(t9.t[0], x) : fmaf(t9.t[k], x, dr[m]);
      dd[m] = k == 0 ? mul(t9.t[0], y) : fmaf(t9.t[k], y, dd[m]);
    }
    if (j >= kR && j < kR + 12) {  // block rows 0-2: frame rows y0 .. y0 + 11, integers exact in f32
      const int br = (j - kR) / 4;
      bs[br][0] += x;
      bs[br][1] += y;
      bs[br][2] = fmaf(x, x, fmaf(y, y, bs[br][2]));
      bs[br][3] = fmaf(x, y, bs[br][3]);
    }
    if (j >= kR && j < kR + kLumaTH && j - kR < rows_valid) {
      const float d = x - y;
      sse = fmaf(d, d, sse);
    }
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int i = 0; i < kLumaTH; ++i) s.mom[q][i][pc(c)] = acc[q][i];
  }
  if (!kRest) return;
#pragma unroll
  for (int i = 0; i < kLumaTH; ++i) s.blur[i][pc(c)] = bl[i];
#pragma unroll
  for (int m = 0; m < kDecRows; ++m) {
    s.dec[0][m][pc(c)] = dr[m];
    s.dec[1][m][pc(c)] = dd[m];
  }
  // Block sums: the four columns of a 4x4 block are four neighbouring lanes.
#pragma unroll
  for (int br = 0; br < 3; ++br) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bs[br][q] += __shfl_xor_sync(0xffffffffu, bs[br][q], 1);
      bs[br][q] += __shfl_xor_sync(0xffffffffu, bs[br][q], 2);
    }
    if ((c & 3) == 0 && c >= kR && c < kR + 4 * kBlk) {
      s.blk[br][(c - kR) / 4] = make_float4(bs[br][0], bs[br][1], bs[br][2], bs[br][3]);
    }
  }
  if (sse_col) sse_acc += sse;
}

// The FILTER_5 blur of ref alone on this thread's column (the frame before
// a run).
__device__ __forceinline__ void vert_blur(const uint8_t* sr, LumaSmem& s, const Taps& t5) {
  const int c = threadIdx.x;
  const uint8_t* pr = sr + c + (kHaloX - kR);
  float bl[kLumaTH];
#pragma unroll
  for (int j = kR - 2; j < kR + kLumaTH + 2; ++j) {
    const float x = u8f(pr[j * kStageCols]);
#pragma unroll
    for (int i = 0; i < kLumaTH; ++i) {
      const int k = j - (kR - 2) - i;
      if (k < 0 || k > 4) continue;
      bl[i] = k == 0 ? mul(t5.t[0], x) : fmaf(t5.t[k], x, bl[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kLumaTH; ++i) s.blur[i][pc(c)] = bl[i];
}

// Horizontal 17-tap pass and the VIF statistics for this thread's run
// (row warp, columns 8 * lane .. + 7 of the tile): adds its num and den
// sums over the valid pixels; flat |= a flat ref window among them.
template <bool kExact>
__device__ __forceinline__ void horiz_vif(const float (*mom)[kLumaTH][kPitch], const Taps& t17,
                                          float egl, int has_egl, int n_valid, double& num_acc,
                                          double& den_acc, bool& flat) {
  const int i = threadIdx.x >> 5, r = threadIdx.x & 31;
  if (r >= kRuns || n_valid <= 0) return;
  float m[5][kRun];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    float v[kRun + 2 * kR];
    load_row<(kRun + 2 * kR) / 4>(mom[q][i], kRun * r, v);
#pragma unroll
    for (int k = 0; k < kRun; ++k) m[q][k] = mul(t17.t[0], v[k]);
#pragma unroll
    for (int t = 1; t <= 2 * kR; ++t) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) m[q][k] = tap<kExact>(m[q][k], t17.t[t], v[k + t]);
    }
  }
  float num_run = 0.0f, den_run = 0.0f;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (k >= n_valid) break;
    float num, den;
    flat |= vif_pixel<kExact>(m[0][k], m[1][k], m[2][k], m[3][k], m[4][k], egl, has_egl, num, den);
    num_run += num;
    den_run += den;
  }
  num_acc += num_run;
  den_acc += den_run;
}

// Horizontal FILTER_5 for this thread's run into cur; unless `first`, the
// SAD of the valid pixels against prv. cur becomes the next frame's prv.
__device__ __forceinline__ void horiz_blur(const float (*blur)[kPitch], const Taps& t5, int n_valid,
                                           float* prv, bool first, double& sad_acc) {
  const int i = threadIdx.x >> 5, r = threadIdx.x & 31;
  if (r >= kRuns) return;
  float v[16];
  load_row<4>(blur[i], kRun * r + 4, v);  // columns 8r + 4 .. 8r + 19: taps at 8r + k + 6 + t
  float cur[kRun], sad = 0.0f;
#pragma unroll
  for (int k = 0; k < kRun; ++k) cur[k] = mul(t5.t[0], v[k + 2]);
#pragma unroll
  for (int t = 1; t < 5; ++t) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) cur[k] = fmaf(t5.t[t], v[k + 2 + t], cur[k]);
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (!first && k < n_valid) sad += fabsf(cur[k] - prv[k]);
    prv[k] = cur[k];
  }
  sad_acc += sad;
}

// Horizontal 9-tap at the even columns: warp w filters dec row w / 2 of
// ref (w even) or dis (w odd); lane r writes dec columns ox0 + 4r .. + 3.
__device__ __forceinline__ void horiz_dec(const float (*dec)[kDecRows][kPitch], const Taps& t9,
                                          float* out_ref, float* out_dis, int h2, int w2, int oy0,
                                          int ox0) {
  const int w = threadIdx.x >> 5, r = threadIdx.x & 31;
  const int m = w >> 1, img = w & 1;
  if (r >= kRuns || oy0 + m >= h2) return;
  float v[16];
  load_row<4>(dec[img][m], kRun * r + 4, v);  // taps of output k at 8r + 2k + 4 + t
  float* out = (img ? out_dis : out_ref) + static_cast<size_t>(oy0 + m) * w2;
  float acc[kRun / 2];
#pragma unroll
  for (int k = 0; k < kRun / 2; ++k) acc[k] = mul(t9.t[0], v[2 * k]);
#pragma unroll
  for (int t = 1; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < kRun / 2; ++k) acc[k] = fmaf(t9.t[t], v[2 * k + t], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < kRun / 2; ++k) {
    const int ox = ox0 + (kRun / 2) * r + k;
    if (ox < w2) out[ox] = acc[k];
  }
}

// ssim_end1 of the tile's windows: thread t < 2 kWin takes window row
// t / kWin, column t % kWin of the tile (block rows y0/4 + 0..1).
__device__ __forceinline__ float ssim_windows(const float4 (*blk)[kBlk], int h, int w, int y0, int x0) {
  const int t = threadIdx.x;
  if (t >= 2 * kWin) return 0.0f;
  const int wy = t / kWin, wx = t - wy * kWin;
  if (y0 / 4 + wy >= h / 4 - 1 || x0 / 4 + wx >= w / 4 - 1) return 0.0f;
  const float4 a = blk[wy][wx], b = blk[wy][wx + 1], c = blk[wy + 1][wx], d = blk[wy + 1][wx + 1];
  return ssim_end1(a.x + b.x + c.x + d.x, a.y + b.y + c.y + d.y, a.z + b.z + c.z + d.z,
                   a.w + b.w + c.w + d.w);
}

// Fixed-order block totals of the five per-thread sums: warp q (q < 5)
// adds quantity q's values (lane l takes l, l + 32, ... in order, then a
// shuffle tree), and its lane 0 returns the total.
__device__ __forceinline__ double block_sum5(const double (*sums)[kThreads]) {
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double total = 0.0;
  if (q < 5) {
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += sums[q][lane + 32 * k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(0xffffffffu, total, o);
  }
  return total;
}

// Grid: (tiles across, tiles down, runs); run z covers frames [z * run,
// min(b, (z + 1) * run)).
__global__ void __launch_bounds__(kThreads, 2)
quality_luma_kernel(const uint8_t* __restrict__ ry, const uint8_t* __restrict__ dy,
            const float* __restrict__ prev_blur, int b, int h, int w, int run, int aligned,
            Taps t17, Taps t9, Taps t5, float egl, int has_egl, double* __restrict__ part,
            int n_tiles, float* __restrict__ dec_ref, float* __restrict__ dec_dis,
            float* __restrict__ blur_carry) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LumaSmem& s = *reinterpret_cast<LumaSmem*>(smem_raw);

  const int x0 = blockIdx.x * kLumaTW, y0 = blockIdx.y * kLumaTH;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int b0 = blockIdx.z * run, b1 = min(b, b0 + run);
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const size_t plane = static_cast<size_t>(h) * w;
  const int c = threadIdx.x, row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_valid = min(kLumaTH, h - y0);
  const bool row_valid = row < rows_valid;
  const int run_valid = row_valid ? min(kRun, w - x0 - kRun * lane) : 0;  // pixels of my run
  const bool sse_col = c >= kR && c < kR + kLumaTW && x0 - kR + c < w;

  // The blur of the frame before the run: prev_blur, or computed below.
  float prv[kRun];
  const bool prv_from_carry = b0 == 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    prv[k] = prv_from_carry && lane < kRuns && k < run_valid
                 ? prev_blur[static_cast<size_t>(y0 + row) * w + x0 + kRun * lane + k] : 0.0f;
  }

  // The stage (common.cuh stage_tile): frame rows y0 - 8 .. y0 + 15 and
  // columns x0 - 16 .. x0 + 255, reflected at the frame's borders; every
  // index the stencils of valid outputs read lies within 8 of the frame
  // (h, w >= 9).
  const bool mirror = aligned && stage_at_border<kStageRows, kStageCols>(h, w, y0 - kR, x0 - kHaloX);
  // Frame f + 1 is staged while frame f computes. A tile at a border mirrors
  // a frame's missing bytes once its copies have landed, then waits once
  // more; other tiles need only the barrier that ends the frame before.
  const int first = b0 > 0 ? b0 - 1 : b0;
  stage_tile<uint8_t, kStageRows, kStageCols>(s.stage[0][0], s.stage[0][1], ry + first * plane,
                                              dy + first * plane, h, w, y0 - kR, x0 - kHaloX, aligned);
  cp_async_wait<0>();
  __syncthreads();
  if (mirror) {
    stage_mirror<uint8_t, kStageRows, kStageCols>(s.stage[0][0], s.stage[0][1], h, w, y0 - kR, x0 - kHaloX);
    __syncthreads();
  }
  for (int f = first, k = 0; f < b1; ++f, ++k) {
    uint8_t* sr = s.stage[k & 1][0];
    uint8_t* sd = s.stage[k & 1][1];
    uint8_t* nr = s.stage[(k + 1) & 1][0];
    uint8_t* nd = s.stage[(k + 1) & 1][1];
    if (f + 1 < b1) {
      stage_tile<uint8_t, kStageRows, kStageCols>(nr, nd, ry + (f + 1) * plane, dy + (f + 1) * plane, h, w,
                                                  y0 - kR, x0 - kHaloX, aligned);
    }
    const bool pre = f < b0;  // the frame before the run: its blur only
    double v[5] = {0.0, 0.0, 0.0, 0.0, 0.0};  // sse, ssim, sad, num, den
    if (pre) {
      vert_blur(sr, s, t5);
    } else {
      vert_pass<false, true>(sr, sd, s, t17, t9, t5, sse_col, rows_valid, v[0]);
    }
    __syncthreads();
    horiz_blur(s.blur, t5, run_valid, prv, pre, v[2]);
    if (!pre) {
      if (f == b - 1 && lane < kRuns) {
        for (int q = 0; q < run_valid; ++q) {
          blur_carry[static_cast<size_t>(y0 + row) * w + x0 + kRun * lane + q] = prv[q];
        }
      }
      const size_t dec_frame = static_cast<size_t>(f) * h2 * w2;
      horiz_dec(s.dec, t9, dec_ref + dec_frame, dec_dis + dec_frame, h2, w2, y0 / 2, x0 / 2);
      v[1] = ssim_windows(s.blk, h, w, y0, x0);
      bool flat = false;
      horiz_vif<false>(s.mom, t17, egl, has_egl, run_valid, v[3], v[4], flat);
#pragma unroll
      for (int q = 0; q < 5; ++q) s.sums[q][threadIdx.x] = v[q];
      if (__syncthreads_or(flat)) {
        // Flat ref windows: the VIF moments again, in the plain version's order.
        vert_pass<true, false>(sr, sd, s, t17, t9, t5, sse_col, rows_valid, v[0]);
        __syncthreads();
        double num = 0.0, den = 0.0;
        horiz_vif<true>(s.mom, t17, egl, has_egl, run_valid, num, den, flat);
        s.sums[3][threadIdx.x] = num;
        s.sums[4][threadIdx.x] = den;
        __syncthreads();
      }
      const double total = block_sum5(s.sums);
      if (lane == 0 && row < 5) {
        put_part(part, f, row == 0 ? kSseY : row == 1 ? kSsimY : row == 2 ? kSad : row == 3 ? kVifNum : kVifDen,
                 n_tiles, tile, total);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // frame f is done with the buffers; frame f + 1's copies have landed
    if (mirror && f + 1 < b1) {
      stage_mirror<uint8_t, kStageRows, kStageCols>(nr, nd, h, w, y0 - kR, x0 - kHaloX);
      __syncthreads();
    }
  }
}

struct LumaLaunch {
  int blocks_per_sm = 0, sms = 0;
};

// Blocks of quality_luma_kernel resident per SM and the SM count of the current
// device (the dynamic shared memory limit is raised once per device). All
// zero if a query failed (its error stays for cudaGetLastError); an entry is
// cached only once every query has succeeded.
LumaLaunch luma_launch() {
  static LumaLaunch cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return LumaLaunch{};
  if (cache[dev].blocks_per_sm > 0 && cache[dev].sms > 0) return cache[dev];
  LumaLaunch l;
  if (cudaFuncSetAttribute(quality_luma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(LumaSmem))) != cudaSuccess ||
      cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.blocks_per_sm, quality_luma_kernel, kThreads,
                                                    sizeof(LumaSmem)) != cudaSuccess ||
      l.blocks_per_sm <= 0 || l.sms <= 0) {
    return LumaLaunch{};
  }
  cache[dev] = l;
  return l;
}

// Frames per run: the grid is tiles x ceil(b / run) blocks in waves of
// `resident`; a run costs its frames plus ~0.1 of a frame for the blur of
// the frame before it. Take the run with the least waves x (run + 0.1).
int luma_run(int b, int tiles, int resident) {
  int best = b;
  double best_cost = 0.0;
  for (int run = b; run >= 1; --run) {
    const long long blocks = static_cast<long long>(tiles) * cdiv(b, run);
    const double cost = static_cast<double>((blocks + resident - 1) / resident) * (run + 0.1);
    if (run == b || cost < best_cost) {
      best = run;
      best_cost = cost;
    }
  }
  return best;
}

int quality_tiles(int h, int w, int hc, int wc) {
  const int luma = cdiv(w, kLumaTW) * cdiv(h, kLumaTH);
  const int chroma = cdiv(wc, 4 * kSsimBX) * cdiv(hc, 4 * kSsimBY);
  return luma > chroma ? luma : chroma;
}

}  // namespace

// Doubles of per-tile partial scratch that rtvqa_quality_fused needs.
extern "C" long long rtvqa_quality_scratch(int b, int h, int w, int hc, int wc) {
  return static_cast<long long>(b) * kQ * quality_tiles(h, w, hc, wc);
}

// The luma kernel's launch figures on the current device: out[0] blocks
// per SM (occupancy API), out[1] registers per thread, out[2] dynamic
// shared bytes per block, out[3] local (spill) bytes per thread. Returns a
// cudaError_t.
extern "C" int rtvqa_quality_luma_occupancy(int* out) {
  const LumaLaunch l = luma_launch();
  RTVQA_LAUNCH_CHECK();
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, quality_luma_kernel);
  out[0] = l.blocks_per_sm;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(sizeof(LumaSmem));
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
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
  const LumaLaunch l = luma_launch();
  RTVQA_LAUNCH_CHECK();
  const dim3 tiles(cdiv(w, kLumaTW), cdiv(h, kLumaTH));
  const int resident = l.blocks_per_sm * l.sms;
  const int run = luma_run(b, tiles.x * tiles.y, resident > 0 ? resident : 1);
  const int aligned = stage_aligned(ry, dy, w);
  quality_luma_kernel<<<dim3(tiles.x, tiles.y, cdiv(b, run)), kThreads, sizeof(LumaSmem), stream>>>(
      ry, dy, prev_blur, b, h, w, run, aligned, make_taps(taps17, 17), make_taps(taps9, 9),
      make_taps(taps_blur, 5), egl, has_egl, scratch, n_tiles, dec_ref, dec_dis, blur_carry);
  RTVQA_LAUNCH_CHECK();
  ssim_sse_kernel<<<ssim_grid(2 * b, hc, wc), kThreads, 0, stream>>>(
      ru, du, rv, dv, b, hc, wc, scratch, kSseU, kSsimU, n_tiles);
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<b * kQ, kThreads, 0, stream>>>(scratch, n_tiles, sums);
  RTVQA_LAUNCH_CHECK();
  return 0;
}
