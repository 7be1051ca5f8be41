// Exhaustive SAD block matching -> mean displacement magnitude per pair.
//
// Replaces: rtvqa_tpu/kernels/motion_pallas.py::block_match_motion_pallas
// (kernel body _bm_kernel). The TPU kernel staged a strip of block-rows in
// VMEM, shifted it with static pltpu.roll per displacement (Mosaic has no
// dynamic sublane slicing) and pooled per-block SADs with a 0/1 matmul. On
// Hopper, shared memory takes any offset, so each candidate window is just
// an address.
//
// Bound on the H100: f32 issue. Each pair needs (2r+1)^2 * H * W
// |diff|-adds; at the half-resolution pyramid shape (540 x 960, block 8,
// r 4) that is 81 * 518k ~ 42 M per pair, 5.3 G for 127 pairs, against only
// ~4 MB of device-memory reads per pair. |c - p| + s is two FADDs (the abs
// is an operand modifier), and an FADD takes a whole FMA issue slot, so the
// issue floor is 5.3 G x 2 / 33.5 T per s ~ 0.32 ms (obs/roofline.py counts
// 3 operations per term against the FMA-as-two rate: 0.24 ms).
//
// Design:
//  * bm_tile_kernel<B, R> (block 8 with r 4, the pyramid's search; block
//    16 with r 8, the full search): one CUDA block per (32-block tile of a
//    block-row, pair). The tile's B rows of the current frame and B + 2R
//    rows of the previous frame (plus R columns each side) go to shared
//    memory as 16-byte pieces (cp.async where rows are 16-byte aligned),
//    with prev indices clamped to [0, hb-1] x [0, wb-1]: the frame is
//    cropped to whole blocks FIRST, then edge-replicated, as in
//    ops/motion.py. Warp dy takes candidate row dy, lane j block j: per
//    pixel row it loads its B current floats and the B + 2R previous ones
//    with 16-byte loads of rows padded so that a quarter-warp's loads hit
//    distinct banks, and updates 2R+1 accumulators, one per dx, from them:
//    (2R+1) * B * 2 FADDs per (3B + 2R) / 4 shared loads. Each candidate's
//    SAD is one thread's serial f32 sum, py outer, px inner, from 0.0f: the
//    same sums, so the same index field, as bm_search_kernel. Each lane
//    keeps its first minimum over dx with a strict '<'; the 2R+1 row
//    results of a block then meet in shared memory, taken in dy order with
//    a strict '<', which gives the global first (raster-order) minimum.
//  * bm_search_kernel: any other block and radius. The same staging of one
//    tile; each warp takes one block at a time, its lanes the candidates k
//    = lane, lane + 32, ... in raster order (dy-major), each keeping its
//    first minimum with a strict '<'; a warp shuffle argmin that breaks
//    ties toward the smaller k then yields the global first minimum.
//  * Both write the block's best index to an int32 scratch (b, nby, nbx).
//    bm_mean_kernel: one CUDA block per pair counts the best indices in
//    shared memory (integer atomics: exact, order-free) and one thread sums
//    count * |(dy, dx)| over the candidates in float64, in index order, with
//    no FMA contraction — the same histogram form as the plain version, so
//    equal index fields give equal means. No float atomics: deterministic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kTileWidth = 256;            // bm_search_kernel: target tile width in pixels
constexpr int kMaxSmem = 227 * 1024;       // per-block opt-in limit on sm_90
constexpr int kTileBlocks = 32;            // bm_tile_kernel: blocks per tile, one per lane

// Floats of a stage row of `cols` columns padded as common.cuh's pc() pads
// them (4 floats per 32 columns), rounded up to whole 16-byte pieces.
constexpr int padded_pitch(int cols) { return (cols + ((cols - 1) >> 5) * 4 + 3) / 4 * 4; }

// bm_tile_kernel's tile: kTileBlocks blocks of B x B pixels, candidates
// within +-R, one warp per candidate row.
template <int B, int R>
struct TileShape {
  static_assert(B % 4 == 0 && R % 4 == 0, "stage rows are whole 16-byte pieces");
  static constexpr int kSide = 2 * R + 1;
  static constexpr int kThreads = 32 * kSide;
  static constexpr int kCurCols = kTileBlocks * B;
  static constexpr int kPrevRows = B + 2 * R;
  static constexpr int kCurPitch = padded_pitch(kCurCols);
  static constexpr int kPrevPitch = padded_pitch(kCurCols + 2 * R);
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float)) * (B * kCurPitch + kPrevRows * kPrevPitch);
};

// Four floats of a frame row into a stage: one cp.async if `copy`, else
// four loads at columns gx .. gx + 3 clamped to [0, wb - 1].
__device__ __forceinline__ void stage_piece(float* dst, const float* row, int gx, int wb, bool copy) {
  if (copy) {
    cp_async16(dst, row + gx);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = row[clamp_idx(gx + e, wb)];
}

template <int B, int R>
__global__ void __launch_bounds__(TileShape<B, R>::kThreads)
bm_tile_kernel(const float* __restrict__ prev, const float* __restrict__ curr,
               int32_t* __restrict__ best, int h, int w, int nby, int nbx, int aligned) {
  using S = TileShape<B, R>;
  extern __shared__ __align__(16) float stage[];
  float* cs = stage;                     // [B][kCurPitch]: rows y0 .., columns x0 ..
  float* ps = stage + B * S::kCurPitch;  // [B + 2R][kPrevPitch]: rows y0 - R .., columns x0 - R ..
  __shared__ float row_sad[S::kSide][kTileBlocks];
  __shared__ int row_k[S::kSide][kTileBlocks];

  const int bx0 = blockIdx.x * kTileBlocks, by = blockIdx.y;
  const int64_t f = blockIdx.z;
  const int hb = nby * B, wb = nbx * B;
  const int nbt = min(kTileBlocks, nbx - bx0);
  const int x0 = bx0 * B, y0 = by * B;
  const float* cf = curr + f * h * w;
  const float* pf = prev + f * h * w;

  // The tile's current rows lie inside the cropped frame; the previous
  // rows and columns are clamped to it. Pieces that reach past it are
  // gathered element by element.
  const int cur_pieces = nbt * B / 4, prev_pieces = (nbt * B + 2 * R) / 4;
  for (int i = threadIdx.x; i < B * cur_pieces; i += S::kThreads) {
    const int r = i / cur_pieces, k = i - r * cur_pieces;
    stage_piece(cs + r * S::kCurPitch + pc(4 * k), cf + static_cast<int64_t>(y0 + r) * w, x0 + 4 * k, wb,
                aligned);
  }
  for (int i = threadIdx.x; i < S::kPrevRows * prev_pieces; i += S::kThreads) {
    const int r = i / prev_pieces, k = i - r * prev_pieces;
    const int gy = clamp_idx(y0 - R + r, hb), gx = x0 - R + 4 * k;
    stage_piece(ps + r * S::kPrevPitch + pc(4 * k), pf + static_cast<int64_t>(gy) * w, gx, wb,
                aligned && gx >= 0 && gx + 4 <= wb);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int dy = threadIdx.x >> 5, j = threadIdx.x & 31;
  float best_sad = INFINITY;
  int best_k = 0;
  if (j < nbt) {
    float acc[S::kSide];
#pragma unroll
    for (int dx = 0; dx < S::kSide; ++dx) acc[dx] = 0.0f;
#pragma unroll 2
    for (int py = 0; py < B; ++py) {
      const float* crow = cs + py * S::kCurPitch;
      const float* prow = ps + (py + dy) * S::kPrevPitch;
      float c[B], p[B + 2 * R];
#pragma unroll
      for (int s = 0; s < B / 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(crow + pc(B * j + 4 * s));
        c[4 * s] = v.x;
        c[4 * s + 1] = v.y;
        c[4 * s + 2] = v.z;
        c[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < (B + 2 * R) / 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(prow + pc(B * j + 4 * s));
        p[4 * s] = v.x;
        p[4 * s + 1] = v.y;
        p[4 * s + 2] = v.z;
        p[4 * s + 3] = v.w;
      }
      // Candidate dx's SAD takes this row's pixels in px order.
#pragma unroll
      for (int px = 0; px < B; ++px) {
#pragma unroll
        for (int dx = 0; dx < S::kSide; ++dx) acc[dx] += fabsf(c[px] - p[px + dx]);
      }
    }
#pragma unroll
    for (int dx = 0; dx < S::kSide; ++dx) {
      if (acc[dx] < best_sad) {  // strict: first minimum of the row
        best_sad = acc[dx];
        best_k = dy * S::kSide + dx;
      }
    }
  }
  row_sad[dy][j] = best_sad;
  row_k[dy][j] = best_k;
  __syncthreads();
  if (dy == 0 && j < nbt) {
    best_sad = INFINITY;
    best_k = 0;
    for (int d = 0; d < S::kSide; ++d) {
      if (row_sad[d][j] < best_sad) {  // rows in order, strict: the first minimum
        best_sad = row_sad[d][j];
        best_k = row_k[d][j];
      }
    }
    best[(f * nby + by) * nbx + bx0 + j] = best_k;
  }
}

template <int B, int R>
cudaError_t tile_launch(const float* prev, const float* curr, int32_t* best, int b, int h, int w,
                        int nby, int nbx, cudaStream_t s) {
  using S = TileShape<B, R>;
  const cudaError_t err = smem_opt_in<bm_tile_kernel<B, R>>(S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int aligned = w % 4 == 0 && ((reinterpret_cast<uintptr_t>(prev) | reinterpret_cast<uintptr_t>(curr)) & 15) == 0;
  bm_tile_kernel<B, R><<<dim3(cdiv(nbx, kTileBlocks), nby, b), S::kThreads, S::kSmemBytes, s>>>(
      prev, curr, best, h, w, nby, nbx, aligned);
  return cudaGetLastError();
}

__global__ void bm_search_kernel(const float* __restrict__ prev,
                                 const float* __restrict__ curr,
                                 int32_t* __restrict__ best, int h, int w,
                                 int block, int radius, int nby, int nbx,
                                 int tile_blocks) {
  extern __shared__ float smem[];
  const int tile_w = tile_blocks * block;
  const int pw = tile_w + 2 * radius;
  const int ph = block + 2 * radius;
  float* cs = smem;                        // [block][tile_w]
  float* ps = smem + block * tile_w;       // [ph][pw]

  const int bx0 = blockIdx.x * tile_blocks;
  const int by = blockIdx.y;
  const int64_t f = blockIdx.z;
  const int hb = nby * block;
  const int wb = nbx * block;
  const int nbt = min(tile_blocks, nbx - bx0);
  const int x0 = bx0 * block;
  const int y0 = by * block;
  const float* cf = curr + f * h * w;
  const float* pf = prev + f * h * w;

  const int cw = nbt * block;
  for (int i = threadIdx.x; i < block * cw; i += kThreads) {
    const int rr = i / cw, cc = i - rr * cw;
    cs[rr * tile_w + cc] = cf[static_cast<int64_t>(y0 + rr) * w + x0 + cc];
  }
  const int pcw = cw + 2 * radius;
  for (int i = threadIdx.x; i < ph * pcw; i += kThreads) {
    const int rr = i / pcw, cc = i - rr * pcw;
    const int gy = min(max(y0 - radius + rr, 0), hb - 1);
    const int gx = min(max(x0 - radius + cc, 0), wb - 1);
    ps[rr * pw + cc] = pf[static_cast<int64_t>(gy) * w + gx];
  }
  __syncthreads();

  const int side = 2 * radius + 1;
  const int ncand = side * side;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = warp; b < nbt; b += kWarps) {
    const float* cblk = cs + b * block;
    float best_sad = INFINITY;
    int best_k = 0;
    for (int k = lane; k < ncand; k += 32) {
      const int dy = k / side, dx = k - dy * side;
      const float* pblk = ps + dy * pw + b * block + dx;
      float sad = 0.0f;
      for (int py = 0; py < block; ++py) {
        const float* crow = cblk + py * tile_w;
        const float* prow = pblk + py * pw;
#pragma unroll 8
        for (int px = 0; px < block; ++px) sad += fabsf(crow[px] - prow[px]);
      }
      if (sad < best_sad) {  // strict: first (raster-order) minimum per lane
        best_sad = sad;
        best_k = k;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o_sad = __shfl_down_sync(0xffffffffu, best_sad, off);
      const int o_k = __shfl_down_sync(0xffffffffu, best_k, off);
      if (o_sad < best_sad || (o_sad == best_sad && o_k < best_k)) {
        best_sad = o_sad;
        best_k = o_k;
      }
    }
    if (lane == 0) best[(f * nby + by) * nbx + bx0 + b] = best_k;
  }
}

__global__ void bm_mean_kernel(const int32_t* __restrict__ best,
                               float* __restrict__ out, int nblocks,
                               int radius) {
  extern __shared__ int counts[];
  const int side = 2 * radius + 1;
  const int ncand = side * side;
  const int64_t f = blockIdx.x;
  for (int i = threadIdx.x; i < ncand; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const int32_t* bf = best + f * nblocks;
  for (int i = threadIdx.x; i < nblocks; i += blockDim.x) atomicAdd(&counts[bf[i]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < ncand; ++k) {
      const int dy = k / side - radius, dx = k % side - radius;
      const double mag = sqrt(static_cast<double>(dy * dy + dx * dx));
      total = __dadd_rn(total, __dmul_rn(static_cast<double>(counts[k]), mag));
    }
    out[f] = static_cast<float>(__ddiv_rn(total, static_cast<double>(nblocks)));
  }
}

cudaError_t search_launch(const float* prev, const float* curr, int32_t* best, int b, int h, int w,
                          int block, int radius, int nby, int nbx, cudaStream_t s) {
  const int tile_blocks = min(max(kTileWidth / block, 1), nbx);
  const int tile_w = tile_blocks * block;
  const size_t smem = sizeof(float) * (static_cast<size_t>(block) * tile_w +
                                       static_cast<size_t>(block + 2 * radius) * (tile_w + 2 * radius));
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      bm_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nbx + tile_blocks - 1) / tile_blocks, nby, b);
  bm_search_kernel<<<grid, kThreads, smem, s>>>(prev, curr, best, h, w, block, radius, nby, nbx, tile_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* rtvqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// prev/curr: (b, h, w) float32 contiguous; best: (b, h/block, w/block)
// int32 scratch; out: (b,) float32. Frames are cropped to whole blocks.
// Returns a cudaError_t code (0 = both kernels launched).
extern "C" int rtvqa_block_match_motion(const float* prev, const float* curr,
                                        int32_t* best, float* out, int b,
                                        int h, int w, int block, int radius,
                                        void* stream) {
  const int nby = h / block, nbx = w / block;
  if (b == 0) return 0;
  if (block <= 0 || radius < 0 || nby == 0 || nbx == 0 || nby > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (block == 8 && radius == 4) {
    err = tile_launch<8, 4>(prev, curr, best, b, h, w, nby, nbx, s);
  } else if (block == 16 && radius == 8) {
    err = tile_launch<16, 8>(prev, curr, best, b, h, w, nby, nbx, s);
  } else {
    err = search_launch(prev, curr, best, b, h, w, block, radius, nby, nbx, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ncand = (2 * radius + 1) * (2 * radius + 1);
  bm_mean_kernel<<<b, kThreads, sizeof(int) * ncand, s>>>(best, out, nby * nbx, radius);
  return static_cast<int>(cudaGetLastError());
}
