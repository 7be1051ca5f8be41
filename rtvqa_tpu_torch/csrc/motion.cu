// Exhaustive SAD block matching -> mean displacement magnitude per pair.
//
// Replaces: rtvqa_tpu/kernels/motion_pallas.py::block_match_motion_pallas
// (kernel body _bm_kernel). The TPU kernel staged a strip of block-rows in
// VMEM, shifted it with static pltpu.roll per displacement (Mosaic has no
// dynamic sublane slicing) and pooled per-block SADs with a 0/1 matmul. On
// Hopper, shared memory takes any offset, so each candidate window is just
// an address.
//
// Bound on the H100: on-chip arithmetic and shared-memory reads. Each pair
// needs (2r+1)^2 * H * W |diff|-adds — at the half-resolution pyramid shape
// (540 x 960, block 8, r 4) that is 81 * 518k ~ 42 M per pair, 5.3 G for
// 127 pairs — against only ~4 MB of device-memory reads per pair. Staging
// the tile once in shared memory keeps device-memory traffic at ~2x one
// read of each frame (the prev halo rows are re-read by the neighbouring
// tile, mostly from L2).
//
// Design (simple first):
//  * bm_search_kernel: one CUDA block per (column tile, block-row, pair).
//    The tile's `block` rows of the current frame and `block + 2r` rows of
//    the previous frame (plus r columns each side) go to dynamic shared
//    memory, with prev indices clamped to [0, hb-1] x [0, wb-1] — the frame
//    is cropped to whole blocks FIRST, then edge-replicated, as in
//    ops/motion.py. Each warp takes one block at a time; its lanes take the
//    candidates k = lane, lane + 32, ... in raster order (dy-major), each
//    keeping its first minimum with a strict '<'; a warp shuffle argmin that
//    breaks ties toward the smaller k then yields the global first minimum.
//    The block's best index goes to an int32 scratch (b, nby, nbx).
//  * bm_mean_kernel: one CUDA block per pair counts the best indices in
//    shared memory (integer atomics: exact, order-free) and one thread sums
//    count * |(dy, dx)| over the candidates in float64, in index order, with
//    no FMA contraction — the same histogram form as the plain version, so
//    equal index fields give equal means. No float atomics: deterministic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWidth = 256;            // target tile width in pixels
constexpr int kMaxSmem = 227 * 1024;       // per-block opt-in limit on sm_90

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
  const int tile_blocks = min(max(kTileWidth / block, 1), nbx);
  const int tile_w = tile_blocks * block;
  const size_t smem = sizeof(float) * (static_cast<size_t>(block) * tile_w +
                                       static_cast<size_t>(block + 2 * radius) * (tile_w + 2 * radius));
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bm_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nbx + tile_blocks - 1) / tile_blocks, nby, b);
  bm_search_kernel<<<grid, kThreads, smem, s>>>(prev, curr, best, h, w, block,
                                                radius, nby, nbx, tile_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ncand = (2 * radius + 1) * (2 * radius + 1);
  bm_mean_kernel<<<b, kThreads, sizeof(int) * ncand, s>>>(best, out, nby * nbx, radius);
  return static_cast<int>(cudaGetLastError());
}
