// The strip-read probes: kernel 8 sums frames over 32-row strips; kernel 9
// measures how fast the card streams the row windows the quality kernels
// stage, per input type, with nothing else to do.
//
// strip_sum_kernel (kernel 8) replaces scripts/probe_int8_dma.py's kernel
// (run, :48-80): the per-frame sum over 32-row strips of u8 or f32 frames.
// The TPU kernel read each strip as a 48-row window at an 8-aligned row;
// the strips' valid rows [32 s, 32 s + min(32, h - 32 s)) partition the
// frame, so the per-frame sum of the strips is the frame's sum, and here
// the frame (one contiguous span) is streamed straight from global memory
// into registers, each byte read once. One launch: a thread block cluster
// of 8 blocks per frame, each block reading one eighth of the span, so
// every block reads the same bytes and 16 frames fill 128 SMs in one wave.
// 16-byte cache-streaming loads, eight in flight per thread, the unaligned
// head and tail of a share byte- or element-wise. u8 sums in integers
// (__dp4a of each 4-byte word against 0x01010101 into a 32-bit per-thread
// count, exact); f32 adds each float4 in f32 (two levels) and the partials
// in float64 per thread. Each block reduces in a fixed order (warp
// shuffles, then the warps in order), and the cluster's rank 0 adds the
// eight block totals in rank order from their shared memory and writes the
// frame's f32 sum: no atomics, so repeat runs are bit-identical.
//
// strip_floor_kernel (kernel 9) replaces scripts/probe_dma_floor.py's
// dma_kernel (floor, :89-131): windows of 56 rows at a 48-row stride, full
// width, n_s = h // 48 per frame, each read once and touched once; the
// output is the sum over frames and windows of the window's first element.
// f32, bf16 and u8 input.
//
// Design of kernel 9: a window is rows [st, st + R) of one contiguous (n,
// h, w) array, so it is one contiguous span of R*w*itemsize bytes. A block
// walks the windows blockIdx.x, blockIdx.x + gridDim.x, ... in 16 KB steps
// through two shared-memory buffers: 16-byte cp.async.cg copies (L1
// bypassed) of step t+1 are in flight while step t is consumed, and the
// walk runs on from one window into the next, as the TPU kernels
// double-buffer their DMAs across grid steps. An unaligned span start (odd
// widths) is copied byte-wise up to the next 16-byte boundary; the buffer
// is shifted so the body copies stay 16-byte aligned on both sides. Every
// byte of every window lands in shared memory.
//
// Bound on the H100: bytes over 3.35 TB/s (obs/roofline.py): kernel 8's
// frames read once, kernel 9's rows that its windows cover, each counted
// once. Kernel 9 sums in float64 per window (exact for u8, bf16 and
// integer-valued f32), reduced in a fixed order (reduce_rows_kernel).

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kStep = 16384;          // bytes staged per step
constexpr int kBuf = kStep + 16;      // + the alignment shift
constexpr int kBlocksPerSm = 4;

struct bf16_raw {
  uint16_t bits;
};

__device__ __forceinline__ float to_f(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_raw v) {
  return __uint_as_float(static_cast<uint32_t>(v.bits) << 16);
}

// Start copying bytes [0, n) of src (n <= kStep) into buf + (src & 15).
__device__ __forceinline__ void stage_async(uint8_t* buf, const uint8_t* src, int n) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  uint8_t* dst = buf + shift;
  const int head = min(n, (16 - shift) & 15);
  const int body_end = head + ((n - head) & ~15);
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  for (int i = head + 16 * threadIdx.x; i < body_end; i += 16 * kThreads) cp_async16(dst + i, src + i);
  for (int i = body_end + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  cp_async_commit();
}

__device__ __forceinline__ int step_bytes(long long win_bytes, long long off) {
  return static_cast<int>(win_bytes - off < kStep ? win_bytes - off : kStep);
}

// Walks this block's windows in kStep steps, double-buffered. start(k) is
// window k's first byte; consume(k, step, data, n) sees step `step` of
// window k: n bytes at `data` (aligned like the global bytes mod 16), with
// every thread of the block calling it and the data complete.
template <typename Start, typename Consume>
__device__ __forceinline__ void walk_windows(const uint8_t* base, int n_win, long long win_bytes,
                                             Start start, Consume consume) {
  __shared__ __align__(16) uint8_t buf[2][kBuf];
  const int per_win = static_cast<int>((win_bytes + kStep - 1) / kStep);
  const int mine = n_win > static_cast<int>(blockIdx.x)
                       ? (n_win - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const long long steps = static_cast<long long>(mine) * per_win;
  auto issue = [&](long long t) {
    const int k = blockIdx.x + static_cast<int>(t / per_win) * gridDim.x;
    const long long off = (t % per_win) * static_cast<long long>(kStep);
    stage_async(buf[t & 1], base + start(k) + off, step_bytes(win_bytes, off));
  };
  if (steps > 0) issue(0);
  for (long long t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k = blockIdx.x + static_cast<int>(t / per_win) * gridDim.x;
    const int step = static_cast<int>(t % per_win);
    const long long off = step * static_cast<long long>(kStep);
    const uint8_t* src = base + start(k) + off;
    consume(k, step, buf[t & 1] + (reinterpret_cast<uintptr_t>(src) & 15),
            step_bytes(win_bytes, off));
    __syncthreads();
  }
}

constexpr int kSumThreads = 1024;  // kernel 8's block
constexpr int kSumCluster = 8;     // kernel 8's blocks per frame: one cluster
constexpr int kInFlight = 8;       // 16-byte loads in flight per thread

// Adds this thread's share of n bytes at p (any alignment) to acc: the
// bytes up to the first 16-byte boundary and after the last one singly,
// the rest as uint4, each 4-byte word's four bytes summed by __dp4a.
__device__ __forceinline__ void sum_span(const uint8_t* p, long long n, unsigned& acc) {
  const int head = static_cast<int>(min(n, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15)));
  if (static_cast<int>(threadIdx.x) < head) acc += p[threadIdx.x];
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long n16 = (n - head) / 16;
  long long i = threadIdx.x;
  for (; i + (kInFlight - 1) * kSumThreads < n16; i += kInFlight * kSumThreads) {
    uint4 a[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) a[u] = __ldcs(v + i + u * kSumThreads);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      acc = __dp4a(a[u].x, 0x01010101u, acc);
      acc = __dp4a(a[u].y, 0x01010101u, acc);
      acc = __dp4a(a[u].z, 0x01010101u, acc);
      acc = __dp4a(a[u].w, 0x01010101u, acc);
    }
  }
  for (; i < n16; i += kSumThreads) {
    const uint4 a = __ldcs(v + i);
    acc = __dp4a(a.x, 0x01010101u, acc);
    acc = __dp4a(a.y, 0x01010101u, acc);
    acc = __dp4a(a.z, 0x01010101u, acc);
    acc = __dp4a(a.w, 0x01010101u, acc);
  }
  for (long long j = head + 16 * n16 + threadIdx.x; j < n; j += kSumThreads) acc += p[j];
}

// The same for n floats at p (4-byte aligned): each float4 summed in f32 as
// (x + y) + (z + w), those partials (and the unaligned elements) added in
// float64.
__device__ __forceinline__ void sum_span(const float* p, long long n, double& acc) {
  const int head = static_cast<int>(min(n, static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4)));
  if (static_cast<int>(threadIdx.x) < head) acc += p[threadIdx.x];
  const float4* v = reinterpret_cast<const float4*>(p + head);
  const long long n4 = (n - head) / 4;
  long long i = threadIdx.x;
  for (; i + (kInFlight - 1) * kSumThreads < n4; i += kInFlight * kSumThreads) {
    float4 a[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) a[u] = __ldcs(v + i + u * kSumThreads);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc += (a[u].x + a[u].y) + (a[u].z + a[u].w);
  }
  for (; i < n4; i += kSumThreads) {
    const float4 a = __ldcs(v + i);
    acc += (a.x + a.y) + (a.z + a.w);
  }
  for (long long j = head + 4 * n4 + threadIdx.x; j < n; j += kSumThreads) acc += p[j];
}

// Kernel 8: the cluster of blocks kSumCluster f .. kSumCluster f + 7 sums
// frame f (`frame` elements); its block of rank r reads share r of them.
// Each block reduces its threads' sums in a fixed order, then rank 0 adds
// the blocks' totals in rank order from their shared memory.
template <typename T, typename Acc>
__global__ void __cluster_dims__(kSumCluster, 1, 1) __launch_bounds__(kSumThreads)
strip_sum_kernel(const T* __restrict__ x, long long frame, float* __restrict__ sums) {
  namespace cg = cooperative_groups;
  __shared__ double red[kSumThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long f = blockIdx.x / kSumCluster;
  const long long lo = frame * rank / kSumCluster, hi = frame * (rank + 1) / kSumCluster;
  Acc acc = 0;
  sum_span(x + f * frame + lo, hi - lo, acc);
  double v = static_cast<double>(acc);  // exact for the u8 count
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int j = 0; j < kSumThreads / 32; ++j) total += red[j];
    red[0] = total;
  }
  cluster.sync();  // every block's total is in its red[0]
  if (rank == 0 && threadIdx.x == 0) {
    double total = 0.0;
    for (int j = 0; j < kSumCluster; ++j) total += *cluster.map_shared_rank(&red[0], j);
    sums[f] = static_cast<float>(total);
  }
  cluster.sync();  // the blocks' shared memory lives until rank 0 has read it
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
strip_floor_kernel(const T* __restrict__ x, int h, int w, int n_s, int n_win, double* __restrict__ part) {
  constexpr int kStride = 48, kRows = 56;
  const long long frame_bytes = static_cast<long long>(h) * w * sizeof(T);
  auto start = [&](int k) {
    return (k / n_s) * frame_bytes + static_cast<long long>(kStride) * (k % n_s) * w * sizeof(T);
  };
  walk_windows(reinterpret_cast<const uint8_t*>(x), n_win, static_cast<long long>(kRows) * w * sizeof(T),
               start, [&](int k, int step, const uint8_t* data, int) {
    // The touch: the window's first element, read from shared memory.
    if (step == 0 && threadIdx.x == 0) part[k] = to_f(*reinterpret_cast<const T*>(data));
  });
}

// Blocks for n_win equal windows: at most kBlocksPerSm per SM, and every
// block walks the same number of windows (or one fewer), so no block walks
// two where the others walk one.
int walk_grid(int n_win) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_block = cdiv(n_win, kBlocksPerSm * sms);
  return std::max(1, cdiv(n_win, per_block));
}

}  // namespace

// Kernel 8. x: (n, h, w) contiguous, uint8 when itemsize 1 else f32.
// sums: (n,) f32 per-frame sums. One launch, kSumCluster blocks per frame.
extern "C" int rtvqa_strip_sum(const void* x, int itemsize, int n, int h, int w, float* sums,
                               void* stream_ptr) {
  if (n == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long frame = static_cast<long long>(h) * w;
  const dim3 grid(kSumCluster * n);
  if (itemsize == 1) {
    strip_sum_kernel<uint8_t, unsigned><<<grid, kSumThreads, 0, stream>>>(static_cast<const uint8_t*>(x), frame, sums);
  } else {
    strip_sum_kernel<float, double><<<grid, kSumThreads, 0, stream>>>(static_cast<const float*>(x), frame, sums);
  }
  RTVQA_LAUNCH_CHECK();
  return 0;
}

// Kernel 9. x: (n, h, w) contiguous; dtype 0 = f32, 1 = bf16, 2 = uint8;
// (h // 48 - 1) * 48 + 56 <= h (checked by the caller). part: n * (h // 48)
// doubles; out: one f64.
extern "C" int rtvqa_strip_floor(const void* x, int dtype, int n, int h, int w, double* part,
                                 double* out, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_s = h / 48, n_win = n * n_s;
  if (n_win == 0) return 0;
  const dim3 grid(walk_grid(n_win));
  if (dtype == 0) {
    strip_floor_kernel<float><<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x), h, w, n_s, n_win, part);
  } else if (dtype == 1) {
    strip_floor_kernel<bf16_raw><<<grid, kThreads, 0, stream>>>(static_cast<const bf16_raw*>(x), h, w, n_s, n_win, part);
  } else {
    strip_floor_kernel<uint8_t><<<grid, kThreads, 0, stream>>>(static_cast<const uint8_t*>(x), h, w, n_s, n_win, part);
  }
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<1, kThreads, 0, stream>>>(part, n_win, out);
  RTVQA_LAUNCH_CHECK();
  return 0;
}
