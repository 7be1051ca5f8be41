// The strip-read floor probes: how fast the card streams the row windows
// the quality kernels stage, per input type, with nothing else to do.
//
// strip_sum_kernel (kernel 8) replaces scripts/probe_int8_dma.py's kernel
// (run, :48-80): 32-row strips, each read as a 48-row window starting at
// the 8-aligned row st = clip((row0 - 8) // 8, 0, (h - 48) // 8) * 8
// (vif_pallas.py::_dma_row_start), its valid rows [row0, row0 + min(32,
// h - row0)) summed; the per-frame sum of the strips. One kernel for u8
// and f32 input.
//
// strip_floor_kernel (kernel 9) replaces scripts/probe_dma_floor.py's
// dma_kernel (floor, :89-131): windows of 56 rows at a 48-row stride, full
// width, n_s = h // 48 per frame, each read once and touched once; the
// output is the sum over frames and windows of the window's first element.
// f32, bf16 and u8 input.
//
// Design: a window is rows [st, st + R) of one contiguous (n, h, w) array,
// so it is one contiguous span of R*w*itemsize bytes. A block walks the
// windows blockIdx.x, blockIdx.x + gridDim.x, ... in 16 KB steps through
// two shared-memory buffers: 16-byte cp.async.cg copies (L1 bypassed) of
// step t+1 are in flight while step t is consumed, and the walk runs on
// from one window into the next, as the TPU kernels double-buffer their
// DMAs across grid steps. An unaligned span start (odd widths) is copied
// byte-wise up to the next 16-byte boundary; the buffer is shifted so the
// body copies stay 16-byte aligned on both sides. Every byte of every
// window lands in shared memory.
//
// Bound on the H100: bytes over 3.35 TB/s (obs/roofline.py): kernel 8's
// frames read once (its windows are 1.5x that), kernel 9's rows that its
// windows cover, each counted once. Sums are
// float64 per window (exact for u8, bf16 and integer-valued f32), reduced
// in a fixed order (reduce_rows_kernel): repeat runs are bit-identical.

#include <algorithm>
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
strip_sum_kernel(const T* __restrict__ x, int h, int w, int n_strips, int n_win,
                 double* __restrict__ part) {
  __shared__ double red[kThreads];
  constexpr int kStrip = 32, kRows = 48;
  const long long frame_bytes = static_cast<long long>(h) * w * sizeof(T);
  const int st_cap8 = (h - kRows) / 8;
  auto window_row = [&](int s) { return min(max(4 * s - 1, 0), st_cap8) * 8; };
  auto start = [&](int k) {
    return (k / n_strips) * frame_bytes + static_cast<long long>(window_row(k % n_strips)) * w * sizeof(T);
  };
  const int per_win = static_cast<int>((static_cast<long long>(kRows) * w * sizeof(T) + kStep - 1) / kStep);
  double acc = 0.0;
  walk_windows(reinterpret_cast<const uint8_t*>(x), n_win, static_cast<long long>(kRows) * w * sizeof(T),
               start, [&](int k, int step, const uint8_t* data, int n) {
    const int s = k % n_strips, row0 = kStrip * s;
    // Valid elements of the window: rows [row0, row0 + nv) of it.
    const long long lo = static_cast<long long>(row0 - window_row(s)) * w;
    const long long hi = lo + static_cast<long long>(min(kStrip, h - row0)) * w;
    const long long e0 = step * static_cast<long long>(kStep / sizeof(T));
    const T* v = reinterpret_cast<const T*>(data);
    const int first = static_cast<int>(max(lo - e0, 0LL));
    const int last = static_cast<int>(min(hi - e0, static_cast<long long>(n / sizeof(T))));
    for (int i = first + threadIdx.x; i < last; i += kThreads) acc += to_f(v[i]);
    if (step == per_win - 1) {
      const double total = block_sum(acc, red);
      if (threadIdx.x == 0) part[k] = total;
      acc = 0.0;
    }
  });
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

// Kernel 8. x: (n, h, w) contiguous, uint8 when itemsize 1 else f32; h >= 48.
// part: n * ceil(h/32) doubles; sums: (n,) f64 per-frame sums.
extern "C" int rtvqa_strip_sum(const void* x, int itemsize, int n, int h, int w, double* part,
                               double* sums, void* stream_ptr) {
  if (n == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_strips = cdiv(h, 32), n_win = n * n_strips;
  if (itemsize == 1) {
    strip_sum_kernel<uint8_t><<<walk_grid(n_win), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(x), h, w, n_strips, n_win, part);
  } else {
    strip_sum_kernel<float><<<walk_grid(n_win), kThreads, 0, stream>>>(
        static_cast<const float*>(x), h, w, n_strips, n_win, part);
  }
  RTVQA_LAUNCH_CHECK();
  reduce_rows_kernel<<<n, kThreads, 0, stream>>>(part, n_strips, sums);
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
