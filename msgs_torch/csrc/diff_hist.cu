// Binning's 2-D difference histogram: for every rectangle [y0, y1) ×
// [x0, x1) of a row, +1 at (y0, x0) and (y1, x1), −1 at (y0, x1) and
// (y1, x0), on an (ny, nx) int32 grid; a corner off the grid adds nothing.
// The plain version is msgs_torch/kernels/binning.py:_onehot_diff_histogram
// (an int32 corner scatter_add_), once per band for the banded path
// (_band_histogram_plain). int32 addition is exact and wraps mod 2^32 in any
// order, so the kernel's grid equals the plain version's bit for bit.
//
// Replaces no TPU kernel: the JAX package forms the histogram as one-hot f32
// matmuls in XLA (msgs/kernels/binning.py:_onehot_diff_histogram). The port's
// plain scatter put every culled row, and every row whose band is empty, on
// the drop row, where the four corners of each land on the same few cells
// and cancel; the atomics on those cells serialised, 20–24 ms a ×1 render.
//
// Bound on the H100: bytes. The banded path reads 41 bytes a row (the rect's
// top row, three band boundaries, three band lows and widths, the live
// flag): 172 MB at 4,194,304 rows, 0.05 ms at 3.35 TB/s. Design:
//   * A rectangle with y0 == y1 or x0 == x1 is skipped: its corners come in
//     +1/−1 pairs on the same cells, or both off the grid, and cancel. That
//     is every culled row, every empty band and every row the plain code
//     parks on the drop row. Every other rectangle adds its four corners as
//     the plain version does, inverted ones and corners off the grid too.
//   * Shared path: each CTA keeps a private copy of the whole grid in
//     shared memory (17 KB at 1237×822, 20 KB at 1332×876), takes rows in a
//     grid-stride loop, adds corners with shared-memory atomics, then adds
//     its non-zero cells to the output with global atomics. The grid is
//     sized to the card (the CTAs resident at that shared memory), so the
//     final adds are a few per cell per SM.
//   * Global path: a grid larger than the shared memory a CTA can take
//     (banded axes of up to 255 tiles, the rect path past 4,080 px) adds
//     its corners to the output directly, still skipping empty rectangles.
//     The path is chosen here from the grid's cell count; the wrapper counts
//     each launch by the path it reports.
//   * Bands form (K = 3, the banded path): a row's band k covers rect rows
//     [q_{k-1}, q_k) (q_{-1} = 0) from the rect's top row, and columns
//     [int(xlo_k), int(xlo_k + w_k)); it is on where the row is live and
//     w_k > 0. The kernel forms y0, y1, x0, x1 from these with the plain
//     code's casts (an f32 add, then truncation as torch's CUDA cast does),
//     so the ~200 index launches of the plain version go away. A dead row
//     reads only its live flag.
//   * Corners form (K = 1, the rect and row-tight paths): one rectangle a
//     row from the int32 corner arrays those paths already compute.
// The output is zero when the kernel starts (the wrapper allocates it with
// torch.zeros).
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMinCtas = 3;   // CTAs an SM holds at least (registers)
constexpr int kBands = 3;
constexpr int kMaxDevices = 64;

// a + b as torch adds int32: wrapping.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Bands {
  static constexpr int K = kBands;
  const int* ybase;   // the rect's top row, every ystride ints
  long long ystride;
  const int* q[kBands];
  const float* xlo[kBands];
  const float* w[kBands];
  const unsigned char* live;

  // Calls f(y0, y1, x0, x1) for each non-empty band of row n.
  template <typename F>
  __device__ __forceinline__ void each(long long n, F&& f) const {
    if (__ldcs(live + n) == 0) return;
    const int y = __ldcs(ybase + n * ystride);
    int qa = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int qb = __ldcs(q[k] + n);
      const float wk = __ldcs(w[k] + n);
      if (wk > 0.0f) {
        const int y0 = wrap_add(y, qa), y1 = wrap_add(y, qb);
        const float xl = __ldcs(xlo[k] + n);
        const int x0 = __float2int_rz(xl);
        const int x1 = __float2int_rz(__fadd_rn(xl, wk));
        if (y0 != y1 && x0 != x1) f(y0, y1, x0, x1);
      }
      qa = qb;
    }
  }
};

struct Corners {
  static constexpr int K = 1;
  const int* y0;
  const int* y1;
  const int* x0;
  const int* x1;

  template <typename F>
  __device__ __forceinline__ void each(long long n, F&& f) const {
    const int a = __ldcs(y0 + n), b = __ldcs(y1 + n);
    const int c = __ldcs(x0 + n), d = __ldcs(x1 + n);
    if (a != b && c != d) f(a, b, c, d);
  }
};

template <typename R, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinCtas)
diff_hist(R rd, long long n_rows, int ny, int nx, int* __restrict__ out) {
  extern __shared__ int grid[];
  const int cells = ny * nx;
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += kThreads) grid[c] = 0;
    __syncthreads();
  }
  auto corner = [&](int y, int x, int v) {
    if ((unsigned)y < (unsigned)ny && (unsigned)x < (unsigned)nx) {
      if constexpr (kShared)
        atomicAdd(grid + y * nx + x, v);
      else
        atomicAdd(out + y * nx + x, v);
    }
  };
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
       n < n_rows; n += stride)
    rd.each(n, [&](int y0, int y1, int x0, int x1) {
      corner(y0, x0, 1);
      corner(y0, x1, -1);
      corner(y1, x0, -1);
      corner(y1, x1, 1);
    });
  if constexpr (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += kThreads) {
      const int v = grid[c];
      if (v != 0) atomicAdd(out + c, v);
    }
  }
}

// The four instances, by the index msgs_diff_hist_info takes.
enum Instance { kSharedBands, kSharedCorners, kGlobalBands, kGlobalCorners };

// Per device: SMs, the shared memory a CTA can take, and whether the shared
// instances may take it (set once: cudaFuncSetAttribute is per function
// and device).
struct DeviceLimits {
  bool ready = false;
  int sms = 0;
  int smem_optin = 0;
};

int device_limits(DeviceLimits& lim) {
  static std::mutex mu;
  static DeviceLimits devices[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceLimits& d = devices[dev];
  if (!d.ready) {
    e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(diff_hist<Bands, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(diff_hist<Corners, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_optin);
    if (e != cudaSuccess) return (int)e;
    d.ready = true;
  }
  lim = d;
  return 0;
}

// Launches k over n_rows rows on as many CTAs as the card holds at `smem`
// bytes a CTA, fewer where there are fewer rows than threads.
template <typename R, bool kShared>
int launch(const R& rd, long long n_rows, int ny, int nx, int* out,
           size_t smem, int sms, cudaStream_t s) {
  auto* k = diff_hist<R, kShared>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (n_rows + kThreads - 1) / kThreads;
  const long long cap = (long long)per_sm * sms;
  k<<<(unsigned)(need < cap ? need : cap), kThreads, smem, s>>>(rd, n_rows,
                                                                ny, nx, out);
  return (int)cudaGetLastError();
}

template <typename R>
int run(const R& rd, long long n_rows, int ny, int nx, int* out, int* path,
        cudaStream_t s) {
  DeviceLimits lim;
  const int err = device_limits(lim);
  if (err != 0) return err;
  const long long bytes = (long long)ny * nx * (long long)sizeof(int);
  if (bytes <= lim.smem_optin) {
    *path = 0;
    return launch<R, true>(rd, n_rows, ny, nx, out, (size_t)bytes, lim.sms,
                           s);
  }
  *path = 1;
  return launch<R, false>(rd, n_rows, ny, nx, out, 0, lim.sms, s);
}

}  // namespace

extern "C" {

// form 0 (bands): desc = {ybase, q_0, q_1, q_2, xlo_0, xlo_1, xlo_2, w_0,
// w_1, w_2, live}: int32 ybase every ystride ints, int32 q_k, float32 xlo_k
// and w_k, bool live, n_rows each. form 1 (corners): desc = {y0, y1, x0,
// x1}, int32, n_rows each. out: (ny, nx) int32, zero. *path: 0 where the
// launch kept the grid in shared memory, 1 where it added to out directly.
int msgs_diff_hist(const void* const* desc, int form, long long n_rows,
                   long long ystride, int ny, int nx, void* out, int* path,
                   void* stream) {
  *path = -1;
  if (ny <= 0 || nx <= 0 || (long long)ny * nx > 0x7fffffffLL || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* o = (int*)out;
  if (form == 0) {
    Bands b;
    b.ybase = (const int*)desc[0];
    b.ystride = ystride;
    for (int k = 0; k < kBands; ++k) {
      b.q[k] = (const int*)desc[1 + k];
      b.xlo[k] = (const float*)desc[1 + kBands + k];
      b.w[k] = (const float*)desc[1 + 2 * kBands + k];
    }
    b.live = (const unsigned char*)desc[1 + 3 * kBands];
    return run(b, n_rows, ny, nx, o, path, s);
  }
  if (form == 1) {
    const Corners c{(const int*)desc[0], (const int*)desc[1],
                    (const int*)desc[2], (const int*)desc[3]};
    return run(c, n_rows, ny, nx, o, path, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The build of instance i (shared bands, shared corners, global bands,
// global corners) at a grid of `cells` cells: registers, stack bytes,
// static and dynamic shared memory, CTAs per SM.
int msgs_diff_hist_info(int i, int cells, int* out) {
  DeviceLimits lim;
  const int err = device_limits(lim);
  if (err != 0) return err;
  const size_t smem = (size_t)cells * sizeof(int);
  switch (i) {
    case kSharedBands:
      return fill_kernel_info(diff_hist<Bands, true>, kThreads, smem, out);
    case kSharedCorners:
      return fill_kernel_info(diff_hist<Corners, true>, kThreads, smem, out);
    case kGlobalBands:
      return fill_kernel_info(diff_hist<Bands, false>, kThreads, 0, out);
    case kGlobalCorners:
      return fill_kernel_info(diff_hist<Corners, false>, kThreads, 0, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
