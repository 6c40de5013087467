// A kernel's build as the runtime reports it, for chip_smoke.py [build]
// (msgs_torch/kernels/_build.py:kernel_info): registers a thread, stack
// (local) bytes, static shared memory a CTA, the dynamic shared memory its
// launch asks for, and CTAs per SM at that launch (`threads` threads,
// `dyn_smem` bytes: the caller passes the constants its launch uses); and
// the CTAs the card holds at once, which sizes a grid.
#pragma once
#include <cuda_runtime.h>

#include <mutex>

template <typename Kernel>
inline int fill_kernel_info(Kernel* kernel, int threads, size_t dyn_smem,
                            int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn_smem;
  out[4] = ctas;
  return 0;
}

// The CTAs of `kernel` the card holds at once with `threads` threads and
// `smem` bytes of dynamic shared memory a CTA: CTAs per SM, at most
// `max_per_sm`, × SMs (the gather's and the probe's grids). The runtime is
// asked once per device, kernel and size, after allowing shared memory
// above 48 KB on that device: a launch asks on every call's host path.
template <typename Kernel>
inline int resident_ctas(Kernel* kernel, int threads, size_t smem,
                         int max_per_sm, long long& ctas) {
  static std::mutex mu;
  static int devices[64];
  static const void* kernels[64];
  static size_t sizes[64];
  static long long cached[64];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (devices[i] == dev && kernels[i] == (const void*)kernel &&
        sizes[i] == smem) {
      ctas = cached[i];
      return 0;
    }
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  ctas = (long long)sms * (per_sm < max_per_sm ? per_sm : max_per_sm);
  if (n < 64) {
    devices[n] = dev;
    kernels[n] = (const void*)kernel;
    sizes[n] = smem;
    cached[n++] = ctas;
  }
  return 0;
}
