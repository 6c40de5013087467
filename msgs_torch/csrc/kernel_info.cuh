// A kernel's build as the runtime reports it, for chip_smoke.py [build]
// (msgs_torch/kernels/_build.py:kernel_info): registers a thread, stack
// (local) bytes, static shared memory a CTA, the dynamic shared memory its
// launch asks for, and CTAs per SM at that launch (`threads` threads,
// `dyn_smem` bytes: the caller passes the constants its launch uses).
#pragma once
#include <cuda_runtime.h>

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
