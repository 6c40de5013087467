// Shared by the compositor kernels (composite_fwd.cu, composite_bwd.cu,
// composite_bwd_bf16.cu, and through ablate_common.cuh fwd_ablate.cu and
// bwd_ablate.cu): the layout constants and the per-pair arithmetic they
// must all do identically, so the backward stops exactly where the forward
// stopped (built with -fmad=false, every product and sum rounds as the
// plain version's separate torch ops do).
#pragma once
#include <cuda_runtime.h>

namespace msgs_composite {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // 256 threads, one per pixel
constexpr int kSub = 32;              // entries per sub-block
constexpr int kFeat = 12;             // payload columns
constexpr int kOut = 8;               // output channels

// Payload columns (composite.py F_*) and output rows (O_*).
constexpr int F_MX = 0, F_MY = 1, F_CXX = 2, F_CXY = 3, F_CYY = 4, F_OP = 5;
constexpr int F_R = 6;   // r g b depth psize = F_R .. F_R+4
constexpr int O_DEPTH = 3, O_ACC = 4, O_T = 5, O_DONE = 6;

// The double constants rounded to float, as torch rounds a Python scalar.
__device__ __forceinline__ float alpha_min() { return (float)(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return (float)0.99; }
__device__ __forceinline__ float t_eps() { return (float)1e-4; }

// α of payload row e at tile-local pixel (pxl, pyl) of the tile at
// (ox, oy): mask ? min(0.99, o·exp(power)) : 0, power in tile-local
// offsets (composite.py:_BlockCtx). araw is o·exp(power).
__device__ __forceinline__ float splat_alpha(const float* e, float ox,
                                             float oy, float pxl, float pyl,
                                             float& araw) {
  const float mxl = e[F_MX] - ox;
  const float myl = e[F_MY] - oy;
  const float dx = pxl - mxl;
  const float dy = pyl - myl;
  const float power =
      -0.5f * (e[F_CXX] * dx * dx + e[F_CYY] * dy * dy) - e[F_CXY] * dx * dy;
  araw = e[F_OP] * expf(power);
  const bool m = (araw >= alpha_min()) && (power <= 0.0f);
  return m ? fminf(araw, alpha_max()) : 0.0f;
}

// One Hillis-Steele round of stride K over a sub-block's 32 values,
// descending so each step reads the previous round's value. K is a
// template constant so every index is one and the array stays in
// registers (a loop over K would leave them in local memory).
template <int K>
__device__ __forceinline__ void hs_mul_round(float (&c)[kSub]) {
#pragma unroll
  for (int i = kSub - 1; i >= K; --i) c[i] = c[i] * c[i - K];
}

// Inclusive prefix product in 5 rounds: the tree of _sub_cumprod_static.
__device__ __forceinline__ void hs_prefix_product(float (&c)[kSub]) {
  hs_mul_round<1>(c);
  hs_mul_round<2>(c);
  hs_mul_round<4>(c);
  hs_mul_round<8>(c);
  hs_mul_round<16>(c);
}

}  // namespace msgs_composite
