// Shared by the compositor kernels (composite_fwd.cu, composite_bwd.cu,
// fwd_ablate.cu, bwd_ablate.cu): the layout constants, the per-pair
// arithmetic they must all do identically, so the backward stops exactly
// where the forward stopped, and the fixed-order warp sum (built with
// -fmad=false, every product and sum rounds as the plain version's
// separate torch ops do).
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

template <int K>
__device__ __forceinline__ void hs_add_round(float (&c)[kSub]) {
#pragma unroll
  for (int i = kSub - 1; i >= K; --i) c[i] = c[i] + c[i - K];
}

// Inclusive prefix product in 5 rounds: the tree of _sub_cumprod_static.
__device__ __forceinline__ void hs_prefix_product(float (&c)[kSub]) {
  hs_mul_round<1>(c);
  hs_mul_round<2>(c);
  hs_mul_round<4>(c);
  hs_mul_round<8>(c);
  hs_mul_round<16>(c);
}

// Inclusive prefix sum in 5 rounds: the tree of _sub_cumsum_static.
__device__ __forceinline__ void hs_prefix_sum(float (&c)[kSub]) {
  hs_add_round<1>(c);
  hs_add_round<2>(c);
  hs_add_round<4>(c);
  hs_add_round<8>(c);
  hs_add_round<16>(c);
}

// One sub-block of the forward at tile-local pixel (pxl, pyl) of the tile
// at (ox, oy), from its 32 payload rows sp (shared memory): loc[c] = the
// sum over the rows, in row order, of column F_R+c times w; T and done
// advance as _block_forward (msgs/kernels/composite.py:224-243) leaves
// them: α, the 5-round prefix product of (1−α) and its shift, t_after =
// T·cum, alive = t_after ≥ 1e-4 ∧ ¬done, w = α·T·cum_excl·alive, T = min
// over the rows of (alive ? t_after : T), done |= t_after[31] < 1e-4.
__device__ __forceinline__ void composite_sub(const float* sp, float ox,
                                              float oy, float pxl, float pyl,
                                              float& T, float& done,
                                              float (&loc)[5]) {
  const float kTEps = t_eps();
  float al[kSub], cu[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    float araw;
    al[i] = splat_alpha(sp + i * kFeat, ox, oy, pxl, pyl, araw);
    cu[i] = 1.0f - al[i];
  }
  hs_prefix_product(cu);

  const float t_in = T;
  const float not_done = 1.0f - done;
  float tmin = INFINITY;
#pragma unroll
  for (int c = 0; c < 5; ++c) loc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float ce = i == 0 ? 1.0f : cu[i - 1];
    const float ta = t_in * cu[i];
    const float alive = (ta >= kTEps ? 1.0f : 0.0f) * not_done;
    const float w = al[i] * t_in * ce * alive;
#pragma unroll
    for (int c = 0; c < 5; ++c) loc[c] = loc[c] + sp[i * kFeat + F_R + c] * w;
    tmin = fminf(tmin, alive > 0.0f ? ta : t_in);
  }
  T = tmin;
  done = fmaxf(done, (t_in * cu[kSub - 1]) < kTEps ? 1.0f : 0.0f);
}

// Walking binning's stream (the ablation kernels). Subs 4b..4b+3 form
// block b; a block computes when its first sub is valid, and those blocks
// are a prefix of the stream; sub_tile is nondecreasing over the stream.
constexpr int kNSub = 4;   // subs per 128-entry block

// The computed blocks: the first b with sub_valid[4b] != 1.
__device__ __forceinline__ int computed_blocks(const int* sub_valid,
                                               int n_blocks) {
  int lo = 0, hi = n_blocks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sub_valid[mid * kNSub] == 1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first i in [0, n) with a[i] >= v (n if none); a nondecreasing.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One round of the transposed butterfly: a lane keeps the half of its
// partial vector that bit HALF of its lane selects and sends the other
// half to the lane across that bit. HALF is a template constant so every
// index is one and v stays in registers.
template <int HALF>
__device__ __forceinline__ void butterfly_round(float (&v)[kSub], int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF];
    const float keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Lane l returns the sum over the warp's 32 lanes of v[l] (31 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kSub]) {
  const int lane = threadIdx.x & 31;
  butterfly_round<16>(v, lane);
  butterfly_round<8>(v, lane);
  butterfly_round<4>(v, lane);
  butterfly_round<2>(v, lane);
  butterfly_round<1>(v, lane);
  return v[0];
}

}  // namespace msgs_composite
