// Tile compositor, backward: per-entry gradients of the 11 payload columns
// F_MX..F_PSIZE from the forward output and its cotangent. The plain
// version is msgs_torch/kernels/composite.py:composite_bwd_reference.
//
// Replaces msgs/kernels/composite.py:_bwd_kernel (launched by
// _composite_bwd_call). The TPU kernel walks payload blocks in grid order
// with (T, done, wφ-prefix) in VMEM scratch, reads per-sub constant rows
// [g_rgb, g_depth, g_acc, total_phi, T_final·g_T] pre-gathered by the
// caller, and sums each entry's per-pixel terms with lane reductions. Here,
// as in composite_fwd.cu, one CTA owns one tile and walks its sub-blocks
// [first_sub, first_sub + n_sub) in order, one thread per pixel. Each
// thread reads its pixel's forward output (C, D, A, T_final) and cotangent
// once and builds total_phi and T_final·g_T in registers, so no per-tile
// constant table exists.
//
// Per sub-block and pixel, with φ_i = Σ_c g_c·f_c over the colour columns
// (r g b, plus depth and psize unless image_only):
//   α, the 5-round Hillis-Steele product of (1−α), t_after, alive, w, and
//   the new T and done: the forward kernel's exact arithmetic (the build
//   uses -fmad=false), so every T < 1e-4 stop decision is the forward's;
//   prefix_i = P + (5-round Hillis-Steele sum of w·φ)_i, P the running
//   prefix of the earlier sub-blocks;
//   S_i = (total_phi + T_final·g_T) − prefix_i     (the JAX form, :612-615);
//   dα_i = (T_i·φ_i − S_i/(1−α_i))·alive·mask;
//   dpower_i = dα_i·α_i·[α_raw < 0.99].
// Per entry, sums over the tile's 256 pixels of the six pixel-monomial
// moments of dpower (x², xy, y², x, y, 1, tile-local) and of w·g_c give
// d{mean2D, conic, opacity} by the chain rules of :656-671 and d{colour
// columns}. The sums run in a fixed order: each warp reduces its 32
// pixels with a transposed butterfly (31 shuffles reduce one quantity for
// all 32 entries at once, and lane l ends with entry l's sum), the 8 warp
// partials go through shared memory, and warp 0 adds them in warp order,
// applies the chain rules and writes the entry's 12-column dpay row. The
// kernel is deterministic and needs no atomics: each entry belongs to one
// tile, so each row is written by one thread.
//
// The CTA stops where the forward stopped (__syncthreads_and(done)); the
// wrapper zeroes dpay, so the rows of skipped and invalid sub-blocks, and
// the columns the kernel does not compute, read 0.
//
// Bound on the H100: fp32 operations — the forward's 46 per (entry, pixel)
// pair before saturation, recomputed, and 41 more under image_only (49
// otherwise; counted in chip_smoke.py), plus the butterfly's shuffles; the
// payload, dpay, forward output and cotangent are read or written once.
// Every per-thread array is indexed by constants only (template strides in
// composite_common.cuh and here), so nothing lives in local memory.
#include "composite_common.cuh"

namespace {

using namespace msgs_composite;

constexpr int kWarps = kPix / 32;
constexpr int kMom = 6;               // pixel-monomial moments

template <int NF>
__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ first_sub,
                     const int* __restrict__ n_sub,
                     const float* __restrict__ res,
                     const float* __restrict__ cot,
                     float* __restrict__ dpay,
                     int tiles_x, int width, int height) {
  constexpr int kQ = kMom + NF;       // per-entry sums
  __shared__ float sp[kSub * kFeat];
  __shared__ float red[kQ][kWarps][kSub];
  const float kTEps = t_eps();

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;
  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);

  const float* r = res + (long long)tile * (kOut * kPix) + p;
  const float* c = cot + (long long)tile * (kOut * kPix) + p;
  float g[5];
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) g[ch] = c[ch * kPix];
  // _composite_bwd_call's constant rows (:806-809), per pixel.
  const float total_phi = (r[0] * g[0] + r[kPix] * g[1]) + r[2 * kPix] * g[2] +
                          r[O_DEPTH * kPix] * g[3] + r[O_ACC * kPix] * g[4];
  const float sfx = total_phi + r[O_T * kPix] * c[O_T * kPix];

  float T = 1.0f;
  float done = ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height)
                   ? 1.0f : 0.0f;
  float P = 0.0f;   // Σ w·φ over the tile's earlier sub-blocks

  const int s0 = first_sub[tile];
  const int ns = n_sub[tile];
  for (int k = 0; k < ns; ++k) {
    const float* src = payload + (long long)(s0 + k) * (kSub * kFeat);
    for (int i = p; i < kSub * kFeat; i += kPix) sp[i] = src[i];
    __syncthreads();

    // α and the prefix product, exactly as composite_fwd.cu computes them.
    float al[kSub], cu[kSub];
    unsigned unclamped = 0u;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      float araw;
      al[i] = splat_alpha(sp + i * kFeat, ox, oy, pxl, pyl, araw);
      cu[i] = 1.0f - al[i];
      if (araw < alpha_max()) unclamped |= 1u << i;
    }
    hs_prefix_product(cu);

    // w, T_i·φ and w·φ per entry; the new T and done as the forward.
    const float t_in = T;
    const float not_done = 1.0f - done;
    const float t_last = t_in * cu[kSub - 1];
    float w[kSub], wphi[kSub];
    unsigned alive_bits = 0u;
    float tmin = INFINITY;
    float ce = 1.0f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const float* e = sp + i * kFeat;
      const float ta = t_in * cu[i];
      const float alive = (ta >= kTEps ? 1.0f : 0.0f) * not_done;
      w[i] = al[i] * t_in * ce * alive;
      tmin = fminf(tmin, alive > 0.0f ? ta : t_in);
      if (alive > 0.0f) alive_bits |= 1u << i;
      float phi = g[0] * e[F_R];
#pragma unroll
      for (int ch = 1; ch < NF; ++ch) phi = phi + g[ch] * e[F_R + ch];
      const float t_i = t_in * ce;
      ce = cu[i];
      cu[i] = t_i * phi;        // cu now holds T_i·φ_i
      wphi[i] = w[i] * phi;
    }
    T = tmin;
    done = fmaxf(done, t_last < kTEps ? 1.0f : 0.0f);

    // Inclusive prefix of w·φ within the sub-block.
    hs_prefix_sum(wphi);
    // dpower per entry, into wphi.
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const float suffix = sfx - (P + wphi[i]);
      const float alive = (alive_bits >> i) & 1u ? 1.0f : 0.0f;
      const float mask = al[i] > 0.0f ? 1.0f : 0.0f;
      const float d_alpha =
          (cu[i] - suffix / (1.0f - al[i])) * alive * mask;
      const float unc = (unclamped >> i) & 1u ? 1.0f : 0.0f;
      if (i == kSub - 1) P = P + wphi[i];
      wphi[i] = d_alpha * al[i] * unc;
    }

    // Per-entry sums over the warp's 32 pixels: moments of dpower, then
    // Σ w·g_c per colour column.
    float v[kSub];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float dp = wphi[i];
        switch (q) {
          case 0: v[i] = dp * pxl * pxl; break;   // x²
          case 1: v[i] = dp * pxl * pyl; break;   // xy
          case 2: v[i] = dp * pyl * pyl; break;   // y²
          case 3: v[i] = dp * pxl; break;         // x
          case 4: v[i] = dp * pyl; break;         // y
          case 5: v[i] = dp; break;               // 1
          default: v[i] = w[i] * g[q >= kMom ? q - kMom : 0]; break;
        }
      }
      red[q][warp][lane] = warp_transpose_sum(v);
    }
    __syncthreads();

    if (warp == 0) {
      float s[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float a = red[q][0][lane];
#pragma unroll
        for (int wp = 1; wp < kWarps; ++wp) a = a + red[q][wp][lane];
        s[q] = a;
      }
      const float q20 = s[0], q11 = s[1], q02 = s[2];
      const float q10 = s[3], q01 = s[4], q00 = s[5];
      const float* e = sp + lane * kFeat;
      const float mxl = e[F_MX] - ox;
      const float myl = e[F_MY] - oy;
      const float cxx = e[F_CXX], cxy = e[F_CXY], cyy = e[F_CYY];
      const float op = e[F_OP];
      float row[kFeat];
      row[F_CXX] = -0.5f * (q20 - 2.0f * mxl * q10 + mxl * mxl * q00);
      row[F_CYY] = -0.5f * (q02 - 2.0f * myl * q01 + myl * myl * q00);
      row[F_CXY] = -(q11 - myl * q10 - mxl * q01 + mxl * myl * q00);
      row[F_MX] = cxx * (q10 - mxl * q00) + cxy * (q01 - myl * q00);
      row[F_MY] = cyy * (q01 - myl * q00) + cxy * (q10 - mxl * q00);
      row[F_OP] = op > 0.0f ? q00 / fmaxf(op, 1e-30f) : 0.0f;
#pragma unroll
      for (int col = F_R; col < kFeat; ++col) row[col] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < NF; ++ch) row[F_R + ch] = s[kMom + ch];
      float* d = dpay + ((long long)(s0 + k) * kSub + lane) * kFeat;
#pragma unroll
      for (int col = 0; col < kFeat; ++col) d[col] = row[col];
    }

    // Also the barrier before the next sub-block overwrites sp and red.
    if (__syncthreads_and(done != 0.0f)) break;
  }
}

}  // namespace

extern "C" int msgs_composite_bwd(const void* payload, const void* first_sub,
                                  const void* n_sub, const void* res,
                                  const void* cot, void* dpay, int tiles,
                                  int tiles_x, int width, int height,
                                  int image_only, void* stream) {
  if (tiles <= 0) return 0;
  const float* pay = (const float*)payload;
  const int* fs = (const int*)first_sub;
  const int* nsb = (const int*)n_sub;
  const float* rs = (const float*)res;
  const float* ct = (const float*)cot;
  float* dp = (float*)dpay;
  cudaStream_t st = (cudaStream_t)stream;
  // image_only: φ and the colour sums over r g b only (the depth and acc
  // cotangents are structurally zero, as in the TPU kernel's nf_phi = 3).
  if (image_only)
    composite_bwd_kernel<3><<<tiles, kPix, 0, st>>>(
        pay, fs, nsb, rs, ct, dp, tiles_x, width, height);
  else
    composite_bwd_kernel<5><<<tiles, kPix, 0, st>>>(
        pay, fs, nsb, rs, ct, dp, tiles_x, width, height);
  return (int)cudaGetLastError();
}
