// The compositor backward with single pieces switched off: the backward
// variants of the ablation tool. The contract and the plain version are
// msgs_torch/kernels/ablate.py (bwd_ablate_plain).
//
// Replaces tools/exp_fwd_ablate.py:268 `bwd_var`, built by `make_bwd` :256
// and called at :428: the image-only backward (msgs/kernels/composite.py:486
// _bwd_kernel) over the forward's sequential grid, with (T, done, wφ
// prefix) in VMEM scratch and per-sub constant rows gathered at each sub's
// tile, in 6 variants (full, geom_nostore, geom_concat, no_geom,
// no_prefix, recompute_only). Its geometry moments come from the script's
// shim: d_power contracted with the raw-monomial basis [x², xy, y², x, y,
// 1] as a bf16 dot with f32 accumulation (:242-254, :346), where
// _bwd_kernel takes exact f32 lane reductions.
//
// Design: composite_bwd.cu's, with image-only colour terms (r g b). One CTA
// per tile, one thread per pixel, walks the tile's subs in order (found by
// binary search over sub_tile within the computed blocks); per sub it
// recomputes α, the prefix product, w, T and done as composite_bwd.cu does
// (the build uses -fmad=false), then dα and dpower, and sums the variant's
// per-entry quantities over the tile's pixels with the fixed-order warp
// butterfly of composite_common.cuh; warp 0 applies the chain rules and
// writes columns 0-8 of each entry's dpay row (the caller's zeros stay in
// the columns a variant does not compute and in 9-11). The bf16
// moments round dpower to bf16 on the CUDA cores (__float2bfloat16_rn) and
// multiply by the basis, which is exact in bf16: every product is exact in
// f32, so only the order of the f32 sums could differ from the TPU's.
// The block rules are the TPU kernel's: full and no_prefix advance the
// state and skip (zero rows) a block all of whose subs continue the tile
// when it is saturated; the other variants never write the state, so a
// sub of a block after its run's first block starts from T = done =
// prefix = 0. Runs chain from sub to sub inside a block in every variant.
// Each row is written by one thread; no atomics, so two launches are
// bit-identical. Rows of blocks that do not compute are not written: the
// caller zeroes dpay.
//
// Bound on the H100: fp32 operations, kernel 4's per (entry, pixel) pair
// (the forward's recompute, φ, the wφ prefix, dα and dpower, the moment
// terms and their butterfly) plus a bf16 rounding per pair for the
// moments, over every computed sub of a live block; dpay, the payload and
// the tiles' constant rows are read or written once.
//
// Also replaces tools/exp_bwd2.py:177 `bwd_kernel_var` (built by
// `make_bwd` :297, called at :323; 4 runs) and tools/exp_bwd3.py:101
// `bwd_kernel` (built by `make` :241, called at :259; 5 runs): `full` with
// other moments and other ways to fetch constants and store rows
// (kernels/ablate.py BwdForm), as template parameters of the same kernel:
//   M       moments: kBf16 (bwd/full's); kDotF32, Σ dpower·m for
//           the exact monomials m (the script's `_dot` under HIGHEST, one
//           rounding per product); kVpu, dp_x = dpower·x first, as
//           exp_bwd2.py:244-251 and composite_bwd.cu form them;
//   kDense  constants: per tile (the TPU fetches them per sub at sub_tile;
//           a CTA per tile reads them once) or the caller's dense
//           (4·B, 8, 256) gather, read per sub by sub index;
//   S       store: kCols (the nine computed columns, one store each; the
//           variants above and exp_bwd3's colstore) or kRow (the 48-byte
//           row as three float4 stores; catstore);
//   kZero   zeroing: the caller zeroes dpay and live rows are written, or
//           the kernel writes every row of the covered blocks once (nozero:
//           columns 9-11 as zeros, extra CTAs after the tiles' zero the
//           rows of blocks that do not compute).
// The TPU's GROUP has no counterpart here (a CTA per tile has no grid
// step): the wrapper passes the blocks its grid covers, (B // group)·group,
// as n_blocks. nogrows (the TPU's implicit broadcast of the per-sub
// constants instead of materialised (BLOCK, NPIX) rows) has none either: a
// thread per pixel holds its constants in registers in every form, so
// nogrows runs colstore's code. The bound is bwd/full's with the moment
// terms of the form: 5 multiplies per pair for kVpu (dp_x, dp_y, then
// ·x, ·y, ·y) and for kDotF32, without bwd/full's bf16 rounding
// (tools/exp_fwd_ablate.py bwd_ops counts every form).
#include <cuda_bf16.h>

#include "composite_common.cuh"

namespace {

using namespace msgs_composite;

constexpr int kWarps = kPix / 32;
constexpr int kMom = 6;      // pixel-monomial moments
constexpr int kPhi = 3;      // image-only colour terms r g b

// kernels/ablate.py BWD_VARIANTS, in order.
enum Variant { kFull = 0, kGeomNostore, kGeomConcat, kNoGeom, kNoPrefix,
               kRecomputeOnly };
// kernels/ablate.py MOMENTS, in order.
enum Moments { kBf16 = 0, kDotF32, kVpu };
enum Store { kCols = 0, kRow };
constexpr int kZeroCtas = 264;   // CTAs that zero the uncomputed blocks

// Rows of blocks [nb, n_blocks) as zeros, the blocks strided over the
// zeroing CTAs (z of nz).
__device__ void zero_blocks(const int* sub_valid, float* dpay, int n_blocks,
                            int z, int nz) {
  __shared__ int nb;
  if (threadIdx.x == 0) nb = computed_blocks(sub_valid, n_blocks);
  __syncthreads();
  constexpr int kVec = kNSub * kSub * kFeat / 4;   // float4s per block
  for (int b = nb + z; b < n_blocks; b += nz) {
    float4* d = reinterpret_cast<float4*>(dpay + (long long)b * (kVec * 4));
    for (int i = threadIdx.x; i < kVec; i += kPix)
      d[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int V, int M = kBf16, bool kDense = false, int S = kCols,
          bool kZero = false>
__global__ void __launch_bounds__(kPix)
bwd_ablate_kernel(const float* __restrict__ payload,
                  const int* __restrict__ sub_tile,
                  const int* __restrict__ sub_valid,
                  const float* __restrict__ cst, float* __restrict__ dpay,
                  int n_blocks, int tiles, int tiles_x, int width,
                  int height) {
  constexpr bool kAdvance = V == kFull || V == kNoPrefix;
  // Per-entry sums: Σ w; or Σ dpower and the 3 colour sums; or the 6
  // moments and the 3 colour sums.
  constexpr int kQ =
      V == kRecomputeOnly ? 1 : V == kNoGeom ? 1 + kPhi : kMom + kPhi;
  __shared__ float sp[kSub * kFeat];
  __shared__ float red[kQ][kWarps][kSub];
  __shared__ int run[2];
  const float kTEps = t_eps();

  if (kZero && (int)blockIdx.x >= tiles) {
    zero_blocks(sub_valid, dpay, n_blocks, blockIdx.x - tiles,
                gridDim.x - tiles);
    return;
  }
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  if (p == 0) {
    const int nb = computed_blocks(sub_valid, n_blocks);
    run[0] = lower_bound(sub_tile, nb * kNSub, tile);
    run[1] = lower_bound(sub_tile, nb * kNSub, tile + 1);
  }
  __syncthreads();
  const int s0 = run[0], s1 = run[1];
  if (s0 >= s1) return;

  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;
  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);
  const float xx = pxl * pxl, xy = pxl * pyl, yy = pyl * pyl;
  // The tile's constant rows (tools/exp_fwd_ablate.py:257-264): g_r g_g
  // g_b, and the suffix base total_phi + T_final·g_T; per sub if dense.
  float g[kPhi];
  float sfx;
  auto constants = [&](long long row) {
    const float* c = cst + row * (kOut * kPix) + p;
#pragma unroll
    for (int ch = 0; ch < kPhi; ++ch) g[ch] = c[ch * kPix];
    sfx = c[5 * kPix] + c[6 * kPix];
  };
  if (!kDense) constants(tile);

  const float outside =
      ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height) ? 1.0f
                                                                   : 0.0f;
  float T = 1.0f, done = outside;
  float P = 0.0f;      // Σ w·φ over the run's earlier subs
  bool sat = false;    // all 256 pixels done (uniform over the CTA)
  bool skip = false;   // the current block is skipped

  for (int j = s0; j < s1; ++j) {
    float* d = dpay + (long long)j * (kSub * kFeat);
    if (j % kNSub == 0 && j > s0) {
      skip = kAdvance && j + kNSub - 1 < s1 && sat;
      if (!kAdvance) {   // a carried sub: the never-written state
        T = 0.0f;
        done = 0.0f;
        P = 0.0f;
      }
    }
    if (skip) {
      for (int i = p; i < kSub * kFeat; i += kPix) d[i] = 0.0f;
      continue;
    }
    const float* src = payload + (long long)j * (kSub * kFeat);
    for (int i = p; i < kSub * kFeat; i += kPix) sp[i] = src[i];
    if (kDense) constants(j);
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
      for (int ch = 1; ch < kPhi; ++ch) phi = phi + g[ch] * e[F_R + ch];
      const float t_i = t_in * ce;
      ce = cu[i];
      cu[i] = t_i * phi;        // cu now holds T_i·φ_i
      wphi[i] = w[i] * phi;
    }
    T = tmin;
    done = fmaxf(done, t_last < kTEps ? 1.0f : 0.0f);

    if (V != kRecomputeOnly) {
      // The wφ prefix within the run (no_prefix: the row's own w·φ), then
      // dpower per entry, into wphi.
      if (V != kNoPrefix) hs_prefix_sum(wphi);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float suffix = V == kNoPrefix ? sfx - wphi[i]
                                            : sfx - (P + wphi[i]);
        const float alive = (alive_bits >> i) & 1u ? 1.0f : 0.0f;
        const float mask = al[i] > 0.0f ? 1.0f : 0.0f;
        const float d_alpha =
            (cu[i] - suffix / (1.0f - al[i])) * alive * mask;
        const float unc = (unclamped >> i) & 1u ? 1.0f : 0.0f;
        if (V != kNoPrefix && i == kSub - 1) P = P + wphi[i];
        wphi[i] = d_alpha * al[i] * unc;
      }
    }

    // Per-entry sums over the warp's 32 pixels.
    float v[kSub];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (V == kRecomputeOnly) {
          v[i] = w[i];
        } else if (V == kNoGeom) {
          v[i] = q == 0 ? wphi[i] : w[i] * g[q == 0 ? 0 : q - 1];
        } else if (q < kMom && M == kDotF32) {
          const float dp = wphi[i];
          switch (q) {
            case 0: v[i] = dp * xx; break;          // x²
            case 1: v[i] = dp * xy; break;          // xy
            case 2: v[i] = dp * yy; break;          // y²
            case 3: v[i] = dp * pxl; break;         // x
            case 4: v[i] = dp * pyl; break;         // y
            default: v[i] = dp; break;              // 1
          }
        } else if (q < kMom) {
          // kBf16 rounds dpower to bf16 first; kVpu takes it as it is.
          // Both form (dp·x)·x, (dp·x)·y and (dp·y)·y.
          const float dp =
              M == kBf16 ? __bfloat162float(__float2bfloat16_rn(wphi[i]))
                         : wphi[i];
          switch (q) {
            case 0: v[i] = dp * pxl * pxl; break;   // x²
            case 1: v[i] = dp * pxl * pyl; break;   // xy
            case 2: v[i] = dp * pyl * pyl; break;   // y²
            case 3: v[i] = dp * pxl; break;         // x
            case 4: v[i] = dp * pyl; break;         // y
            default: v[i] = dp; break;              // 1
          }
        } else {
          v[i] = w[i] * g[q - kMom];
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
      float row[kFeat];
#pragma unroll
      for (int col = 0; col < kFeat; ++col) row[col] = 0.0f;
      if (V == kRecomputeOnly) {
        row[0] = s[0];
      } else if (V == kNoGeom) {
        row[0] = s[0];
#pragma unroll
        for (int ch = 0; ch < kPhi; ++ch) row[F_R + ch] = s[1 + ch];
      } else {
        const float q20 = s[0], q11 = s[1], q02 = s[2];
        const float q10 = s[3], q01 = s[4], q00 = s[5];
        const float* e = sp + lane * kFeat;
        const float mxl = e[F_MX] - ox;
        const float myl = e[F_MY] - oy;
        const float cxx = e[F_CXX], cxy = e[F_CXY], cyy = e[F_CYY];
        const float op = e[F_OP];
        const float d_cxx = -0.5f * (q20 - 2.0f * mxl * q10 + mxl * mxl * q00);
        const float d_cyy = -0.5f * (q02 - 2.0f * myl * q01 + myl * myl * q00);
        const float d_cxy = -(q11 - myl * q10 - mxl * q01 + mxl * myl * q00);
        const float d_mx = cxx * (q10 - mxl * q00) + cxy * (q01 - myl * q00);
        const float d_my = cyy * (q01 - myl * q00) + cxy * (q10 - mxl * q00);
        const float d_op = op > 0.0f ? q00 / fmaxf(op, 1e-30f) : 0.0f;
        if (V == kGeomNostore) {
          row[0] = d_mx + d_my + d_cxx + d_cxy + d_cyy + d_op +
                   (((0.0f + s[kMom]) + s[kMom + 1]) + s[kMom + 2]);
        } else {
          row[F_MX] = d_mx;
          row[F_MY] = d_my;
          row[F_CXX] = d_cxx;
          row[F_CXY] = d_cxy;
          row[F_CYY] = d_cyy;
          row[F_OP] = d_op;
#pragma unroll
          for (int ch = 0; ch < kPhi; ++ch) row[F_R + ch] = s[kMom + ch];
        }
      }
      float* dr = d + lane * kFeat;
      if (S == kCols) {
        // kZero writes every column once, 9-11 as zeros.
        constexpr int kCol = kZero ? kFeat : F_R + kPhi;
#pragma unroll
        for (int col = 0; col < kCol; ++col) dr[col] = row[col];
      } else {
        float4* d4 = reinterpret_cast<float4*>(dr);
        d4[0] = make_float4(row[0], row[1], row[2], row[3]);
        d4[1] = make_float4(row[4], row[5], row[6], row[7]);
        d4[2] = make_float4(row[8], row[9], row[10], row[11]);
      }
    }

    // Also the barrier before the next sub overwrites sp and red.
    sat = __syncthreads_count(done != 0.0f) == kPix;
  }
}

template <int V, int M = kBf16, bool kDense = false, int S = kCols,
          bool kZero = false>
int launch(const float* pay, const int* st, const int* sv, const float* cst,
           float* dpay, int n_blocks, int tiles, int tiles_x, int width,
           int height, cudaStream_t s) {
  const int grid = tiles + (kZero ? kZeroCtas : 0);
  bwd_ablate_kernel<V, M, kDense, S, kZero><<<grid, kPix, 0, s>>>(
      pay, st, sv, cst, dpay, n_blocks, tiles, tiles_x, width, height);
  return (int)cudaGetLastError();
}

}  // namespace

// The forms of `full` built (kernels/ablate.py BUILT_FORMS): moments,
// dense, row store, kernel zeroing.
#define MSGS_BWD_FORM(M, D, R, Z)                                          \
  if (moments == M && dense == D && row_store == R && kernel_zero == Z)    \
    return launch<kFull, M, D, R ? kRow : kCols, Z>(                        \
        pay, st, sv, c, d, n_blocks, tiles, tiles_x, width, height, s);

extern "C" int msgs_bwd_ablate(const void* payload, const void* sub_tile,
                               const void* sub_valid, const void* cst,
                               void* dpay, int n_blocks, int variant,
                               int moments, int dense, int row_store,
                               int kernel_zero, int tiles, int tiles_x,
                               int width, int height, void* stream) {
  if (n_blocks <= 0 || tiles <= 0) return 0;
  const float* pay = (const float*)payload;
  const int* st = (const int*)sub_tile;
  const int* sv = (const int*)sub_valid;
  const float* c = (const float*)cst;
  float* d = (float*)dpay;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kFull) {
    MSGS_BWD_FORM(kBf16, false, false, false)    // bwd/full
    MSGS_BWD_FORM(kVpu, false, false, false)     // geom_vpu, colstore
    MSGS_BWD_FORM(kDotF32, true, false, false)   // cst_dense
    MSGS_BWD_FORM(kVpu, true, false, false)      // geom_vpu+cst_dense
    MSGS_BWD_FORM(kDotF32, false, false, false)  // g16
    MSGS_BWD_FORM(kVpu, false, true, false)      // catstore
    MSGS_BWD_FORM(kVpu, false, false, true)      // nozero
    MSGS_BWD_FORM(kVpu, false, true, true)       // all
    return (int)cudaErrorInvalidValue;
  }
  if (moments != kBf16 || dense || row_store || kernel_zero)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kGeomNostore:
      return launch<kGeomNostore>(pay, st, sv, c, d, n_blocks, tiles,
                                  tiles_x, width, height, s);
    case kGeomConcat:
      return launch<kGeomConcat>(pay, st, sv, c, d, n_blocks, tiles, tiles_x,
                                 width, height, s);
    case kNoGeom:
      return launch<kNoGeom>(pay, st, sv, c, d, n_blocks, tiles, tiles_x,
                             width, height, s);
    case kNoPrefix:
      return launch<kNoPrefix>(pay, st, sv, c, d, n_blocks, tiles, tiles_x,
                               width, height, s);
    case kRecomputeOnly:
      return launch<kRecomputeOnly>(pay, st, sv, c, d, n_blocks, tiles,
                                    tiles_x, width, height, s);
  }
  return (int)cudaErrorInvalidValue;
}
