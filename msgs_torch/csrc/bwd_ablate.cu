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
// Also replaces tools/exp_bwd2.py:177 `bwd_kernel_var` (built by
// `make_bwd` :297, called at :323; 4 runs) and tools/exp_bwd3.py:101
// `bwd_kernel` (built by `make` :241, called at :259; 5 runs): `full` with
// other moments and other ways to fetch constants and store rows
// (kernels/ablate.py BwdForm), as template parameters of the same kernel:
//   M       moments: kBf16 (bwd/full's: dpower rounded to bf16, then
//           (dp·x)·x, (dp·x)·y, (dp·y)·y, dp·x, dp·y, dp; every product is
//           exact in f32); kDotF32, dpower·m for the exact monomials m (the
//           script's `_dot` under HIGHEST, one rounding per product); kVpu,
//           dp_x = dpower·x first, as exp_bwd2.py:244-251 and
//           composite_bwd.cu form them;
//   kDense  constants: per tile (the TPU fetches them per sub at sub_tile)
//           or the caller's dense (4·B, 8, 256) gather, read per sub;
//   S       store: kCols (one store per column) or kRow (the 48-byte row
//           as three float4 stores; catstore);
//   kZero   zeroing: the caller zeroes dpay and the kernel writes columns
//           0-8 of the rows it computes, or the kernel writes every row of
//           the covered blocks once (nozero, all: columns 9-11 and the rows
//           it does not compute as zeros; extra CTAs after the tiles' zero
//           the rows of blocks that do not compute).
// The TPU's GROUP has no counterpart here (a CTA per tile has no grid
// step): the wrapper passes the blocks its grid covers, (B // group)·group,
// as n_blocks. nogrows (the TPU's implicit broadcast of the per-sub
// constants) has none either: the constants are held per pixel in shared
// memory in every form, so nogrows runs colstore's code.
//
// Design: composite_bwd.cu's (kernel 4), with the variant's quantities.
//   - One CTA of 8 warps per tile; warp w owns the tile's pixels
//     32w..32w+31, and within a sub lane i owns entry i, whose payload row
//     it holds in registers. Warp 0 finds the tile's run of subs among the
//     computed blocks by warp-wide searches over sub_valid and sub_tile.
//   - The warp visits its pixels two at a time, j and j + 16, in 4-bit
//     bit-reversed j. At each pixel the lanes compute α_i, then the
//     Hillis-Steele prefix product of (1 − α) and prefix sum of w·φ run
//     across lanes with __shfl_up_sync (lane i ≥ K takes c_i·c_{i−K}: the
//     operands of the plain version's Hillis-Steele rounds for entry i), so T,
//     alive, done and every dpower are the bits the thread-per-pixel form
//     computes (the build uses -fmad=false).
//   - Each quantity's per-entry sum over the warp's 32 pixels is the tree
//     of kernels/ablate.py pixel_tree_sum: pixels p and p + 16 first, then
//     + 8, + 4, + 2, + 1. The pair (j, j + 16) is its first level, and the
//     bit-reversed order makes every further level join two neighbours, as
//     a binary counter carries: two leaves are joined in registers, at most
//     3 pending partials per quantity wait in shared memory.
//   - A pixel's T and running prefix P live in shared memory beside its
//     constants (sfx = total_phi + T_final·g_T, g_r, g_g, g_b); its done
//     flag is a bit of a warp-uniform mask, updated through a ballot. alive,
//     the mask and [α_raw < 0.99] are selects, not 0/1 factors: the same
//     bits, or +0 where a multiply gave ±0. A pair of done pixels, and a
//     pair no entry touches, adds an exact 0 to its leaf.
//   - The 8 warps' sums meet in shared memory (double-buffered, one barrier
//     per sub) and are added in warp order; the chain rules are spread over
//     the warps, one output column (or the colour columns) each, lane =
//     entry, in the first port's operand order.
// The block rules. A sub after the tile is saturated (all 256 pixels done)
// adds ±0 to every sum, so the CTA stops there, as kernel 4 does (the TPU
// skips such a block, or computes ±0 rows in a block it does not skip).
// full and no_prefix advance the state from block to block; the other
// variants never write it, so a sub of a block after its run's first block
// starts from T = done = P = 0, where every term is ±0: their CTA walks
// only the run's first block (runs still chain from sub to sub inside it).
// The rows a CTA does not walk are the caller's zeros, or under kZero
// written as zeros once. Each row is written by one thread and no atomics
// are used, so two launches are bit-identical. The results equal the plain
// version's up to the sign of a zero.
//
// Bound on the H100: fp32 operations per (entry, pixel) pair before each
// 32-pixel strip is done (msgs_torch/tools/work.py counts each variant and
// form from this source); the payload, dpay and the constant rows are read
// or written once. __launch_bounds__ asks for 3 CTAs per SM (at most 80
// registers); shared memory is static (≤ 43 KB a CTA).
#include <cuda_bf16.h>

#include "ablate_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace msgs_composite;
using namespace msgs_ablate;

constexpr int kWarps = kPix / 32;   // 8
constexpr int kMom = 6;             // pixel-monomial moments
constexpr int kPhi = 3;             // image-only colour terms r g b
constexpr int kStep = 2;            // pixels a warp takes at once
constexpr int kPairs = 32 / kStep;  // leaves of a warp's tree
constexpr int kPend = 2;            // pending levels in shared memory

// kernels/ablate.py BWD_VARIANTS.
enum Variant { kFull = 0, kGeomNostore, kGeomConcat, kNoGeom, kNoPrefix,
               kRecomputeOnly };
// kernels/ablate.py MOMENTS.
enum Moments { kBf16 = 0, kDotF32, kVpu };
enum Store { kCols = 0, kRow };
constexpr int kZeroCtas = 264;   // CTAs that zero the uncomputed blocks

// Per-entry sums: Σ w; or Σ dpower and the 3 colour sums; or the 6
// moments and the 3 colour sums.
template <int V>
__host__ __device__ constexpr int n_quantities() {
  return V == kRecomputeOnly ? 1 : V == kNoGeom ? 1 + kPhi : kMom + kPhi;
}

// One Hillis-Steele round of stride K across the warp's lanes.
template <int K>
__device__ __forceinline__ float lane_mul_round(float c, int lane) {
  const float o = __shfl_up_sync(kAll, c, K);
  return lane >= K ? c * o : c;
}

template <int K>
__device__ __forceinline__ float lane_add_round(float c, int lane) {
  const float o = __shfl_up_sync(kAll, c, K);
  return lane >= K ? c + o : c;
}

// The per-pixel terms of the variant's quantities for entry `lane` at one
// pixel: the moment form M of dpower, then w·g_c.
template <int V, int M>
__device__ __forceinline__ void pixel_terms(float w, float dp, const float* g,
                                            float pxl, float pyl,
                                            float* term) {
  if (V == kRecomputeOnly) {
    term[0] = w;
    return;
  }
  if (V == kNoGeom) {
    term[0] = dp;
#pragma unroll
    for (int ch = 0; ch < kPhi; ++ch) term[1 + ch] = w * g[ch];
    return;
  }
  if (M == kDotF32) {
    term[0] = dp * (pxl * pxl);   // x²
    term[1] = dp * (pxl * pyl);   // xy
    term[2] = dp * (pyl * pyl);   // y²
    term[3] = dp * pxl;           // x
    term[4] = dp * pyl;           // y
    term[5] = dp;                 // 1
  } else {
    // kBf16 rounds dpower to bf16 first; kVpu takes it as it is. Both form
    // (dp·x)·x, (dp·x)·y and (dp·y)·y.
    const float d =
        M == kBf16 ? __bfloat162float(__float2bfloat16_rn(dp)) : dp;
    term[0] = d * pxl * pxl;
    term[1] = d * pxl * pyl;
    term[2] = d * pyl * pyl;
    term[3] = d * pxl;
    term[4] = d * pyl;
    term[5] = d;
  }
#pragma unroll
  for (int ch = 0; ch < kPhi; ++ch) term[kMom + ch] = w * g[ch];
}

// The warp's pixels j and j + 16, for entry `lane` of the sub: the
// forward's recompute, dα and dpower, and x[q] = term_q(j) + term_q(j+16)
// for each quantity (the tree's leaf); each pixel's T and P in shared
// memory and its bit of done_mask updated. A pixel that is already done
// takes part with not_done = 0, as in the forward. Returns false, with x
// untouched, when no entry touches a pixel of the pair that is not done.
template <int V, int M>
__device__ __forceinline__ bool pair_step(
    const float (&ent)[kFeat], float ox, float oy, int lane, int warp,
    int j, const float4* pconst, float2* tp, unsigned& done_mask,
    float (&x)[n_quantities<V>()]) {
  constexpr int kQ = n_quantities<V>();
  constexpr bool kDpower = V != kRecomputeOnly;
  constexpr bool kPrefix = kDpower && V != kNoPrefix;
  const float kTEps = t_eps();
  int jj[kStep], pj[kStep];
  float pxl[kStep], pyl[kStep], nd[kStep], araw[kStep], al[kStep];
  bool touched = false;
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    jj[u] = j + (32 / kStep) * u;
    pj[u] = (warp << 5) + jj[u];
    pxl[u] = (float)(pj[u] % kTile);
    pyl[u] = (float)(pj[u] / kTile);
    nd[u] = (done_mask >> jj[u]) & 1u ? 0.0f : 1.0f;
    al[u] = splat_alpha(ent, ox, oy, pxl[u], pyl[u], araw[u]);
    touched = touched || (al[u] > 0.0f && nd[u] > 0.0f);
  }
  if (__ballot_sync(kAll, touched) == 0u) return false;

  float cu[kStep];
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = 1.0f - al[u];
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = lane_mul_round<1>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = lane_mul_round<2>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = lane_mul_round<4>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = lane_mul_round<8>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < kStep; ++u) cu[u] = lane_mul_round<16>(cu[u], lane);

  float wp[kStep], w[kStep], tphi[kStep], ta[kStep], t_in[kStep];
  float p_in[kStep], sfx[kStep], g[kStep][kPhi], t_last[kStep];
  bool alive[kStep];
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    const float ce_up = __shfl_up_sync(kAll, cu[u], 1);
    const float ce = lane == 0 ? 1.0f : ce_up;
    const float2 st = tp[pj[u]];               // T, P
    t_in[u] = st.x;
    p_in[u] = st.y;
    t_last[u] = t_in[u] * __shfl_sync(kAll, cu[u], 31);
    ta[u] = t_in[u] * cu[u];
    alive[u] = ta[u] >= kTEps && nd[u] > 0.0f;
    // α·T·cum_excl·alive with alive ∈ {0, 1} and every factor ≥ 0: the
    // product itself or +0, the same bits as the multiply.
    w[u] = alive[u] ? al[u] * t_in[u] * ce : 0.0f;
    if (kDpower) {
      const float4 c = pconst[pj[u]];          // sfx, g_r, g_g, g_b
      sfx[u] = c.x;
      g[u][0] = c.y;
      g[u][1] = c.z;
      g[u][2] = c.w;
      float phi = g[u][0] * ent[F_R];
#pragma unroll
      for (int ch = 1; ch < kPhi; ++ch) phi = phi + g[u][ch] * ent[F_R + ch];
      const float t_i = t_in[u] * ce;
      tphi[u] = t_i * phi;
      wp[u] = w[u] * phi;
    }
  }
  if (kPrefix) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) wp[u] = lane_add_round<1>(wp[u], lane);
#pragma unroll
    for (int u = 0; u < kStep; ++u) wp[u] = lane_add_round<2>(wp[u], lane);
#pragma unroll
    for (int u = 0; u < kStep; ++u) wp[u] = lane_add_round<4>(wp[u], lane);
#pragma unroll
    for (int u = 0; u < kStep; ++u) wp[u] = lane_add_round<8>(wp[u], lane);
#pragma unroll
    for (int u = 0; u < kStep; ++u) wp[u] = lane_add_round<16>(wp[u], lane);
  }

  float term[kStep][kQ];
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    float dp = 0.0f;
    if (kDpower) {
      // (T_i·φ − S/(1−α))·alive·mask·α·unclamped with 0/1 factors as
      // selects: the same bits, or +0 where the multiplies give ±0.
      // no_prefix takes the row's own w·φ for the prefix.
      const float suffix = kPrefix ? sfx[u] - (p_in[u] + wp[u])
                                   : sfx[u] - wp[u];
      const float d_alpha = alive[u] && al[u] > 0.0f
                                ? tphi[u] - suffix / (1.0f - al[u]) : 0.0f;
      dp = araw[u] < alpha_max() ? d_alpha * al[u] : 0.0f;
    }
    pixel_terms<V, M>(w[u], dp, g[u], pxl[u], pyl[u], term[u]);

    // The pixel's new T (the minimum of non-negative floats, as unsigned
    // bits), P and done, as the forward leaves them.
    const float tmin = __uint_as_float(__reduce_min_sync(
        kAll, __float_as_uint(alive[u] ? ta[u] : t_in[u])));
    float p_out = p_in[u];
    if (kPrefix) p_out = p_in[u] + __shfl_sync(kAll, wp[u], 31);
    if (lane == 0) tp[pj[u]] = make_float2(tmin, p_out);
    // Through a ballot, so the compiler sees the mask as warp-uniform.
    if (__ballot_sync(kAll, t_last[u] < kTEps)) done_mask |= 1u << jj[u];
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) x[q] = term[0][q] + term[1][q];
  return true;
}

// Rows [k0, k1) of dpay as zeros, by the CTA's threads.
__device__ __forceinline__ void zero_rows(float* dpay, int k0, int k1) {
  float4* d = reinterpret_cast<float4*>(dpay + (long long)k0 * (kSub * kFeat));
  const int n = (k1 - k0) * (kSub * kFeat / 4);
  for (int i = threadIdx.x; i < n; i += kPix)
    d[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Warp `warp`'s share of the chain rules and stores for entry `lane` of
// the sub whose dpay row is d, from the warps' sums pb[q·256 + 32·w].
template <int V, int S, bool kZero>
__device__ __forceinline__ void store_rows(const float* pb,
                                           const float (&ent)[kFeat],
                                           float ox, float oy, int warp,
                                           float* d) {
  auto sum = [&](int q) {
    float a = pb[q * kPix];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) a = a + pb[q * kPix + wp * 32];
    return a;
  };
  if (V == kRecomputeOnly) {
    if (warp == 0) d[0] = sum(0);
    return;
  }
  if (V == kNoGeom) {
    if (warp == 0) d[0] = sum(0);
    if (warp == 1) {
#pragma unroll
      for (int ch = 0; ch < kPhi; ++ch) d[F_R + ch] = sum(1 + ch);
    }
    return;
  }
  const float mxl = ent[F_MX] - ox;
  const float myl = ent[F_MY] - oy;
  auto d_mx = [&](float q10, float q01, float q00) {
    return ent[F_CXX] * (q10 - mxl * q00) + ent[F_CXY] * (q01 - myl * q00);
  };
  auto d_my = [&](float q10, float q01, float q00) {
    return ent[F_CYY] * (q01 - myl * q00) + ent[F_CXY] * (q10 - mxl * q00);
  };
  auto d_cxx = [&](float q20, float q10, float q00) {
    return -0.5f * (q20 - 2.0f * mxl * q10 + mxl * mxl * q00);
  };
  auto d_cxy = [&](float q11, float q10, float q01, float q00) {
    return -(q11 - myl * q10 - mxl * q01 + mxl * myl * q00);
  };
  auto d_cyy = [&](float q02, float q01, float q00) {
    return -0.5f * (q02 - 2.0f * myl * q01 + myl * myl * q00);
  };
  auto d_op = [&](float q00) {
    const float op = ent[F_OP];
    return op > 0.0f ? q00 / fmaxf(op, 1e-30f) : 0.0f;
  };
  if (V == kGeomNostore) {
    if (warp == 0) {
      const float q20 = sum(0), q11 = sum(1), q02 = sum(2);
      const float q10 = sum(3), q01 = sum(4), q00 = sum(5);
      d[0] = d_mx(q10, q01, q00) + d_my(q10, q01, q00) +
             d_cxx(q20, q10, q00) + d_cxy(q11, q10, q01, q00) +
             d_cyy(q02, q01, q00) + d_op(q00) +
             (((0.0f + sum(kMom)) + sum(kMom + 1)) + sum(kMom + 2));
    }
    return;
  }
  if (S == kRow) {
    float4* d4 = reinterpret_cast<float4*>(d);
    if (warp == 0) {
      const float q20 = sum(0), q11 = sum(1);
      const float q10 = sum(3), q01 = sum(4), q00 = sum(5);
      d4[0] = make_float4(d_mx(q10, q01, q00), d_my(q10, q01, q00),
                          d_cxx(q20, q10, q00), d_cxy(q11, q10, q01, q00));
    } else if (warp == 1) {
      const float q02 = sum(2), q01 = sum(4), q00 = sum(5);
      d4[1] = make_float4(d_cyy(q02, q01, q00), d_op(q00), sum(kMom),
                          sum(kMom + 1));
    } else if (warp == 2) {
      d4[2] = make_float4(sum(kMom + 2), 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  switch (warp) {
    case 0:
      d[F_MX] = d_mx(sum(3), sum(4), sum(5));
      break;
    case 1:
      d[F_MY] = d_my(sum(3), sum(4), sum(5));
      break;
    case 2:
      d[F_CXX] = d_cxx(sum(0), sum(3), sum(5));
      break;
    case 3:
      d[F_CXY] = d_cxy(sum(1), sum(3), sum(4), sum(5));
      break;
    case 4:
      d[F_CYY] = d_cyy(sum(2), sum(4), sum(5));
      break;
    case 5:
      d[F_OP] = d_op(sum(5));
      break;
    case 6:
#pragma unroll
      for (int ch = 0; ch < kPhi; ++ch) d[F_R + ch] = sum(kMom + ch);
      break;
    default:
      // kZero writes every column once, 9-11 as zeros.
      if (kZero) {
#pragma unroll
        for (int col = F_R + kPhi; col < kFeat; ++col) d[col] = 0.0f;
      }
      break;
  }
}

template <int V, int M, bool kDense, int S, bool kZero>
__global__ void __launch_bounds__(kPix, 3)
bwd_ablate_kernel(const float* __restrict__ payload,
                  const int* __restrict__ sub_tile,
                  const int* __restrict__ sub_valid,
                  const float* __restrict__ cst, float* __restrict__ dpay,
                  int n_blocks, int tiles, int tiles_x, int width,
                  int height) {
  constexpr int kQ = n_quantities<V>();
  constexpr bool kAdvance = V == kFull || V == kNoPrefix;
  constexpr bool kConst = V != kRecomputeOnly;
  __shared__ float4 pconst[kPix];          // per pixel: sfx, g_r, g_g, g_b
  __shared__ float2 tp[kPix];              // per pixel: T, P
  // pend[l][q][tid]: the tree's pending nodes of levels 2 and 3;
  // part[b][q][warp·32 + lane]: the warps' sums, and the level-4 node
  // while the warp walks its pixels.
  __shared__ float pend[kPend * kQ * kPix];
  __shared__ float part[2 * kQ * kPix];
  __shared__ int run[2];

  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  if (warp == 0) {
    // A tile's run, or (a zeroing CTA) the computed blocks.
    const int2 r =
        (int)blockIdx.x < tiles
            ? tile_run(sub_tile, sub_valid, n_blocks, blockIdx.x, lane)
            : make_int2(computed_blocks(sub_valid, n_blocks, lane), 0);
    if (lane == 0) {
      run[0] = r.x;
      run[1] = r.y;
    }
  }
  __syncthreads();
  if (kZero && (int)blockIdx.x >= tiles) {
    // Rows of blocks [nb, n_blocks) as zeros, the blocks strided over the
    // zeroing CTAs.
    for (int b = run[0] + blockIdx.x - tiles; b < n_blocks;
         b += gridDim.x - tiles)
      zero_rows(dpay, b * kNSub, (b + 1) * kNSub);
    return;
  }
  const int tile = blockIdx.x;
  const int s0 = run[0], s1 = run[1];
  if (s0 >= s1) return;
  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;

  // Pixel p's constants (tools/exp_fwd_ablate.py:257-264): the suffix base
  // total_phi + T_final·g_T and g_r g_g g_b, per tile or (dense) per sub.
  // A warp only ever reads its own pixels' entries, so __syncwarp orders
  // them. T starts at 1 and P at 0.
  auto constants = [&](long long row) {
    const float* c = cst + row * (kOut * kPix) + p;
    pconst[p] = make_float4(c[5 * kPix] + c[6 * kPix], c[0], c[kPix],
                            c[2 * kPix]);
  };
  if (kConst && !kDense) constants(tile);
  tp[p] = make_float2(1.0f, 0.0f);
  const float pxl_own = (float)(p % kTile);
  const float pyl_own = (float)(p / kTile);
  unsigned done_mask = __ballot_sync(
      kAll, (pxl_own + ox) >= (float)width || (pyl_own + oy) >= (float)height);
  __syncwarp();

  // Variants that do not advance the state walk the run's first block only.
  const int s_end = kAdvance ? s1 : min(s1, (s0 / kNSub + 1) * kNSub);
  int k = s0;
  while (k < s_end) {
    // Entry `lane` of sub k, in registers.
    const float* e = payload + ((long long)k * kSub + lane) * kFeat;
    float ent[kFeat];
#pragma unroll
    for (int col = 0; col < kFeat; ++col) ent[col] = __ldg(e + col);
    if (kConst && kDense) {
      constants(k);
      __syncwarp();
    }

    float* buf = part + ((k - s0) & 1) * kQ * kPix;
    float* mine = buf + p;   // level 4, then the warp's sum
    if (done_mask == kAll) {
      // Every term of every pixel is ±0.
#pragma unroll
      for (int q = 0; q < kQ; ++q) mine[q * kPix] = 0.0f;
    } else {
      for (int r2 = 0; r2 < kPairs / 2; ++r2) {
        // Leaves 2·r2 and 2·r2 + 1 (pairs j and j + 8), joined here.
        float x[2][kQ];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = (int)(__brev((unsigned)(2 * r2 + h)) >> 28);
          const unsigned two = (1u << j) | (1u << (j + 32 / kStep));
          if ((done_mask & two) == two ||
              !pair_step<V, M>(ent, ox, oy, lane, warp, j, pconst, tp,
                               done_mask, x[h])) {
#pragma unroll
            for (int q = 0; q < kQ; ++q) x[h][q] = 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) x[0][q] = x[0][q] + x[1][q];
        // Join the node to its pending left neighbours, as a binary
        // counter carries: r2's trailing ones are the levels it completes.
        int l = 0;
        for (; (r2 >> l) & 1; ++l) {
          const float* s = l < kPend ? pend + l * kQ * kPix + p : mine;
#pragma unroll
          for (int q = 0; q < kQ; ++q) x[0][q] = s[q * kPix] + x[0][q];
        }
        float* s = l < kPend ? pend + l * kQ * kPix + p : mine;
#pragma unroll
        for (int q = 0; q < kQ; ++q) s[q * kPix] = x[0][q];
      }
    }

    // One barrier: the partials are complete, and the last one tells
    // whether every pixel of the tile is done.
    const bool all_done = __syncthreads_and(done_mask == kAll);
    store_rows<V, S, kZero>(buf + lane, ent, ox, oy, warp,
                            dpay + ((long long)k * kSub + lane) * kFeat);
    ++k;
    if (all_done) break;
  }
  if (kZero) zero_rows(dpay, k, s1);
}

// One built instance: its kernel, launch and build info.
template <int V, int M = kBf16, bool kDense = false, int S = kCols,
          bool kZero = false>
struct Inst {
  static int launch(const float* pay, const int* st, const int* sv,
                    const float* cst, float* dpay, int n_blocks, int tiles,
                    int tiles_x, int width, int height, cudaStream_t s) {
    bwd_ablate_kernel<V, M, kDense, S, kZero>
        <<<tiles + (kZero ? kZeroCtas : 0), kPix, 0, s>>>(
            pay, st, sv, cst, dpay, n_blocks, tiles, tiles_x, width, height);
    return (int)cudaGetLastError();
  }
  static int info(int* out) {
    return fill_kernel_info(bwd_ablate_kernel<V, M, kDense, S, kZero>, kPix,
                            0, out);
  }
};

// The instances built, in kernels/ablate.py BWD_INSTANCES' order: the
// forms of full (ablate.BUILT_FORMS), then the other variants.
template <typename F>
int with_instance(int i, F&& f) {
  switch (i) {
    case 0: return f(Inst<kFull>());                          // bwd/full
    case 1: return f(Inst<kFull, kVpu>());                    // geom_vpu
    case 2: return f(Inst<kFull, kDotF32, true>());           // cst_dense
    case 3: return f(Inst<kFull, kVpu, true>());   // geom_vpu+cst_dense
    case 4: return f(Inst<kFull, kDotF32>());                 // g16
    case 5: return f(Inst<kFull, kVpu, false, kRow>());       // catstore
    case 6: return f(Inst<kFull, kVpu, false, kCols, true>());  // nozero
    case 7: return f(Inst<kFull, kVpu, false, kRow, true>());   // all
    case 8: return f(Inst<kGeomNostore>());
    case 9: return f(Inst<kGeomConcat>());
    case 10: return f(Inst<kNoGeom>());
    case 11: return f(Inst<kNoPrefix>());
    case 12: return f(Inst<kRecomputeOnly>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int msgs_bwd_ablate(const void* payload, const void* sub_tile,
                               const void* sub_valid, const void* cst,
                               void* dpay, int n_blocks, int instance,
                               int tiles, int tiles_x, int width, int height,
                               void* stream) {
  if (n_blocks <= 0 || tiles <= 0) return 0;
  return with_instance(instance, [&](auto inst) {
    return decltype(inst)::launch(
        (const float*)payload, (const int*)sub_tile, (const int*)sub_valid,
        (const float*)cst, (float*)dpay, n_blocks, tiles, tiles_x, width,
        height, (cudaStream_t)stream);
  });
}

// An instance's build: registers, stack bytes, static and dynamic shared
// memory, and CTAs per SM at its launch configuration.
extern "C" int msgs_bwd_ablate_info(int instance, int* out) {
  return with_instance(instance,
                       [&](auto inst) { return decltype(inst)::info(out); });
}
