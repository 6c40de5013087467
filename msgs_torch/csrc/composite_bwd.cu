// Tile compositor, backward: per-entry gradients of the 11 payload columns
// F_MX..F_PSIZE from the forward output and its cotangent. The plain
// version is msgs_torch/kernels/composite.py:composite_bwd_reference.
//
// Replaces msgs/kernels/composite.py:_bwd_kernel (launched by
// _composite_bwd_call). The TPU kernel walks payload blocks in grid order
// with (T, done, wφ-prefix) in VMEM scratch, reads per-sub constant rows
// [g_rgb, g_depth, g_acc, total_phi, T_final·g_T] pre-gathered by the
// caller, and sums each entry's per-pixel terms with lane reductions. Here
// one CTA owns one tile and walks its sub-blocks [first_sub, first_sub +
// n_sub) in order; each pixel's constants (total_phi + T_final·g_T and its
// cotangent) are built once from its forward output, so no per-tile
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
// moments of dpower (dp·x·x, dp·x·y, dp·y·y, dp·x, dp·y, dp; tile-local)
// and of w·g_c give d{mean2D, conic, opacity} by the chain rules of
// :656-671 and d{colour columns}.
//
// Design (the layout of composite_bwd_bf16.cu, with exact f32 operands):
//   - one CTA of 8 warps per tile; warp w owns the tile's pixels
//     32w..32w+31 (rows 2w, 2w+1), and within a sub-block lane i owns
//     entry i, whose payload row it holds in registers;
//   - the warp visits its pixels two at a time, j and j + 16 (the same
//     column of its two rows), whose chains interleave. At each pixel the
//     lanes compute α_i, then the 5-round Hillis-Steele prefix product of
//     (1 − α) and prefix sum of w·φ run across lanes with __shfl_up_sync
//     (lane i ≥ K takes c_i·c_{i−K}, c_i + c_{i−K}: the operands of the
//     plain version's Hillis-Steele rounds for entry i), so T, alive, done
//     and every dpower are the bits the thread-per-pixel form computes;
//   - the per-entry sum of each quantity over the warp's 32 pixels is the
//     tree of the first port's warp butterfly (kernels/ablate.py
//     pixel_tree_sum): pixels p and p^16 first, then across bits 3, 2, 1
//     and 0 of the pixel. The pair (j, j+16) is its first level; visiting j in 4-bit
//     bit-reversed order (0, 8, 4, 12, 2, ...) makes every further level
//     join two neighbours, as a binary counter does: two leaves in a row
//     are joined in registers, and at most 3 pending partials per quantity
//     wait in shared memory (the last level's in the warp's own slot of
//     the partials buffer, free until the sub-block ends). IEEE addition
//     is commutative, so the same tree gives the same bits;
//   - a pixel's T and running prefix P live in shared memory beside its
//     constants, read as warp-wide broadcasts; its done flag is a bit of a
//     warp-uniform mask, updated through a ballot so that the compiler
//     sees it uniform (updated from a per-lane compare, it gave every
//     shuffle the divergent-warp lowering, WARPSYNC and all). alive, mask
//     and [α_raw < 0.99] are selects, not 0/1 factors: the same bits, or
//     +0 where a multiply gave ±0. A pair of done pixels, and a pair that
//     no entry touches where it is not done (every α = 0: T, done and P
//     unchanged, every term ±0), is a warp-uniform skip that adds an exact
//     0 to its leaf of the tree; a done pixel paired with one that is not
//     takes part with not_done = 0, as in the forward. Skipping changes at
//     most the sign of a zero;
//   - the 8 warps' sums meet in shared memory (double-buffered, so one
//     barrier per sub-block) and are added in warp order; the chain rules
//     are spread over the warps, one output column (or the colour columns)
//     each, lane = entry, in the first port's operand order.
// __launch_bounds__ asks for 3 CTAs per SM (at most 85 registers; both
// instances build without a stack). The kernel is deterministic and needs
// no atomics. It stops where the forward stopped (all 256 pixels done);
// the wrapper zeroes dpay, so the rows of skipped and invalid sub-blocks,
// and the columns the kernel does not compute, read 0.
//
// Bound on the H100: fp32 operations per (entry, pixel) pair before each
// 32-pixel strip is done — the forward's 31 without its colour sums,
// recomputed, and 36 more under image_only (44 otherwise; 67 and 75 in
// all, counted in chip_smoke.py OPS_PER_PAIR_BWD); the payload, dpay,
// forward output and cotangent are read or written once.
#include <atomic>

#include "composite_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace msgs_composite;

constexpr int kWarps = kPix / 32;   // 8
constexpr int kMom = 6;             // pixel-monomial moments
constexpr int kStep = 2;            // pixels a warp takes at once
constexpr int kPairs = 32 / kStep;  // leaves of a warp's tree
constexpr int kPend = 2;            // pending levels in shared memory
constexpr unsigned kAll = 0xffffffffu;

// Dynamic shared memory: kPend pending levels and 2 partial buffers, each
// kQ quantities × 256 (warp, lane) slots.
template <int NF>
constexpr size_t dyn_smem() {
  return (size_t)(kPend + 2) * (kMom + NF) * kPix * sizeof(float);
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

// The warp's pixels j and j + 16, for entry `lane` of the sub-block: the
// forward's recompute, dα and dpower, and x[q] = term_q(j) + term_q(j+16)
// for each quantity (the tree's leaf); each pixel's T and P in shared
// memory and its bit of done_mask updated. A pixel that is already done
// takes part with not_done = 0, as in the forward. Returns false, with x
// untouched, when no entry touches a pixel of the pair that is not done.
template <int NF>
__device__ __forceinline__ bool pair_step(
    const float (&ent)[kFeat], float ox, float oy, int lane, int warp,
    int j, const float4* pconst, float2* tp, unsigned& done_mask,
    float (&x)[kMom + NF]) {
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

  float wp[kStep], w[kStep], tphi[kStep], ta[kStep];
  float t_in[kStep], p_in[kStep], sfx[kStep], g[kStep][NF], t_last[kStep];
  bool alive[kStep];
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    const float ce_up = __shfl_up_sync(kAll, cu[u], 1);
    const float ce = lane == 0 ? 1.0f : ce_up;
    const float4 c0 = pconst[2 * pj[u]];       // sfx, g_r, g_g, g_b
    const float2 st = tp[pj[u]];               // T, P
    t_in[u] = st.x;
    p_in[u] = st.y;
    sfx[u] = c0.x;
    g[u][0] = c0.y;
    g[u][1] = c0.z;
    g[u][2] = c0.w;
    if (NF > 3) {
      const float4 c1 = pconst[2 * pj[u] + 1];  // g_depth, g_acc
      g[u][NF > 3 ? 3 : 0] = c1.x;
      g[u][NF > 4 ? 4 : 0] = c1.y;
    }
    t_last[u] = t_in[u] * __shfl_sync(kAll, cu[u], 31);
    ta[u] = t_in[u] * cu[u];
    alive[u] = ta[u] >= kTEps && nd[u] > 0.0f;
    // α·T·cum_excl·alive with alive ∈ {0, 1} and every factor ≥ 0: the
    // product itself or +0, the same bits as the multiply.
    w[u] = alive[u] ? al[u] * t_in[u] * ce : 0.0f;
    float phi = g[u][0] * ent[F_R];
#pragma unroll
    for (int ch = 1; ch < NF; ++ch) phi = phi + g[u][ch] * ent[F_R + ch];
    const float t_i = t_in[u] * ce;
    tphi[u] = t_i * phi;
    wp[u] = w[u] * phi;
  }
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

  float term[kStep][kMom + NF];
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    // (T_i·φ − S/(1−α))·alive·mask·α·unclamped with 0/1 factors as
    // selects: the same bits, or +0 where the multiplies give ±0.
    const float suffix = sfx[u] - (p_in[u] + wp[u]);
    const float d_alpha = alive[u] && al[u] > 0.0f
                              ? tphi[u] - suffix / (1.0f - al[u]) : 0.0f;
    const float dp = araw[u] < alpha_max() ? d_alpha * al[u] : 0.0f;
    term[u][0] = dp * pxl[u] * pxl[u];   // x²
    term[u][1] = dp * pxl[u] * pyl[u];   // xy
    term[u][2] = dp * pyl[u] * pyl[u];   // y²
    term[u][3] = dp * pxl[u];            // x
    term[u][4] = dp * pyl[u];            // y
    term[u][5] = dp;                     // 1
#pragma unroll
    for (int ch = 0; ch < NF; ++ch) term[u][kMom + ch] = w[u] * g[u][ch];

    // The pixel's new T (the minimum of non-negative floats, as unsigned
    // bits), P and done, as the forward leaves them.
    const float tmin = __uint_as_float(__reduce_min_sync(
        kAll, __float_as_uint(alive[u] ? ta[u] : t_in[u])));
    const float p_last = __shfl_sync(kAll, wp[u], 31);
    if (lane == 0) tp[pj[u]] = make_float2(tmin, p_in[u] + p_last);
    // Through a ballot, so the compiler sees the mask as warp-uniform (the
    // shuffles need no divergent-warp lowering).
    if (__ballot_sync(kAll, t_last[u] < kTEps)) done_mask |= 1u << jj[u];
  }
#pragma unroll
  for (int q = 0; q < kMom + NF; ++q) x[q] = term[0][q] + term[1][q];
  return true;
}

template <int NF>
__global__ void __launch_bounds__(kPix, 3)
composite_bwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ first_sub,
                     const int* __restrict__ n_sub,
                     const float* __restrict__ res,
                     const float* __restrict__ cot,
                     float* __restrict__ dpay,
                     int tiles_x, int width, int height) {
  constexpr int kQ = kMom + NF;
  __shared__ float4 pconst[2 * kPix];              // per pixel, see below
  __shared__ float2 tp[kPix];                      // per pixel: T, P
  // pend[l][q][tid]: the tree's pending nodes of levels 2 and 3;
  // part[b][q][warp·32 + lane]: the warps' sums, and the level-4 node
  // while the warp walks its pixels.
  extern __shared__ float dyn[];
  float* pend = dyn;
  float* part = dyn + kPend * kQ * kPix;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;

  // Pixel p's constants: total_phi + T_final·g_T (the JAX form, :612-615)
  // and the cotangent rows; its T starts at 1 and P at 0. A warp only ever
  // reads its own pixels' entries, so __syncwarp orders them.
  {
    const float* r = res + (long long)tile * (kOut * kPix) + p;
    const float* c = cot + (long long)tile * (kOut * kPix) + p;
    float g[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) g[ch] = c[ch * kPix];
    // _composite_bwd_call's constant rows (:806-809), per pixel.
    const float total_phi = (r[0] * g[0] + r[kPix] * g[1]) +
                            r[2 * kPix] * g[2] + r[O_DEPTH * kPix] * g[3] +
                            r[O_ACC * kPix] * g[4];
    const float sfx = total_phi + r[O_T * kPix] * c[O_T * kPix];
    pconst[2 * p] = make_float4(sfx, g[0], g[1], g[2]);
    pconst[2 * p + 1] = make_float4(g[3], g[4], 0.0f, 0.0f);
    tp[p] = make_float2(1.0f, 0.0f);
  }
  const float pxl_own = (float)(p % kTile);
  const float pyl_own = (float)(p / kTile);
  unsigned done_mask = __ballot_sync(
      kAll, (pxl_own + ox) >= (float)width || (pyl_own + oy) >= (float)height);
  __syncwarp();

  const int s0 = first_sub[tile];
  const int ns = n_sub[tile];
  for (int k = 0; k < ns; ++k) {
    // Entry `lane` of the sub-block, in registers.
    const float* e = payload + ((long long)(s0 + k) * kSub + lane) * kFeat;
    float ent[kFeat];
#pragma unroll
    for (int col = 0; col < kFeat; ++col) ent[col] = __ldg(e + col);

    const int b = k & 1;
    float* mine = part + b * kQ * kPix + p;   // level 4, then the sum
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
              !pair_step<NF>(ent, ox, oy, lane, warp, j, pconst, tp,
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

    // Σ over the 8 warps, in warp order, of quantity q for entry `lane`.
    const float* pb = part + b * kQ * kPix + lane;
    auto sum = [&](int q) {
      float a = pb[q * kPix];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) a = a + pb[q * kPix + wp * 32];
      return a;
    };
    const float mxl = ent[F_MX] - ox;
    const float myl = ent[F_MY] - oy;
    float* d = dpay + ((long long)(s0 + k) * kSub + lane) * kFeat;
    switch (warp) {
      case 0: {
        const float q10 = sum(3), q01 = sum(4), q00 = sum(5);
        d[F_MX] = ent[F_CXX] * (q10 - mxl * q00) +
                  ent[F_CXY] * (q01 - myl * q00);
        break;
      }
      case 1: {
        const float q10 = sum(3), q01 = sum(4), q00 = sum(5);
        d[F_MY] = ent[F_CYY] * (q01 - myl * q00) +
                  ent[F_CXY] * (q10 - mxl * q00);
        break;
      }
      case 2: {
        const float q20 = sum(0), q10 = sum(3), q00 = sum(5);
        d[F_CXX] = -0.5f * (q20 - 2.0f * mxl * q10 + mxl * mxl * q00);
        break;
      }
      case 3: {
        const float q11 = sum(1), q10 = sum(3), q01 = sum(4), q00 = sum(5);
        d[F_CXY] = -(q11 - myl * q10 - mxl * q01 + mxl * myl * q00);
        break;
      }
      case 4: {
        const float q02 = sum(2), q01 = sum(4), q00 = sum(5);
        d[F_CYY] = -0.5f * (q02 - 2.0f * myl * q01 + myl * myl * q00);
        break;
      }
      case 5: {
        const float op = ent[F_OP];
        d[F_OP] = op > 0.0f ? sum(5) / fmaxf(op, 1e-30f) : 0.0f;
        break;
      }
      case 6:
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) d[F_R + ch] = sum(kMom + ch);
        break;
      default:
#pragma unroll
        for (int ch = 3; ch < NF; ++ch) d[F_R + ch] = sum(kMom + ch);
        break;
    }
    if (all_done) break;
  }
}

// Static and dynamic shared memory above 48 KB needs the kernel's
// attribute raised (on the current device); the launch and the occupancy
// query both depend on it.
template <int NF>
int prepare() {
  return (int)cudaFuncSetAttribute(
      composite_bwd_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn_smem<NF>());
}

// prepare() once per device and instance, so that a launch makes no CUDA
// API call beyond its own and cudaGetDevice (two threads may both set it:
// the call is idempotent).
constexpr int kMaxDevices = 64;

template <int NF>
int prepare_once() {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire))
    return 0;
  if (const int err = prepare<NF>()) return err;
  if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  return 0;
}

template <int NF>
int launch(const float* pay, const int* fs, const int* nsb, const float* rs,
           const float* ct, float* dp, int tiles, int tiles_x, int width,
           int height, cudaStream_t st) {
  if (const int err = prepare_once<NF>()) return err;
  composite_bwd_kernel<NF><<<tiles, kPix, dyn_smem<NF>(), st>>>(
      pay, fs, nsb, rs, ct, dp, tiles_x, width, height);
  return (int)cudaGetLastError();
}

template <int NF>
int info(int* out) {
  if (const int err = prepare<NF>()) return err;
  return fill_kernel_info(composite_bwd_kernel<NF>, kPix, dyn_smem<NF>(),
                          out);
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
    return launch<3>(pay, fs, nsb, rs, ct, dp, tiles, tiles_x, width, height,
                     st);
  return launch<5>(pay, fs, nsb, rs, ct, dp, tiles, tiles_x, width, height,
                   st);
}

// The kernel's build: registers, stack bytes, static and dynamic shared
// memory, and CTAs per SM at its launch configuration.
extern "C" int msgs_composite_bwd_info(int image_only, int* out) {
  return image_only ? info<3>(out) : info<5>(out);
}
