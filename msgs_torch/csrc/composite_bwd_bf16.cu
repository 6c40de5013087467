// Tile compositor, backward, bwd_bf16 variant: per-entry gradients of the
// payload columns F_MX..F_PSIZE with bf16 operands and f32 sums. The plain
// version is msgs_torch/kernels/composite.py:composite_bwd_bf16_reference.
//
// Replaces msgs/kernels/composite.py:_bwd_kernel with bwd_bf16=True
// (:490-519, :565-572, :602-606, :624-639, :706-760). The TPU kernel stages
// d_power, d_power·dx, d_power·dy and w as bf16 rows for a whole grid step
// in VMEM and contracts them on the MXU against the pixel basis [x, y, 1]
// and the cotangent columns.
//
// Bound on the H100: fp32 operations (the forward recompute and the
// per-pair φ, prefix, dα, dpower and moment arithmetic; counted in
// chip_smoke.py), ahead of the bytes (payload, dpay, forward output and
// cotangent once).
//
// Design. The first port (PR 3) ran one
// thread per pixel and staged four 32 × 256 bf16 matrices in shared memory
// for the tensor cores: 255 registers, a stack frame, 71,808 bytes of dynamic
// shared memory, so one 8-warp CTA per SM, and a warp-0 tail while 7 warps
// waited. Its measured split (PERF.md) put the time in the recompute
// and staging under that occupancy, not in the contractions, which are tiny
// (32 entries × 8 columns per pixel). This design turns the parallelism
// around and drops the staging, the MMA and two of the three barriers:
//
//   - one CTA of 8 warps per tile walks the tile's sub-blocks in order; warp
//     w owns the tile's pixels 32w..32w+31 (rows 2w, 2w+1), and within a
//     sub-block lane i owns entry i, whose payload row it holds in registers;
//   - the warp visits its 32 pixels two at a time (j and j + 16, the same
//     column of its two rows), whose independent chains of shuffles
//     interleave; that latency weighs most where tiles are few (the
//     trainer's 512², 1,024 tiles). At each pixel the lanes compute α_i,
//     then the 5-round
//     Hillis-Steele prefix product of (1 − α) and prefix sum of bf16(w·φ)
//     run across lanes with __shfl_up_sync: lane i ≥ K
//     takes c_i·c_{i−K} (c_i + c_{i−K}), the operands of the plain
//     version's Hillis-Steele rounds for entry i, so under -fmad=false T,
//     alive and done are the forward's bits and the CTA stops where the
//     forward stopped;
//   - each lane adds its entry's terms over the pixels in registers: the
//     moments Σ bf16(dp), Σ bf16(dp·dx)·[1, x, y], Σ bf16(dp·dy)·[1, y] of
//     the mean-centred dpower against the exact-in-bf16 basis, and
//     Σ bf16(w)·bf16(g_c). These are the contract's bf16 operands and exact
//     f32 products; only the order of the f32 sums differs from the plain
//     version's, which the contract allows;
//   - a pixel's T and running prefix P live in shared memory beside its
//     constants (total_phi + T_final·g_T and the bf16 cotangent rows), read
//     as warp-wide broadcasts; its done flag is a bit of a warp-uniform
//     mask. A pair of done pixels, and a pair that no entry of the
//     sub-block touches where it is not done (every α = 0: T, done and P
//     unchanged, every term 0), is a warp-uniform skip: it would add only
//     zeros. A done pixel paired with one that is not takes part with
//     not_done = 0, as in the forward, and adds zeros;
//   - the 8 warps' partial sums meet in shared memory (double-buffered, so
//     one barrier per sub-block) and are added in warp order; the chain
//     rules are spread over the warps, one output column (or the colour
//     columns) each, lane = entry:
//       q20 = m1x − mxl·q10, q11 = m1y − myl·q10, q02 = m2y − myl·q01,
//       d_mx = cxx·q10 + cxy·q01, d_my = cyy·q01 + cxy·q10,
//       d_cxx = −q20/2, d_cxy = −q11, d_cyy = −q02/2, d_op = q00/op.
//
// The kernel is deterministic: every sum runs in a fixed order, no atomics.
// The wrapper zeroes dpay, so the rows of skipped sub-blocks and the
// uncomputed columns read 0. The exact kernel (composite_bwd.cu) has the
// same shape, with f32 operands, its six raw moments, and each per-entry
// sum in the tree of the first port's butterfly, so its output keeps that
// port's bits.
#include <cuda_bf16.h>

#include "composite_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace msgs_composite;

constexpr int kWarps = kPix / 32;   // 8
constexpr int kMom = 6;             // q00, q10, m1x, m1y, q01, m2y
constexpr int kStep = 2;            // pixels a warp takes at once
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kDynSmem = 0;      // shared memory is static

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// A warp's step over U of its pixels at once (pixel j0 + 32/U·u, u < U),
// for entry `lane` of the sub-block: the forward's recompute, dα and
// dpower, and the entry's terms added into acc; each pixel's T and P in
// shared memory and its bit of done_mask updated. The U pixels' chains are
// independent, so their shuffles and arithmetic interleave. A pixel that
// is already done takes part with not_done = 0 and adds only zeros, as in
// the forward; the step is a warp-uniform no-op when no entry touches a
// pixel that is not done.
template <int NF, int U>
__device__ __forceinline__ void pixel_steps(
    const float (&ent)[kFeat], const float (&fb)[NF], float mxl, float myl,
    float ox, float oy, int lane, int warp, int j0, const float4* pconst,
    float2* tp, unsigned& done_mask, float (&acc)[kMom + NF]) {
  const float kTEps = t_eps();
  int j[U], pj[U];
  float pxl[U], pyl[U], nd[U], araw[U], al[U];
  bool touched = false;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    j[u] = j0 + (32 / U) * u;
    pj[u] = (warp << 5) + j[u];
    pxl[u] = (float)(pj[u] % kTile);
    pyl[u] = (float)(pj[u] / kTile);
    nd[u] = (done_mask >> j[u]) & 1u ? 0.0f : 1.0f;
    al[u] = splat_alpha(ent, ox, oy, pxl[u], pyl[u], araw[u]);
    touched = touched || (al[u] > 0.0f && nd[u] > 0.0f);
  }
  if (__ballot_sync(kAll, touched) == 0u) return;

  float cu[U];
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = 1.0f - al[u];
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = lane_mul_round<1>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = lane_mul_round<2>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = lane_mul_round<4>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = lane_mul_round<8>(cu[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) cu[u] = lane_mul_round<16>(cu[u], lane);

  float wp[U], w[U], tphi[U], ta[U], alive[U], t_in[U], p_in[U], sfx[U];
  float gb[U][NF], t_last[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float ce_up = __shfl_up_sync(kAll, cu[u], 1);
    const float ce = lane == 0 ? 1.0f : ce_up;
    const float4 c0 = pconst[2 * pj[u]];       // sfx, g_r, g_g, g_b (bf16)
    const float2 st = tp[pj[u]];               // T, P
    t_in[u] = st.x;
    p_in[u] = st.y;
    sfx[u] = c0.x;
    gb[u][0] = c0.y;
    gb[u][1] = c0.z;
    gb[u][2] = c0.w;
    if (NF > 3) {
      const float4 c1 = pconst[2 * pj[u] + 1];  // g_depth, g_acc (bf16)
      gb[u][NF > 3 ? 3 : 0] = c1.x;
      gb[u][NF > 4 ? 4 : 0] = c1.y;
    }
    t_last[u] = t_in[u] * __shfl_sync(kAll, cu[u], 31);
    ta[u] = t_in[u] * cu[u];
    alive[u] = (ta[u] >= kTEps ? 1.0f : 0.0f) * nd[u];
    w[u] = al[u] * t_in[u] * ce * alive[u];
    float phi = gb[u][0] * fb[0];
#pragma unroll
    for (int ch = 1; ch < NF; ++ch) phi = phi + gb[u][ch] * fb[ch];
    const float t_i = t_in[u] * ce;
    tphi[u] = t_i * phi;
    wp[u] = bf16_round(w[u] * phi);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) wp[u] = lane_add_round<1>(wp[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) wp[u] = lane_add_round<2>(wp[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) wp[u] = lane_add_round<4>(wp[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) wp[u] = lane_add_round<8>(wp[u], lane);
#pragma unroll
  for (int u = 0; u < U; ++u) wp[u] = lane_add_round<16>(wp[u], lane);

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float suffix = sfx[u] - (p_in[u] + wp[u]);
    const float mask = al[u] > 0.0f ? 1.0f : 0.0f;
    const float d_alpha =
        (tphi[u] - suffix / (1.0f - al[u])) * alive[u] * mask;
    const float unc = araw[u] < alpha_max() ? 1.0f : 0.0f;
    const float dp = d_alpha * al[u] * unc;
    const float dx = pxl[u] - mxl;
    const float dy = pyl[u] - myl;
    const float bdp = bf16_round(dp);
    const float bdx = bf16_round(dp * dx);
    const float bdy = bf16_round(dp * dy);
    acc[0] = acc[0] + bdp;
    acc[1] = acc[1] + bdx;
    acc[2] = acc[2] + bdx * pxl[u];
    acc[3] = acc[3] + bdx * pyl[u];
    acc[4] = acc[4] + bdy;
    acc[5] = acc[5] + bdy * pyl[u];
    const float bw = bf16_round(w[u]);
#pragma unroll
    for (int ch = 0; ch < NF; ++ch)
      acc[kMom + ch] = acc[kMom + ch] + bw * gb[u][ch];

    // The pixel's new T (the minimum of non-negative floats, as unsigned
    // bits), P and done, as the forward leaves them.
    const float tmin = __uint_as_float(__reduce_min_sync(
        kAll, __float_as_uint(alive[u] > 0.0f ? ta[u] : t_in[u])));
    const float p_last = __shfl_sync(kAll, wp[u], 31);
    if (lane == 0) tp[pj[u]] = make_float2(tmin, p_in[u] + p_last);
    if (t_last[u] < kTEps) done_mask |= 1u << j[u];
  }
}

template <int NF>
__global__ void __launch_bounds__(kPix, 2)
composite_bwd_bf16_kernel(const float* __restrict__ payload,
                          const int* __restrict__ first_sub,
                          const int* __restrict__ n_sub,
                          const float* __restrict__ res,
                          const float* __restrict__ cot,
                          float* __restrict__ dpay,
                          int tiles_x, int width, int height) {
  constexpr int kQ = kMom + NF;
  __shared__ float4 pconst[2 * kPix];              // per pixel, see below
  __shared__ float2 tp[kPix];                      // per pixel: T, P
  __shared__ float part[2][kQ][kWarps][32];        // per warp and entry

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;

  // Pixel p's constants: total_phi + T_final·g_T (the JAX form, :612-615)
  // and the bf16 cotangent rows; its T starts at 1 and P at 0. A warp only
  // ever reads its own pixels' entries, so __syncwarp orders them.
  {
    const float* r = res + (long long)tile * (kOut * kPix) + p;
    const float* c = cot + (long long)tile * (kOut * kPix) + p;
    float g[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) g[ch] = c[ch * kPix];
    const float total_phi = (r[0] * g[0] + r[kPix] * g[1]) +
                            r[2 * kPix] * g[2] + r[O_DEPTH * kPix] * g[3] +
                            r[O_ACC * kPix] * g[4];
    const float sfx = total_phi + r[O_T * kPix] * c[O_T * kPix];
    float gb[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) gb[ch] = ch < NF ? bf16_round(g[ch]) : 0.f;
    pconst[2 * p] = make_float4(sfx, gb[0], gb[1], gb[2]);
    pconst[2 * p + 1] = make_float4(gb[3], gb[4], 0.0f, 0.0f);
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
    const float mxl = ent[F_MX] - ox;
    const float myl = ent[F_MY] - oy;
    float fb[NF];
#pragma unroll
    for (int ch = 0; ch < NF; ++ch) fb[ch] = bf16_round(ent[F_R + ch]);

    float acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = 0.0f;
    for (int j0 = 0; j0 < 32 / kStep; ++j0) {
      unsigned mine = 0u;   // the step's pixels
#pragma unroll
      for (int u = 0; u < kStep; ++u) mine |= 1u << (j0 + (32 / kStep) * u);
      if ((done_mask & mine) == mine) continue;
      pixel_steps<NF, kStep>(ent, fb, mxl, myl, ox, oy, lane, warp, j0,
                             pconst, tp, done_mask, acc);
    }

    const int b = k & 1;
#pragma unroll
    for (int q = 0; q < kQ; ++q) part[b][q][warp][lane] = acc[q];
    // One barrier: the partials are complete, and the last one tells
    // whether every pixel of the tile is done.
    const bool all_done = __syncthreads_and(done_mask == kAll);

    // Σ over the 8 warps, in warp order, of quantity q for entry `lane`.
    auto sum = [&](int q) {
      float a = part[b][q][0][lane];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) a = a + part[b][q][wp][lane];
      return a;
    };
    float* d = dpay + ((long long)(s0 + k) * kSub + lane) * kFeat;
    switch (warp) {
      case 0: d[F_MX] = ent[F_CXX] * sum(1) + ent[F_CXY] * sum(4); break;
      case 1: d[F_MY] = ent[F_CYY] * sum(4) + ent[F_CXY] * sum(1); break;
      case 2: d[F_CXX] = -0.5f * (sum(2) - mxl * sum(1)); break;
      case 3: d[F_CXY] = -(sum(3) - myl * sum(1)); break;
      case 4: d[F_CYY] = -0.5f * (sum(5) - myl * sum(4)); break;
      case 5: {
        const float op = ent[F_OP];
        d[F_OP] = op > 0.0f ? sum(0) / fmaxf(op, 1e-30f) : 0.0f;
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

template <int NF>
int launch(const float* pay, const int* fs, const int* nsb, const float* rs,
           const float* ct, float* dp, int tiles, int tiles_x, int width,
           int height, cudaStream_t st) {
  composite_bwd_bf16_kernel<NF><<<tiles, kPix, kDynSmem, st>>>(
      pay, fs, nsb, rs, ct, dp, tiles_x, width, height);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msgs_composite_bwd_bf16(const void* payload,
                                       const void* first_sub,
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
  // image_only: φ and the colour sums over r g b only (nf_phi = 3).
  if (image_only)
    return launch<3>(pay, fs, nsb, rs, ct, dp, tiles, tiles_x, width, height,
                     st);
  return launch<5>(pay, fs, nsb, rs, ct, dp, tiles, tiles_x, width, height,
                   st);
}

// The kernel's build: registers, stack bytes, static and dynamic shared
// memory, and CTAs per SM at its launch configuration.
extern "C" int msgs_composite_bwd_bf16_info(int image_only, int* out) {
  return image_only
             ? fill_kernel_info(composite_bwd_bf16_kernel<3>, kPix, kDynSmem,
                                out)
             : fill_kernel_info(composite_bwd_bf16_kernel<5>, kPix, kDynSmem,
                                out);
}
