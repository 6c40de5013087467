// Tile compositor, backward, bwd_bf16 variant: per-entry gradients of the
// payload columns F_MX..F_PSIZE with the per-pixel reductions done as bf16
// tensor-core contractions with f32 accumulation. The plain version is
// msgs_torch/kernels/composite.py:composite_bwd_bf16_reference.
//
// Replaces msgs/kernels/composite.py:_bwd_kernel with bwd_bf16=True
// (:490-519, :565-572, :602-606, :624-639, :706-760). The TPU kernel stages
// d_power, d_power·dx, d_power·dy and w as bf16 rows for a whole grid step
// in VMEM and contracts them on the MXU against the pixel basis [x, y, 1]
// and the cotangent columns. Here, as in composite_bwd.cu, one CTA owns one
// tile and walks its sub-blocks in order, one thread per pixel, and
// recomputes the forward (α, the prefix product, T, alive, done) with
// composite_common.cuh's arithmetic under -fmad=false. Per sub-block:
//
//   1. Each thread computes, for the sub-block's 32 entries at its pixel,
//      φ = Σ_c bf16(f_c)·bf16(g_c) and the inclusive prefix of bf16(w·φ)
//      in f32 registers (5 Hillis-Steele rounds, the plain version's tree).
//      Every product of two bf16 values is exact in f32, so these stay on
//      the fp32 units: the contract holds up to the order of f32 sums.
//      Then dα and dpower exactly as composite_bwd.cu.
//   2. Each thread writes its pixel's column of four 32 × 256 bf16
//      matrices to shared memory: bf16(dp), bf16(dp·dx), bf16(dp·dy) in the
//      mean-centred form (dx, dy tile-local offsets from the entry's mean)
//      and bf16(w). Rows are padded to 264 elements so the ldmatrix row
//      reads fall in distinct banks. 67.6 KB in all, plus the tile's bf16
//      cotangent rows G (8 × 264, channels past NF zero).
//   3. Warp (m, h), m = warp/2, h = warp%2, multiplies rows 16h..16h+15 of
//      matrix m by a 256 × 8 operand: the pixel basis [x, y, 1, 0…]
//      (x, y ≤ 15, exact in bf16) for m < 3, G for m = 3. That is 16
//      mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 over K = 256, A loaded
//      with ldmatrix.x4, B built in registers (basis) or read from G.
//      The (32 × 8) f32 results go to shared memory.
//   4. Warp 0, lane = entry, applies the chain rules of :733-750:
//      q20 = m1[0] − mxl·q10, q11 = m1[1] − myl·q10, q02 = m2[1] − myl·q01,
//      d_mx = cxx·q10 + cxy·q01, d_my = cyy·q01 + cxy·q10,
//      d_cxx = −q20/2, d_cxy = −q11, d_cyy = −q02/2, d_op = q00/op,
//      d{colour c} = (w·G)[c], and writes the entry's 12-column dpay row.
//
// These contractions replace composite_bwd.cu's 6 + NF transposed warp
// butterflies. The kernel is deterministic: every sum runs in a fixed
// order, no atomics. The CTA stops where the forward stopped; the wrapper
// zeroes dpay, so the rows of skipped sub-blocks and the uncomputed
// columns read 0.
//
// Bound on the H100: fp32 operations (the forward recompute and the
// per-pair φ, prefix, dα, dpower and staging arithmetic; counted in
// chip_smoke.py), ahead of the tensor-core work (4 × 8 × 2 flops per
// pair, about 1/15 of the card's dense bf16 rate against the fp32 rate)
// and the bytes (payload, dpay, forward output and cotangent once).
#include <cuda_bf16.h>

#include "composite_common.cuh"

namespace {

using namespace msgs_composite;

constexpr int kWarps = kPix / 32;   // 8
constexpr int kMats = 4;            // dp, dp·dx, dp·dy, w
constexpr int kLd = kPix + 8;       // padded row stride of the bf16 tiles
constexpr int kN = 8;               // MMA n: basis columns / colour columns
constexpr size_t kDynSmem =
    (size_t)(kMats * kSub + kN) * kLd * sizeof(__nv_bfloat16);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two values as one bf16x2 register, the lower k in the lower half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column n of the moment basis at tile-local pixel p: x, y, 1, then 0.
__device__ __forceinline__ float basis(int p, int n) {
  return n == 0 ? (float)(p % kTile)
                : n == 1 ? (float)(p / kTile) : n == 2 ? 1.0f : 0.0f;
}

template <int NF>
__global__ void __launch_bounds__(kPix)
composite_bwd_bf16_kernel(const float* __restrict__ payload,
                          const int* __restrict__ first_sub,
                          const int* __restrict__ n_sub,
                          const float* __restrict__ res,
                          const float* __restrict__ cot,
                          float* __restrict__ dpay,
                          int tiles_x, int width, int height) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);  // [4][32][kLd]
  __nv_bfloat16* G = A + kMats * kSub * kLd;                   // [8][kLd]
  __shared__ float sp[kSub * kFeat];
  __shared__ float S[kMats][kSub][kN];
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
  float g[5], gb[NF];
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) g[ch] = c[ch * kPix];
#pragma unroll
  for (int ch = 0; ch < NF; ++ch) gb[ch] = bf16_round(g[ch]);
#pragma unroll
  for (int n = 0; n < kN; ++n)
    G[n * kLd + p] = __float2bfloat16_rn(n < NF ? g[n < 5 ? n : 0] : 0.0f);
  const float total_phi = (r[0] * g[0] + r[kPix] * g[1]) + r[2 * kPix] * g[2] +
                          r[O_DEPTH * kPix] * g[3] + r[O_ACC * kPix] * g[4];
  const float sfx = total_phi + r[O_T * kPix] * c[O_T * kPix];

  float T = 1.0f;
  float done = ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height)
                   ? 1.0f : 0.0f;
  float P = 0.0f;   // Σ bf16(w·φ) over the tile's earlier sub-blocks

  // This warp's MMA: matrix m, rows 16h..16h+15; ldmatrix row / column.
  const int m = warp >> 1;
  const int h = warp & 1;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const __nv_bfloat16* a_rows =
      A + (m * kSub + h * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;

  const int s0 = first_sub[tile];
  const int ns = n_sub[tile];
  for (int k = 0; k < ns; ++k) {
    const float* src = payload + (long long)(s0 + k) * (kSub * kFeat);
    for (int i = p; i < kSub * kFeat; i += kPix) sp[i] = src[i];
    __syncthreads();

    // 1. α and the prefix product, exactly as composite_fwd.cu.
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

    // w (staged as bf16 at once), T_i·φ and bf16(w·φ) per entry; the new
    // T and done as the forward.
    const float t_in = T;
    const float not_done = 1.0f - done;
    const float t_last = t_in * cu[kSub - 1];
    float wphi[kSub];
    unsigned alive_bits = 0u;
    float tmin = INFINITY;
    float ce = 1.0f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const float* e = sp + i * kFeat;
      const float ta = t_in * cu[i];
      const float alive = (ta >= kTEps ? 1.0f : 0.0f) * not_done;
      const float w = al[i] * t_in * ce * alive;
      A[(3 * kSub + i) * kLd + p] = __float2bfloat16_rn(w);
      tmin = fminf(tmin, alive > 0.0f ? ta : t_in);
      if (alive > 0.0f) alive_bits |= 1u << i;
      float phi = gb[0] * bf16_round(e[F_R]);
#pragma unroll
      for (int ch = 1; ch < NF; ++ch)
        phi = phi + gb[ch] * bf16_round(e[F_R + ch]);
      const float t_i = t_in * ce;
      ce = cu[i];
      cu[i] = t_i * phi;        // cu now holds T_i·φ_i
      wphi[i] = bf16_round(w * phi);
    }
    T = tmin;
    done = fmaxf(done, t_last < kTEps ? 1.0f : 0.0f);

    // Inclusive prefix of bf16(w·φ) within the sub-block; dpower per
    // entry, staged with its mean-centred moments.
    hs_prefix_sum(wphi);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const float* e = sp + i * kFeat;
      const float suffix = sfx - (P + wphi[i]);
      const float alive = (alive_bits >> i) & 1u ? 1.0f : 0.0f;
      const float mask = al[i] > 0.0f ? 1.0f : 0.0f;
      const float d_alpha =
          (cu[i] - suffix / (1.0f - al[i])) * alive * mask;
      const float unc = (unclamped >> i) & 1u ? 1.0f : 0.0f;
      if (i == kSub - 1) P = P + wphi[i];
      const float dp = d_alpha * al[i] * unc;
      const float dx = pxl - (e[F_MX] - ox);
      const float dy = pyl - (e[F_MY] - oy);
      A[(0 * kSub + i) * kLd + p] = __float2bfloat16_rn(dp);
      A[(1 * kSub + i) * kLd + p] = __float2bfloat16_rn(dp * dx);
      A[(2 * kSub + i) * kLd + p] = __float2bfloat16_rn(dp * dy);
    }
    __syncthreads();

    // 3. (32 × 256)·(256 × 8) per matrix on the tensor cores.
    {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k0 = 0; k0 < kPix; k0 += 16) {
        unsigned a[4];
        ldmatrix_x4(a, a_rows + k0);
        unsigned b0, b1;
        if (m < 3) {
          const int q = k0 + tig * 2;
          b0 = pack_bf16x2(basis(q, gid), basis(q + 1, gid));
          b1 = pack_bf16x2(basis(q + 8, gid), basis(q + 9, gid));
        } else {
          const __nv_bfloat16* gr = G + gid * kLd + k0 + tig * 2;
          b0 = *reinterpret_cast<const unsigned*>(gr);
          b1 = *reinterpret_cast<const unsigned*>(gr + 8);
        }
        mma_bf16(acc, a, b0, b1);
      }
      S[m][h * 16 + gid][tig * 2] = acc[0];
      S[m][h * 16 + gid][tig * 2 + 1] = acc[1];
      S[m][h * 16 + gid + 8][tig * 2] = acc[2];
      S[m][h * 16 + gid + 8][tig * 2 + 1] = acc[3];
    }
    __syncthreads();

    // 4. Chain rules, one entry per lane of warp 0.
    if (warp == 0) {
      const float* e = sp + lane * kFeat;
      const float mxl = e[F_MX] - ox;
      const float myl = e[F_MY] - oy;
      const float cxx = e[F_CXX], cxy = e[F_CXY], cyy = e[F_CYY];
      const float op = e[F_OP];
      const float q00 = S[0][lane][2];
      const float q10 = S[1][lane][2];
      const float q01 = S[2][lane][2];
      const float q20 = S[1][lane][0] - mxl * q10;
      const float q11 = S[1][lane][1] - myl * q10;
      const float q02 = S[2][lane][1] - myl * q01;
      float row[kFeat];
      row[F_MX] = cxx * q10 + cxy * q01;
      row[F_MY] = cyy * q01 + cxy * q10;
      row[F_CXX] = -0.5f * q20;
      row[F_CXY] = -q11;
      row[F_CYY] = -0.5f * q02;
      row[F_OP] = op > 0.0f ? q00 / fmaxf(op, 1e-30f) : 0.0f;
#pragma unroll
      for (int col = F_R; col < kFeat; ++col) row[col] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < NF; ++ch) row[F_R + ch] = S[3][lane][ch];
      float* d = dpay + ((long long)(s0 + k) * kSub + lane) * kFeat;
#pragma unroll
      for (int col = 0; col < kFeat; ++col) d[col] = row[col];
    }

    // Also the barrier before the next sub-block overwrites sp, A and S.
    if (__syncthreads_and(done != 0.0f)) break;
  }
}

template <int NF>
int launch(const float* pay, const int* fs, const int* nsb, const float* rs,
           const float* ct, float* dp, int tiles, int tiles_x, int width,
           int height, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_bf16_kernel<NF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDynSmem);
  if (err != cudaSuccess) return (int)err;
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
