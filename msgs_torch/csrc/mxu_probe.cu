// The compositor's per-(entry, pixel) pair math in eight formulations,
// summed over blocks: the probe of whether parts of it pay on the tensor
// cores. The contract and the plain version are
// msgs_torch/kernels/mxu_probe.py (pair_block_probe_plain): per block of
// 128 payload rows × 16 features against a 16×16 pixel tile, power, α,
// the transmittance within 4 segments of 32 rows, w = α·T_excl·alive, and
// rows 0-4 of an (8, 256) accumulator, in the variant's formulation.
//
// Replaces the Pallas kernel of tools/exp_mxu.py: `make_kernel` :160,
// called at :209 with a grid over the blocks that carries the accumulator
// in VMEM scratch from one grid step to the next (:164, :202).
//
// Bound on the H100: the issue rate of its instructions. A block reads 8 KB
// and does ~40 fp32 operations for each of its 32,768 (entry, pixel) pairs
// (base), about 160 per byte, past the card's 20 fp32 operations per byte
// of HBM; the arithmetic is fixed by the plain version's bits (-fmad=false,
// IEEE expf, log1pf and division), so what the design can cut is
// everything around it.
//
// Design. A CTA of 128 threads walks a contiguous range of blocks; the
// grid is what the card holds at once (CTAs per SM, at most 3, × SMs, at
// most B), and each CTA's range is B/grid blocks to one more.
//   * Staging: block b+1 is copied into the second of two shared buffers
//     by cp.async while block b computes; one CTA barrier a block. `empty`
//     stages every block too and so measures the streaming floor.
//   * Two pixels a thread: thread i takes pixels i and i + 128, which share
//     x, so each entry's constants, read once from shared memory, serve two
//     pairs, and dx, cxx·dx·dx and cxy·dx (pow_mxu HIGHEST: the x terms)
//     are made once for both. Each thread keeps its pixels' 32 α, the
//     products and its running sums in registers.
//   * Tensor cores (HIGH: 3×TF32 `mma.sync.m16n8k8`, x = big + small,
//     big = tf32(x), small = tf32(x − big), products small·big + big·small
//     + big·big with fp32 accumulation). Warp w owns pixels 32w..32w+31 and
//     128+32w..128+32w+31: the n-tiles of every 256-wide product it
//     computes are its own pixels, so the data passes through a
//     [pixel][32] shared matrix between its own lanes behind `__syncwarp`
//     only. Operands that vary per pair are split once per element; the
//     constant ones, the monomial basis and the triangle, are exact in TF32
//     (integers ≤ 225, 0 and 1): their small part is 0 and the product that
//     would use it is left out, and the triangle's zero blocks with it.
//       pow_mxu   power = coefficients (split once per block) @ basis
//       scan_mxu  cs = tri (32×32 lower ones) @ log1p(−α): the four diagonal
//                 blocks of the TPU's dense (128×128) product
//       acc_tn    featᵀ (8×32) @ w per segment; segment 0's rows 0-4 kept
//       dfeat_nt  df = w (32×256) @ g_rowsᵀ per segment, the warps' K
//                 ranges added in warp order through shared memory; then
//                 (df[:8] @ basis)·1e-6
//     HIGHEST is fp32 on the CUDA cores, each element summed in k order
//     (the plain version's order); dfeat_nt's df there is register-tiled:
//     a thread sums 2 elements from float4 reads of w and g_rows.
//   * Values the TPU computes and drops (acc_tn's segments 1-3 and rows
//     5-7, dfeat_nt's df and rows 5-7) are folded into one word by xor
//     and stored where it matches a constant, so ptxas keeps their work
//     (an empty asm that reads a value keeps nothing).
//   * The summed output is one launch: each CTA writes its partial (rows
//     0-4); the last CTA of each group of 32 to finish (a ticket) adds its
//     group's partials in CTA order, and the last group to finish adds the
//     group sums in group order. The order is fixed by B and the grid, so
//     two launches are bit-identical (no atomics on values); the plain
//     version sums the per-block terms with torch.sum. Tickets are reset by
//     the CTA that closes them.
//
// Built with -fmad=false (kernels/_build.py): the HIGHEST runs' dot
// products are separate multiplies and adds, as the plain version rounds
// them, so the f32 runs equal it per block wherever expf, exp2f and
// log1pf agree with torch's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ablate_common.cuh"
#include "kernel_info.cuh"

namespace {

using msgs_composite::alpha_max;
using msgs_composite::alpha_min;
using msgs_composite::t_eps;

constexpr int kBlock = 128;   // payload rows per block
constexpr int kPix = 256;     // pixels per block
constexpr int kFeat = 16;     // payload columns
constexpr int kSub = msgs_composite::kSub;   // 32 rows per segment
constexpr int kNSub = kBlock / kSub;
constexpr int kOut = 8;       // accumulator rows
constexpr int kAcc = 5;       // rows the variants add into
constexpr int kNdf = 8;       // df columns
constexpr int kThreads = 128;              // thread i: pixels i, i + 128
constexpr int kBlockFloats = kBlock * kFeat;
constexpr int kGroup = 32;    // CTAs whose partials one closer adds
// CTAs an SM takes at most: every formulation but `empty` holds at most 3
// (registers); `empty` could hold 13, but its summed output then has 4×
// the partials, and it ran slower on the H100.
constexpr int kMaxCtasPerSm = 3;
constexpr int kPart = kAcc * kPix;          // floats of a partial
constexpr int kLdP = 36;      // [pixel][32] matrix rows, ≡ 4 (mod 32)
constexpr int kLdC = 12;      // pow_mxu HIGH coefficient rows, ≡ 12
constexpr int kLdW = 260;     // dfeat_nt: [32][pixel] w and [8][pixel] g
constexpr unsigned kOne = 0x3f800000u;      // 1.0f, exact in TF32
// The dropped values' xor, stored where it equals this NaN pattern.
constexpr unsigned kSinkKey = 0x7fc00001u;

enum Variant { kEmpty = 0, kBase, kExp2, kPowMxu, kScanMxu, kAccTn,
               kDfeatNt };

// Row k of the (8, 256) monomial basis at pixel n: x², xy, y², x, y, 1, 0,
// 0 with x = n % 16, y = n / 16 (tools/exp_mxu.py:52-58).
__device__ __forceinline__ float basis(int k, int n) {
  const float x = (float)(n & 15), y = (float)(n >> 4);
  switch (k) {
    case 0: return x * x;
    case 1: return x * y;
    case 2: return y * y;
    case 3: return x;
    case 4: return y;
    case 5: return 1.0f;
    default: return 0.0f;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += A @ B for one m16n8k8 tile. Fragments (PTX ISA): with g = lane / 4
// and t = lane % 4, a = A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4);
// b = B(t, g), B(t+4, g); c = C(g, 2t), C(g, 2t+1), C(g+8, 2t),
// C(g+8, 2t+1).
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// First pixel column of n-tile j (0..7) of warp w: its pixels 32w + 8j
// (j < 4) and 128 + 32w + 8(j − 4).
__device__ __forceinline__ int tile_n0(int w, int j) {
  return (j >> 2) * 128 + 32 * w + 8 * (j & 3);
}

// Shared memory of one variant, in floats: two staged blocks, then what
// the formulation passes between threads.
template <int V, bool kTC>
struct Smem {
  static constexpr bool kMat = kTC;          // [pixel][kLdP]
  static constexpr int kBlkOff = 0;
  static constexpr int kCoefOff = kBlkOff + 2 * kBlockFloats;
  static constexpr int kCoefFloats =
      V != kPowMxu ? 0 : (kTC ? 2 * kBlock * kLdC : kBlock * 8);
  static constexpr int kMatOff = kCoefOff + kCoefFloats;
  static constexpr int kWOff = kMatOff + (kMat ? kPix * kLdP : 0);
  static constexpr int kWFloats = V == kDfeatNt && !kTC ? kSub * kLdW : 0;
  static constexpr int kGOff = kWOff + kWFloats;
  static constexpr int kGFloats =
      V == kDfeatNt ? (kTC ? 2 : 1) * kNdf * kLdW : 0;
  // dfeat_nt: HIGH the warps' df partials, HIGHEST df rows 0-7.
  static constexpr int kDfOff = kGOff + kGFloats;
  static constexpr int kDfFloats =
      V == kDfeatNt ? (kTC ? 4 * kSub * kNdf : kNdf * kNdf) : 0;
  static constexpr int kFloats = kDfOff + kDfFloats;
  static constexpr int kBytes = kFloats * 4;
};

// Σ over the rows of one block's segment of feat[6 + i]·w at the thread's
// two pixels, in row order from the first term, i < N.
template <int N>
__device__ __forceinline__ void feature_sums(const float* fs,
                                             const float (&w)[2][kSub],
                                             float (&v)[2][8]) {
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    const float* e = fs + r * kFeat;
    const float2 f01 = *reinterpret_cast<const float2*>(e + 6);
    const float4 f25 = *reinterpret_cast<const float4*>(e + 8);
    float f[8] = {f01.x, f01.y, f25.x, f25.y, f25.z, f25.w, 0.f, 0.f};
    if constexpr (N > 6) {
      const float2 f67 = *reinterpret_cast<const float2*>(e + 12);
      f[6] = f67.x;
      f[7] = f67.y;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[k][i] = r == 0 ? f[i] * w[k][r] : v[k][i] + f[i] * w[k][r];
  }
}

// sum = slot q0 + slot q0+1 + ... + slot q1−1 of the partials at the
// thread's two pixels, in slot order from the first; the loads of 4 slots
// are issued before their adds, so a closer waits on L2 once per 4 slots
// (8 raised the summed instances' registers, `empty`'s most).
__device__ __forceinline__ void add_slots(const float* part, int q0, int q1,
                                          const int (&pix)[2],
                                          float (&sum)[2][kAcc]) {
  for (int q = q0; q < q1; q += 4) {
    float x[4][2][kAcc];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q + u < q1) {
        const float* pq = part + (size_t)(q + u) * kPart;
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            x[u][k][i] = __ldcg(pq + i * kPix + pix[k]);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q + u < q1) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            sum[k][i] = q + u == q0 ? x[u][k][i] : sum[k][i] + x[u][k][i];
      }
  }
}

// CTAs an SM must hold (__launch_bounds__' second argument), chosen by
// timing each formulation's instances on the H100 at 1, 2 and 4: ptxas
// settles at ~165 registers (3 CTAs an SM) without a bound; a bound of 2
// (up to 255 registers) ran scan_mxu HIGH, pow_mxu HIGH, exp2 and dfeat_nt
// HIGHEST faster; 4 (≤ 128 registers) gives base and acc_tn HIGHEST a
// stack frame, so none takes it.
template <int V, bool kTC>
constexpr int min_ctas() {
  if (kTC ? (V == kScanMxu || V == kPowMxu) : (V == kExp2 || V == kDfeatNt))
    return 2;
  return 1;
}

template <int V, bool kTC, bool kPerBlock>
__global__ void __launch_bounds__(kThreads, (min_ctas<V, kTC>()))
mxu_probe_kernel(const float* __restrict__ pay,
                 const float* __restrict__ g_rows, float* __restrict__ out,
                 float* __restrict__ df_out, float* __restrict__ partial,
                 unsigned* __restrict__ tickets, int B) {
  using L = Smem<V, kTC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sblk = smem + L::kBlkOff;
  float* scoef = smem + L::kCoefOff;
  float* smat = smem + L::kMatOff;
  float* sw = smem + L::kWOff;
  float* sg = smem + L::kGOff;
  float* sdf = smem + L::kDfOff;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float px = (float)(tid & 15);
  const float py[2] = {(float)(tid >> 4), (float)((tid >> 4) + 8)};
  const int pix[2] = {tid, tid + 128};
  unsigned junk = 0;   // xor of the values the TPU computes and drops
  auto drop = [&](float x) { junk ^= __float_as_uint(x); };

  // The basis at this lane's b fragments of the warp's n-tiles (HIGH
  // pow_mxu and dfeat_nt): rows t and t + 4 at pixel n0 + g.
  uint32_t bas[8][2];
  if constexpr (kTC && (V == kPowMxu || V == kDfeatNt)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tile_n0(warp, j) + g;
      bas[j][0] = __float_as_uint(basis(t, n));
      bas[j][1] = __float_as_uint(basis(t + 4, n));
    }
  }
  if constexpr (V == kDfeatNt) {
    for (int i = tid; i < kNdf * kPix; i += kThreads) {
      const int j = i / kPix, q = i % kPix;
      const float x = g_rows[i];
      if constexpr (kTC) {
        uint32_t big, small;
        split_tf32(x, big, small);
        sg[j * kLdW + q] = __uint_as_float(big);
        sg[(kNdf + j) * kLdW + q] = __uint_as_float(small);
      } else {
        sg[j * kLdW + q] = x;
      }
    }
  }

  const int b0 = (int)((long long)blockIdx.x * B / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * B / gridDim.x);
  auto stage = [&](int b, int buf) {
    const float4* src =
        reinterpret_cast<const float4*>(pay) + (size_t)b * (kBlockFloats / 4);
    float* dst = sblk + buf * kBlockFloats;
#pragma unroll
    for (int i = 0; i < kBlockFloats / 4 / kThreads; ++i)
      msgs_ablate::cp_async16(dst + 4 * (tid + i * kThreads),
                              src + tid + i * kThreads);
    msgs_ablate::cp_async_commit();
  };
  if (b0 < b1) stage(b0, 0);

  float tot[2][kAcc];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) tot[k][i] = 0.0f;

#pragma unroll 1
  for (int b = b0; b < b1; ++b) {
    msgs_ablate::cp_async_wait<0>();
    __syncthreads();   // block b staged; every thread done with block b − 1
    if (b + 1 < b1) stage(b + 1, (b + 1 - b0) & 1);
    const float* blk = sblk + ((b - b0) & 1) * kBlockFloats;

    if constexpr (V == kPowMxu) {
      // Tile-origin coefficients of row tid (tools/exp_mxu.py:96-107).
      const float* e = blk + tid * kFeat;
      const float mx = e[0], my = e[1], cxx = e[2], cxy = e[3], cyy = e[4];
      const float co[8] = {-0.5f * cxx, -cxy, -0.5f * cyy,
                           cxx * mx + cxy * my, cyy * my + cxy * mx,
                           -0.5f * (cxx * mx * mx + cyy * my * my) -
                               cxy * mx * my,
                           0.0f, 0.0f};
      if constexpr (kTC) {
        uint32_t big[8], small[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) split_tf32(co[k], big[k], small[k]);
        uint4* cb = reinterpret_cast<uint4*>(scoef + tid * kLdC);
        uint4* cs = reinterpret_cast<uint4*>(scoef + (kBlock + tid) * kLdC);
        cb[0] = make_uint4(big[0], big[1], big[2], big[3]);
        cb[1] = make_uint4(big[4], big[5], big[6], big[7]);
        cs[0] = make_uint4(small[0], small[1], small[2], small[3]);
        cs[1] = make_uint4(small[4], small[5], small[6], small[7]);
      } else {
        float4* c4 = reinterpret_cast<float4*>(scoef + tid * 8);
        c4[0] = make_float4(co[0], co[1], co[2], co[3]);
        c4[1] = make_float4(co[4], co[5], co[6], co[7]);
      }
      __syncthreads();
    }

    // This block's accumulator rows at the thread's two pixels.
    float c[2][kOut];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < kOut; ++i) c[k][i] = 0.0f;

    if constexpr (V == kEmpty) {
      c[0][0] = c[1][0] = blk[6] * px;
    } else {
#pragma unroll 1
      for (int s = 0; s < kNSub; ++s) {
        const float* fs = blk + s * kSub * kFeat;
        float a[2][kSub];   // power, then α, then w
        if constexpr (V == kPowMxu && kTC) {
          // power (32×256) = coef (32×8) @ basis (8×256), the warp's
          // n-tiles, into smat[pixel][row].
          const uint32_t* cb =
              reinterpret_cast<const uint32_t*>(scoef) + s * kSub * kLdC;
          const uint32_t* cs = cb + kBlock * kLdC;
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r0 = (16 * mt + g) * kLdC, r1 = r0 + 8 * kLdC;
            ab[mt][0] = cb[r0 + t];
            ab[mt][1] = cb[r1 + t];
            ab[mt][2] = cb[r0 + t + 4];
            ab[mt][3] = cb[r1 + t + 4];
            as[mt][0] = cs[r0 + t];
            as[mt][1] = cs[r1 + t];
            as[mt][2] = cs[r0 + t + 4];
            as[mt][3] = cs[r1 + t + 4];
          }
          __syncwarp();   // the warp's readers of the last segment are done
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n0 = tile_n0(warp, j);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float cc[4] = {0.f, 0.f, 0.f, 0.f};
              mma(cc, as[mt][0], as[mt][1], as[mt][2], as[mt][3], bas[j][0],
                  bas[j][1]);
              mma(cc, ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bas[j][0],
                  bas[j][1]);
              float* m0 = smat + (n0 + 2 * t) * kLdP + 16 * mt + g;
              m0[0] = cc[0];
              m0[kLdP] = cc[1];
              m0[8] = cc[2];
              m0[kLdP + 8] = cc[3];
            }
          }
          __syncwarp();
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4* col =
                reinterpret_cast<const float4*>(smat + pix[k] * kLdP);
#pragma unroll
            for (int q = 0; q < kSub / 4; ++q) {
              const float4 v = col[q];
              a[k][4 * q] = v.x;
              a[k][4 * q + 1] = v.y;
              a[k][4 * q + 2] = v.z;
              a[k][4 * q + 3] = v.w;
            }
          }
        }
        // α of the segment's 32 rows at the two pixels.
#pragma unroll
        for (int r = 0; r < kSub; ++r) {
          const float* e = fs + r * kFeat;
          const float4 e03 = *reinterpret_cast<const float4*>(e);
          const float2 e45 = *reinterpret_cast<const float2*>(e + 4);
          float pw[2];
          if constexpr (V == kPowMxu && kTC) {
            pw[0] = a[0][r];
            pw[1] = a[1][r];
          } else if constexpr (V == kPowMxu) {
            const float* co = scoef + (s * kSub + r) * 8;
            const float4 c03 = *reinterpret_cast<const float4*>(co);
            const float2 c45 = *reinterpret_cast<const float2*>(co + 4);
            const float xx = c03.x * (px * px), x1 = c03.w * px,
                        one = c45.y * 1.0f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float p = xx + c03.y * (px * py[k]);
              p = p + c03.z * (py[k] * py[k]);
              p = p + x1;
              p = p + c45.x * py[k];
              pw[k] = p + one;
            }
          } else {
            const float dx = px - e03.x;
            const float xx = e03.z * dx * dx, xy = e03.w * dx;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float dy = py[k] - e03.y;
              pw[k] = -0.5f * (xx + e45.x * dy * dy) - xy * dy;
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float gg = V == kExp2
                ? exp2f(pw[k] * (float)1.4426950408889634) : expf(pw[k]);
            const float ar = e45.y * gg;
            const bool m = (ar >= alpha_min()) && (pw[k] <= 0.0f);
            a[k][r] = m ? fminf(ar, alpha_max()) : 0.0f;
          }
        }

        // w = α·T_excl·alive, in place in a.
        if constexpr (V == kScanMxu) {
          float cs[2][kSub];
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int r = 0; r < kSub; ++r) cs[k][r] = log1pf(-a[k][r]);
          if constexpr (kTC) {
            // cs (32×256) = tri (32×32 lower ones) @ log1p(−α), in place
            // in smat.
            __syncwarp();   // the warp's readers of the last segment are done
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float4* col = reinterpret_cast<float4*>(smat + pix[k] * kLdP);
#pragma unroll
              for (int q = 0; q < kSub / 4; ++q)
                col[q] = make_float4(cs[k][4 * q], cs[k][4 * q + 1],
                                     cs[k][4 * q + 2], cs[k][4 * q + 3]);
            }
            __syncwarp();
            // The triangle's fragments: rows 0-15 take k-steps 0 (d0) and
            // 1 (d1), 2-3 are zero; rows 16-31 take ones, ones, d0, d1.
            const uint32_t p0 = t <= g ? kOne : 0u, p1 = t + 4 <= g ? kOne : 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n0 = tile_n0(warp, j);
              const float* col = smat + (n0 + g) * kLdP;
              uint32_t bb[4][2], bs[4][2];
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                split_tf32(col[8 * ks + t], bb[ks][0], bs[ks][0]);
                split_tf32(col[8 * ks + t + 4], bb[ks][1], bs[ks][1]);
              }
              float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
              mma(c0, p0, kOne, p1, kOne, bs[0][0], bs[0][1]);
              mma(c0, p0, kOne, p1, kOne, bb[0][0], bb[0][1]);
              mma(c0, 0u, p0, 0u, p1, bs[1][0], bs[1][1]);
              mma(c0, 0u, p0, 0u, p1, bb[1][0], bb[1][1]);
              mma(c1, kOne, kOne, kOne, kOne, bs[0][0], bs[0][1]);
              mma(c1, kOne, kOne, kOne, kOne, bb[0][0], bb[0][1]);
              mma(c1, kOne, kOne, kOne, kOne, bs[1][0], bs[1][1]);
              mma(c1, kOne, kOne, kOne, kOne, bb[1][0], bb[1][1]);
              mma(c1, p0, kOne, p1, kOne, bs[2][0], bs[2][1]);
              mma(c1, p0, kOne, p1, kOne, bb[2][0], bb[2][1]);
              mma(c1, 0u, p0, 0u, p1, bs[3][0], bs[3][1]);
              mma(c1, 0u, p0, 0u, p1, bb[3][0], bb[3][1]);
              __syncwarp();   // every lane has read this n-tile's columns
              float* m0 = smat + (n0 + 2 * t) * kLdP + g;
              m0[0] = c0[0];
              m0[kLdP] = c0[1];
              m0[8] = c0[2];
              m0[kLdP + 8] = c0[3];
              m0[16] = c1[0];
              m0[kLdP + 16] = c1[1];
              m0[24] = c1[2];
              m0[kLdP + 24] = c1[3];
            }
            __syncwarp();
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float4* col =
                  reinterpret_cast<const float4*>(smat + pix[k] * kLdP);
#pragma unroll
              for (int q = 0; q < kSub / 4; ++q) {
                const float4 v = col[q];
                cs[k][4 * q] = v.x;
                cs[k][4 * q + 1] = v.y;
                cs[k][4 * q + 2] = v.z;
                cs[k][4 * q + 3] = v.w;
              }
            }
          } else {
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int r = 1; r < kSub; ++r) cs[k][r] = cs[k][r - 1] + cs[k][r];
          }
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int r = 0; r < kSub; ++r) {
              const float cum = expf(cs[k][r]);
              const float ce = cum / fmaxf(1.0f - a[k][r], (float)1e-6);
              a[k][r] = (a[k][r] * ce) * (cum >= t_eps() ? 1.0f : 0.0f);
            }
        } else {
          float cum[2][kSub];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int r = 0; r < kSub; ++r) cum[k][r] = 1.0f - a[k][r];
            msgs_composite::hs_prefix_product(cum[k]);
#pragma unroll
            for (int r = 0; r < kSub; ++r) {
              const float ce = r == 0 ? 1.0f : cum[k][r - 1];
              a[k][r] = (a[k][r] * ce) * (cum[k][r] >= t_eps() ? 1.0f : 0.0f);
            }
          }
        }

        // The accumulation.
        if constexpr (V == kAccTn && kTC) {
          // acc (8×256) = featᵀ (8×32: features 6..13 of the segment's
          // rows) @ w, M padded to 16 with zero rows.
          __syncwarp();   // the warp's readers of the last segment are done
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float4* col = reinterpret_cast<float4*>(smat + pix[k] * kLdP);
#pragma unroll
            for (int q = 0; q < kSub / 4; ++q)
              col[q] = make_float4(a[k][4 * q], a[k][4 * q + 1],
                                   a[k][4 * q + 2], a[k][4 * q + 3]);
          }
          uint32_t fb[4][2], fsm[4][2];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            split_tf32(fs[(8 * ks + t) * kFeat + 6 + g], fb[ks][0],
                       fsm[ks][0]);
            split_tf32(fs[(8 * ks + t + 4) * kFeat + 6 + g], fb[ks][1],
                       fsm[ks][1]);
          }
          __syncwarp();
          float acc[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float* col = smat + (tile_n0(warp, j) + g) * kLdP;
            float cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32(col[8 * ks + t], bb0, bs0);
              split_tf32(col[8 * ks + t + 4], bb1, bs1);
              mma(cc, fsm[ks][0], 0u, fsm[ks][1], 0u, bb0, bb1);
              mma(cc, fb[ks][0], 0u, fb[ks][1], 0u, bs0, bs1);
              mma(cc, fb[ks][0], 0u, fb[ks][1], 0u, bb0, bb1);
            }
            acc[j][0] = cc[0];
            acc[j][1] = cc[1];
          }
          if (s == 0) {
            __syncwarp();   // every lane has read w
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* m0 = smat + (tile_n0(warp, j) + 2 * t) * kLdP + g;
              m0[0] = acc[j][0];
              m0[kLdP] = acc[j][1];
            }
            __syncwarp();
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float4* col =
                  reinterpret_cast<const float4*>(smat + pix[k] * kLdP);
              const float4 lo = col[0], hi = col[1];
              c[k][0] = lo.x;
              c[k][1] = lo.y;
              c[k][2] = lo.z;
              c[k][3] = lo.w;
              c[k][4] = hi.x;
              drop(hi.y);
              drop(hi.z);
              drop(hi.w);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              drop(acc[j][0]);
              drop(acc[j][1]);
            }
          }
        } else if constexpr (V == kAccTn) {
          float v[2][8];
          feature_sums<8>(fs, a, v);
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (s == 0 && j < kAcc) c[k][j] = v[k][j];
              else drop(v[k][j]);
            }
        } else if constexpr (V == kDfeatNt) {
          float v[2][8];   // (df[:8] @ basis)·1e-6 at the two pixels (s = 0)
          if constexpr (kTC) {
            // df (32×8) = w (32×256) @ g_rowsᵀ: K = the warp's 64 pixels.
            __syncwarp();   // the warp's readers of the last segment are done
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float4* col = reinterpret_cast<float4*>(smat + pix[k] * kLdP);
#pragma unroll
              for (int q = 0; q < kSub / 4; ++q)
                col[q] = make_float4(a[k][4 * q], a[k][4 * q + 1],
                                     a[k][4 * q + 2], a[k][4 * q + 3]);
            }
            __syncwarp();
            const uint32_t* gb = reinterpret_cast<const uint32_t*>(sg);
            const uint32_t* gs = gb + kNdf * kLdW;
            float cc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int q0 = tile_n0(warp, j);
              const uint32_t bb0 = gb[g * kLdW + q0 + t];
              const uint32_t bb1 = gb[g * kLdW + q0 + t + 4];
              const uint32_t bs0 = gs[g * kLdW + q0 + t];
              const uint32_t bs1 = gs[g * kLdW + q0 + t + 4];
              const float* c0 = smat + (q0 + t) * kLdP + g;
              const float* c4 = c0 + 4 * kLdP;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                uint32_t ab[4], as[4];
                split_tf32(c0[16 * mt], ab[0], as[0]);
                split_tf32(c0[16 * mt + 8], ab[1], as[1]);
                split_tf32(c4[16 * mt], ab[2], as[2]);
                split_tf32(c4[16 * mt + 8], ab[3], as[3]);
                mma(cc[mt], as[0], as[1], as[2], as[3], bb0, bb1);
                mma(cc[mt], ab[0], ab[1], ab[2], ab[3], bs0, bs1);
                mma(cc[mt], ab[0], ab[1], ab[2], ab[3], bb0, bb1);
              }
            }
            __syncthreads();   // every warp has read the last segment's partials
            float* part = sdf + warp * kSub * kNdf;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              *reinterpret_cast<float2*>(part + (16 * mt + g) * kNdf + 2 * t) =
                  make_float2(cc[mt][0], cc[mt][1]);
              *reinterpret_cast<float2*>(part + (16 * mt + g + 8) * kNdf +
                                         2 * t) =
                  make_float2(cc[mt][2], cc[mt][3]);
            }
            __syncthreads();
            // df of row tid / 4, columns 2(tid % 4) and +1: the warps'
            // partials added in warp order.
            const int el = (tid >> 2) * kNdf + 2 * (tid & 3);
            float2 d = *reinterpret_cast<const float2*>(sdf + el);
#pragma unroll
            for (int w = 1; w < 4; ++w) {
              const float2 x =
                  *reinterpret_cast<const float2*>(sdf + w * kSub * kNdf + el);
              d.x = d.x + x.x;
              d.y = d.y + x.y;
            }
            if constexpr (kPerBlock)
              *reinterpret_cast<float2*>(
                  df_out + ((size_t)b * kBlock + s * kSub) * kNdf + el) = d;
            else {
              drop(d.x);
              drop(d.y);
            }
            if (s == 0) {
              // (df[:8] @ basis)·1e-6 (tools/exp_mxu.py:196-199, :202): the
              // lane's a fragment, df[g][t] and df[g][t + 4], added as
              // above; rows 8-15 of A are zero.
              float dA = sdf[g * kNdf + t], dB = sdf[g * kNdf + t + 4];
#pragma unroll
              for (int w = 1; w < 4; ++w) {
                dA = dA + sdf[w * kSub * kNdf + g * kNdf + t];
                dB = dB + sdf[w * kSub * kNdf + g * kNdf + t + 4];
              }
              uint32_t ab0, as0, ab2, as2;
              split_tf32(dA, ab0, as0);
              split_tf32(dB, ab2, as2);
              float res[8][2];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                float r4[4] = {0.f, 0.f, 0.f, 0.f};
                mma(r4, as0, 0u, as2, 0u, bas[j][0], bas[j][1]);
                mma(r4, ab0, 0u, ab2, 0u, bas[j][0], bas[j][1]);
                res[j][0] = r4[0];
                res[j][1] = r4[1];
              }
              __syncwarp();
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                float* m0 = smat + (tile_n0(warp, j) + 2 * t) * kLdP + g;
                m0[0] = res[j][0];
                m0[kLdP] = res[j][1];
              }
              __syncwarp();
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const float4* col =
                    reinterpret_cast<const float4*>(smat + pix[k] * kLdP);
                const float4 lo = col[0], hi = col[1];
                const float r8[8] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) v[k][i] = r8[i] * (float)1e-6;
              }
            }
          } else {
            __syncthreads();   // every thread has read the last segment's w
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int r = 0; r < kSub; ++r) sw[r * kLdW + pix[k]] = a[k][r];
            __syncthreads();
            // df of row tid / 4, columns 2(tid % 4) and +1, each summed
            // over the pixels in order from the first term.
            const int rr = tid >> 2, j0 = 2 * (tid & 3);
            const float4* wr = reinterpret_cast<const float4*>(sw + rr * kLdW);
            const float4* g0 = reinterpret_cast<const float4*>(sg + j0 * kLdW);
            const float4* g1 =
                reinterpret_cast<const float4*>(sg + (j0 + 1) * kLdW);
            float d0, d1;
            {
              const float4 x = wr[0], u = g0[0], z = g1[0];
              d0 = x.x * u.x;
              d1 = x.x * z.x;
              d0 = d0 + x.y * u.y;
              d1 = d1 + x.y * z.y;
              d0 = d0 + x.z * u.z;
              d1 = d1 + x.z * z.z;
              d0 = d0 + x.w * u.w;
              d1 = d1 + x.w * z.w;
            }
#pragma unroll 4
            for (int q = 1; q < kPix / 4; ++q) {
              const float4 x = wr[q], u = g0[q], z = g1[q];
              d0 = d0 + x.x * u.x;
              d1 = d1 + x.x * z.x;
              d0 = d0 + x.y * u.y;
              d1 = d1 + x.y * z.y;
              d0 = d0 + x.z * u.z;
              d1 = d1 + x.z * z.z;
              d0 = d0 + x.w * u.w;
              d1 = d1 + x.w * z.w;
            }
            if constexpr (kPerBlock)
              *reinterpret_cast<float2*>(
                  df_out + ((size_t)b * kBlock + s * kSub + rr) * kNdf + j0) =
                  make_float2(d0, d1);
            if (s == 0 && rr < kNdf) {
              sdf[rr * kNdf + j0] = d0;
              sdf[rr * kNdf + j0 + 1] = d1;
            } else if (!kPerBlock) {
              drop(d0);
              drop(d1);
            }
            if (s == 0) {
              __syncthreads();   // df rows 0-7 written
              const float bxx = px * px;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float4 d03 = *reinterpret_cast<const float4*>(sdf + i * kNdf);
                const float2 d45 = *reinterpret_cast<const float2*>(sdf + i * kNdf + 4);
                const float xx = d03.x * bxx, x1 = d03.w * px, one = d45.y * 1.0f;
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  float x = xx + d03.y * (px * py[k]);
                  x = x + d03.z * (py[k] * py[k]);
                  x = x + x1;
                  x = x + d45.x * py[k];
                  x = x + one;
                  v[k][i] = x * (float)1e-6;
                }
              }
            }
          }
          if (s == 0) {
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                if (i < kAcc) c[k][i] = v[k][i];
                else drop(v[k][i]);
              }
          }
        } else {
          // Σ over the segment's rows, segments added in order
          // (tools/exp_mxu.py:132-139).
          float v[2][8];
          feature_sums<kAcc>(fs, a, v);
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < kAcc; ++i)
              c[k][i] = s == 0 ? v[k][i] : c[k][i] + v[k][i];
        }
      }
    }
    if constexpr (kPerBlock) {
      float* o = out + (size_t)b * kOut * kPix;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < kOut; ++i)
          o[i * kPix + pix[k]] = i < kAcc ? c[k][i] : 0.0f;
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) tot[k][i] = tot[k][i] + c[k][i];
    }
  }

  if constexpr (!kPerBlock) {
    // This CTA's partial; the last CTA of its group adds the group's, the
    // last group the group sums (see the header).
    const int ctas = gridDim.x;
    const int ngroups = (ctas + kGroup - 1) / kGroup;
    const int grp = blockIdx.x / kGroup;
    const int c0 = grp * kGroup, c1 = min(ctas, c0 + kGroup);
    float* mine = partial + (size_t)blockIdx.x * kPart;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) mine[i * kPix + pix[k]] = tot[k][i];
    __threadfence();
    __syncthreads();
    unsigned* group_tickets = tickets + 1;
    if (tid == 0) {
      const unsigned n = atomicAdd(group_tickets + grp, 1u);
      s_last = n == (unsigned)(c1 - c0 - 1);
      if (s_last) group_tickets[grp] = 0u;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      float sum[2][kAcc];
      add_slots(partial, c0, c1, pix, sum);
      bool final_sum = ngroups == 1;
      if (!final_sum) {
        float* gsum = partial + ((size_t)ctas + grp) * kPart;
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) gsum[i * kPix + pix[k]] = sum[k][i];
        __threadfence();
        __syncthreads();
        if (tid == 0) {
          const unsigned n = atomicAdd(group_tickets + ngroups, 1u);
          s_last = n == (unsigned)(ngroups - 1);
          if (s_last) group_tickets[ngroups] = 0u;
        }
        __syncthreads();
        final_sum = s_last;
        if (final_sum) {
          __threadfence();
          add_slots(partial, ctas, ctas + ngroups, pix, sum);
        }
      }
      if (final_sum) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < kOut; ++i)
            out[i * kPix + pix[k]] = i < kAcc ? sum[k][i] : 0.0f;
      }
    }
  }
  if (junk == kSinkKey) tickets[0] = junk;
}

template <int V, bool kTC, bool kPerBlock>
int launch(const float* pay, const float* g, float* out, float* df,
           float* partial, int capacity, unsigned* tickets, int B,
           cudaStream_t s) {
  long long resident = 0;
  const int err = resident_ctas(mxu_probe_kernel<V, kTC, kPerBlock>,
                                kThreads, Smem<V, kTC>::kBytes,
                                kMaxCtasPerSm, resident);
  if (err != 0) return err;
  const int ctas = (int)(resident < B ? resident : B);
  if (!kPerBlock && capacity < ctas + (ctas + kGroup - 1) / kGroup)
    return (int)cudaErrorInvalidValue;
  mxu_probe_kernel<V, kTC, kPerBlock>
      <<<ctas, kThreads, Smem<V, kTC>::kBytes, s>>>(pay, g, out, df, partial,
                                                     tickets, B);
  return (int)cudaGetLastError();
}

template <int V, bool kTC>
int launch_mode(const float* pay, const float* g, float* out, float* df,
                float* partial, int capacity, unsigned* tickets, int B,
                int per_block, cudaStream_t s) {
  return per_block
             ? launch<V, kTC, true>(pay, g, out, df, partial, capacity,
                                    tickets, B, s)
             : launch<V, kTC, false>(pay, g, out, df, partial, capacity,
                                     tickets, B, s);
}

template <int V>
int launch_precision(const float* pay, const float* g, float* out,
                     float* df, float* partial, int capacity,
                     unsigned* tickets, int B, int high, int per_block,
                     cudaStream_t s) {
  return high ? launch_mode<V, true>(pay, g, out, df, partial, capacity,
                                     tickets, B, per_block, s)
              : launch_mode<V, false>(pay, g, out, df, partial, capacity,
                                      tickets, B, per_block, s);
}

template <int V, bool kTC>
int info_mode(int per_block, int* out) {
  return per_block
             ? fill_kernel_info(mxu_probe_kernel<V, kTC, true>, kThreads,
                                Smem<V, kTC>::kBytes, out)
             : fill_kernel_info(mxu_probe_kernel<V, kTC, false>, kThreads,
                                Smem<V, kTC>::kBytes, out);
}

template <int V, bool kTC>
int info(int per_block, int* out) {
  // The runtime refuses more than 48 KB of dynamic shared memory until it
  // is allowed; resident_ctas allows it.
  long long ctas = 0;
  const int err =
      per_block ? resident_ctas(mxu_probe_kernel<V, kTC, true>, kThreads,
                                Smem<V, kTC>::kBytes, kMaxCtasPerSm, ctas)
                : resident_ctas(mxu_probe_kernel<V, kTC, false>, kThreads,
                                Smem<V, kTC>::kBytes, kMaxCtasPerSm, ctas);
  return err != 0 ? err : info_mode<V, kTC>(per_block, out);
}

}  // namespace

extern "C" {

// payload: (B, 128, 16) float32, 16-byte aligned. g_rows: (8, 256) for
// dfeat_nt, else unused. per_block: out is (B, 8, 256) and, for dfeat_nt,
// df_out (B, 128, 8); else out is (8, 256) and partial a scratch of
// `capacity` (5, 256) slots, at least the grid plus a slot for each group
// of 32 CTAs. tickets: uint32 words, word 0 a sink, then one per group and
// one more, all 0 (each launch leaves them 0). variant: 0 empty, 1 base,
// 2 exp2, 3 pow_mxu, 4 scan_mxu, 5 acc_tn, 6 dfeat_nt; high: 3×TF32
// tensor cores (matmul variants only).
int msgs_mxu_probe(const void* payload, const void* g_rows, void* out,
                   void* df_out, void* partial, int capacity, void* tickets,
                   int B, int variant, int high, int per_block,
                   void* stream) {
  if (B <= 0 || variant < kEmpty || variant > kDfeatNt ||
      (high && variant < kPowMxu) || (variant == kDfeatNt && !g_rows) ||
      (per_block && variant == kDfeatNt && !df_out) || !tickets ||
      (!per_block && !partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)payload;
  const float* g = (const float*)g_rows;
  float* o = (float*)out;
  float* d = (float*)df_out;
  float* part = (float*)partial;
  unsigned* tk = (unsigned*)tickets;
  switch (variant) {
    case kEmpty: return launch_mode<kEmpty, false>(p, g, o, d, part, capacity, tk, B, per_block, s);
    case kBase: return launch_mode<kBase, false>(p, g, o, d, part, capacity, tk, B, per_block, s);
    case kExp2: return launch_mode<kExp2, false>(p, g, o, d, part, capacity, tk, B, per_block, s);
    case kPowMxu: return launch_precision<kPowMxu>(p, g, o, d, part, capacity, tk, B, high, per_block, s);
    case kScanMxu: return launch_precision<kScanMxu>(p, g, o, d, part, capacity, tk, B, high, per_block, s);
    case kAccTn: return launch_precision<kAccTn>(p, g, o, d, part, capacity, tk, B, high, per_block, s);
    default: return launch_precision<kDfeatNt>(p, g, o, d, part, capacity, tk, B, high, per_block, s);
  }
}

// The summed output's scratch for a card of `sms` SMs, at the largest grid
// it can hold: out[0] the (5, 256) partial slots (the grid's and a sum for
// each group of kGroup CTAs), out[1] the ticket words (a sink, one for
// each group and one more).
int msgs_mxu_probe_scratch(int sms, int* out) {
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int ctas = sms * kMaxCtasPerSm;
  const int groups = (ctas + kGroup - 1) / kGroup;
  out[0] = ctas + groups;
  out[1] = groups + 2;
  return 0;
}

// The build of instance i = 4·variant + 2·high + per_block
// (kernels/mxu_probe.py:PROBE_INSTANCES lists the valid ones).
int msgs_mxu_probe_info(int i, int* out) {
  const int variant = i >> 2, high = (i >> 1) & 1, per_block = i & 1;
  if (i < 0 || variant > kDfeatNt || (high && variant < kPowMxu))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kEmpty: return info<kEmpty, false>(per_block, out);
    case kBase: return info<kBase, false>(per_block, out);
    case kExp2: return info<kExp2, false>(per_block, out);
    case kPowMxu: return high ? info<kPowMxu, true>(per_block, out) : info<kPowMxu, false>(per_block, out);
    case kScanMxu: return high ? info<kScanMxu, true>(per_block, out) : info<kScanMxu, false>(per_block, out);
    case kAccTn: return high ? info<kAccTn, true>(per_block, out) : info<kAccTn, false>(per_block, out);
    default: return high ? info<kDfeatNt, true>(per_block, out) : info<kDfeatNt, false>(per_block, out);
  }
}

}  // extern "C"
