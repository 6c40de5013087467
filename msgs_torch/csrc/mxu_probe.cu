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
// Design. One CTA of 256 threads, a thread per pixel, walks
// kBlocksPerCta consecutive blocks. For each it stages the block's 8 KB in
// shared memory (float4 loads; `empty` stages it too and so measures the
// streaming floor), then walks the 4 segments: each thread keeps the
// segment's 32 powers, α and w and its running sums in registers. Where a
// formulation contracts over entries or pixels, the operand goes through
// shared memory:
//   pow_mxu   power = coefficients (32×8 per segment) @ basis (8×256)
//   scan_mxu  cs = tri (32×32 lower ones) @ log1p(−α) (32×256): the four
//             diagonal blocks of the TPU's dense (128×128) product, whose
//             zero blocks add exact zeros
//   acc_tn    featᵀ (8×32) @ w (32×256) per segment; segment 0's rows are
//             kept, the others computed and dropped, as the TPU drops them
//   dfeat_nt  df = w (32×256) @ g_rowsᵀ (256×8) per segment, all 128 rows;
//             then (df[:8] @ basis)·1e-6
// at precision HIGHEST as fp32 dot products on the CUDA cores, each
// element summed in k order (the plain version's order), and at HIGH as
// 3×TF32 `mma.sync.m16n8k8` (x = big + small, big = tf32(x), small =
// tf32(x − big); small·big + big·small + big·big, fp32 accumulation).
// Values the TPU computes and drops are kept from dead-code elimination by
// an empty asm that reads them.
//
// The sum over blocks: each CTA adds its blocks' terms in block order into
// per-thread registers and writes one (8, 256) partial; a second kernel
// adds 8 ranges of the partials, each in CTA order, then the 8 range sums
// in order. The order is fixed by B alone, so two
// launches are bit-identical (no atomics); it is not the TPU's grid order
// (a running sum over all B), and the plain version sums the per-block
// terms with torch.sum. All terms are ≥ 0 for every variant but dfeat_nt,
// so the orders differ by a few ulps of the sum.
//
// Built with -fmad=false (kernels/_build.py): the HIGHEST runs' dot
// products are separate multiplies and adds, as the plain version rounds
// them, so the f32 runs equal it per block wherever expf, exp2f and
// log1pf agree with torch's; fused, they would be fewer instructions.
//
// Bound on the H100: operations. A block reads 8 KB and does ~40 fp32
// operations for each of its 32,768 (entry, pixel) pairs (base), about
// 160 per byte, past the card's 20 fp32 operations per byte of HBM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

constexpr int kBlock = 128;   // payload rows per block
constexpr int kPix = 256;     // pixels per block, one thread each
constexpr int kFeat = 16;     // payload columns
constexpr int kSub = msgs_composite::kSub;   // 32 rows per segment
constexpr int kNSub = kBlock / kSub;
constexpr int kOut = 8;       // accumulator rows
constexpr int kAcc = 5;       // rows the variants add into
constexpr int kNdf = 8;       // df columns
constexpr int kBlocksPerCta = 8;   // kernels/mxu_probe.py BLOCKS_PER_CTA

enum Variant { kEmpty = 0, kBase, kExp2, kPowMxu, kScanMxu, kAccTn,
               kDfeatNt };

// Keeps x computed without storing it.
__device__ __forceinline__ void sink(float x) { asm volatile("" ::"f"(x)); }

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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16×8) += A (16×K) @ B (K×8) in 3×TF32, for one warp. A(m, k) and
// B(k, n) read the tile's operands. Fragments of m16n8k8 (PTX ISA): with
// g = lane / 4 and t = lane % 4, a = A(g, t), A(g+8, t), A(g, t+4),
// A(g+8, t+4); b = B(t, g), B(t+4, g); c = C(g, 2t), C(g, 2t+1),
// C(g+8, 2t), C(g+8, 2t+1).
template <int K, class FA, class FB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], FA A, FB B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    split_tf32(A(g, k0 + t), ab[0], as[0]);
    split_tf32(A(g + 8, k0 + t), ab[1], as[1]);
    split_tf32(A(g, k0 + t + 4), ab[2], as[2]);
    split_tf32(A(g + 8, k0 + t + 4), ab[3], as[3]);
    split_tf32(B(k0 + t, g), bb[0], bs[0]);
    split_tf32(B(k0 + t + 4, g), bb[1], bs[1]);
    mma_tf32(c, as, bb);
    mma_tf32(c, ab, bs);
    mma_tf32(c, ab, bb);
  }
}

// Stores a c fragment through S(row, col, value).
template <class FS>
__device__ __forceinline__ void store_tile(const float (&c)[4], FS S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  S(g, 2 * t, c[0]);
  S(g, 2 * t + 1, c[1]);
  S(g + 8, 2 * t, c[2]);
  S(g + 8, 2 * t + 1, c[3]);
}

// Shared memory of one variant, in floats: the staged block, then what the
// formulation contracts through.
template <int V, bool kTC>
struct Smem {
  // Row stride of the (32, 256) segment matrix: ≡ 8 (mod 32) where the
  // tensor cores read it as B (rows are k), ≡ 4 where dfeat_nt reads it
  // as A (rows are m) or walks it by rows; either way fragment reads are
  // free of bank conflicts.
  static constexpr int kLd = V == kDfeatNt ? 260 : 264;
  static constexpr int kLdG = 260;
  static constexpr bool kMat = V == kDfeatNt ||
      (kTC && (V == kPowMxu || V == kScanMxu || V == kAccTn));
  static constexpr int kFeatOff = 0;
  static constexpr int kCoefOff = kFeatOff + kBlock * kFeat;
  static constexpr int kMatOff = kCoefOff + (V == kPowMxu ? kBlock * 8 : 0);
  static constexpr int kGOff = kMatOff + (kMat ? kSub * kLd : 0);
  static constexpr int kDfOff = kGOff + (V == kDfeatNt ? kNdf * kLdG : 0);
  static constexpr int kFloats =
      kDfOff + (V == kDfeatNt ? kBlock * kNdf : 0);
  static constexpr int kBytes = kFloats * 4;
};

// The 3×TF32 products of a segment, each by the 8 warps. The warp owns
// n-tiles 4w..4w+3 (columns 32w..32w+31) of every 256-wide product.

// power (32×256) = coef (32×8) @ basis (8×256) into mat.
__device__ __forceinline__ void pow_mma(const float* coef, float* mat,
                                        int ld) {
  const int w = threadIdx.x >> 5;
#pragma unroll 1
  for (int nt = 0; nt < 4; ++nt) {
    const int n0 = (4 * w + nt) * 8;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32<8>(
          c, [&](int m, int k) { return coef[(16 * mt + m) * 8 + k]; },
          [&](int k, int n) { return basis(k, n0 + n); });
      store_tile(c, [&](int m, int n, float v) {
        mat[(16 * mt + m) * ld + n0 + n] = v;
      });
    }
  }
}

// cs (32×256) = tri (32×32) @ lf (32×256), in place in mat: the warp reads
// all 32 rows of its columns before it writes them.
__device__ __forceinline__ void scan_mma(float* mat, int ld) {
  const int w = threadIdx.x >> 5;
#pragma unroll 1
  for (int nt = 0; nt < 4; ++nt) {
    const int n0 = (4 * w + nt) * 8;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_3xtf32<kSub>(
          c[mt],
          [&](int m, int k) { return k <= 16 * mt + m ? 1.0f : 0.0f; },
          [&](int k, int n) { return mat[k * ld + n0 + n]; });
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      store_tile(c[mt], [&](int m, int n, float v) {
        mat[(16 * mt + m) * ld + n0 + n] = v;
      });
    __syncwarp();
  }
}

// acc (8×256) = featᵀ (8×32: features 6..13 of the segment's rows) @ w
// (32×256), M padded to 16 with zero rows; rows 0..7 replace mat's rows
// 0..7 in place.
__device__ __forceinline__ void acc_mma(const float* fs, float* mat, int ld) {
  const int w = threadIdx.x >> 5;
#pragma unroll 1
  for (int nt = 0; nt < 4; ++nt) {
    const int n0 = (4 * w + nt) * 8;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32<kSub>(
        c, [&](int m, int k) { return m < 8 ? fs[k * kFeat + 6 + m] : 0.0f; },
        [&](int k, int n) { return mat[k * ld + n0 + n]; });
    __syncwarp();
    store_tile(c, [&](int m, int n, float v) {
      if (m < 8) mat[m * ld + n0 + n] = v;
    });
    __syncwarp();
  }
}

template <int V, bool kTC, bool kPerBlock>
__global__ void __launch_bounds__(kPix)
mxu_probe_kernel(const float* __restrict__ pay,
                 const float* __restrict__ g_rows, float* __restrict__ out,
                 float* __restrict__ df_out, int B) {
  using L = Smem<V, kTC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sfeat = smem + L::kFeatOff;
  float* scoef = smem + L::kCoefOff;
  float* smat = smem + L::kMatOff;
  float* sg = smem + L::kGOff;
  float* sdf = smem + L::kDfOff;
  constexpr int ld = L::kLd;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const float px = (float)(p & 15), py = (float)(p >> 4);

  if constexpr (V == kDfeatNt) {
    for (int i = p; i < kNdf * kPix; i += kPix)
      sg[(i / kPix) * L::kLdG + (i % kPix)] = g_rows[i];
  }
  float tot[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const int b0 = blockIdx.x * kBlocksPerCta;
  const int b1 = min(B, b0 + kBlocksPerCta);
#pragma unroll 1
  for (int b = b0; b < b1; ++b) {
    __syncthreads();   // the previous block's readers are done
    {
      const float4* src =
          reinterpret_cast<const float4*>(pay) + (size_t)b * (kBlock * kFeat / 4);
      float4* dst = reinterpret_cast<float4*>(sfeat);
      dst[p] = __ldg(src + p);
      dst[p + kPix] = __ldg(src + p + kPix);
    }
    __syncthreads();
    if constexpr (V == kPowMxu) {
      // Tile-origin coefficients of row p (tools/exp_mxu.py:96-107).
      if (p < kBlock) {
        const float* e = sfeat + p * kFeat;
        const float mx = e[0], my = e[1], cxx = e[2], cxy = e[3],
                    cyy = e[4];
        float* co = scoef + p * 8;
        co[0] = -0.5f * cxx;
        co[1] = -cxy;
        co[2] = -0.5f * cyy;
        co[3] = cxx * mx + cxy * my;
        co[4] = cyy * my + cxy * mx;
        co[5] = -0.5f * (cxx * mx * mx + cyy * my * my) - cxy * mx * my;
        co[6] = 0.0f;
        co[7] = 0.0f;
      }
      __syncthreads();
    }

    // This block's accumulator rows at this pixel; rows kAcc.. are
    // computed by acc_tn and dfeat_nt and dropped.
    float c[kOut] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (V == kEmpty) {
      c[0] = sfeat[6] * px;
    } else {
#pragma unroll 1
      for (int s = 0; s < kNSub; ++s) {
        const float* fs = sfeat + s * kSub * kFeat;
        if constexpr (V == kPowMxu && kTC) {
          __syncthreads();
          pow_mma(scoef + s * kSub * 8, smat, ld);
          __syncthreads();
        }
        // α of the segment's 32 rows at this pixel.
        float a[kSub];
#pragma unroll
        for (int r = 0; r < kSub; ++r) {
          const float* e = fs + r * kFeat;
          float pw;
          if constexpr (V == kPowMxu && kTC) {
            pw = smat[r * ld + p];
          } else if constexpr (V == kPowMxu) {
            const float* co = scoef + (s * kSub + r) * 8;
            pw = co[0] * (px * px) + co[1] * (px * py);
            pw = pw + co[2] * (py * py);
            pw = pw + co[3] * px;
            pw = pw + co[4] * py;
            pw = pw + co[5] * 1.0f;
          } else {
            const float dx = px - e[0];
            const float dy = py - e[1];
            pw = -0.5f * (e[2] * dx * dx + e[4] * dy * dy) - e[3] * dx * dy;
          }
          const float gg = V == kExp2
              ? exp2f(pw * (float)1.4426950408889634) : expf(pw);
          const float ar = e[5] * gg;
          const bool m = (ar >= msgs_composite::alpha_min()) && (pw <= 0.0f);
          a[r] = m ? fminf(ar, msgs_composite::alpha_max()) : 0.0f;
        }
        // w = α·T_excl·alive.
        float wv[kSub];
        if constexpr (V == kScanMxu) {
          float cs[kSub];
#pragma unroll
          for (int r = 0; r < kSub; ++r) cs[r] = log1pf(-a[r]);
          if constexpr (kTC) {
            __syncthreads();
#pragma unroll
            for (int r = 0; r < kSub; ++r) smat[r * ld + p] = cs[r];
            __syncthreads();
            scan_mma(smat, ld);
            __syncthreads();
#pragma unroll
            for (int r = 0; r < kSub; ++r) cs[r] = smat[r * ld + p];
          } else {
#pragma unroll
            for (int r = 1; r < kSub; ++r) cs[r] = cs[r - 1] + cs[r];
          }
#pragma unroll
          for (int r = 0; r < kSub; ++r) {
            const float cum = expf(cs[r]);
            const float ce = cum / fmaxf(1.0f - a[r], (float)1e-6);
            wv[r] = (a[r] * ce) * (cum >= msgs_composite::t_eps() ? 1.0f
                                                                  : 0.0f);
          }
        } else {
          float cum[kSub];
#pragma unroll
          for (int r = 0; r < kSub; ++r) cum[r] = 1.0f - a[r];
          msgs_composite::hs_prefix_product(cum);
#pragma unroll
          for (int r = 0; r < kSub; ++r) {
            const float ce = r == 0 ? 1.0f : cum[r - 1];
            wv[r] = (a[r] * ce) * (cum[r] >= msgs_composite::t_eps() ? 1.0f
                                                                     : 0.0f);
          }
        }
        // The accumulation.
        if constexpr (V == kAccTn && kTC) {
          __syncthreads();
#pragma unroll
          for (int r = 0; r < kSub; ++r) smat[r * ld + p] = wv[r];
          __syncthreads();
          acc_mma(fs, smat, ld);
          __syncthreads();
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = smat[j * ld + p];
            if (s == 0) c[j] = v; else sink(v);
          }
        } else if constexpr (V == kAccTn) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = fs[6 + j] * wv[0];
#pragma unroll
            for (int r = 1; r < kSub; ++r) v = v + fs[r * kFeat + 6 + j] * wv[r];
            if (s == 0) c[j] = v; else sink(v);
          }
        } else if constexpr (V == kDfeatNt) {
          __syncthreads();
#pragma unroll
          for (int r = 0; r < kSub; ++r) smat[r * ld + p] = wv[r];
          __syncthreads();
          const int rr = p >> 3, j = p & 7;   // this thread's df element
          float d;
          if constexpr (kTC) {
            // K = 256 split over 4 warp pairs: warp w takes m-tile w % 2
            // and pixels 64·(w / 2) .. +63; the partials add in chunk
            // order.
            const int mt = warp & 1, k0 = (warp >> 1) * 64;
            float cc[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32<64>(
                cc, [&](int m, int k) { return smat[(16 * mt + m) * ld + k0 + k]; },
                [&](int k, int n) { return sg[n * L::kLdG + k0 + k]; });
            __syncthreads();   // every warp has read w
            store_tile(cc, [&](int m, int n, float v) {
              smat[((warp >> 1) * kSub + 16 * mt + m) * kNdf + n] = v;
            });
            __syncthreads();
            d = smat[rr * kNdf + j];
#pragma unroll
            for (int q = 1; q < 4; ++q) d = d + smat[(q * kSub + rr) * kNdf + j];
          } else {
            const float* wr = smat + rr * ld;
            const float* gr = sg + j * L::kLdG;
            d = wr[0] * gr[0];
#pragma unroll 8
            for (int q = 1; q < kPix; ++q) d = d + wr[q] * gr[q];
          }
          sdf[(s * kSub + rr) * kNdf + j] = d;
          if constexpr (kPerBlock)
            df_out[((size_t)b * kBlock + s * kSub + rr) * kNdf + j] = d;
          else
            sink(d);
          if (s == 0) {
            // (df[:8] @ basis)·1e-6, rows 0..4 kept (tools/exp_mxu.py:196-
            // 199, :202).
            __syncthreads();   // sdf rows 0..7 written, smat's readers done
            float v[8];
            if constexpr (kTC) {
#pragma unroll 1
              for (int nt = 0; nt < 4; ++nt) {
                const int n0 = (4 * warp + nt) * 8;
                float cc[4] = {0.f, 0.f, 0.f, 0.f};
                mma_3xtf32<8>(
                    cc, [&](int m, int k) { return m < 8 ? sdf[m * kNdf + k] : 0.0f; },
                    [&](int k, int n) { return basis(k, n0 + n); });
                store_tile(cc, [&](int m, int n, float x) {
                  if (m < 8) smat[m * ld + n0 + n] = x;
                });
              }
              __syncthreads();
#pragma unroll
              for (int i = 0; i < 8; ++i) v[i] = smat[i * ld + p] * (float)1e-6;
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float* di = sdf + i * kNdf;
                float x = di[0] * (px * px) + di[1] * (px * py);
                x = x + di[2] * (py * py);
                x = x + di[3] * px;
                x = x + di[4] * py;
                x = x + di[5] * 1.0f;
                v[i] = x * (float)1e-6;
              }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) c[i] = v[i];
          }
        } else {
          // Σ over the segment's rows, segments added in order
          // (tools/exp_mxu.py:132-139).
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            float v = fs[6 + i] * wv[0];
#pragma unroll
            for (int r = 1; r < kSub; ++r) v = v + fs[r * kFeat + 6 + i] * wv[r];
            c[i] = s == 0 ? v : c[i] + v;
          }
        }
      }
    }
#pragma unroll
    for (int i = kAcc; i < kOut; ++i) sink(c[i]);
    if constexpr (kPerBlock) {
      float* o = out + (size_t)b * kOut * kPix;
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i * kPix + p] = i < kAcc ? c[i] : 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) tot[i] = tot[i] + c[i];
    }
  }
  if constexpr (!kPerBlock) {
    float* o = out + (size_t)blockIdx.x * kOut * kPix;
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i * kPix + p] = i < kAcc ? tot[i] : 0.0f;
  }
}

// out[i] = Σ over the n partials, for the 8·256 outputs: a CTA takes 32
// outputs, its 8 warps 8 consecutive ranges of the partials; each warp
// sums its range in order, then the 8 range sums add in order. The order
// depends on n alone.
__global__ void __launch_bounds__(kPix)
sum_partials(const float* __restrict__ part, float* __restrict__ out,
             int n) {
  __shared__ float sums[kPix / 32][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int per = (n + kPix / 32 - 1) / (kPix / 32);
  const int q1 = min(n, (grp + 1) * per);
  float s = 0.0f;
#pragma unroll 8
  for (int q = grp * per; q < q1; ++q)
    s = s + part[(size_t)q * kOut * kPix + i];
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0) {
    float t = sums[0][lane];
#pragma unroll
    for (int k = 1; k < kPix / 32; ++k) t = t + sums[k][lane];
    out[i] = t;
  }
}

template <int V, bool kTC, bool kPerBlock>
int launch(const float* pay, const float* g, float* out, float* df,
           float* partial, int B, cudaStream_t s) {
  constexpr int bytes = Smem<V, kTC>::kBytes;
  auto* k = mxu_probe_kernel<V, kTC, kPerBlock>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int ctas = (B + kBlocksPerCta - 1) / kBlocksPerCta;
  k<<<ctas, kPix, bytes, s>>>(pay, g, kPerBlock ? out : partial, df, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || kPerBlock) return (int)e;
  sum_partials<<<kOut * kPix / 32, kPix, 0, s>>>(partial, out, ctas);
  return (int)cudaGetLastError();
}

template <int V, bool kTC>
int launch_mode(const float* pay, const float* g, float* out, float* df,
                float* partial, int B, int per_block, cudaStream_t s) {
  return per_block ? launch<V, kTC, true>(pay, g, out, df, partial, B, s)
                   : launch<V, kTC, false>(pay, g, out, df, partial, B, s);
}

template <int V>
int launch_precision(const float* pay, const float* g, float* out,
                     float* df, float* partial, int B, int high,
                     int per_block, cudaStream_t s) {
  return high ? launch_mode<V, true>(pay, g, out, df, partial, B, per_block, s)
              : launch_mode<V, false>(pay, g, out, df, partial, B, per_block,
                                      s);
}

}  // namespace

extern "C" {

// payload: (B, 128, 16) float32, 16-byte aligned. g_rows: (8, 256) for
// dfeat_nt, else unused. per_block: out is (B, 8, 256) and, for dfeat_nt,
// df_out (B, 128, 8); else out is (8, 256) and partial a (ceil(B / 8), 8,
// 256) scratch. variant: 0 empty, 1 base, 2 exp2, 3 pow_mxu, 4 scan_mxu,
// 5 acc_tn, 6 dfeat_nt; high: 3×TF32 tensor cores (matmul variants only).
int msgs_mxu_probe(const void* payload, const void* g_rows, void* out,
                   void* df_out, void* partial, int B, int variant, int high,
                   int per_block, void* stream) {
  if (B <= 0 || variant < kEmpty || variant > kDfeatNt ||
      (high && variant < kPowMxu) || (variant == kDfeatNt && !g_rows) ||
      (per_block && variant == kDfeatNt && !df_out) ||
      (!per_block && !partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)payload;
  const float* g = (const float*)g_rows;
  float* o = (float*)out;
  float* d = (float*)df_out;
  float* part = (float*)partial;
  switch (variant) {
    case kEmpty: return launch_mode<kEmpty, false>(p, g, o, d, part, B, per_block, s);
    case kBase: return launch_mode<kBase, false>(p, g, o, d, part, B, per_block, s);
    case kExp2: return launch_mode<kExp2, false>(p, g, o, d, part, B, per_block, s);
    case kPowMxu: return launch_precision<kPowMxu>(p, g, o, d, part, B, high, per_block, s);
    case kScanMxu: return launch_precision<kScanMxu>(p, g, o, d, part, B, high, per_block, s);
    case kAccTn: return launch_precision<kAccTn>(p, g, o, d, part, B, high, per_block, s);
    default: return launch_precision<kDfeatNt>(p, g, o, d, part, B, high, per_block, s);
  }
}

}  // extern "C"
