// The compositor forward with single pieces switched off: the forward
// variants of the ablation tool. The contract and the plain version are
// msgs_torch/kernels/ablate.py (fwd_ablate_plain).
//
// Replaces tools/exp_fwd_ablate.py:97 `fwd_kernel_var`, built by `make_fwd`
// :193 and called at :216: the real forward (msgs/kernels/composite.py:401
// _fwd_kernel) over a sequential grid of 8-block steps that carries one
// running (8, 256) state in VMEM scratch, with one piece removed per
// variant (full, dump_last, no_dump, small_out, no_states, pairs_only,
// pairs_noaccs, pairs_noscan, pairs_alpha).
//
// Design. The variants that keep the per-tile state (full, dump_last,
// no_dump, small_out) run as composite_fwd.cu: one CTA per tile, one thread
// per pixel, walking the tile's subs in order with the state in registers
// and each sub's 32 payload rows staged in shared memory; the sub step is
// composite_fwd.cu's (composite_common.cuh:composite_sub). The CTA finds
// its subs by binary search over sub_tile within the computed blocks, and
// applies the TPU kernel's block rules itself: a block all of whose subs
// continue the tile, reached with all 256 pixels done, is skipped (its
// slots take the unchanged state); every other block computes, including
// subs after saturation, whose state does not change. Each variant writes
// the slots the TPU kernel writes, and marks them in `written`.
//
// no_states and the pairs variants add a per-block term to a running state
// over the whole stream, across tiles: one CTA per block computes the
// block's term (no_states chains the block's runs from T = 1 or from the
// zero state it reads at a carried sub; the pairs variants evaluate α at
// tile-local pixels with no tile origin), and a second kernel adds the
// terms in block order for each (row, pixel), the TPU's sequential order,
// writing slot 4b of every computed block.
//
// Built with -fmad=false: every sum runs in the plain version's order, so
// the kernel equals it bit for bit wherever expf agrees with torch's.
//
// Bound on the H100: operations for the tile variants (the α evaluation
// and prefix product, ~46 fp32 operations per (entry, pixel) pair, over
// every computed sub), and the state dumps' bytes for full (8 KB per
// sub); the pairs variants the same α per pair with no early exit. The
// running sum is a dependent chain of one add per block per (row, pixel):
// its latency, not its bytes, bounds it, and the kernel keeps 32 loads in
// flight per thread to hide it.
//
// Also replaces tools/exp_bwd2.py:92 `fwd_horner_kernel`, built by
// `make_simple` :141 and called at :153: pairs_only with the power from
// per-entry Horner coefficients (:112-120), the `kHorner` instance of
// fwd_block_kernel. Its threads 0-127 first compute the block's 128
// entries' coefficients (a, b, c, d, e, f0) and opacity into shared memory,
// in the script's order; each pixel's thread then evaluates u = a·x + d,
// v = c·y + e and power = (u + b·y)·x + v·y + f0 per entry (10 operations
// where splat_alpha takes 11, about 20 with the mask against 21). The TPU
// writes slot 4b of each computed block with its running state, as the
// other block variants do, and so does running_sum_kernel.
#include "composite_common.cuh"

namespace {

using namespace msgs_composite;

constexpr int kBlock = kNSub * kSub;   // 128 rows per block
constexpr int kGroup = 8;              // blocks per grid step
constexpr int kAcc = 5;                // rows r g b depth acc
constexpr int kBatch = 32;             // running-sum loads in flight

// kernels/ablate.py ALL_FWD (FWD_VARIANTS, then HORNER_VARIANTS), in order.
enum Variant { kFull = 0, kDumpLast, kNoDump, kNoStates, kPairsOnly,
               kPairsNoaccs, kPairsNoscan, kPairsAlpha, kSmallOut, kHorner };
constexpr int kCoef = 8;   // horner: a b c d e f0 op, padded

// horner's per-entry coefficients (tools/exp_bwd2.py:112-117), into
// c[0..6] = a, b, c, d, e, f0, op.
__device__ __forceinline__ void horner_coefs(const float* e, float* c) {
  const float mx = e[F_MX], my = e[F_MY];
  const float cxx = e[F_CXX], cxy = e[F_CXY], cyy = e[F_CYY];
  c[0] = -0.5f * cxx;
  c[1] = -cxy;
  c[2] = -0.5f * cyy;
  c[3] = cxx * mx + cxy * my;
  c[4] = cyy * my + cxy * mx;
  c[5] = -0.5f * (cxx * mx * mx + cyy * my * my) - cxy * mx * my;
  c[6] = e[F_OP];
}

// α of one entry at tile-local pixel (pxl, pyl) from its coefficients
// (:118-127).
__device__ __forceinline__ float horner_alpha(const float* c, float pxl,
                                              float pyl) {
  const float u = c[0] * pxl + c[3];
  const float v = c[2] * pyl + c[4];
  const float power = (u + c[1] * pyl) * pxl + v * pyl + c[5];
  const float araw = c[6] * expf(power);
  const bool m = (araw >= alpha_min()) && (power <= 0.0f);
  return m ? fminf(araw, alpha_max()) : 0.0f;
}

// Keeps x computed without storing it (no_dump's colour sums, which the
// TPU kernel computes into its state and never stores).
__device__ __forceinline__ void sink(float x) { asm volatile("" ::"f"(x)); }

__device__ __forceinline__ float outside(float pxl, float pyl, float ox,
                                         float oy, int width, int height) {
  return ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height)
             ? 1.0f : 0.0f;
}

template <int V>
__global__ void __launch_bounds__(kPix)
fwd_tile_kernel(const float* __restrict__ payload,
                const int* __restrict__ sub_tile,
                const int* __restrict__ sub_valid,
                float* __restrict__ out, unsigned char* __restrict__ written,
                int n_blocks, int tiles_x, int width, int height) {
  __shared__ float sp[kSub * kFeat];
  __shared__ int run[3];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  if (p == 0) {
    const int nb = computed_blocks(sub_valid, n_blocks);
    run[0] = lower_bound(sub_tile, nb * kNSub, tile);
    run[1] = lower_bound(sub_tile, nb * kNSub, tile + 1);
    run[2] = nb;
  }
  __syncthreads();
  const int s0 = run[0], s1 = run[1], nb = run[2];
  if (s0 >= s1) return;

  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;
  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);
  float acc[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float T = 1.0f;
  float done = outside(pxl, pyl, ox, oy, width, height);
  bool sat = false;    // all 256 pixels done (uniform over the CTA)
  bool skip = false;   // the current block is skipped

  for (int j = s0; j < s1; ++j) {
    if (j % kNSub == 0) skip = j > s0 && j + kNSub - 1 < s1 && sat;
    if (!skip) {
      const float* src = payload + (long long)j * (kSub * kFeat);
      for (int i = p; i < kSub * kFeat; i += kPix) sp[i] = src[i];
      __syncthreads();
      float loc[kAcc];
      composite_sub(sp, ox, oy, pxl, pyl, T, done, loc);
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[c] = acc[c] + loc[c];
      // Also the barrier before the next sub overwrites sp.
      sat = __syncthreads_count(done != 0.0f) == kPix;
    }
    int slot = -1;
    if (V == kFull) {
      slot = j;
    } else if (V == kDumpLast) {
      slot = skip ? j : (j % kNSub == kNSub - 1 ? j - (kNSub - 1) : -1);
    } else if (V == kSmallOut) {
      const int s = j / (kNSub * kGroup);
      const int b_last = min(s * kGroup + kGroup - 1, nb - 1);
      slot = j == b_last * kNSub + kNSub - 1 ? s : -1;
    }
    if (slot >= 0) {
      float* o = out + (long long)slot * (kOut * kPix) + p;
#pragma unroll
      for (int c = 0; c < kAcc; ++c) o[c * kPix] = acc[c];
      o[O_T * kPix] = T;
      o[O_DONE * kPix] = done;
      o[7 * kPix] = 0.0f;
      if (p == 0) written[slot] = 1;
    }
  }
  if (V == kNoDump) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) sink(acc[c]);
  }
}

// The per-block term of no_states or a pairs variant, (5, 256) per block
// (rows past the variant's are 0); blocks that do not compute write
// nothing.
template <int V>
__global__ void __launch_bounds__(kPix)
fwd_block_kernel(const float* __restrict__ payload,
                 const int* __restrict__ sub_tile,
                 const int* __restrict__ sub_valid,
                 float* __restrict__ partial, int tiles_x, int width,
                 int height) {
  __shared__ __align__(16) float sp[kBlock * kFeat];
  __shared__ float hc[V == kHorner ? kBlock * kCoef : 1];
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  if (sub_valid[b * kNSub] != 1) return;
  const float4* src =
      reinterpret_cast<const float4*>(payload + (long long)b * (kBlock * kFeat));
  for (int i = p; i < kBlock * kFeat / 4; i += kPix)
    reinterpret_cast<float4*>(sp)[i] = src[i];
  __syncthreads();
  if (V == kHorner) {
    if (p < kBlock) horner_coefs(sp + p * kFeat, hc + p * kCoef);
    __syncthreads();
  }

  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);
  float part[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (V == kNoStates) {
    const int prev = b > 0 ? sub_tile[b * kNSub - 1] : -1;
    float T = 0.0f, done = 0.0f;
    for (int k = 0; k < kNSub; ++k) {
      const int j = b * kNSub + k;
      const int tile = sub_tile[j];
      const bool carried = b > 0 && tile == prev;
      const float ox = (float)(tile % tiles_x) * (float)kTile;
      const float oy = (float)(tile / tiles_x) * (float)kTile;
      if (k == 0 && carried) {
        T = 0.0f;      // the never-written state
        done = 0.0f;
      } else if (!carried && (k == 0 || tile != sub_tile[j - 1])) {
        T = 1.0f;
        done = outside(pxl, pyl, ox, oy, width, height);
      }
      float loc[kAcc];
      composite_sub(sp + k * kSub * kFeat, ox, oy, pxl, pyl, T, done, loc);
#pragma unroll
      for (int c = 0; c < kAcc; ++c)
        part[c] = k == 0 ? loc[c] : part[c] + loc[c];
    }
  } else {
    const float kTEps = t_eps();
    float m = 0.0f;   // pairs_alpha, pairs_noaccs: the max over rows
    for (int k = 0; k < kNSub; ++k) {
      const float* rows = sp + k * kSub * kFeat;
      float al[kSub], cu[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        float araw;
        al[i] = V == kHorner
                    ? horner_alpha(hc + (k * kSub + i) * kCoef, pxl, pyl)
                    : splat_alpha(rows + i * kFeat, 0.0f, 0.0f, pxl, pyl,
                                  araw);
        cu[i] = 1.0f - al[i];
      }
      constexpr bool kScan = V == kPairsOnly || V == kPairsNoaccs ||
                             V == kHorner;
      if (kScan) hs_prefix_product(cu);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        float w = al[i];
        if (kScan) {
          const float ce = i == 0 ? 1.0f : cu[i - 1];
          w = al[i] * ce * (cu[i] >= kTEps ? 1.0f : 0.0f);
        }
        if (V == kPairsAlpha || V == kPairsNoaccs) {
          m = fmaxf(m, w);
        } else {
#pragma unroll
          for (int c = 0; c < kAcc; ++c)
            part[c] = part[c] + rows[i * kFeat + F_R + c] * w;
        }
      }
    }
    if (V == kPairsAlpha || V == kPairsNoaccs) part[0] = m;
  }
  float* o = partial + (long long)b * (kAcc * kPix) + p;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) o[c * kPix] = part[c];
}

// Slot 4b of every computed block b: rows 0-4 the sum of the blocks'
// terms up to b, added in block order; rows 5-7 zero. One thread per
// (row, pixel) of the 8 state rows.
__global__ void __launch_bounds__(kPix)
running_sum_kernel(const float* __restrict__ partial,
                   const int* __restrict__ sub_valid,
                   float* __restrict__ out, unsigned char* __restrict__ written,
                   int n_blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i / kPix, p = i % kPix;
  const int nb = computed_blocks(sub_valid, n_blocks);
  float acc = 0.0f;
  for (int b0 = 0; b0 < nb; b0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = r < kAcc && b0 + u < nb
                 ? partial[((long long)(b0 + u) * kAcc + r) * kPix + p]
                 : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b0 + u < nb) {
        acc = acc + v[u];
        out[(long long)(b0 + u) * kNSub * (kOut * kPix) + r * kPix + p] = acc;
        if (i == 0) written[(b0 + u) * kNSub] = 1;
      }
    }
  }
}

template <int V>
int launch_tile(const float* pay, const int* st, const int* sv, float* out,
                unsigned char* wr, int n_blocks, int tiles, int tiles_x,
                int width, int height, cudaStream_t s) {
  fwd_tile_kernel<V><<<tiles, kPix, 0, s>>>(pay, st, sv, out, wr, n_blocks,
                                            tiles_x, width, height);
  return (int)cudaGetLastError();
}

template <int V>
int launch_block(const float* pay, const int* st, const int* sv, float* out,
                 unsigned char* wr, float* partial, int n_blocks,
                 int tiles_x, int width, int height, cudaStream_t s) {
  fwd_block_kernel<V><<<n_blocks, kPix, 0, s>>>(pay, st, sv, partial,
                                                tiles_x, width, height);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  running_sum_kernel<<<kOut, kPix, 0, s>>>(partial, sv, out, wr, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msgs_fwd_ablate(const void* payload, const void* sub_tile,
                               const void* sub_valid, void* out,
                               void* written, void* partial, int n_blocks,
                               int variant, int tiles, int tiles_x,
                               int width, int height, void* stream) {
  if (n_blocks <= 0) return 0;
  const float* pay = (const float*)payload;
  const int* st = (const int*)sub_tile;
  const int* sv = (const int*)sub_valid;
  float* o = (float*)out;
  unsigned char* wr = (unsigned char*)written;
  float* part = (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFull:
      return launch_tile<kFull>(pay, st, sv, o, wr, n_blocks, tiles, tiles_x,
                                width, height, s);
    case kDumpLast:
      return launch_tile<kDumpLast>(pay, st, sv, o, wr, n_blocks, tiles,
                                    tiles_x, width, height, s);
    case kNoDump:
      return launch_tile<kNoDump>(pay, st, sv, o, wr, n_blocks, tiles,
                                  tiles_x, width, height, s);
    case kSmallOut:
      return launch_tile<kSmallOut>(pay, st, sv, o, wr, n_blocks, tiles,
                                    tiles_x, width, height, s);
    case kNoStates:
      return launch_block<kNoStates>(pay, st, sv, o, wr, part, n_blocks,
                                     tiles_x, width, height, s);
    case kPairsOnly:
      return launch_block<kPairsOnly>(pay, st, sv, o, wr, part, n_blocks,
                                      tiles_x, width, height, s);
    case kPairsNoaccs:
      return launch_block<kPairsNoaccs>(pay, st, sv, o, wr, part, n_blocks,
                                        tiles_x, width, height, s);
    case kPairsNoscan:
      return launch_block<kPairsNoscan>(pay, st, sv, o, wr, part, n_blocks,
                                        tiles_x, width, height, s);
    case kPairsAlpha:
      return launch_block<kPairsAlpha>(pay, st, sv, o, wr, part, n_blocks,
                                       tiles_x, width, height, s);
    case kHorner:
      return launch_block<kHorner>(pay, st, sv, o, wr, part, n_blocks,
                                   tiles_x, width, height, s);
  }
  return (int)cudaErrorInvalidValue;
}
