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
// Also replaces tools/exp_bwd2.py:92 `fwd_horner_kernel`, built by
// `make_simple` :141 and called at :153: pairs_only with the power from
// per-entry Horner coefficients (:112-120), the `kHorner` instance of
// fwd_block_kernel.
//
// Built with -fmad=false: every sum runs in the plain version's order, so
// the kernels equal it bit for bit (up to the sign of a zero) wherever expf
// agrees with torch's.
//
// The tile variants (full, dump_last, no_dump, small_out): fwd_tile_kernel,
// composite_fwd.cu's (kernel 3's) layout. A warp owns a 32-pixel strip of a
// tile (rows 2u, 2u+1) and walks the tile's run of subs alone: lane i
// copies entry i of the next sub into the warp's other shared-memory buffer
// (cp.async) while the warp computes the current one, makes its means
// tile-local once, and α stays in shared memory, so only the 32 prefix
// products live in registers. The warp stops computing as soon as its 32
// pixels are done (__all_sync): a done pixel adds nothing and its state no
// longer changes, so the TPU's block rules (a block all of whose subs
// continue a saturated tile is skipped and dumps the unchanged state; every
// other block computes) give each slot the strip's state after that sub
// either way. Each variant writes the slots the TPU kernel writes, and
// marks them in `written`:
//   full       slot j after every sub j of the run; a done strip writes its
//              final state into the slots left;
//   small_out  slot s after the last computed block of grid step s (the
//              slot depends on j and the computed blocks alone);
//   dump_last  slot 4b after sub 4b+3, and all four slots of a skipped
//              block. Whether a block is skipped depends on all 256 pixels,
//              so dump_last runs the tile's 8 strips in one CTA: a strip
//              that is not done at a block's start knows the block is not
//              skipped and writes as it goes; a done strip holds its final
//              state, records where it stopped, and after one barrier
//              writes the blocks left, each skipped exactly when every
//              strip had stopped by its start;
//   no_dump    no slot: the colour sums are stored only under a kernel
//              argument the caller passes as 0, so ptxas keeps them.
// The CTAs of 2 warps (8 for dump_last) find the tile's run of subs among
// the computed blocks by warp-wide searches over sub_valid and sub_tile.
//
// no_states, the pairs variants and horner add a per-block term to a
// running state over the whole stream, across tiles. fwd_block_kernel: one
// CTA per block, a thread per pixel, computes the block's term (no_states
// chains the block's runs from T = 1 or from the zero state it reads at a
// carried sub, with α in shared memory as the tile kernel keeps it; the
// pairs variants and horner evaluate α at tile-local pixels with no tile
// origin, every pair of the block); it also writes rows 5-7 of slot 4b as
// zeros and marks the slot. The pairs variants evaluate every pair, masked
// or not: they time the pair math. running_sum_kernel adds the terms in
// block order for each (row, pixel) of rows 0-4, the TPU's sequential
// order: one warp per row and 32 pixels (40 warps on 40 SMs), each fed by
// a ring of 10 cp.async stages of 32 blocks in shared memory, so the
// dependent adds wait on no load. Each block's shared-memory load and slot
// store come on top of the chain's add in the warp's one issue slot; a
// deeper ring or more warps per SM do not relieve that.
//
// horner: threads 0-127 first compute the block's 128 entries'
// coefficients (a, b, c, d, e, f0) and opacity into shared memory, in the
// script's order; each pixel's thread then evaluates u = a·x + d, v = c·y +
// e and power = (u + b·y)·x + v·y + f0 per entry.
//
// Bound on the H100: operations per (entry, pixel) pair (counted from this
// source in msgs_torch/tools/work.py): the tile variants over the pairs
// before each 32-pixel strip is done, no_states over those of the subs in
// their run's first block, the pairs variants and horner over every pair of
// the computed blocks; the bytes of the state dumps for full. The running
// sum's chain of one add per block per (row, pixel) is ~14,336 dependent
// adds on the script's stream: about 30 µs at 4 cycles an add; its bytes
// (the terms read, the slots' rows written) about 45 µs.
#include <type_traits>

#include "ablate_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace msgs_composite;
using namespace msgs_ablate;

constexpr int kBlock = kNSub * kSub;   // 128 rows per block
constexpr int kGroup = 8;              // blocks per grid step
constexpr int kAcc = 5;                // rows r g b depth acc
constexpr int kStrips = kPix / 32;     // 32-pixel strips of a tile
constexpr int kWarpsPerSm = 16;        // the register cap: 65536 / (16·32)
constexpr int kRow4 = kFeat / 4;       // 16-byte pieces of a payload row
constexpr int kRing = 10;              // running sum: stages in flight
constexpr int kStage = 32;             // running sum: blocks a stage
constexpr int kChains = kAcc * kPix / 32;   // running sum: warps

// kernels/ablate.py ALL_FWD (FWD_VARIANTS, then HORNER_VARIANTS), in order.
enum Variant { kFull = 0, kDumpLast, kNoDump, kNoStates, kPairsOnly,
               kPairsNoaccs, kPairsNoscan, kPairsAlpha, kSmallOut, kHorner };
constexpr int kNVariants = kHorner + 1;

__host__ __device__ constexpr bool is_tile(int v) {
  return v == kFull || v == kDumpLast || v == kNoDump || v == kSmallOut;
}

// horner's per-entry coefficients (tools/exp_bwd2.py:112-117): a, b, c, d
// and e, f0, op, 0.
__device__ __forceinline__ void horner_coefs(const float* e, float4* c) {
  const float mx = e[F_MX], my = e[F_MY];
  const float cxx = e[F_CXX], cxy = e[F_CXY], cyy = e[F_CYY];
  c[0] = make_float4(-0.5f * cxx, -cxy, -0.5f * cyy, cxx * mx + cxy * my);
  c[1] = make_float4(cyy * my + cxy * mx,
                     -0.5f * (cxx * mx * mx + cyy * my * my) - cxy * mx * my,
                     e[F_OP], 0.0f);
}

// α of one entry at tile-local pixel (pxl, pyl) from its coefficients
// (:118-127).
__device__ __forceinline__ float horner_alpha(const float4* c, float pxl,
                                              float pyl) {
  const float4 c0 = c[0], c1 = c[1];
  const float u = c0.x * pxl + c0.w;
  const float v = c0.z * pyl + c1.x;
  const float power = (u + c0.y * pyl) * pxl + v * pyl + c1.y;
  const float araw = c1.z * expf(power);
  const bool m = (araw >= alpha_min()) && (power <= 0.0f);
  return m ? fminf(araw, alpha_max()) : 0.0f;
}

__device__ __forceinline__ float outside(float pxl, float pyl, float ox,
                                         float oy, int width, int height) {
  return ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height)
             ? 1.0f : 0.0f;
}

// One sub of the forward (msgs_torch/kernels/composite.py:_sub_forward, as
// composite_fwd.cu computes it), bit for bit up to the sign of a zero,
// from a staged sub whose F_MX, F_MY hold the tile-local means (mx −
// ox, my − oy, as splat_alpha computes them; splat_alpha at origin 0 then
// subtracts 0, which is exact), keeping α in shared memory (entry i at
// al[kStride·i]) so that only the prefix product lives in registers. alive
// ∈ {0, 1}, so α·T·cum_excl·alive is the product itself or +0 (every factor
// is ≥ 0): a select gives the same bits.
template <int kStride>
__device__ __forceinline__ void composite_sub_staged(
    const float* sp, float* al, float pxl, float pyl, float& T, float& done,
    float (&loc)[kAcc]) {
  const float kTEps = t_eps();
  float cu[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    float araw;
    const float a = splat_alpha(sp + i * kFeat, 0.0f, 0.0f, pxl, pyl, araw);
    al[kStride * i] = a;
    cu[i] = 1.0f - a;
  }
  hs_prefix_product(cu);

  const float t_in = T;
  const bool live = done == 0.0f;
  float tmin = INFINITY;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) loc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float ce = i == 0 ? 1.0f : cu[i - 1];
    const float ta = t_in * cu[i];
    const bool alive = ta >= kTEps && live;
    const float w = alive ? al[kStride * i] * t_in * ce : 0.0f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c)
      loc[c] = loc[c] + sp[i * kFeat + F_R + c] * w;
    tmin = fminf(tmin, alive ? ta : t_in);
  }
  T = tmin;
  done = fmaxf(done, (t_in * cu[kSub - 1]) < kTEps ? 1.0f : 0.0f);
}

template <int V>
__host__ __device__ constexpr int tile_warps() {
  return V == kDumpLast ? kStrips : 2;
}

// Dynamic shared memory of the tile kernel: per warp two staged subs and
// its α.
template <int V>
constexpr size_t tile_smem() {
  return (size_t)tile_warps<V>() * (2 * kSub * kFeat + kSub * 32) *
         sizeof(float);
}

template <int V>
__global__ void __launch_bounds__(32 * tile_warps<V>(),
                                  kWarpsPerSm / tile_warps<V>())
fwd_tile_kernel(const float* __restrict__ payload,
                const int* __restrict__ sub_tile,
                const int* __restrict__ sub_valid,
                float* __restrict__ out, unsigned char* __restrict__ written,
                int n_blocks, int tiles_x, int width, int height, int keep) {
  constexpr int kW = tile_warps<V>();
  extern __shared__ __align__(16) float smem[];
  __shared__ int stop[kW];   // dump_last: where each strip stopped

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kW + warp;
  const int tile = unit / kStrips;
  const int strip = unit % kStrips;
  const int p = strip * 32 + lane;
  float* sp = smem + warp * (2 * kSub * kFeat);
  float* al = smem + kW * (2 * kSub * kFeat) + warp * (kSub * 32) + lane;

  const int2 r = tile_run(sub_tile, sub_valid, n_blocks, tile, lane);
  const int s0 = r.x, s1 = r.y;
  if (s0 >= s1) return;   // every warp of a dump_last CTA returns here
  // small_out's slots depend on the last computed block.
  const int nb =
      V == kSmallOut ? computed_blocks(sub_valid, n_blocks, lane) : 0;

  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;
  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);
  float acc[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float T = 1.0f;
  float done = outside(pxl, pyl, ox, oy, width, height);

  // The strip's state into slot s (strip 0 marks it).
  auto dump = [&](int s) {
    float* o = out + (long long)s * (kOut * kPix) + p;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) o[c * kPix] = acc[c];
    o[O_T * kPix] = T;
    o[O_DONE * kPix] = done;
    o[7 * kPix] = 0.0f;
    if (strip == 0 && lane == 0) written[s] = 1;
  };
  // The slot the state after sub j goes to in full and small_out (dump_last
  // also writes slot j − 3 after sub j ≡ 3 mod 4 of a block not skipped).
  auto slot_of = [&](int j) {
    if (V == kFull) return j;
    if (V == kDumpLast) return j % kNSub == kNSub - 1 ? j - (kNSub - 1) : -1;
    if (V == kSmallOut) {
      const int s = j / (kNSub * kGroup);
      const int b_last = min(s * kGroup + kGroup - 1, nb - 1);
      return j == b_last * kNSub + kNSub - 1 ? s : -1;
    }
    return -1;
  };

  // Entry `lane` of sub j, into buffer j & 1.
  const float4* src = reinterpret_cast<const float4*>(payload) + lane * kRow4;
  auto stage = [&](int j) {
    float* dst = sp + (j & 1) * (kSub * kFeat) + lane * kFeat;
    const float4* s = src + (long long)j * (kSub * kRow4);
#pragma unroll
    for (int c = 0; c < kRow4; ++c) cp_async16(dst + 4 * c, s + c);
    cp_async_commit();
  };
  stage(s0);
  int k = s0;
  for (; k < s1; ++k) {
    if (__all_sync(kAll, done != 0.0f)) break;
    // Sub k has landed (this lane's row); its means become tile-local.
    // Then every lane is past sub k − 1, whose buffer the next copy
    // overwrites.
    cp_async_wait<0>();
    float* row = sp + (k & 1) * (kSub * kFeat) + lane * kFeat;
    row[F_MX] = row[F_MX] - ox;
    row[F_MY] = row[F_MY] - oy;
    __syncwarp();
    if (k + 1 < s1) stage(k + 1);

    float loc[kAcc];
    composite_sub_staged<32>(sp + (k & 1) * (kSub * kFeat), al, pxl, pyl, T,
                             done, loc);
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[c] = acc[c] + loc[c];
    const int s = slot_of(k);
    if (s >= 0) dump(s);
  }
  cp_async_wait<0>();

  // The strip is done from sub k on, or the run has ended: its state no
  // longer changes, and the slots of subs k..s1−1 take it.
  if (V == kDumpLast) {
    if (lane == 0) stop[warp] = k;
    __syncthreads();
    // Every pixel of the tile is done at the start of sub `sat` (s1: never
    // within the run).
    int sat = stop[0];
#pragma unroll
    for (int w = 1; w < kW; ++w) sat = max(sat, stop[w]);
    for (int j0 = k / kNSub * kNSub; j0 < s1; j0 += kNSub) {
      const bool skipped = j0 > s0 && j0 + kNSub - 1 < s1 && sat <= j0;
      if (skipped) {
        for (int j = j0; j < j0 + kNSub; ++j) dump(j);
      } else if (j0 + kNSub - 1 < s1) {
        dump(j0);
      }
    }
  } else if (V != kNoDump) {
    for (int j = k; j < s1; ++j) {
      const int s = slot_of(j);
      if (s >= 0) dump(s);
    }
  } else if (keep) {
    // Never taken (the caller passes 0), but ptxas cannot know it.
    float* o = out + (long long)s0 * (kOut * kPix) + p;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) o[c * kPix] = acc[c];
  }
}

// CTAs per SM the block kernel's register cap leaves: 3 (80 registers), or
// 1 (255, the first port's budget) for no_states' chain and pairs_only's α,
// prefix product and colour sums, which spill at 80 and at 128.
template <int V>
__host__ __device__ constexpr int block_ctas() {
  return V == kNoStates || V == kPairsOnly ? 1 : 3;
}

// The per-block term of no_states, a pairs variant or horner, (5, 256) per
// block into `partial` (rows past the variant's are 0), and rows 5-7 of
// slot 4b as zeros; blocks that do not compute write nothing.
template <int V>
__global__ void __launch_bounds__(kPix, block_ctas<V>())
fwd_block_kernel(const float* __restrict__ payload,
                 const int* __restrict__ sub_tile,
                 const int* __restrict__ sub_valid,
                 float* __restrict__ partial, float* __restrict__ out,
                 unsigned char* __restrict__ written, int tiles_x, int width,
                 int height) {
  constexpr bool kScan =
      V == kPairsOnly || V == kPairsNoaccs || V == kHorner;
  __shared__ __align__(16) float sp[kBlock * kFeat];
  __shared__ float al[V == kNoStates ? kSub * kPix : 1];   // α of no_states
  __shared__ float4 hc[V == kHorner ? 2 * kBlock : 1];
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  if (sub_valid[b * kNSub] != 1) return;
  const float4* src = reinterpret_cast<const float4*>(
      payload + (long long)b * (kBlock * kFeat));
  for (int i = p; i < kBlock * kFeat / 4; i += kPix)
    reinterpret_cast<float4*>(sp)[i] = src[i];
  __syncthreads();
  if (V == kHorner || V == kNoStates) {
    if (p < kBlock) {
      if (V == kHorner) {
        horner_coefs(sp + p * kFeat, hc + 2 * p);
      } else {
        // Row p's means made tile-local at its sub's tile.
        const int tile = sub_tile[b * kNSub + p / kSub];
        sp[p * kFeat + F_MX] =
            sp[p * kFeat + F_MX] - (float)(tile % tiles_x) * (float)kTile;
        sp[p * kFeat + F_MY] =
            sp[p * kFeat + F_MY] - (float)(tile / tiles_x) * (float)kTile;
      }
    }
    __syncthreads();
  }

  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);
  float part[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (V == kNoStates) {
    const int prev = b > 0 ? sub_tile[b * kNSub - 1] : -1;
    float T = 0.0f, done = 0.0f;
#pragma unroll 1
    for (int k = 0; k < kNSub; ++k) {
      const int j = b * kNSub + k;
      const int tile = sub_tile[j];
      const bool carried = b > 0 && tile == prev;
      if (k == 0 && carried) {
        T = 0.0f;      // the never-written state
        done = 0.0f;
      } else if (!carried && (k == 0 || tile != sub_tile[j - 1])) {
        T = 1.0f;
        done = outside(pxl, pyl, (float)(tile % tiles_x) * (float)kTile,
                       (float)(tile / tiles_x) * (float)kTile, width,
                       height);
      }
      float loc[kAcc];
      composite_sub_staged<kPix>(sp + k * kSub * kFeat, al + p, pxl, pyl, T,
                                 done, loc);
#pragma unroll
      for (int c = 0; c < kAcc; ++c)
        part[c] = k == 0 ? loc[c] : part[c] + loc[c];
    }
  } else {
    const float kTEps = t_eps();
    float m = 0.0f;   // pairs_alpha, pairs_noaccs: the max over rows
    auto alpha = [&](int i) {
      float araw;
      return V == kHorner ? horner_alpha(hc + 2 * i, pxl, pyl)
                          : splat_alpha(sp + i * kFeat, 0.0f, 0.0f, pxl, pyl,
                                        araw);
    };
    auto add = [&](int i, float w) {
      if (V == kPairsAlpha || V == kPairsNoaccs) {
        m = fmaxf(m, w);
      } else {
#pragma unroll
        for (int c = 0; c < kAcc; ++c)
          part[c] = part[c] + sp[i * kFeat + F_R + c] * w;
      }
    };
#pragma unroll 1
    for (int k = 0; k < kNSub; ++k) {
      const int i0 = k * kSub;
      if (kScan) {
        float a[kSub], cu[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          a[i] = alpha(i0 + i);
          cu[i] = 1.0f - a[i];
        }
        hs_prefix_product(cu);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float ce = i == 0 ? 1.0f : cu[i - 1];
          add(i0 + i, a[i] * ce * (cu[i] >= kTEps ? 1.0f : 0.0f));
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < kSub; ++i) add(i0 + i, alpha(i0 + i));
      }
    }
    if (V == kPairsAlpha || V == kPairsNoaccs) part[0] = m;
  }
  float* o = partial + (long long)b * (kAcc * kPix) + p;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) o[c * kPix] = part[c];
  float* z = out + (long long)b * kNSub * (kOut * kPix) + p;
#pragma unroll
  for (int c = kAcc; c < kOut; ++c) z[c * kPix] = 0.0f;
  if (p == 0) written[b * kNSub] = 1;
}

// Rows 0-4 of slot 4b of every computed block b: the sum of the blocks'
// terms up to b, added in block order. One warp per row and 32 pixels;
// lane l adds pixel l's chain. The terms arrive through a ring of kRing
// stages of kStage blocks in shared memory, each stage copied by the whole
// warp with cp.async (lane l: 16 bytes of blocks l/8, l/8 + 4, ...), so
// the chain of adds waits on no load. Every address is a base made once
// plus a constant: per block the warp issues a shared load, the add and
// the slot's store.
__global__ void __launch_bounds__(32)
running_sum_kernel(const float* __restrict__ partial,
                   const int* __restrict__ sub_valid,
                   float* __restrict__ out, int n_blocks) {
  __shared__ __align__(16) float ring[kRing][kStage][32];
  constexpr int kSrc = kAcc * kPix;           // floats a block's terms
  constexpr int kDst = kNSub * kOut * kPix;   // floats from slot 4b to 4b+4
  constexpr int kSlot = kStage * 32 * 4;      // bytes a stage
  const int lane = threadIdx.x;
  const int row = blockIdx.x / (kPix / 32);
  const int col = blockIdx.x % (kPix / 32) * 32;
  const int nb = computed_blocks(sub_valid, n_blocks, lane);
  const int n_st = (nb + kStage - 1) / kStage;
  // Lane l's copies: block u = l/8 + 4i of a stage, pixels 4(l%8)..+3.
  const int u0 = lane >> 3;
  const float* src =
      partial + (long long)u0 * kSrc + row * kPix + col + (lane & 7) * 4;
  const unsigned dst_s = (unsigned)__cvta_generic_to_shared(
      &ring[0][u0][(lane & 7) * 4]);
  auto issue = [&](int s) {
    if (s < n_st) {
      const float* g = src + (long long)s * (kStage * kSrc);
      const unsigned d = dst_s + (s % kRing) * kSlot;
      const int left = nb - s * kStage - u0;   // copies with u < left
#pragma unroll
      for (int i = 0; i < kStage / 4; ++i)
        if (4 * i < left) cp_async16(d + i * (4 * 32 * 4), g + i * 4 * kSrc);
    }
    cp_async_commit();   // past the end an empty group keeps the count
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  float acc = 0.0f;
  float* d = out + row * kPix + col + lane;
  for (int s = 0; s < n_st; ++s, d += kStage * kDst) {
    __syncwarp();   // every lane is done with stage s − 1's slot
    issue(s + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncwarp();   // stage s has landed, every lane's copies
    const float* st = &ring[s % kRing][0][lane];
    const int n = min(kStage, nb - s * kStage);
    if (n == kStage) {
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        acc = acc + st[u * 32];
        d[u * kDst] = acc;
      }
    } else {
      for (int u = 0; u < n; ++u) {
        acc = acc + st[u * 32];
        d[u * kDst] = acc;
      }
    }
  }
}

template <int V>
int launch_tile(const float* pay, const int* st, const int* sv, float* out,
                unsigned char* wr, int n_blocks, int tiles, int tiles_x,
                int width, int height, cudaStream_t s) {
  constexpr size_t smem = tile_smem<V>();
  if (smem > 48 * 1024) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            fwd_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
      return (int)err;
  }
  fwd_tile_kernel<V><<<tiles * (kStrips / tile_warps<V>()),
                       32 * tile_warps<V>(), smem, s>>>(
      pay, st, sv, out, wr, n_blocks, tiles_x, width, height, 0);
  return (int)cudaGetLastError();
}

template <int V>
int launch_block(const float* pay, const int* st, const int* sv, float* out,
                 unsigned char* wr, float* partial, int n_blocks,
                 int tiles_x, int width, int height, cudaStream_t s) {
  fwd_block_kernel<V><<<n_blocks, kPix, 0, s>>>(pay, st, sv, partial, out,
                                                wr, tiles_x, width, height);
  if (const int err = (int)cudaGetLastError()) return err;
  running_sum_kernel<<<kChains, 32, 0, s>>>(partial, sv, out, n_blocks);
  return (int)cudaGetLastError();
}

template <int V>
int info(int* out) {
  if constexpr (!is_tile(V)) {
    return fill_kernel_info(fwd_block_kernel<V>, kPix, 0, out);
  } else {
    constexpr size_t smem = tile_smem<V>();
    if (const cudaError_t err = cudaFuncSetAttribute(
            fwd_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
      return (int)err;
    return fill_kernel_info(fwd_tile_kernel<V>, 32 * tile_warps<V>(), smem,
                            out);
  }
}

// Calls f with the variant v as a compile-time constant.
template <typename F>
int with_variant(int v, F&& f) {
  switch (v) {
    case kFull: return f(std::integral_constant<int, kFull>());
    case kDumpLast: return f(std::integral_constant<int, kDumpLast>());
    case kNoDump: return f(std::integral_constant<int, kNoDump>());
    case kNoStates: return f(std::integral_constant<int, kNoStates>());
    case kPairsOnly: return f(std::integral_constant<int, kPairsOnly>());
    case kPairsNoaccs: return f(std::integral_constant<int, kPairsNoaccs>());
    case kPairsNoscan: return f(std::integral_constant<int, kPairsNoscan>());
    case kPairsAlpha: return f(std::integral_constant<int, kPairsAlpha>());
    case kSmallOut: return f(std::integral_constant<int, kSmallOut>());
    case kHorner: return f(std::integral_constant<int, kHorner>());
  }
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
  return with_variant(variant, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if constexpr (is_tile(V))
      return launch_tile<V>(pay, st, sv, o, wr, n_blocks, tiles, tiles_x,
                            width, height, s);
    else
      return launch_block<V>(pay, st, sv, o, wr, (float*)partial, n_blocks,
                             tiles_x, width, height, s);
  });
}

// A kernel's build: registers, stack bytes, static and dynamic shared
// memory, and CTAs per SM at its launch configuration. i < 10: the
// variant's kernel in ALL_FWD order (the tile kernel, or the block
// kernel); i = 10: running_sum_kernel.
extern "C" int msgs_fwd_ablate_info(int i, int* out) {
  if (i == kNVariants) return fill_kernel_info(running_sum_kernel, 32, 0, out);
  return with_variant(i, [&](auto v) { return info<decltype(v)::value>(out); });
}
