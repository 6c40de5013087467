// Tile compositor, forward: front-to-back alpha blending of each 16×16
// tile's depth-sorted splat entries. The plain version is
// msgs_torch/kernels/composite.py:composite_reference.
//
// Replaces msgs/kernels/composite.py:_fwd_kernel (launched by
// _composite_fwd_call). The TPU kernel walks payload blocks in grid order,
// carries the running tile state in VMEM scratch and dumps it to every
// sub-block slot (read back at tile_last_sub). Blocks of a CUDA grid run in
// no order, so here each pixel's state lives in one thread for its whole
// life: the thread walks the tile's sub-blocks [first_sub, first_sub +
// n_sub) in order and writes the final (NOUT=8, 256) channel-major state
// once. No per-sub state dump.
//
// Layout: payload (S·32, 12) float32 rows (columns F_MX..F_PSIZE, pad);
// out (tiles, 8, 256): r g b depth acc T done pad. One thread per pixel.
//
// Arithmetic order follows _block_forward (composite.py:224-243) and the
// tile-local α of _BlockCtx (:297-311), per 32-entry sub-block (the plain
// version's msgs_torch/kernels/composite.py:_sub_forward):
//   α_i = mask ? min(0.99, o·exp(power)) : 0, power in tile-local offsets;
//   cum_incl = the 5-round Hillis-Steele product of (1−α) (as
//   _sub_cumprod_static builds it), cum_excl its shift;
//   t_after = t_in·cum_incl; alive = t_after ≥ 1e-4 ∧ ¬done;
//   w = α·t_in·cum_excl·alive, summed into r g b depth acc per sub;
//   T = min(alive ? t_after : t_in); done |= t_after[31] < 1e-4.
// Built with -fmad=false, so each product and sum rounds as the plain
// version's separate torch ops do: α, T and done agree to the last bit, and
// the T < 1e-4 stop decisions cannot flip between the two.
//
// Bound on the H100: 41 fp32 operations per (entry, pixel) pair, one exp
// among them (counted in chip_smoke.py OPS_PER_PAIR: 31 for α, the (1−α)
// product, t_after, alive, w and T, 10 for the colour sums), over the
// pairs before each 32-pixel strip is done; the payload read (48 bytes per
// entry) is far below that.
//
// Design. A pixel's state never depends on another pixel's, so the unit of
// work is a warp: 32 pixels of one tile (rows 2u, 2u+1 of its 8 strips),
// which walks the tile's sub-blocks alone, with no CTA barrier, and stops
// as soon as its own 32 pixels are done (__all_sync). That is exact: a done
// pixel's w is 0 and its state no longer changes, and off-image pixels
// start done. Lane i copies entry i of the next sub-block (3 × 16 bytes,
// cp.async) into the warp's other shared-memory buffer while the warp
// computes the current one, which it reads as broadcasts; lane i also makes
// entry i's means tile-local once (the subtraction splat_alpha makes per
// pixel); one __syncwarp per sub-block. The sub-block step is
// that arithmetic with α kept in shared memory, so only the 32
// prefix products stay in registers, and __launch_bounds__ caps the build
// at what 16 resident warps leave (96 registers, no stack). The first port
// ran one 256-thread CTA per tile with two CTA barriers per sub-block and
// the sub-block's α and products both in registers: 186 registers, one CTA
// per SM. Small CTAs let a long tile's strips run on different SMs.
#include "composite_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace msgs_composite;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kStrips = kPix / 32;     // warp units per tile
constexpr int kWarps = 2;              // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpsPerSm = 16;        // the register cap: 65536 / (16·32)
constexpr size_t kDynSmem = 0;         // shared memory is static
constexpr int kRow4 = kFeat / 4;       // 16-byte pieces of a payload row
static_assert(kStrips % kWarps == 0, "a CTA holds strips of one tile");

__device__ __forceinline__ void cp_async16(float* smem, const float4* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One sub-block of the forward (the arithmetic above), bit for bit, from a
// staged sub-block whose F_MX, F_MY hold the tile-local means (mx − ox, my − oy,
// as splat_alpha computes them; splat_alpha at origin 0 then subtracts 0,
// which is exact), keeping α in shared memory (al, stride 32: entry i of
// this lane at al[32·i]) so that only the prefix product lives in
// registers. alive ∈ {0, 1}, so α·T·cum_excl·alive is the product itself
// or +0 (every factor is ≥ 0): a select gives the same bits.
__device__ __forceinline__ void composite_sub_staged(
    const float* sp, float* al, float pxl, float pyl, float& T, float& done,
    float (&loc)[5]) {
  const float kTEps = t_eps();
  float cu[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    float araw;
    const float a = splat_alpha(sp + i * kFeat, 0.0f, 0.0f, pxl, pyl, araw);
    al[32 * i] = a;
    cu[i] = 1.0f - a;
  }
  hs_prefix_product(cu);

  const float t_in = T;
  const bool live = done == 0.0f;
  float tmin = INFINITY;
#pragma unroll
  for (int c = 0; c < 5; ++c) loc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float ce = i == 0 ? 1.0f : cu[i - 1];
    const float ta = t_in * cu[i];
    const bool alive = ta >= kTEps && live;
    const float w = alive ? al[32 * i] * t_in * ce : 0.0f;
#pragma unroll
    for (int c = 0; c < 5; ++c) loc[c] = loc[c] + sp[i * kFeat + F_R + c] * w;
    tmin = fminf(tmin, alive ? ta : t_in);
  }
  T = tmin;
  done = fmaxf(done, (t_in * cu[kSub - 1]) < kTEps ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads, kWarpsPerSm / kWarps)
composite_fwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ first_sub,
                     const int* __restrict__ n_sub,
                     float* __restrict__ out,
                     int tiles_x, int width, int height) {
  __shared__ __align__(16) float sp[kWarps][2][kSub * kFeat];
  __shared__ float al[kWarps][kSub * 32];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + warp;
  const int tile = unit / kStrips;
  const int p = (unit % kStrips) * 32 + lane;
  const float ox = (float)(tile % tiles_x) * (float)kTile;
  const float oy = (float)(tile / tiles_x) * (float)kTile;
  const float pxl = (float)(p % kTile);
  const float pyl = (float)(p / kTile);

  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float T = 1.0f;
  float done = ((pxl + ox) >= (float)width || (pyl + oy) >= (float)height)
                   ? 1.0f : 0.0f;

  const int s0 = first_sub[tile];
  const int ns = n_sub[tile];
  // Entry `lane` of sub-block k of the tile, into buffer k & 1.
  const float4* src = reinterpret_cast<const float4*>(payload) +
                      ((long long)s0 * kSub + lane) * kRow4;
  auto stage = [&](int k) {
    float* dst = sp[warp][k & 1] + lane * kFeat;
    const float4* s = src + (long long)k * (kSub * kRow4);
#pragma unroll
    for (int c = 0; c < kRow4; ++c) cp_async16(dst + 4 * c, s + c);
    cp_async_commit();
  };
  if (ns > 0) stage(0);
  for (int k = 0; k < ns; ++k) {
    if (__all_sync(kAll, done != 0.0f)) break;
    // Sub-block k has landed (this lane's row); its means become
    // tile-local. Then every lane is past sub-block k − 1, whose buffer
    // the next copy overwrites.
    cp_async_wait_all();
    float* row = sp[warp][k & 1] + lane * kFeat;
    row[F_MX] = row[F_MX] - ox;
    row[F_MY] = row[F_MY] - oy;
    __syncwarp();
    if (k + 1 < ns) stage(k + 1);

    float loc[5];
    composite_sub_staged(sp[warp][k & 1], al[warp] + lane, pxl, pyl, T, done,
                         loc);
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[c] = acc[c] + loc[c];
  }
  cp_async_wait_all();

  float* o = out + (long long)tile * (kOut * kPix);
#pragma unroll
  for (int c = 0; c < 5; ++c) o[c * kPix + p] = acc[c];
  o[O_T * kPix + p] = T;
  o[O_DONE * kPix + p] = done;
  o[7 * kPix + p] = 0.0f;
}

}  // namespace

extern "C" int msgs_composite_fwd(const void* payload, const void* first_sub,
                                  const void* n_sub, void* out, int tiles,
                                  int tiles_x, int width, int height,
                                  void* stream) {
  if (tiles <= 0) return 0;
  composite_fwd_kernel<<<tiles * (kStrips / kWarps), kThreads, kDynSmem,
                         (cudaStream_t)stream>>>(
      (const float*)payload, (const int*)first_sub, (const int*)n_sub,
      (float*)out, tiles_x, width, height);
  return (int)cudaGetLastError();
}

// The kernel's build: registers, stack bytes, static and dynamic shared
// memory, and CTAs per SM at its launch configuration (the argument is
// unused; every info entry takes one).
extern "C" int msgs_composite_fwd_info(int, int* out) {
  return fill_kernel_info(composite_fwd_kernel, kThreads, kDynSmem, out);
}
