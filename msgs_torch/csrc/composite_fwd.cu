// Tile compositor, forward: front-to-back alpha blending of each 16×16
// tile's depth-sorted splat entries. The plain version is
// msgs_torch/kernels/composite.py:composite_reference.
//
// Replaces msgs/kernels/composite.py:_fwd_kernel (launched by
// _composite_fwd_call). The TPU kernel walks payload blocks in grid order,
// carries the running tile state in VMEM scratch and dumps it to every
// sub-block slot (read back at tile_last_sub). Blocks of a CUDA grid run in
// no order, so here one CTA owns one tile for its whole life: it walks the
// tile's sub-blocks [first_sub, first_sub + n_sub) in order with the pixel
// state in registers and writes the final (NOUT=8, 256) channel-major state
// once. No per-sub state dump.
//
// Layout: payload (S·32, 12) float32 rows (columns F_MX..F_PSIZE, pad);
// out (tiles, 8, 256): r g b depth acc T done pad. One thread per pixel.
//
// Arithmetic order follows _block_forward (composite.py:224-243) and the
// tile-local α of _BlockCtx (:297-311), per 32-entry sub-block:
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
// Off-image pixels start done. The CTA stops once all 256 pixels are done
// (__syncthreads_and): the exact form of the TPU kernel's saturated-tile
// skip, since a done pixel's w is 0 and its state no longer changes.
//
// Bound on the H100: the α evaluation, ~40 fp32 operations and one exp per
// (entry, pixel) pair, over the pairs the early exit leaves; the payload
// read (48 bytes per entry) is far below that. Each sub-block's 32×12
// payload is staged once into shared memory and read by all 256 threads as
// broadcasts; the per-pixel state stays in registers. Staging several
// sub-blocks per barrier (cp.async / TMA) and packing several tiles per CTA
// are later work.
#include "composite_common.cuh"

namespace {

using namespace msgs_composite;

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ first_sub,
                     const int* __restrict__ n_sub,
                     float* __restrict__ out,
                     int tiles_x, int width, int height) {
  __shared__ float sp[kSub * kFeat];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
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
  for (int k = 0; k < ns; ++k) {
    const float* src = payload + (long long)(s0 + k) * (kSub * kFeat);
    for (int i = p; i < kSub * kFeat; i += kPix) sp[i] = src[i];
    __syncthreads();

    float loc[5];
    composite_sub(sp, ox, oy, pxl, pyl, T, done, loc);
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[c] = acc[c] + loc[c];

    // Also the barrier before the next sub-block overwrites sp.
    if (__syncthreads_and(done != 0.0f)) break;
  }

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
  composite_fwd_kernel<<<tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)payload, (const int*)first_sub, (const int*)n_sub,
      (float*)out, tiles_x, width, height);
  return (int)cudaGetLastError();
}
