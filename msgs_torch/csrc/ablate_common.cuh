// Shared by the ablation kernels (fwd_ablate.cu, bwd_ablate.cu): walking
// binning's stream, and the asynchronous copies their layouts stage with.
#pragma once
#include "composite_common.cuh"

namespace msgs_ablate {

using namespace msgs_composite;

constexpr unsigned kAll = 0xffffffffu;

// Subs 4b..4b+3 form block b; a block computes when its first sub is
// valid, and those blocks are a prefix of the stream; sub_tile is
// nondecreasing over the stream.
constexpr int kNSub = 4;   // subs per 128-entry block

// The first i in [lo, hi) where pred(i) is false (hi if none), pred being
// true on a prefix of the range. The warp probes 32 indices a step, so the
// search takes about log32 of the range in dependent loads (a binary search
// takes log2). Every lane of the warp calls it and gets the answer.
template <typename Pred>
__device__ __forceinline__ int warp_partition_point(int lo, int hi, int lane,
                                                    Pred pred) {
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    // pred is true on the first c probes and false on the others.
    const int c = __popc(__ballot_sync(kAll, i < hi && pred(i)));
    if (c == 0) return lo;
    const int last = lo + (c - 1) * step;
    hi = min(hi, last + step);
    lo = last + 1;
  }
  return lo;
}

// The computed blocks: the first b with sub_valid[4b] != 1.
__device__ __forceinline__ int computed_blocks(const int* sub_valid,
                                               int n_blocks, int lane) {
  return warp_partition_point(0, n_blocks, lane, [&](int b) {
    return __ldg(sub_valid + b * kNSub) == 1;
  });
}

// [s0, s1): the subs of `tile` in the computed blocks, its run of the
// stream. s0 by a warp-wide search over the whole stream (sub_tile is
// nondecreasing over all of it); s1 by one probe of the 32 subs from s0
// (runs are a few subs long), searching on only past a longer run; the
// computed blocks are counted only when the run reaches a block that does
// not compute (the last tile's run).
__device__ __forceinline__ int2 tile_run(const int* sub_tile,
                                         const int* sub_valid, int n_blocks,
                                         int tile, int lane) {
  const int n = n_blocks * kNSub;
  auto below = [&](int i) { return __ldg(sub_tile + i) < tile; };
  auto within = [&](int i) { return __ldg(sub_tile + i) <= tile; };
  const int s0 = warp_partition_point(0, n, lane, below);
  const int c =
      __popc(__ballot_sync(kAll, s0 + lane < n && within(s0 + lane)));
  const int s1 = c < 32 ? s0 + c : warp_partition_point(s0 + 32, n, lane,
                                                        within);
  if (s1 > s0 && __ldg(sub_valid + (s1 - 1) / kNSub * kNSub) != 1) {
    const int end = computed_blocks(sub_valid, n_blocks, lane) * kNSub;
    return make_int2(min(s0, end), min(s1, end));
  }
  return make_int2(s0, s1);
}

// 16 bytes from global to shared memory, the destination a shared-space
// address.
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  cp_async16((unsigned)__cvta_generic_to_shared(smem), gmem);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace msgs_ablate
