// Row gather of a float32 table by int32 ids, in three output layouts:
//   entry    out[e, f]           = T(gid[e], f)        (E, F)
//   blocked  out[e / B, f, e % B] = T(gid[e], f)       (E/B, F, B)
// where the feature-major layout (F, E) is `blocked` with B = E. The table
// is row-major, T(r, f) = table[r·F + f], or feature-major,
// T(r, f) = table[f·rows + r]. The plain version is
// msgs_torch/kernels/gather.py:gather_rows_plain (`table[gid]` or
// `table[:, gid]`, then the layout's reshape and permute); a gather is exact,
// so the kernel equals it bit for bit.
//
// Replaces the Pallas row gathers of the experiment scripts:
// tools/exp_gather.py:65 gather_kernel (pallas_call :72, row table, entry
// out), :98 gather_kernel_t (:103, feature table, feature out), :126
// gather_kernel_tt (:131, feature table, entry out), and
// tools/exp_gather2.py:69 k_sub (:75, row table, entry out as (E/B, 8, B/8,
// F)), :100 k_lane (:106, feature table, blocked out as (E/B, F, 8, B/8)).
// Those keep the whole table in VMEM and index it with (8, B/8) blocks of
// ids padded to 8-row tables; none of that is observable and none of it is
// carried over: here ids are a flat (E,) array and tables are unpadded.
//
// Bound on the H100: bytes. A gather does no arithmetic; it reads E ids,
// the table rows gid references (6.4 MB at the scripts' default, 4.8 MB on
// the render path: they fit in the 50 MB L2) and writes E·F floats (134 MB
// at the default). Design:
//   * A feature table is first transposed into a row-major (rows, F)
//     workspace by one tiled transpose (coalesced reads along rows, 16-byte
//     stores of whole rows), so every gather reads a row as F/4 float4s:
//     with random ids a scalar read `rows` apart costs a 32-byte L2 sector
//     for 4 bytes. The workspace is the caller's, made anew for each call.
//   * entry out: a warp takes 64 consecutive entries, loads their ids
//     coalesced once (two a lane) and hands each of its float4 units the id
//     it needs by shuffle; a lane keeps 2·F/4 independent float4 loads in
//     flight, then stores them, the warp 512 contiguous bytes a store.
//   * blocked out: a CTA takes 256 consecutive entries a step, loads their
//     rows as the entry kernel does into a shared [feature][entry] tile,
//     and writes each feature's entries as float4s, a warp 512 contiguous
//     bytes of the feature's row (a thread that loaded 4 rows and stored a
//     float4 per feature sent 32 rows' sectors through L1 a load and ran
//     markedly slower than the entry kernel on the H100). Where
//     B % 4 != 0 four entries may straddle a block and the stores are
//     scalar.
//   * Output is written with streaming stores (st.global.cs), so the
//     134 MB of output does not push the table out of L2; ids are read
//     with streaming loads. Grids are sized to the card (CTAs per SM × SMs)
//     and stride over the work.
// Ids outside [0, rows) are outside the contract; they are clamped to that
// range, as XLA's row gather does, so no read leaves the table. Offsets are
// 64-bit throughout.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIdsPerLane = 2;                     // entry out: ids a lane holds
constexpr int kWarpEntries = 32 * kIdsPerLane;     // entries a warp takes
constexpr int kTileRows = 128;                     // transpose tile: rows
constexpr int kTileFeat = 32;                      //   and features
constexpr int kTilePad = kTileRows + 2;            // ≡ 2 (mod 32): no conflicts
constexpr int kChunk = 256;                        // blocked out: entries a step
constexpr int kLdT = kChunk + 4;                   //   tile rows, ≡ 4 (mod 32)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_id(int id, long long rows) {
  return id < 0 ? 0 : (id >= rows ? rows - 1 : (long long)id);
}

// (F, rows) → (rows, F): a CTA moves rows r0..r0+127 of features
// f0..f0+31 (all F when F ≤ 32) through shared memory.
__global__ void __launch_bounds__(kThreads)
transpose_features(const float* __restrict__ table, float* __restrict__ work,
                   long long rows, int F) {
  __shared__ float tile[kTileFeat][kTilePad];
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int f0 = blockIdx.y * kTileFeat;
  const int fw = min(kTileFeat, F - f0);
  for (int i = threadIdx.x; i < fw * kTileRows; i += kThreads) {
    const int fi = i / kTileRows, rl = i % kTileRows;
    const long long r = r0 + rl;
    tile[fi][rl] = r < rows ? __ldg(table + (long long)(f0 + fi) * rows + r)
                            : 0.0f;
  }
  __syncthreads();
  const int q4 = fw >> 2;   // float4s of a row within the tile
  for (int i = threadIdx.x; i < kTileRows * q4; i += kThreads) {
    const int rl = i / q4, k = i - rl * q4;
    const long long r = r0 + rl;
    if (r < rows)
      *reinterpret_cast<float4*>(work + r * F + f0 + 4 * k) =
          make_float4(tile[4 * k][rl], tile[4 * k + 1][rl],
                      tile[4 * k + 2][rl], tile[4 * k + 3][rl]);
  }
}

// Entry-major out from a row table with Q float4s a row: a warp takes
// entries e0..e0+63, its 64·Q float4 units u·32 + lane. kQ = 0: Q at run
// time, units one at a time.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
gather_entry(const float4* __restrict__ table, const int* __restrict__ gid,
             float4* __restrict__ out, long long rows, int q_rt, long long E) {
  const int Q = kQ > 0 ? kQ : q_rt;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  const long long chunks = (E + kWarpEntries - 1) / kWarpEntries;
  for (long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
       c < chunks; c += nwarps) {
    const long long e0 = c * kWarpEntries;
    int id[kIdsPerLane];
#pragma unroll
    for (int j = 0; j < kIdsPerLane; ++j) {
      const long long e = e0 + 32 * j + lane;
      id[j] = e < E ? (int)clamp_id(__ldcs(gid + e), rows) : 0;
    }
    // Units of this chunk (the last chunk may be short).
    const int units = (int)((E - e0 < kWarpEntries ? E - e0 : kWarpEntries) *
                            Q);
    float4* o = out + e0 * Q;
    // The id of chunk entry el, from the lane that loaded it.
    auto row_of = [&](int el) {
      long long r = 0;
#pragma unroll
      for (int j = 0; j < kIdsPerLane; ++j) {
        const int v = __shfl_sync(kFull, id[j], el & 31);
        if ((el >> 5) == j) r = v;
      }
      return r;
    };
    if constexpr (kQ > 0) {
      float4 v[kIdsPerLane * kQ];
#pragma unroll
      for (int u = 0; u < kIdsPerLane * kQ; ++u) {
        const int t = u * 32 + lane, el = t / kQ, q = t - el * kQ;
        const long long r = row_of(el);
        if (t < units) v[u] = __ldg(table + r * kQ + q);
      }
#pragma unroll
      for (int u = 0; u < kIdsPerLane * kQ; ++u) {
        const int t = u * 32 + lane;
        if (t < units) __stcs(o + t, v[u]);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < kIdsPerLane * Q; ++u) {
        const int t = u * 32 + lane, el = t / Q, q = t - el * Q;
        const long long r = row_of(el);
        if (t < units) __stcs(o + t, __ldg(table + r * Q + q));
      }
    }
  }
}

// Blocked out (E/B, F, B) from a row table with Q float4s a row, B % 4 ==
// 0: a CTA takes kChunk consecutive entries a step, loads their rows as the
// entry kernel does (neighbouring lanes on one row's float4s) into a
// shared [feature][entry] tile, then writes each feature's entries as
// float4s (4 entries of a block; a warp 512 contiguous bytes).
template <int kQ>
__global__ void __launch_bounds__(kThreads, 4)
gather_blocked_tile(const float4* __restrict__ table,
                    const int* __restrict__ gid, float* __restrict__ out,
                    long long rows, int q_rt, long long E, long long B) {
  const int Q = kQ > 0 ? kQ : q_rt;
  const int F = 4 * Q;
  extern __shared__ float4 smem4[];
  int* sid = reinterpret_cast<int*>(smem4);                  // [kChunk]
  float* tile = reinterpret_cast<float*>(smem4) + kChunk;    // [F][kLdT]
  __shared__ long long s_b0, s_r0;   // the chunk's first block and offset
  const int t = threadIdx.x;
  const long long chunks = (E + kChunk - 1) / kChunk;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long e0 = c * kChunk;
    __syncthreads();   // the last chunk's readers are done
    if (e0 + t < E) sid[t] = (int)clamp_id(__ldcs(gid + e0 + t), rows);
    if (t == 0) {
      s_b0 = e0 / B;
      s_r0 = e0 - s_b0 * B;
    }
    __syncthreads();
    const int n = (int)(E - e0 < kChunk ? E - e0 : kChunk);
    if constexpr (kQ > 0) {
      float4 v[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int u = i * kThreads + t, r = u / kQ, q = u - r * kQ;
        if (r < n) v[i] = __ldg(table + (long long)sid[r] * kQ + q);
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int u = i * kThreads + t, r = u / kQ, q = u - r * kQ;
        float* d = tile + 4 * q * kLdT + r;
        if (r < n) {
          d[0] = v[i].x;
          d[kLdT] = v[i].y;
          d[2 * kLdT] = v[i].z;
          d[3 * kLdT] = v[i].w;
        }
      }
    } else {
      for (int u = t; u < Q * kChunk; u += kThreads) {
        const int r = u / Q, q = u - r * Q;
        if (r < n) {
          const float4 v = __ldg(table + (long long)sid[r] * Q + q);
          float* d = tile + 4 * q * kLdT + r;
          d[0] = v.x;
          d[kLdT] = v.y;
          d[2 * kLdT] = v.z;
          d[3 * kLdT] = v.w;
        }
      }
    }
    __syncthreads();
    const long long b0 = s_b0, r0 = s_r0;
#pragma unroll 4
    for (int u = t; u < F * (kChunk / 4); u += kThreads) {
      const int f = u / (kChunk / 4), k = u % (kChunk / 4);
      if (4 * k >= n) continue;
      long long b = b0, el = r0 + 4 * k;
      if (el >= B) {   // the chunk crosses into a later block
        const long long d = el / B;
        b += d;
        el -= d * B;
      }
      __stcs(reinterpret_cast<float4*>(out + (b * F + f) * B + el),
             *reinterpret_cast<const float4*>(tile + f * kLdT + 4 * k));
    }
  }
}

// Blocked out with B % 4 != 0 (or E % 4 != 0): a thread takes entries
// 4g..4g+3 and stores each value alone.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
gather_blocked_scalar(const float4* __restrict__ table,
                      const int* __restrict__ gid, float* __restrict__ out,
                      long long rows, int q_rt, long long E, long long B) {
  const int Q = kQ > 0 ? kQ : q_rt;
  const long long F = 4LL * Q;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       4 * g < E; g += stride) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long e = 4 * g + i;
      if (e >= E) break;
      const long long r = clamp_id(__ldcs(gid + e), rows);
      const long long b = e / B;
      float* o = out + b * F * B + (e - b * B);
      for (int q = 0; q < Q; ++q) {
        const float4 v = __ldg(table + r * Q + q);
        __stcs(o + (4 * q) * B, v.x);
        __stcs(o + (4 * q + 1) * B, v.y);
        __stcs(o + (4 * q + 2) * B, v.z);
        __stcs(o + (4 * q + 3) * B, v.w);
      }
    }
  }
}

// k on a grid of `ctas` CTAs capped at resident_ctas: the kernels stride
// over the rest.
template <typename Kernel, typename... Args>
int launch(Kernel* k, long long ctas, size_t smem, cudaStream_t s,
           Args... args) {
  long long cap = 0;
  const int err = resident_ctas(k, kThreads, smem, 1 << 30, cap);
  if (err != 0) return err;
  k<<<(unsigned)(ctas < cap ? ctas : cap), kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

size_t tile_bytes(int F) {
  return (size_t)kChunk * 4 + (size_t)F * kLdT * 4;
}

template <int kQ>
int gather_rows_q(const float4* t, const int* g, float* o, long long rows,
                  int Q, long long E, long long block, cudaStream_t s) {
  const auto ctas = [](long long threads) {
    return (threads + kThreads - 1) / kThreads;
  };
  if (block == 0)
    return launch(gather_entry<kQ>,
                  ctas((E + kWarpEntries - 1) / kWarpEntries * 32), 0, s, t,
                  g, reinterpret_cast<float4*>(o), rows, Q, E);
  if (block % 4 == 0)
    return launch(gather_blocked_tile<kQ>, (E + kChunk - 1) / kChunk,
                  tile_bytes(4 * Q), s, t, g, o, rows, Q, E, block);
  return launch(gather_blocked_scalar<kQ>, ctas((E + 3) / 4), 0, s, t, g, o,
                rows, Q, E, block);
}

}  // namespace

extern "C" {

// table: float32, (rows, F) if feat_table == 0, else (F, rows), when work,
// a (rows, F) float32 scratch, receives its transpose first.
// out: (E, F) if block == 0, else (E/block, F, block); block divides E.
// F % 4 == 0, table, work and out 16-byte aligned (the wrapper checks).
int msgs_gather_rows(const void* table, const void* gid, void* out,
                     void* work, long long rows, int F, long long E,
                     int feat_table, long long block, void* stream) {
  if (E <= 0) return 0;
  if (rows <= 0 || F <= 0 || (F & 3) != 0 || block < 0 ||
      (block > 0 && E % block != 0) || (feat_table && !work))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  if (feat_table) {
    const long long tiles = (rows + kTileRows - 1) / kTileRows;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (F + kTileFeat - 1) / kTileFeat);
    transpose_features<<<grid, kThreads, 0, s>>>(t, (float*)work, rows, F);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    t = (const float*)work;
  }
  const float4* t4 = reinterpret_cast<const float4*>(t);
  const int* g = (const int*)gid;
  float* o = (float*)out;
  const int Q = F >> 2;
  switch (Q) {
    case 3: return gather_rows_q<3>(t4, g, o, rows, Q, E, block, s);
    case 4: return gather_rows_q<4>(t4, g, o, rows, Q, E, block, s);
    default: return gather_rows_q<0>(t4, g, o, rows, Q, E, block, s);
  }
}

// The build of instance i (kernels/gather.py:GATHER_INSTANCES): 0 the
// transpose; 1-3 entry out with Q = 3, 4, any; 4-6 blocked out through a
// shared tile with Q = 3, 4, any (6 at F = 16), 7-9 blocked out with scalar
// stores.
int msgs_gather_rows_info(int i, int* out) {
  switch (i) {
    case 0: return fill_kernel_info(transpose_features, kThreads, 0, out);
    case 1: return fill_kernel_info(gather_entry<3>, kThreads, 0, out);
    case 2: return fill_kernel_info(gather_entry<4>, kThreads, 0, out);
    case 3: return fill_kernel_info(gather_entry<0>, kThreads, 0, out);
    case 4: return fill_kernel_info(gather_blocked_tile<3>, kThreads,
                                    tile_bytes(12), out);
    case 5: return fill_kernel_info(gather_blocked_tile<4>, kThreads,
                                    tile_bytes(16), out);
    case 6: return fill_kernel_info(gather_blocked_tile<0>, kThreads,
                                    tile_bytes(16), out);
    case 7: return fill_kernel_info(gather_blocked_scalar<3>, kThreads, 0,
                                    out);
    case 8: return fill_kernel_info(gather_blocked_scalar<4>, kThreads, 0,
                                    out);
    case 9: return fill_kernel_info(gather_blocked_scalar<0>, kThreads, 0,
                                    out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
