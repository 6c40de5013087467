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
// reads the table (6.4 MB at the scripts' default, 4.8 MB on the render
// path: it fits in the 50 MB L2, so it comes from DRAM about once) and
// writes E·F floats. The design makes every store coalesced and reads table
// rows through the read-only path (ld.global.nc):
//   entry out:   one thread per 16 bytes of output, a float4; a warp stores
//                512 contiguous bytes. From a row table the thread loads one
//                float4 of the row (rows are 16-byte aligned since F % 4 ==
//                0); from a feature table four scalars, `rows` apart.
//   blocked out: one thread per entry, which stores its F values to F
//                output rows; consecutive threads store consecutive
//                addresses of each row. From a row table the thread loads
//                its row as F/4 float4s.
// Ids outside [0, rows) are outside the contract; they are clamped to that
// range, as XLA's row gather does, so no read leaves the table. Offsets are
// 64-bit throughout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_id(const int* gid, long long e,
                                              long long rows) {
  long long id = __ldg(gid + e);
  return id < 0 ? 0 : (id >= rows ? rows - 1 : id);
}

// One thread per float4 of the (E, F) output: entry e, features 4q..4q+3.
template <bool kFeatTable>
__global__ void __launch_bounds__(kThreads)
gather_entry(const float* __restrict__ table, const int* __restrict__ gid,
             float* __restrict__ out, long long rows, int F, long long E) {
  const int Q = F >> 2;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= E * Q) return;
  const long long e = t / Q;
  const int q = (int)(t - e * Q);
  const long long id = clamp_id(gid, e, rows);
  float4 v;
  if (!kFeatTable) {
    v = __ldg(reinterpret_cast<const float4*>(table + id * F) + q);
  } else {
    const float* c = table + (long long)(4 * q) * rows + id;
    v.x = __ldg(c);
    v.y = __ldg(c + rows);
    v.z = __ldg(c + 2 * rows);
    v.w = __ldg(c + 3 * rows);
  }
  reinterpret_cast<float4*>(out)[t] = v;
}

// One thread per entry e of the (E/B, F, B) output.
template <bool kFeatTable>
__global__ void __launch_bounds__(kThreads)
gather_blocked(const float* __restrict__ table, const int* __restrict__ gid,
               float* __restrict__ out, long long rows, int F, long long E,
               long long B) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const long long id = clamp_id(gid, e, rows);
  const long long b = e / B;
  float* o = out + b * F * B + (e - b * B);
  if (!kFeatTable) {
    const float4* r = reinterpret_cast<const float4*>(table + id * F);
    for (int q = 0; q < (F >> 2); ++q) {
      const float4 v = __ldg(r + q);
      o[(4 * q + 0) * B] = v.x;
      o[(4 * q + 1) * B] = v.y;
      o[(4 * q + 2) * B] = v.z;
      o[(4 * q + 3) * B] = v.w;
    }
  } else {
    for (int f = 0; f < F; ++f) o[f * B] = __ldg(table + f * rows + id);
  }
}

}  // namespace

extern "C" {

// table: float32, (rows, F) if feat_table == 0, else (F, rows).
// out: (E, F) if block == 0, else (E/block, F, block); block divides E.
// F % 4 == 0, table and out 16-byte aligned (the wrapper checks).
int msgs_gather_rows(const void* table, const void* gid, void* out,
                     long long rows, int F, long long E, int feat_table,
                     long long block, void* stream) {
  if (E <= 0) return 0;
  if (rows <= 0 || F <= 0 || (F & 3) != 0 || block < 0 ||
      (block > 0 && E % block != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const int* g = (const int*)gid;
  float* o = (float*)out;
  const long long units = block == 0 ? E * (F >> 2) : E;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (block == 0) {
    if (feat_table)
      gather_entry<true><<<(unsigned)blocks, kThreads, 0, s>>>(t, g, o, rows,
                                                               F, E);
    else
      gather_entry<false><<<(unsigned)blocks, kThreads, 0, s>>>(t, g, o,
                                                                rows, F, E);
  } else {
    if (feat_table)
      gather_blocked<true><<<(unsigned)blocks, kThreads, 0, s>>>(
          t, g, o, rows, F, E, block);
    else
      gather_blocked<false><<<(unsigned)blocks, kThreads, 0, s>>>(
          t, g, o, rows, F, E, block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
