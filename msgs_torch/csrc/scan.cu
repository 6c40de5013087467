// Inclusive prefix sum along the last axis of an (R, E) row-major array,
// float32 or int32. The plain version is msgs_torch/kernels/scan.py:
// cumsum_rows_plain (torch.cumsum with the input's dtype).
//
// Replaces msgs/kernels/scan.py:_scan_kernel (float32, exact to 2^24 through
// a 0/1 triangular MXU matmul) and :_scan_kernel_i32 (int32, lane
// Hillis-Steele), launched by cumsum_perm. The TPU kernels scan a
// sublane-major permuted layout that exists only to avoid TPU transposes;
// here rows are scanned in logical order.
//
// Bound on the H100: memory. A scan does one add per 4-byte element, so it
// is bound by reading the input once and writing the output once
// (2·R·E·4 bytes at 3.35 TB/s). At the main path's shapes that is 0.65 µs
// (1 × 270,336) to 13.5 µs (4 × 1,417,216), so one launch's latency is a
// large share of a call. The design is one launch per call, a single-pass
// scan with decoupled look-back (Merrill & Garland, 2016):
//
//   - grid (chunks, R); each CTA scans one CHUNK of 4096 elements of one row,
//     read once and written once. Each warp moves its 512 elements with
//     coalesced 16-byte vectors through a padded shared buffer, so that
//     each thread then scans 16 consecutive elements (loading a thread's
//     own 16 elements directly, 64 bytes apart across the warp, was slower
//     on the card);
//   - a CTA takes its chunk from a per-row atomic ticket, not from blockIdx:
//     the card does not promise to schedule blocks in order, and a CTA only
//     ever waits on chunks whose tickets were drawn before its own, by CTAs
//     that are therefore resident and never wait on it;
//   - it publishes its chunk total (flag AGGREGATE) in the chunk's status
//     word, then warp 0 looks back over its predecessors' words 32 at a time
//     and adds totals until it meets an inclusive prefix (flag PREFIX; chunk
//     0 publishes one at once), publishes its own inclusive prefix, and the
//     CTA writes its chunk from that offset.
//
// A status word is 64 bits, epoch (30) | flag (2) | value (32), written and
// read whole (st.relaxed.gpu / ld.relaxed.gpu): the value travels in the same
// single-copy-atomic word as its flag, so no other data needs ordering and no
// fence is needed. No memset launch is needed either:
//   - the host passes a new epoch with every call (scan.py keeps the status
//     words, the tickets and an epoch counter per device and stream); a word
//     whose epoch is not the call's is "not ready", so the words of earlier
//     calls, of any shape, are never read as this call's. At 2^30 calls the
//     host zeroes the words once and starts again at epoch 1 (0 is never
//     issued).
//   - the CTA that draws a row's last ticket sets that row's counter back to
//     0: every other CTA of the row has drawn by then, and the next call on
//     the stream starts after this one ends. Tickets live apart from the
//     status words, so every counter is 0 whatever shape comes next.
// Calls on one stream run one after the other; calls on two streams use two
// sets of buffers, so they never share a word or a ticket. The epoch is a
// launch argument, so a captured CUDA graph would replay one epoch and
// read its previous replay's words as ready: scan.py refuses capture.
//
// Exactness. int32 is added as uint32, so every intermediate (including
// chunk totals that leave the int32 range when partial sums swing from
// negative to positive) wraps with defined behaviour and the results are
// exact mod 2^32, whatever the order: exact wherever the true prefix sums fit
// in int32. float32 is exact for integer-valued inputs whose partial sums (of
// any contiguous range) stay below 2^24 in magnitude, as in the TPU kernel:
// every sum the scan forms is the sum of a contiguous range. With look-back
// the order of float additions depends on timing (how far back a CTA finds a
// prefix), which is harmless only for such inputs. Every float32 caller scans
// integers: msgs_torch/kernels/binning.py:_delta_scan's five rect fields
// (gid + 1, offsets, offsets + kept, the packed rect corner, the packed
// width and depth quantum; all integers below 2^24, asserted there) and the
// dummy stream's tile + 1 in _finalize; _cover, _excl_cumsum and gid_starts
// scan int32. For other float inputs the sums are rounded in another order
// than torch.cumsum's, and may differ from call to call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                  // elements a thread
constexpr int kChunk = kThreads * kPerThread;   // 4096 elements per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 32 * kPerThread;           // a warp's elements
constexpr size_t kDynSmem = 0;                  // shared memory is static
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kEpochs = 1u << 30;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

// A value's 32 bits, and back: float, the int32 input and output, and
// the uint32 they are added as.
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned to_bits(uint32_t v) { return v; }
__device__ __forceinline__ unsigned to_bits(int32_t v) { return (unsigned)v; }

template <typename X>
__device__ __forceinline__ X from_bits(unsigned b) {
  return (X)b;   // uint32_t, int32_t
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

template <typename Acc>
__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, Acc v) {
  return ((unsigned long long)epoch << 34) | (flag << 32) | to_bits(v);
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename Acc>
__device__ __forceinline__ Acc warp_incl_scan(Acc v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    Acc o = __shfl_up_sync(kAll, v, k);
    if (lane >= k) v = v + o;
  }
  return v;
}

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v = v + __shfl_xor_sync(kAll, v, k);
  return v;
}

// Exclusive block scan of one value per thread; returns the thread's
// exclusive prefix and writes the block total to *total.
template <typename Acc>
__device__ __forceinline__ Acc block_excl_scan(Acc v, Acc* warp_tot,
                                               Acc* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc incl = warp_incl_scan(v);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Acc t = lane < kWarps ? warp_tot[lane] : Acc(0);
    Acc ti = warp_incl_scan(t);
    if (lane < kWarps) warp_tot[lane] = ti - t;   // exclusive warp offsets
    if (lane == kWarps - 1) *total = ti;
  }
  __syncthreads();
  return warp_tot[warp] + incl - v;
}

// Warp 0 of the CTA that scans `chunk`: publishes the chunk's total, looks
// back for its exclusive prefix, publishes its inclusive prefix. Returns
// the exclusive prefix (every lane).
template <typename Acc>
__device__ __forceinline__ Acc look_back(unsigned long long* st, int chunk,
                                         Acc total, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  if (chunk == 0) {
    if (lane == 0) st_status(st, status_word(epoch, kPrefix, total));
    return Acc(0);
  }
  if (lane == 0) st_status(st + chunk, status_word(epoch, kAggregate, total));
  Acc excl = Acc(0);
  // Lane l reads chunk − 1 − l: lane 0 the nearest predecessor. Below
  // chunk 0 reads as a prefix of 0 (never reached: chunk 0's word is one).
  for (int j = chunk - 1 - lane;; j -= 32) {
    unsigned long long w;
    for (;;) {
      w = j >= 0 ? ld_status(st + j) : status_word(epoch, kPrefix, Acc(0));
      const bool ready = (unsigned)(w >> 34) == epoch && ((w >> 32) & 3u);
      if (__all_sync(kAll, ready)) break;
    }
    const unsigned pre = __ballot_sync(kAll, ((w >> 32) & 3u) == kPrefix);
    // Lanes up to the nearest prefix contribute; the prefix ends the walk.
    const int stop = pre ? __ffs(pre) - 1 : 31;
    excl = excl + warp_sum(lane <= stop ? from_bits<Acc>((unsigned)w)
                                        : Acc(0));
    if (pre) break;
  }
  if (lane == 0)
    st_status(st + chunk, status_word(epoch, kPrefix, excl + total));
  return excl;
}

// Shared-memory word index with one pad word per 32, so that the threads'
// 16 consecutive words and a warp's 16-byte vectors fall in distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Moves a warp's segment of kSeg elements between device memory and the
// warp's shared buffer, coalesced: 16-byte vectors where the segment is
// whole and aligned, single elements otherwise (the row's ragged end, or a
// row that starts off a 16-byte boundary).
template <typename T>
__device__ __forceinline__ void load_segment(const T* seg, long long left,
                                             unsigned* buf) {
  const int lane = threadIdx.x & 31;
  if (left >= kSeg && (reinterpret_cast<uintptr_t>(seg) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int i = 4 * (32 * k + lane);
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(seg + i));
      buf[pad(i)] = a.x;
      buf[pad(i + 1)] = a.y;
      buf[pad(i + 2)] = a.z;
      buf[pad(i + 3)] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = 32 * k + lane;
      buf[pad(i)] = i < left ? to_bits(seg[i]) : 0u;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_segment(T* seg, long long left,
                                              const unsigned* buf) {
  const int lane = threadIdx.x & 31;
  if (left >= kSeg && (reinterpret_cast<uintptr_t>(seg) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int i = 4 * (32 * k + lane);
      reinterpret_cast<uint4*>(seg + i)[0] =
          make_uint4(buf[pad(i)], buf[pad(i + 1)], buf[pad(i + 2)],
                     buf[pad(i + 3)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = 32 * k + lane;
      if (i < left) seg[i] = from_bits<T>(buf[pad(i)]);
    }
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
scan_lookback(const T* __restrict__ x, T* __restrict__ out,
              unsigned* __restrict__ tickets,
              unsigned long long* __restrict__ status, long long E,
              int chunks, unsigned epoch) {
  __shared__ unsigned buf[kWarps][kSeg + kSeg / 32];
  __shared__ int s_chunk;
  __shared__ Acc warp_tot[kWarps];
  __shared__ Acc s_total;
  __shared__ Acc s_excl;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(&tickets[row], 1u);
    // The row's last ticket: every CTA of the row has drawn, so the counter
    // goes back to 0 for the next call.
    if (t == (unsigned)chunks - 1) atomicExch(&tickets[row], 0u);
    s_chunk = (int)t;
  }
  __syncthreads();
  const long long off =
      (long long)s_chunk * kChunk + (long long)warp * kSeg;
  const long long left = E - off;   // elements of the row from the segment
  load_segment(x + (long long)row * E + off, left, buf[warp]);
  __syncwarp();

  // Each thread scans its 16 consecutive elements.
  Acc v[kPerThread];
  Acc s = Acc(0);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    s = s + from_bits<Acc>(buf[warp][pad(lane * kPerThread + i)]);
    v[i] = s;
  }
  const Acc ex = block_excl_scan(s, warp_tot, &s_total);
  if (warp == 0) {
    const Acc excl = look_back(status + (long long)row * chunks, s_chunk,
                               s_total, epoch);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const Acc o = s_excl + ex;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    buf[warp][pad(lane * kPerThread + i)] = to_bits(o + v[i]);
  __syncwarp();
  store_segment(out + (long long)row * E + off, left, buf[warp]);
}

template <typename T, typename Acc>
int launch_scan(const void* x, void* out, void* tickets, void* status,
                int rows, long long E, unsigned epoch, void* stream) {
  if (rows <= 0 || E <= 0) return 0;
  const long long chunks = (E + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffffLL || rows > 65535 || epoch == 0 ||
      epoch >= kEpochs)
    return (int)cudaErrorInvalidValue;
  scan_lookback<T, Acc>
      <<<dim3((unsigned)chunks, (unsigned)rows), kThreads, kDynSmem,
          (cudaStream_t)stream>>>(
          (const T*)x, (T*)out, (unsigned*)tickets,
          (unsigned long long*)status, E, (int)chunks, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tickets` (at least rows 32-bit counters) and `status` (at least rows ·
// ceil(E / 4096) 64-bit words) are scratch kept from call to call, zero
// when first allocated; the kernel leaves every ticket at 0. `epoch` is new
// for every call on them, in [1, 2^30).
int msgs_scan_f32(const void* x, void* out, void* tickets, void* status,
                  int rows, long long E, unsigned epoch, void* stream) {
  return launch_scan<float, float>(x, out, tickets, status, rows, E, epoch,
                                   stream);
}

int msgs_scan_i32(const void* x, void* out, void* tickets, void* status,
                  int rows, long long E, unsigned epoch, void* stream) {
  return launch_scan<int32_t, uint32_t>(x, out, tickets, status, rows, E,
                                        epoch, stream);
}

// The scan kernel's build: registers, stack bytes, static and dynamic
// shared memory, and CTAs per SM at its launch configuration.
int msgs_scan_info(int i32, int* out) {
  return i32 ? fill_kernel_info(scan_lookback<int32_t, uint32_t>, kThreads,
                                kDynSmem, out)
             : fill_kernel_info(scan_lookback<float, float>, kThreads,
                                kDynSmem, out);
}

const char* msgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
