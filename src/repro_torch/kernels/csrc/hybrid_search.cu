// DiLi hybrid search for Hopper (sm_90a): a warp-cooperative 32-ary search
// of the registry, then one sweep of the chosen packed block, one warp per
// query.
//
// Replaces the TPU kernel src/repro/kernels/hybrid_search.py::_kernel
// (driven by hybrid_search; public wrapper kernels/ops.py::hybrid_search).
// Same contract, bit for bit, for `keymin` sorted ascending and each row of
// `blocks` sorted (both INT32_MAX-padded) and any int32 query q:
//   entry = last i with keymin[i] < q (0 when none);
//   pos   = first index of blocks[entry] with key >= q, or C when none is
//           (the full-block edge: the caller decodes against its own
//           entry, never slot / C);
//   slot  = entry * C + pos (int32 wrap-around, as the reference's);
//   found = any(blocks[entry] == q) and q != INT32_MAX (the pad sentinel
//           equals every pad cell; the mask is applied here, so the wrapper
//           returns the outputs as they are).
// `pos` and `found` are exact for any row contents, sorted or not.
//
// What bounds it. On the main path (M = 256, C = 160, B = 128 lanes) one
// launch must read B*C*4 + M*4 + B*4 bytes ~ 83 KB and write B*5 bytes: at
// 3.35 TB/s that is ~0.02 us, and the operations are fewer still. What a
// launch costs instead is (1) the launch itself, ~2 us, and (2) the chain
// of dependent round trips to L2 or HBM each warp waits on: the query, the
// registry search, the row, the store. A binary search makes the search
// ceil(log2 M) dependent loads (8 at M = 256, 14 at M = 16384), and a row
// swept in a loop of 32-wide chunks adds a load per chunk. The design cuts
// the chain to one round trip per 32-ary step plus one for the row:
//   * the search loads 32 keymin values per step, one per lane, spread
//     evenly over the range still open, votes `keymin < q` with
//     __ballot_sync and narrows to one of 32 sub-ranges with __popc:
//     ceil(log32 M) steps at most (2 at M = 256, 3 at M = 16384). The first
//     step's addresses depend only on M, so its load is in flight together
//     with the query's, and every warp of the launch reads the same first
//     32 values (they stay in L1/L2);
//   * the row is loaded whole before any comparison, with no dependence
//     between the loads: 16-byte vector loads where C % 4 == 0 and the
//     rows are 16-byte aligned (C = 160: 40 int4, two per lane), scalar
//     loads otherwise; then one warp min-reduction (__reduce_min_sync) of
//     each lane's first key >= q gives pos, one vote gives found. The
//     vector sweep is the faster one at C = 160 on an H100 80GB HBM3 at
//     700 W (scripts/hybrid_search_sweep.py, which builds both): 1.821
//     against 1.909 us at the fig3a shape, 2.329 against 2.419 at
//     M = 16384, B = 128, and 3.764 against 4.400 at B = 4096.
// No shared memory: staging keymin costs M*4 bytes per block before the
// first comparison, more than the few strided loads it would save. Nothing
// here bounds the bytes.
//
// Block shape. One warp answers one query, 4 warps per block: at B = 128
// that is 32 blocks where 8 warps give 16, so more SMs take a share of the
// lanes. Timed once against 8 warps on an H100 80GB HBM3 at 700 W: 4 warps
// took 1.85-1.90 us and 8 warps 1.92-1.93 us at the fig3a shape (M = 256,
// C = 160, B = 128); at B = 4096 (M = 16384) 8 warps were 0-0.12 us
// faster (3.79-3.83 us against 3.83-3.93). The rounds launch it at
// B = 128, so 4 stays.
//
// The search step, exactly as tests/test_torch_kernels.py models it in
// numpy. [lo, hi) is the part of keymin not yet classified: every index
// below lo holds a key < q, every index from hi on a key >= q (index M
// counts as >= q), so count(keymin < q) lies in [lo, hi]. Start lo = 0,
// hi = M; while hi > lo:
//   span   = hi - lo
//   s      = (span - 1) / 32 + 1          (sub-range width, ceil(span/32))
//   nvalid = span / s                     (lanes probing a full sub-range;
//                                          1 <= nvalid <= 32)
//   lane j < nvalid probes i_j = lo + (j + 1) * s - 1 and votes
//            keymin[i_j] < q; lanes j >= nvalid vote false
//   k      = popc(ballot)                 (sorted: the first k votes)
//   hi     = k < nvalid ? lo + (k + 1) * s - 1 : hi
//   lo     = lo + k * s
// Each step leaves at most s - 1 < span open. At the end lo = count(keymin
// < q) and entry = max(lo - 1, 0), which is also the binary search's answer
// and searchsorted(keymin, q, 'left') - 1 clamped into [0, M - 1]. On an
// unsorted keymin the loop still ends (k <= nvalid; the span shrinks).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps (queries) per block
// ints of a row each lane loads per sweep batch: a batch covers 512 ints of
// the row, so rows up to C = 512 take one round trip
constexpr int kRowInts = 16;

// The row sweep: this lane's first index with key >= q (or c), and whether
// any of its keys equals q. Loads are issued before any comparison.
template <bool kVec>
__device__ __forceinline__ void sweep(const int* __restrict__ row, int c,
                                      int q, int lane, int& pos, bool& eq) {
  if constexpr (kVec) {
    constexpr int kSlots = kRowInts / 4;
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int n4 = c >> 2;
    for (int base = 0; base < n4; base += 32 * kSlots) {
      int4 v[kSlots] = {};
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int i = base + s * 32 + lane;
        if (i < n4) v[s] = __ldg(row4 + i);
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int i = base + s * 32 + lane;
        if (i < n4) {
          const int x[4] = {v[s].x, v[s].y, v[s].z, v[s].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (x[t] >= q) pos = min(pos, 4 * i + t);
            eq = eq || x[t] == q;
          }
        }
      }
    }
  } else {
    for (int base = 0; base < c; base += 32 * kRowInts) {
      int v[kRowInts] = {};
#pragma unroll
      for (int s = 0; s < kRowInts; ++s) {
        const int i = base + s * 32 + lane;
        if (i < c) v[s] = __ldg(row + i);
      }
#pragma unroll
      for (int s = 0; s < kRowInts; ++s) {
        const int i = base + s * 32 + lane;
        if (i < c) {
          if (v[s] >= q) pos = min(pos, i);
          eq = eq || v[s] == q;
        }
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
hybrid_search_kernel(const int* __restrict__ keymin,
                     const int* __restrict__ blocks,
                     const int* __restrict__ queries,
                     int* __restrict__ slot,
                     unsigned char* __restrict__ found,
                     int m, int c, int b) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= b) return;  // uniform per warp: the votes below stay full-mask

  const int q = __ldg(queries + w);
  // 32-ary registry search (the step arithmetic above); lo and hi come
  // from a ballot, so they are the same in every lane
  int lo = 0, hi = m;
  while (hi > lo) {
    const int span = hi - lo;
    const int s = (span - 1) / 32 + 1;
    const int nvalid = span / s;
    bool lt = false;
    if (lane < nvalid) lt = __ldg(keymin + lo + (lane + 1) * s - 1) < q;
    const int k = __popc(__ballot_sync(kFull, lt));
    hi = k < nvalid ? lo + (k + 1) * s - 1 : hi;
    lo += k * s;
  }
  const int entry = lo > 0 ? lo - 1 : 0;

  // bounded "linear traversal": the whole row in one round trip
  const int* row = blocks + static_cast<long long>(entry) * c;
  int pos = c;
  bool eq = false;
  sweep<kVec>(row, c, q, lane, pos, eq);
  pos = __reduce_min_sync(kFull, pos);
  eq = __any_sync(kFull, eq) != 0;
  if (lane == 0) {
    slot[w] = static_cast<int>(static_cast<unsigned>(entry) *
                                   static_cast<unsigned>(c) +
                               static_cast<unsigned>(pos));
    found[w] = (eq && q != INT_MAX) ? 1 : 0;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int hybrid_search_launch(const void* keymin, const void* blocks,
                                    const void* queries, void* slot,
                                    void* found, int m, int c, int b,
                                    void* stream) {
  if (b <= 0) return 0;
  if (m <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarps);
  const dim3 grid((b + kWarps - 1) / kWarps);
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(blocks) % 16 == 0;
  auto* kernel = vec ? hybrid_search_kernel<true>
                     : hybrid_search_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keymin), static_cast<const int*>(blocks),
      static_cast<const int*>(queries), static_cast<int*>(slot),
      static_cast<unsigned char*>(found), m, c, b);
  return static_cast<int>(cudaGetLastError());
}
