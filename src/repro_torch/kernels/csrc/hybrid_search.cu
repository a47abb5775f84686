// DiLi hybrid search for Hopper (sm_90a): registry binary search + one
// sweep of the chosen packed block, one warp per query.
//
// Replaces the TPU kernel src/repro/kernels/hybrid_search.py::_kernel
// (driven by hybrid_search; public wrapper kernels/ops.py::hybrid_search).
// Same contract, bit for bit: for each query q,
//   entry = last i with keymin[i] < q (0 when none), by the same
//           ceil(log2 M)-step binary search the TPU kernel runs;
//   pos   = first index of blocks[entry] with key >= q, or C when none is
//           (the full-block edge: the caller decodes against its own
//           entry, never slot / C);
//   slot  = entry * C + pos;   found = any(blocks[entry] == q).
// The INT32_MAX sentinel mask on `found` stays in the Python wrapper, as in
// the reference's public wrapper.
//
// What bounds it. On the main path (M = 256, C = 160, B = 128 lanes) one
// launch must read B*C*4 + M*4 + B*4 bytes ~ 83 KB and write B*5 bytes: at
// 3.35 TB/s that is ~0.03 us, far below the ~2-5 us a launch costs, so the
// kernel is bound by launch latency, then by the latency of the
// log2(M) dependent loads of the binary search — not by bytes or
// arithmetic. The design keeps both short: no shared-memory staging of
// keymin (staging costs M*4 bytes per block, more than the log2(M)
// broadcast loads it saves at these shapes; every lane of a warp reads the
// same address, one transaction), no tile padding (the grid masks the
// ragged edge), and a row sweep in 32-wide coalesced chunks whose
// comparisons reduce with warp ballots (__ballot_sync + __ffs) instead of
// shared memory. The sweep reads the whole row so `found` is exact for
// any row contents, as the reference's any(eq) is.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hybrid_search_kernel(const int* __restrict__ keymin,
                     const int* __restrict__ blocks,
                     const int* __restrict__ queries,
                     int* __restrict__ slot,
                     unsigned char* __restrict__ found,
                     int m, int c, int b, int levels) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= b) return;  // uniform per warp: the ballots below stay full-mask

  const int q = __ldg(queries + w);
  // registry binary search: entry covers keys > keymin[i] (Alg. 6)
  int lo = 0, hi = m - 1;
  for (int l = 0; l < levels; ++l) {
    const int mid = (lo + hi + 1) >> 1;
    const bool go = __ldg(keymin + mid) < q;
    lo = go ? mid : lo;
    hi = go ? hi : mid - 1;
  }
  const int entry = lo;

  // bounded "linear traversal": one coalesced sweep of the row
  const int* row = blocks + static_cast<long long>(entry) * c;
  int pos = c;
  bool any_eq = false;
  for (int base = 0; base < c; base += 32) {
    const int i = base + lane;
    const bool in = i < c;
    const int v = in ? __ldg(row + i) : 0;
    const unsigned ge = __ballot_sync(0xffffffffu, in && v >= q);
    const unsigned eq = __ballot_sync(0xffffffffu, in && v == q);
    if (pos == c && ge != 0u) pos = base + __ffs(ge) - 1;
    any_eq = any_eq || (eq != 0u);
  }
  if (lane == 0) {
    // int32 wrap-around exactly as the reference's int32 arithmetic
    slot[w] = static_cast<int>(static_cast<unsigned>(entry) *
                                   static_cast<unsigned>(c) +
                               static_cast<unsigned>(pos));
    found[w] = any_eq ? 1 : 0;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int hybrid_search_launch(const void* keymin, const void* blocks,
                                    const void* queries, void* slot,
                                    void* found, int m, int c, int b,
                                    int levels, void* stream) {
  if (b <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
  hybrid_search_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keymin), static_cast<const int*>(blocks),
      static_cast<const int*>(queries), static_cast<int*>(slot),
      static_cast<unsigned char*>(found), m, c, b, levels);
  return static_cast<int>(cudaGetLastError());
}
