// DiLi packed-block refresh for Hopper (sm_90a): every dirty, owned, live
// registry entry walks its own chain on the card, all rows in one launch,
// with nothing read back by the host.
//
// Replaces no Pallas kernel. The reference rebuilds the blocks in
// src/repro/core/blocks.py::refresh_blocks as one jax.lax.while_loop, which
// XLA keeps on the device. Run eagerly, the same lock-step walk
// (kernels/ref.py::refresh_walk_ref, the CPU path) makes ~20 small
// launches a step and reads its exit test on the host once a step: ~150
// round trips a round on the main path, each waiting for the card. Public
// wrapper: kernels/ops.py::refresh_walk.
//
// Contract, bit for bit with refresh_walk_ref on any int32 inputs. Refs
// pack {mark: bit 31, shard id: bits 30..22, index: bits 21..0}; NULL is
// the index field all ones, unmarked. For row e of M (C columns; the pool
// has N nodes, stct NC slots; clamp() clamps an index into its array):
//   live = e < size and subhead[e] is not NULL and sid(subhead[e]) == me
//          and stct[clamp(reg_ctr[e])] >= 0
//          and newloc[clamp(idx(subhead[e]))] is NULL;
//   a row that is not live, or already valid, keeps its old keys and idx,
//   and leaves valid = old valid and live, after 0 steps;
//   any other row walks from cur = nxt[head]. A step reads node
//   ci = clamp(idx(cur)) and stops on the first of: a foreign shard id
//   in cur, a NULL cur, a moving node (newloc set), a switched counter
//   (stct[clamp(ctr[ci])] < 0), an ST node that is not the registered
//   unmarked SubTail, a live key past column C-1 -- or, valid, at the
//   registered unmarked SubTail. Marked non-ST nodes and SH_KEY nodes are
//   stepped over; every other node's key and ci go to the next column.
//   A row still walking after max_scan steps is not valid. Columns past
//   the last write hold ST_KEY / 0. steps[e] counts the steps taken.
// The lock-step loop advances all rows together, but each row reads only
// round-start state and writes only its own row, and a row that stops
// never resumes: so each row walked alone, under the same bound, takes the
// same steps and writes the same row.
//
// What bounds it. At the main path's shape (M = 16384, C = 160, N = 2**21)
// about 190 rows are dirty a round and the longest walk takes ~150 steps.
// A step cannot start before the previous one's next pointer has arrived,
// so the least time is the longest walk's steps times one dependent load's
// latency (an L2 hit or an HBM read; ~0.05-0.1 ms in all). The bytes are
// the copy of the M x C clean rows into fresh outputs, 2 x 10.5 MB read and
// written: ~13 us at 3.35 TB/s. The design keeps the chain to one load a
// step:
//   * one warp per entry, kWarps per block. The gate's loads go out
//     together, the walk's first pointer with them; warps of rows that
//     need no walk copy their old row with all 32 lanes and exit;
//   * lane 0 walks. Each step starts the next node's four loads (nxt, key,
//     newloc, ctr at the index of this node's nxt) before it decides this
//     step, beside this step's stct load, so only nxt[] is on the
//     dependent path. Those loads are asm volatile: the compiler may not
//     sink them below the exit test, where they would wait a step more.
//     A load past the chain's end reads a clamped, valid index and is
//     dropped;
//   * the row's keys and indices are staged in shared memory (2 x C int32
//     a warp), then written with the ST_KEY / 0 padding by all 32 lanes,
//     coalesced.
// Outputs are fresh buffers: the caller's state is never written.
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                 // entries (warps) per block
constexpr int kIdxBits = 22;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kSidMask = (1 << 9) - 1;
constexpr int kNullRef = kIdxMask;
constexpr int kUnmark = 0x7fffffff;
constexpr int kShKey = INT_MIN;
constexpr int kStKey = INT_MAX;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ int ref_idx(int r) { return r & kIdxMask; }
__device__ __forceinline__ int ref_sid(int r) {
  return (r >> kIdxBits) & kSidMask;
}
__device__ __forceinline__ bool is_null(int r) {
  return (r & kUnmark) == kNullRef;
}

// A read-only load that stays where the walk places it.
__device__ __forceinline__ int load(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
refresh_walk_kernel(const int* __restrict__ key, const int* __restrict__ nxt,
                    const int* __restrict__ ctr,
                    const int* __restrict__ newloc,
                    const int* __restrict__ stct,
                    const int* __restrict__ subhead,
                    const int* __restrict__ subtail,
                    const int* __restrict__ reg_ctr,
                    const int* __restrict__ size,
                    const int* __restrict__ old_keys,
                    const int* __restrict__ old_idx,
                    const unsigned char* __restrict__ old_valid,
                    int* __restrict__ keys, int* __restrict__ idx,
                    unsigned char* __restrict__ valid,
                    int* __restrict__ steps, int m, int c, int n, int nc,
                    int me, int max_scan) {
  extern __shared__ int stage[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + wid;
  if (e >= m) return;  // uniform per warp: the shuffle below is full-mask

  // the gate: every lane loads the same words (one broadcast each)
  const int sh = __ldg(subhead + e);
  const int head = min(ref_idx(sh), n - 1);
  const int slot = min(max(__ldg(reg_ctr + e), 0), nc - 1);
  const int sz = __ldg(size);
  const bool was_valid = __ldg(old_valid + e) != 0;
  const int head_moved = __ldg(newloc + head);
  const int first = __ldg(nxt + head);
  const int st_ref = __ldg(subtail + e) & kUnmark;
  const bool live = e < sz && !is_null(sh) && ref_sid(sh) == me &&
                    __ldg(stct + slot) >= 0 && is_null(head_moved);
  const long long base = static_cast<long long>(e) * c;

  if (!live || was_valid) {
    for (int j = lane; j < c; j += 32) {
      keys[base + j] = __ldg(old_keys + base + j);
      idx[base + j] = __ldg(old_idx + base + j);
    }
    if (lane == 0) {
      valid[e] = live && was_valid;
      steps[e] = 0;
    }
    return;
  }

  int* s_key = stage + wid * 2 * c;
  int* s_idx = s_key + c;
  int col = 0, walked = 0;
  bool good = false;
  if (lane == 0 && max_scan > 0) {
    int cur = first;
    int ci = min(ref_idx(cur), n - 1);
    int w = load(nxt + ci), k = load(key + ci), nl = load(newloc + ci),
        ct = load(ctr + ci);
    for (;;) {
      ++walked;
      const int sc = load(stct + min(max(ct, 0), nc - 1));
      // the next node's loads, from this node's nxt, before the decision
      const int cn = min(ref_idx(w), n - 1);
      const int wn = load(nxt + cn), kn = load(key + cn),
                nln = load(newloc + cn), ctn = load(ctr + cn);
      const bool marked = w < 0;
      const bool at_st = k == kStKey;
      const bool reach_ok = at_st && !marked && (cur & kUnmark) == st_ref;
      const bool hop = k == kShKey || (marked && !at_st);
      const bool want = !at_st && !hop;
      const bool bad = ref_sid(cur) != me || is_null(cur) || !is_null(nl) ||
                       sc < 0 || (at_st && !reach_ok) || (want && col >= c);
      if (want && !bad) {
        s_key[col] = k;
        s_idx[col] = ci;
        ++col;
      }
      good = reach_ok;  // a reached SubTail validates even where `bad`
      if (bad || reach_ok || walked == max_scan) break;
      cur = w;
      ci = cn;
      w = wn;
      k = kn;
      nl = nln;
      ct = ctn;
    }
  }
  col = __shfl_sync(kFull, col, 0);
  __syncwarp();
  for (int j = lane; j < c; j += 32) {
    const bool written = j < col;
    keys[base + j] = written ? s_key[j] : kStKey;
    idx[base + j] = written ? s_idx[j] : 0;
  }
  if (lane == 0) {
    valid[e] = good;
    steps[e] = walked;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers (old_valid and
// valid one byte an entry); `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int refresh_walk_launch(
    const void* key, const void* nxt, const void* ctr, const void* newloc,
    const void* stct, const void* subhead, const void* subtail,
    const void* reg_ctr, const void* size, const void* old_keys,
    const void* old_idx, const void* old_valid, void* keys, void* idx,
    void* valid, void* steps, int m, int c, int n, int nc, int me,
    int max_scan, void* stream) {
  if (m <= 0) return 0;
  if (c <= 0 || n <= 0 || nc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * 2 * c * sizeof(int);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        refresh_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(32 * kWarps);
  const dim3 grid((m + kWarps - 1) / kWarps);
  refresh_walk_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const int*>(nxt),
      static_cast<const int*>(ctr), static_cast<const int*>(newloc),
      static_cast<const int*>(stct), static_cast<const int*>(subhead),
      static_cast<const int*>(subtail), static_cast<const int*>(reg_ctr),
      static_cast<const int*>(size), static_cast<const int*>(old_keys),
      static_cast<const int*>(old_idx),
      static_cast<const unsigned char*>(old_valid), static_cast<int*>(keys),
      static_cast<int*>(idx), static_cast<unsigned char*>(valid),
      static_cast<int*>(steps), m, c, n, nc, me, max_scan);
  return static_cast<int>(cudaGetLastError());
}
