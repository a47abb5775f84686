// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over KV pages that a page table names, with grouped query heads, as a
// split-page ("flash-decoding") kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (driven by paged_attention; public wrapper kernels/ops.py::paged_attention;
// plain twin kernels/ref.py::paged_attention_ref). Same contract:
//   q [B,H,D], k_pages/v_pages [P,S,KH,D] (float or bf16), page_table
//   int32[B,PP], seq_lens int32[B] -> out [B,H,D] in q's type.
//   - Query head hq attends with KV head hq / G (G = H/KH, the TPU kernel's
//     q.reshape(KH, G, D)).
//   - Scores are (q . k) * D**-0.5 in f32; a position p*S + s >= seq_len
//     scores -1e30 (the reference's NEG_INF, not -inf).
//   - The output is acc / max(l, 1e-30) of an online softmax (running max
//     m, sum l, weighted V acc) in f32, in q's type.
//   - Page ids are clamped into [0, P-1] so memory stays safe; the caller
//     (serving/paged.py) clamps its -1 sentinel to 0 and relies on the
//     length mask, as the reference's caller does.
//   - A row with seq_len <= 0 gives the reference's answer, the mean of V
//     over all PP*S named positions (every score is -1e30, so the softmax
//     is uniform): such a row walks every one of its pages.
//
// What bounds it. The work is ~4 flops per element read (G <= 7 query heads
// share each K/V row at the serving shapes), far below the card's ridge, so
// the bound is bytes: at the serving shape (Qwen2-0.5B: B=8, H=14, KH=2,
// D=64, S=16, PP=34, f32) each live token costs its K and V rows for both
// KV heads, 2 * KH * D * 4 B = 1 KB, ~0.86 us at 3.35 TB/s for the ~2,900
// live tokens of a step. What keeps the kernel far from that is latency: a
// block walks its pages one dependent step at a time, and B*KH = 16
// (sequence, KV head) pairs walking 34 pages each would leave 116 of the
// 132 SMs idle. So:
//   - Grid over (unit, split). A unit is a sequence, a KV head and a block
//     of GB <= 8 of its query heads (GB = G up to 8), one warp per head, so
//     a block has at most 256 threads. A split is a contiguous range of the
//     sequence's pages. The wrapper (kernels/paged_attention.py::plan)
//     picks the split count from PP, the unit count and the SM count for
//     about two blocks per SM (16 units x 17 splits of 2 pages = 272 at the
//     serving shape); one split, with no merge, when the units alone fill
//     the card.
//   - The masked tail is skipped. A live split (seq_len >= 1) stops at its
//     last page holding a position < seq_len; a split wholly past it walks
//     no page and publishes the empty partial m = -1e30, l = 0, acc = 0.
//     That is exact: once m is finite a fully masked page has alpha = 1
//     and weights exp(-1e30 - m) = 0, so only the order of the sums moves.
//   - Pages are staged asynchronously. A split loads its page ids and its
//     heads' q (as f32) into shared memory once; each page's [S, D] K and V
//     tiles of the block's KV head (rows KH*D elements apart in [P,S,KH,D])
//     arrive by 16-byte cp.async copies, double-buffered: one barrier per
//     page, the next page's copy in flight while this one is computed; one
//     buffer where two exceed the card's shared memory (S = 64, D = 256,
//     f32). Above 48 KB the launch opts in with cudaFuncSetAttribute. Rows
//     are padded by 16 bytes, an odd number of 16-byte chunks, so the 8 lanes
//     of a quarter-warp reading 8 positions' chunks hit 8 bank groups.
//   - Scores without a shuffle tree per score: each lane owns a key
//     position (two when S > 32; with S <= 16 the two half-warps take the
//     two halves of D for the same position and add them with one shuffle)
//     and takes its dot product from shared memory, four 16-byte chunks of
//     K and q loaded ahead of their sums. One warp max and one warp sum per
//     page. For P.V each lane owns kDpl consecutive dims of D; the page's
//     weights go through the warp's row of shared memory, and a batch of
//     positions' weights and V rows is loaded before it is summed. No
//     tensor cores: G <= 7 rows per KV head is far from wgmma's 64-row
//     tile, the kernel is byte- and latency-bound, and TF32 would break the
//     f32 tolerance of 2e-5. All arithmetic is f32 on CUDA cores.
//   - The merge is in the same launch (a second launch would add one ~16 us
//     host launch per layer to a host-bound decode step). Each split writes
//     (m, l, acc[GB, D]) into an f32 workspace the wrapper allocates; the
//     last block of a unit to finish, found by an atomic ticket (an atomic
//     add on a per-unit counter between two fence.acq_rel.gpu),
//     merges the partials in split-index order (m* = max m_i, l* = sum l_i
//     e^(m_i-m*), acc* = sum acc_i e^(m_i-m*)) and writes the output, so
//     the result is bitwise the same from run to run. The counters live in
//     an int32 tensor the wrapper caches per device, zeroed once; the
//     merging block resets its unit's counter for the next launch. That
//     assumes the launches that share the counters run in order on one
//     stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeads = 8;   // query heads (warps) computing in a block
constexpr int kMinWarps = 4;   // warps past the block's heads only copy

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* seq_lens;
  void* out;
  float* ws;      // [units, splits, GB, D] acc, then [units, splits, GB, 2]
  int* counters;  // [units], zero between launches
  int h, kh, d, n_pages, s, pp, n_split, split_pages;
  int gb;         // query heads per block: a divisor of G, <= kMaxHeads
  int stages;     // page buffers: 2, or 1 where two do not fit
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// q . k over one 16-byte chunk of a K row (q already f32)
__device__ __forceinline__ float dot16(const float* k, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(q);
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* k,
                                       const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* kk = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 b0 = *reinterpret_cast<const float4*>(q);
  const float4 b1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 a0 = __bfloat1622float2(kk[0]);
  const float2 a1 = __bfloat1622float2(kk[1]);
  const float2 a2 = __bfloat1622float2(kk[2]);
  const float2 a3 = __bfloat1622float2(kk[3]);
  const float lo = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y,
                        fmaf(a1.x, b0.z, a1.y * b0.w)));
  const float hi = fmaf(a2.x, b1.x, fmaf(a2.y, b1.y,
                        fmaf(a3.x, b1.z, a3.y * b1.w)));
  return lo + hi;
}

// n consecutive elements (n even, 8-byte aligned for float) as f32
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    o[i] = v.x;
    o[i + 1] = v.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block per (unit, split). A unit is (sequence b, KV head, head block):
// the G query heads of a KV head go to G / GB blocks of GB heads, one warp
// per head (at least kMinWarps warps), so a block never has more than 256
// threads. kDpl = dims of D each lane owns in P.V, consecutive ones
// (D <= 32 * kDpl).
template <typename T, int kDpl>
__global__ void __launch_bounds__(32 * kMaxHeads)
    paged_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kBatch = 16 / kDpl;     // rows loaded ahead of their sums
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int g = p.h / p.kh;
  const int gb = p.gb;
  const int d = p.d;
  const int rowp = d + kVec;      // a padded [D] row, in elements
  const int tile = p.s * rowp;    // one padded [S, D] tile
  T* kv = reinterpret_cast<T*>(smem);  // [stages][K, V][S][rowp]
  float* qs = reinterpret_cast<float*>(kv + p.stages * 2 * tile);  // [GB, D]
  float* es = qs + gb * d;  // [GB, 64]: a page's softmax weights
  int* ids = reinterpret_cast<int*>(es + gb * 64);  // [split_pages]

  const int split = blockIdx.x % p.n_split;
  const int unit = blockIdx.x / p.n_split;
  const int n_hb = g / gb;
  const int b = unit / (p.kh * n_hb);
  const int kvh = (unit / n_hb) % p.kh;
  const int head0 = kvh * g + (unit % n_hb) * gb;  // the block's first head
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = split * p.split_pages;
  const int p1 = min(p.pp, p0 + p.split_pages);

  // the split's page ids and the block's q rows, once; the length beside
  const int* pt = p.page_table + static_cast<long long>(b) * p.pp;
  for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x)
    ids[i] = min(max(pt[p0 + i], 0), p.n_pages - 1);
  const T* qg = static_cast<const T*>(p.q) +
                (static_cast<long long>(b) * p.h + head0) * d;
  for (int i = threadIdx.x; i < gb * d; i += blockDim.x)
    qs[i] = to_f32(qg[i]);
  const int len = p.seq_lens[b];
  // pages holding a position < len; a row with len <= 0 walks them all
  const int live =
      len <= 0 ? p.pp : min(p.pp, len / p.s + (len % p.s != 0 ? 1 : 0));
  const int n = max(min(p1, live) - p0, 0);  // pages this split walks
  __syncthreads();

  const T* kg = static_cast<const T*>(p.k_pages);
  const T* vg = static_cast<const T*>(p.v_pages);
  const int chunks = d / kVec;  // 16-byte chunks per row
  // Each thread copies chunk `cc` of rows r0, r0 + rstep, ... of a page's
  // K tile and of its V tile (chunks <= 64 < blockDim).
  const int cc = threadIdx.x % chunks;
  const int rstep = blockDim.x / chunks;
  const int r0 = threadIdx.x / chunks;
  const long long page_elems = static_cast<long long>(p.s) * p.kh * d;
  const int src_step = rstep * p.kh * d;
  const int dst_step = rstep * rowp;
  // page p0 + i of this split into buffer `stage`, as one commit group
  auto issue = [&](int i, int stage) {
    const long long off = ids[i] * page_elems +
                          static_cast<long long>(r0 * p.kh + kvh) * d +
                          cc * kVec;
    T* dst = kv + stage * 2 * tile + r0 * rowp + cc * kVec;
    const T* ks = kg + off;
    const T* vs = vg + off;
    if (r0 < rstep) {
      for (int r = r0; r < p.s; r += rstep) {
        cp_async16(dst, ks);
        cp_async16(dst + tile, vs);
        dst += dst_step;
        ks += src_step;
        vs += src_step;
      }
    }
    cp_async_commit();
  };

  const bool active = warp < gb;
  const float* qrow = qs + warp * d;
  // Scores: lane owns key position pos0 (and pos0 + 32 when S > 32). With
  // S <= 16 the two half-warps take the two halves of D for the same
  // position and add them with one shuffle.
  const bool halves = p.s <= 16;
  const int pos0 = halves ? (lane & 15) : lane;
  const int c_lo = halves ? (lane >> 4) * (chunks / 2) : 0;
  const int c_hi = halves ? c_lo + chunks / 2 : chunks;
  const bool has0 = halves ? lane < 16 && pos0 < p.s : lane < p.s;
  const bool has1 = lane + 32 < p.s;
  float acc[kDpl];
#pragma unroll
  for (int j = 0; j < kDpl; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  // q . K[row] over chunks [lo, hi), loaded four chunks at a time
  auto row_dot = [&](const T* row, int lo, int hi) {
    float sum = 0.f;
    for (int c0 = lo; c0 < hi; c0 += 4) {
      float part[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[u] = c0 + u < hi ? dot16(row + (c0 + u) * kVec,
                                      qrow + (c0 + u) * kVec)
                              : 0.f;
      sum += (part[0] + part[1]) + (part[2] + part[3]);
    }
    return sum;
  };
  // P.V: lane owns dims [dim0, dim0 + kDpl) of D
  const int dim0 = lane * kDpl;
  const bool own = dim0 < d;
  // pv += sum over positions [0, S) of e(si) * V[si], with the weights in
  // the warp's row of es; kBatch positions' weights and rows are loaded
  // before they are added up in position order
  const float* e_s = es + warp * 64;
  auto pv_rows = [&](const T* vt, float* pv) {
    for (int s0 = 0; s0 < p.s; s0 += kBatch) {
      float ev[kBatch], vv[kBatch][kDpl];
      if constexpr (kBatch % 4 == 0) {
#pragma unroll
        for (int u = 0; u < kBatch; u += 4) {
          const float4 e4 = *reinterpret_cast<const float4*>(e_s + s0 + u);
          ev[u] = e4.x;
          ev[u + 1] = e4.y;
          ev[u + 2] = e4.z;
          ev[u + 3] = e4.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) ev[u] = e_s[s0 + u];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (own && s0 + u < p.s) {
          load_f32(vt + (s0 + u) * rowp + dim0, vv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < kDpl; ++j) vv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < p.s) {
#pragma unroll
          for (int j = 0; j < kDpl; ++j) pv[j] = fmaf(ev[u], vv[u][j], pv[j]);
        }
      }
    }
  };

  // one page of the online softmax for this warp's head
  auto step = [&](const T* kt, int page) {
    const T* vt = kt + tile;
    const int base = page * p.s;
    const bool live0 = pos0 < p.s && base + pos0 < len;
    float part0 = live0 ? row_dot(kt + pos0 * rowp, c_lo, c_hi) : 0.f;
    if (halves) part0 += __shfl_xor_sync(0xffffffffu, part0, 16);
    const float sc0 = live0 ? part0 * p.scale : kNegInf;
    float sc1 = kNegInf;
    if (has1 && base + lane + 32 < len)
      sc1 = row_dot(kt + (lane + 32) * rowp, 0, chunks) * p.scale;
    const float m_new = fmaxf(m, warp_max(fmaxf(sc0, sc1)));
    const float alpha = expf(m - m_new);
    const float e0 = has0 ? expf(sc0 - m_new) : 0.f;
    const float e1 = has1 ? expf(sc1 - m_new) : 0.f;
    float pv[kDpl];
#pragma unroll
    for (int j = 0; j < kDpl; ++j) pv[j] = 0.f;
    if (has0) es[warp * 64 + pos0] = e0;
    if (has1) es[warp * 64 + lane + 32] = e1;
    __syncwarp();
    pv_rows(vt, pv);
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[j] = fmaf(acc[j], alpha, pv[j]);
    l = l * alpha + warp_sum(e0 + e1);
    m = m_new;
  };

  // Double-buffered pages: the next page's copy is in flight while this
  // one is computed, one barrier per page. With one buffer (two do not
  // fit), each page is copied and then computed.
  const bool two = p.stages == 2;
  if (two && n > 0) issue(0, 0);
  for (int i = 0; i < n; ++i) {
    if (!two) {
      __syncthreads();  // every warp is done with the one buffer
      issue(i, 0);
    }
    cp_async_wait_all();
    // page i is in for every thread, and every warp is done with page
    // i - 1, whose buffer the next copy reuses
    __syncthreads();
    if (two && i + 1 < n) issue(i + 1, (i + 1) & 1);
    if (active) step(kv + (two ? i & 1 : 0) * 2 * tile, p0 + i);
  }

  T* orow = static_cast<T*>(p.out) +
            (static_cast<long long>(b) * p.h + head0 + warp) * d;
  if (p.n_split == 1) {
    if (!active) return;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if (own) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) store(orow + dim0 + j, acc[j] * inv);
    }
    return;
  }

  // publish this split's partial (the empty one if it walked no page)
  const long long first = static_cast<long long>(unit) * p.n_split;
  const long long n_parts = static_cast<long long>(gridDim.x) * gb;
  float* ws_acc = p.ws;                 // [part * GB + head][D]
  float* ws_ml = p.ws + n_parts * d;    // [part * GB + head][2]
  if (active) {
    float* a = ws_acc + ((first + split) * gb + warp) * d + dim0;
    if (own) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) a[j] = acc[j];
    }
    if (lane == 0) {
      ws_ml[((first + split) * gb + warp) * 2] = m;
      ws_ml[((first + split) * gb + warp) * 2 + 1] = l;
    }
  }
  // The ticket: the block's writes, ordered by the barrier, are released
  // by thread 0's fence before its atomic; the last block's fence after it
  // acquires the other blocks' (as CUTLASS's GenericBarrier does).
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "atom.relaxed.gpu.global.add.s32 %0, [%1], 1;\n"
        : "=r"(ticket)
        : "l"(p.counters + unit)
        : "memory");
    is_last = ticket == p.n_split - 1;
    if (is_last) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      p.counters[unit] = 0;  // ready for the next launch
    }
  }
  __syncthreads();
  if (!is_last || !active) return;

  // The last block of the unit merges every split in split order. A lane
  // holds the (m, l) of splits lane + 32k, the weights go round by
  // __shfl_sync, and the partial rows are loaded kMerge splits at a time
  // (the first batch beside the (m, l)) before they are added up in split
  // order.
  constexpr int kMerge = 32 / kDpl;
  const int ns = p.n_split;
  const long long ml_step = 2LL * gb;
  const long long row_step = static_cast<long long>(gb) * d;
  const float* ml = ws_ml + (first * gb + warp) * 2;
  const float* rows0 = ws_acc + (first * gb + warp) * d;
  float rows[kMerge][kDpl];
  auto load_rows = [&](int s0) {
#pragma unroll
    for (int u = 0; u < kMerge; ++u) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j)
        rows[u][j] = own && s0 + u < ns
                         ? __ldcg(rows0 + (s0 + u) * row_step + dim0 + j)
                         : 0.f;
    }
  };
  load_rows(0);
  float mv = kNegInf, lv = 0.f;
  if (lane < ns) {
    mv = __ldcg(ml + lane * ml_step);
    lv = __ldcg(ml + lane * ml_step + 1);
  }
  float ms = mv;
  for (int i = lane + 32; i < ns; i += 32)
    ms = fmaxf(ms, __ldcg(ml + i * ml_step));
  ms = warp_max(ms);
  float ls = 0.f;
#pragma unroll
  for (int j = 0; j < kDpl; ++j) acc[j] = 0.f;
  for (int i0 = 0; i0 < ns; i0 += 32) {
    if (i0 > 0) {
      mv = i0 + lane < ns ? __ldcg(ml + (i0 + lane) * ml_step) : kNegInf;
      lv = i0 + lane < ns ? __ldcg(ml + (i0 + lane) * ml_step + 1) : 0.f;
    }
    const float w = i0 + lane < ns ? expf(mv - ms) : 0.f;
    const float lw = lv * w;
    const int cnt = min(32, ns - i0);
    for (int t0 = 0; t0 < cnt; t0 += kMerge) {
      if (i0 + t0 > 0) load_rows(i0 + t0);
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        if (t0 + u < cnt) {
          ls += __shfl_sync(0xffffffffu, lw, t0 + u);
          const float wt = __shfl_sync(0xffffffffu, w, t0 + u);
#pragma unroll
          for (int j = 0; j < kDpl; ++j)
            acc[j] = fmaf(rows[u][j], wt, acc[j]);
        }
      }
    }
  }
  const float inv = 1.f / fmaxf(ls, 1e-30f);
  if (own) {
#pragma unroll
    for (int j = 0; j < kDpl; ++j) store(orow + dim0 + j, acc[j] * inv);
  }
}

template <typename T>
size_t smem_bytes(const Params& p, int stages) {
  const size_t tile = static_cast<size_t>(p.s) * (p.d + 16 / sizeof(T));
  return stages * 2 * tile * sizeof(T) +
         static_cast<size_t>(p.gb) * (p.d + 64) * sizeof(float) +
         static_cast<size_t>(p.split_pages) * sizeof(int);
}

template <typename T, int kDpl>
int launch_dpl(const Params& p, int blocks, int threads, size_t smem,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, kDpl>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_kernel<T, kDpl><<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Two page buffers, or one where two exceed the card's shared memory
// (S = 64, D = 256, f32).
template <typename T>
int launch(Params p, int b, cudaStream_t stream) {
  const int blocks = b * (p.h / p.gb) * p.n_split;
  const int threads = 32 * (p.gb > kMinWarps ? p.gb : kMinWarps);
  p.stages = 2;
  if (smem_bytes<T>(p, 2) > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem_bytes<T>(p, 2) > static_cast<size_t>(optin)) p.stages = 1;
  }
  const size_t smem = smem_bytes<T>(p, p.stages);
  if (p.d <= 64) return launch_dpl<T, 2>(p, blocks, threads, smem, stream);
  if (p.d <= 128) return launch_dpl<T, 4>(p, blocks, threads, smem, stream);
  return launch_dpl<T, 8>(p, blocks, threads, smem, stream);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t; dtype 0 = float, 1 = bf16. A unit is (sequence, KV head,
// block of `gb` query heads): `ws` holds units*n_split*gb*(D+2) floats and
// `counters` `units` zeroed ints (both unused, and may be null, when
// n_split == 1). Shapes are validated by the Python wrappers (1 <= H/KH <=
// 32, gb divides H/KH and is <= 8, D % 16 == 0, D <= 256, S <= 64, 16-byte
// aligned pages, n_split * split_pages >= PP). Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* seq_lens, void* out, void* ws, void* counters, int b, int h,
    int kh, int d, int n_pages, int s, int pp, int n_split, int split_pages,
    int gb, float scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  Params p;
  p.q = q;
  p.k_pages = k;
  p.v_pages = v;
  p.page_table = static_cast<const int*>(page_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.h = h;
  p.kh = kh;
  p.d = d;
  p.n_pages = n_pages;
  p.s = s;
  p.pp = pp;
  p.n_split = n_split;
  p.split_pages = split_pages;
  p.gb = gb;
  p.stages = 1;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, b, st);
  return launch<__nv_bfloat16>(p, b, st);
}
