// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over KV pages that a page table names, with grouped query heads.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (driven by paged_attention; public wrapper kernels/ops.py::paged_attention;
// oracle kernels/ref.py::paged_attention_ref). Same contract:
//   q [B,H,D], k_pages/v_pages [P,S,KH,D] (float or bf16), page_table
//   int32[B,PP], seq_lens int32[B] -> out [B,H,D] in q's type.
//   Query head hq attends with KV head hq / G (G = H/KH, the TPU kernel's
//   q.reshape(KH, G, D)). Scores are (q . k) * D**-0.5 in f32; a position
//   p*S + s >= seq_len scores -1e30 (the reference's NEG_INF, not -inf).
//   An online softmax (running max m, sum l, weighted V acc) in f32 walks
//   every one of the PP pages in order, as the TPU kernel's grid does, so a
//   fully masked page leaves m, l and acc unchanged. The output is
//   acc / max(l, 1e-30).
// Page ids are clamped into [0, P-1] so memory stays safe; the caller's
// contract (serving/paged.py) clamps its -1 sentinel to 0 and relies on the
// length mask, as the reference's caller does.
//
// What bounds it. At the serving shape (Qwen2-0.5B: H=14, KH=2, D=64, S=16,
// B=8, PP=34, f32) one launch must read the live tokens' K and V, about
// B * 2 * KH * D * 4 bytes per token = 8 KB per 8 tokens x ~400 tokens, and
// does 4 flops per byte of it: bytes bound, ~1 us at 3.35 TB/s. This first
// design is simple and correct rather than fast: one block per (sequence,
// KV head) — only B*KH blocks, far fewer than the 132 SMs — one warp per
// query head of the group, each page staged in shared memory between two
// block barriers, and a warp-shuffle reduction over D per score. It is
// bound by latency: PP dependent page steps per block. Splitting the pages
// across blocks (flash-decoding) and skipping the masked tail are the
// redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDPerLane = 8;  // D <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pages,
                                       const T* __restrict__ v_pages,
                                       const int* __restrict__ page_table,
                                       const int* __restrict__ seq_lens,
                                       T* __restrict__ out, int h, int kh,
                                       int d, int n_pages, int s, int pp,
                                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                  // [S, D]
  T* vs = ks + s * d;                                  // [S, D]
  float* scores = reinterpret_cast<float*>(vs + s * d);  // [G, S]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = kvh * g + warp;
  const int len = seq_lens[b];
  float* my_scores = scores + warp * s;

  // lane holds dims lane, lane + 32, ... of its head's q and acc
  float qr[kMaxDPerLane], acc[kMaxDPerLane];
  const T* qrow = q + (static_cast<long long>(b) * h + head) * d;
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) {
    const int dim = lane + 32 * j;
    qr[j] = dim < d ? to_f32(qrow[dim]) : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int elems = s * d;

  for (int p = 0; p < pp; ++p) {
    int slot = page_table[static_cast<long long>(b) * pp + p];
    slot = min(max(slot, 0), n_pages - 1);
    __syncthreads();  // every warp is done with the previous page
    // rows (slot, si, kvh, :) are contiguous D-vectors, KH*D apart
    const long long base = static_cast<long long>(slot) * s * kh + kvh;
    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      const int si = i / d;
      const long long off = (base + static_cast<long long>(si) * kh) * d +
                            (i - si * d);
      ks[i] = k_pages[off];
      vs[i] = v_pages[off];
    }
    __syncthreads();

    for (int si = 0; si < s; ++si) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int dim = lane + 32 * j;
        if (dim < d) part += qr[j] * to_f32(ks[si * d + dim]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      float sc = part * scale;
      if (p * s + si >= len) sc = kNegInf;
      if (lane == 0) my_scores[si] = sc;
    }
    __syncwarp();

    float m_cur = kNegInf;
    for (int si = 0; si < s; ++si) m_cur = fmaxf(m_cur, my_scores[si]);
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float pv[kMaxDPerLane];
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) pv[j] = 0.f;
    for (int si = 0; si < s; ++si) {
      const float pe = expf(my_scores[si] - m_new);
      psum += pe;
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int dim = lane + 32 * j;
        if (dim < d) pv[j] += pe * to_f32(vs[si * d + dim]);
      }
    }
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) acc[j] = acc[j] * alpha + pv[j];
    m = m_new;
    __syncwarp();  // scores are rewritten by the next page
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + (static_cast<long long>(b) * h + head) * d;
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) {
    const int dim = lane + 32 * j;
    if (dim < d) store(orow + dim, acc[j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* sl, void* out, int b, int h, int kh, int d,
           int n_pages, int s, int pp, float scale, cudaStream_t stream) {
  const int g = h / kh;
  const size_t smem = 2 * static_cast<size_t>(s) * d * sizeof(T) +
                      static_cast<size_t>(g) * s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b, kh);
  const dim3 block(32 * g);
  paged_attention_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(sl), static_cast<T*>(out), h, kh, d, n_pages,
      s, pp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t; dtype 0 = float, 1 = bf16. Shapes are validated by the
// Python wrapper (1 <= H/KH <= 32, D % 16 == 0, D <= 256, S <= 64).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* page_table,
                                      const void* seq_lens, void* out, int b,
                                      int h, int kh, int d, int n_pages,
                                      int s, int pp, float scale, int dtype,
                                      void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, page_table, seq_lens, out, b, h, kh, d,
                         n_pages, s, pp, scale, st);
  return launch<__nv_bfloat16>(q, k, v, page_table, seq_lens, out, b, h, kh,
                               d, n_pages, s, pp, scale, st);
}
