// Sorted-segment sums: a sorted, segmented gradient stream -> per-segment sums.
//
// Two entries share one segmented reduction.
//
// Kernel 3, `cffm_sorted_segment_sum`, replaces the Pallas TPU kernel
// `_kernel` of cffm_tpu/ops/sorted_segment.py (launched by
// `sorted_segment_sum_compact`). Contract:
//   sid (n,) int32 ascending; seg (n,) int32, seg[e] = (number of id
//   changes up to e), computed by the caller with a cumsum, so segment s
//   holds the entries with seg == s; grads (n, W) bf16, W % 128 == 0.
//   uids[s] = the id of segment s, -1 in the empty slots [count, m_pad);
//   gsum[s] = the f32 sum of segment s's rows, stored as bf16, and zero
//   rows in the empty slots.
//
// Kernel 6, `cffm_sorted_segment_sum_by_seg`, replaces `_kernel_seg` of
// the same file (launched by `sorted_segment_sum_by_seg`, the dedup of the
// sharded gradient return). Contract: seg (n,) int32 non-decreasing from 0
// in steps of at most 1 (the routing's segment index, read directly);
// grads (n, W) bf16, W % 128 == 0; gsum as above, with no uids.
//
// Design: a segmented reduction with no atomics and no one-hot products.
// The TPU kernel walked the stream once, in order, depositing each block's
// entries with one-hot MXU matmuls. Here the stream is cut into fixed
// chunks of kChunk entries, so a hot segment (the synthetic zipf ids fill
// tens of thousands of entries with one id) spreads over many blocks
// instead of serialising one:
//   pass 1, one block per (chunk, 128-column tile): each thread owns two
//     columns and sums the chunk's entries in order. A segment that both
//     starts and ends in the chunk is complete and is written at once. The
//     chunk's first segment, when it started in an earlier chunk, leaves
//     its part in head[chunk]; the chunk's last segment, when it started in
//     this chunk and may go on, leaves its part in tail[chunk] and its id in
//     tail_seg[chunk].
//   pass 2, one block per (chunk, tile) with a tail: the segment's total is
//     tail[chunk] plus the head parts of the following chunks, in order,
//     until a chunk starts a new segment. Sums are in a fixed order, so the
//     result is the same from run to run.
//   fill: the empty slots get zero rows (and -1 uids for kernel 3), the TPU
//     kernel's sweep. The empty rows are one contiguous block of gsum, so
//     the fill is a flat 16-byte-per-thread store over it.
//
// Bound on the H100: reading n*W bf16 grads and writing m_pad*W bf16 sums
// is memory-bound. Kernel 3 at criteo_kaggle, B = 65536: n = 1,703,936,
// W = 640, 2.18 GB read, 2.2 GB written. Kernel 6 there at T = 1 writes
// m_pad = 3,407,872 slots (4.36 GB), nearly all of them the zero fill the
// contract asks for. Each warp reads 128 contiguous bytes per entry; left
// on the table are wider loads and reading the grads through the sort
// permutation (the caller's gather copy of the grads costs as much again).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;   // entries per pass-1 block
constexpr int kTileCols = 128;
constexpr int kThreads = kTileCols / 2;

struct Args {
  const int* sid;             // (n,), or null for kernel 6
  const int* seg;
  const __nv_bfloat162* g;    // (n, W/2)
  int* uids;                  // (m_pad,), or null for kernel 6
  __nv_bfloat162* gsum;       // (m_pad, W/2)
  float2* head;               // (chunks, W/2)
  float2* tail;               // (chunks, W/2)
  int* tail_seg;              // (chunks,)
  long long n, m_pad;
  int w2, chunks;
};

__device__ __forceinline__ bool starts(const Args& a, long long e) {
  return e == 0 || a.seg[e] != a.seg[e - 1];
}

__device__ __forceinline__ void store(const Args& a, long long s, int col, float2 v) {
  if (s < a.m_pad) a.gsum[s * a.w2 + col] = __floats2bfloat162_rn(v.x, v.y);
}

__global__ void __launch_bounds__(kThreads) pass1_kernel(Args a) {
  __shared__ int seg_s[kChunk];
  const int chunk = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const long long e0 = static_cast<long long>(chunk) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), a.n - e0));
  for (int u = threadIdx.x; u < len; u += kThreads) seg_s[u] = a.seg[e0 + u];
  __syncthreads();

  const bool first_starts = starts(a, e0);
  int cur = seg_s[0];
  bool cur_here = first_starts;
  float2 acc = make_float2(0.f, 0.f);
  const __nv_bfloat162* row = a.g + e0 * a.w2 + col;
  for (int u = 0; u < len; ++u) {
    const int s = seg_s[u];
    if (s != cur) {
      if (cur_here) {
        store(a, cur, col, acc);
      } else {
        a.head[static_cast<long long>(chunk) * a.w2 + col] = acc;
      }
      cur = s;
      cur_here = true;
      acc = make_float2(0.f, 0.f);
    }
    const float2 v = __bfloat1622float2(row[static_cast<long long>(u) * a.w2]);
    acc.x += v.x;
    acc.y += v.y;
  }
  const long long o = static_cast<long long>(chunk) * a.w2 + col;
  if (cur_here) {
    a.tail[o] = acc;
  } else {
    a.head[o] = acc;
  }
  if (blockIdx.y == 0) {
    if (threadIdx.x == 0) a.tail_seg[chunk] = cur_here ? cur : -1;
    // every segment start in the chunk names its slot's id
    for (int u = threadIdx.x; a.uids != nullptr && u < len; u += kThreads) {
      const long long e = e0 + u;
      const int s = seg_s[u];
      if ((u == 0 ? first_starts : s != seg_s[u - 1]) && s < a.m_pad) a.uids[s] = a.sid[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads) pass2_kernel(Args a) {
  const int chunk = blockIdx.x;
  const int s = a.tail_seg[chunk];
  if (s < 0) return;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  float2 acc = a.tail[static_cast<long long>(chunk) * a.w2 + col];
  for (int c = chunk + 1; c < a.chunks; ++c) {
    if (starts(a, static_cast<long long>(c) * kChunk)) break;
    const float2 h = a.head[static_cast<long long>(c) * a.w2 + col];
    acc.x += h.x;
    acc.y += h.y;
    if (a.tail_seg[c] >= 0) break;  // the segment ended inside chunk c
  }
  store(a, s, col, acc);
}

__global__ void fill_kernel(Args a) {
  const long long count = a.n > 0 ? static_cast<long long>(a.seg[a.n - 1]) + 1 : 0;
  if (count >= a.m_pad) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a.uids != nullptr)
    for (long long s = count + first; s < a.m_pad; s += stride) a.uids[s] = -1;
  // rows [count, m_pad) of gsum: W/8 16-byte words each (W % 128 == 0)
  uint4* z = reinterpret_cast<uint4*>(a.gsum + count * a.w2);
  const long long words = (a.m_pad - count) * (a.w2 / 4);
  for (long long i = first; i < words; i += stride) z[i] = make_uint4(0u, 0u, 0u, 0u);
}

int launch(const Args& a, cudaStream_t s) {
  if (a.chunks > 0) {
    const dim3 grid(a.chunks, a.w2 * 2 / kTileCols);
    pass1_kernel<<<grid, kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pass2_kernel<<<grid, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.m_pad > 0) fill_kernel<<<1056, 256, 0, s>>>(a);  // 8 blocks per SM
  return cudaGetLastError();
}

Args make_args(const int* sid, const int* seg, const void* grads, long long n, int w,
               int* uids, void* gsum, long long m_pad, float* head, float* tail,
               int* tail_seg) {
  Args a;
  a.sid = sid;
  a.seg = seg;
  a.g = static_cast<const __nv_bfloat162*>(grads);
  a.uids = uids;
  a.gsum = static_cast<__nv_bfloat162*>(gsum);
  a.head = reinterpret_cast<float2*>(head);
  a.tail = reinterpret_cast<float2*>(tail);
  a.tail_seg = tail_seg;
  a.n = n;
  a.m_pad = m_pad;
  a.w2 = w / 2;
  a.chunks = static_cast<int>((n + kChunk - 1) / kChunk);
  return a;
}

}  // namespace

extern "C" {

// Pass-1 chunk length: the caller sizes head/tail (chunks, W) f32 and
// tail_seg (chunks,) int32 scratch with chunks = ceil(n / chunk).
int cffm_sorted_segment_chunk() { return kChunk; }

// Kernel 3. Returns a cudaError_t; 0 means the three kernels were launched.
int cffm_sorted_segment_sum(const int* sid, const int* seg, const void* grads,
                            long long n, int w, int* uids, void* gsum, long long m_pad,
                            float* head, float* tail, int* tail_seg, void* stream) {
  if (w % kTileCols != 0 || n < 0 || m_pad < 0 || sid == nullptr || uids == nullptr)
    return cudaErrorInvalidValue;
  return launch(make_args(sid, seg, grads, n, w, uids, gsum, m_pad, head, tail, tail_seg),
                static_cast<cudaStream_t>(stream));
}

// Kernel 6: the same reduction from seg alone, with no uids. Returns a
// cudaError_t; 0 means the kernels were launched.
int cffm_sorted_segment_sum_by_seg(const int* seg, const void* grads, long long n, int w,
                                   void* gsum, long long m_pad, float* head, float* tail,
                                   int* tail_seg, void* stream) {
  if (w % kTileCols != 0 || n < 0 || m_pad < 0) return cudaErrorInvalidValue;
  return launch(make_args(nullptr, seg, grads, n, w, nullptr, gsum, m_pad, head, tail,
                          tail_seg),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
