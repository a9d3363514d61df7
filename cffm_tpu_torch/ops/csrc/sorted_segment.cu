// Sorted-segment sums: a sorted, segmented gradient stream -> per-segment sums.
//
// Three entries share one segmented reduction.
//
// Kernel 3, `cffm_sorted_segment_sum`, replaces the Pallas TPU kernel
// `_kernel` of cffm_tpu/ops/sorted_segment.py (launched by
// `sorted_segment_sum_compact`). Contract:
//   sid (n,) int32 ascending; seg (n,) int32, seg[e] = (number of id
//   changes up to e), computed by the caller with a cumsum, so segment s
//   holds the entries with seg == s; grads (n, W) bf16, W % 128 == 0.
//   uids[s] = the id of segment s, -1 in the empty slots [count, m_pad);
//   gsum[s] = the f32 sum of segment s's rows, rounded once to bf16, and
//   zero rows in the empty slots. Segments at or past m_pad are dropped.
//
// Kernel 6, `cffm_sorted_segment_sum_by_seg`, replaces `_kernel_seg` of
// the same file (launched by `sorted_segment_sum_by_seg`, the dedup of the
// sharded gradient return). Contract: seg (n,) int32 non-decreasing from 0
// in steps of at most 1 (the routing's segment index, read directly);
// grads (n, W) bf16, W % 128 == 0; gsum as above, with no uids.
//
// The scatter route's sums, `cffm_scatter_segment_sum` (launched by
// `scatter_segment_sum`, for `optim/rowwise.rowwise_update` when the touched
// rows are under the 8% gate), have no TPU kernel: the JAX package leaves
// them to XLA's scatter-add. Contract: order (N,) int64, the sort's
// permutation of the unsorted bf16 grads (N, W), W % 128 == 0; seg (N,)
// int32 as for kernel 3, over the sorted entries; the live segments are the
// run [lo, lo + n). out[s - lo] = the f32 sum of live segment s's rows, not
// rounded; the other segments (sentinel ids, negative ids) are dropped.
//
// Bound on the H100: memory. The reduction reads n * W bf16 grads once and
// writes m_pad * W bf16 sums; it does one add per element read. Kernel 6
// at criteo_kaggle, B = 65536, T = 1: n = 1,703,936, W = 640, 2.18 GB read
// and 4.36 GB written (3,407,872 slots, nearly all of them the zero rows
// the contract asks for), 1.96 ms at 3.35 TB/s. Kernel 3 there writes
// about half as many slots. The TPU kernel walked the stream once, in
// order, depositing each block's entries with one-hot MXU matmuls and a
// carry from one grid step to the next; here blocks run in no order, and
// a segment may be one entry or (the sentinel slots of the hier step's
// second stage) 1.57M entries. Nothing here may wait on a segment's length.
//
// Design: a tree of chunked passes, with no atomics, in a fixed order.
//   Level 0: the stream is cut into chunks of kChunk0 entries; one thread
//     per (chunk, 8 columns) walks its chunk in order with 16-byte loads
//     (kU rows in flight, neighbouring threads on neighbouring columns),
//     summing in f32. A segment that starts and ends in the chunk is
//     complete and its sum is stored at once. The chunk's first segment,
//     when it began in an earlier chunk, leaves its part in head[chunk];
//     its last segment, when it began in this chunk, leaves its part in
//     tail[chunk] (each 0 when there is no such part).
//   Level l + 1: the same pass over the chunks of level l, entry j being
//     tail[j] + head[j + 1] with the label of chunk j's last entry, in
//     chunks of kChunkN. A segment's entries there are its tail and the
//     heads of the chunks it runs through, so it is summed by a tree of
//     these passes: the depth is log(n) / log(kChunkN), whatever the
//     segment lengths (n = 1.7M: four passes, 13,312, 416 and 13 entries
//     above the first). The level with one chunk stores every segment it
//     holds.
//   Fill: the empty slots get zero rows (and -1 uids for kernel 3, which
//     also writes each segment's id at its first entry here), a flat
//     16-byte store over the contiguous rows [count, m_pad).
// Each segment is stored once, from the pass that holds all of it; the
// sums are taken in a fixed order, so the result is the same from run to
// run. Segments that fit a chunk are summed in stream order.
// The scatter entry runs the same tree with two changes: level 0 reads
// entry e's row through order[e] (no sorted copy of the grads is made),
// and a complete segment's f32 sum goes to row s - lo of its output, which
// holds the live segments only, so there is no fill. At criteo_full,
// B = 32768 (851,968 entries, ~52.5k live rows) it reads 1.09 GB of grads
// and 10 MB of order and seg, and writes 134 MB: 0.37 ms at 3.35 TB/s.
// kChunk0 and kU were chosen on the card at the T = 1 and stage-2 shapes.
// What keeps it above the bound is level 0's reads, not the fill's stores
// (`python -m cffm_tpu_torch.scripts.ablate_bwd --kernel=6`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk0 = 128;  // entries per chunk at level 0
constexpr int kChunkN = 32;   // entries per chunk at the levels above
constexpr int kThreads = 256;
constexpr int kU = 8;         // entries a thread loads before it sums them

// One pass of the tree.
struct Level {
  const int* seg;
  long long n;                // seg's length
  long long stride;           // entry i's label is seg[min((i + 1) * stride, n) - 1]
  long long count;            // entries at this level
  long long chunks;
  int len;                    // entries per chunk
  int w8;                     // W / 8: 16-byte column groups per row
  float4* head;               // (chunks, W) f32, when chunks > 1
  float4* tail;
};

__device__ __forceinline__ int label(const Level& a, long long i) {
  return __ldg(a.seg + (min((i + 1) * a.stride, a.n) - 1));
}

// Level 0: the bf16 gradient rows, read once.
struct Rows {
  const uint4* g;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(const Level& a, long long i, int c) const {
    return __ldg(g + i * a.w8 + c);
  }
  __device__ __forceinline__ static void add(float (&acc)[8], const Raw& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] += f.x;
      acc[2 * k + 1] += f.y;
    }
  }
};

// Level 0 of the scatter entry: entry i is the bf16 row order[i] of the
// unsorted grads.
struct Gathered {
  const uint4* g;
  const long long* order;
  using Raw = uint4;
  __device__ __forceinline__ Raw load(const Level& a, long long i, int c) const {
    return __ldg(g + __ldg(order + i) * a.w8 + c);
  }
  __device__ __forceinline__ static void add(float (&acc)[8], const Raw& v) { Rows::add(acc, v); }
};

// The levels above: entry i is tail[i] + head[i + 1] of the level below.
struct Partials {
  const float4* tail;
  const float4* head;
  struct Raw {
    float4 t[2], h[2];
  };
  __device__ __forceinline__ Raw load(const Level& a, long long i, int c) const {
    Raw r;
    const long long o = i * 2 * a.w8 + 2 * c;
    r.t[0] = tail[o];
    r.t[1] = tail[o + 1];
    if (i + 1 < a.count) {
      r.h[0] = head[o + 2 * a.w8];
      r.h[1] = head[o + 2 * a.w8 + 1];
    } else {
      r.h[0] = r.h[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return r;
  }
  __device__ __forceinline__ static void add(float (&acc)[8], const Raw& r) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      acc[4 * k] += r.t[k].x + r.h[k].x;
      acc[4 * k + 1] += r.t[k].y + r.h[k].y;
      acc[4 * k + 2] += r.t[k].z + r.h[k].z;
      acc[4 * k + 3] += r.t[k].w + r.h[k].w;
    }
  }
};

// Where a complete segment's sum goes. Kernels 3 and 6: slot s of gsum,
// rounded once to bf16; segments at or past m_pad are dropped.
struct Slots {
  uint4* gsum;                // (m_pad, W) bf16
  long long m_pad;
  __device__ __forceinline__ void store(const Level& a, int s, int c, const float (&v)[8]) const {
    if (s < m_pad) {
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      gsum[static_cast<long long>(s) * a.w8 + c] = o;
    }
  }
};

// The scatter entry: row s - lo of out, in f32; segments outside the live
// run [lo, lo + n) are dropped.
struct LiveRows {
  float4* out;                // (n, W) f32
  long long lo, n;
  __device__ __forceinline__ void store(const Level& a, int s, int c, const float (&v)[8]) const {
    const long long r = s - lo;
    if (r >= 0 && r < n) {
      float4* q = out + r * 2 * a.w8 + 2 * c;
      q[0] = make_float4(v[0], v[1], v[2], v[3]);
      q[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

// A chunk's partial (head or tail) in f32.
__device__ __forceinline__ void store_part(const Level& a, float4* p, long long chunk, int c,
                                           const float (&v)[8]) {
  float4* q = p + chunk * 2 * a.w8 + 2 * c;
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <class Src, class Out>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const Src src, const Out out,
                                                          const Level a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.chunks * a.w8) return;
  const long long chunk = t / a.w8;
  const int c = static_cast<int>(t - chunk * a.w8);
  const long long e0 = chunk * a.len;
  const long long e1 = min(e0 + a.len, a.count);
  const bool top = a.chunks == 1;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int cur = label(a, e0);
  // `here`: the current segment began in this chunk
  bool here = e0 == 0 || label(a, e0 - 1) != cur;
  if (here && !top) store_part(a, a.head, chunk, c, acc);
  for (long long e = e0; e < e1; e += kU) {
    typename Src::Raw v[kU];
    int s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      s[u] = cur;
      if (e + u < e1) {
        v[u] = src.load(a, e + u, c);
        s[u] = label(a, e + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (e + u < e1) {
        if (s[u] != cur) {
          if (here) {
            out.store(a, cur, c, acc);
          } else {
            store_part(a, a.head, chunk, c, acc);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = 0.f;
          cur = s[u];
          here = true;
        }
        Src::add(acc, v[u]);
      }
    }
  }
  if (top) {
    out.store(a, cur, c, acc);
  } else if (here) {
    store_part(a, a.tail, chunk, c, acc);
  } else {
    store_part(a, a.head, chunk, c, acc);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    store_part(a, a.tail, chunk, c, acc);
  }
}

struct Fill {
  const int* sid;             // (n,), or null for kernel 6
  const int* seg;
  int* uids;                  // (m_pad,), or null for kernel 6
  uint4* gsum;
  long long n, m_pad;
  int w8;
};

__global__ void fill_kernel(const Fill f) {
  const long long count = f.n > 0 ? static_cast<long long>(f.seg[f.n - 1]) + 1 : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f.uids != nullptr) {
    // each segment's id, from its first entry
    for (long long e = first; e < f.n; e += stride) {
      const int s = f.seg[e];
      if ((e == 0 || f.seg[e - 1] != s) && s < f.m_pad) f.uids[s] = f.sid[e];
    }
    for (long long s = count + first; s < f.m_pad; s += stride) f.uids[s] = -1;
  }
  if (count >= f.m_pad) return;
  // rows [count, m_pad) of gsum: W/8 16-byte words each
  uint4* z = f.gsum + count * f.w8;
  const long long words = (f.m_pad - count) * f.w8;
  for (long long i = first; i < words; i += stride) z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Rows of (W,) f32 scratch the tree needs for n entries: a head and a tail
// row per chunk of every level with more than one chunk
// (`sorted_segment.scratch_rows` in the wrapper; a launch with less is
// refused).
long long scratch_rows(long long n) {
  long long rows = 0;
  for (long long count = n, len = kChunk0; count > 0;) {
    const long long chunks = (count + len - 1) / len;
    if (chunks == 1) break;
    rows += 2 * chunks;
    count = chunks;
    len = kChunkN;
  }
  return rows;
}

// The tree's passes over n entries, level 0 read from src0, each complete
// segment's sum handed to out.
template <class Src0, class Out>
int launch_tree(const Src0 src0, const Out out, const int* seg, long long n, int w,
                float* scratch, long long rows, cudaStream_t st) {
  if (w % 128 != 0 || n < 0 || rows < scratch_rows(n)) return cudaErrorInvalidValue;
  Level lv;
  lv.seg = seg;
  lv.n = n;
  lv.stride = 1;
  lv.count = n;
  lv.len = kChunk0;
  lv.w8 = w / 8;
  float4* next = reinterpret_cast<float4*>(scratch);  // the next level's head rows
  Partials below{nullptr, nullptr};  // the level below's partials, from level 1 on
  for (int level = 0; lv.count > 0; ++level) {
    lv.chunks = (lv.count + lv.len - 1) / lv.len;
    lv.head = lv.tail = nullptr;
    if (lv.chunks > 1) {
      lv.head = next;
      lv.tail = next + lv.chunks * 2 * lv.w8;
      next += 2 * lv.chunks * 2 * lv.w8;
    }
    const long long blocks = (lv.chunks * lv.w8 + kThreads - 1) / kThreads;
    if (level == 0) {
      reduce_kernel<Src0, Out><<<blocks, kThreads, 0, st>>>(src0, out, lv);
    } else {
      reduce_kernel<Partials, Out><<<blocks, kThreads, 0, st>>>(below, out, lv);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (lv.chunks == 1) break;
    below = Partials{lv.tail, lv.head};
    lv.stride *= lv.len;
    lv.count = lv.chunks;
    lv.len = kChunkN;
  }
  return cudaSuccess;
}

// Kernels 3 and 6: the tree into the bf16 slots, then the fill.
int launch(const int* sid, const int* seg, const void* grads, long long n, int w, int* uids,
           void* gsum, long long m_pad, float* scratch, long long rows, cudaStream_t st) {
  if (m_pad < 0) return cudaErrorInvalidValue;
  const int err = launch_tree(Rows{static_cast<const uint4*>(grads)},
                              Slots{static_cast<uint4*>(gsum), m_pad}, seg, n, w, scratch,
                              rows, st);
  if (err != cudaSuccess) return err;
  if (m_pad > 0) {
    const Fill f{sid, seg, uids, static_cast<uint4*>(gsum), n, m_pad, w / 8};
    fill_kernel<<<1056, 256, 0, st>>>(f);  // 8 blocks per SM
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunk length at level 0 (level 0) and at the levels above (level 1).
int cffm_sorted_segment_chunk(int level) { return level == 0 ? kChunk0 : kChunkN; }

// Kernel 3. Returns a cudaError_t; 0 means the kernels were launched.
int cffm_sorted_segment_sum(const int* sid, const int* seg, const void* grads, long long n,
                            int w, int* uids, void* gsum, long long m_pad, float* scratch,
                            long long rows, void* stream) {
  // an empty tensor's pointer may be null
  if ((n > 0 && sid == nullptr) || (m_pad > 0 && uids == nullptr)) return cudaErrorInvalidValue;
  return launch(sid, seg, grads, n, w, uids, gsum, m_pad, scratch, rows,
                static_cast<cudaStream_t>(stream));
}

// Kernel 6: the same reduction from seg alone, with no uids. Returns a
// cudaError_t; 0 means the kernels were launched.
int cffm_sorted_segment_sum_by_seg(const int* seg, const void* grads, long long n, int w,
                                   void* gsum, long long m_pad, float* scratch,
                                   long long rows, void* stream) {
  return launch(nullptr, seg, grads, n, w, nullptr, gsum, m_pad, scratch, rows,
                static_cast<cudaStream_t>(stream));
}

// The scatter route's sums: the tree over the grads read through order,
// the live segments [lo, lo + n_live) stored in f32 at rows 0 .. n_live - 1
// of out. Returns a cudaError_t; 0 means the kernels were launched.
int cffm_scatter_segment_sum(const long long* order, const int* seg, const void* grads,
                             long long n, int w, long long lo, long long n_live, float* out,
                             float* scratch, long long rows, void* stream) {
  if (lo < 0 || n_live < 0 || (n > 0 && order == nullptr)) return cudaErrorInvalidValue;
  return launch_tree(Gathered{static_cast<const uint4*>(grads), order},
                     LiveRows{reinterpret_cast<float4*>(out), lo, n_live}, seg, n, w, scratch,
                     rows, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
