// Per-row sparse optimizer apply on the touched rows of an embedding table.
//
// Two entries share the per-row update.
//
// Kernels 4-5, `cffm_streamed_apply`, replace the Pallas TPU kernel
// `_kernel` of cffm_tpu/ops/streamed_update.py with nb = 1 (launched by
// `streamed_rowwise_apply` and `streamed_rowwise_adam_apply`), in its three
// modes: sgd, adagrad and rowwise_adam. Contract:
//   uids (M,) int32: the unique ascending valid prefix, then the sentinel V;
//   gsum (M, W) bf16: the duplicate-summed gradient S of each slot.
//
// Kernel 7, `cffm_bucketed_apply`, replaces the same `_kernel` with nb > 1
// and its in-kernel clip (launched by `bucketed_rowwise_apply` and
// `bucketed_rowwise_adam_apply`), the update of the sharded step. Contract:
//   ids (NB, C) int32: each bucket ascending and unique, the out-of-range
//   sentinel (>= V) in its empty tail; g (NB, C, W) bf16, garbage (NaN
//   included) in sentinel slots, which are never read. A row present in
//   several buckets takes S = the f32 sum of its partials in bucket order;
//   clip > 0 scales S by min(1, clip / max(|S|, 1e-12)) (rowwise.clip_rows).
//
// The update, per touched row with its S:
//   sgd:          delta = -lr * S
//   adagrad:      acc += mean(S^2) over the W lanes;
//                 delta = -lr * S / (sqrt(acc) + eps)
//   rowwise_adam: m = b1*m + (1-b1)*S; v = b2*v + (1-b2)*mean(S^2);
//                 delta = -lr * (m*c1) / (sqrt(v*c2) + eps), with
//                 c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) from the incremented t;
//   an f32 table takes table + delta in f32; a bf16 table takes the f32 sum
//   rounded to nearest, or stochastically with a 16-bit dither from a
//   Philox4x32-10 stream keyed by the caller's seed and counted by
//   (column pair, row), so each element's dither is fixed by (seed, row,
//   column) alone.
//   Rows outside the ids are never read or written: they keep table and
//   state bit for bit.
//
// Design. The TPU streamed the whole table through VMEM because its
// scatter is slow per index; here one warp owns one slot and reads and
// writes only that row, in place. The warp sums S^2 with shuffles, then
// updates its row with two lanes' worth of columns per thread. The
// hyperparameters are read from device memory, so a learning-rate
// schedule or Adam's step costs no host synchronisation.
// Kernel 7 gives each row one owner with no atomics: the warp of slot
// (o, j) binary-searches its id in buckets 0..o-1 (each ascending), one
// bucket per lane, and leaves if any holds it. The owner finds the id's
// slot in each later bucket the same way, keeps those slots in shared
// memory, and sums the partials in bucket order as it goes over the
// columns (once for |S|^2, once more for the clipped mean(S^2) when clip is
// on and the mode needs it, once for the update). The result does not
// depend on the order the warps run in.
//
// Bound on the H100: per touched row, read the bf16 gradient(s) and the row
// (plus m for rowwise_adam) and write the row (and m) back: about 6.4 KB
// per row for an f32 table at W=640, 0.87 GB for the ~136k distinct
// big-field rows of a criteo_kaggle step at B=65536 -- memory-bound at
// about 0.26 ms. Kernel 7 also reads the NB*C ids and, for the ids of
// later buckets, about log2(C) of them per search.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

struct Args {
  void* table;            // (V, W) f32 or bf16
  float* accum;           // (V,) adagrad accumulator, or null
  float* m;               // (V, W) rowwise_adam first moment, or null
  float* v;               // (V,) rowwise_adam second moment, or null
  const int* ids;         // uids (M,), or the buckets' ids (NB, C)
  const __nv_bfloat162* g;  // (M, W/2), or (NB, C, W/2)
  const float* hyper;     // lr, eps[, b1, b2, c1, c2]
  long long rows, slots;  // V; M, or C for the buckets
  int nb, w2, mode, stochastic;
  float clip;             // kernel 7: per-row L2 clip of S, 0 = off
  uint32_t key0, key1;
};

enum Mode { kSgd = 0, kAdagrad = 1, kRowwiseAdam = 2 };

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ __nv_bfloat16 round_sr(float x, uint32_t dither) {
  uint32_t bits = __float_as_uint(x);
  if (isfinite(x)) bits += dither & 0xFFFFu;
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  return x;
}

// sum over the W lanes of (scale * S)^2, S(c) giving column pair c
template <typename Total>
__device__ __forceinline__ float sum_sq(const Args& a, int lane, float scale, Total total) {
  float ss = 0.f;
  for (int c = lane; c < a.w2; c += 32) {
    float2 s = total(c);
    s.x *= scale;
    s.y *= scale;
    ss = fmaf(s.x, s.x, fmaf(s.y, s.y, ss));
  }
  return warp_sum(ss);
}

// The optimizer step of row uid from S(c) * scale; mean is mean(S^2) of the
// scaled S (unused by sgd). Lane 0 writes the row's scalar state.
template <typename T, typename Total>
__device__ __forceinline__ void update_row(const Args& a, int uid, int lane, float mean,
                                           float scale, Total total) {
  const float lr = a.hyper[0], eps = a.hyper[1];
  float denom = 1.f, b1 = 0.f, c1 = 0.f;
  if (a.mode == kAdagrad) {
    const float acc = a.accum[uid] + mean;
    if (lane == 0) a.accum[uid] = acc;
    denom = sqrtf(acc) + eps;
  } else if (a.mode == kRowwiseAdam) {
    b1 = a.hyper[2];
    const float b2 = a.hyper[3];
    c1 = a.hyper[4];
    const float c2 = a.hyper[5];
    const float vn = b2 * a.v[uid] + (1.f - b2) * mean;
    if (lane == 0) a.v[uid] = vn;
    denom = sqrtf(vn * c2) + eps;
  }

  const long long row = static_cast<long long>(uid) * a.w2;
  for (int c = lane; c < a.w2; c += 32) {
    float2 s = total(c);
    s.x *= scale;
    s.y *= scale;
    float dx, dy;
    if (a.mode == kRowwiseAdam) {
      float2* mp = reinterpret_cast<float2*>(a.m) + row + c;
      float2 mv = *mp;
      mv.x = b1 * mv.x + (1.f - b1) * s.x;
      mv.y = b1 * mv.y + (1.f - b1) * s.y;
      *mp = mv;
      dx = (-lr) * (mv.x * c1) / denom;
      dy = (-lr) * (mv.y * c1) / denom;
    } else if (a.mode == kAdagrad) {
      dx = (-lr) * s.x / denom;
      dy = (-lr) * s.y / denom;
    } else {
      dx = (-lr) * s.x;
      dy = (-lr) * s.y;
    }
    if constexpr (sizeof(T) == 4) {
      float2* tp = reinterpret_cast<float2*>(a.table) + row + c;
      float2 tv = *tp;
      tv.x += dx;
      tv.y += dy;
      *tp = tv;
    } else {
      __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(a.table) + row + c;
      const float2 tv = __bfloat1622float2(*tp);
      const float nx = tv.x + dx, ny = tv.y + dy;
      if (a.stochastic) {
        const uint4 r = philox(make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(uid),
                                          0u, 0u),
                               a.key0, a.key1);
        *tp = __halves2bfloat162(round_sr(nx, r.x), round_sr(ny, r.y));
      } else {
        *tp = __floats2bfloat162_rn(nx, ny);
      }
    }
  }
}

// Kernels 4-5: one warp per slot of the flat deduplicated stream.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) apply_kernel(Args a) {
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= a.slots) return;
  const int uid = a.ids[slot];
  if (uid < 0 || uid >= a.rows) return;
  const __nv_bfloat162* g = a.g + slot * a.w2;
  auto total = [g](int c) { return __bfloat1622float2(g[c]); };
  const float mean = a.mode == kSgd ? 0.f : sum_sq(a, lane, 1.f, total) / (2 * a.w2);
  update_row<T>(a, uid, lane, mean, 1.f, total);
}

// Index of id in bucket b (ascending, sentinel tail), or -1.
__device__ __forceinline__ int find(const Args& a, int b, int id) {
  const int* p = a.ids + static_cast<long long>(b) * a.slots;
  long long lo = 0, hi = a.slots;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (p[mid] < id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < a.slots && p[lo] == id) ? static_cast<int>(lo) : -1;
}

// Kernel 7: one warp per bucket slot (o, j); the row's first bucket owns it.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) bucketed_kernel(Args a) {
  extern __shared__ int pos_s[];  // (kWarps, nb): the row's slot in each bucket
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (slot >= a.nb * a.slots) return;
  const int o = static_cast<int>(slot / a.slots);
  const int uid = a.ids[slot];
  if (uid < 0 || uid >= a.rows) return;
  bool earlier = false;
  for (int b = lane; b < o; b += 32) earlier |= find(a, b, uid) >= 0;
  if (__any_sync(0xFFFFFFFFu, earlier)) return;
  int* pos = pos_s + warp * a.nb;
  for (int b = o + 1 + lane; b < a.nb; b += 32) pos[b] = find(a, b, uid);
  __syncwarp();

  const __nv_bfloat162* g0 = a.g + slot * a.w2;
  auto total = [&](int c) {
    float2 s = __bfloat1622float2(g0[c]);
    for (int b = o + 1; b < a.nb; ++b) {
      const int p = pos[b];
      if (p >= 0) {
        const float2 x =
            __bfloat1622float2(a.g[(static_cast<long long>(b) * a.slots + p) * a.w2 + c]);
        s.x += x.x;
        s.y += x.y;
      }
    }
    return s;
  };
  float scale = 1.f, mean = 0.f;
  if (a.clip > 0.f || a.mode != kSgd) {
    float ss = sum_sq(a, lane, 1.f, total);
    if (a.clip > 0.f) {
      scale = fminf(1.f, a.clip / fmaxf(sqrtf(ss), 1e-12f));
      if (a.mode != kSgd) ss = sum_sq(a, lane, scale, total);
    }
    mean = ss / (2 * a.w2);
  }
  update_row<T>(a, uid, lane, mean, scale, total);
}

int check_state(int mode, float* accum, float* m, float* v) {
  if (mode < kSgd || mode > kRowwiseAdam) return cudaErrorInvalidValue;
  if ((mode == kAdagrad && accum == nullptr) ||
      (mode == kRowwiseAdam && (m == nullptr || v == nullptr)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Args make_args(void* table, float* accum, float* m, float* v, const int* ids, const void* g,
               const float* hyper, long long rows, long long slots, int nb, int w, int mode,
               int stochastic, float clip, unsigned long long seed) {
  Args a;
  a.table = table;
  a.accum = accum;
  a.m = m;
  a.v = v;
  a.ids = ids;
  a.g = static_cast<const __nv_bfloat162*>(g);
  a.hyper = hyper;
  a.rows = rows;
  a.slots = slots;
  a.nb = nb;
  a.w2 = w / 2;
  a.mode = mode;
  a.stochastic = stochastic;
  a.clip = clip;
  a.key0 = static_cast<uint32_t>(seed);
  a.key1 = static_cast<uint32_t>(seed >> 32);
  return a;
}

}  // namespace

extern "C" {

// Kernels 4-5. mode: 0 sgd, 1 adagrad, 2 rowwise_adam. Returns a
// cudaError_t; 0 means the kernel was launched. Updates table and state in
// place.
int cffm_streamed_apply(int is_bf16, void* table, float* accum, float* m, float* v,
                        const int* uids, const void* gsum, const float* hyper,
                        long long rows, long long slots, int w, int mode,
                        int stochastic, unsigned long long seed, void* stream) {
  if (w % 64 != 0) return cudaErrorInvalidValue;
  if (const int err = check_state(mode, accum, m, v)) return err;
  const Args a = make_args(table, accum, m, v, uids, gsum, hyper, rows, slots, 1, w, mode,
                           stochastic, 0.f, seed);
  if (slots == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((slots + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    apply_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(a);
  } else {
    apply_kernel<float><<<blocks, kWarps * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// Kernel 7: ids (nb, c), g (nb, c, w) bf16; clip > 0 clips each row's
// summed gradient. Same modes, return value and in-place update.
int cffm_bucketed_apply(int is_bf16, void* table, float* accum, float* m, float* v,
                        const int* ids, const void* g, const float* hyper, long long rows,
                        int nb, long long c, int w, int mode, float clip, int stochastic,
                        unsigned long long seed, void* stream) {
  if (w % 64 != 0 || nb < 1 || c < 0) return cudaErrorInvalidValue;
  if (const int err = check_state(mode, accum, m, v)) return err;
  const Args a = make_args(table, accum, m, v, ids, g, hyper, rows, c, nb, w, mode,
                           stochastic, clip, seed);
  const long long slots = nb * c;
  if (slots == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((slots + kWarps - 1) / kWarps);
  const size_t smem = sizeof(int) * kWarps * static_cast<size_t>(nb);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (is_bf16) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(bucketed_kernel<__nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess) bucketed_kernel<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(a);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(bucketed_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess) bucketed_kernel<float><<<blocks, kWarps * 32, smem, s>>>(a);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
