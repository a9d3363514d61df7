// Per-row sparse optimizer apply on the touched rows of an embedding table.
//
// Replaces the Pallas TPU kernel `_kernel` of cffm_tpu/ops/streamed_update.py
// (launched by `streamed_rowwise_apply` and `streamed_rowwise_adam_apply`),
// in its three modes: sgd, adagrad and rowwise_adam. Contract:
//   uids (M,) int32: the unique ascending valid prefix, then the sentinel V;
//   gsum (M, W) bf16: the duplicate-summed gradient of each slot;
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
//   Rows outside uids are never read or written: they keep table and state
//   bit for bit.
//
// Design. The TPU streamed the whole table through VMEM because its
// scatter is slow per index; here one warp owns one slot and reads and
// writes only that row, in place. The warp sums S^2 with shuffles, then
// updates its row with two lanes' worth of columns per thread. The
// hyperparameters are read from device memory, so a learning-rate
// schedule or Adam's step costs no host synchronisation.
//
// Bound on the H100: per touched row, read the bf16 gradient and the row
// (plus m for rowwise_adam) and write the row (and m) back: about 6.4 KB
// per row for an f32 table at W=640, 9.0 GB for the ~1.4M unique rows of a
// criteo_kaggle step at B=65536 -- memory-bound at about 2.7 ms.

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
  const int* uids;        // (M,)
  const __nv_bfloat162* gsum;  // (M, W/2)
  const float* hyper;     // lr, eps[, b1, b2, c1, c2]
  long long rows, slots;
  int w2, mode, stochastic;
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) apply_kernel(Args a) {
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= a.slots) return;
  const int uid = a.uids[slot];
  if (uid < 0 || uid >= a.rows) return;
  const __nv_bfloat162* g = a.gsum + slot * a.w2;
  const float lr = a.hyper[0], eps = a.hyper[1];

  float mean = 0.f;
  if (a.mode != kSgd) {
    float ss = 0.f;
    for (int c = lane; c < a.w2; c += 32) {
      const float2 s = __bfloat1622float2(g[c]);
      ss = fmaf(s.x, s.x, fmaf(s.y, s.y, ss));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xFFFFFFFFu, ss, off);
    mean = ss / static_cast<float>(2 * a.w2);
  }
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
    const float2 s = __bfloat1622float2(g[c]);
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

}  // namespace

extern "C" {

// mode: 0 sgd, 1 adagrad, 2 rowwise_adam. Returns a cudaError_t; 0 means
// the kernel was launched. Updates table and state in place.
int cffm_streamed_apply(int is_bf16, void* table, float* accum, float* m, float* v,
                        const int* uids, const void* gsum, const float* hyper,
                        long long rows, long long slots, int w, int mode,
                        int stochastic, unsigned long long seed, void* stream) {
  if (w % 64 != 0 || mode < kSgd || mode > kRowwiseAdam) return cudaErrorInvalidValue;
  if ((mode == kAdagrad && accum == nullptr) ||
      (mode == kRowwiseAdam && (m == nullptr || v == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.table = table;
  a.accum = accum;
  a.m = m;
  a.v = v;
  a.uids = uids;
  a.gsum = static_cast<const __nv_bfloat162*>(gsum);
  a.hyper = hyper;
  a.rows = rows;
  a.slots = slots;
  a.w2 = w / 2;
  a.mode = mode;
  a.stochastic = stochastic;
  a.key0 = static_cast<uint32_t>(seed);
  a.key1 = static_cast<uint32_t>(seed >> 32);
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

}  // extern "C"
