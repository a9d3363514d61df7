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
// `cffm_streamed_apply_f32` is the same update with S read in f32 (launched
// by `scatter_rowwise_apply`, the scatter route of optim/rowwise.py, from
// the f32 sums of `cffm_scatter_segment_sum`, and for the small-field
// prefix's rows): the gradient's storage is a template parameter of the
// kernels' bodies beside the table's, so the bf16 entries compile as they
// did; the f32 ones run as scatter_apply_kernel and
// scatter_apply_chunked_kernel.
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
//   Philox4x32-10 stream keyed by the caller's seed, so each element's
//   dither is fixed by (seed, row, column) alone: kernel 7 makes one
//   Philox call per column pair, counted by (pair, row); kernels 4-5 one
//   per group of four pairs c, c+32, c+64, c+96 (c mod 128 < 32), counted
//   by (group, row), a 32-bit word of it per pair.
//   Rows outside the ids are never read or written: they keep table and
//   state bit for bit.
//
// Design. The TPU streamed the whole table through VMEM because its
// scatter is slow per index; here the kernels read and write only the
// touched rows, in place. Both run a persistent grid, one wave of resident
// blocks, over the live slots only: a live range ends at its first
// sentinel, found on the device, so sentinel slots (92% of kernel 4's at
// B=65536, ~95% of kernel 7's) are never visited and no count crosses to
// the host. The hyperparameters are read from device memory, so a
// learning-rate schedule or Adam's step costs no host synchronisation.
// Kernels 4-5 (apply_kernel): warp w of G takes the live slots w, w + G,
// ... in turn. It holds a row in registers (NPL column pairs a lane, g and
// the table as stored, widened to f32 where used) and issues every load of
// its next row (g, table pairs, m, state) before it updates the current
// one, so those loads are in flight under this row's math and stores; g
// is read once and mean(S^2) taken from registers. The warp reads its
// rows' ids 32 at a time, so no row waits on its own id. Two buffers of a
// 640-lane row fit 128 registers, two blocks an SM (rowwise_adam's m
// takes one block). Rows wider than the register route
// (cffm_streamed_route) take the chunked route (apply_chunked_kernel):
// S^2 over chunks of the row, then the update chunk by chunk, reading g
// again.
// Kernel 7 (bucketed_kernel): each block owns a range of ids, finds its
// slots in every bucket, merges them in shared memory into (id, bucket)
// order and gives each id's first slot the row. The owner's warp issues
// every load of the row at once (first partial, table pairs, m, state),
// sums S in bucket order into registers, reading each partial once, and
// updates the row in one pass. No atomics; the result does not depend on
// the order the blocks run in.
// Both share the per-row body (load_row, row_mean, row_step, store_row):
// one S^2 order (lane l sums pairs l, l+32, ... in turn, then a butterfly)
// and written-out f32 roundings, so kernel 4 and kernel 7 at nb = 1 give
// the same bits in f32 and bf16 to nearest, and an f32 table's result is
// bit for bit that of the warp-per-slot kernel both replaced.
//
// Bound on the H100: per touched row, read the bf16 gradient(s) and the row
// (plus m for rowwise_adam) and write the row (and m) back: about 6.4 KB
// per row for an f32 table at W=640, 0.87 GB for the ~136k distinct
// big-field rows of a criteo_kaggle step at B=65536 -- memory-bound at
// about 0.26 ms (3.8 KB per row for a bf16 table: ~1.44 ms for the 1.25M
// rows of a batch of uniform ids). The kernels also read each live id
// once, and a few more per block for their searches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  void* table;            // (V, W) f32 or bf16
  float* accum;           // (V,) adagrad accumulator, or null
  float* m;               // (V, W) rowwise_adam first moment, or null
  float* v;               // (V,) rowwise_adam second moment, or null
  const int* ids;         // uids (M,), or the buckets' ids (NB, C)
  const void* g;           // (M, W/2) pairs of bf16 or f32, or (NB, C, W/2) of bf16
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

// First index in [lo, hi) of the ascending p with p[i] >= key (hi if none),
// by the whole warp: 32 probes a round.
__device__ long long warp_lower_bound(const int* p, long long lo, long long hi, long long key,
                                      int lane) {
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + lane * step;
    const unsigned below = __ballot_sync(0xFFFFFFFFu, i < hi && p[i] < key);
    const int n = __popc(below);  // the probes below key are a prefix of the lanes
    if (n == 0) return lo;
    const long long nlo = lo + (n - 1) * step + 1;
    hi = min(hi, lo + n * step);
    lo = nlo;
  }
  const long long i = lo + lane;
  return lo + __popc(__ballot_sync(0xFFFFFFFFu, i < hi && p[i] < key));
}

// The row's scalar state before the step: accum (adagrad) or v
// (rowwise_adam), 0 for sgd.
__device__ __forceinline__ float row_state(const Args& a, int uid) {
  if (a.mode == kAdagrad) return a.accum[uid];
  if (a.mode == kRowwiseAdam) return a.v[uid];
  return 0.f;
}

// The scalar part of row uid's optimizer step from its state st; mean is
// mean(S^2) of the scaled S (unused by sgd). Lane 0 writes the new state.
struct RowStep {
  float lr, denom, b1, c1;
};

__device__ __forceinline__ RowStep row_step(const Args& a, int uid, int lane, float mean,
                                            float st) {
  RowStep r{a.hyper[0], 1.f, 0.f, 0.f};
  const float eps = a.hyper[1];
  if (a.mode == kAdagrad) {
    const float acc = st + mean;
    if (lane == 0) a.accum[uid] = acc;
    r.denom = sqrtf(acc) + eps;
  } else if (a.mode == kRowwiseAdam) {
    r.b1 = a.hyper[2];
    const float b2 = a.hyper[3];
    r.c1 = a.hyper[4];
    const float c2 = a.hyper[5];
    const float vn = fmaf(1.f - b2, mean, __fmul_rn(b2, st));  // rounded as in pair_delta
    if (lane == 0) a.v[uid] = vn;
    r.denom = sqrtf(vn * c2) + eps;
  }
  return r;
}

// The step of one column pair: the delta for the scaled S pair s, with the
// rowwise_adam first moment mv updated in place. The f32 roundings are
// written out, none left to the compiler's contraction, as the
// warp-per-slot kernel that kernels 4 and 7 replaced compiled them
// (checked bit for bit on the card), so an f32 table's result is that
// kernel's.
__device__ __forceinline__ float2 pair_delta(const Args& a, const RowStep& r, float2 s,
                                             float2& mv) {
  if (a.mode == kRowwiseAdam) {
    mv.x = fmaf(1.f - r.b1, s.x, __fmul_rn(r.b1, mv.x));
    mv.y = fmaf(1.f - r.b1, s.y, __fmul_rn(r.b1, mv.y));
    return make_float2((-r.lr) * (mv.x * r.c1) / r.denom, (-r.lr) * (mv.y * r.c1) / r.denom);
  }
  if (a.mode == kAdagrad) return make_float2((-r.lr) * s.x / r.denom, (-r.lr) * s.y / r.denom);
  return make_float2(__fmul_rn(-r.lr, s.x), __fmul_rn(-r.lr, s.y));
}

// A column pair as it is stored: a table of T holds Pair<T>.
template <typename T>
struct PairOf {
  using type = __nv_bfloat162;
};
template <>
struct PairOf<float> {
  using type = float2;
};
template <typename T>
using Pair = typename PairOf<T>::type;

// A stored pair as f32.
__device__ __forceinline__ float2 as_f32(float2 x) { return x; }
__device__ __forceinline__ float2 as_f32(__nv_bfloat162 x) { return __bfloat1622float2(x); }

// Writes table pair c of row uid: its old value tv plus the delta d, in f32
// or rounded into bf16: to nearest, or stochastically with the 16-bit
// dithers in the low (x) and high (y) halves of dither.
template <typename T>
__device__ __forceinline__ void store_pair(const Args& a, int uid, int c, float2 tv, float2 d,
                                           uint32_t dither) {
  const long long i = static_cast<long long>(uid) * a.w2 + c;
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float2*>(a.table)[i] = make_float2(__fadd_rn(tv.x, d.x), __fadd_rn(tv.y, d.y));
  } else {
    __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(a.table) + i;
    const float nx = tv.x + d.x, ny = tv.y + d.y;
    if (a.stochastic) {
      *tp = __halves2bfloat162(round_sr(nx, dither), round_sr(ny, dither >> 16));
    } else {
      *tp = __floats2bfloat162_rn(nx, ny);
    }
  }
}

// ---------------------------------------------------------------------------
// The per-row body both entries share
// ---------------------------------------------------------------------------

// A row in registers: lane l holds the column pairs c0 + l + 32 i (i < NPL)
// of S (s: as read, bf16, or summed in f32), of the table (tv, as stored)
// and, with kM, of m (mv), and the row's scalar state st (row_state). Each
// is widened to f32 where it is used, so a row held as read takes half
// the registers of one held in f32.
template <typename T, typename S, int NPL, bool kM>
struct RowRegs {
  S s[NPL];
  Pair<T> tv[NPL];
  float2 mv[kM ? NPL : 1];
  float st;
};

// Issues every load of row uid's pairs c0 + lane + 32 i (c < w2) at once:
// its gradient from g (the slot's row, pairs of G), its table pairs, m
// (rowwise_adam, kM) and, with st, its scalar state.
template <typename T, typename S, typename G, int NPL, bool kM>
__device__ __forceinline__ void load_row(const Args& a, int uid, const G* g, int c0, int lane,
                                         bool st, RowRegs<T, S, NPL, kM>& r) {
  const long long row = static_cast<long long>(uid) * a.w2;
  const float2* mrow = reinterpret_cast<const float2*>(a.m) + row;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < a.w2) {
      if constexpr (std::is_same<S, G>::value) {
        r.s[i] = g[c];
      } else {
        r.s[i] = as_f32(g[c]);
      }
      r.tv[i] = reinterpret_cast<const Pair<T>*>(a.table)[row + c];
      if constexpr (kM) r.mv[i] = a.mode == kRowwiseAdam ? mrow[c] : make_float2(0.f, 0.f);
    }
  }
  if (st) r.st = row_state(a, uid);
}

// mean(S^2) over the W lanes of a row held whole in r (c0 = 0), S scaled
// first by the clip's factor, returned in scale (1 without a clip); 0 for
// sgd without a clip, which needs neither.
template <typename T, typename S, int NPL, bool kM>
__device__ __forceinline__ float row_mean(const Args& a, int lane,
                                          const RowRegs<T, S, NPL, kM>& r, float& scale) {
  scale = 1.f;
  if (!(a.clip > 0.f || a.mode != kSgd)) return 0.f;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    if (lane + 32 * i < a.w2) {
      const float2 x = as_f32(r.s[i]);
      ss = fmaf(x.x, x.x, fmaf(x.y, x.y, ss));
    }
  ss = warp_sum(ss);
  if (a.clip > 0.f) {
    scale = fminf(1.f, a.clip / fmaxf(sqrtf(ss), 1e-12f));
    if (a.mode != kSgd) {
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (lane + 32 * i < a.w2) {
          const float x = as_f32(r.s[i]).x * scale, y = as_f32(r.s[i]).y * scale;
          ss = fmaf(x, x, fmaf(y, y, ss));
        }
      ss = warp_sum(ss);
    }
  }
  return ss / (2 * a.w2);
}

// The dither word of pair c of row uid, held as pair i of a row loaded
// from a multiple of 128 pairs: kDither pairs' dither from one Philox call,
// 1 (kernel 7) counted by (pair, row); 4 (kernels 4-5) counted by the group
// (c mod 32) + 32 (c / 128) of pairs c, c+32, c+64, c+96 and the row,
// drawn at the group's first pair into bits, word i mod 4 for pair c.
template <int kDither>
__device__ __forceinline__ uint32_t pair_dither(const Args& a, int uid, int c, int i,
                                                uint4& bits) {
  const uint32_t row = static_cast<uint32_t>(uid);
  if constexpr (kDither == 1) {
    const uint4 p = philox(make_uint4(static_cast<uint32_t>(c), row, 0u, 0u), a.key0, a.key1);
    return (p.x & 0xFFFFu) | (p.y << 16);
  } else {
    const uint32_t group = static_cast<uint32_t>((c & 31) | (c >> 7) << 5);
    if (i % 4 == 0) bits = philox(make_uint4(group, row, 0u, 0u), a.key0, a.key1);
    return i % 4 == 0 ? bits.x : i % 4 == 1 ? bits.y : i % 4 == 2 ? bits.z : bits.w;
  }
}

// Writes row uid's pairs held in r (loaded from c0) with the step rs and S
// scaled by scale: m (rowwise_adam) and the table, a stochastic bf16 table
// dithered by pair_dither<kDither>.
template <int kDither, typename T, typename S, int NPL, bool kM>
__device__ __forceinline__ void store_row(const Args& a, int uid, int c0, int lane,
                                          const RowStep& rs, float scale,
                                          const RowRegs<T, S, NPL, kM>& r) {
  float2* mw = reinterpret_cast<float2*>(a.m) + static_cast<long long>(uid) * a.w2;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < a.w2) {
      float2 mv = make_float2(0.f, 0.f);
      if constexpr (kM) mv = r.mv[i];
      const float2 x = as_f32(r.s[i]);
      const float2 d = pair_delta(a, rs, make_float2(x.x * scale, x.y * scale), mv);
      if constexpr (kM) {
        if (a.mode == kRowwiseAdam) mw[c] = mv;
      }
      uint32_t dither = 0u;
      if constexpr (sizeof(T) == 2) {
        if (a.stochastic) dither = pair_dither<kDither>(a, uid, c, i, bits);
      }
      store_pair<T>(a, uid, c, as_f32(r.tv[i]), d, dither);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 4-5: the flat update over live slots only
// ---------------------------------------------------------------------------

// The live slots [lo, hi) of the ascending uids, lo the first >= 0 and hi
// the first >= V, found by the block's first warp.
__device__ __forceinline__ void live_range(const Args& a, long long* range_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long lo = warp_lower_bound(a.ids, 0, a.slots, 0, lane);
    const long long hi = warp_lower_bound(a.ids, lo, a.slots, a.rows, lane);
    if (lane == 0) {
      range_s[0] = lo;
      range_s[1] = hi;
    }
  }
  __syncthreads();
}

// Kernels 4-5, the register route: rows of at most 32 * NPL column pairs,
// the next row's loads issued before this row's update. The warp reads
// its rows' ids 32 at a time, one a lane, so that a row's loads wait on
// no id load of their own. Two blocks an SM where two rows fit 128
// registers (without m, NPL <= 10). S is held as read: pairs of G.
template <typename T, typename G, int NPL, bool kM>
__device__ __forceinline__ void apply_rows(const Args& a) {
  __shared__ long long range_s[2];
  live_range(a, range_s);
  const long long hi = range_s[1], step = static_cast<long long>(gridDim.x) * kWarps;
  const int lane = threadIdx.x % 32;
  long long slot = range_s[0] + static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  int ids = 0, k = 0;  // lane j: the id of the warp's row k + j of this batch of 32
  auto id_of = [&](long long s) {  // the id of slot s, the warp's row after the last asked
    if (k == 0) ids = s + lane * step < hi ? a.ids[s + lane * step] : 0;
    const int u = __shfl_sync(0xFFFFFFFFu, ids, k);
    k = (k + 1) % 32;
    return u;
  };
  const G* g = static_cast<const G*>(a.g);
  using Row = RowRegs<T, G, NPL, kM>;
  Row r0, r1;
  int u0 = 0, u1 = 0;
  if (slot < hi) {
    u0 = id_of(slot);
    load_row(a, u0, g + slot * a.w2, 0, lane, true, r0);
  }
  // updates the row in cur after issuing the loads of the warp's next row
  // into nxt; no clip (a.clip is 0), so S is not scaled
  auto advance = [&](const Row& cur, int uc, Row& nxt, int& un) {
    const long long next = slot + step;
    if (next < hi) {
      un = id_of(next);
      load_row(a, un, g + next * a.w2, 0, lane, true, nxt);
    }
    float scale;
    const float mean = row_mean(a, lane, cur, scale);
    store_row<4>(a, uc, 0, lane, row_step(a, uc, lane, mean, cur.st), 1.f, cur);
    slot = next;
  };
  while (slot < hi) {
    advance(r0, u0, r1, u1);
    if (slot >= hi) break;
    advance(r1, u1, r0, u0);
  }
}

// Kernels 4-5, the chunked route: rows wider than the register route, in
// chunks of 32 * NPL column pairs (NPL a multiple of 4). S^2 over the
// chunks in the register route's order, then each chunk's update, reading
// its g again.
template <typename T, typename G, int NPL>
__device__ __forceinline__ void apply_chunked_rows(const Args& a) {
  __shared__ long long range_s[2];
  live_range(a, range_s);
  const long long hi = range_s[1], step = static_cast<long long>(gridDim.x) * kWarps;
  const int lane = threadIdx.x % 32;
  const long long first = range_s[0] + static_cast<long long>(blockIdx.x) * kWarps;
  for (long long slot = first + threadIdx.x / 32; slot < hi; slot += step) {
    const int uid = a.ids[slot];
    const G* g = static_cast<const G*>(a.g) + slot * a.w2;
    const float st = row_state(a, uid);
    float mean = 0.f;
    if (a.mode != kSgd) {
      float ss = 0.f;
      for (int c0 = 0; c0 < a.w2; c0 += 32 * NPL) {
        float2 s[NPL];
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (c0 + lane + 32 * i < a.w2) s[i] = as_f32(g[c0 + lane + 32 * i]);
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (c0 + lane + 32 * i < a.w2) ss = fmaf(s[i].x, s[i].x, fmaf(s[i].y, s[i].y, ss));
      }
      ss = warp_sum(ss);
      mean = ss / (2 * a.w2);
    }
    const RowStep rs = row_step(a, uid, lane, mean, st);
    for (int c0 = 0; c0 < a.w2; c0 += 32 * NPL) {
      RowRegs<T, G, NPL, true> r;
      load_row(a, uid, g, c0, lane, false, r);
      store_row<4>(a, uid, c0, lane, rs, 1.f, r);
    }
  }
}

// The routes as kernels: bf16 S under kernel 4's names; f32 S (the
// scatter route's apply) under names of their own, so that a trace tells
// the two apart.
template <typename T, typename G, int NPL, bool kM>
__global__ void __launch_bounds__(kThreads, kM || NPL > 10 ? 1 : 2) apply_kernel(Args a) {
  apply_rows<T, G, NPL, kM>(a);
}

template <typename T, typename G, int NPL>
__global__ void __launch_bounds__(kThreads) apply_chunked_kernel(Args a) {
  apply_chunked_rows<T, G, NPL>(a);
}

template <typename T, int NPL, bool kM>
__global__ void __launch_bounds__(kThreads, kM || NPL > 10 ? 1 : 2) scatter_apply_kernel(Args a) {
  apply_rows<T, float2, NPL, kM>(a);
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads) scatter_apply_chunked_kernel(Args a) {
  apply_chunked_rows<T, float2, NPL>(a);
}

// Column pairs a lane holds on kernel 4's register route for rows of w
// lanes (w % 64 == 0), or 0: the chunked route.
int streamed_route(int w) {
  const int npl = w / 64;
  if (npl <= 4) return 4;
  if (npl <= 8) return 8;
  if (npl <= 10) return 10;
  if (npl <= 16) return 16;
  return 0;
}

// the chunked route's pairs a lane per chunk
constexpr int kChunkPairs = 8;

// ---------------------------------------------------------------------------
// Kernel 7: the bucketed update over live slots only.
// ---------------------------------------------------------------------------

constexpr int k7Win = 2048;  // slots one window merges in shared memory

// First index in [0, n) of the ascending shared p with p[i] >= key (or > key
// when upper), n if none.
__device__ __forceinline__ int smem_bound(const int* p, int n, int key, bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p[mid] < key || (upper && p[mid] == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Kernel 7. Block k of G owns the ids in [s_k, s_k+1), with splitters
// taken at even steps of the longest bucket's live range (the buckets come
// from peers that route the same way, so their ids are spread alike); the
// block finds each bucket's slots of that range with warp searches and
// walks them in windows of at most k7Win slots, each window holding every
// occurrence of its ids. In a window the slots are merged in shared memory
// into (id, bucket) order by co-rank: a slot's rank is its index in its
// bucket plus, in every other bucket, the count of smaller ids (and of
// equal ids in earlier buckets). The first slot of each run of one id owns
// the row; the run lists its partials in bucket order. A warp per row sums
// the partials into registers once (S, NPL column pairs a lane), takes
// |S|^2, the clip scale and mean(S^2) from them, and updates the row.
template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads, 2) bucketed_kernel(Args a) {
  extern __shared__ long long sm7[];
  const int nb = a.nb;
  long long* lo_s = sm7;               // (nb) live range [lo, hi) of each bucket
  long long* hi_s = lo_s + nb;
  long long* cur_s = hi_s + nb;        // (nb) the block's next slot in each bucket
  long long* end_s = cur_s + nb;       // (nb) the end of the block's slots
  long long* src_s = end_s + nb;       // (k7Win) merged: the slot's (bucket, slot) index
  int* ids_s = reinterpret_cast<int*>(src_s + k7Win);  // (k7Win) the window's ids by bucket
  int* mid_s = ids_s + k7Win;          // (k7Win) merged ids
  int* head_s = mid_s + k7Win;         // (k7Win) positions of the runs' first slots
  int* cnt_s = head_s + k7Win;         // (nb) the window's slots in each bucket
  int* off_s = cnt_s + nb;             // (nb + 1) their offsets in the window
  __shared__ long long split_s[2];
  __shared__ int warp_s[kWarps];
  __shared__ int nheads_s, more_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long c = a.slots;
  for (int b = warp; b < nb; b += kWarps) {
    const int* p = a.ids + b * c;
    const long long lo = warp_lower_bound(p, 0, c, 0, lane);
    const long long hi = warp_lower_bound(p, lo, c, a.rows, lane);
    if (lane == 0) {
      lo_s[b] = lo;
      hi_s[b] = hi;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int b = 1; b < nb; ++b)
      if (hi_s[b] - lo_s[b] > hi_s[best] - lo_s[best]) best = b;
    const int* p = a.ids + best * c + lo_s[best];
    const long long len = hi_s[best] - lo_s[best];
    const long long k = blockIdx.x, g = gridDim.x;
    split_s[0] = k == 0 ? 0 : p[k * len / g];
    split_s[1] = k + 1 == g ? a.rows : p[(k + 1) * len / g];
    if (len == 0) split_s[1] = split_s[0];
  }
  __syncthreads();
  const long long s_lo = split_s[0], s_hi = split_s[1];
  if (s_lo >= s_hi) return;  // no id falls in this block's range
  for (int b = warp; b < nb; b += kWarps) {
    const int* p = a.ids + b * c;
    const long long st = warp_lower_bound(p, lo_s[b], hi_s[b], s_lo, lane);
    const long long en = warp_lower_bound(p, st, hi_s[b], s_hi, lane);
    if (lane == 0) {
      cur_s[b] = st;
      end_s[b] = en;
    }
  }
  __syncthreads();

  const int cap = k7Win / nb;
  while (true) {
    // load up to cap ids of each bucket
    for (int u = tid; u < nb * cap; u += kThreads) {
      const int b = u / cap, j = u - b * cap;
      if (cur_s[b] + j < end_s[b]) ids_s[u] = a.ids[b * c + cur_s[b] + j];
    }
    __syncthreads();
    if (tid == 0) {
      // the window ends below the last loaded id of any bucket cut short
      long long v_end = s_hi;
      bool any = false;
      for (int b = 0; b < nb; ++b) {
        const long long left = end_s[b] - cur_s[b];
        any |= left > 0;
        if (left > cap) v_end = min(v_end, static_cast<long long>(ids_s[b * cap + cap - 1]) + 1);
      }
      more_s = any;
      split_s[0] = v_end;  // s_lo is kept in a register
    }
    __syncthreads();
    if (!more_s) break;
    const long long v_end = split_s[0];
    for (int b = tid; b < nb; b += kThreads) {
      const int n = static_cast<int>(min(static_cast<long long>(cap), end_s[b] - cur_s[b]));
      cnt_s[b] = smem_bound(ids_s + b * cap, n, static_cast<int>(v_end), false);
    }
    __syncthreads();
    if (tid == 0) {
      int o = 0;
      for (int b = 0; b < nb; ++b) {
        off_s[b] = o;
        o += cnt_s[b];
      }
      off_s[nb] = o;
    }
    __syncthreads();
    const int n = off_s[nb];

    // merge by co-rank into (id, bucket) order
    for (int u = tid; u < n; u += kThreads) {
      int b = 0;
      while (u >= off_s[b + 1]) ++b;
      const int j = u - off_s[b];
      const int x = ids_s[b * cap + j];
      int rank = j;
      for (int o = 0; o < nb; ++o)
        if (o != b) rank += smem_bound(ids_s + o * cap, cnt_s[o], x, o < b);
      mid_s[rank] = x;
      src_s[rank] = b * c + cur_s[b] + j;
    }
    __syncthreads();

    // the runs' first slots, compacted in order by a block scan
    constexpr int kPer = k7Win / kThreads;
    int flags = 0, cnt = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int r = tid * kPer + q;
      if (r < n && (r == 0 || mid_s[r] != mid_s[r - 1])) {
        flags |= 1 << q;
        ++cnt;
      }
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_s[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int o = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int t = warp_s[w];
        warp_s[w] = o;
        o += t;
      }
      nheads_s = o;
    }
    __syncthreads();
    int pos = warp_s[warp] + incl - cnt;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (flags & (1 << q)) head_s[pos++] = tid * kPer + q;
    __syncthreads();

    const int nheads = nheads_s;
    for (int h = warp; h < nheads; h += kWarps) {
      const int r0 = head_s[h], r1 = h + 1 < nheads ? head_s[h + 1] : n;
      const int uid = mid_s[r0];
      RowRegs<T, float2, NPL, true> row;
      const __nv_bfloat162* g = static_cast<const __nv_bfloat162*>(a.g);
      load_row(a, uid, g + src_s[r0] * a.w2, 0, lane, true, row);
      for (int r = r0 + 1; r < r1; ++r) {
        const __nv_bfloat162* gr = g + src_s[r] * a.w2;
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if (lane + 32 * i < a.w2) {
            const float2 x = __bfloat1622float2(gr[lane + 32 * i]);
            row.s[i].x += x.x;
            row.s[i].y += x.y;
          }
      }
      float scale;
      const float mean = row_mean(a, lane, row, scale);
      store_row<1>(a, uid, 0, lane, row_step(a, uid, lane, mean, row.st), scale, row);
    }
    __syncthreads();
    for (int b = tid; b < nb; b += kThreads) cur_s[b] += cnt_s[b];
    __syncthreads();
  }
}

size_t bucketed_smem(int nb) {
  return sizeof(long long) * (4 * static_cast<size_t>(nb) + k7Win) +
         sizeof(int) * (3 * static_cast<size_t>(k7Win) + 2 * nb + 1);
}

// Launches kernel on a persistent grid of one wave: as many blocks of
// kThreads as the card holds at once.
cudaError_t launch_wave(void (*kernel)(Args), const Args& a, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  kernel<<<sms * (per_sm > 0 ? per_sm : 1), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename G, int NPL>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  const bool adam = a.mode == kRowwiseAdam;
  void (*kernel)(Args);
  if constexpr (std::is_same<G, float2>::value)
    kernel = adam ? scatter_apply_kernel<T, NPL, true> : scatter_apply_kernel<T, NPL, false>;
  else
    kernel = adam ? apply_kernel<T, G, NPL, true> : apply_kernel<T, G, NPL, false>;
  return launch_wave(kernel, a, 0, s);
}

// Kernels 4-5 on a table of T from S stored as pairs of G.
template <typename T, typename G>
cudaError_t launch_apply(const Args& a, cudaStream_t s) {
  switch (streamed_route(2 * a.w2)) {
    case 4: return launch_rows<T, G, 4>(a, s);
    case 8: return launch_rows<T, G, 8>(a, s);
    case 10: return launch_rows<T, G, 10>(a, s);
    case 16: return launch_rows<T, G, 16>(a, s);
    default:
      if constexpr (std::is_same<G, float2>::value)
        return launch_wave(scatter_apply_chunked_kernel<T, kChunkPairs>, a, 0, s);
      else
        return launch_wave(apply_chunked_kernel<T, G, kChunkPairs>, a, 0, s);
  }
}

template <typename T>
cudaError_t launch_bucketed(const Args& a, cudaStream_t s) {
  const size_t smem = bucketed_smem(a.nb);
  const int npl = a.w2 / 32;  // column pairs a lane
  if (npl <= 4) return launch_wave(bucketed_kernel<T, 4>, a, smem, s);
  if (npl <= 8) return launch_wave(bucketed_kernel<T, 8>, a, smem, s);
  if (npl <= 10) return launch_wave(bucketed_kernel<T, 10>, a, smem, s);
  if (npl <= 16) return launch_wave(bucketed_kernel<T, 16>, a, smem, s);
  return launch_wave(bucketed_kernel<T, 32>, a, smem, s);
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
  a.g = g;
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

// Kernels 4-5 from S stored as pairs of G.
template <typename G>
int streamed_apply(int is_bf16, void* table, float* accum, float* m, float* v, const int* uids,
                   const void* gsum, const float* hyper, long long rows, long long slots, int w,
                   int mode, int stochastic, unsigned long long seed, void* stream) {
  if (w <= 0 || w % 64 != 0 || rows > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (const int err = check_state(mode, accum, m, v)) return err;
  const Args a = make_args(table, accum, m, v, uids, gsum, hyper, rows, slots, 1, w, mode,
                           stochastic, 0.f, seed);
  if (slots == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_apply<__nv_bfloat16, G>(a, s) : launch_apply<float, G>(a, s);
}

}  // namespace

extern "C" {

// Kernels 4-5's route for rows of w lanes: the column pairs a lane holds on
// the register route (4, 8, 10 or 16), 0 for the chunked route, -1 for a
// width the kernels do not take.
int cffm_streamed_route(int w) { return w <= 0 || w % 64 != 0 ? -1 : streamed_route(w); }

// Kernels 4-5. mode: 0 sgd, 1 adagrad, 2 rowwise_adam. Returns a
// cudaError_t; 0 means the kernel was launched. Updates table and state in
// place.
int cffm_streamed_apply(int is_bf16, void* table, float* accum, float* m, float* v,
                        const int* uids, const void* gsum, const float* hyper,
                        long long rows, long long slots, int w, int mode,
                        int stochastic, unsigned long long seed, void* stream) {
  return streamed_apply<__nv_bfloat162>(is_bf16, table, accum, m, v, uids, gsum, hyper, rows,
                                        slots, w, mode, stochastic, seed, stream);
}

// The same update with gsum (M, W) f32: the scatter route's apply. Same
// modes, return value and in-place update.
int cffm_streamed_apply_f32(int is_bf16, void* table, float* accum, float* m, float* v,
                            const int* uids, const void* gsum, const float* hyper,
                            long long rows, long long slots, int w, int mode,
                            int stochastic, unsigned long long seed, void* stream) {
  return streamed_apply<float2>(is_bf16, table, accum, m, v, uids, gsum, hyper, rows, slots, w,
                                mode, stochastic, seed, stream);
}

// Kernel 7: ids (nb, c), g (nb, c, w) bf16 with w <= cffm_bucketed_max_width();
// clip > 0 clips each row's summed gradient. Same modes, return value and
// in-place update.
int cffm_bucketed_max_width() { return 64 * 32; }

int cffm_bucketed_apply(int is_bf16, void* table, float* accum, float* m, float* v,
                        const int* ids, const void* g, const float* hyper, long long rows,
                        int nb, long long c, int w, int mode, float clip, int stochastic,
                        unsigned long long seed, void* stream) {
  if (w % 64 != 0 || w > cffm_bucketed_max_width() || nb < 1 || nb > k7Win || c < 0 ||
      rows > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if (const int err = check_state(mode, accum, m, v)) return err;
  const Args a = make_args(table, accum, m, v, ids, g, hyper, rows, c, nb, w, mode,
                           stochastic, clip, seed);
  if (c == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bucketed<__nv_bfloat16>(a, s) : launch_bucketed<float>(a, s);
}

}  // extern "C"
