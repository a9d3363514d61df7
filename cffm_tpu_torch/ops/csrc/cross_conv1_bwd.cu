// Fused pairwise cross + conv layer 1 (+ first-order column), backward.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// cffm_tpu/ops/interaction_conv.py (launched by `_bwd_pallas`), for all
// four entries of the forward (cross_conv1_fwd.cu): the same per-part base
// pointers, field counts and (field, batch) strides, 64-bit row offsets.
//
// What it computes, per example b, with g = gY rounded to the input type T
// and M the cross map rebuilt from E exactly as the forward builds it:
//   dW[t,p,c] = sum_b sum_x g[b,c,x] * M[b,p,x+t-k/2]          (f32)
//   dM[b,p,x] = sum_{c,t} W1[c,p,t] * g[b,c,x-t+k/2]           (f32, then T)
//   field-aware: dE[b,i,j*d+x] = T(dM[b,p,x] * E[b,j,i*d+x]) and
//                dE[b,j,i*d+x] = T(dM[b,p,x] * E[b,i,j*d+x]) for p=(i<j);
//                the diagonal blocks dE[b,i,i*d+x] are exact zeros;
//                with lin, dE[b,f,lin_col] = T(glin[b]) and the other pad
//                lanes [lin_col+1, w_phys) are exact zeros;
//   hadamard:    dE[b,i,x] = T(sum_{j!=i} dM[b,p(i,j),x] * E[b,j,x]), the
//                sum in f32.
// dW is summed in f32 in a fixed order that does not depend on the order
// in which blocks run (per-block partials, then a second kernel sums them
// in block order): no atomics, bit-equal from run to run.
//
// Two kernels. Field-aware bf16 rows with d=16, k in {1, 3, 5, 7} and
// C1<=64, or k=3 and C1<=128 (the training path of criteo_kaggle, avazu
// and criteo_full, and movielens field-aware) take
// cross_conv1_bwd_wgmma_kernel (below the CUDA-core kernel): both products
// as wgmma GEMMs around one shared tap window of g. Everything else (f32,
// hadamard, k >= 9, other shapes) takes cross_conv1_bwd_kernel: a block
// owns a range of examples and walks the pair axis in chunks and layer 1
// in slices of channels and taps, stages the slice's weights, g and the
// cross map in shared memory as f32, and runs both products as FMAs on
// the CUDA cores, a thread's dW over one pair and one group of 8 channels.
// cffm_cross_conv1_bwd_takes says which shapes the two take together (any
// C1 and every odd k whose smallest slice fits); the wrapper raises for
// others.
//
// Bound on the H100. At criteo_kaggle shapes (F=39, d=16, W=640, C1=64,
// k=3, bf16) dW and dM each take 2*d*P*k*C1 = 4.55 MFLOP per example
// (596 GFLOP together at B=65536, ~0.6 ms at the bf16 tensor-core peak)
// against ~102 KB of E, dE and g moved (6.7 GB, 1.99 ms at 3.35 TB/s): the
// function is memory-bound. The wgmma kernel reads E once and g once per
// pair chunk (6 times at P=741). Its time goes to the producer's loads of E
// and the consumers' stores of dE, each a 32-byte piece per pair and
// example, half of them scattered over rows; the products cost little
// (cffm_tpu_torch/scripts/ablate_bwd.py times variants with each part
// taken out). An L2 prefetch of the next tile's rows keeps more of E in
// flight than the producer's registers hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPC = 32;      // pairs per chunk
constexpr int kEB = 8;       // examples per group (kEB * kPC == kThreads)
constexpr int kCG = 8;       // channels per dW group, one group a thread
constexpr int kMaxUnrolled = 9;  // widths k <= this take their own instantiation (KT = k)
constexpr int kRT = 8;       // taps per slice of the run-time-k instantiation
constexpr int kTN = 8;       // positions per dM step
constexpr int kThreads = 256;
constexpr int kMaxCC = kThreads / kPC * kCG;  // channels per slice of the CUDA-core kernel
constexpr int kTargetBlocks = 264;  // two per SM on a 132-SM card

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

struct Args {
  const void* e0;          // input part 0: fields [0, nf0)
  const void* e1;          // input part 1: fields [nf0, fields)
  int nf0;
  long long fs0, bs0, fs1, bs1;      // input (field, batch) strides
  void* de0;               // output parts, same field partition
  void* de1;
  long long dfs0, dbs0, dfs1, dbs1;  // output (field, batch) strides
  const void* w;           // (K, c1, P) in T
  const void* g;           // (batch, c1, d) in T
  const float* glin;       // (batch,) f32 or null
  float* hacc;             // (batch, fields, d) f32 scratch (hadamard)
  float* dwp;              // (blocks, K, P, c1) f32 partials
  float* dmacc;            // (batch, kPC, d) f32 scratch: dM over slices (CUDA cores)
  int batch, fields, d, k, c1, hadamard, lin_col, w_phys;
  int ebl, xp, ngx;        // examples per block, padded row, position groups
  int cc, ncs, nts;        // CUDA-core slices: channels per slice, channel and tap slices
};

template <typename T>
__device__ __forceinline__ const T* in_row(const Args& a, int f, long long b) {
  if (f < a.nf0) return static_cast<const T*>(a.e0) + f * a.fs0 + b * a.bs0;
  return static_cast<const T*>(a.e1) + (f - a.nf0) * a.fs1 + b * a.bs1;
}

template <typename T>
__device__ __forceinline__ T* out_row(const Args& a, int f, long long b) {
  if (f < a.nf0) return static_cast<T*>(a.de0) + f * a.dfs0 + b * a.dbs0;
  return static_cast<T*>(a.de1) + (f - a.nf0) * a.dfs1 + b * a.dbs1;
}

// Field-aware dE lanes no pair writes: diagonal blocks zero; with lin, the
// fused column glin and the other pad lanes zero. One block's examples.
template <typename T>
__device__ void diag_and_pads(const Args& a, long long b_begin, long long b_end) {
  const int extra = a.glin != nullptr ? a.w_phys - a.lin_col : 0;
  const int lanes = a.d + extra;
  const long long nb = b_end - b_begin;
  for (long long u = threadIdx.x; u < nb * a.fields * lanes; u += blockDim.x) {
    const long long bl = u / (a.fields * lanes);
    const int r = static_cast<int>(u - bl * a.fields * lanes);
    const int f = r / lanes;
    const int l = r - f * lanes;
    const long long b = b_begin + bl;
    T* row = out_row<T>(a, f, b);
    if (l < a.d) {
      row[f * a.d + l] = from_f<T>(0.f);
    } else {
      const int col = a.lin_col + (l - a.d);
      row[col] = from_f<T>(col == a.lin_col ? a.glin[b] : 0.f);
    }
  }
}

// The CUDA-core kernel walks layer 1 in slices of at most kMaxCC channels
// and KT taps (KT = k for the unrolled widths, kRT otherwise): shared
// memory and a thread's dW registers are sized by the slice, not by C1 or
// k. Per pair chunk it runs the block's examples once per slice; dM's f32
// sum is carried from slice to slice in the scratch dmacc (batch, kPC, d),
// and the last slice forms dE from it.
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads) cross_conv1_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // (KT, cc, kPC)
  float* gs = ws + KT * a.cc * kPC;              // (kEB, xp, cc), halo k/2
  float* ms = gs + kEB * a.xp * a.cc;            // (kEB, kPC, xp), halo k/2
  float* fa = ms + kEB * kPC * a.xp;             // (kEB, kPC, d): E side i
  float* fb = fa + kEB * kPC * a.d;              // (kEB, kPC, d): E side j
  float* dms = fb + kEB * kPC * a.d;             // (kEB, kPC, d): dM (hadamard only)
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  const int half = a.k / 2;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int slices = a.ncs * a.nts;
  const int tid = threadIdx.x;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  // dW role: one pair, one group of kCG channels of the slice
  const int ncg = a.cc / kCG;
  const int wpc = tid / ncg;
  const int wcg = tid - wpc * ncg;
  // dM role: one (example, pair)
  const int me = tid / kPC;
  const int mpc = tid - me * kPC;
  const T* wg = static_cast<const T*>(a.w);
  const T* gg = static_cast<const T*>(a.g);

  for (int p0 = 0; p0 < pairs; p0 += kPC) {
    const int npc = min(kPC, pairs - p0);
    if (tid < kPC) {
      int i = 0, rem = p0 + tid;
      while (i < a.fields - 1 && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      pi_s[tid] = i;
      pj_s[tid] = i + 1 + rem;
    }
    for (int sl = 0; sl < slices; ++sl) {
      const int c0 = (sl / a.nts) * a.cc, t0 = (sl % a.nts) * KT;
      const int nc = min(a.cc, a.c1 - c0), nt = min(KT, a.k - t0);
      const bool first = sl == 0, last = sl == slices - 1;
      __syncthreads();  // the previous slice's readers of ws are done; pair tables set
      for (int u = tid; u < KT * a.cc * kPC; u += kThreads) {
        const int t = u / (a.cc * kPC);
        const int r = u - t * a.cc * kPC;
        const int c = r / kPC;
        const int pc = r - c * kPC;
        ws[u] = (t < nt && c < nc && pc < npc)
                    ? to_f(wg[(static_cast<long long>(t0 + t) * a.c1 + c0 + c) * pairs + p0 + pc])
                    : 0.f;
      }

      float acc[kCG][KT];
#pragma unroll
      for (int ci = 0; ci < kCG; ++ci)
#pragma unroll
        for (int t = 0; t < KT; ++t) acc[ci][t] = 0.f;

      for (long long b0 = b_begin; b0 < b_end; b0 += kEB) {
        __syncthreads();  // previous group's tiles settled; ws visible
        // the slice's channels of g, halo-padded, channels innermost
        for (int u = tid; u < kEB * a.xp * a.cc; u += kThreads) {
          const int e = u / (a.xp * a.cc);
          const int r = u - e * a.xp * a.cc;
          const int q = r / a.cc;
          const int c = r - q * a.cc;
          const int x = q - half;
          const long long b = b0 + e;
          gs[u] = (b < b_end && x >= 0 && x < a.d && c < nc)
                      ? to_f(gg[(b * a.c1 + c0 + c) * a.d + x])
                      : 0.f;
        }
        // cross map chunk and its factors
        for (int u = tid; u < kEB * kPC * a.xp; u += kThreads) {
          const int e = u / (kPC * a.xp);
          const int r = u - e * kPC * a.xp;
          const int pc = r / a.xp;
          const int x = r - pc * a.xp - half;
          const long long b = b0 + e;
          float v = 0.f;
          if (x >= 0 && x < a.d) {
            float av = 0.f, bv = 0.f;
            if (pc < npc && b < b_end) {
              const int i = pi_s[pc], j = pj_s[pc];
              const T* ri = in_row<T>(a, i, b);
              const T* rj = in_row<T>(a, j, b);
              av = a.hadamard ? to_f(ri[x]) : to_f(ri[j * a.d + x]);
              bv = a.hadamard ? to_f(rj[x]) : to_f(rj[i * a.d + x]);
              v = round_t<T>(av * bv);
            }
            fa[(e * kPC + pc) * a.d + x] = av;
            fb[(e * kPC + pc) * a.d + x] = bv;
          }
          ms[u] = v;
        }
        __syncthreads();

        // dW: acc[ci][t] += g[e, c0 + wcg*kCG + ci, x] * M[e, wpc, x + t0 + t - k/2]
        if (wpc < npc && wcg * kCG < nc) {
          for (int e = 0; e < kEB && b0 + e < b_end; ++e) {
            const float* mrow = ms + (e * kPC + wpc) * a.xp + t0;
            const float* grow = gs + e * a.xp * a.cc + wcg * kCG;
            for (int x = 0; x < a.d; ++x) {
              const float* gq = grow + (x + half) * a.cc;
              const float4 g0 = *reinterpret_cast<const float4*>(gq);
              const float4 g1 = *reinterpret_cast<const float4*>(gq + 4);
              const float gv[kCG] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
              for (int t = 0; t < KT; ++t) {
                if (t < nt) {
                  const float mv = mrow[x + t];
#pragma unroll
                  for (int ci = 0; ci < kCG; ++ci) acc[ci][t] = fmaf(gv[ci], mv, acc[ci][t]);
                }
              }
            }
          }
        }

        // dM over the slice, continuing the earlier slices' sum (so that the
        // channels are summed in the order one slice would take them):
        // dm[n] += sum_c sum_t W[t0+t, c0+c, mpc] * g[me, c0+c, x0+n-(t0+t)+k/2];
        // the window starts at q0 in gs's row (negative only on a short
        // last tap slice, whose missing taps have zero weights)
        const long long mb = b0 + me;
        const bool mactive = mpc < npc && mb < b_end;
        const int q0 = a.k - t0 - KT;
        for (int xg = 0; xg < a.ngx; ++xg) {
          float* acc_dm = a.dmacc ? a.dmacc + (mb * kPC + mpc) * a.d + xg * kTN : nullptr;
          float dm[kTN];
#pragma unroll
          for (int n = 0; n < kTN; ++n)
            dm[n] = (!first && mactive && xg * kTN + n < a.d) ? acc_dm[n] : 0.f;
          if (mactive) {
            const float* gwin = gs + (me * a.xp + xg * kTN) * a.cc;
            for (int c = 0; c < nc; ++c) {
              float wv[KT];
#pragma unroll
              for (int t = 0; t < KT; ++t) wv[t] = ws[(t * a.cc + c) * kPC + mpc];
              float gw[kTN + KT - 1];
#pragma unroll
              for (int q = 0; q < kTN + KT - 1; ++q)
                gw[q] = q0 + q >= 0 ? gwin[(q0 + q) * a.cc + c] : 0.f;
#pragma unroll
              for (int t = 0; t < KT; ++t)
#pragma unroll
                for (int n = 0; n < kTN; ++n) dm[n] = fmaf(wv[t], gw[n + KT - 1 - t], dm[n]);
            }
          }
          if (!mactive) continue;
          if (!last) {
#pragma unroll
            for (int n = 0; n < kTN; ++n)
              if (xg * kTN + n < a.d) acc_dm[n] = dm[n];
            continue;
          }
          const int i = pi_s[mpc], j = pj_s[mpc];
          const float* fav = fa + (me * kPC + mpc) * a.d;
          const float* fbv = fb + (me * kPC + mpc) * a.d;
          if (a.hadamard) {
#pragma unroll
            for (int n = 0; n < kTN; ++n) {
              const int x = xg * kTN + n;
              if (x < a.d) dms[(me * kPC + mpc) * a.d + x] = round_t<T>(dm[n]);
            }
          } else {
            T* di = out_row<T>(a, i, mb) + j * a.d;
            T* dj = out_row<T>(a, j, mb) + i * a.d;
#pragma unroll
            for (int n = 0; n < kTN; ++n) {
              const int x = xg * kTN + n;
              if (x < a.d) {
                const float dmt = round_t<T>(dm[n]);
                di[x] = from_f<T>(dmt * fbv[x]);
                dj[x] = from_f<T>(dmt * fav[x]);
              }
            }
          }
        }

        if (a.hadamard && last) {
          __syncthreads();
          // one thread per (example, field, position): sums in pair order
          const bool last_chunk = p0 + kPC >= pairs;
          for (int u = tid; u < kEB * a.fields * a.d; u += kThreads) {
            const int e = u / (a.fields * a.d);
            const int r = u - e * a.fields * a.d;
            const int f = r / a.d;
            const int x = r - f * a.d;
            const long long b = b0 + e;
            if (b >= b_end) continue;
            float* h = a.hacc + (b * a.fields + f) * a.d + x;
            float s = p0 == 0 ? 0.f : *h;
            for (int pc = 0; pc < npc; ++pc) {
              const int o = (e * kPC + pc) * a.d + x;
              if (pi_s[pc] == f) s += dms[o] * fb[o];
              if (pj_s[pc] == f) s += dms[o] * fa[o];
            }
            if (last_chunk) {
              out_row<T>(a, f, b)[x] = from_f<T>(s);
            } else {
              *h = s;
            }
          }
        }
      }

      if (wpc < npc) {
        float* out = a.dwp + static_cast<long long>(blockIdx.x) * a.k * pairs * a.c1;
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int ci = 0; ci < kCG; ++ci) {
            const int c = wcg * kCG + ci;
            if (t < nt && c < nc)
              out[(static_cast<long long>(t0 + t) * pairs + p0 + wpc) * a.c1 + c0 + c] =
                  acc[ci][t];
          }
      }
    }
    __syncthreads();  // pair tables are rewritten by the next chunk
  }

  if (!a.hadamard) diag_and_pads<T>(a, b_begin, b_end);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: field-aware, d == 16, k*C1 within wg_max_mtiles
// m-tiles of 64 (C1 <= 64, or C1 <= 128 at k=3), 16-byte aligned rows and
// g (wgmma).
//
// With A = [W_0; ...; W_{k-1}] the stacked weights (R = k*C1 rows by P
// pairs; W_t = W1[:, :, t]) and the tap window of g for a tile of examples,
//   Gwin[t*C1 + c, (b, x)] = g[b, c, x - t + k/2]   (zero outside [0, 16)),
// both products are GEMMs over the same shared-memory operands:
//   dM^T ((b, x), p) = Gwin^T * A        (depth R),
//   dW_stack (r, p) += Gwin * M^T        (depth examples * 16),
// because dM[b,p,x] = sum_{c,t} W1[c,p,t] g[b,c,x-t+k/2] and, with
// x' = x + t - k/2, dW[c,p,t] = sum_{b,x'} Gwin[t*C1+c, (b,x')] M[p,(b,x')];
// the zero halos of g and M become zeros of Gwin. The conv's shift costs
// nothing in either GEMM.
//
// Loop order. One block per SM (a persistent grid) owns a contiguous range
// of kNE-example tiles. It walks the pair axis in chunks of kPC pairs
// (outer loop) and its tiles (inner loop), keeps the chunk's dW_stack in
// registers over its whole range and writes one f32 partial per (block,
// chunk); sum_partials_kernel sums them in block order. So E is read once
// and g once per chunk. Threads: two consumer warpgroups, each owning kPW
// pairs of the chunk (the N of both GEMMs), and one producer warpgroup.
// The chunk's slice of A^T (pairs x R) arrives by one bulk copy onto an
// mbarrier. Per tile the producer fills one stage of a two-stage ring:
// Gwin (R x kNE*16) from g, and the cross tile M (rounded to bf16 as the
// forward rounds it) with its two factors E[b,i,16j+x] and E[b,j,16i+x]
// (pairs x kNE*16) from E, and prefetches the next tile's rows into L2
// while this tile's loads are in flight. A consumer issues dM^T (Gwin read
// MN-major: transpose bit set) and then dW (Gwin read K-major), waits for
// dM^T only, rounds it to bf16 into shared memory and writes dE =
// bf16(dM * factor), 16 bytes a lane, while its dW products run; then it
// releases the stage.
// Each dE lane is written by exactly one pair. The consumers write each
// tile's diagonal blocks and pad lanes in the first chunk.
// Shared memory layouts, without swizzle, in 8x8 core matrices of 128
// contiguous bytes (8 rows of 16 bytes):
//   Gwin:      [row group r/8][column group (b,x)/8][r%8][8 columns];
//   M, factors and the dM staging: [pair group][column group][pair%8][8];
//   A^T chunk: [pair group][row group][pair%8][8 rows], one contiguous
//              block per chunk in the wrapper's layout
//              (interaction_conv.bwd_wgmma_weights).
// ---------------------------------------------------------------------------

constexpr int kD = 16;                 // embed dim of this path
constexpr int kNE = 4;                 // examples per tile
constexpr int kCols = kNE * kD;        // GEMM columns (b, x) per tile
constexpr int kCG8 = kCols / 8;        // column groups of 8
constexpr int kStages = 2;
constexpr int kWgThreads = 3 * 128;    // two consumer warpgroups, one producer
constexpr int kBarBytes = 128;
constexpr int kMaxWgFields = 255;      // pair tables hold i and j in a byte each
constexpr int kSmemMax = 232448;       // shared memory a block may use on the H100

// m-tiles of 64 rows of Gwin: k*C1 rows
__host__ __device__ constexpr int wg_mtiles(int k, int c1) { return (k * c1 + 63) / 64; }
// pairs per consumer warpgroup: dW holds MT * kPW / 2 f32 registers a thread
__host__ __device__ constexpr int wg_pairs(int mt) { return mt <= 3 ? 64 : 32; }
// m-tiles instantiated at width K: C1 <= 64, and C1 <= 128 at K=3
__host__ __device__ constexpr int wg_max_mtiles(int k) { return k == 3 ? 6 : k; }

template <int MT>
struct BwdLayout {
  static constexpr int kRP = MT * 64;               // Gwin rows, padded
  static constexpr int kRG = kRP / 8;               // Gwin row groups
  static constexpr int kPW = wg_pairs(MT);          // pairs per consumer warpgroup
  static constexpr int kPC = 2 * kPW;               // pairs per chunk
  static constexpr int kABytes = kPC * kRP * 2;     // A^T chunk
  static constexpr int kGBytes = kRP * kCols * 2;   // Gwin
  static constexpr int kMBytes = kPC * kCols * 2;   // M, each factor, the dM staging
  static constexpr int kStageBytes = kGBytes + 3 * kMBytes;
  static constexpr int kPairBytes = 2 * kPC * 2;    // (i, j) of two chunks
  static constexpr int kSmem =
      kBarBytes + kPairBytes + kABytes + kStages * kStageBytes + kMBytes;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor, no swizzle: lbo is the byte stride
// between core matrices along K, sbo along M (or N)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x N, f32, this thread's N/2) += A (64 x 16) * B (16 x N, K-major);
// TA = 1 reads A MN-major (the transpose bit), 0 K-major
template <int N, int TA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <int TA>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64, 0>(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_bf16_n64<0>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<64, 1>(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_bf16_n64<1>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<32, 0>(float (&d)[16], uint64_t a, uint64_t b) {
  wgmma_bf16_n32<0>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<32, 1>(float (&d)[16], uint64_t a, uint64_t b) {
  wgmma_bf16_n32<1>(d, a, b);
}

// 8 bf16 products, each rounded once: bf16(x * y)
__device__ __forceinline__ uint4 mul8(const uint4& x, const uint4& y) {
  uint4 z;
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
  __nv_bfloat162* za = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
  for (int n = 0; n < 4; ++n) za[n] = __hmul2(xa[n], ya[n]);
  return z;
}

// out[x] = in[x - S] over 16 bf16 lanes (8 words), zero outside [0, 16)
template <int S>
__device__ __forceinline__ void shift16(const uint32_t (&in)[8], uint32_t (&out)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x0 = 2 * k - S, x1 = 2 * k + 1 - S;
    const int c0 = x0 < 0 ? 0 : (x0 > 15 ? 15 : x0), c1 = x1 < 0 ? 0 : (x1 > 15 ? 15 : x1);
    const uint32_t lo = (x0 == c0) ? (in[c0 >> 1] >> ((c0 & 1) * 16)) & 0xFFFFu : 0u;
    const uint32_t hi = (x1 == c1) ? (in[c1 >> 1] >> ((c1 & 1) * 16)) & 0xFFFFu : 0u;
    out[k] = lo | (hi << 16);
  }
}

// Gwin rows t*C1 + c, t = T..K-1, of one (example, channel) from its g row
template <int K, int T>
__device__ __forceinline__ void store_taps(unsigned char* gw, const uint32_t (&gv)[8], int c,
                                           int c1, int e) {
  if constexpr (T < K) {
    uint32_t o[8];
    shift16<T - K / 2>(gv, o);
    const int r = T * c1 + c;
    unsigned char* dst = gw + ((r / 8) * kCG8 + 2 * e) * 128 + (r % 8) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + 128) = make_uint4(o[4], o[5], o[6], o[7]);
    store_taps<K, T + 1>(gw, gv, c, c1, e);
  }
}

// diag_and_pads for the wgmma path, 16 bytes a store, by threads t0, t0 +
// nt, ...: d == 16, and lin_col and w_phys are multiples of 8 (checked at
// the launch)
__device__ void diag_and_pads16(const Args& a, long long b_begin, long long b_end, int t0,
                                int nt) {
  using bf = __nv_bfloat16;
  const int pads = a.glin != nullptr ? (a.w_phys - a.lin_col) / 8 : 0;
  const int per_field = 2 + pads;
  const int per_example = a.fields * per_field;
  const int n = static_cast<int>(b_end - b_begin) * per_example;
  for (int u = t0; u < n; u += nt) {
    const int bl = u / per_example;
    const int r = u - bl * per_example;
    const int f = r / per_field, l = r - f * per_field;
    const long long b = b_begin + bl;
    bf* row = out_row<bf>(a, f, b);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (l == 2) v.x = __bfloat16_as_ushort(__float2bfloat16_rn(a.glin[b]));
    *reinterpret_cast<uint4*>(l < 2 ? row + f * kD + l * 8 : row + a.lin_col + (l - 2) * 8) = v;
  }
}

template <int K, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    cross_conv1_bwd_wgmma_kernel(Args a, int tpb, int ntiles) {
  using L = BwdLayout<MT>;
  using bf = __nv_bfloat16;
  constexpr int kPW = L::kPW, kPC = L::kPC;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint64_t* a_full = empty + kStages;
  uint64_t* a_empty = a_full + 1;
  uint16_t* pij = reinterpret_cast<uint16_t*>(smem + kBarBytes);  // [2][kPC]: i << 8 | j
  unsigned char* at = smem + kBarBytes + L::kPairBytes;           // A^T chunk
  unsigned char* ring = at + L::kABytes;
  unsigned char* dms = ring + kStages * L::kStageBytes;           // dM staging, bf16

  const int tid = threadIdx.x;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int nq = (pairs + kPC - 1) / kPC;
  const int t_begin = blockIdx.x * tpb;
  const int t_end = min(ntiles, t_begin + tpb);
  const long long b_begin = static_cast<long long>(t_begin) * kNE;
  const long long b_end = min(static_cast<long long>(a.batch),
                              static_cast<long long>(t_end) * kNE);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Gwin's pad rows [k*C1, MT*64) are never written: zero both stages' Gwin
  for (int u = tid; u < kStages * L::kGBytes / 16; u += kWgThreads) {
    const int s = u / (L::kGBytes / 16);
    reinterpret_cast<uint4*>(ring + s * L::kStageBytes)[u - s * (L::kGBytes / 16)] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // producer: A^T by bulk copy once per chunk; per tile Gwin, M and the factors
    const int pt = tid - 2 * 128;
    constexpr int kEStep = 128 / kPC;  // the thread's examples: e0, e0 + kEStep, ...
    constexpr int kEU = kNE / kEStep;
    // (example, channel) items of g a thread takes: C1 <= MT * 64 / K
    constexpr int kGI = (kNE * (MT * 64 / K) + 127) / 128;
    const int pc = pt % kPC;
    const int e0 = pt / kPC;
    const unsigned char* wsrc = static_cast<const unsigned char*>(a.w);
    const bf* gg = static_cast<const bf*>(a.g);
    uint32_t it = 0;
    for (int q = 0; q < nq; ++q) {
      const int p = q * kPC + pc;
      const bool pv = p < pairs;
      int i = 0, rem = p;
      while (pv && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      const int j = i + 1 + rem;
      for (int tile = t_begin; tile < t_end; ++tile, ++it) {
        const int s = it % kStages;
        const long long b0 = static_cast<long long>(tile) * kNE;
        uint4 va[kEU][2], vb[kEU][2], gv[kGI][2];
#pragma unroll
        for (int u = 0; u < kEU; ++u) {
          const long long b = b0 + e0 + u * kEStep;
          if (pv && b < b_end) {
            const uint4* ri = reinterpret_cast<const uint4*>(in_row<bf>(a, i, b) + j * kD);
            const uint4* rj = reinterpret_cast<const uint4*>(in_row<bf>(a, j, b) + i * kD);
            va[u][0] = __ldg(ri);
            va[u][1] = __ldg(ri + 1);
            vb[u][0] = __ldg(rj);
            vb[u][1] = __ldg(rj + 1);
          } else {
            va[u][0] = va[u][1] = vb[u][0] = vb[u][1] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int n = 0; n < kGI; ++n) {
          const int item = pt + n * 128;
          const int e = item / a.c1;
          const long long b = b0 + e;
          if (item < kNE * a.c1 && b < b_end) {
            const uint4* src = reinterpret_cast<const uint4*>(gg + (b * a.c1 + item % a.c1) * kD);
            gv[n][0] = __ldg(src);
            gv[n][1] = __ldg(src + 1);
          } else {
            gv[n][0] = gv[n][1] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        // the next tile's rows into L2 while this one's loads are in flight
        if (tile + 1 < t_end) {
#pragma unroll
          for (int u = 0; u < kEU; ++u) {
            const long long b = b0 + kNE + e0 + u * kEStep;
            if (pv && b < b_end) {
              prefetch_l2(in_row<bf>(a, i, b) + j * kD);
              prefetch_l2(in_row<bf>(a, j, b) + i * kD);
            }
          }
        }
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        // the chunk's pair table; its buffer's last reader, two chunks back,
        // released this stage or an earlier one
        if (tile == t_begin && pt < kPC)
          pij[(q & 1) * kPC + pc] = pv ? static_cast<uint16_t>((i << 8) | j) : 0xFFFFu;
        unsigned char* gw = ring + s * L::kStageBytes;
        unsigned char* ms = gw + L::kGBytes;
        unsigned char* fa = ms + L::kMBytes;
        unsigned char* fb = fa + L::kMBytes;
#pragma unroll
        for (int u = 0; u < kEU; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = ((pc / 8) * kCG8 + 2 * (e0 + u * kEStep) + h) * 128 + (pc % 8) * 16;
            *reinterpret_cast<uint4*>(ms + off) = mul8(va[u][h], vb[u][h]);
            *reinterpret_cast<uint4*>(fa + off) = va[u][h];
            *reinterpret_cast<uint4*>(fb + off) = vb[u][h];
          }
        }
#pragma unroll
        for (int n = 0; n < kGI; ++n) {
          const int item = pt + n * 128;
          if (item < kNE * a.c1) {
            const uint32_t w8[8] = {gv[n][0].x, gv[n][0].y, gv[n][0].z, gv[n][0].w,
                                    gv[n][1].x, gv[n][1].y, gv[n][1].z, gv[n][1].w};
            store_taps<K, 0>(gw, w8, item % a.c1, a.c1, item / a.c1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + s);
        if (pt == 0 && tile == t_begin) {
          // the chunk's A^T, once the consumers are done with the previous one
          if (q > 0) mbar_wait(a_empty, (q - 1) & 1);
          mbar_arrive_tx(a_full, L::kABytes);
          bulk_copy(at, wsrc + static_cast<size_t>(q) * L::kABytes, L::kABytes, a_full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns pairs [wg * kPW, (wg + 1) * kPW) of each chunk
  const int ct = tid % 128;
  const int warp = ct / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rows = K * a.c1;
  unsigned char* dmw = dms + wg * (L::kMBytes / 2);
  float acc_w[MT][kPW / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < kPW / 2; ++r) acc_w[mt][r] = 0.f;
    wg_pin<kPW / 2>(acc_w[mt]);
  }
  uint32_t it = 0;
  for (int q = 0; q < nq; ++q) {
    mbar_wait(a_full, q & 1);
    const uint16_t* pq = pij + (q & 1) * kPC;
    for (int tile = t_begin; tile < t_end; ++tile, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const unsigned char* gw = ring + s * L::kStageBytes;
      const unsigned char* ms = gw + L::kGBytes;
      const unsigned char* fa = ms + L::kMBytes;
      const unsigned char* fb = fa + L::kMBytes;
      float acc_m[kPW / 2];
#pragma unroll
      for (int r = 0; r < kPW / 2; ++r) acc_m[r] = 0.f;
      wg_pin<kPW / 2>(acc_m);
      wg_fence();
      // dM^T ((b, x), p) = Gwin^T * A: Gwin MN-major, A^T K-major
#pragma unroll
      for (int ks = 0; ks < L::kRP / 16; ++ks)
        wgmma_bf16<kPW, 1>(acc_m, wg_desc(gw + 2 * ks * kCG8 * 128, kCG8 * 128, 128),
                           wg_desc(at + ((wg * kPW / 8) * L::kRG + 2 * ks) * 128, 128,
                                   L::kRG * 128));
      wg_commit();
      // dW_stack (r, p) += Gwin * M^T: Gwin K-major, M K-major
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < kCols / 16; ++ks)
          wgmma_bf16<kPW, 0>(acc_w[mt], wg_desc(gw + (8 * mt * kCG8 + 2 * ks) * 128, 128,
                                                kCG8 * 128),
                             wg_desc(ms + ((wg * kPW / 8) * kCG8 + 2 * ks) * 128, 128,
                                     kCG8 * 128));
      wg_commit();
      wg_wait<1>();
      wg_pin<kPW / 2>(acc_m);
      // dM rounded to bf16 into this warpgroup's staging, [pair][(b, x)]:
      // row (b, x) = (warp, gid + 8h), column pair 8jj + 2tig + e
      named_sync(1 + wg, 128);  // the previous tile's dE lanes have read it
#pragma unroll
      for (int jj = 0; jj < kPW / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<bf*>(dmw + (jj * kCG8 + 2 * warp + h) * 128 + (2 * tig + e) * 16 +
                                   gid * 2) = __float2bfloat16_rn(acc_m[jj * 4 + h * 2 + e]);
      named_sync(1 + wg, 128);
      // dE, 8 lanes per item: item = ((pair group, example), half, pair % 8)
      for (int u = ct; u < kPW * kNE * 2; u += 128) {
        const int p8 = u & 7, h = (u >> 3) & 1, e = (u >> 4) & (kNE - 1);
        const int pgl = u >> 6;
        const int pcn = wg * kPW + pgl * 8 + p8;  // pair within the chunk
        const uint16_t ij = pq[pcn];
        const long long b = static_cast<long long>(tile) * kNE + e;
        if (ij == 0xFFFFu || b >= b_end) continue;
        const int i = ij >> 8, j = ij & 0xFF;
        const int cg = 2 * e + h;
        const uint4 dm = *reinterpret_cast<const uint4*>(dmw + (pgl * kCG8 + cg) * 128 + p8 * 16);
        const int off = ((pcn / 8) * kCG8 + cg) * 128 + (pcn % 8) * 16;
        const uint4 xa = *reinterpret_cast<const uint4*>(fa + off);  // E[b, i, 16j + x]
        const uint4 xb = *reinterpret_cast<const uint4*>(fb + off);  // E[b, j, 16i + x]
        *reinterpret_cast<uint4*>(out_row<bf>(a, i, b) + j * kD + h * 8) = mul8(dm, xb);
        *reinterpret_cast<uint4*>(out_row<bf>(a, j, b) + i * kD + h * 8) = mul8(dm, xa);
      }
      // the tile's diagonal blocks and pad lanes, once
      if (q == 0)
        diag_and_pads16(a, static_cast<long long>(tile) * kNE,
                        min(b_end, static_cast<long long>(tile) * kNE + kNE), tid, 2 * 128);
      wg_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wg_pin<kPW / 2>(acc_w[mt]);
      mbar_arrive(empty + s);
    }
    mbar_arrive(a_empty);
    // this block's dW partial for the chunk: row r = t*C1 + c, pair p
    float* out = a.dwp + static_cast<long long>(blockIdx.x) * K * pairs * a.c1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int jj = 0; jj < kPW / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 64 + warp * 16 + gid + 8 * h;
            const int p = q * kPC + wg * kPW + jj * 8 + 2 * tig + e;
            float& v = acc_w[mt][jj * 4 + h * 2 + e];
            if (r < rows && p < pairs) {
              const int t = r / a.c1;
              out[(static_cast<long long>(t) * pairs + p) * a.c1 + (r - t * a.c1)] = v;
            }
            v = 0.f;
          }
      wg_pin<kPW / 2>(acc_w[mt]);
    }
  }
}

// dw[i] = sum over blocks of dwp[blk, i], in block order
__global__ void sum_partials_kernel(const float* dwp, float* dw, int blocks, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += dwp[blk * n + i];
  dw[i] = s;
}

int examples_per_block(int batch) {
  const int groups = (batch + kEB - 1) / kEB;
  const int per_block = (groups + kTargetBlocks - 1) / kTargetBlocks;
  return kEB * (per_block < 1 ? 1 : per_block);
}

// Taps per slice of the CUDA-core kernel: all of them for an unrolled
// width, kRT for any other odd k.
int taps_per_slice(int k) { return k <= kMaxUnrolled ? k : kRT; }

// Dynamic shared memory of the CUDA-core kernel, f32, at cc channels per
// slice: the weight slice, g's slice and the cross map with their halos,
// the two factors and, for hadamard, dM.
size_t core_smem(int d, int k, int cc, int hadamard) {
  const size_t xp = (d + kTN - 1) / kTN * kTN + k - 1;
  return (static_cast<size_t>(taps_per_slice(k)) * cc * kPC + kEB * xp * cc + kEB * kPC * xp +
          (hadamard ? 3 : 2) * static_cast<size_t>(kEB) * kPC * d) *
         sizeof(float);
}

// Channels per slice: the most, a multiple of kCG up to kMaxCC, whose
// shared memory fits the card's limit less the static pair tables; 0 if
// none does.
int core_channels(int d, int k, int c1, int hadamard) {
  const int most = (c1 + kCG - 1) / kCG * kCG;
  for (int cc = most < kMaxCC ? most : kMaxCC; cc >= kCG; cc -= kCG)
    if (core_smem(d, k, cc, hadamard) <= static_cast<size_t>(kSmemMax - 2 * kPC * 4)) return cc;
  return 0;
}

// The shapes the CUDA-core kernel takes, and so the backward as a whole
// (the wgmma kernel takes a subset): every odd k, any C1, and a slice of
// at least kCG channels within shared memory.
bool core_takes(int d, int k, int c1, int hadamard) {
  return k >= 1 && k % 2 == 1 && d >= 1 && c1 >= 1 && core_channels(d, k, c1, hadamard) > 0;
}

template <typename T, int KT>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = core_smem(a.d, a.k, a.cc, a.hadamard);
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_bwd_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cross_conv1_bwd_kernel<T, KT><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const Args& a, int blocks, cudaStream_t stream) {
  switch (taps_per_slice(a.k)) {
    case 1: return launch<T, 1>(a, blocks, stream);
    case 3: return launch<T, 3>(a, blocks, stream);
    case 5: return launch<T, 5>(a, blocks, stream);
    case 7: return launch<T, 7>(a, blocks, stream);
    case 9: return launch<T, 9>(a, blocks, stream);
    case kRT: return launch<T, kRT>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// SMs of the current device, asked once per device
cudaError_t sm_count(int* sms) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cache[dev] == 0) {
    err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// The wgmma kernel's persistent grid: at most one block per SM, each a
// contiguous range of tpb tiles, none empty.
struct WgGrid {
  int blocks, tpb, ntiles;
};

cudaError_t wg_grid(int batch, WgGrid* g) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  g->ntiles = (batch + kNE - 1) / kNE;
  const int first = g->ntiles < sms ? g->ntiles : sms;
  g->tpb = first > 0 ? (g->ntiles + first - 1) / first : 1;
  g->blocks = (g->ntiles + g->tpb - 1) / g->tpb;
  return cudaSuccess;
}

template <int K, int MT>
cudaError_t launch_wgmma(const Args& a, const WgGrid& g, cudaStream_t stream) {
  using L = BwdLayout<MT>;
  const cudaError_t err =
      cudaFuncSetAttribute(cross_conv1_bwd_wgmma_kernel<K, MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  cross_conv1_bwd_wgmma_kernel<K, MT><<<g.blocks, kWgThreads, L::kSmem, stream>>>(a, g.tpb,
                                                                                 g.ntiles);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_wgmma_mt(const Args& a, const WgGrid& g, cudaStream_t stream) {
  constexpr int kMax = wg_max_mtiles(K);
  switch (wg_mtiles(K, a.c1)) {
    case 1: return launch_wgmma<K, 1>(a, g, stream);
    case 2: if constexpr (kMax >= 2) return launch_wgmma<K, 2>(a, g, stream); break;
    case 3: if constexpr (kMax >= 3) return launch_wgmma<K, 3>(a, g, stream); break;
    case 4: if constexpr (kMax >= 4) return launch_wgmma<K, 4>(a, g, stream); break;
    case 5: if constexpr (kMax >= 5) return launch_wgmma<K, 5>(a, g, stream); break;
    case 6: if constexpr (kMax >= 6) return launch_wgmma<K, 6>(a, g, stream); break;
    case 7: if constexpr (kMax >= 7) return launch_wgmma<K, 7>(a, g, stream); break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_wgmma_k(const Args& a, int k, const WgGrid& g, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_wgmma_mt<1>(a, g, stream);
    case 3: return launch_wgmma_mt<3>(a, g, stream);
    case 5: return launch_wgmma_mt<5>(a, g, stream);
    case 7: return launch_wgmma_mt<7>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core path reads rows and g with 16-byte loads and writes dE
// with 16-byte stores.
bool wgmma_path(const Args& a, int is_bf16, int k) {
  const long long strides[] = {a.fs0, a.bs0, a.fs1, a.bs1, a.dfs0, a.dbs0, a.dfs1, a.dbs1};
  for (long long st : strides)
    if (st % 8 != 0) return false;
  return is_bf16 && !a.hadamard && a.d == kD && a.fields <= kMaxWgFields &&
         (k == 1 || k == 3 || k == 5 || k == 7) && wg_mtiles(k, a.c1) <= wg_max_mtiles(k) &&
         aligned16(a.e0) && aligned16(a.e1) && aligned16(a.de0) && aligned16(a.de1) &&
         aligned16(a.g);
}

Args make_args(const void* e0, const void* e1, int nf0, long long fs0, long long bs0,
               long long fs1, long long bs1, void* de0, void* de1, long long dfs0,
               long long dbs0, long long dfs1, long long dbs1, const void* g, int fields,
               int d, int k, int c1, int hadamard) {
  Args a = {};
  a.e0 = e0;
  a.e1 = e1;
  a.nf0 = nf0;
  a.fs0 = fs0;
  a.bs0 = bs0;
  a.fs1 = fs1;
  a.bs1 = bs1;
  a.de0 = de0;
  a.de1 = de1;
  a.dfs0 = dfs0;
  a.dbs0 = dbs0;
  a.dfs1 = dfs1;
  a.dbs1 = dbs1;
  a.g = g;
  a.fields = fields;
  a.d = d;
  a.k = k;
  a.c1 = c1;
  a.hadamard = hadamard;
  a.ngx = (d + kTN - 1) / kTN;
  a.xp = a.ngx * kTN + k - 1;
  a.cc = core_channels(d, k, c1, hadamard);
  a.ncs = a.cc > 0 ? (c1 + a.cc - 1) / a.cc : 0;
  a.nts = (k + taps_per_slice(k) - 1) / taps_per_slice(k);
  return a;
}

}  // namespace

extern "C" {

// 1 when these rows take the tensor-core (wgmma) kernel, whose weight
// operand is interaction_conv.bwd_wgmma_weights' layout with
// cffm_cross_conv1_bwd_pair_chunk pairs per chunk; 0 for the CUDA-core
// kernel, whose weight operand is (k, c1, P).
int cffm_cross_conv1_bwd_wgmma(int is_bf16, const void* e0, const void* e1, long long fs0,
                               long long bs0, long long fs1, long long bs1, const void* de0,
                               const void* de1, long long dfs0, long long dbs0, long long dfs1,
                               long long dbs1, const void* g, int fields, int d, int k, int c1,
                               int hadamard) {
  const Args a = make_args(e0, e1, 0, fs0, bs0, fs1, bs1, const_cast<void*>(de0),
                           const_cast<void*>(de1), dfs0, dbs0, dfs1, dbs1, g, fields, d, k, c1,
                           hadamard);
  return wgmma_path(a, is_bf16, k) ? 1 : 0;
}

// Pairs per chunk of the wgmma kernel's weight operand at (k, c1).
int cffm_cross_conv1_bwd_pair_chunk(int k, int c1) { return 2 * wg_pairs(wg_mtiles(k, c1)); }

// Number of blocks (rows of the dW partial buffer) for a batch on a route,
// or -1 on a CUDA error.
int cffm_cross_conv1_bwd_blocks(int batch, int wgmma) {
  if (wgmma) {
    WgGrid g;
    return wg_grid(batch, &g) == cudaSuccess ? g.blocks : -1;
  }
  const int ebl = examples_per_block(batch);
  return (batch + ebl - 1) / ebl;
}

// 1 when the backward takes layer 1 at (d, k, c1, hadamard): the
// CUDA-core kernel takes every shape the wgmma kernel does, and more.
int cffm_cross_conv1_bwd_takes(int d, int k, int c1, int hadamard) {
  return core_takes(d, k, c1, hadamard) ? 1 : 0;
}

// f32 elements of the dmacc scratch per example the CUDA-core kernel
// needs at (d, k, c1, hadamard): 0 when it runs layer 1 in one slice.
int cffm_cross_conv1_bwd_dm_scratch(int d, int k, int c1, int hadamard) {
  const Args a = make_args(nullptr, nullptr, 0, 0, 0, 0, 0, nullptr, nullptr, 0, 0, 0, 0,
                           nullptr, 2, d, k, c1, hadamard);
  return a.ncs * a.nts > 1 ? kPC * d : 0;
}

// Returns a cudaError_t; 0 means both kernels were launched. wgmma says
// which kernel and weight layout, and must be what cffm_cross_conv1_bwd_wgmma
// says. w: (k, c1, P) in T for the CUDA-core kernel, bwd_wgmma_weights'
// layout for the wgmma kernel; g: (batch, c1, d) in T; dwp: (blocks, k, P,
// c1) f32 scratch, blocks from cffm_cross_conv1_bwd_blocks; dw: (k, P, c1)
// f32 out; hacc: (batch, fields, d) f32 scratch for hadamard, else null;
// dmacc: (batch, cffm_cross_conv1_bwd_dm_scratch) f32 scratch for the
// CUDA-core kernel when that is not 0, else null.
int cffm_cross_conv1_bwd(int is_bf16, int wgmma, const void* e0, const void* e1, int nf0,
                         long long fs0, long long bs0, long long fs1, long long bs1,
                         void* de0, void* de1, long long dfs0, long long dbs0,
                         long long dfs1, long long dbs1, const void* w, const void* g,
                         const float* glin, float* hacc, float* dmacc, float* dwp, float* dw,
                         int batch, int fields, int d, int k, int c1, int hadamard,
                         int lin_col, int w_phys, void* stream) {
  Args a = make_args(e0, e1, nf0, fs0, bs0, fs1, bs1, de0, de1, dfs0, dbs0, dfs1, dbs1, g,
                     fields, d, k, c1, hadamard);
  a.w = w;
  a.glin = glin;
  a.hacc = hacc;
  a.dmacc = dmacc;
  a.dwp = dwp;
  a.batch = batch;
  a.lin_col = lin_col;
  a.w_phys = w_phys;
  a.ebl = examples_per_block(batch);
  if (fields < 2 || !core_takes(d, k, c1, hadamard) ||
      (hadamard && hacc == nullptr) || wgmma != (wgmma_path(a, is_bf16, k) ? 1 : 0) ||
      (!wgmma && a.ncs * a.nts > 1 && dmacc == nullptr) ||
      (wgmma && glin != nullptr && (lin_col % 8 != 0 || w_phys % 8 != 0)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  if (batch > 0) {
    cudaError_t err;
    if (wgmma) {
      WgGrid grid;
      if ((err = wg_grid(batch, &grid)) != cudaSuccess) return err;
      blocks = grid.blocks;
      err = launch_wgmma_k(a, k, grid, s);
    } else {
      blocks = cffm_cross_conv1_bwd_blocks(batch, 0);
      err = is_bf16 ? launch_k<__nv_bfloat16>(a, blocks, s) : launch_k<float>(a, blocks, s);
    }
    if (err != cudaSuccess) return err;
  }
  const long long n = static_cast<long long>(k) * fields * (fields - 1) / 2 * c1;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(dwp, dw, blocks, n);
  return cudaGetLastError();
}

}  // extern "C"
