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
//
// Design. A block owns a contiguous range of examples and walks the pair
// axis in chunks of kPC pairs. Per chunk it stages the weight chunk, then
// for each group of kEB examples stages g (halo-padded) and rebuilds the
// chunk's cross map and its two factors in shared memory, so M never
// reaches device memory. Two products share those tiles:
//   dW: per pair tile, channels x taps, accumulated in registers across all
//       the block's example groups, and written once per chunk as this
//       block's f32 partial;
//   dM: per example, then dE straight from registers (field-aware) or an
//       f32 accumulator pass over (example, field, position) (hadamard).
// The dW partials (blocks, K, P, C1) are summed by a second kernel, one
// thread per weight, in block order: deterministic, no atomics.
// Two kernels share that walk. Field-aware bf16 rows with d=16 and C1<=64
// (the criteo_kaggle training path) take cross_conv1_bwd_mma_kernel: both
// products as bf16 mma.sync tiles with f32 sums, every staged tile in
// bf16, two blocks per SM. Everything else (f32, hadamard, other shapes)
// takes cross_conv1_bwd_kernel: FMAs on the CUDA cores, f32 tiles.
//
// Bound on the H100. At criteo_kaggle shapes (F=39, d=16, W=640, C1=64,
// k=3, bf16) dW and dM each take 2*d*P*k*C1 = 4.55 MFLOP per example
// (298 GFLOP each at B=65536) against ~100 KB of E, dE and g moved: about
// 90 FLOP per byte, so on paper the function is memory-bound (2.0 ms at
// B=65536). The CUDA-core kernel is bound by FP32 issue and by the latency
// of one 129 KB block per SM; the tensor-core kernel by its staging of g
// and M per chunk and by synchronisation. Left on the table: wgmma with
// TMA-fed tiles, staging g once per example group instead of per chunk,
// and fusing the forward's cross build with this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPC = 32;      // pairs per chunk
constexpr int kEB = 8;       // examples per group (kEB * kPC == kThreads)
constexpr int kCG = 8;       // channels per dW thread
constexpr int kTN = 8;       // positions per dM step
constexpr int kThreads = 256;
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
  int batch, fields, d, c1, c1p, hadamard, lin_col, w_phys;
  int ebl, xp, ngx;        // examples per block, padded row, position groups
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) cross_conv1_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // (K, c1p, kPC)
  float* gs = ws + K * a.c1p * kPC;              // (kEB, xp, c1p), halo k/2
  float* ms = gs + kEB * a.xp * a.c1p;           // (kEB, kPC, xp), halo k/2
  float* fa = ms + kEB * kPC * a.xp;             // (kEB, kPC, d): E side i
  float* fb = fa + kEB * kPC * a.d;              // (kEB, kPC, d): E side j
  float* dms = fb + kEB * kPC * a.d;             // (kEB, kPC, d): dM (hadamard)
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  constexpr int kHalf = K / 2;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int tid = threadIdx.x;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  // dW role: one pair, kCG channels
  const int ncg = a.c1p / kCG;
  const int wpc = tid / ncg;
  const int wcg = tid - wpc * ncg;
  // dM role: one (example, pair)
  const int me = tid / kPC;
  const int mpc = tid - me * kPC;

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
    const T* wg = static_cast<const T*>(a.w);
    for (int u = tid; u < K * a.c1p * kPC; u += kThreads) {
      const int t = u / (a.c1p * kPC);
      const int r = u - t * a.c1p * kPC;
      const int c = r / kPC;
      const int pc = r - c * kPC;
      ws[u] = (c < a.c1 && pc < npc)
                  ? to_f(wg[(static_cast<long long>(t) * a.c1 + c) * pairs + p0 + pc])
                  : 0.f;
    }

    float acc[kCG][K];
#pragma unroll
    for (int ci = 0; ci < kCG; ++ci)
#pragma unroll
      for (int t = 0; t < K; ++t) acc[ci][t] = 0.f;

    for (long long b0 = b_begin; b0 < b_end; b0 += kEB) {
      __syncthreads();  // previous group's tiles (and the pair tables) settled
      // g, halo-padded, channels innermost
      const T* gg = static_cast<const T*>(a.g);
      for (int u = tid; u < kEB * a.xp * a.c1p; u += kThreads) {
        const int e = u / (a.xp * a.c1p);
        const int r = u - e * a.xp * a.c1p;
        const int q = r / a.c1p;
        const int c = r - q * a.c1p;
        const int x = q - kHalf;
        const long long b = b0 + e;
        gs[u] = (b < b_end && x >= 0 && x < a.d && c < a.c1)
                    ? to_f(gg[(b * a.c1 + c) * a.d + x])
                    : 0.f;
      }
      // cross map chunk and its factors
      for (int u = tid; u < kEB * kPC * a.xp; u += kThreads) {
        const int e = u / (kPC * a.xp);
        const int r = u - e * kPC * a.xp;
        const int pc = r / a.xp;
        const int x = r - pc * a.xp - kHalf;
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

      // dW: acc[ci][t] += g[e, c0+ci, x] * M[e, wpc, x+t-k/2]
      if (wpc < npc) {
        for (int e = 0; e < kEB && b0 + e < b_end; ++e) {
          const float* mrow = ms + (e * kPC + wpc) * a.xp;
          const float* grow = gs + e * a.xp * a.c1p + wcg * kCG;
          for (int x = 0; x < a.d; ++x) {
            const float4 g0 = *reinterpret_cast<const float4*>(grow + (x + kHalf) * a.c1p);
            const float4 g1 = *reinterpret_cast<const float4*>(grow + (x + kHalf) * a.c1p + 4);
            const float gv[kCG] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
            for (int t = 0; t < K; ++t) {
              const float mv = mrow[x + t];
#pragma unroll
              for (int ci = 0; ci < kCG; ++ci) acc[ci][t] = fmaf(gv[ci], mv, acc[ci][t]);
            }
          }
        }
      }

      // dM: dm[n] = sum_c sum_t W[t,c,mpc] * gs[me, x0+n-t+2*(k/2), c]
      const long long mb = b0 + me;
      const bool mactive = mpc < npc && mb < b_end;
      for (int xg = 0; xg < a.ngx; ++xg) {
        float dm[kTN];
#pragma unroll
        for (int n = 0; n < kTN; ++n) dm[n] = 0.f;
        if (mactive) {
          const float* gwin = gs + (me * a.xp + xg * kTN) * a.c1p;
          for (int c = 0; c < a.c1; ++c) {
            float wv[K];
#pragma unroll
            for (int t = 0; t < K; ++t) wv[t] = ws[(t * a.c1p + c) * kPC + mpc];
            float gw[kTN + K - 1];
#pragma unroll
            for (int q = 0; q < kTN + K - 1; ++q) gw[q] = gwin[q * a.c1p + c];
#pragma unroll
            for (int t = 0; t < K; ++t)
#pragma unroll
              for (int n = 0; n < kTN; ++n) dm[n] = fmaf(wv[t], gw[n + K - 1 - t], dm[n]);
          }
        }
        if (!mactive) continue;
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

      if (a.hadamard) {
        __syncthreads();
        // one thread per (example, field, position): sums in pair order
        const bool last = p0 + kPC >= pairs;
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
          if (last) {
            out_row<T>(a, f, b)[x] = from_f<T>(s);
          } else {
            *h = s;
          }
        }
      }
    }

    if (wpc < npc) {
      float* out = a.dwp + static_cast<long long>(blockIdx.x) * K * pairs * a.c1;
#pragma unroll
      for (int t = 0; t < K; ++t)
#pragma unroll
        for (int ci = 0; ci < kCG; ++ci) {
          const int c = wcg * kCG + ci;
          if (c < a.c1) out[(static_cast<long long>(t) * pairs + p0 + wpc) * a.c1 + c] = acc[ci][t];
        }
    }
    __syncthreads();  // pair tables are rewritten by the next chunk
  }

  if (!a.hadamard) diag_and_pads<T>(a, b_begin, b_end);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: field-aware, d == 16, C1 <= 64, 16-byte aligned rows.
//
// Same block walk (pair chunks outside, example groups inside) and the same
// outputs; the two products run as mma.sync.m16n8k16 (bf16 in, f32 sums):
//   dW: per example and tap, M[p, x+t-k/2] (16 pairs x 16 positions: d is
//       exactly one k-step) times g[c, x] (16 positions x 8 channels); each
//       warp owns 16 pairs x 16 channels x K taps, summed over the block;
//   dM: per example, W[(t, c), p] (16 pairs x 16 channels) times
//       g[c, x-t+k/2] (16 channels x 8 positions), over K taps and C1.
// Every staged tile is bf16 (the values are bf16 anyway, so exactly), which
// halves shared memory against the CUDA-core kernel: two blocks per SM. The
// cross map is staged twice, at even and odd offsets, so every fragment
// load of a shifted tap is an aligned 32-bit load.
// ---------------------------------------------------------------------------

constexpr int kD = 16;     // embed dim of this path
constexpr int kRow = 24;   // bf16 row stride of the 16-wide tiles (bank spread)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int mma_c16(int c1) { return (c1 + 15) / 16 * 16; }

// bf16 elements of shared memory the tensor-core kernel needs
__host__ __device__ constexpr long long mma_smem_elems(int k, int c1) {
  return static_cast<long long>(k) * kPC * (mma_c16(c1) + 8) +          // W chunk
         static_cast<long long>(kEB) * mma_c16(c1) * kRow +               // g, x-contiguous
         static_cast<long long>(kEB) * (kD + k - 1) * (mma_c16(c1) + 8) +  // g, c-contiguous
         4LL * kEB * kPC * kRow;                                          // M even/odd, factors
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2) cross_conv1_bwd_mma_kernel(Args a) {
  using bf = __nv_bfloat16;
  constexpr int kHalf = K / 2;
  constexpr int kQ = kD + 2 * kHalf;       // halo-padded positions
  extern __shared__ float4 smem4[];
  const int c16 = mma_c16(a.c1);
  const int wrow = c16 + 8;                // row stride of ws and gm
  bf* ws = reinterpret_cast<bf*>(smem4);   // [t][p][c] = W1[c, p0+p, t]
  bf* gw = ws + K * kPC * wrow;            // [e][c][x] = g[b, c, x]
  bf* gm = gw + kEB * c16 * kRow;          // [e][q][c] = g[b, c, q - k/2]
  bf* me = gm + kEB * kQ * wrow;           // [e][p][q] = M[b, p, q - k/2]
  bf* mo = me + kEB * kPC * kRow;          // [e][p][q] = M[b, p, q + 1 - k/2]
  bf* fa = mo + kEB * kPC * kRow;          // [e][p][x] = E[b, i, j*d + x]
  bf* fb = fa + kEB * kPC * kRow;          // [e][p][x] = E[b, j, i*d + x]
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  const int pairs = a.fields * (a.fields - 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  const int wpt = warp >> 2;               // dW: pair tile of this warp
  const int wct = (warp & 3) * 2;          // dW: first of its two channel tiles
  const bf zero = __float2bfloat16_rn(0.f);

  // halos and pads stay zero: the staging below writes interiors only
  {
    const long long n16 = mma_smem_elems(K, a.c1) / 8;
    for (long long u = tid; u < n16; u += kThreads) smem4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int p0 = 0; p0 < pairs; p0 += kPC) {
    const int npc = min(kPC, pairs - p0);
    __syncthreads();
    if (tid < kPC) {
      int i = 0, rem = p0 + tid;
      while (i < a.fields - 1 && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      pi_s[tid] = i;
      pj_s[tid] = i + 1 + rem;
    }
    const bf* wg = static_cast<const bf*>(a.w);
    for (int u = tid; u < K * c16 * kPC; u += kThreads) {
      const int p = u % kPC;
      const int r = u / kPC;
      const int c = r % c16;
      const int t = r / c16;
      ws[(t * kPC + p) * wrow + c] =
          (c < a.c1 && p < npc) ? wg[(static_cast<long long>(t) * a.c1 + c) * pairs + p0 + p] : zero;
    }

    float acc[2][K][4];
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
#pragma unroll
      for (int t = 0; t < K; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ct][t][r] = 0.f;

    for (long long b0 = b_begin; b0 < b_end; b0 += kEB) {
      __syncthreads();  // previous group's tiles are consumed
      const bf* gg = static_cast<const bf*>(a.g);
      for (int u = tid; u < kEB * c16 * 2; u += kThreads) {
        const int e = u / (c16 * 2);
        const int r = u - e * c16 * 2;
        const int c = r >> 1, hf = r & 1;
        const long long b = b0 + e;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (b < b_end && c < a.c1)
          v = *reinterpret_cast<const uint4*>(gg + (b * a.c1 + c) * kD + hf * 8);
        *reinterpret_cast<uint4*>(gw + (e * c16 + c) * kRow + hf * 8) = v;
        const bf* vv = reinterpret_cast<const bf*>(&v);
#pragma unroll
        for (int n = 0; n < 8; ++n) gm[(e * kQ + kHalf + hf * 8 + n) * wrow + c] = vv[n];
      }
      for (int u = tid; u < kEB * kPC * 2; u += kThreads) {
        const int e = u / (kPC * 2);
        const int r = u - e * kPC * 2;
        const int pc = r >> 1, x0 = (r & 1) * 8;
        const long long b = b0 + e;
        uint4 ua = make_uint4(0u, 0u, 0u, 0u), ub = ua;
        if (pc < npc && b < b_end) {
          const int i = pi_s[pc], j = pj_s[pc];
          ua = *reinterpret_cast<const uint4*>(in_row<bf>(a, i, b) + j * kD + x0);
          ub = *reinterpret_cast<const uint4*>(in_row<bf>(a, j, b) + i * kD + x0);
        }
        const int o = (e * kPC + pc) * kRow;
        *reinterpret_cast<uint4*>(fa + o + x0) = ua;
        *reinterpret_cast<uint4*>(fb + o + x0) = ub;
        const bf* av = reinterpret_cast<const bf*>(&ua);
        const bf* bv = reinterpret_cast<const bf*>(&ub);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const bf m = __float2bfloat16_rn(__bfloat162float(av[n]) * __bfloat162float(bv[n]));
          const int q = kHalf + x0 + n;
          me[o + q] = m;
          if (q >= 1) mo[o + q - 1] = m;
        }
      }
      __syncthreads();

      // dW += M_t^T-tiles x g-tiles, per example and tap
      for (int e = 0; e < kEB && b0 + e < b_end; ++e) {
        const bf* gwe = gw + e * c16 * kRow;
        uint32_t bw[2][2];
        bool ok[2];
#pragma unroll
        for (int ct = 0; ct < 2; ++ct) {
          ok[ct] = (wct + ct) * 8 < c16;
          const bf* row = gwe + ((ok[ct] ? wct + ct : 0) * 8 + gid) * kRow + 2 * tig;
          bw[ct][0] = ld32(row);
          bw[ct][1] = ld32(row + 8);
        }
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const bf* m = ((t & 1) ? mo : me) + (e * kPC + wpt * 16) * kRow + (t & ~1) + 2 * tig;
          const uint32_t a0 = ld32(m + gid * kRow), a1 = ld32(m + (gid + 8) * kRow);
          const uint32_t a2 = ld32(m + gid * kRow + 8), a3 = ld32(m + (gid + 8) * kRow + 8);
#pragma unroll
          for (int ct = 0; ct < 2; ++ct)
            if (ok[ct]) mma_bf16(acc[ct][t], a0, a1, a2, a3, bw[ct][0], bw[ct][1]);
        }
      }

      // dM for example `warp`, then its dE products straight from registers
      const long long b = b0 + warp;
      if (b < b_end) {
        const bf* gme = gm + warp * kQ * wrow;
        for (int mt = 0; mt < 2 && mt * 16 < npc; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int t = 0; t < K; ++t) {
              const bf* wt = ws + (t * kPC + mt * 16) * wrow + 2 * tig;
              const bf* gq = gme + (nt * 8 + gid - t + 2 * kHalf) * wrow + 2 * tig;
              for (int cc = 0; cc < c16; cc += 16) {
                mma_bf16(d4, ld32(wt + gid * wrow + cc), ld32(wt + (gid + 8) * wrow + cc),
                         ld32(wt + gid * wrow + cc + 8), ld32(wt + (gid + 8) * wrow + cc + 8),
                         ld32(gq + cc), ld32(gq + cc + 8));
              }
            }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int p = mt * 16 + gid + rr * 8;
              if (p >= npc) continue;
              const int x = nt * 8 + 2 * tig;
              const int i = pi_s[p], j = pj_s[p];
              const float dm0 = round_t<bf>(d4[rr * 2]), dm1 = round_t<bf>(d4[rr * 2 + 1]);
              const bf* fav = fa + (warp * kPC + p) * kRow + x;
              const bf* fbv = fb + (warp * kPC + p) * kRow + x;
              *reinterpret_cast<__nv_bfloat162*>(out_row<bf>(a, i, b) + j * kD + x) =
                  __floats2bfloat162_rn(dm0 * __bfloat162float(fbv[0]),
                                        dm1 * __bfloat162float(fbv[1]));
              *reinterpret_cast<__nv_bfloat162*>(out_row<bf>(a, j, b) + i * kD + x) =
                  __floats2bfloat162_rn(dm0 * __bfloat162float(fav[0]),
                                        dm1 * __bfloat162float(fav[1]));
            }
          }
        }
      }
    }

    // this block's dW partial for the chunk
    float* out = a.dwp + static_cast<long long>(blockIdx.x) * K * pairs * a.c1;
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
#pragma unroll
      for (int t = 0; t < K; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = wpt * 16 + gid + (r >> 1) * 8;
          const int c = (wct + ct) * 8 + 2 * tig + (r & 1);
          if (p < npc && c < a.c1)
            out[(static_cast<long long>(t) * pairs + p0 + p) * a.c1 + c] = acc[ct][t][r];
        }
  }
  diag_and_pads<__nv_bfloat16>(a, b_begin, b_end);
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

template <typename T, int K>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(K) * a.c1p * kPC +
                       static_cast<size_t>(kEB) * a.xp * a.c1p +
                       static_cast<size_t>(kEB) * kPC * a.xp +
                       3 * static_cast<size_t>(kEB) * kPC * a.d) *
                      sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cross_conv1_bwd_kernel<T, K><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const Args& a, int k, int blocks, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(a, blocks, stream);
    case 3: return launch<T, 3>(a, blocks, stream);
    case 5: return launch<T, 5>(a, blocks, stream);
    case 7: return launch<T, 7>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t launch_mma(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(mma_smem_elems(K, a.c1)) * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_bwd_mma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cross_conv1_bwd_mma_kernel<K><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma_k(const Args& a, int k, int blocks, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_mma<1>(a, blocks, stream);
    case 3: return launch_mma<3>(a, blocks, stream);
    case 5: return launch_mma<5>(a, blocks, stream);
    case 7: return launch_mma<7>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core path reads rows and g with 16-byte loads.
bool mma_path(const Args& a, int is_bf16) {
  const long long strides[] = {a.fs0, a.bs0, a.fs1, a.bs1, a.dfs0, a.dbs0, a.dfs1, a.dbs1};
  for (long long st : strides)
    if (st % 8 != 0) return false;
  return is_bf16 && !a.hadamard && a.d == kD && a.c1 <= 64 && aligned16(a.e0) &&
         aligned16(a.e1) && aligned16(a.de0) && aligned16(a.de1) && aligned16(a.g);
}

}  // namespace

extern "C" {

// Number of blocks (rows of the dW partial buffer) for a batch.
int cffm_cross_conv1_bwd_blocks(int batch) {
  const int ebl = examples_per_block(batch);
  return (batch + ebl - 1) / ebl;
}

// Largest C1 the kernel takes (kCG channels per thread, kPC pairs per pass).
int cffm_cross_conv1_bwd_max_channels() { return kThreads / kPC * kCG; }

// Returns a cudaError_t; 0 means both kernels were launched. bf16 rows
// take the tensor-core kernel where mma_path allows, else the CUDA-core one.
// w: (k, c1, P) in T; g: (batch, c1, d) in T; dwp: (blocks, k, P, c1) f32
// scratch; dw: (k, P, c1) f32 out; hacc: (batch, fields, d) f32 scratch
// for hadamard, else null.
int cffm_cross_conv1_bwd(int is_bf16, const void* e0, const void* e1, int nf0,
                         long long fs0, long long bs0, long long fs1, long long bs1,
                         void* de0, void* de1, long long dfs0, long long dbs0,
                         long long dfs1, long long dbs1, const void* w, const void* g,
                         const float* glin, float* hacc, float* dwp, float* dw,
                         int batch, int fields, int d, int k, int c1, int hadamard,
                         int lin_col, int w_phys, void* stream) {
  Args a;
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
  a.w = w;
  a.g = g;
  a.glin = glin;
  a.hacc = hacc;
  a.dwp = dwp;
  a.batch = batch;
  a.fields = fields;
  a.d = d;
  a.c1 = c1;
  a.c1p = (c1 + kCG - 1) / kCG * kCG;
  a.hadamard = hadamard;
  a.lin_col = lin_col;
  a.w_phys = w_phys;
  a.ngx = (d + kTN - 1) / kTN;
  a.xp = a.ngx * kTN + k - 1;
  a.ebl = examples_per_block(batch);
  if (fields < 2 || d < 1 || c1 < 1 || a.c1p / kCG * kPC > kThreads ||
      (hadamard && hacc == nullptr))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int blocks = cffm_cross_conv1_bwd_blocks(batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = mma_path(a, is_bf16) ? launch_mma_k(a, k, blocks, s)
                    : is_bf16           ? launch_k<__nv_bfloat16>(a, k, blocks, s)
                                        : launch_k<float>(a, k, blocks, s);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(k) * fields * (fields - 1) / 2 * c1;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(dwp, dw, blocks, n);
  return cudaGetLastError();
}

}  // extern "C"
