// Fused pairwise cross + conv layer 1 backward, field-major full rows with
// the fused first-order column: the "v1" variant, example tile outside.
//
// Replaces the Pallas TPU kernel `_bwd_kernel_v1` of
// scripts/bench_bwd_variants.py (launched by `bwd_v1`, :111). It computes
// what kernel 2 (cross_conv1_bwd.cu) computes for the field-major lin entry,
// from the weights in v1's orientation:
//   e    (F, B, w_phys) rows in T (bf16 or f32), 64-bit row offsets
//   wr   (P_pad, K*C1) in T, tap-reversed: wr[p, s*C1 + c] = W1[c, p, K-1-s]
//   g    (B, C1, d) in T (gY rounded to the input type)
//   glin (B,) f32
//   de   (F, B, w_phys) in T: dE[b,i,j*d+x] = T(dM[b,p,x] * E[b,j,i*d+x]) and
//        dE[b,j,i*d+x] = T(dM[b,p,x] * E[b,i,j*d+x]) for p = (i<j); diagonal
//        blocks exact zeros; dE[b,f,lin_col] = T(glin[b]); other pad lanes 0
//   dw   (K, P_pad, C1) f32: dW[t,p,c] = sum_{b,x} M[b,p,x] g[b,c,x+s-K/2]
//        with s = K-1-t (v1's tap order, bench_bwd_variants.py:70-72);
//        rows P..P_pad-1 are zeros
// with M[b,p,x] = T(E[b,i,j*d+x] * E[b,j,i*d+x]) and
//   dM[b,p,x] = T(sum_{s,c} wr[p, s*C1+c] * g[b,c,x+s-K/2])   (f32 sum).
//
// Design. v1 merged the dW and dM loops on the TPU so that one staged g
// window served both products per position x. The GPU counterpart is the
// change kernel 2's header leaves on the table: a block owns a range of
// examples and walks it in example tiles; g is staged ONCE per tile (kernel 2
// stages it once per pair chunk, 24 times per example at criteo_kaggle
// shapes). Per tile the block walks the pair chunks; per chunk and group of
// kEB examples it rebuilds the chunk's cross map and its two factors in
// shared memory from E, then both products read the one staged g tile:
//   dW: per example and tap, M (16 pairs x 16 positions) times the g window
//       at shift s (16 positions x 8 channels, loaded with ldmatrix.trans),
//       summed in registers over the tile;
//   dM: per example, wr (16 pairs x 16 channels) times the g window
//       (16 channels x 8 positions); then dE straight from registers.
// The price of staging g once: a block's dW, (K, P, C1) f32 = 571 KB at
// criteo_kaggle shapes, cannot stay in registers or shared memory across
// tiles, so each (tile, chunk) adds its registers into the block's own f32
// partial in device memory (read-modify-write, one owner per element), and a
// second kernel sums the partials in block order: deterministic, no atomics.
// Field-aware bf16 rows with d=16, C1<=64 and 16-byte aligned rows take the
// tensor-core kernel (mma.sync.m16n8k16, bf16 in, f32 sums); f32 and every
// other shape take bwd_v1_kernel, the same walk with FMAs on the CUDA cores
// and a tile of kEB examples.
//
// Bound on the H100 at criteo_kaggle shapes (F=39, d=16, W=640, C1=64, k=3,
// bf16, B=65536): like kernel 2, 2 x 298 GFLOP against ~6.7 GB of E, dE and g
// moved, so memory-bound on paper at 2.0 ms. What bounds this design: the
// partial's read-modify-write (K*P*C1*8 bytes per tile and block: 1.1 GB at
// B=65536 with 64-example tiles, partly in L2), one block per SM (the g tile
// takes 166 KB of shared memory), and the same per-chunk staging of M and
// the factors as kernel 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPC = 32;            // pairs per chunk
constexpr int kEB = 8;             // examples per group: one per warp in dM
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132; // one per SM on a 132-SM card
constexpr int kTileMax = 64;       // examples per tile (tensor-core kernel)
constexpr int kD = 16;             // embed dim of the tensor-core kernel
constexpr int kRow = 24;           // bf16 row stride of the 16-wide tiles

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
  const void* e;           // (fields, batch, w_phys) rows in T
  void* de;                // same layout as e
  long long fs, bs;        // field and batch strides of e and de (elements)
  const void* wr;          // (p_pad, K*c1) in T
  const void* g;           // (batch, c1, d) in T
  const float* glin;       // (batch,)
  float* dwp;              // (blocks, K, pairs, c1) f32 partials, tap order s
  int batch, fields, d, c1, pairs, kc, lin_col, w_phys;
  int ebl;                 // examples per block (a multiple of kEB)
  int tb;                  // examples per tile
};

template <typename T>
__device__ __forceinline__ const T* in_row(const Args& a, int f, long long b) {
  return static_cast<const T*>(a.e) + f * a.fs + b * a.bs;
}

template <typename T>
__device__ __forceinline__ T* out_row(const Args& a, int f, long long b) {
  return static_cast<T*>(a.de) + f * a.fs + b * a.bs;
}

__device__ __forceinline__ void pair_of(int p, int fields, int& i, int& j) {
  int r = p;
  i = 0;
  while (i < fields - 1 && r >= fields - 1 - i) {
    r -= fields - 1 - i;
    ++i;
  }
  j = i + 1 + r;
}

// dE lanes no pair writes: diagonal blocks zero, the fused column glin, the
// other pad lanes zero. One block's examples.
template <typename T>
__device__ void diag_and_pads(const Args& a, long long b_begin, long long b_end) {
  const int lanes = a.d + a.w_phys - a.lin_col;
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

// ---------------------------------------------------------------------------
// CUDA-core kernel: any d and C1, f32 or bf16. Tile = kEB examples.
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) bwd_v1_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int xq = a.d + K - 1;                   // halo-padded positions
  float* gs = reinterpret_cast<float*>(smem4);  // [e][q][c] = g[b, c, q - K/2]
  float* ws = gs + kEB * xq * a.c1;             // [s][p][c] = wr[p0+p, s*c1+c]
  float* ms = ws + K * kPC * a.c1;              // [e][p][x] = M
  float* fa = ms + kEB * kPC * a.d;             // [e][p][x] = E[b, i, j*d+x]
  float* fb = fa + kEB * kPC * a.d;             // [e][p][x] = E[b, j, i*d+x]
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  constexpr int kHalf = K / 2;
  const int tid = threadIdx.x;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  float* part = a.dwp + static_cast<long long>(blockIdx.x) * K * a.pairs * a.c1;
  const T* gg = static_cast<const T*>(a.g);
  const T* wg = static_cast<const T*>(a.wr);

  for (long long t0 = b_begin; t0 < b_end; t0 += kEB) {
    const int nt = static_cast<int>(min(static_cast<long long>(kEB), b_end - t0));
    const bool first = t0 == b_begin;
    __syncthreads();  // the previous tile's readers of gs are done
    for (int u = tid; u < kEB * xq * a.c1; u += kThreads) {
      const int e = u / (xq * a.c1);
      const int r = u - e * xq * a.c1;
      const int q = r / a.c1;
      const int c = r - q * a.c1;
      const int x = q - kHalf;
      gs[u] = (e < nt && x >= 0 && x < a.d) ? to_f(gg[((t0 + e) * a.c1 + c) * a.d + x]) : 0.f;
    }
    for (int p0 = 0; p0 < a.pairs; p0 += kPC) {
      const int npc = min(kPC, a.pairs - p0);
      __syncthreads();  // the previous chunk's readers of ws, ms and the pair table are done
      if (tid < kPC) pair_of(min(p0 + tid, a.pairs - 1), a.fields, pi_s[tid], pj_s[tid]);
      for (int u = tid; u < K * kPC * a.c1; u += kThreads) {
        const int c = u % a.c1;
        const int r = u / a.c1;
        const int p = r % kPC;
        const int s = r / kPC;
        ws[u] = p < npc ? to_f(wg[static_cast<long long>(p0 + p) * a.kc + s * a.c1 + c]) : 0.f;
      }
      __syncthreads();  // the pair table is set
      for (int u = tid; u < kEB * kPC * a.d; u += kThreads) {
        const int e = u / (kPC * a.d);
        const int r = u - e * kPC * a.d;
        const int pc = r / a.d;
        const int x = r - pc * a.d;
        float av = 0.f, bv = 0.f;
        if (e < nt && pc < npc) {
          const int i = pi_s[pc], j = pj_s[pc];
          av = to_f(in_row<T>(a, i, t0 + e)[j * a.d + x]);
          bv = to_f(in_row<T>(a, j, t0 + e)[i * a.d + x]);
        }
        fa[u] = av;
        fb[u] = bv;
        ms[u] = round_t<T>(av * bv);
      }
      __syncthreads();

      // dW partial: part[s, p0+p, c] (+)= sum_{e,x} M[e,p,x] * g[e, c, x+s-K/2]
      for (int u = tid; u < kPC * K * a.c1; u += kThreads) {
        const int c = u % a.c1;
        const int r = u / a.c1;
        const int s = r % K;
        const int p = r / K;
        if (p >= npc) continue;
        float acc = 0.f;
        for (int e = 0; e < nt; ++e) {
          const float* mrow = ms + (e * kPC + p) * a.d;
          const float* gcol = gs + (e * xq + s) * a.c1 + c;
          for (int x = 0; x < a.d; ++x) acc = fmaf(mrow[x], gcol[x * a.c1], acc);
        }
        float* o = part + (static_cast<long long>(s) * a.pairs + p0 + p) * a.c1 + c;
        *o = first ? acc : *o + acc;
      }

      // dM, then dE: dM[e,p,x] = sum_{s,c} wr[p, s*c1+c] * g[e, c, x+s-K/2]
      for (int u = tid; u < kEB * kPC * a.d; u += kThreads) {
        const int e = u / (kPC * a.d);
        const int r = u - e * kPC * a.d;
        const int pc = r / a.d;
        const int x = r - pc * a.d;
        if (e >= nt || pc >= npc) continue;
        float dm = 0.f;
        for (int s = 0; s < K; ++s) {
          const float* wrow = ws + (s * kPC + pc) * a.c1;
          const float* grow = gs + (e * xq + x + s) * a.c1;
          for (int c = 0; c < a.c1; ++c) dm = fmaf(wrow[c], grow[c], dm);
        }
        const float dmt = round_t<T>(dm);
        const int i = pi_s[pc], j = pj_s[pc];
        out_row<T>(a, i, t0 + e)[j * a.d + x] = from_f<T>(dmt * fb[u]);
        out_row<T>(a, j, t0 + e)[i * a.d + x] = from_f<T>(dmt * fa[u]);
      }
    }
  }
  diag_and_pads<T>(a, b_begin, b_end);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: d == 16, C1 <= 64, 16-byte aligned rows.
// ---------------------------------------------------------------------------

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

// Two 8x8 b16 matrices, transposed on the way: lanes 0-7 give the row
// addresses of matrix 0 (-> b0), lanes 8-15 those of matrix 1 (-> b1).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__host__ __device__ constexpr int mma_c16(int c1) { return (c1 + 15) / 16 * 16; }

// bf16 elements of shared memory the tensor-core kernel needs for a tile
__host__ __device__ constexpr long long mma_smem_elems(int k, int c1, int tb) {
  return static_cast<long long>(tb) * (kD + k - 1) * (mma_c16(c1) + 8) +  // g tile
         static_cast<long long>(k) * kPC * (mma_c16(c1) + 8) +           // wr chunk
         3LL * kEB * kPC * kRow;                                          // M, factors
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1) bwd_v1_mma_kernel(Args a) {
  using bf = __nv_bfloat16;
  constexpr int kHalf = K / 2;
  constexpr int kQ = kD + K - 1;           // halo-padded positions
  extern __shared__ float4 smem4[];
  const int c16 = mma_c16(a.c1);
  const int wrow = c16 + 8;                // row stride of gm and ws
  bf* gm = reinterpret_cast<bf*>(smem4);   // [e][q][c] = g[b, c, q - K/2], whole tile
  bf* ws = gm + a.tb * kQ * wrow;          // [s][p][c] = wr[p0+p, s*c1 + c]
  bf* ms = ws + K * kPC * wrow;            // [e][p][x] = M[b, p0+p, x], one group
  bf* fa = ms + kEB * kPC * kRow;          // [e][p][x] = E[b, i, j*d + x]
  bf* fb = fa + kEB * kPC * kRow;          // [e][p][x] = E[b, j, i*d + x]
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  const int wpt = warp >> 2;               // dW: pair tile of this warp
  const int wct = (warp & 3) * 2;          // dW: first of its two channel tiles
  const bf zero = __float2bfloat16_rn(0.f);
  const bf* gg = static_cast<const bf*>(a.g);
  const bf* wg = static_cast<const bf*>(a.wr);
  float* part = a.dwp + static_cast<long long>(blockIdx.x) * K * a.pairs * a.c1;

  // halos and pads stay zero: the staging below writes interiors only
  {
    const long long n16 = mma_smem_elems(K, a.c1, a.tb) / 8;
    for (long long u = tid; u < n16; u += kThreads) smem4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (long long t0 = b_begin; t0 < b_end; t0 += a.tb) {
    const int nt = static_cast<int>(min(static_cast<long long>(a.tb), b_end - t0));
    const bool first = t0 == b_begin;
    __syncthreads();  // the previous tile's readers of gm are done
    for (int u = tid; u < a.tb * c16 * 2; u += kThreads) {
      const int e = u / (c16 * 2);
      const int r = u - e * c16 * 2;
      const int c = r >> 1, hf = r & 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (e < nt && c < a.c1)
        v = *reinterpret_cast<const uint4*>(gg + ((t0 + e) * a.c1 + c) * kD + hf * 8);
      const bf* vv = reinterpret_cast<const bf*>(&v);
#pragma unroll
      for (int n = 0; n < 8; ++n) gm[(e * kQ + kHalf + hf * 8 + n) * wrow + c] = vv[n];
    }

    for (int p0 = 0; p0 < a.pairs; p0 += kPC) {
      const int npc = min(kPC, a.pairs - p0);
      __syncthreads();  // the previous chunk's readers of ws and the pair table are done
      if (tid < kPC) pair_of(min(p0 + tid, a.pairs - 1), a.fields, pi_s[tid], pj_s[tid]);
      for (int u = tid; u < K * kPC * c16; u += kThreads) {
        const int c = u % c16;
        const int r = u / c16;
        const int p = r % kPC;
        const int s = r / kPC;
        ws[(s * kPC + p) * wrow + c] =
            (c < a.c1 && p < npc) ? wg[static_cast<long long>(p0 + p) * a.kc + s * a.c1 + c]
                                  : zero;
      }

      float acc[2][K][4];
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
#pragma unroll
        for (int s = 0; s < K; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ct][s][r] = 0.f;

      for (int g0 = 0; g0 < nt; g0 += kEB) {
        __syncthreads();  // the previous group's M and factors are consumed; the
                          // pair table, ws and gm are visible
        for (int u = tid; u < kEB * kPC * 2; u += kThreads) {
          const int e = u / (kPC * 2);
          const int r = u - e * kPC * 2;
          const int pc = r >> 1, x0 = (r & 1) * 8;
          uint4 ua = make_uint4(0u, 0u, 0u, 0u), ub = ua;
          if (pc < npc && g0 + e < nt) {
            const int i = pi_s[pc], j = pj_s[pc];
            const long long b = t0 + g0 + e;
            ua = *reinterpret_cast<const uint4*>(in_row<bf>(a, i, b) + j * kD + x0);
            ub = *reinterpret_cast<const uint4*>(in_row<bf>(a, j, b) + i * kD + x0);
          }
          const int o = (e * kPC + pc) * kRow + x0;
          *reinterpret_cast<uint4*>(fa + o) = ua;
          *reinterpret_cast<uint4*>(fb + o) = ub;
          const bf* av = reinterpret_cast<const bf*>(&ua);
          const bf* bv = reinterpret_cast<const bf*>(&ub);
          uint4 um;
          bf* mv = reinterpret_cast<bf*>(&um);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mv[n] = __float2bfloat16_rn(__bfloat162float(av[n]) * __bfloat162float(bv[n]));
          *reinterpret_cast<uint4*>(ms + o) = um;
        }
        __syncthreads();

        // dW: per example and tap, M tile (pairs x positions) times the g
        // window at shift s (positions x channels)
        for (int e = 0; e < kEB && g0 + e < nt; ++e) {
          const bf* m = ms + (e * kPC + wpt * 16) * kRow + 2 * tig;
          const uint32_t a0 = ld32(m + gid * kRow), a1 = ld32(m + (gid + 8) * kRow);
          const uint32_t a2 = ld32(m + gid * kRow + 8), a3 = ld32(m + (gid + 8) * kRow + 8);
          const bf* gwin = gm + ((g0 + e) * kQ + (lane & 15)) * wrow;
#pragma unroll
          for (int s = 0; s < K; ++s) {
#pragma unroll
            for (int ct = 0; ct < 2; ++ct) {
              if ((wct + ct) * 8 >= c16) continue;
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1, gwin + s * wrow + (wct + ct) * 8);
              mma_bf16(acc[ct][s], a0, a1, a2, a3, b0, b1);
            }
          }
        }

        // dM for example `warp` of the group, then its dE products
        if (g0 + warp < nt) {
          const long long b = t0 + g0 + warp;
          const bf* gme = gm + (g0 + warp) * kQ * wrow;
          for (int mt = 0; mt < 2 && mt * 16 < npc; ++mt) {
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
              float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int s = 0; s < K; ++s) {
                const bf* wt = ws + (s * kPC + mt * 16) * wrow + 2 * tig;
                const bf* gq = gme + (nt2 * 8 + gid + s) * wrow + 2 * tig;
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
                const int x = nt2 * 8 + 2 * tig;
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

      // add this tile's registers into the block's partial (one owner each)
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
#pragma unroll
        for (int s = 0; s < K; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = wpt * 16 + gid + (r >> 1) * 8;
            const int c = (wct + ct) * 8 + 2 * tig + (r & 1);
            if (p < npc && c < a.c1) {
              float* o = part + (static_cast<long long>(s) * a.pairs + p0 + p) * a.c1 + c;
              *o = first ? acc[ct][s][r] : *o + acc[ct][s][r];
            }
          }
    }
  }
  diag_and_pads<bf>(a, b_begin, b_end);
}

// dw[t, p, c] = sum over blocks of dwp[blk, K-1-t, p, c] in block order for
// p < pairs, 0 for pairs <= p < p_pad
__global__ void sum_partials_kernel(const float* dwp, float* dw, int blocks, int k, int pairs,
                                    int p_pad, int c1) {
  const long long n = static_cast<long long>(k) * p_pad * c1;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % c1);
  const long long r = i / c1;
  const int p = static_cast<int>(r % p_pad);
  const int t = static_cast<int>(r / p_pad);
  float s = 0.f;
  if (p < pairs) {
    const long long per = static_cast<long long>(k) * pairs * c1;
    const long long off = (static_cast<long long>(k - 1 - t) * pairs + p) * c1 + c;
    for (int blk = 0; blk < blocks; ++blk) s += dwp[blk * per + off];
  }
  dw[i] = s;
}

int examples_per_block(int batch) {
  const int groups = (batch + kEB - 1) / kEB;
  const int per_block = (groups + kTargetBlocks - 1) / kTargetBlocks;
  return kEB * (per_block < 1 ? 1 : per_block);
}

template <typename T, int K>
cudaError_t launch(Args a, int blocks, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kEB) * (a.d + K - 1) * a.c1 +
                       static_cast<size_t>(K) * kPC * a.c1 + 3 * static_cast<size_t>(kEB) * kPC * a.d) *
                      sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_v1_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  a.tb = kEB;
  bwd_v1_kernel<T, K><<<blocks, kThreads, smem, stream>>>(a);
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

// The largest tile (a multiple of kEB, at most kTileMax and the block's
// range) whose shared memory fits the card's opt-in limit.
template <int K>
cudaError_t launch_mma(Args a, int blocks, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long budget = limit - 2 * kPC * static_cast<long long>(sizeof(int));
  int tb = a.ebl < kTileMax ? a.ebl : kTileMax;
  while (tb > kEB && mma_smem_elems(K, a.c1, tb) * 2 > budget) tb -= kEB;
  a.tb = tb;
  const size_t smem = static_cast<size_t>(mma_smem_elems(K, a.c1, tb)) * sizeof(__nv_bfloat16);
  err = cudaFuncSetAttribute(bwd_v1_mma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_v1_mma_kernel<K><<<blocks, kThreads, smem, stream>>>(a);
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

// The tensor-core kernel reads rows and g with 16-byte loads.
bool mma_path(const Args& a, int is_bf16) {
  return is_bf16 && a.d == kD && a.c1 <= 64 && a.fs % 8 == 0 && a.bs % 8 == 0 &&
         aligned16(a.e) && aligned16(a.de) && aligned16(a.g);
}

}  // namespace

extern "C" {

// Number of blocks (rows of the dW partial buffer) for a batch.
int cffm_cross_conv1_bwd_v1_blocks(int batch) {
  const int ebl = examples_per_block(batch);
  return (batch + ebl - 1) / ebl;
}

// Returns a cudaError_t; 0 means both kernels were launched. e, de:
// (fields, batch, w_phys) with field stride fs and batch stride bs; wr:
// (p_pad, k*c1) in T; g: (batch, c1, d) in T; glin: (batch,) f32; dwp:
// (blocks, k, pairs, c1) f32 scratch; dw: (k, p_pad, c1) f32 out.
int cffm_cross_conv1_bwd_v1(int is_bf16, const void* e, void* de, long long fs, long long bs,
                            const void* wr, const void* g, const float* glin, float* dwp,
                            float* dw, int batch, int fields, int d, int k, int c1, int p_pad,
                            int lin_col, int w_phys, void* stream) {
  Args a;
  a.e = e;
  a.de = de;
  a.fs = fs;
  a.bs = bs;
  a.wr = wr;
  a.g = g;
  a.glin = glin;
  a.dwp = dwp;
  a.batch = batch;
  a.fields = fields;
  a.d = d;
  a.c1 = c1;
  a.pairs = fields * (fields - 1) / 2;
  a.kc = k * c1;
  a.lin_col = lin_col;
  a.w_phys = w_phys;
  a.ebl = examples_per_block(batch);
  a.tb = kEB;
  if (fields < 2 || d < 1 || c1 < 1 || p_pad < a.pairs || lin_col != fields * d ||
      w_phys <= lin_col)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int blocks = cffm_cross_conv1_bwd_v1_blocks(batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = mma_path(a, is_bf16) ? launch_mma_k(a, k, blocks, s)
                    : is_bf16           ? launch_k<__nv_bfloat16>(a, k, blocks, s)
                                        : launch_k<float>(a, k, blocks, s);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(k) * p_pad * c1;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      dwp, dw, blocks, k, a.pairs, p_pad, c1);
  return cudaGetLastError();
}

}  // extern "C"
