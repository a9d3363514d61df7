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
// window served both products per position x. Two kernels keep that.
// Field-aware bf16 rows with d=16, C1 of 32 or 64 and k*C1 <= 224 take
// bwd_v1_wgmma_kernel (below; bwd_variants.bwd_v1 brings a narrower layer
// to 32 or 64 channels with zero channels): both products as wgmma GEMMs over one tap
// window of g per (pair chunk, example tile) in shared memory, read at x's
// offset, dW in registers over a block's tile range. f32 and every other
// shape take bwd_v1_kernel: a block walks its examples in tiles of kEB,
// stages g once per tile and, per pair chunk, the weight chunk and the
// cross map, and runs both products as FMAs on the CUDA cores, adding each
// (tile, chunk)'s dW into the block's f32 partial in device memory. Both
// sum the partials in a second kernel, in order: deterministic, no
// atomics. k is an unrolled template value for 1-9 and a run-time value
// for any other odd k.
//
// Bound on the H100 at criteo_kaggle shapes (F=39, d=16, W=640, C1=64, k=3,
// bf16, B=65536): like kernel 2, 2 x 298 GFLOP against ~6.7 GB of E, dE and g
// moved, so memory-bound on paper at 2.0 ms. The wgmma kernel moves more:
// it reads g once per pair chunk (12 chunks of 64 pairs, ~1.6 GB at
// B=65536, much of it from L2) besides E and dE, and stores dE in 32-byte
// pieces as kernel 2 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPC = 32;            // pairs per chunk
constexpr int kEB = 8;             // examples per group: one per warp in dM
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132; // one per SM on a 132-SM card
constexpr int kD = 16;             // embed dim of the tensor-core kernel
constexpr int kSmemMax = 232448;   // shared memory a block may use on the H100

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
  const void* wr;          // (p_pad, K*c1) in T (CUDA-core kernel)
  const void* g;           // (batch, c1, d) in T
  const float* glin;       // (batch,)
  float* dwp;              // (blocks, K, pairs, c1) f32 partials, tap order s
  int batch, fields, d, k, c1, pairs, kc, lin_col, w_phys;
  int ebl;                 // examples per block (a multiple of kEB)
  int pcs;                 // pairs per chunk (CUDA-core kernel)
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

// K > 0: that width; K = 0: a.k at run time.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) bwd_v1_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int kk = K > 0 ? K : a.k;
  const int pcs = a.pcs;                        // pairs per chunk
  const int xq = a.d + kk - 1;                  // halo-padded positions
  float* gs = reinterpret_cast<float*>(smem4);  // [e][q][c] = g[b, c, q - K/2]
  float* ws = gs + kEB * xq * a.c1;             // [s][p][c] = wr[p0+p, s*c1+c]
  float* ms = ws + kk * pcs * a.c1;              // [e][p][x] = M
  float* fa = ms + kEB * pcs * a.d;             // [e][p][x] = E[b, i, j*d+x]
  float* fb = fa + kEB * pcs * a.d;             // [e][p][x] = E[b, j, i*d+x]
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  const int kHalf = kk / 2;
  const int tid = threadIdx.x;
  const long long b_begin = static_cast<long long>(blockIdx.x) * a.ebl;
  const long long b_end = min(static_cast<long long>(a.batch), b_begin + a.ebl);
  float* part = a.dwp + static_cast<long long>(blockIdx.x) * kk * a.pairs * a.c1;
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
    for (int p0 = 0; p0 < a.pairs; p0 += pcs) {
      const int npc = min(pcs, a.pairs - p0);
      __syncthreads();  // the previous chunk's readers of ws, ms and the pair table are done
      if (tid < pcs) pair_of(min(p0 + tid, a.pairs - 1), a.fields, pi_s[tid], pj_s[tid]);
      for (int u = tid; u < kk * pcs * a.c1; u += kThreads) {
        const int c = u % a.c1;
        const int r = u / a.c1;
        const int p = r % pcs;
        const int s = r / pcs;
        ws[u] = p < npc ? to_f(wg[static_cast<long long>(p0 + p) * a.kc + s * a.c1 + c]) : 0.f;
      }
      __syncthreads();  // the pair table is set
      for (int u = tid; u < kEB * pcs * a.d; u += kThreads) {
        const int e = u / (pcs * a.d);
        const int r = u - e * pcs * a.d;
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
      for (int u = tid; u < pcs * kk * a.c1; u += kThreads) {
        const int c = u % a.c1;
        const int r = u / a.c1;
        const int s = r % kk;
        const int p = r / kk;
        if (p >= npc) continue;
        float acc = 0.f;
        for (int e = 0; e < nt; ++e) {
          const float* mrow = ms + (e * pcs + p) * a.d;
          const float* gcol = gs + (e * xq + s) * a.c1 + c;
          for (int x = 0; x < a.d; ++x) acc = fmaf(mrow[x], gcol[x * a.c1], acc);
        }
        float* o = part + (static_cast<long long>(s) * a.pairs + p0 + p) * a.c1 + c;
        *o = first ? acc : *o + acc;
      }

      // dM, then dE: dM[e,p,x] = sum_{s,c} wr[p, s*c1+c] * g[e, c, x+s-K/2]
      for (int u = tid; u < kEB * pcs * a.d; u += kThreads) {
        const int e = u / (pcs * a.d);
        const int r = u - e * pcs * a.d;
        const int pc = r / a.d;
        const int x = r - pc * a.d;
        if (e >= nt || pc >= npc) continue;
        float dm = 0.f;
        for (int s = 0; s < kk; ++s) {
          const float* wrow = ws + (s * pcs + pc) * a.c1;
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
// bf16 tensor-core kernel (wgmma): d == 16, C1 in {32, 64}, k*C1 <= 224,
// at most 255 fields, 16-byte aligned rows and pad columns.
//
// v1 contracts over a tile of kTE examples for each position x, reading
// one tap window of g: with Gw_x (k*C1 x kTE) = rows x*C1 .. (x+k)*C1 of
// the window gp[q*C1 + c, b] = g[b, c, q - k/2] (zero outside [0, 16)),
//   dW_all (pairs x k*C1) += M_x (pairs x kTE) . Gw_x^T   (dW's K = examples)
//   dM_x   (pairs x kTE)   = wr (pairs x k*C1) . Gw_x     (dM's K = k*C1)
// Both GEMMs read the one shared-memory window at x's offset (x*C1 rows,
// x*C1*kTE*2 bytes, whole core matrices for C1 a multiple of 8): dW reads
// it K-major (rows r, examples contiguous), dM MN-major (its transpose
// bit). A warpgroup builds the window from g for each tile, transposing
// it into 8x8 core matrices (r/8, b/8) at (r/8 * 2 + b/8) * 128 bytes; its
// halo rows (q < k/2 or q >= k/2 + 16) are zeroed once. The weights come
// from the wrapper one block per pair chunk (bwd_variants.v1_weight_chunks).
//
// Loop order. One block per SM walks a contiguous range of tiles; its two
// warpgroups take alternate tiles, warpgroup 1 starting each chunk one load
// phase behind, so that one's loads and stores run under the other's
// products. The pair axis goes in chunks of kWgPairs (wgmma's M) in the
// outer loop: a warpgroup keeps the chunk's dW (k accumulators of 64 x C1)
// in registers over all its tiles and writes one f32 partial per (block,
// warpgroup, chunk); sum_partials_kernel sums them in order. Per tile a
// warpgroup loads the pairs' 32-byte pieces of E, E[b, i, 16j + x] and
// E[b, j, 16i + x] (two lanes a piece, consecutive lanes on consecutive
// pairs; half of them already loaded during its previous tile's
// products), and stores them transposed into position planes
// [x][pair][example], two examples per 32-bit word (plane_off swizzles the
// slots); it writes the window's rows from g's 32-byte pieces g[b, c,
// 0..16) the same way (store_window); then for each x it forms M_x = bf16(E_i *
// E_j) straight into the register fragment of wgmma's A operand (a
// thread's fragment positions are those of its dM accumulator), issues
// dM_x (wgmma, A = wr from shared memory) and dW (wgmma, A from
// registers), rounds dM_x to bf16 and overwrites the two factors at x in
// place with dE = bf16(dM * partner). Last it gathers each (pair,
// example)'s 16 positions back into 32-byte pieces and stores dE. The
// tile's diagonal blocks and pad lanes are written in the first chunk.
//
// Shared memory (k=3, C1=64): the weight chunk 24 KB; per warpgroup the
// two factors' planes 2 x 32 KB and the tap window (16 + k - 1) * C1 * kTE
// * 2 = 36 KB; 229.4 KB in all, so one block per SM and no ring. What holds
// it back (scripts/ablate_bwd.py --kernel=8a): the loads of E and the stores of dE,
// each 32-byte pieces half scattered over rows, which two warpgroups do not
// keep in flight long enough; the products cost little.
// ---------------------------------------------------------------------------

constexpr int kWgPairs = 64;                  // pairs per chunk: wgmma's M
constexpr int kTE = 16;                       // examples per tile: dW's K, dM's N
constexpr int kWgThreads = 256;               // two warpgroups, alternate tiles
constexpr int kPlane = kWgPairs * kTE * 2;    // bytes of one position's plane
constexpr int kFactorBytes = kD * kPlane;     // one factor of a tile, all positions
constexpr int kMaxWgFields = 255;             // pair tables hold i and j in a byte each

__host__ __device__ constexpr int v1_gp_bytes(int k, int c1) { return (kD + k - 1) * c1 * kTE * 2; }
__host__ __device__ constexpr int v1_wr_bytes(int k, int c1) { return kWgPairs * k * c1 * 2; }
__host__ __device__ constexpr int v1_smem(int k, int c1) {
  return v1_wr_bytes(k, c1) + 2 * (2 * kFactorBytes + v1_gp_bytes(k, c1)) + kWgPairs * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// keeps the compiler from moving register reads or writes across a wgmma wait
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wg_pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 64, f32, this thread's 32) += A (64 x 16, bf16 in registers: this
// thread's fragment a) * B (16 x 64, K-major descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32, this thread's 16) += A (64 x 16, bf16 in registers: this
// thread's fragment a) * B (16 x 32, K-major descriptor)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32, this thread's 8) = scale_d * d + A (64 x 16, K-major
// descriptor) * B (16 x 16, MN-major descriptor: the transpose bit)
__device__ __forceinline__ void wgmma_ss_n16_bmn(float (&d)[8], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n32(d, a, b);
}

// two bf16 products, each rounded once: bf16(x * y), lane by lane
__device__ __forceinline__ uint32_t mul2(uint32_t x, uint32_t y) {
  const __nv_bfloat162 z = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&z);
}

// Byte offset in position x's plane of the word (pair p, examples 2*e2
// and 2*e2 + 1): pair-major, the example pair's slot XOR-ed with (p/4) % 8
// and with 4 in the upper half of the positions, so that the fragment loads
// (8 pairs x 4 example pairs a warp) and the transposing stores and the
// gather (16 consecutive pairs, two halves a warp) each hit 32 distinct banks.
__device__ __forceinline__ int plane_off(int p, int e2, int x) {
  return (p * (kTE / 2) + (e2 ^ ((p >> 2) & 7) ^ ((x >> 3) << 2))) * 4;
}

__device__ __forceinline__ uint32_t& word(unsigned char* base, int off) {
  return *reinterpret_cast<uint32_t*>(base + off);
}

// diagonal blocks and pad lanes of examples [b_begin, b_end), 16 bytes a
// store, by threads t0, t0 + nt, ...: d == 16, lin_col and w_phys are
// multiples of 8 (checked at the launch)
__device__ void diag_and_pads16(const Args& a, long long b_begin, long long b_end, int t0,
                                int nt) {
  using bf = __nv_bfloat16;
  const int per_field = 2 + (a.w_phys - a.lin_col) / 8;
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

// Byte offset of window element (row r, example e) in its 8x8 core
// matrix layout: core (r/8, e/8) at (r/8 * 2 + e/8) * 128 bytes, rows of
// 8 examples.
__device__ __forceinline__ int window_off(int r, int e) {
  return ((r >> 3) * 2 + (e >> 3)) * 128 + (r & 7) * 16 + (e & 7) * 2;
}

// The tile's window rows from g, transposed: word (row (x + K/2) * C1 + c,
// examples 2e2, 2e2 + 1) = (g[b, c, x], g[b + 1, c, x]) for b = b0 + 2e2,
// zeros past the batch. A thread takes C1/16 (channel, example pair)
// items, item u = ct + 128 * it: lanes on 8 channels and 4 example pairs,
// so that each warp's stores hit 32 banks and its loads read 256 bytes
// of one example's row.
template <int K, int C1>
__device__ __forceinline__ void store_window(unsigned char* gw, const Args& a, long long b0,
                                             int ct) {
  constexpr int kItems = C1 / 16;  // 2 or 4: two items' loads in flight at a time
#pragma unroll
  for (int i0 = 0; i0 < kItems; i0 += 2) {
    uint4 v[2][2][2];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int u = ct + 128 * (i0 + it), w = u >> 5, l = u & 31;
      const int c = 8 * (w >> 1) + (l & 7), e2 = 4 * (w & 1) + (l >> 3);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long b = b0 + 2 * e2 + e;
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.g) + (b * C1 + c) * kD);
        v[it][e][0] = b < a.batch ? __ldg(src) : make_uint4(0u, 0u, 0u, 0u);
        v[it][e][1] = b < a.batch ? __ldg(src + 1) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int u = ct + 128 * (i0 + it), w = u >> 5, l = u & 31;
      const int c = 8 * (w >> 1) + (l & 7), e2 = 4 * (w & 1) + (l >> 3);
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&v[it][0][0]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&v[it][1][0]);
#pragma unroll
      for (int x2 = 0; x2 < kD / 2; ++x2) {  // positions 2x2, 2x2 + 1
        const int r = (2 * x2 + K / 2) * C1 + c;
        word(gw, window_off(r, 2 * e2)) = __byte_perm(w0[x2], w1[x2], 0x5410);
        word(gw, window_off(r + C1, 2 * e2)) = __byte_perm(w0[x2], w1[x2], 0x7632);
      }
    }
  }
}

// Four example pairs' E for this thread's (pair ij, half h): v[it][side][e]
// = 16 bytes of E[b, i, 16j + 8h ..] (side 0) or E[b, j, 16i + 8h ..] (side
// 1) of example b = b0 + 2 * (e20 + it) + e; zeros past the batch and for a
// pad pair.
__device__ __forceinline__ void load_quad(uint4 (&v)[4][2][2], const Args& a, uint16_t ij,
                                          long long b0, int e20, int h) {
  using bf = __nv_bfloat16;
  const int i = ij >> 8, j = ij & 0xFF;
#pragma unroll
  for (int it = 0; it < 4; ++it)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long b = b0 + 2 * (e20 + it) + e;
      if (ij != 0xFFFFu && b < a.batch) {
        v[it][0][e] = __ldg(reinterpret_cast<const uint4*>(in_row<bf>(a, i, b) + j * kD) + h);
        v[it][1][e] = __ldg(reinterpret_cast<const uint4*>(in_row<bf>(a, j, b) + i * kD) + h);
      } else {
        v[it][0][e] = v[it][1][e] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
}

// load_quad's pieces into the position planes, transposed: plane x, word
// (pair p, example pair) = (example 2e2 at x, example 2e2 + 1 at x)
__device__ __forceinline__ void store_quad(const uint4 (&v)[4][2][2], unsigned char* fa,
                                           unsigned char* fb, int p, int e20, int h) {
#pragma unroll
  for (int it = 0; it < 4; ++it)
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      unsigned char* plane = side ? fb : fa;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&v[it][side][0]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&v[it][side][1]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // positions x = 8h + 2w, 8h + 2w + 1
        const int x = 8 * h + 2 * w;
        word(plane, x * kPlane + plane_off(p, e20 + it, x)) = __byte_perm(w0[w], w1[w], 0x5410);
        word(plane, (x + 1) * kPlane + plane_off(p, e20 + it, x + 1)) =
            __byte_perm(w0[w], w1[w], 0x7632);
      }
    }
}

// M_x's A fragment from the factor planes at x: (pair pr + 8h, examples
// 8j + 2tq, +1) in af[h + 2j], each bf16(E_i * E_j)
__device__ __forceinline__ void m_fragment(uint32_t (&af)[4], unsigned char* fa,
                                           unsigned char* fb, int x, int pr, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = x * kPlane + plane_off(pr + 8 * h, 4 * j + tq, x);
      af[h + 2 * j] = mul2(word(fa, o), word(fb, o));
    }
}

// dE at x, in place: the i side's factor slot takes bf16(dM) * E_j (row
// i's lanes 16j + x), the j side's takes bf16(dM) * E_i; this thread's
// (pair, example) positions are those of its dM accumulator
__device__ __forceinline__ void de_at(unsigned char* fa, unsigned char* fb, int x,
                                      const float (&am)[8], int pr, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = x * kPlane + plane_off(pr + 8 * h, 4 * j + tq, x);
      const __nv_bfloat162 dm2 = __floats2bfloat162_rn(am[4 * j + 2 * h], am[4 * j + 2 * h + 1]);
      const uint32_t dm = *reinterpret_cast<const uint32_t*>(&dm2);
      const uint32_t ea = word(fa, o), eb = word(fb, o);
      word(fa, o) = mul2(dm, eb);
      word(fb, o) = mul2(dm, ea);
    }
}

// Issue position x's products, one commit group each:
//   dM_x = wr (64 x k*C1, K-major) . Gw_x (k*C1 x 16, MN-major),
//   dW_s += M_x (64 x 16, registers) . Gw_x rows s*C1.. (16 x C1, K-major).
template <int K, int C1>
__device__ __forceinline__ void issue_x(float (&acc_m)[8], float (&acc_w)[K][C1 / 2],
                                        const uint32_t (&af)[4], const unsigned char* wrs,
                                        const unsigned char* gw, int x) {
  constexpr int kR = K * C1;
  wg_fence();
#pragma unroll
  for (int kr = 0; kr < kR / 16; ++kr)
    wgmma_ss_n16_bmn(acc_m, wg_desc(wrs + 2 * kr * 128, 128, (kR / 8) * 128),
                     wg_desc(gw + (x * C1 + 16 * kr) * kTE * 2, 2 * 128, 128), kr);
  wg_commit();
#pragma unroll
  for (int s = 0; s < K; ++s)
    wgmma_rs<C1>(acc_w[s], af, wg_desc(gw + (x + s) * C1 * kTE * 2, 128, 2 * 128));
  wg_commit();
}

template <int K, int C1>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_v1_wgmma_kernel(Args a, const __nv_bfloat16* wrc, int tpb, int ntiles) {
  using bf = __nv_bfloat16;
  constexpr int kGp = v1_gp_bytes(K, C1);
  constexpr int kWr = v1_wr_bytes(K, C1);
  constexpr int kStage = 2 * kFactorBytes + kGp;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wrs = smem;                                   // [pair/8][r/8][pair%8][8 r]
  uint16_t* pij = reinterpret_cast<uint16_t*>(smem + kWr + 2 * kStage);  // i << 8 | j
  const int tid = threadIdx.x, ct = tid % 128;
  // the warpgroup, uniform across each warp as the compiler sees it
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int warp = ct / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  unsigned char* fa = smem + kWr + wg * kStage;   // planes [x][pair][example]: E[b, i, 16j + x]
  unsigned char* fb = fa + kFactorBytes;          // E[b, j, 16i + x]
  unsigned char* gw = fb + kFactorBytes;          // window: core (r/8, b/8) at (r/8*2 + b/8)*128
  const int pairs = a.pairs;
  const int nq = (pairs + kWgPairs - 1) / kWgPairs;
  const int t_begin = blockIdx.x * tpb;
  const int t_end = min(ntiles, t_begin + tpb);
  float* part = a.dwp + static_cast<long long>(2 * blockIdx.x + wg) * K * pairs * C1;
  const int pr = 16 * warp + gq;   // this thread's pairs pr, pr + 8 and examples 2tq, +1, +8, +9
  // the window's halo rows, zeros for every tile: the first K/2 * C1 rows
  // and the last (K - 1 - K/2) * C1, 256 bytes per 8 rows
  for (int u = ct; u < (K - 1) * C1 * 2; u += 128) {
    const int lo16 = (K / 2) * C1 * 2;
    reinterpret_cast<uint4*>(gw)[u < lo16 ? u : u + kD * C1 * 2] = make_uint4(0u, 0u, 0u, 0u);
  }

  for (int q = 0; q < nq; ++q) {
    __syncthreads();  // the previous chunk's readers of the weights and pair table are done
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(wrc) + static_cast<long long>(q) * (kWr / 16);
    for (int u = tid; u < kWr / 16; u += kWgThreads)
      reinterpret_cast<uint4*>(wrs)[u] = __ldg(wsrc + u);
    if (tid < kWgPairs) {
      const int p = q * kWgPairs + tid;
      int i = 0, j = 0;
      if (p < pairs) pair_of(p, a.fields, i, j);
      pij[tid] = p < pairs ? static_cast<uint16_t>((i << 8) | j) : 0xFFFFu;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float acc_w[K][C1 / 2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int r = 0; r < C1 / 2; ++r) acc_w[s][r] = 0.f;
      wg_pin<C1 / 2>(acc_w[s]);
    }

    // The two warpgroups do the same work, so left alone they would load,
    // compute and store in step; warpgroup 1 starts each chunk once
    // warpgroup 0 has loaded its first tile, so that one's loads and
    // stores run under the other's products.
    bool stagger = t_end - t_begin >= 2;  // both warpgroups have a tile
    // the thread's (pair, half) in E's loads and dE's stores
    const int h = ct & 1, p = (ct >> 1) & (kWgPairs - 1);
    const uint16_t ij = pij[p];
    uint4 pre[4][2][2];
    bool have_pre = false;
    for (int tile = t_begin + wg; tile < t_end; tile += 2) {
      const long long b0 = static_cast<long long>(tile) * kTE;
      if (wg == 1 && stagger) named_sync(3, 256);
      named_sync(1 + wg, 128);  // the previous tile's dE stores have read the planes
      // E, stored transposed: plane x, word (pair, example pair) = (example
      // 2e2 at x, example 2e2 + 1 at x). A thread owns one (pair, half of
      // the 16 positions) and loads four example pairs at a time, their 16
      // loads in flight together: two lanes share each 32-byte piece and
      // consecutive lanes take consecutive pairs, whose i-side pieces often
      // lie side by side in one row. The first four of a tile were loaded
      // during the previous tile's products (pre).
      if (!have_pre) load_quad(pre, a, ij, b0, 0, h);
      store_quad(pre, fa, fb, p, 0, h);
      store_window<K, C1>(gw, a, b0, ct);
      {
        uint4 v[4][2][2];
        load_quad(v, a, ij, b0, 4, h);
        store_quad(v, fa, fb, p, 4, h);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (wg == 0 && stagger) named_arrive(3, 256);
      stagger = false;
      // the next tile's first four example pairs, in flight during this
      // tile's products
      have_pre = tile + 2 < t_end;
      if (have_pre) load_quad(pre, a, ij, b0 + 2 * kTE, 0, h);
      // per position x: the A fragment of M_x, dM_x and dW issued, dM_x
      // awaited and dE formed while dW runs
#pragma unroll 1
      for (int x = 0; x < kD; ++x) {
        uint32_t af[4];
        float am[8];
        m_fragment(af, fa, fb, x, pr, tq);
        issue_x<K, C1>(am, acc_w, af, wrs, gw, x);
        wg_wait<1>();
        wg_pin<8>(am);
        de_at(fa, fb, x, am, pr, tq);
        wg_wait<0>();
        wg_pin(af);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) wg_pin<C1 / 2>(acc_w[s]);

      named_sync(1 + wg, 128);  // every position's dE is in the planes
      // gather the planes back into pieces of dE: a thread owns one (pair,
      // half) as in the loads and walks (side, example pair); two lanes
      // share each 32-byte piece
      {
        const int i = ij >> 8, j = ij & 0xFF;
#pragma unroll 1
        for (int it = 0; it < kTE && ij != 0xFFFFu; ++it) {
          const int side = it / (kTE / 2), e2 = it % (kTE / 2);
          const unsigned char* buf = side ? fb : fa;
          uint32_t w[8];
#pragma unroll
          for (int xx = 0; xx < 8; ++xx) {
            const int x = 8 * h + xx;
            w[xx] = *reinterpret_cast<const uint32_t*>(buf + x * kPlane + plane_off(p, e2, x));
          }
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2) {
            lo[k2] = __byte_perm(w[2 * k2], w[2 * k2 + 1], 0x5410);
            hi[k2] = __byte_perm(w[2 * k2], w[2 * k2 + 1], 0x7632);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long b = b0 + 2 * e2 + e;
            if (b >= a.batch) continue;
            const uint32_t* v = e ? hi : lo;
            bf* row = side ? out_row<bf>(a, j, b) + i * kD : out_row<bf>(a, i, b) + j * kD;
            reinterpret_cast<uint4*>(row)[h] = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      if (q == 0)
        diag_and_pads16(a, b0, min(static_cast<long long>(a.batch), b0 + kTE), ct, 128);
    }

    // this warpgroup's dW partial for the chunk, tap order s: pair pr + 8h,
    // channel 8j + 2tq + e in acc_w[s][4j + 2h + e]
#pragma unroll
    for (int s = 0; s < K; ++s)
#pragma unroll
      for (int j = 0; j < C1 / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = q * kWgPairs + pr + 8 * h;
            if (p < pairs)
              part[(static_cast<long long>(s) * pairs + p) * C1 + 8 * j + 2 * tq + e] =
                  acc_w[s][4 * j + 2 * h + e];
          }
  }
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

// The CUDA-core kernel's shared memory at pcs pairs per chunk, f32: the g
// tile with its halo, the weight chunk, M and its two factors.
size_t core_smem(const Args& a, int pcs) {
  return (static_cast<size_t>(kEB) * (a.d + a.k - 1) * a.c1 +
          static_cast<size_t>(a.k) * pcs * a.c1 + 3 * static_cast<size_t>(kEB) * pcs * a.d) *
         sizeof(float);
}

template <typename T, int K>
cudaError_t launch(Args a, int blocks, cudaStream_t stream) {
  // the most pairs per chunk, up to kPC, that fit the card's limit
  a.pcs = kPC;
  while (a.pcs > 1 && core_smem(a, a.pcs) > static_cast<size_t>(kSmemMax - 2 * kPC * 4)) --a.pcs;
  const size_t smem = core_smem(a, a.pcs);
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_v1_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_v1_kernel<T, K><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// widths 1-9 unrolled; every other odd k at run time
template <typename T>
cudaError_t launch_k(const Args& a, int k, int blocks, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(a, blocks, stream);
    case 3: return launch<T, 3>(a, blocks, stream);
    case 5: return launch<T, 5>(a, blocks, stream);
    case 7: return launch<T, 7>(a, blocks, stream);
    case 9: return launch<T, 9>(a, blocks, stream);
    default: return k >= 1 && k % 2 == 1 ? launch<T, 0>(a, blocks, stream) : cudaErrorInvalidValue;
  }
}

// SMs of the current device
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
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
  g->ntiles = (batch + kTE - 1) / kTE;
  const int first = g->ntiles < sms ? g->ntiles : sms;
  g->tpb = first > 0 ? (g->ntiles + first - 1) / first : 1;
  g->blocks = g->ntiles > 0 ? (g->ntiles + g->tpb - 1) / g->tpb : 0;
  return cudaSuccess;
}

template <int K, int C1>
cudaError_t launch_wgmma(const Args& a, const void* wrc, const WgGrid& g, cudaStream_t stream) {
  constexpr int smem = v1_smem(K, C1);
  static_assert(smem <= kSmemMax, "shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_v1_wgmma_kernel<K, C1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bwd_v1_wgmma_kernel<K, C1><<<g.blocks, kWgThreads, smem, stream>>>(
      a, static_cast<const __nv_bfloat16*>(wrc), g.tpb, g.ntiles);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_k(const Args& a, const void* wrc, const WgGrid& g, cudaStream_t stream) {
  const int key = a.k * 1000 + a.c1;
  switch (key) {
    case 1032: return launch_wgmma<1, 32>(a, wrc, g, stream);
    case 3032: return launch_wgmma<3, 32>(a, wrc, g, stream);
    case 5032: return launch_wgmma<5, 32>(a, wrc, g, stream);
    case 7032: return launch_wgmma<7, 32>(a, wrc, g, stream);
    case 1064: return launch_wgmma<1, 64>(a, wrc, g, stream);
    case 3064: return launch_wgmma<3, 64>(a, wrc, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core kernel's shapes (one instantiation each): bf16 rows with
// d=16, C1 of 32 or 64, k*C1 <= 224 (its dW registers), 16-byte aligned
// rows and pad columns.
bool wgmma_path(const Args& a, int is_bf16) {
  return is_bf16 && a.d == kD && (a.c1 == 32 || a.c1 == 64) && a.k % 2 == 1 &&
         a.k * a.c1 <= 224 && a.fields <= kMaxWgFields && a.fs % 8 == 0 && a.bs % 8 == 0 &&
         a.lin_col % 8 == 0 && a.w_phys % 8 == 0 && aligned16(a.e) && aligned16(a.de);
}

Args make_args(const void* e, void* de, long long fs, long long bs, int batch, int fields,
               int d, int k, int c1, int lin_col, int w_phys) {
  Args a = {};
  a.e = e;
  a.de = de;
  a.fs = fs;
  a.bs = bs;
  a.batch = batch;
  a.fields = fields;
  a.d = d;
  a.k = k;
  a.c1 = c1;
  a.pairs = fields * (fields - 1) / 2;
  a.kc = k * c1;
  a.lin_col = lin_col;
  a.w_phys = w_phys;
  a.ebl = examples_per_block(batch);
  return a;
}

}  // namespace

extern "C" {

// 1 when these rows take the tensor-core (wgmma) kernel, whose weights come
// in bwd_variants' v1_weight_chunks layout (and g 16-byte aligned); 0 for
// the CUDA-core kernel (wr (p_pad, k*c1)).
int cffm_cross_conv1_bwd_v1_wgmma(int is_bf16, const void* e, const void* de, long long fs,
                                  long long bs, int fields, int d, int k, int c1, int lin_col,
                                  int w_phys) {
  const Args a = make_args(e, const_cast<void*>(de), fs, bs, 0, fields, d, k, c1, lin_col,
                           w_phys);
  return wgmma_path(a, is_bf16) ? 1 : 0;
}

// Rows of the dW partial buffer for a batch on a route (two per block on
// the wgmma route, one per warpgroup), or -1 on a CUDA error.
int cffm_cross_conv1_bwd_v1_blocks(int batch, int wgmma) {
  if (wgmma) {
    WgGrid g;
    return wg_grid(batch, &g) == cudaSuccess ? 2 * g.blocks : -1;
  }
  const int ebl = examples_per_block(batch);
  return (batch + ebl - 1) / ebl;
}

// Returns a cudaError_t; 0 means both kernels were launched. wgmma says
// which kernel and operand layouts, and must be what
// cffm_cross_conv1_bwd_v1_wgmma says. e, de: (fields, batch, w_phys) with
// field stride fs and batch stride bs; wr: (p_pad, k*c1) in T, or the
// chunks of v1_weight_chunks; g: (batch, c1, d) in T; glin: (batch,) f32;
// dwp: (rows of
// cffm_cross_conv1_bwd_v1_blocks, k, pairs, c1) f32 scratch; dw: (k,
// p_pad, c1) f32 out.
int cffm_cross_conv1_bwd_v1(int is_bf16, int wgmma, const void* e, void* de, long long fs,
                            long long bs, const void* wr, const void* g, const float* glin,
                            float* dwp, float* dw, int batch, int fields, int d, int k, int c1,
                            int p_pad, int lin_col, int w_phys, void* stream) {
  Args a = make_args(e, de, fs, bs, batch, fields, d, k, c1, lin_col, w_phys);
  a.wr = wr;
  a.g = g;
  a.glin = glin;
  a.dwp = dwp;
  if (fields < 2 || d < 1 || c1 < 1 || k < 1 || k % 2 == 0 || p_pad < a.pairs ||
      lin_col != fields * d || w_phys <= lin_col || wgmma != (wgmma_path(a, is_bf16) ? 1 : 0) ||
      (wgmma && !aligned16(g)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rows = 0;
  if (batch > 0) {
    cudaError_t err;
    if (wgmma) {
      WgGrid grid;
      if ((err = wg_grid(batch, &grid)) != cudaSuccess) return err;
      rows = 2 * grid.blocks;
      err = launch_wgmma_k(a, wr, grid, s);
    } else {
      rows = cffm_cross_conv1_bwd_v1_blocks(batch, 0);
      err = is_bf16 ? launch_k<__nv_bfloat16>(a, k, rows, s) : launch_k<float>(a, k, rows, s);
    }
    if (err != cudaSuccess) return err;
  }
  const long long n = static_cast<long long>(k) * p_pad * c1;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      dwp, dw, rows, k, a.pairs, p_pad, c1);
  return cudaGetLastError();
}

}  // extern "C"
