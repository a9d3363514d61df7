// Fused pairwise cross + conv layer 1 (+ first-order sum), forward.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// cffm_tpu/ops/interaction_conv.py (launched by `_fwd_pallas`), for all
// four of its entries: the sliced (B,F,F,d)/(B,F,d) rows, flat full rows
// (B,F*W), field-major rows (F,B,W) and the split field-major operands
// (Fs,B,W)+(Fb,B,W) of the hybrid lookup. One kernel takes every layout
// through per-part base pointers, field counts and (field, batch) strides;
// lanes within a field row are contiguous.
//
// What it computes, per example b:
//   M[p=(i<j), x] = E[b,i,j*d+x] * E[b,j,i*d+x]     (field-aware)
//                 = E[b,i,x] * E[b,j,x]              (hadamard)
//   rounded to the input type T, as the TPU kernel rounds it;
//   y[b,c,x] = sum_{p,t} W1[c,p,t] * M[p, x+t-k/2]   (SAME, zero halo),
//   accumulated in f32, stored in T;
//   lin[b] = sum_f E[b,f,lin_col] in f32, when lin is requested.
//
// Design. A block owns `eb` examples and `cb` of the (padded) C1 channels
// (all of them up to kThreads / (d/8) * kTM; a wider layer splits over the
// grid's y axis): the GEMM Y[c,(b,x)] = W[c,(p,t)] * Mwin[(p,t),(b,x)] with
// cb rows, eb*d columns and a depth of P*k. The pair axis is walked in
// chunks of `pcs` pairs (kPC, or fewer where a chunk would not fit shared
// memory): per chunk the block builds the halo-padded cross map of its
// examples and stages the weight chunk, both in shared memory as f32, so
// M never reaches device memory. Each thread owns kTM channels x kTN
// positions of one example and accumulates with CUDA-core FMAs. The
// widths 1-9 are unrolled instantiations; every other odd k takes the
// run-time-k one (K = 0), whose tap loop is not unrolled.
//
// Bound on the H100. At criteo_kaggle shapes (F=39, d=16, W=640, C1=64,
// k=3, bf16) one example reads 39*640*2 B = 49.9 KB of E and needs
// 2*64*16*741*3 = 4.55 MFLOP: about 91 FLOP per byte, under the ~295 the
// card needs to be bound by its bf16 tensor cores, so the function is
// memory-bound on the card. Two kernels: bf16 rows with d=16 and C1<=64
// take cross_conv1_fwd_wgmma_kernel (below: one wgmma GEMM of the stacked
// weights by the cross map, a persistent grid, the cross build overlapped
// with the products); everything else takes cross_conv1_fwd_kernel, whose
// FMAs run on the CUDA cores (about 1/15 of the bf16 tensor-core rate),
// bound by FP32 issue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 4;       // channels per thread (C1 is padded to this)
constexpr int kTN = 8;       // positions per thread
constexpr int kPC = 32;      // pairs per shared-memory chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* e0;        // part 0: fields [0, nf0)
  const void* e1;        // part 1: fields [nf0, fields)
  int nf0;
  long long fs0, bs0;    // part 0 field and batch strides, in elements
  long long fs1, bs1;    // part 1 field and batch strides
  const void* w;         // (P, k, c1p) in T, channels zero-padded to c1p
  void* y;               // (batch, c1, d) in T
  float* lin;            // (batch,) f32, or null
  int batch, fields, d, k, c1, c1p, hadamard, lin_col;
  int eb, ngx, xp;       // examples per block, position groups, padded row
  int cb, pcs;           // CUDA-core kernel: channels per block, pairs per chunk
};

template <typename T>
__device__ __forceinline__ const T* field_row(const Args& a, int f, long long b) {
  if (f < a.nf0) return static_cast<const T*>(a.e0) + f * a.fs0 + b * a.bs0;
  return static_cast<const T*>(a.e1) + (f - a.nf0) * a.fs1 + b * a.bs1;
}

// K > 0: that width, unrolled; K = 0: a.k at run time.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) cross_conv1_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int kk = K > 0 ? K : a.k;
  float* ws = reinterpret_cast<float*>(smem4);   // (pcs, k, cb)
  float* ms = ws + a.pcs * kk * a.cb;            // (eb, pcs, xp)
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  const int half = kk / 2;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int tid = threadIdx.x;
  const int cg = a.cb / kTM;
  const int cgi = tid % cg;                      // channel group
  const int col = tid / cg;                      // (example, position group)
  const int e = col / a.ngx;
  const int xg = col - e * a.ngx;
  const bool active = e < a.eb;
  const long long b0 = static_cast<long long>(blockIdx.x) * a.eb;
  const int c_base = blockIdx.y * a.cb;          // the block's channels
  const int row_elems = a.pcs * a.xp;

  float acc[kTM][kTN];
#pragma unroll
  for (int c = 0; c < kTM; ++c)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[c][n] = 0.f;

  for (int p0 = 0; p0 < pairs; p0 += a.pcs) {
    const int npc = min(a.pcs, pairs - p0);
    if (tid < a.pcs) {
      // anchor field i holds fields-1-i pairs (i, i+1..fields-1)
      int i = 0, rem = p0 + tid;
      while (i < a.fields - 1 && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      pi_s[tid] = i;
      pj_s[tid] = i + 1 + rem;
    }
    const T* wg = static_cast<const T*>(a.w);
    for (int u = tid; u < a.pcs * kk * a.cb; u += kThreads) {
      const int c = u % a.cb;
      const int r = u / a.cb;                    // pc * k + t
      ws[u] = (r / kk < npc && c_base + c < a.c1p)
                  ? to_f(wg[(static_cast<long long>(p0) * kk + r) * a.c1p + c_base + c])
                  : 0.f;
    }
    __syncthreads();

    for (int u = tid; u < a.eb * row_elems; u += kThreads) {
      const int ee = u / row_elems;
      const int r = u - ee * row_elems;
      const int pc = r / a.xp;
      const int x = r - pc * a.xp - half;
      const long long b = b0 + ee;
      float v = 0.f;
      if (x >= 0 && x < a.d && pc < npc && b < a.batch) {
        const int i = pi_s[pc], j = pj_s[pc];
        const T* ri = field_row<T>(a, i, b);
        const T* rj = field_row<T>(a, j, b);
        const float prod = a.hadamard ? to_f(ri[x]) * to_f(rj[x])
                                      : to_f(ri[j * a.d + x]) * to_f(rj[i * a.d + x]);
        v = to_f(from_f<T>(prod));
      }
      ms[u] = v;
    }
    __syncthreads();

    if (active) {
      const float* mbase = ms + e * row_elems + xg * kTN;
      for (int pc = 0; pc < npc; ++pc) {
        const float* mrow = mbase + pc * a.xp;
        const float* wrow = ws + pc * kk * a.cb + cgi * kTM;
        if constexpr (K > 0) {
          float mw[kTN + K - 1];
#pragma unroll
          for (int q = 0; q < kTN + K - 1; ++q) mw[q] = mrow[q];
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + t * a.cb);
            const float wv[kTM] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int c = 0; c < kTM; ++c)
#pragma unroll
              for (int n = 0; n < kTN; ++n) acc[c][n] = fmaf(wv[c], mw[n + t], acc[c][n]);
          }
        } else {
          for (int t = 0; t < kk; ++t) {
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + t * a.cb);
            const float wv[kTM] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int c = 0; c < kTM; ++c)
#pragma unroll
              for (int n = 0; n < kTN; ++n) acc[c][n] = fmaf(wv[c], mrow[n + t], acc[c][n]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (active && b0 + e < a.batch) {
    T* yb = static_cast<T*>(a.y) + (b0 + e) * a.c1 * a.d;
#pragma unroll
    for (int c = 0; c < kTM; ++c) {
      const int ch = c_base + cgi * kTM + c;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int x = xg * kTN + n;
        if (ch < a.c1 && x < a.d) yb[ch * a.d + x] = from_f<T>(acc[c][n]);
      }
    }
  }
  if (a.lin != nullptr && blockIdx.y == 0 && tid < a.eb && b0 + tid < a.batch) {
    const long long b = b0 + tid;
    float s = 0.f;
    for (int f = 0; f < a.fields; ++f) s += to_f(field_row<T>(a, f, b)[a.lin_col]);
    a.lin[b] = s;
  }
}

size_t core_smem(const Args& a) {
  return (static_cast<size_t>(a.pcs) * a.k * a.cb + static_cast<size_t>(a.eb) * a.pcs * a.xp) *
         sizeof(float);
}

template <typename T, int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = core_smem(a);
  // opt in every time: the static pair tables count against the default
  // 48 KB too, so a dynamic size just under it can still need the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_fwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.batch + a.eb - 1) / a.eb),
                  static_cast<unsigned>((a.c1p + a.cb - 1) / a.cb));
  cross_conv1_fwd_kernel<T, K><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const Args& a, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 9: return launch<T, 9>(a, stream);
    default: return k >= 1 && k % 2 == 1 ? launch<T, 0>(a, stream) : cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: d == 16, C1 <= 64, 16-byte aligned rows (wgmma).
//
// The conv's shift is folded into the GEMM's rows: with W_t = W1[:, :, t],
// y[c, x] = sum_t Z[t*C1 + c, x + t - k/2] (zero outside [0, 16)) where
// Z = A * M, A = [W_0; ...; W_{k-1}] the stacked weights (k*C1, P) and M
// the cross map (P, examples*16). One block per SM walks tiles of kNE
// examples (a persistent grid, so B=4096 runs in one wave). The pair axis
// goes in chunks of kWP pairs through a ring of stages in shared memory,
// each stage a slice of A (one bulk copy from the wrapper's layout, see
// interaction_conv.wgmma_weights) and the tile's cross map for those
// pairs. The producer warpgroup builds the cross map: a thread takes one
// pair and reads 32 bytes of each of the pair's two rows for each of its
// examples, multiplies them in bf16 (the product rounded to bf16, as the
// TPU kernel rounds M to the input type) and stores the 16 products as two
// 16-byte runs, MN-major: B is [pair][example*16 + x], which wgmma reads
// with its transpose bit. The consumer warpgroups each own 64 rows of Z
// (kTPW m-tiles of 64) and keep their f32 sums in registers over the whole
// pair loop, one wgmma m64nNk16 per 16 pairs. mbarriers hand stages over:
// "full" counts the producer's threads and the bulk copy's bytes, "empty"
// the consumers' threads; a consumer releases a stage once the wgmma
// group after it is issued and its own group has completed. The epilogue
// writes Z to shared memory two examples at a time, shift-adds the k row
// blocks and stores y in bf16; the producer meanwhile starts the next
// tile. lin's terms are loaded as a tile starts, so their latency hides
// behind the pair loop, and summed once per example, in field order.
// Shared memory layouts, without swizzle, in 8x8 core matrices of 128
// contiguous bytes (8 rows of 16 bytes):
//   A stage: [k-step (16 pairs)][8-row group][pair half][row][8 pairs]:
//     K-major, LBO 128 B (between the pair halves), SBO 256 B (row groups);
//   B stage: [k-step][8-position group][pair half][pair][8 positions]:
//     MN-major, LBO 128 B (between the pair halves), SBO 256 B (position
//     groups).
// ---------------------------------------------------------------------------

constexpr int kD = 16;             // embed dim of this path
constexpr int kWP = 64;            // pairs per chunk
constexpr int kKSteps = kWP / 16;  // wgmma k-steps per chunk
constexpr int kZS = 40;            // f32 row stride of the epilogue's Z tile
constexpr int kBarBytes = 128;     // shared bytes of the ring's barriers
constexpr int kMaxFields = 128;    // fields this path takes (lin's staging)
constexpr int kSmemMax = 232448;   // shared memory a block may use on the H100

// m-tiles of 64 rows of A: k*C1 rows
__host__ __device__ constexpr int wg_mtiles(int k, int c1) { return (k * c1 + 63) / 64; }

template <int MT>
struct WgLayout {
  static constexpr int kNE = MT <= 4 ? 8 : 4;   // examples per tile
  static constexpr int kTPW = MT <= 4 ? 1 : 2;  // m-tiles per consumer warpgroup
  static constexpr int kNWG = (MT + kTPW - 1) / kTPW;
  static constexpr int kN = kNE * kD;           // GEMM columns per tile
  static constexpr int kThreads = (kNWG + 1) * 128;
  static constexpr int kABytes = MT * 64 * kWP * 2;
  static constexpr int kBBytes = kWP * kN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kHead = kBarBytes + kNE * kMaxFields * 4;  // barriers, lin's terms
  static constexpr int kZBytes = MT * 64 * kZS * 4;
  static constexpr int kStages0 = (kSmemMax - kHead - kZBytes) / kStageBytes;
  static constexpr int kStages = kStages0 < 4 ? kStages0 : 4;
  static constexpr int kSmem = kHead + kStages * kStageBytes + kZBytes;
  static_assert(kStages >= 2, "the ring needs two stages");
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

// shared-memory matrix descriptor, no swizzle
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

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32, this thread's N/2) += A (64 x 16, K-major) * B (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int MT>
__global__ void __launch_bounds__(WgLayout<MT>::kThreads, 1)
    cross_conv1_fwd_wgmma_kernel(Args a, int ntiles) {
  using L = WgLayout<MT>;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + L::kStages;
  float* lin_s = reinterpret_cast<float*>(smem + kBarBytes);  // (kNE, fields)
  unsigned char* ring = smem + L::kHead;
  float* zs = reinterpret_cast<float*>(ring + L::kStages * L::kStageBytes);

  const int tid = threadIdx.x;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int nq = (pairs + kWP - 1) / kWP;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 128 + 1);
      mbar_init(empty + s, L::kNWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == L::kNWG) {
    // producer: the weight slice by bulk copy, the cross tile by hand
    const int pt = tid - L::kNWG * 128;
    const int pc = pt % kWP;  // the thread's pair in each chunk
    const int eg = pt / kWP;  // examples eg, eg + 2, ...
    constexpr int kEU = L::kNE / 2;
    const int ks = pc / 16, kh = (pc % 16) / 8, kr = pc % 8;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long b0 = static_cast<long long>(tile) * L::kNE;
      int pi = 0, rem = pc;  // pair (pi, pi + 1 + rem)
      while (pi < a.fields - 1 && rem >= a.fields - 1 - pi) {
        rem -= a.fields - 1 - pi;
        ++pi;
      }
      for (int q = 0; q < nq; ++q, ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty + s, ((it / L::kStages) & 1) ^ 1);
        unsigned char* st = ring + s * L::kStageBytes;
        if (pt == 0) {
          mbar_arrive_tx(full + s, L::kABytes);
          const unsigned char* w = static_cast<const unsigned char*>(a.w);
          bulk_copy(st, w + static_cast<size_t>(q) * L::kABytes, L::kABytes, full + s);
        }
        const bool pv = q * kWP + pc < pairs;
        const int i = pi, j = pi + 1 + rem;
        uint4 va[kEU][2], vb[kEU][2];
#pragma unroll
        for (int u = 0; u < kEU; ++u) {
          const long long b = b0 + eg + 2 * u;
          if (pv && b < a.batch) {
            const uint4* ri = reinterpret_cast<const uint4*>(field_row<bf>(a, i, b) +
                                                             (a.hadamard ? 0 : j * kD));
            const uint4* rj = reinterpret_cast<const uint4*>(field_row<bf>(a, j, b) +
                                                             (a.hadamard ? 0 : i * kD));
            va[u][0] = __ldg(ri);
            va[u][1] = __ldg(ri + 1);
            vb[u][0] = __ldg(rj);
            vb[u][1] = __ldg(rj + 1);
          } else {
            va[u][0] = va[u][1] = vb[u][0] = vb[u][1] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        unsigned char* bt = st + L::kABytes;
#pragma unroll
        for (int u = 0; u < kEU; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint4 prod;
            const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&va[u][h]);
            const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&vb[u][h]);
            __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&prod);
#pragma unroll
            for (int n = 0; n < 4; ++n) z[n] = __hmul2(x[n], y[n]);
            const int ng = (eg + 2 * u) * 2 + h;
            *reinterpret_cast<uint4*>(bt + ((ks * 2 * L::kNE + ng) * 2 + kh) * 128 + kr * 16) =
                prod;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + s);
        rem += kWP;
        while (pi < a.fields - 1 && rem >= a.fields - 1 - pi) {
          rem -= a.fields - 1 - pi;
          ++pi;
        }
      }
    }
    return;
  }

  // consumers
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ct = tid;  // consumer thread, 0 .. kNWG*128-1
  const int half = a.k / 2;
  float acc[L::kTPW][L::kN / 2];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b0 = static_cast<long long>(tile) * L::kNE;
#pragma unroll
    for (int tp = 0; tp < L::kTPW; ++tp) {
#pragma unroll
      for (int r = 0; r < L::kN / 2; ++r) acc[tp][r] = 0.f;
      wg_pin<L::kN / 2>(acc[tp]);
    }
    // lin's terms E[b, f, lin_col], loaded now and summed in the epilogue
    const int nlin = a.lin != nullptr ? L::kNE * a.fields : 0;
    float lv = 0.f;
    if (ct < nlin && b0 + ct / a.fields < a.batch)
      lv = to_f(field_row<bf>(a, ct % a.fields, b0 + ct / a.fields)[a.lin_col]);
    int prev = 0;
    for (int q = 0; q < nq; ++q, ++it) {
      const int s = it % L::kStages;
      mbar_wait(full + s, (it / L::kStages) & 1);
      const unsigned char* st = ring + s * L::kStageBytes;
      wg_fence();
#pragma unroll
      for (int k = 0; k < kKSteps; ++k) {
        const uint64_t db = wg_desc(st + L::kABytes + k * 2 * L::kNE * 256, 128, 256);
#pragma unroll
        for (int tp = 0; tp < L::kTPW; ++tp) {
          const int mt = wg * L::kTPW + tp;
          if (mt < MT)
            wgmma_bf16<L::kN>(acc[tp], wg_desc(st + (k * MT + mt) * 8 * 256, 128, 256), db);
        }
      }
      wg_commit();
      if (q > 0) {
        wg_wait<1>();
        mbar_arrive(empty + prev);
      }
      prev = s;
    }
    wg_wait<0>();
#pragma unroll
    for (int tp = 0; tp < L::kTPW; ++tp) wg_pin<L::kN / 2>(acc[tp]);
    mbar_arrive(empty + prev);

    // epilogue, two examples (32 columns of Z) at a time
    if (ct < nlin) lin_s[ct] = lv;
    for (int u = ct + L::kNWG * 128; u < nlin; u += L::kNWG * 128)
      lin_s[u] = b0 + u / a.fields < a.batch
                     ? to_f(field_row<bf>(a, u % a.fields, b0 + u / a.fields)[a.lin_col])
                     : 0.f;
#pragma unroll
    for (int qq = 0; qq < L::kNE / 2; ++qq) {
#pragma unroll
      for (int tp = 0; tp < L::kTPW; ++tp) {
        const int mt = wg * L::kTPW + tp;
        if (mt < MT) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int r = (qq * 4 + jj) * 4 + hi * 2;
              float* z = zs + (mt * 64 + warp * 16 + gid + 8 * hi) * kZS + jj * 8 + tig * 2;
              *reinterpret_cast<float2*>(z) = make_float2(acc[tp][r], acc[tp][r + 1]);
            }
        }
      }
      named_sync(1, L::kNWG * 128);
      for (int u = ct; u < a.c1 * 16; u += L::kNWG * 128) {
        const int c = u / 16, e = (u % 16) / 8, x0 = (u % 8) * 2;
        float s0 = 0.f, s1 = 0.f;
        for (int t = 0; t < a.k; ++t) {
          const float* zr = zs + (t * a.c1 + c) * kZS + e * 16;
          const int xa = x0 + t - half;
          if (xa >= 0 && xa < kD) s0 += zr[xa];
          if (xa + 1 >= 0 && xa + 1 < kD) s1 += zr[xa + 1];
        }
        const long long b = b0 + qq * 2 + e;
        if (b < a.batch)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf*>(a.y) + (b * a.c1 + c) * kD + x0) =
              __floats2bfloat162_rn(s0, s1);
      }
      if (qq == L::kNE / 2 - 1 && nlin > 0 && ct < L::kNE && b0 + ct < a.batch) {
        float sl = 0.f;  // in field order
        for (int f = 0; f < a.fields; ++f) sl += lin_s[ct * a.fields + f];
        a.lin[b0 + ct] = sl;
      }
      named_sync(1, L::kNWG * 128);
    }
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

template <int MT>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using L = WgLayout<MT>;
  cudaError_t err = cudaFuncSetAttribute(cross_conv1_fwd_wgmma_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int ntiles = (a.batch + L::kNE - 1) / L::kNE;
  const int blocks = ntiles < sms ? ntiles : sms;
  cross_conv1_fwd_wgmma_kernel<MT><<<blocks, L::kThreads, L::kSmem, stream>>>(a, ntiles);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_mt(const Args& a, cudaStream_t stream) {
  switch (wg_mtiles(a.k, a.c1)) {
    case 1: return launch_wgmma<1>(a, stream);
    case 2: return launch_wgmma<2>(a, stream);
    case 3: return launch_wgmma<3>(a, stream);
    case 4: return launch_wgmma<4>(a, stream);
    case 5: return launch_wgmma<5>(a, stream);
    case 6: return launch_wgmma<6>(a, stream);
    case 7: return launch_wgmma<7>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core path reads field rows with 16-byte loads; its m-tiles
// are instantiated up to 7 (k=9 at C1=64 takes the CUDA-core kernel).
bool wgmma_path(int is_bf16, const void* e0, const void* e1, long long fs0, long long bs0,
                long long fs1, long long bs1, int fields, int d, int k, int c1) {
  const long long strides[] = {fs0, bs0, fs1, bs1};
  for (long long st : strides)
    if (st % 8 != 0) return false;
  return is_bf16 && d == kD && c1 <= 64 && wg_mtiles(k, c1) <= 7 && fields <= kMaxFields &&
         aligned16(e0) && aligned16(e1);
}

}  // namespace

extern "C" {

// Channel padding the CUDA-core kernel's weight operand must carry: w is
// (P, k, round_up(c1, tile)).
int cffm_cross_conv1_fwd_channel_tile() { return kTM; }

// 1 when these rows take the tensor-core (wgmma) kernel, whose weight
// operand is the stacked layout of interaction_conv.wgmma_weights; 0 for
// the CUDA-core kernel.
int cffm_cross_conv1_fwd_wgmma(int is_bf16, const void* e0, const void* e1, long long fs0,
                               long long bs0, long long fs1, long long bs1, int fields, int d,
                               int k, int c1) {
  return wgmma_path(is_bf16, e0, e1, fs0, bs0, fs1, bs1, fields, d, k, c1) ? 1 : 0;
}

// Returns a cudaError_t; 0 means the kernel was launched. wgmma says which
// weight layout w is in, and must be what cffm_cross_conv1_fwd_wgmma says.
int cffm_cross_conv1_fwd(int is_bf16, int wgmma, const void* e0, const void* e1, int nf0,
                         long long fs0, long long bs0, long long fs1, long long bs1,
                         const void* w, void* y, float* lin, int batch, int fields, int d,
                         int k, int c1, int hadamard, int lin_col, void* stream) {
  Args a;
  a.e0 = e0;
  a.e1 = e1;
  a.nf0 = nf0;
  a.fs0 = fs0;
  a.bs0 = bs0;
  a.fs1 = fs1;
  a.bs1 = bs1;
  a.w = w;
  a.y = y;
  a.lin = lin;
  a.batch = batch;
  a.fields = fields;
  a.d = d;
  a.k = k;
  a.c1 = c1;
  a.c1p = (c1 + kTM - 1) / kTM * kTM;
  a.hadamard = hadamard;
  a.lin_col = lin_col;
  a.ngx = (d + kTN - 1) / kTN;
  if (fields < 2 || d < 1 || c1 < 1 || a.ngx > kThreads) return cudaErrorInvalidValue;
  // channels per block: C1 split evenly over the fewest blocks whose
  // threads cover them; then the pairs per chunk that fit shared memory
  const int cb_max = kThreads / a.ngx * kTM;
  const int nblk = (a.c1p + cb_max - 1) / cb_max;
  a.cb = ((a.c1p + nblk - 1) / nblk + kTM - 1) / kTM * kTM;
  a.eb = kThreads / (a.ngx * (a.cb / kTM));
  a.xp = a.ngx * kTN + k - 1;
  const long long per_pair =
      (static_cast<long long>(k) * a.cb + static_cast<long long>(a.eb) * a.xp) * sizeof(float);
  const long long fit = (kSmemMax - 2 * kPC * static_cast<long long>(sizeof(int))) / per_pair;
  a.pcs = fit < kPC ? static_cast<int>(fit) : kPC;
  if (a.pcs < 1) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma != (wgmma_path(is_bf16, e0, e1, fs0, bs0, fs1, bs1, fields, d, k, c1) ? 1 : 0) ||
      (reinterpret_cast<uintptr_t>(y) & 3) != 0)
    return cudaErrorInvalidValue;
  if (wgmma) return launch_wgmma_mt(a, s);
  return is_bf16 ? launch_k<__nv_bfloat16>(a, k, s) : launch_k<float>(a, k, s);
}

}  // extern "C"
