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
// Design. A block owns `eb` examples and all (padded) C1 channels: the
// GEMM Y[c,(b,x)] = W[c,(p,t)] * Mwin[(p,t),(b,x)] with C1 rows, eb*d
// columns and a depth of P*k. The pair axis is walked in chunks of kPC
// pairs: per chunk the block builds the halo-padded cross map of its
// examples and stages the weight chunk, both in shared memory as f32, so
// M never reaches device memory. Each thread owns kTM channels x kTN
// positions of one example and accumulates with CUDA-core FMAs.
//
// Bound on the H100. At criteo_kaggle shapes (F=39, d=16, W=640, C1=64,
// k=3, bf16) one example reads 39*640*2 B = 49.9 KB of E and needs
// 2*64*16*741*3 = 4.55 MFLOP: about 91 FLOP per byte, under the ~295 the
// card needs to be bound by its bf16 tensor cores, so the function is
// memory-bound on the card. Two kernels: bf16 rows with d=16 and C1<=64
// take cross_conv1_fwd_mma_kernel (below: bf16 mma.sync tiles, f32 sums);
// everything else takes cross_conv1_fwd_kernel, whose FMAs run on the
// CUDA cores (about 1/15 of the bf16 tensor-core rate), bound by FP32
// issue. Left on the table: wgmma fed by TMA loads of the field rows, and
// a persistent grid that overlaps one tile's cross build with the
// previous tile's products.

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
  int batch, fields, d, c1, c1p, hadamard, lin_col;
  int eb, ngx, xp;       // examples per block, position groups, padded row
};

template <typename T>
__device__ __forceinline__ const T* field_row(const Args& a, int f, long long b) {
  if (f < a.nf0) return static_cast<const T*>(a.e0) + f * a.fs0 + b * a.bs0;
  return static_cast<const T*>(a.e1) + (f - a.nf0) * a.fs1 + b * a.bs1;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) cross_conv1_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // (kPC, K, c1p)
  float* ms = ws + kPC * K * a.c1p;              // (eb, kPC, xp)
  __shared__ int pi_s[kPC];
  __shared__ int pj_s[kPC];

  constexpr int kHalf = K / 2;
  const int pairs = a.fields * (a.fields - 1) / 2;
  const int tid = threadIdx.x;
  const int cg = a.c1p / kTM;
  const int cgi = tid % cg;                      // channel group
  const int col = tid / cg;                      // (example, position group)
  const int e = col / a.ngx;
  const int xg = col - e * a.ngx;
  const bool active = e < a.eb;
  const long long b0 = static_cast<long long>(blockIdx.x) * a.eb;
  const int row_elems = kPC * a.xp;

  float acc[kTM][kTN];
#pragma unroll
  for (int c = 0; c < kTM; ++c)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[c][n] = 0.f;

  for (int p0 = 0; p0 < pairs; p0 += kPC) {
    const int npc = min(kPC, pairs - p0);
    if (tid < kPC) {
      // anchor field i holds fields-1-i pairs (i, i+1..fields-1)
      int i = 0, rem = p0 + tid;
      while (i < a.fields - 1 && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      pi_s[tid] = i;
      pj_s[tid] = i + 1 + rem;
    }
    const T* wg = static_cast<const T*>(a.w) + static_cast<long long>(p0) * K * a.c1p;
    const int wvalid = npc * K * a.c1p;
    for (int u = tid; u < kPC * K * a.c1p; u += kThreads)
      ws[u] = u < wvalid ? to_f(wg[u]) : 0.f;
    __syncthreads();

    for (int u = tid; u < a.eb * row_elems; u += kThreads) {
      const int ee = u / row_elems;
      const int r = u - ee * row_elems;
      const int pc = r / a.xp;
      const int x = r - pc * a.xp - kHalf;
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
        float mw[kTN + K - 1];
#pragma unroll
        for (int q = 0; q < kTN + K - 1; ++q) mw[q] = mrow[q];
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(ws + (pc * K + t) * a.c1p + cgi * kTM);
          const float wv[kTM] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int c = 0; c < kTM; ++c)
#pragma unroll
            for (int n = 0; n < kTN; ++n) acc[c][n] = fmaf(wv[c], mw[n + t], acc[c][n]);
        }
      }
    }
    __syncthreads();
  }

  if (active && b0 + e < a.batch) {
    T* yb = static_cast<T*>(a.y) + (b0 + e) * a.c1 * a.d;
#pragma unroll
    for (int c = 0; c < kTM; ++c) {
      const int ch = cgi * kTM + c;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int x = xg * kTN + n;
        if (ch < a.c1 && x < a.d) yb[ch * a.d + x] = from_f<T>(acc[c][n]);
      }
    }
  }
  if (a.lin != nullptr && tid < a.eb && b0 + tid < a.batch) {
    const long long b = b0 + tid;
    float s = 0.f;
    for (int f = 0; f < a.fields; ++f) s += to_f(field_row<T>(a, f, b)[a.lin_col]);
    a.lin[b] = s;
  }
}

template <typename T, int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kPC) * K * a.c1p + static_cast<size_t>(a.eb) * kPC * a.xp) *
      sizeof(float);
  // opt in every time: the static pair tables count against the default
  // 48 KB too, so a dynamic size just under it can still need the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_fwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((a.batch + a.eb - 1) / a.eb);
  cross_conv1_fwd_kernel<T, K><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const Args& a, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: d == 16, C1 <= 64, 16-byte aligned rows.
//
// One block owns kEBM examples, one warp each, and walks the pair axis in
// chunks of kPCM pairs. Per chunk it stages the weights as [t][c][p] and
// the transposed, halo-padded cross map as [e][q][p] (pairs contiguous), so
// y[c, x] += W[c, (p, t)] * M[p, x+t-k/2] runs as mma.sync.m16n8k16 (bf16
// in, f32 sums): 16 channels x 8 positions per tile, 16 pairs per k-step.
// A warp keeps its example's whole (C1, 16) output in registers across the
// pair loop. The products are rounded to bf16 before the sums, as on the
// CUDA-core path.
// ---------------------------------------------------------------------------

constexpr int kD = 16;       // embed dim of this path
constexpr int kEBM = 8;      // examples per block (one warp each)
constexpr int kPCM = 32;     // pairs per chunk (two k-steps)
constexpr int kRowM = kPCM + 8;  // bf16 row stride of the staged tiles

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
__host__ __device__ constexpr int mma_smem_elems(int k, int c1) {
  return k * mma_c16(c1) * kRowM + kEBM * (kD + k - 1) * kRowM;
}

template <int K>
__global__ void __launch_bounds__(kThreads) cross_conv1_fwd_mma_kernel(Args a) {
  using bf = __nv_bfloat16;
  constexpr int kHalf = K / 2;
  constexpr int kQ = kD + 2 * kHalf;
  extern __shared__ float4 smem4[];
  const int c16 = mma_c16(a.c1);
  bf* ws = reinterpret_cast<bf*>(smem4);   // [t][c][p] = W1[c, p0+p, t]
  bf* mt = ws + K * c16 * kRowM;           // [e][q][p] = M[b, p0+p, q - k/2]
  __shared__ int pi_s[kPCM];
  __shared__ int pj_s[kPCM];

  const int pairs = a.fields * (a.fields - 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long b0 = static_cast<long long>(blockIdx.x) * kEBM;
  const bf zero = __float2bfloat16_rn(0.f);
  const int ctiles = c16 / 16;

  // halo rows stay zero: the staging writes interior rows only
  for (int u = tid; u < mma_smem_elems(K, a.c1) / 8; u += kThreads)
    smem4[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  const bf* wg = static_cast<const bf*>(a.w);  // (P, K, c1p), c1p a multiple of kTM
  for (int p0 = 0; p0 < pairs; p0 += kPCM) {
    const int npc = min(kPCM, pairs - p0);
    __syncthreads();  // the previous chunk's tiles are consumed
    if (tid < kPCM) {
      int i = 0, rem = p0 + tid;
      while (i < a.fields - 1 && rem >= a.fields - 1 - i) {
        rem -= a.fields - 1 - i;
        ++i;
      }
      pi_s[tid] = i;
      pj_s[tid] = i + 1 + rem;
    }
    for (int u = tid; u < kPCM * K * c16; u += kThreads) {
      const int c = u % c16;
      const int r = u / c16;
      const int t = r % K;
      const int p = r / K;
      ws[(t * c16 + c) * kRowM + p] =
          (c < a.c1 && p < npc) ? wg[(static_cast<long long>(p0 + p) * K + t) * a.c1p + c] : zero;
    }
    __syncthreads();  // pair tables
    for (int u = tid; u < kEBM * kPCM * 2; u += kThreads) {
      const int hf = u & 1;
      const int pc = (u >> 1) % kPCM;
      const int e = (u >> 1) / kPCM;
      const long long b = b0 + e;
      uint4 ua = make_uint4(0u, 0u, 0u, 0u), ub = ua;
      if (pc < npc && b < a.batch) {
        const int i = pi_s[pc], j = pj_s[pc];
        ua = *reinterpret_cast<const uint4*>(field_row<bf>(a, i, b) + (a.hadamard ? 0 : j * kD) +
                                             hf * 8);
        ub = *reinterpret_cast<const uint4*>(field_row<bf>(a, j, b) + (a.hadamard ? 0 : i * kD) +
                                             hf * 8);
      }
      const bf* av = reinterpret_cast<const bf*>(&ua);
      const bf* bv = reinterpret_cast<const bf*>(&ub);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mt[(e * kQ + kHalf + hf * 8 + n) * kRowM + pc] =
            __float2bfloat16_rn(__bfloat162float(av[n]) * __bfloat162float(bv[n]));
    }
    __syncthreads();

    const bf* me = mt + warp * kQ * kRowM;
#pragma unroll
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int ks = 0; ks < kPCM; ks += 16) {
        uint32_t b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf* row = me + (nt * 8 + gid + t) * kRowM + ks + 2 * tig;
          b[nt][0] = ld32(row);
          b[nt][1] = ld32(row + 8);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= ctiles) break;
          const bf* w = ws + (t * c16 + m * 16) * kRowM + ks + 2 * tig;
          const uint32_t a0 = ld32(w + gid * kRowM), a1 = ld32(w + (gid + 8) * kRowM);
          const uint32_t a2 = ld32(w + gid * kRowM + 8), a3 = ld32(w + (gid + 8) * kRowM + 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[m][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
      }
    }
  }

  const long long b = b0 + warp;
  if (b < a.batch) {
    bf* yb = static_cast<bf*>(a.y) + b * a.c1 * kD;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = m * 16 + gid + rr * 8;
          if (m < ctiles && c < a.c1)
            *reinterpret_cast<__nv_bfloat162*>(yb + c * kD + nt * 8 + 2 * tig) =
                __floats2bfloat162_rn(acc[m][nt][rr * 2], acc[m][nt][rr * 2 + 1]);
        }
  }
  if (a.lin != nullptr && tid < kEBM && b0 + tid < a.batch) {
    const long long bl = b0 + tid;
    float s = 0.f;
    for (int f = 0; f < a.fields; ++f) s += to_f(field_row<bf>(a, f, bl)[a.lin_col]);
    a.lin[bl] = s;
  }
}

template <int K>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(mma_smem_elems(K, a.c1)) * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      cross_conv1_fwd_mma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((a.batch + kEBM - 1) / kEBM);
  cross_conv1_fwd_mma_kernel<K><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma_k(const Args& a, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_mma<1>(a, stream);
    case 3: return launch_mma<3>(a, stream);
    case 5: return launch_mma<5>(a, stream);
    case 7: return launch_mma<7>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core path reads field rows with 16-byte loads.
bool mma_path(const Args& a, int is_bf16) {
  const long long strides[] = {a.fs0, a.bs0, a.fs1, a.bs1};
  for (long long st : strides)
    if (st % 8 != 0) return false;
  return is_bf16 && a.d == kD && a.c1 <= 64 && aligned16(a.e0) && aligned16(a.e1) &&
         aligned16(a.y);
}

}  // namespace

extern "C" {

// Channel padding the weight operand must carry: w is (P, k, round_up(c1, tile)).
int cffm_cross_conv1_fwd_channel_tile() { return kTM; }

// Returns a cudaError_t; 0 means the kernel was launched. bf16 rows take
// the tensor-core kernel where mma_path allows, else the CUDA-core kernel.
int cffm_cross_conv1_fwd(int is_bf16, const void* e0, const void* e1, int nf0,
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
  a.c1 = c1;
  a.c1p = (c1 + kTM - 1) / kTM * kTM;
  a.hadamard = hadamard;
  a.lin_col = lin_col;
  a.ngx = (d + kTN - 1) / kTN;
  const int per_example = a.ngx * (a.c1p / kTM);
  if (fields < 2 || d < 1 || c1 < 1 || per_example > kThreads) return cudaErrorInvalidValue;
  a.eb = kThreads / per_example;
  a.xp = a.ngx * kTN + k - 1;
  if (batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_path(a, is_bf16)) return launch_mma_k(a, k, s);
  return is_bf16 ? launch_k<__nv_bfloat16>(a, k, s) : launch_k<float>(a, k, s);
}

}  // extern "C"
