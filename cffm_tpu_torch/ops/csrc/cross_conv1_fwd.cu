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
// memory-bound on the card. This simple design does not reach that
// bound: its FMAs run on the CUDA cores (about 1/15 of the bf16
// tensor-core rate), so it is bound by FP32 issue instead. Left on the
// table: wgmma on bf16 tiles of M fed from shared memory, TMA loads of
// the field rows, and a persistent grid that overlaps one tile's cross
// build with the previous tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

// Channel padding the weight operand must carry: w is (P, k, round_up(c1, tile)).
int cffm_cross_conv1_fwd_channel_tile() { return kTM; }

// Returns a cudaError_t; 0 means the kernel was launched.
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
  return is_bf16 ? launch_k<__nv_bfloat16>(a, k, s) : launch_k<float>(a, k, s);
}

}  // extern "C"
