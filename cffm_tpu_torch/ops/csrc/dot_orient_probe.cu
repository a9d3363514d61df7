// Probe: the tensor cores' feed in three operand orientations.
//
// Replaces the Pallas TPU kernel of scripts/probe_dot_orient.py (`_mk`, the
// kernel body; launched at :68). The TPU probe asked which operand
// orientation its matrix unit lowers natively; on Hopper the same question
// is asked of mma.sync: out (M, N) = sum over D of L (M x K) . R (K x N),
// bf16 operands, f32 sums, with each mode keeping its operands in its own
// layout in device memory:
//   lane  L = a (P, BT) K-contiguous,        R = b (KC, BT) K-contiguous
//   sub   L = a (BT, P) M-contiguous (a^T),  R = b (BT, KC) N-contiguous
//   rhs   L = b (BT, KC) K-contiguous,       R = a (KC, P) N-contiguous
// (lane and sub give out (P, KC), rhs gives out (BT, P)). A block owns a
// 32 x 32 output tile (four warps, 16 x 16 each) and stages its L rows and
// R columns in shared memory once, in the stored orientation. Per step it
// sums the D products into fresh f32 registers, reloading the fragments for
// every product: ldmatrix for a K-contiguous operand, ldmatrix.trans for an
// M- or N-contiguous one. After the last step each output element is
// written once, by its owning thread: the TPU grid rewrote one block per
// step, but parallel blocks must not race. Ragged tiles (M = 744 in lane and
// sub is not a multiple of 16 or 32) are staged as zeros and masked on the
// store.
//
// Bound on the H100: steps * D * M * N * K MACs over the dense bf16 peak,
// 2 * 1.498e11 / 989e12 = 0.303 ms at the probe's shapes (BT=128, P=744,
// KC=192, D=16, 512 steps); the operands are a few hundred KB. What bounds
// this kernel: mma.sync (not wgmma) with two independent accumulators per
// warp and an ldmatrix per fragment per product, one to two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32, kBN = 32;   // block tile
constexpr int kThreads = 128;       // four warps, 16 x 16 each
constexpr int kPad = 8;             // bf16 row padding (16 bytes): no bank conflicts

using bf = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const bf* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// L_KC: L stored [m][k] (else [k][m]); R_KC: R stored [n][k] (else [k][n]).
template <bool L_KC, bool R_KC>
__global__ void __launch_bounds__(kThreads) probe_kernel(const bf* __restrict__ l,
                                                         const bf* __restrict__ r,
                                                         float* __restrict__ out, int m, int n,
                                                         int k, int steps, int d) {
  extern __shared__ float4 smem4[];
  bf* ls = reinterpret_cast<bf*>(smem4);
  const int lstride = L_KC ? k + kPad : kBM + kPad;
  const int rstride = R_KC ? k + kPad : kBN + kPad;
  bf* rs = ls + (L_KC ? kBM : k) * lstride;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  const bf zero = __float2bfloat16_rn(0.f);

  // stage the block's operands once, in the stored orientation
  for (int u = tid; u < kBM * k; u += kThreads) {
    if (L_KC) {
      const int mm = u / k, kk = u - mm * k;
      ls[mm * lstride + kk] = m0 + mm < m ? l[static_cast<long long>(m0 + mm) * k + kk] : zero;
    } else {
      const int kk = u / kBM, mm = u - kk * kBM;
      ls[kk * lstride + mm] = m0 + mm < m ? l[static_cast<long long>(kk) * m + m0 + mm] : zero;
    }
  }
  for (int u = tid; u < kBN * k; u += kThreads) {
    if (R_KC) {
      const int nn = u / k, kk = u - nn * k;
      rs[nn * rstride + kk] = n0 + nn < n ? r[static_cast<long long>(n0 + nn) * k + kk] : zero;
    } else {
      const int kk = u / kBN, nn = u - kk * kBN;
      rs[kk * rstride + nn] = n0 + nn < n ? r[static_cast<long long>(kk) * n + n0 + nn] : zero;
    }
  }
  __syncthreads();

  // per-lane ldmatrix row addresses (x4: lanes 8i..8i+7 give matrix i's rows)
  const int r8 = lane & 7, mi = lane >> 3;
  // A (16 x 16 at wm): matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
  const bf* la = L_KC ? ls + (wm + r8 + (mi & 1) * 8) * lstride + (mi >> 1) * 8
                      : ls + (r8 + (mi >> 1) * 8) * lstride + wm + (mi & 1) * 8;
  const long long la_k = L_KC ? 1 : lstride;   // step of one k in elements
  // B (16 k x 16 n at wn): matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  const bf* rb = R_KC ? rs + (wn + r8 + (mi >> 1) * 8) * rstride + (mi & 1) * 8
                      : rs + (r8 + (mi & 1) * 8) * rstride + wn + (mi >> 1) * 8;
  const long long rb_k = R_KC ? 1 : rstride;

  float acc[2][4];
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      for (int k0 = 0; k0 < k; k0 += 16) {
        uint32_t a[4], b[4];
        if (L_KC) ldsm_x4(a, la + k0 * la_k);
        else ldsm_x4_trans(a, la + k0 * la_k);
        if (R_KC) ldsm_x4(b, rb + k0 * rb_k);
        else ldsm_x4_trans(b, rb + k0 * rb_k);
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mm = m0 + wm + gid + (q >> 1) * 8;
      const int nn = n0 + wn + j * 8 + 2 * tig + (q & 1);
      if (steps > 0 && mm < m && nn < n) out[static_cast<long long>(mm) * n + nn] = acc[j][q];
    }
}

template <bool L_KC, bool R_KC>
cudaError_t launch(const bf* l, const bf* r, float* out, int m, int n, int k, int steps, int d,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(L_KC ? kBM : k) * (L_KC ? k + kPad : kBM + kPad) +
                       static_cast<size_t>(R_KC ? kBN : k) * (R_KC ? k + kPad : kBN + kPad)) *
                      sizeof(bf);
  const cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<L_KC, R_KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  probe_kernel<L_KC, R_KC><<<grid, kThreads, smem, stream>>>(l, r, out, m, n, k, steps, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0 lane: a (p, bt), b (kc, bt) -> out (p, kc)
// mode 1 sub:  a (bt, p), b (bt, kc) -> out (p, kc)
// mode 2 rhs:  a (kc, p), b (bt, kc) -> out (bt, p)
// All bf16 row-major, out f32. The contraction (bt, or kc in rhs) must be a
// multiple of 16. Returns a cudaError_t.
int cffm_dot_orient_probe(int mode, const void* a, const void* b, float* out, int bt, int p,
                          int kc, int steps, int d, void* stream) {
  const bf* av = static_cast<const bf*>(a);
  const bf* bv = static_cast<const bf*>(b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bt < 1 || p < 1 || kc < 1 || steps < 1 || d < 1) return cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      if (bt % 16) return cudaErrorInvalidValue;
      return launch<true, true>(av, bv, out, p, kc, bt, steps, d, s);
    case 1:
      if (bt % 16) return cudaErrorInvalidValue;
      return launch<false, false>(av, bv, out, p, kc, bt, steps, d, s);
    case 2:
      if (kc % 16) return cudaErrorInvalidValue;
      return launch<true, false>(bv, av, out, bt, p, kc, steps, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
