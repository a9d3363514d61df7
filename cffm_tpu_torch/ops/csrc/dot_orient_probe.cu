// Probe: the tensor cores' feed in three operand orientations, on wgmma.
//
// Replaces the Pallas TPU kernel of scripts/probe_dot_orient.py (`_mk`, the
// kernel body; launched at :68). The TPU probe asked which operand
// orientation its matrix unit lowers natively. On Hopper the question
// belongs to wgmma, which reads both operands from shared memory either
// K-major or MN-major (its transpose bits). Per step the kernel computes
// out (M, N) = sum over D of L (M x K) . R (K x N), bf16 operands, f32
// sums, with each mode's operands staged in their stored orientation:
//   lane  L = a (P, BT)  K-major,            R = b^T, b (KC, BT) K-major
//   sub   L = a^T, a (BT, P) MN-major,       R = b (BT, KC) MN-major
//   rhs   L = b (BT, KC) K-major,            R = a (KC, P) MN-major
// (lane and sub give out (P, KC), rhs gives out (BT, P)). An MN-major
// operand is read with its transpose bit set; nothing is transposed while
// staging, so a mode's time is the price of its orientation.
//
// Design. The output is cut into m64 x N tiles (N = 192 for lane and sub,
// 248 for rhs: 12 x 1 and 2 x 3 tiles at the probe's shapes). The steps
// are independent (each starts from zero and only the last is written),
// so the grid is (tile, step range): split s of `splits` takes steps
// [s*steps/splits, (s+1)*steps/splits), with splits chosen so that the
// grid holds about two blocks per SM (probe_grid). A block stages its L
// rows and R columns once, in 8x8 core matrices without swizzle (the
// layout kernels 1 and 2 use), and its two warpgroups take alternate
// steps of its range, each one chain of D * K/16 wgmma m64nNk16 into its
// own accumulator (the first with scale-d 0), so two chains overlap on
// the SM's tensor cores. Only the warpgroup that owns step steps-1 writes
// its tile; every other product is computed and dropped (asm volatile
// wgmma, so none can be elided). Rows and columns past M and N are staged
// as zeros and masked on the store. The MACs the kernel issues are the
// tiles' (padded) products; `macs()` counts steps * D * M * N * K.
//
// Bound on the H100: steps * D * M * N * K MACs over the dense bf16 peak,
// 2 * 1.498e11 / 989e12 = 0.303 ms at the probe's shapes (BT=128, P=744,
// KC=192, D=16, 512 steps); the operands are a few hundred KB. What bounds
// this design: the tensor cores' rate for one wgmma chain per warpgroup
// and the padded rows of the ragged m-tile (744 of 768 rows are real).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf = __nv_bfloat16;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kSmemMax = 232448;   // shared memory a block may use on the H100
constexpr int kBlocksPerSm = 2;    // blocks per SM the step split aims at

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

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 192, f32, this thread's 96) = scale_d * d + A (64 x 16) * B (16 x 192);
// TA / TB = 1 read A / B MN-major (the transpose bits), 0 K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 248, f32, this thread's 124) = scale_d * d + A (64 x 16) * B (16 x 248);
// TA / TB = 1 read A / B MN-major (the transpose bits), 0 K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n248(float (&d)[124], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %126, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n248k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123}, "
      "%124, %125, p, 1, 1, %127, %128;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}


template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 192) wgmma_n192<TA, TB>(d, a, b, scale_d);
  else wgmma_n248<TA, TB>(d, a, b, scale_d);
}

// Byte offset of element (r, c) of a tile staged in 8x8 core matrices of
// 128 contiguous bytes (8 rows of 16 bytes, the row dimension being the
// stored matrix's outer one): core matrix (r/8, c/8) at (r/8 * cgs + c/8) * 128.
__device__ __forceinline__ int core_off(int r, int c, int cgs) {
  return ((r >> 3) * cgs + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// TA = 0: l stored [m][k] (K-major), 1: [k][m] (MN-major); TB = 0: r stored
// [n][k] (K-major), 1: [k][n] (MN-major). The block owns the m64 x N tile
// (blockIdx.x / ntiles, blockIdx.x % ntiles) and the steps of split
// blockIdx.y.
template <int N, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1) probe_kernel(const bf* __restrict__ l,
                                                            const bf* __restrict__ r,
                                                            float* __restrict__ out, int m, int n,
                                                            int k, int steps, int d, int ntiles,
                                                            int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* as = smem;                 // L tile: 64 x k
  unsigned char* bs = smem + 64 * k * 2;    // R tile: N x k
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / ntiles) * 64, n0 = (blockIdx.x % ntiles) * N;
  const int kg = k / 8;
  const bf zero = __float2bfloat16_rn(0.f);

  // stage both tiles once, in the stored orientation (threads along the
  // stored rows' contiguous axis)
  for (int u = tid; u < 64 * k; u += kThreads) {
    if (TA == 0) {
      const int mm = u / k, kk = u - mm * k;
      *reinterpret_cast<bf*>(as + core_off(mm, kk, kg)) =
          m0 + mm < m ? l[static_cast<long long>(m0 + mm) * k + kk] : zero;
    } else {
      const int kk = u / 64, mm = u - kk * 64;
      *reinterpret_cast<bf*>(as + core_off(kk, mm, 8)) =
          m0 + mm < m ? l[static_cast<long long>(kk) * m + m0 + mm] : zero;
    }
  }
  for (int u = tid; u < N * k; u += kThreads) {
    if (TB == 0) {
      const int nn = u / k, kk = u - nn * k;
      *reinterpret_cast<bf*>(bs + core_off(nn, kk, kg)) =
          n0 + nn < n ? r[static_cast<long long>(n0 + nn) * k + kk] : zero;
    } else {
      const int kk = u / N, nn = u - kk * N;
      *reinterpret_cast<bf*>(bs + core_off(kk, nn, N / 8)) =
          n0 + nn < n ? r[static_cast<long long>(kk) * n + n0 + nn] : zero;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // descriptors of k-step 0 and their advance per k-step (16 of K = two
  // core matrices along K)
  const uint32_t a_lbo = TA == 0 ? 128 : 8 * 128, a_sbo = TA == 0 ? kg * 128 : 128;
  const uint32_t b_lbo = TB == 0 ? 128 : (N / 8) * 128, b_sbo = TB == 0 ? kg * 128 : 128;
  const uint64_t a0 = wg_desc(as, a_lbo, a_sbo), b0 = wg_desc(bs, b_lbo, b_sbo);
  // the descriptor's start address is in 16-byte units in its low bits
  const uint64_t a_step = (2 * a_lbo) >> 4, b_step = (2 * b_lbo) >> 4;

  // the warpgroup, uniform across each warp as the compiler sees it (else
  // it serialises the wgmma chain)
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int s_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * steps / splits);
  const int s_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * steps / splits);
  const int ksteps = k / 16;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wg_fence();
  for (int s = s_begin + wg; s < s_end; s += 2) {
    for (int dd = 0; dd < d; ++dd)
      for (int ks = 0; ks < ksteps; ++ks)
        wgmma_n<N, TA, TB>(acc, a0 + ks * a_step, b0 + ks * b_step, (dd | ks) != 0);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  wg_pin<N / 2>(acc);

  // the warpgroup that owns the last step writes the tile: row 16*warp +
  // lane/4 + 8h, column 8j + 2*(lane%4) + e holds acc[4j + 2h + e]
  if (s_end != steps || s_end <= s_begin || (steps - 1 - s_begin) % 2 != wg) return;
  const int ct = tid % 128, warp = ct / 32, lane = ct % 32;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mm = m0 + 16 * warp + lane / 4 + 8 * h;
        const int nn = n0 + 8 * j + 2 * (lane % 4) + e;
        if (mm < m && nn < n) out[static_cast<long long>(mm) * n + nn] = acc[4 * j + 2 * h + e];
      }
}

// (N-tile width, m-tiles, n-tiles, splits) of a launch
struct Grid {
  int nw, mtiles, ntiles, splits;
};

Grid probe_grid(int nw, int m, int n, int steps, int sms) {
  Grid g;
  g.nw = nw;
  g.mtiles = (m + 63) / 64;
  g.ntiles = (n + nw - 1) / nw;
  const int tiles = g.mtiles * g.ntiles;
  const int want = (kBlocksPerSm * sms + tiles - 1) / tiles;
  g.splits = want < 1 ? 1 : (want > steps ? steps : want);
  return g;
}

size_t probe_smem(int nw, int k) { return static_cast<size_t>(64 + nw) * k * sizeof(bf); }

// SMs of the current device
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int N, int TA, int TB>
cudaError_t launch(const bf* l, const bf* r, float* out, int m, int n, int k, int steps, int d,
                   cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Grid g = probe_grid(N, m, n, steps, sms);
  const size_t smem = probe_smem(N, k);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(probe_kernel<N, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(g.mtiles * g.ntiles, g.splits);
  probe_kernel<N, TA, TB><<<grid, kThreads, smem, stream>>>(l, r, out, m, n, k, steps, d,
                                                            g.ntiles, g.splits);
  return cudaGetLastError();
}

// the N-tile width of a mode
int mode_width(int mode) { return mode == 2 ? 248 : 192; }

}  // namespace

extern "C" {

// The launch a mode takes at these shapes on a card of `sms` SMs:
// grid[0..3] = N-tile width, m-tiles, n-tiles, step splits. Returns the
// dynamic shared memory in bytes.
long long cffm_dot_orient_probe_grid(int mode, int bt, int p, int kc, int steps, int sms,
                                     int* grid) {
  const int m = mode == 2 ? bt : p, n = mode == 2 ? p : kc, k = mode == 2 ? kc : bt;
  const Grid g = probe_grid(mode_width(mode), m, n, steps, sms);
  grid[0] = g.nw;
  grid[1] = g.mtiles;
  grid[2] = g.ntiles;
  grid[3] = g.splits;
  return static_cast<long long>(probe_smem(g.nw, k));
}

// mode 0 lane: a (p, bt), b (kc, bt) -> out (p, kc)
// mode 1 sub:  a (bt, p), b (bt, kc) -> out (p, kc)
// mode 2 rhs:  a (kc, p), b (bt, kc) -> out (bt, p)
// All bf16 row-major, out f32. The contraction (bt, or kc in rhs) must be a
// multiple of 16 and the tiles must fit shared memory. Returns a cudaError_t.
int cffm_dot_orient_probe(int mode, const void* a, const void* b, float* out, int bt, int p,
                          int kc, int steps, int d, void* stream) {
  const bf* av = static_cast<const bf*>(a);
  const bf* bv = static_cast<const bf*>(b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bt < 1 || p < 1 || kc < 1 || steps < 1 || d < 1) return cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      if (bt % 16) return cudaErrorInvalidValue;
      return launch<192, 0, 0>(av, bv, out, p, kc, bt, steps, d, s);
    case 1:
      if (bt % 16) return cudaErrorInvalidValue;
      return launch<192, 1, 1>(av, bv, out, p, kc, bt, steps, d, s);
    case 2:
      if (kc % 16) return cudaErrorInvalidValue;
      return launch<248, 0, 1>(bv, av, out, bt, p, kc, steps, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
