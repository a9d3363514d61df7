// The conv tail after kernel 1, forward: layer 1's bias, ReLU and max-pool,
// then conv 2 with its bias, ReLU and max-pool, in one pass over kernel 1's
// output.
//
// `cffm_conv_tail_fwd`, launched by `ops/interaction_conv.conv_tail`,
// replaces no TPU kernel: the JAX package leaves the tail to XLA
// (`cffm_tpu/ops/interaction_conv.py` `_conv_tail`), which fuses it on the
// TPU. Eager PyTorch ran it as about ten passes (the bias add, the clamp,
// the pool's reduce, the pad, cuDNN's layout transposes around conv 2, conv
// 2, its bias add, clamp and pool), each writing a whole intermediate.
//
// Contract: y (B, C1, 16) bf16, contiguous, 16-byte aligned; w2 (C2, C1, 3)
// and the biases b1 (C1,), b2 (C2,) contiguous, f32 or bf16 (cast to bf16 to
// nearest even here, as `.to(torch.bfloat16)` casts them); C1, C2 in {32,
// 64}; k = 3, SAME; pool 2, VALID. out (B, C2 * 4) bf16, channel-major:
//   p1[b, c, j]   = max(relu(bf16(y[b, c, 2j] + b1[c])), relu(bf16(y[b, c, 2j+1] + b1[c])))
//   s[b, c2, x]   = bf16(sum_{c, t} w2[c2, c, t] * p1[b, c, x + t - 1]), f32 sum, zero halo
//   out[b, c2*4 + j] = max over x in {2j, 2j+1} of relu(bf16(s[b, c2, x] + b2[c2]))
// These are the eager chain's rounding points: layer 1 is bit-equal to it,
// and conv 2 differs from cuDNN's only in the order of its f32 sum (for
// finite inputs: the pools' bf16 max drops a NaN that torch.max would keep).
//
// Bound on the H100: memory. At criteo_kaggle's B = 65536 the tail reads y
// once (134 MB) and writes the features once (33.6 MB): 0.050 ms at 3.35
// TB/s. Conv 2's 12.9 GFLOP take 0.013 ms at the bf16 peak.
//
// Design: a persistent grid, one block an SM, walks tiles of kT examples.
// The block's two warp groups take its tiles in turn; one thread of each
// keeps its group's kStages / 2 tiles of y in flight with 1D bulk copies
// (cp.async.bulk, completion on an mbarrier), each tile one contiguous span
// of y. Per tile, a group runs three phases separated by its own barrier:
//   A  every thread reads 16-byte chunks of the staged tile (8 positions of
//      one channel), adds the bias, pools and applies the ReLU in bf16
//      pairs, trades half its results with the neighbouring channel's lane
//      and writes channel pairs into the group's im2col buffer P: per
//      example 10 position rows (a zero halo row at each end) of C1
//      channels, padded so that the ldmatrix reads below hit every bank
//      once;
//   B  conv 2 as a GEMM on the tensor cores (mma.sync m16n8k16, f32
//      accumulation): rows (example, position), depth (tap, channel), width
//      C2. An m16 tile holds 2 examples, row r < 8 at position 2(r % 4) and
//      row r + 8 at the position after it, so each thread holds both
//      positions of a pool window and pools in registers. A warp owns half
//      of C2 for half of the tile; its w2 fragments stay in registers for
//      the whole kernel, loaded once;
//   C  the staged features (kT x C2*4 bf16, contiguous in the output) go
//      out in 16-byte stores.
// After phase A the tile's stage is free, and the group's next tile for it
// is requested, so the copies run under the rest of the work. The two
// groups drift apart, so one's products overlap the other's arithmetic. At
// criteo_kaggle's B = 65536 on an H100 it runs 0.077 ms, 65% of its bound;
// one group over the whole block, with f32 arithmetic, ran 0.128 ms, held
// by the latency of its 8 warps between block-wide barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 16;       // positions of layer 1's output
constexpr int kP1 = 8;       // after layer 1's pool
constexpr int kP2 = 4;       // after conv 2's pool
constexpr int kTaps = 3;
constexpr int kT = 16;       // examples a tile
constexpr int kStages = 4;   // tiles in flight (even: each group has its own)
constexpr int kGroups = 2;   // warp groups, each on its own tiles
constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = kGroupWarps * 32;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kBarBytes = 128;

template <int C1, int C2>
struct Layout {
  static constexpr int kKSteps = kTaps * C1 / 16;     // depth in steps of 16
  static constexpr int kNTiles = C2 / 16;             // n-tiles of 8 a warp (half of C2)
  static constexpr int kMT = kT * 8 / 16 / 2;         // m16 tiles a warp (half of the tile's)
  // P: per example 10 position rows of C1 channels; a row is C1 + 8
  // elements (its word stride = 4 mod 16) and an example 10 rows + 56
  // elements (its word stride = 4 mod 32), so the 8 rows of each ldmatrix
  // phase (4 positions of 2 examples) fall on distinct banks
  static constexpr int kPS = C1 + 8;
  static constexpr int kES = 10 * kPS + 56;
  // the staged features: C2*4 + 32 elements an example (word stride = 16
  // mod 32), so the two examples of an m16 tile store to distinct banks
  static constexpr int kOS = C2 * kP2 + 32;
  static constexpr int kRawBytes = kT * C1 * kD * 2;  // one stage of y
  static constexpr int kPBytes = kT * kES * 2;        // a group's P
  static constexpr int kOBytes = kT * kOS * 2;        // a group's staged features
  static constexpr int kBiasOff = kBarBytes;
  static constexpr int kRingOff = kBiasOff + (C1 + C2 / 2) * 4 + 127 & ~127;
  static constexpr int kPOff = kRingOff + kStages * kRawBytes;
  static constexpr int kOOff = kPOff + kGroups * kPBytes;
  static constexpr int kSmem = kOOff + kGroups * kOBytes;
  static_assert(kSmem <= 232448, "the tail's shared memory exceeds the H100's");
  static_assert(kStages % kGroups == 0 && kMT % 2 == 0, "stages and m-tiles split by group");
  static_assert((kPS / 2) % 16 == 4 && (kES / 2) % 32 == 4 && (kOS / 2) % 32 == 16,
                "bank layout");
};

struct Args {
  const __nv_bfloat16* y;
  const void* w2;
  const void* b1;
  const void* b2;
  int params_bf16;
  __nv_bfloat16* out;
  long long batch;
  long long ntiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a parameter as the eager chain uses it: cast to bf16 (to nearest even)
__device__ __forceinline__ __nv_bfloat16 param(const void* p, int i, int is_bf16) {
  return is_bf16 ? static_cast<const __nv_bfloat16*>(p)[i]
                 : __float2bfloat16_rn(static_cast<const float*>(p)[i]);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A bf16x2 add rounds the exact sum once; eager PyTorch rounds the f32 sum
// to bf16. For two bf16 operands the f32 sum is exact unless their exponents
// lie more than 16 apart, and then both give the larger operand: the same
// bits.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// relu(max(a, b)) of each half (max and relu commute)
__device__ __forceinline__ uint32_t relu_max2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  __nv_bfloat162 r = __hmax2(__hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                     *reinterpret_cast<__nv_bfloat162*>(&b)),
                             zero);
  return *reinterpret_cast<uint32_t*>(&r);
}

// (bf16(lo), bf16(hi)) to nearest even, lo in the low half
__device__ __forceinline__ uint32_t round2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads) : "memory");
}

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 1) conv_tail_fwd_kernel(const Args a) {
  using L = Layout<C1, C2>;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint32_t* b1s = reinterpret_cast<uint32_t*>(smem + L::kBiasOff);  // (b1[c], b1[c])
  uint32_t* b2s = b1s + C1;                                           // (b2[n], b2[n+1]), n even
  unsigned char* ring = smem + L::kRingOff;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int group = warp / kGroupWarps;
  const int gtid = tid % kGroupThreads;
  bf* ps = reinterpret_cast<bf*>(smem + L::kPOff + group * L::kPBytes);
  bf* os = reinterpret_cast<bf*>(smem + L::kOOff + group * L::kOBytes);
  const long long stride = gridDim.x;

  // the copy of the block's it-th tile into stage it % kStages
  auto fetch = [&](int it) {
    const long long tile = blockIdx.x + it * stride;
    if (tile >= a.ntiles) return;
    const long long b0 = tile * kT;
    const long long n = a.batch - b0 < kT ? a.batch - b0 : kT;
    const uint32_t bytes = static_cast<uint32_t>(n * C1 * kD * 2);
    const int s = it % kStages;
    mbar_arrive_tx(full + s, bytes);
    bulk_copy(ring + s * L::kRawBytes, a.y + b0 * C1 * kD, bytes, full + s);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < kStages; ++it) fetch(it);
  }

  // under the first copies: the biases in bf16 pairs, both groups' P halo
  // rows and this warp's w2 fragments (B[k = (t, c), n = c2] = w2[c2, c, t];
  // b0 holds k = 2q, 2q + 1 and b1 k = 2q + 8, 2q + 9 of n = lane / 4, q =
  // lane % 4)
  for (int c = tid; c < C1; c += kThreads) {
    const bf v = param(a.b1, c, a.params_bf16);
    b1s[c] = pack(v, v);
  }
  for (int n = tid; n < C2 / 2; n += kThreads)
    b2s[n] = pack(param(a.b2, 2 * n, a.params_bf16), param(a.b2, 2 * n + 1, a.params_bf16));
  for (int i = tid; i < kGroups * kT * C1; i += kThreads) {
    const int e = i / C1, c = i % C1;  // e counts both groups' examples
    bf* p = reinterpret_cast<bf*>(smem + L::kPOff) + e * L::kES + c;
    p[0] = p[(kP1 + 1) * L::kPS] = __float2bfloat16_rn(0.0f);
  }
  const int gwarp = warp % kGroupWarps;
  const int wn = gwarp & 1;   // half of C2
  const int wm = gwarp >> 1;  // m-tiles kMT * wm .. of the tile's 8
  const int g = lane >> 2, q = lane & 3;
  uint32_t bfrag[L::kKSteps][L::kNTiles][2];
#pragma unroll
  for (int ks = 0; ks < L::kKSteps; ++ks) {
    const int t = ks / (C1 / 16), c0 = (ks % (C1 / 16)) * 16 + 2 * q;
#pragma unroll
    for (int nt = 0; nt < L::kNTiles; ++nt) {
      const int n = wn * (C2 / 2) + nt * 8 + g;
      const int base = n * C1 * kTaps + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 8 * h;
        bfrag[ks][nt][h] = pack(param(a.w2, base + c * kTaps, a.params_bf16),
                                param(a.w2, base + (c + 1) * kTaps, a.params_bf16));
      }
    }
  }
  __syncthreads();

  // this lane's ldmatrix row: r = lane % 16 of the m16 tile, depth half lane / 16
  const int r = lane & 15;
  const int a_row = ((r & 7) >> 2) * L::kES + (2 * (r & 3) + (r >> 3)) * L::kPS + (lane >> 4) * 8;
  const uint32_t ps_u32 = smem_u32(ps);

  // the groups take the block's tiles in turn, each with its own P and
  // staged features, so that one group's products overlap the other's
  // layer-1 and epilogue arithmetic
  for (int it = group;; it += kGroups) {
    const long long tile = blockIdx.x + it * stride;
    if (tile >= a.ntiles) break;
    const int s = it % kStages;
    const long long b0 = tile * kT;
    const int nvalid = static_cast<int>(a.batch - b0 < kT ? a.batch - b0 : kT);
    mbar_wait(full + s, (it / kStages) & 1);

    // A: layer 1's bias, ReLU and pool into P. Chunk i = (e, c, h): 8
    // positions 8h..8h+7 of channel c, in 4 bf16 pairs; lane ^ 2 holds
    // channel c ^ 1
    const uint4* raw = reinterpret_cast<const uint4*>(ring + s * L::kRawBytes);
#pragma unroll 4
    for (int i = gtid; i < kT * C1 * 2; i += kGroupThreads) {
      const int e = i / (C1 * 2), c = (i / 2) % C1, h = i & 1;
      const uint4 v = raw[i];
      const uint32_t bias = b1s[c];
      const uint32_t x0 = add2(v.x, bias), x1 = add2(v.y, bias);
      const uint32_t x2 = add2(v.z, bias), x3 = add2(v.w, bias);
      // (p0, p1) = the pools of positions (0, 1) and (2, 3); (p2, p3) of 4-7
      const uint32_t w0 = relu_max2(__byte_perm(x0, x1, 0x5410), __byte_perm(x0, x1, 0x7632));
      const uint32_t w1 = relu_max2(__byte_perm(x2, x3, 0x5410), __byte_perm(x2, x3, 0x7632));
      const bool odd = c & 1;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 2);
      // even c writes positions 4h, 4h+1 of (c, c+1); odd c 4h+2, 4h+3 of (c-1, c)
      const uint32_t lo_a = odd ? got : w0, lo_b = odd ? w1 : got;
      const int j0 = 4 * h + (odd ? 2 : 0);
      uint32_t* row = reinterpret_cast<uint32_t*>(ps + e * L::kES + (1 + j0) * L::kPS + (c & ~1));
      row[0] = __byte_perm(lo_a, lo_b, 0x5410);
      row[L::kPS / 2] = __byte_perm(lo_a, lo_b, 0x7632);
    }
    group_sync(group);
    // the stage is read: request the tile kStages on (this group's again)
    if (gtid == 0) fetch(it + kStages);

    // B: conv 2 on the tensor cores, then its bias, ReLU and pool; two
    // m-tiles at a time, for two chains of products in flight
#pragma unroll
    for (int mp = 0; mp < L::kMT; mp += 2) {
      float acc[2][L::kNTiles][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < L::kNTiles; ++nt)
          acc[u][nt][0] = acc[u][nt][1] = acc[u][nt][2] = acc[u][nt][3] = 0.0f;
      const int mt0 = wm * L::kMT + mp;  // examples 2 mt, 2 mt + 1 of the tile
      const uint32_t arow = ps_u32 + 2 * (2 * mt0 * L::kES + a_row);
#pragma unroll
      for (int ks = 0; ks < L::kKSteps; ++ks) {
        const int t = ks / (C1 / 16), c0 = (ks % (C1 / 16)) * 16;
        uint32_t af[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) ldmatrix_x4(arow + 2 * (2 * u * L::kES + t * L::kPS + c0), af[u]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < L::kNTiles; ++nt)
            mma_bf16(acc[u][nt], af[u], bfrag[ks][nt][0], bfrag[ks][nt][1]);
      }
      // rows g (position 2j) and g + 8 (2j + 1) of example 2 mt + g / 4,
      // j = g % 4; columns n, n + 1. lane ^ 4 holds j ^ 1
      const int j = g & 3;
      const bool odd = j & 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * (mt0 + u) + (g >> 2);
#pragma unroll
        for (int nt = 0; nt < L::kNTiles; ++nt) {
          const int n = wn * (C2 / 2) + nt * 8 + 2 * q;
          const uint32_t bias = b2s[n / 2];
          // (v(n, j), v(n + 1, j)): conv 2 rounded, the bias added, pooled
          const uint32_t v = relu_max2(add2(round2(acc[u][nt][0], acc[u][nt][1]), bias),
                                       add2(round2(acc[u][nt][2], acc[u][nt][3]), bias));
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v : v >> 16, 4);
          // even j writes (n, j), (n, j + 1); odd j (n + 1, j - 1), (n + 1, j)
          const uint32_t word = odd ? __byte_perm(got, v, 0x7610) : __byte_perm(v, got, 0x5410);
          const int col = odd ? (n + 1) * kP2 + j - 1 : n * kP2 + j;
          *reinterpret_cast<uint32_t*>(os + e * L::kOS + col) = word;
        }
      }
    }
    group_sync(group);

    // C: the tile's features, contiguous in the output, in 16-byte stores
    constexpr int kChunks = C2 * kP2 / 8;  // 16-byte chunks an example
    for (int i = gtid; i < nvalid * kChunks; i += kGroupThreads) {
      const int e = i / kChunks, k = i % kChunks;
      const uint4 v = *reinterpret_cast<const uint4*>(os + e * L::kOS + k * 8);
      *reinterpret_cast<uint4*>(a.out + (b0 + e) * (C2 * kP2) + k * 8) = v;
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

template <int C1, int C2>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<C1, C2>;
  static bool sized[64] = {};  // the shared-memory opt-in, set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(conv_tail_fwd_kernel<C1, C2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized[dev] = true;
  }
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const long long blocks = a.ntiles < sms ? a.ntiles : sms;
  conv_tail_fwd_kernel<C1, C2><<<static_cast<unsigned>(blocks), kThreads, L::kSmem, stream>>>(a);
  return cudaGetLastError();
}

bool takes(int c) { return c == 32 || c == 64; }

}  // namespace

extern "C" {

// One launch: y (batch, c1, 16) bf16 -> out (batch, c2 * 4) bf16; w2 (c2, c1,
// 3), b1 (c1,), b2 (c2,) f32 or (params_bf16) bf16. Returns a cudaError_t;
// 0 means the kernel was launched (or batch was 0).
int cffm_conv_tail_fwd(const void* y, const void* w2, const void* b1, const void* b2,
                       int params_bf16, void* out, long long batch, int c1, int c2,
                       void* stream) {
  if (!takes(c1) || !takes(c2) || batch < 0 || (reinterpret_cast<uintptr_t>(y) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Args a;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.w2 = w2;
  a.b1 = b1;
  a.b2 = b2;
  a.params_bf16 = params_bf16;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.batch = batch;
  a.ntiles = (batch + kT - 1) / kT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 64) return c2 == 64 ? launch<64, 64>(a, s) : launch<64, 32>(a, s);
  return c2 == 64 ? launch<32, 64>(a, s) : launch<32, 32>(a, s);
}

}  // extern "C"
