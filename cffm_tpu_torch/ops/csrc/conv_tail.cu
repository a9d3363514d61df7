// The conv tail after kernel 1: layer 1's bias, ReLU and max-pool, then
// conv 2 with its bias, ReLU and max-pool, in one pass over kernel 1's
// output; and its backward, in one pass over that output and the
// features' gradient.
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
//
// Backward (`cffm_conv_tail_bwd`, launched by
// `ops/interaction_conv.conv_tail_bwd` from a train step's autograd): the
// gradient g (B, C2 * 4) bf16 of the features and the saved y give
//   g_s[b, c2, x]  = g[b, c2*4 + x/2] at the first maximum of conv 2's pool
//                    window, if positive, else 0 (torch.max's and the
//                    ReLU's backward), bf16
//   g_p1[b, c, x]  = bf16(sum_{c2, t} w2[c2, c, t] * g_s[b, c2, x - t + 1]), f32 sum
//   gy[b, c, 2x+i] = g_p1[b, c, x] routed likewise through layer 1's pool and ReLU
//   dW2[c2, c, t]  = bf16(sum_{b, x} g_s[b, c2, x] * p1[b, c, x + t - 1])
//   db1 = bf16(sum_{b, x} gy), db2 = bf16(sum_{b, x} g_s), all sums f32,
// in the parameters' dtype: the eager chain's rounding points. p1 and s are
// recomputed from y as the forward computes them: conv 2's products and
// their order are the forward kernel's, so its sums, and the pools'
// winners, are the forward's bit for bit.
//
// Bound: memory. At B = 65536 it reads y (134 MB) and g (33.6 MB) and
// writes gy (134 MB) once: 0.090 ms at 3.35 TB/s; its three products
// (conv 2 again, its input gradient, its weight gradient) are 38.7 GFLOP,
// 0.039 ms at the bf16 peak.
//
// Design: a persistent grid of one block an SM, 8 warps, walks tiles of 16
// examples; one thread keeps the next tile of y and g in flight with bulk
// copies on mbarriers. Per tile, with a block barrier after each of A and B
// (P has a buffer for each of two tiles in turn, so the next tile's A does
// not wait for this tile's D):
//   A  layer 1's bias, ReLU and pool into P, as the forward;
//   B  conv 2 on mma.sync, its bias; conv 2's pool and ReLU route g into
//      Gs (bf16, a zero halo row at each end); db2's sums in registers;
//   C  the input gradient on mma.sync (rows (example, position), depth
//      (tap, c2), width C1), rounded, routed through layer 1's pool and
//      ReLU against the staged y and stored as gy in 8-byte words (a
//      warp's store covers whole 32-byte rows of gy); db1's sums;
//   D  dW2 on mma.sync (m = c2, n = (tap, c), depth = the tile's
//      (example, position), both operands by ldmatrix.trans), its sums in
//      registers for the whole kernel.
// At the end each block writes its partial sums, and a second launch adds
// them in a fixed order and rounds once: two calls give the same bits. At
// B = 65536 (64, 64) on an H100 it runs 0.19 ms, about 48% of its bound:
// the phases run in lockstep in all 8 warps, whose registers dW2's sums
// fill, so copies and arithmetic overlap only across tiles. One copy of w2
// read transposed for the input gradient ran 3% slower, a barrier after D
// in place of P's second buffer 2% slower, gy in 4-byte words 2% slower,
// and 3 stages in place of 2 no faster.

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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBT = 16;        // examples a tile
constexpr int kBWarps = 8;
constexpr int kBThreads = kBWarps * 32;

template <int C1, int C2>
struct BwdLayout {
  static constexpr int kStages = 2;                   // tiles of (y, g) staged
  // P (layer 1's pooled output, as the forward's; two buffers, a tile's
  // and the next's) and Gs (conv 2's output gradient), each per example 10
  // position rows with a zero halo row at each end, padded as the
  // forward's P: the 8 rows of every ldmatrix phase fall on distinct banks
  static constexpr int kPS = C1 + 8;
  static constexpr int kES = 10 * kPS + 56;
  static constexpr int kGPS = C2 + 8;
  static constexpr int kGES = 10 * kGPS + 56;
  // w2 twice, as the two products read it: W2f[c2][t C1 + c] for conv 2,
  // W2d[c][t C2 + c2] for its input gradient (rows padded as above)
  static constexpr int kWFS = kTaps * C1 + 8;
  static constexpr int kWDS = kTaps * C2 + 8;
  static constexpr int kYBytes = kBT * C1 * kD * 2;   // a tile of y
  static constexpr int kGBytes = kBT * C2 * kP2 * 2;  // a tile of g
  static constexpr int kStageBytes = kYBytes + kGBytes;
  static constexpr int kBiasOff = kBarBytes;
  static constexpr int kW2fOff = kBiasOff + (C1 + C2 / 2) * 4 + 127 & ~127;
  static constexpr int kW2dOff = kW2fOff + (C2 * kWFS * 2 + 127 & ~127);
  static constexpr int kRingOff = kW2dOff + (C1 * kWDS * 2 + 127 & ~127);
  static constexpr int kPOff = kRingOff + kStages * kStageBytes;
  static constexpr int kGsOff = kPOff + 2 * (kBT * kES * 2 + 127 & ~127);
  static constexpr int kSmem = kGsOff + kBT * kGES * 2;
  // a block's partial sums: dW2 (C2, C1, 3), db1, db2
  static constexpr int kSums = C2 * C1 * kTaps + C1 + C2;
  static_assert(kSmem <= 232448, "the tail backward's shared memory exceeds the H100's");
  static_assert((kPS / 2) % 16 == 4 && (kGPS / 2) % 16 == 4 && (kWFS / 2) % 16 == 4 &&
                    (kWDS / 2) % 16 == 4 && (kES / 2) % 32 == 4 && (kGES / 2) % 32 == 4,
                "bank layout");
  static_assert(4 * (C1 + C2) * 4 <= kStages * kStageBytes, "the bias sums' scratch");
};

struct BwdArgs {
  const __nv_bfloat16* y;
  const __nv_bfloat16* g;
  const void* w2;
  const void* b1;
  const void* b2;
  int params_bf16;
  __nv_bfloat16* gy;
  float* sums;  // (gridDim.x, kSums) f32, each block's partial sums
  long long batch;
  long long ntiles;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The gradient of one pool window (a, b) of ReLU'd values, as torch.max's
// and the ReLU's backward give it: g (bf16 bits) to the first maximum of
// the window if that maximum is > 0, zero elsewhere. Returns (ga, gb) in
// the low and high halves.
__device__ __forceinline__ uint32_t route(float a, float b, uint32_t g) {
  const bool second = b > a;
  if (!((second ? b : a) > 0.0f)) return 0u;
  return second ? g << 16 : g;
}

// route() of both halves of the bf16 pairs xa (first positions) and xb
// (second positions), whose gradients are the halves of gw; returns the
// (first, second) words of the low half's channel in .x, the high half's in .y
__device__ __forceinline__ uint2 route2(uint32_t xa, uint32_t xb, uint32_t gw) {
  const uint32_t lo = route(lo_f(xa), lo_f(xb), gw & 0xffffu);
  const uint32_t hi = route(hi_f(xa), hi_f(xb), gw >> 16);
  return make_uint2(lo, hi);
}

// f32 value of each half of a bf16 pair, summed
__device__ __forceinline__ float pair_sum(uint32_t w) { return lo_f(w) + hi_f(w); }

template <int C1, int C2>
__global__ void __launch_bounds__(kBThreads, 1) conv_tail_bwd_kernel(const BwdArgs a) {
  using L = BwdLayout<C1, C2>;
  using bf = __nv_bfloat16;
  constexpr int kStages = L::kStages;
  constexpr int kNF = C2 / 16;         // conv 2: n-tiles of 8 a warp (half of C2)
  constexpr int kKF = kTaps * C1 / 16; // conv 2: depth steps (tap, channel)
  constexpr int kND = C1 / 16;         // input gradient: n-tiles a warp (half of C1)
  constexpr int kKD = kTaps * C2 / 16; // input gradient: depth steps (tap, c2)
  constexpr int kMW = C2 / 32;         // dW2: m-tiles of 16 a warp (half of C2)
  constexpr int kNW = kTaps * C1 / 32; // dW2: n-tiles of 8 a warp (a quarter of 3 C1)
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint32_t* b1s = reinterpret_cast<uint32_t*>(smem + L::kBiasOff);  // (b1[c], b1[c])
  uint32_t* b2s = b1s + C1;                                           // (b2[n], b2[n+1]), n even
  bf* w2f = reinterpret_cast<bf*>(smem + L::kW2fOff);
  bf* w2d = reinterpret_cast<bf*>(smem + L::kW2dOff);
  unsigned char* ring = smem + L::kRingOff;
  bf* ps = reinterpret_cast<bf*>(smem + L::kPOff);
  bf* gs = reinterpret_cast<bf*>(smem + L::kGsOff);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const long long stride = gridDim.x;

  // the copies of the block's it-th tile of y and g into stage it % kStages
  auto fetch = [&](int it) {
    const long long tile = blockIdx.x + it * stride;
    if (tile >= a.ntiles) return;
    const long long b0 = tile * kBT;
    const long long n = a.batch - b0 < kBT ? a.batch - b0 : kBT;
    const uint32_t ybytes = static_cast<uint32_t>(n * C1 * kD * 2);
    const uint32_t gbytes = static_cast<uint32_t>(n * C2 * kP2 * 2);
    const int s = it % kStages;
    unsigned char* st = ring + s * L::kStageBytes;
    mbar_arrive_tx(full + s, ybytes + gbytes);
    bulk_copy(st, a.y + b0 * C1 * kD, ybytes, full + s);
    bulk_copy(st + L::kYBytes, a.g + b0 * C2 * kP2, gbytes, full + s);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < kStages; ++it) fetch(it);
  }

  // under the first copies: the biases in bf16 pairs, w2 in both layouts,
  // the halo rows of P and Gs
  for (int c = tid; c < C1; c += kBThreads) {
    const bf v = param(a.b1, c, a.params_bf16);
    b1s[c] = pack(v, v);
  }
  for (int n = tid; n < C2 / 2; n += kBThreads)
    b2s[n] = pack(param(a.b2, 2 * n, a.params_bf16), param(a.b2, 2 * n + 1, a.params_bf16));
  // unrolled, so that a thread's loads of w2 are in flight together
  static_assert(C2 * C1 * kTaps % kBThreads == 0, "w2 splits over the block");
#pragma unroll 12
  for (int k = 0; k < C2 * C1 * kTaps / kBThreads; ++k) {
    const int i = tid + k * kBThreads;
    const int c2 = i / (C1 * kTaps), c = (i / kTaps) % C1, t = i % kTaps;
    const bf v = param(a.w2, i, a.params_bf16);
    w2f[c2 * L::kWFS + t * C1 + c] = v;
    w2d[c * L::kWDS + t * C2 + c2] = v;
  }
  for (int i = tid; i < 2 * kBT * C1; i += kBThreads) {  // both P buffers
    bf* p = ps + (i / C1) * L::kES + i % C1;
    p[0] = p[(kP1 + 1) * L::kPS] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < kBT * C2; i += kBThreads) {
    bf* p = gs + (i / C2) * L::kGES + i % C2;
    p[0] = p[(kP1 + 1) * L::kGPS] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int r = lane & 15, khalf = lane >> 4;
  // conv 2 and the input gradient: a warp owns m-tiles 2 wm, 2 wm + 1 of
  // the tile's 8 (2 examples each) and half of the n-tiles
  const int wm = warp >> 1, wn = warp & 1;
  // dW2: a warp owns half of C2 and a quarter of (tap, c1)
  const int wm2 = warp >> 2, wn2 = warp & 3;
  const uint32_t ps_u32 = smem_u32(ps), gs_u32 = smem_u32(gs);
  // this lane's ldmatrix rows: both products' A as the forward's (row r <
  // 8 of an m-tile at position 2 (r % 4) of example r / 4, row r + 8 the
  // position after it), in P and in Gs; the B operands' rows n, depth
  // halves by lane / 8
  const int a_row_f = ((r & 7) >> 2) * L::kES + (2 * (r & 3) + (r >> 3)) * L::kPS + khalf * 8;
  const int a_row_d = ((r & 7) >> 2) * L::kGES + (2 * (r & 3) + (r >> 3)) * L::kGPS + khalf * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const uint32_t w2f_lane = smem_u32(w2f + (wn * (C2 / 2) + b_row) * L::kWFS + b_col);
  const uint32_t w2d_lane = smem_u32(w2d + (wn * (C1 / 2) + b_row) * L::kWDS + b_col);
  // dW2's operands, read transposed: A's rows (example, position) of Gs,
  // this warp's c2 by lane / 8; B's of P, examples by lane / 8
  const int wa_row = (lane >> 4) * L::kGES + ((lane & 7) + 1) * L::kGPS + wm2 * (C2 / 2) +
                     ((lane >> 3) & 1) * 8;
  const int wb_row = ((lane >> 3) & 1) * L::kES + (lane & 7) * L::kPS;

  // dW2's, db1's and db2's sums over the block's tiles
  float accw[kMW][kNW][4] = {};
  float db1[kND][2] = {}, db2[kNF][2] = {};

  for (int it = 0;; ++it) {
    const long long tile = blockIdx.x + it * stride;
    if (tile >= a.ntiles) break;
    const int s = it % kStages;
    const long long b0 = tile * kBT;
    const int nvalid = static_cast<int>(a.batch - b0 < kBT ? a.batch - b0 : kBT);
    const unsigned char* st = ring + s * L::kStageBytes;
    bf* pt = ps + (it & 1) * kBT * L::kES;  // this tile's P
    const uint32_t pt_u32 = ps_u32 + (it & 1) * kBT * L::kES * 2;
    const uint2* y2 = reinterpret_cast<const uint2*>(st);  // y in fours of positions
    const uint16_t* gt = reinterpret_cast<const uint16_t*>(st + L::kYBytes);
    mbar_wait(full + s, (it / kStages) & 1);

    // A: layer 1's bias, ReLU and pool into P, as the forward; an example
    // past the batch reads zeros (its gradient is zero, its P finite)
    const uint4* raw = reinterpret_cast<const uint4*>(st);
#pragma unroll 4
    for (int i = tid; i < kBT * C1 * 2; i += kBThreads) {
      const int e = i / (C1 * 2), c = (i / 2) % C1, h = i & 1;
      const uint4 v = e < nvalid ? raw[i] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t bias = b1s[c];
      const uint32_t x0 = add2(v.x, bias), x1 = add2(v.y, bias);
      const uint32_t x2 = add2(v.z, bias), x3 = add2(v.w, bias);
      const uint32_t w0 = relu_max2(__byte_perm(x0, x1, 0x5410), __byte_perm(x0, x1, 0x7632));
      const uint32_t w1 = relu_max2(__byte_perm(x2, x3, 0x5410), __byte_perm(x2, x3, 0x7632));
      const bool odd = c & 1;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 2);
      const uint32_t lo_a = odd ? got : w0, lo_b = odd ? w1 : got;
      const int j0 = 4 * h + (odd ? 2 : 0);
      uint32_t* row = reinterpret_cast<uint32_t*>(pt + e * L::kES + (1 + j0) * L::kPS + (c & ~1));
      row[0] = __byte_perm(lo_a, lo_b, 0x5410);
      row[L::kPS / 2] = __byte_perm(lo_a, lo_b, 0x7632);
    }
    __syncthreads();
    // every warp is past the last tile's C and D: its stage is read, and
    // B may write Gs; request the tile kStages on from the last
    if (tid == 0 && it > 0) fetch(it - 1 + kStages);

    // B: conv 2 again, with the forward's products in the forward's order
    // (so its sums are the forward kernel's, bit for bit), its bias; the
    // features' gradient routed through conv 2's pool and ReLU into Gs
    {
      float acc[2][kNF][4] = {};
      const uint32_t arow = pt_u32 + 2 * (2 * (2 * wm) * L::kES + a_row_f);
#pragma unroll
      for (int ks = 0; ks < kKF; ++ks) {
        const int t = ks / (C1 / 16), c0 = (ks % (C1 / 16)) * 16;
        uint32_t af[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) ldmatrix_x4(arow + 2 * (2 * u * L::kES + t * L::kPS + c0), af[u]);
#pragma unroll
        for (int np = 0; np < kNF / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(w2f_lane + 2 * (np * 16 * L::kWFS + ks * 16), bq);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16(acc[u][2 * np], af[u], bq[0], bq[1]);
            mma_bf16(acc[u][2 * np + 1], af[u], bq[2], bq[3]);
          }
        }
      }
      // rows g (position 2j) and g + 8 (2j + 1) of example e; columns n, n + 1
      const int j = g & 3;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * (2 * wm + u) + (g >> 2);
        const bool live = e < nvalid;
#pragma unroll
        for (int nt = 0; nt < kNF; ++nt) {
          const int n = wn * (C2 / 2) + nt * 8 + 2 * q;
          const uint32_t bias = b2s[n / 2];
          const uint32_t xa = add2(round2(acc[u][nt][0], acc[u][nt][1]), bias);
          const uint32_t xb = add2(round2(acc[u][nt][2], acc[u][nt][3]), bias);
          const uint16_t* gr = gt + e * C2 * kP2 + n * kP2 + j;  // g of (n, j), (n + 1, j)
          const uint32_t gw = live ? gr[0] | static_cast<uint32_t>(gr[kP2]) << 16 : 0u;
          const uint2 rt = route2(xa, xb, gw);  // (first, second) of n and of n + 1
          const uint32_t first = __byte_perm(rt.x, rt.y, 0x5410);
          const uint32_t second = __byte_perm(rt.x, rt.y, 0x7632);
          uint32_t* row = reinterpret_cast<uint32_t*>(gs + e * L::kGES + (2 * j + 1) * L::kGPS + n);
          row[0] = first;
          row[L::kGPS / 2] = second;
          db2[nt][0] += pair_sum(rt.x);
          db2[nt][1] += pair_sum(rt.y);
        }
      }
    }
    __syncthreads();

    // C: conv 2's input gradient on the tensor cores, rounded to bf16 and
    // routed through layer 1's pool and ReLU into gy
    {
      float acc[2][kND][4] = {};
      const uint32_t arow = gs_u32 + 2 * (2 * (2 * wm) * L::kGES + a_row_d);
#pragma unroll
      for (int ks = 0; ks < kKD; ++ks) {
        const int t = ks / (C2 / 16), c0 = (ks % (C2 / 16)) * 16;
        uint32_t af[2][4];
        // input position x reads conv 2's gradient at x - t + 1: Gs row x - t + 2
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ldmatrix_x4(arow + 2 * (2 * u * L::kGES + (2 - t) * L::kGPS + c0), af[u]);
#pragma unroll
        for (int np = 0; np < kND / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(w2d_lane + 2 * (np * 16 * L::kWDS + ks * 16), bq);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16(acc[u][2 * np], af[u], bq[0], bq[1]);
            mma_bf16(acc[u][2 * np + 1], af[u], bq[2], bq[3]);
          }
        }
      }
      // rows g (position 2j) and g + 8 (2j + 1) of example 2 mt + g / 4, j =
      // g % 4; columns c, c + 1. y's positions 4j..4j+3 of a channel, and
      // gy's, are one 8-byte word: a warp's store covers whole rows of gy
      const int j = g & 3;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * (2 * wm + u) + (g >> 2);
        if (e >= nvalid) continue;
        uint2* out = reinterpret_cast<uint2*>(a.gy) + (b0 + e) * C1 * (kD / 4) + j;
#pragma unroll
        for (int nt = 0; nt < kND; ++nt) {
          const int c = wn * (C1 / 2) + nt * 8 + 2 * q;
          // the input gradient at 2j and 2j + 1, of c (low halves) and c + 1
          const uint32_t g0 = round2(acc[u][nt][0], acc[u][nt][1]);
          const uint32_t g1 = round2(acc[u][nt][2], acc[u][nt][3]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint2 yv = y2[(e * C1 + c + k) * (kD / 4) + j];
            const uint32_t x0 = add2(yv.x, b1s[c + k]), x1 = add2(yv.y, b1s[c + k]);
            const uint2 w = make_uint2(route(lo_f(x0), hi_f(x0), k ? g0 >> 16 : g0 & 0xffffu),
                                       route(lo_f(x1), hi_f(x1), k ? g1 >> 16 : g1 & 0xffffu));
            out[(c + k) * (kD / 4)] = w;
            db1[nt][k] += pair_sum(w.x) + pair_sum(w.y);
          }
        }
      }
    }

    // D: dW2[c2, c, t] += sum over (example, position x) of Gs[x + 1][c2]
    // P[x + t][c], on the tensor cores: m = c2, n = (t, c), depth = the
    // tile's (example, position), two examples a step
#pragma unroll 2
    for (int kk = 0; kk < kBT / 2; ++kk) {
      uint32_t af[kMW][4];
#pragma unroll
      for (int mi = 0; mi < kMW; ++mi)
        ldmatrix_x4_trans(gs_u32 + 2 * (2 * kk * L::kGES + wa_row + mi * 16), af[mi]);
#pragma unroll
      for (int np = 0; np < kNW / 2; ++np) {
        const int n = wn2 * kNW * 8 + np * 16 + (lane >> 4) * 8;
        const int t = n / C1, c = n % C1;
        uint32_t bq[4];
        ldmatrix_x4_trans(pt_u32 + 2 * (2 * kk * L::kES + wb_row + t * L::kPS + c), bq);
#pragma unroll
        for (int mi = 0; mi < kMW; ++mi) {
          mma_bf16(accw[mi][2 * np], af[mi], bq[0], bq[1]);
          mma_bf16(accw[mi][2 * np + 1], af[mi], bq[2], bq[3]);
        }
      }
      if constexpr (kNW % 2 == 1) {
        const int n = wn2 * kNW * 8 + (kNW - 1) * 8;
        const int t = n / C1, c = n % C1;
        uint32_t bq[2];
        ldmatrix_x2_trans(pt_u32 + 2 * (2 * kk * L::kES + wb_row + t * L::kPS + c), bq);
#pragma unroll
        for (int mi = 0; mi < kMW; ++mi) mma_bf16(accw[mi][kNW - 1], af[mi], bq[0], bq[1]);
      }
    }
  }
  __syncthreads();  // the last tile's stage is read

  // the block's partial sums, each in a fixed order: dW2 from this
  // thread's fragments; db1 and db2 over the 8 lanes of one q, then over
  // the 4 warps that share the columns
  float* sums = a.sums + blockIdx.x * static_cast<long long>(L::kSums);
#pragma unroll
  for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNW; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = wm2 * (C2 / 2) + mi * 16 + g + (k >> 1) * 8;
        const int n = wn2 * kNW * 8 + ni * 8 + 2 * q + (k & 1);
        sums[(m * C1 + n % C1) * kTaps + n / C1] = accw[mi][ni][k];
      }
  float* part = reinterpret_cast<float*>(ring);  // (4, C1) then (4, C2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int nt = 0; nt < kND; ++nt) {
      float v = db1[nt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) part[wm * C1 + wn * (C1 / 2) + nt * 8 + 2 * q + h] = v;
    }
#pragma unroll
    for (int nt = 0; nt < kNF; ++nt) {
      float v = db2[nt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) part[4 * C1 + wm * C2 + wn * (C2 / 2) + nt * 8 + 2 * q + h] = v;
    }
  }
  __syncthreads();
  for (int c = tid; c < C1 + C2; c += kBThreads) {
    const float* p = c < C1 ? part + c : part + 4 * C1 + (c - C1);
    const int w = c < C1 ? C1 : C2;
    sums[C2 * C1 * kTaps + c] = ((p[0] + p[w]) + p[2 * w]) + p[3 * w];
  }
}

// The blocks' partial sums added in a fixed order, rounded to bf16 once and
// stored in the parameters' dtype: dW2 (C2, C1, 3), then db1, then db2. A
// block takes 32 sums; its 8 warps add every 8th block's partials each, in
// block order, and one warp adds the 8 results in a fixed tree.
constexpr int kSumParts = 8;

__global__ void __launch_bounds__(32 * kSumParts) conv_tail_bwd_sum_kernel(
    const float* sums, int blocks, int n_sums, int n_w2, int c1, void* dw2, void* db1,
    void* db2, int params_bf16) {
  __shared__ float part[kSumParts][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (i < n_sums) {
#pragma unroll 4
    for (int b = w; b < blocks; b += kSumParts) s += sums[static_cast<long long>(b) * n_sums + i];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w != 0 || i >= n_sums) return;
  const float(&p)[kSumParts][32] = part;
  s = ((p[0][lane] + p[1][lane]) + (p[2][lane] + p[3][lane])) +
      ((p[4][lane] + p[5][lane]) + (p[6][lane] + p[7][lane]));
  void* dst = i < n_w2 ? dw2 : i < n_w2 + c1 ? db1 : db2;
  const int k = i < n_w2 ? i : i < n_w2 + c1 ? i - n_w2 : i - n_w2 - c1;
  const __nv_bfloat16 v = __float2bfloat16_rn(s);
  if (params_bf16)
    static_cast<__nv_bfloat16*>(dst)[k] = v;
  else
    static_cast<float*>(dst)[k] = __bfloat162float(v);
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

template <int C1, int C2>
cudaError_t launch_bwd(const BwdArgs& a, int blocks, void* dw2, void* db1, void* db2,
                       cudaStream_t stream) {
  using L = BwdLayout<C1, C2>;
  static bool sized[64] = {};  // the shared-memory opt-in, set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(conv_tail_bwd_kernel<C1, C2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized[dev] = true;
  }
  conv_tail_bwd_kernel<C1, C2><<<blocks, kBThreads, L::kSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_tail_bwd_sum_kernel<<<(L::kSums + 31) / 32, 32 * kSumParts, 0, stream>>>(
      a.sums, blocks, L::kSums, C2 * C1 * kTaps, C1, dw2, db1, db2, a.params_bf16);
  return cudaGetLastError();
}

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


// The f32 partial sums the backward needs a block: dW2, db1 and db2.
int cffm_conv_tail_bwd_sums(int c1, int c2) { return c2 * c1 * kTaps + c1 + c2; }

// Two launches on one stream: the tail's backward over the batch, then the
// fixed-order sum of its blocks' partials. y (batch, c1, 16) and g (batch,
// c2 * 4) bf16 -> gy (batch, c1, 16) bf16; w2 (c2, c1, 3), b1 (c1,), b2
// (c2,) f32 or (params_bf16) bf16 -> dw2, db1, db2 in the same dtype.
// sums holds max_blocks * cffm_conv_tail_bwd_sums(c1, c2) f32; the grid is
// min(tiles, max_blocks), so a caller that passes the same max_blocks gets
// the same sums, bit for bit. Returns a cudaError_t; 0 means both kernels
// were launched. batch must be > 0.
int cffm_conv_tail_bwd(const void* y, const void* g, const void* w2, const void* b1,
                       const void* b2, int params_bf16, void* gy, void* dw2, void* db1,
                       void* db2, void* sums, int max_blocks, long long batch, int c1, int c2,
                       void* stream) {
  if (!takes(c1) || !takes(c2) || batch <= 0 || max_blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0 || (reinterpret_cast<uintptr_t>(g) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(gy) & 7) != 0)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.w2 = w2;
  a.b1 = b1;
  a.b2 = b2;
  a.params_bf16 = params_bf16;
  a.gy = static_cast<__nv_bfloat16*>(gy);
  a.sums = static_cast<float*>(sums);
  a.batch = batch;
  a.ntiles = (batch + kBT - 1) / kBT;
  const int blocks = static_cast<int>(a.ntiles < max_blocks ? a.ntiles : max_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 64)
    return c2 == 64 ? launch_bwd<64, 64>(a, blocks, dw2, db1, db2, s)
                    : launch_bwd<64, 32>(a, blocks, dw2, db1, db2, s);
  return c2 == 64 ? launch_bwd<32, 64>(a, blocks, dw2, db1, db2, s)
                  : launch_bwd<32, 32>(a, blocks, dw2, db1, db2, s);
}

}  // extern "C"
