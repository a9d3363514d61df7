// Field-major embedding lookup: (B, F) ids -> the compute-dtype operands of
// the split field-major interaction entry, in one pass.
//
// `cffm_embed_lookup_fm`, launched by `ops/embed_lookup.lookup_fm`, replaces
// no TPU kernel: the JAX package leaves this lookup to XLA (`jnp.take` of the
// big fields' rows, the one-hot product over the small-field prefix, the cast
// to the compute dtype), which fuses the gather and the cast on the TPU. Eager
// PyTorch ran it as three passes, each writing a whole intermediate:
// index_select in the table's dtype, the cast, and the prefix's where.
//
// Contract: table (V, W) f32 or bf16 with contiguous rows, W % 8 == 0; ids
// (B, F) int32 or int64, read through their strides (so ids.t() of a (B, F)
// tensor, or a slice of it, costs no copy); the fs leading fields form the
// small-field prefix, field f holding the global ids [bounds[f], bounds[f+1]).
//   out_small[f, b]      = table[ids[b, f]] when that id lies in field f's
//                          block, else a row of zeros (the one-hot product's
//                          answer), for f < fs;
//   out_big[f - fs, b]   = table[clamp(ids[b, f], 0, V - 1)] (jnp.take's
//                          "clip"), for f >= fs;
// both (rows, B, W) and contiguous, in the output dtype: f32 -> bf16 rounds to
// nearest even (`cvt.rn`, as `.to(torch.bfloat16)` does on the card), bf16 ->
// f32 widens, and equal dtypes are copied bit for bit.
//
// Bound on the H100: memory. Each output row is written once and the outputs
// are most of the bytes: at criteo_kaggle, B = 65536, 39 fields x 640 lanes
// of bf16, 3.27 GB. The distinct table rows it needs (about 68k of the 1.7M
// big-field ids under zipf(1.3) traffic, 174 MB in f32, and the 832-row
// prefix) and the ids add 0.19 GB: 3.46 GB, 1.03 ms at 3.35 TB/s.
//
// Design: one pass, no intermediate in device memory. A warp copies
// kRowsPerWarp consecutive output rows: lane k reads row k's id once and
// works out its source row (-1 for a row of zeros), and a shuffle hands it to
// every lane. Each lane then loads its 16-byte column groups of all those rows
// before it stores any (kRowsPerWarp loads of 32 bytes in flight a lane, 64
// warps an SM: enough to cover the latency of rows read at random), converts
// in registers, and writes 16 bytes of bf16 at a time with streaming stores
// (st.global.cs, evict-first), so that the 3.27 GB of output does not push the
// zipf-hot table rows out of the 50 MB L2. At criteo_kaggle's B = 65536 on an
// H100 it runs at 83% of that bound; an L2 evict-last policy on the table's
// loads made it 3% slower, and was left out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxSmall = 512;  // prefix fields the arguments carry

struct Args {
  const void* table;
  long long vocab;                 // V
  int w;                           // W
  const void* ids;
  long long stride_b, stride_f;    // the ids' strides, in elements
  long long batch;                 // B
  long long rows;                  // F * B output rows
  long long small_rows;            // fs * B of them go to out_small
  int fs;
  void* out_small;
  void* out_big;
  int bounds[kMaxSmall + 1];       // the prefix fields' blocks
};

// The 8 values of one 16-byte column group of bf16: 16 bytes of T = bf16,
// 32 of T = float.
template <typename T>
struct Group {
  uint4 q[sizeof(T) / 2];
};

__device__ __forceinline__ uint32_t bf16x2(uint32_t lo, uint32_t hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(lo)))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(hi))))
          << 16);
}

__device__ __forceinline__ uint4 to_bf16(const uint4& a, const uint4& b) {
  return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
}

// bf16 -> f32 is exact: the bf16 bits are the f32's top half.
__device__ __forceinline__ uint4 widen(uint32_t p, uint32_t q) {
  return make_uint4(p << 16, p & 0xffff0000u, q << 16, q & 0xffff0000u);
}

template <typename In, typename Out>
__device__ __forceinline__ Group<Out> convert(const Group<In>& g) {
  if constexpr (sizeof(In) == sizeof(Out)) {
    return g;
  } else if constexpr (sizeof(In) == 4) {
    return Group<Out>{{to_bf16(g.q[0], g.q[1])}};
  } else {
    return Group<Out>{{widen(g.q[0].x, g.q[0].y), widen(g.q[0].z, g.q[0].w)}};
  }
}

template <typename In, typename Out, typename Id>
__global__ void __launch_bounds__(kThreads) lookup_fm_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRowsPerWarp;
  if (r0 >= a.rows) return;  // the whole warp
  long long src = -1;
  if (lane < kRowsPerWarp && r0 + lane < a.rows) {
    const long long r = r0 + lane;
    const long long f = r / a.batch, b = r - f * a.batch;
    const long long id =
        static_cast<long long>(static_cast<const Id*>(a.ids)[f * a.stride_f + b * a.stride_b]);
    if (f < a.fs) {
      src = (id >= a.bounds[f] && id < a.bounds[f + 1]) ? id : -1;
    } else {
      src = id < 0 ? 0 : (id < a.vocab ? id : a.vocab - 1);
    }
  }
  long long s[kRowsPerWarp];
  Out* dst[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    s[k] = __shfl_sync(0xffffffffu, src, k);
    const long long r = r0 + k;
    dst[k] = r >= a.rows ? nullptr
             : r < a.small_rows
                 ? static_cast<Out*>(a.out_small) + r * a.w
                 : static_cast<Out*>(a.out_big) + (r - a.small_rows) * a.w;
  }
  const In* table = static_cast<const In*>(a.table);
  const int w8 = a.w / 8;
  for (int g = lane; g < w8; g += 32) {
    Group<In> v[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const uint4* p =
          reinterpret_cast<const uint4*>(table + (s[k] < 0 ? 0 : s[k]) * a.w + g * 8);
#pragma unroll
      for (int j = 0; j < sizeof(In) / 2; ++j) {
        v[k].q[j] = s[k] >= 0 ? __ldg(p + j) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      if (dst[k] == nullptr) continue;
      const Group<Out> o = convert<In, Out>(v[k]);
      uint4* q = reinterpret_cast<uint4*>(dst[k] + g * 8);
#pragma unroll
      for (int j = 0; j < sizeof(Out) / 2; ++j) __stcs(q + j, o.q[j]);
    }
  }
}

template <typename In, typename Out, typename Id>
int launch(const Args& a, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((a.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  lookup_fm_kernel<In, Out, Id><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename In, typename Out>
int launch_ids(const Args& a, int ids64, cudaStream_t st) {
  return ids64 ? launch<In, Out, long long>(a, st) : launch<In, Out, int>(a, st);
}

template <typename In>
int launch_out(const Args& a, int out_bf16, int ids64, cudaStream_t st) {
  return out_bf16 ? launch_ids<In, __nv_bfloat16>(a, ids64, st)
                  : launch_ids<In, float>(a, ids64, st);
}

}  // namespace

extern "C" {

// Prefix fields the launch takes at most.
int cffm_embed_lookup_max_small(void) { return kMaxSmall; }

// One launch: table (vocab, w), f32 or (table_bf16) bf16; ids (batch, fields)
// int32 or (ids64) int64 at the given element strides; fs prefix fields whose
// blocks are [bounds[f], bounds[f + 1]) (bounds: fs + 1 host ints); out_small
// (fs, batch, w) and out_big (fields - fs, batch, w), f32 or (out_bf16) bf16.
// Returns a cudaError_t; 0 means the kernel was launched (or had no rows).
int cffm_embed_lookup_fm(const void* table, int table_bf16, long long vocab, int w,
                         const void* ids, int ids64, long long stride_b, long long stride_f,
                         long long batch, int fields, int fs, const int* bounds,
                         void* out_small, void* out_big, int out_bf16, void* stream) {
  if (w <= 0 || w % 8 != 0 || vocab <= 0 || batch < 0 || fields < 0 || fs < 0 ||
      fs > fields || fs > kMaxSmall || (fs > 0 && bounds == nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.table = table;
  a.vocab = vocab;
  a.w = w;
  a.ids = ids;
  a.stride_b = stride_b;
  a.stride_f = stride_f;
  a.batch = batch;
  a.rows = static_cast<long long>(fields) * batch;
  a.small_rows = static_cast<long long>(fs) * batch;
  a.fs = fs;
  a.out_small = out_small;
  a.out_big = out_big;
  for (int f = 0; f <= kMaxSmall; ++f) a.bounds[f] = f <= fs && fs > 0 ? bounds[f] : 0;
  if (a.rows == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_bf16 ? launch_out<__nv_bfloat16>(a, out_bf16, ids64, st)
                    : launch_out<float>(a, out_bf16, ids64, st);
}

}  // extern "C"
