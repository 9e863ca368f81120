// The log-sum-exp merge of two attention partials (ring attention, K7) for
// Hopper (sm_90a): float32 or bf16 partials.
//
// Ring attention (paddle_tpu/pallas/ring_attention.py, _ring_fwd_impl :70)
// runs flash attention (K1) once per ring step on the query shard against
// the KV shard the ring holds at that step, and folds each step's partial
// (o, lse) into the running one with _merge (:43-54):
//
//   m      = max(lse1, lse2),        m_safe = m <= NEG_INF/2 ? 0 : m
//   w1     = lse1 <= NEG_INF/2 ? 0 : exp(lse1 - m_safe)      (w2 alike)
//   den    = w1 + w2,                den_safe = den == 0 ? 1 : den
//   o      = o1 * T(w1 / den_safe) + o2 * T(w2 / den_safe)
//   lse    = den == 0 ? NEG_INF : m_safe + log(den_safe)
//
// with o1, o2, o [bh, tq, d] of type T (float32 or bf16) and lse1, lse2,
// lse [bh, tq] float32; NEG_INF = -1e30.  As in the reference, each weight
// is cast to T before it multiplies, and in bf16 each product and the sum
// are rounded to bf16 (one rounding per operation, as PyTorch's and XLA's
// separate operations round).  Every float32 operation is rounded on its
// own (__f*_rn: no FMA contraction), so the kernel gives its plain version's
// values bit for bit.
//
// What bounds it on an H100: bytes.  The merge reads 2 partials and writes
// 1, with ~3 operations an element: at [24, 2048, 64] bf16 19 MB, ~0.0058
// ms at 3.35 TB/s (float32 38 MB, ~0.0114 ms).
//
// Design:
//  - a unit is 16 bytes of a row (8 bf16 or 4 float32 elements) moved in
//    one access; a row of C units is held by a group of L lanes (the power
//    of two >= C, at most 32), so at d = 64 bf16 a warp holds 4 rows and
//    each instruction moves 512 contiguous bytes;
//  - a warp walks U rows of each group per step of a grid-stride loop, and
//    issues all their loads before any arithmetic: U 16-byte loads of each
//    partial in flight a lane.  U = 1 measured fastest on an H100 80GB
//    HBM3 (700 W) at [24, 2048, 64] with inputs out of L2: 2, 4 and 8
//    give fewer blocks and resident warps for the same bytes, and at 2 an
//    in-place merge ran slower than one into other buffers;
//  - a row's weights and new lse are computed once, by one lane of its
//    group (lane u of the group for the group's u-th row), and handed to
//    the group by shuffles;
//  - the grid is a few waves of resident blocks, not one block per 8 rows;
//  - where d * sizeof(T) is not a multiple of 16 or a row tensor is off 16
//    bytes, the same kernel runs with a unit of one element (the scalar
//    form), chosen before launch.
//
// o may be o1 (and lse lse1), merging in place: every element, and every
// lse, is read by the thread that writes it, before it writes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -1e30f / 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 1;                   // rows of a lane group a step
constexpr int MAX_BLOCKS = 132 * 8;    // 8 resident blocks an SM at most
constexpr unsigned FULL = 0xffffffffu;

// a value rounded to the element type and widened back (bf16: the
// rounding of T(x); float32: x)
__device__ __forceinline__ float as_t(float x, const float*) { return x; }
__device__ __forceinline__ float as_t(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC elements of T moved in one access, kept in T until the arithmetic
template <typename T, int VEC>
struct Unit;

template <typename T>
struct Unit<T, 1> {
  T r;
  __device__ __forceinline__ void load(const T* p) { r = *p; }
  __device__ __forceinline__ float get(int) const { return ptt::ld(&r); }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    ptt::st(p, v[0]);
  }
};

template <>
struct Unit<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float get(int i) const { return (&r.x)[i]; }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Unit<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  // element i: the low half of word i / 2 for even i, the high for odd
  // (a bf16 widens to float32 exactly by a shift)
  __device__ __forceinline__ float get(int i) const {
    const uint32_t w = (&r.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// the row's weights (c1, c2, cast to T and widened back) and its new lse
template <typename T>
__device__ __forceinline__ void row_weights(float l1, float l2, float& c1,
                                            float& c2, float& l) {
  const float m = fmaxf(l1, l2);
  const float m_safe = m <= HALF_NEG_INF ? 0.f : m;
  const float w1 = l1 <= HALF_NEG_INF ? 0.f : expf(__fsub_rn(l1, m_safe));
  const float w2 = l2 <= HALF_NEG_INF ? 0.f : expf(__fsub_rn(l2, m_safe));
  const float den = __fadd_rn(w1, w2);
  const float den_safe = den == 0.f ? 1.f : den;
  c1 = as_t(__fdiv_rn(w1, den_safe), static_cast<const T*>(nullptr));
  c2 = as_t(__fdiv_rn(w2, den_safe), static_cast<const T*>(nullptr));
  l = den == 0.f ? NEG_INF : __fadd_rn(m_safe, logf(den_safe));
}

// o1/o and lse1/lse may alias, so no __restrict__ on them
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
ring_merge_kernel(const T* o1, const float* lse1, const T* __restrict__ o2,
                  const float* __restrict__ lse2, T* o, float* lse,
                  long long rows, int d, int lg) {
  using V = Unit<T, VEC>;
  const int units = d / VEC;             // units a row
  const int lane = threadIdx.x & 31;
  const int width = 1 << lg;             // lanes a row
  const int sub = lane >> lg;            // the lane's row group in its warp
  const int j = lane & (width - 1);      // its lane within the group
  const int first = lane & ~(width - 1); // the group's first lane
  const long long step = (long long)(32 >> lg) * U;  // rows a warp a step
  const long long warp =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * THREADS) >> 5;
  for (long long r0 = warp * step; r0 < rows; r0 += warps * step) {
    float c1[U], c2[U];
    for (int c0 = 0; c0 < units; c0 += width) {
      const int unit = c0 + j;
      V a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r0 + (long long)u * (32 >> lg) + sub;
        if (row < rows && unit < units) {
          a[u].load(o1 + row * d + (long long)unit * VEC);
          b[u].load(o2 + row * d + (long long)unit * VEC);
        }
      }
      if (c0 == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long row = r0 + (long long)u * (32 >> lg) + sub;
          const int owner = u & (width - 1);
          float w1 = 0.f, w2 = 0.f;
          if (j == owner && row < rows) {
            float l;
            row_weights<T>(lse1[row], lse2[row], w1, w2, l);
            lse[row] = l;
          }
          c1[u] = __shfl_sync(FULL, w1, first + owner);
          c2[u] = __shfl_sync(FULL, w2, first + owner);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r0 + (long long)u * (32 >> lg) + sub;
        if (row < rows && unit < units) {
          float v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float p1 = as_t(__fmul_rn(a[u].get(i), c1[u]), o1);
            const float p2 = as_t(__fmul_rn(b[u].get(i), c2[u]), o2);
            v[i] = __fadd_rn(p1, p2);
          }
          V::store(o + row * d + (long long)unit * VEC, v);
        }
      }
    }
  }
}

// log2 of the lanes that hold a row of `units` units
int lanes_log2(int units) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < units) ++lg;
  return lg;
}

template <typename T, int VEC>
int launch(const void* o1, const float* lse1, const void* o2,
           const float* lse2, void* o, float* lse, long long rows, int d,
           cudaStream_t stream) {
  const int lg = lanes_log2(d / VEC);
  const long long per_block = (long long)WARPS * (32 >> lg) * U;
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  ring_merge_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o1), lse1, static_cast<const T*>(o2), lse2,
      static_cast<T*>(o), lse, rows, d, lg);
  return (int)cudaGetLastError();
}

// the 16-byte form where every row is whole 16-byte units on a 16-byte
// boundary, else the scalar form
template <typename T>
int merge(const void* o1, const float* lse1, const void* o2,
          const float* lse2, void* o, float* lse, long long rows, int d,
          cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(o1) |
                    reinterpret_cast<uintptr_t>(o2) |
                    reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  return vec ? launch<T, VEC>(o1, lse1, o2, lse2, o, lse, rows, d, stream)
             : launch<T, 1>(o1, lse1, o2, lse2, o, lse, rows, d, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  o1, o2, o: `rows` x d elements of
// one type, float32 (dtype 0) or bf16 (dtype 1); lse1, lse2, lse: `rows`
// float32; all contiguous, on the device.  o may be o1 and lse lse1 (an
// in-place merge); otherwise the outputs overlap no input.  Launches one
// kernel on `stream` and returns the cudaError_t of the launch (0 when it
// was accepted).
extern "C" int paddle_tpu_torch_ring_merge(const void* o1, const void* lse1,
                                           const void* o2, const void* lse2,
                                           void* o, void* lse, long long rows,
                                           int d, int dtype, void* stream) {
  const float* l1 = static_cast<const float*>(lse1);
  const float* l2 = static_cast<const float*>(lse2);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return merge<float>(o1, l1, o2, l2, o, l, rows, d, s);
  if (dtype == 1)
    return merge<__nv_bfloat16>(o1, l1, o2, l2, o, l, rows, d, s);
  return (int)cudaErrorInvalidValue;
}
