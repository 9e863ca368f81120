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
// Design: one warp per row; every lane computes the row's two weights from
// the two lse values, then the lanes walk the row's d elements.  The merge
// reads 2 partials and writes 1: bytes bound it (at [24, 2048, 64] float32,
// 37.7 MB, ~0.011 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -1e30f / 2;
constexpr int WARPS = 8;

// a value rounded to the element type and widened back (bf16: the
// rounding of T(x); float32: x)
__device__ __forceinline__ float as_t(float x, const float*) { return x; }
__device__ __forceinline__ float as_t(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void ring_merge_kernel(const T* __restrict__ o1,
                                  const float* __restrict__ lse1,
                                  const T* __restrict__ o2,
                                  const float* __restrict__ lse2,
                                  T* __restrict__ o, float* __restrict__ lse,
                                  long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float l1 = lse1[row], l2 = lse2[row];
  const float m = fmaxf(l1, l2);
  const float m_safe = m <= HALF_NEG_INF ? 0.f : m;
  const float w1 = l1 <= HALF_NEG_INF ? 0.f : expf(__fsub_rn(l1, m_safe));
  const float w2 = l2 <= HALF_NEG_INF ? 0.f : expf(__fsub_rn(l2, m_safe));
  const float den = __fadd_rn(w1, w2);
  const float den_safe = den == 0.f ? 1.f : den;
  const float c1 = as_t(__fdiv_rn(w1, den_safe), o1);
  const float c2 = as_t(__fdiv_rn(w2, den_safe), o2);
  const long long base = row * d;
  for (int j = lane; j < d; j += 32) {
    const float p1 = as_t(__fmul_rn(ptt::ld(o1 + base + j), c1), o1);
    const float p2 = as_t(__fmul_rn(ptt::ld(o2 + base + j), c2), o2);
    ptt::st(o + base + j, __fadd_rn(p1, p2));
  }
  if (lane == 0)
    lse[row] = den == 0.f ? NEG_INF : __fadd_rn(m_safe, logf(den_safe));
}

template <typename T>
int launch(const void* o1, const float* lse1, const void* o2,
           const float* lse2, void* o, float* lse, long long rows, int d,
           cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ring_merge_kernel<T><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(o1), lse1, static_cast<const T*>(o2), lse2,
      static_cast<T*>(o), lse, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  o1, o2, o: `rows` x d elements of
// one type, float32 (dtype 0) or bf16 (dtype 1); lse1, lse2, lse: `rows`
// float32; all contiguous, on the device (o may alias neither input).
// Launches one kernel on `stream` and returns the cudaError_t of the launch
// (0 when it was accepted).
extern "C" int paddle_tpu_torch_ring_merge(const void* o1, const void* lse1,
                                           const void* o2, const void* lse2,
                                           void* o, void* lse, long long rows,
                                           int d, int dtype, void* stream) {
  const float* l1 = static_cast<const float*>(lse1);
  const float* l2 = static_cast<const float*>(lse2);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(o1, l1, o2, l2, o, l, rows, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(o1, l1, o2, l2, o, l, rows, d, s);
  return (int)cudaErrorInvalidValue;
}
