// Dropout on a replayable Philox stream for Hopper (sm_90a): float32 or bf16.
//
// Replaces no Pallas kernel: the JAX package draws and applies its dropout
// mask in jnp (paddle_tpu/ops/nn_ops.py _dropout_keep :647, _dropout_lower
// :667, _dropout_grad :698; the fused tail of fused_ops.py :94-112).  It is
// the port's own kernel for the hot elementwise op of transformer training:
// 49 dropouts and 49 of their gradients a BERT-base step.
//
// For element i of x [n] (float32 or bf16), with the stream given by a
// 64-bit key (the run's seed) and two counter words (the op's tag or the
// run's counter, and the stream's kind):
//
//   r      = Philox4x32-10(counter = (i / 16 lo, i / 16 hi, word2, word3),
//                          key = (seed lo, seed hi))
//   byte   = byte i % 16 of r, little-endian (word (i % 16) / 4 of r)
//   keep   = byte >= threshold        (threshold in [0, 256]; 256 keeps none)
//   out[i] = keep ? x[i] * scale : 0  (scale is x's type's value: one
//                                      rounding of the product to x's type)
//   mask[i] = keep                    (written only where mask is given)
//
// Given mask_in, keep = mask_in[i] != 0 and no bits are drawn (the gradient
// of an untagged dropout, which replays its stored mask).  The same call on
// the output gradient is the gradient: the stream regenerates the forward's
// mask, so no mask is stored for a tagged dropout.  Philox is computed with
// exact 32-bit wrap-around (__umulhi and the low product), so the bits are
// those of the plain PyTorch version on any device, bit for bit.
//
// What bounds it on an H100: bytes.  Philox-10 costs ~10 x 2 32-bit
// multiplies a 16-element group (~2.6 integer operations an element), far
// below the bytes: x read and out written, 2 x 4 bytes an element in float32
// and 2 x 2 in bf16 (plus one byte of mask where it is written).  At BERT's
// [128, 12, 128, 128] in bf16 that is 101 MB, ~0.030 ms at 3.35 TB/s.
//
// Design: one thread a 16-element group (one Philox call, its 16 bytes one
// each); 16-byte loads and stores (4 of x in float32, 2 in bf16, one of the
// mask) where every pointer is 16-byte aligned, chosen before launch; the
// ragged last group and unaligned tensors take element accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

struct Args {
  long long n;
  uint32_t k0, k1, word2, word3;
  int threshold;
  float scale;
};

// the 16 keep flags of group g, as one bit each
__device__ __forceinline__ uint32_t keep_bits(const Args& a, long long g,
                                              const uint8_t* mask_in,
                                              bool vec) {
  uint32_t bits = 0;
  const long long base = g * 16;
  if (mask_in != nullptr) {
    if (vec) {
      const uint4 m = *reinterpret_cast<const uint4*>(mask_in + base);
      const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        bits |= (((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) != 0u) << j;
    } else {
      for (int j = 0; j < 16 && base + j < a.n; ++j)
        bits |= (mask_in[base + j] != 0) << j;
    }
    return bits;
  }
  const uint4 r = philox4x32_10((uint32_t)g, (uint32_t)((unsigned long long)g
                                                        >> 32),
                                a.word2, a.word3, a.k0, a.k1);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bits |= ((int)((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) >= a.threshold)
            << j;
  return bits;
}

__device__ __forceinline__ float apply(float v, bool keep, float scale) {
  return keep ? __fmul_rn(v, scale) : 0.0f;
}

// 16 elements of float32 (4 x 16 bytes) or bf16 (2 x 16 bytes)
template <typename T>
__device__ __forceinline__ void apply16(const T* x, T* out, uint32_t bits,
                                        float scale);

template <>
__device__ __forceinline__ void apply16<float>(const float* x, float* out,
                                               uint32_t bits, float scale) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 v = reinterpret_cast<const float4*>(x)[q];
    v.x = apply(v.x, (bits >> (4 * q)) & 1u, scale);
    v.y = apply(v.y, (bits >> (4 * q + 1)) & 1u, scale);
    v.z = apply(v.z, (bits >> (4 * q + 2)) & 1u, scale);
    v.w = apply(v.w, (bits >> (4 * q + 3)) & 1u, scale);
    reinterpret_cast<float4*>(out)[q] = v;
  }
}

template <>
__device__ __forceinline__ void apply16<__nv_bfloat16>(
    const __nv_bfloat16* x, __nv_bfloat16* out, uint32_t bits, float scale) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint4 v = reinterpret_cast<const uint4*>(x)[q];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(
          apply(__bfloat162float(e[j]), (bits >> (8 * q + j)) & 1u, scale));
    reinterpret_cast<uint4*>(out)[q] = v;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   uint8_t* __restrict__ mask_out,
                   const uint8_t* __restrict__ mask_in, Args a) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long base = g * 16;
  if (base >= a.n) return;
  const bool full = VEC && base + 16 <= a.n;
  const uint32_t bits = keep_bits(a, g, mask_in, full);
  if (full) {
    apply16<T>(x + base, out + base, bits, a.scale);
    if (mask_out != nullptr) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = ((bits >> (4 * q)) & 1u) | (((bits >> (4 * q + 1)) & 1u) << 8) |
               (((bits >> (4 * q + 2)) & 1u) << 16) |
               (((bits >> (4 * q + 3)) & 1u) << 24);
      *reinterpret_cast<uint4*>(mask_out + base) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (int j = 0; j < 16 && base + j < a.n; ++j) {
    const bool keep = (bits >> j) & 1u;
    ptt::st(out + base + j, apply(ptt::ld(x + base + j), keep, a.scale));
    if (mask_out != nullptr) mask_out[base + j] = keep ? 1 : 0;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, void* out, void* mask_out, const void* mask_in,
           const Args& a, cudaStream_t s) {
  const long long groups = (a.n + 15) / 16;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  uint8_t* mo = static_cast<uint8_t*>(mask_out);
  const uint8_t* mi = static_cast<const uint8_t*>(mask_in);
  if (aligned16(x) && aligned16(out) && aligned16(mask_out) &&
      aligned16(mask_in))
    dropout_kernel<T, true><<<(unsigned)blocks, THREADS, 0, s>>>(xp, op, mo,
                                                                 mi, a);
  else
    dropout_kernel<T, false><<<(unsigned)blocks, THREADS, 0, s>>>(xp, op, mo,
                                                                  mi, a);
  return (int)cudaGetLastError();
}

}  // namespace

// out (and mask_out, when not null) for x [n] of dtype 0 (float32) or 1
// (bf16); keep from the stream (seed, word2, word3) and threshold, or from
// mask_in when it is not null.  Returns the CUDA error of the launch.
extern "C" int paddle_tpu_torch_dropout(const void* x, void* out,
                                        void* mask_out, const void* mask_in,
                                        long long n, unsigned long long seed,
                                        unsigned int word2,
                                        unsigned int word3, int threshold,
                                        float scale, int dtype, void* stream) {
  if (n <= 0 || threshold < 0 || threshold > 256)
    return (int)cudaErrorInvalidValue;
  Args a{n, (uint32_t)seed, (uint32_t)(seed >> 32), word2, word3, threshold,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, mask_out, mask_in, a, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, mask_out, mask_in, a, s);
  return (int)cudaErrorInvalidValue;
}
