// Element access shared by the kernels that take float32 or bf16 tensors:
// a load widens to float32, a store rounds float32 to the tensor's type
// (round to nearest even for bf16).  Arithmetic stays in float32.
#pragma once

#include <cuda_bf16.h>

namespace ptt {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a value as a bf16 operand of the tensor cores (round to nearest even)
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}

}  // namespace ptt
