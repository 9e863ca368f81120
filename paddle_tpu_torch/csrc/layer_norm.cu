// LayerNorm over the last dim (K4) for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels paddle_tpu/pallas/layer_norm.py
// _fwd_pallas (:92, pallas_call :97, body _fwd_kernel :44) and _bwd_pallas
// (:111, pallas_call :117, body _bwd_kernel :54).  For x [rows, d] in
// float32 or bf16 (AMP) and scale and bias [d] in float32:
//
//   m = mean(x), var = max(mean(x^2) - m^2, 0), rstd = rsqrt(var + eps)
//   y = (x - m) * rstd * scale + bias
//   backward, g = dy * scale, xhat = (x - m) * rstd:
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//   dscale = sum_rows dy * xhat,   dbias = sum_rows dy
//
// exactly the TPU kernel's formulas (one-pass statistics, the variance
// clamped at 0; the backward recomputes m and rstd from x instead of reading
// saved statistics).  x and dy are widened to float32 as they are loaded;
// y and dx are written in x's type, rounded once (:106, :131); the
// statistics, dscale and dbias stay float32.
//
// Design:
//  - a row is held in registers by a group of WPR warps (1, 2, 4 or 8, the
//    fewest that keep each thread at <= 4 slots of 4 elements), 8 warps a
//    block: x (and dy) are read once, y (and dx) written once, 4 elements
//    an access (16 bytes in float32, 8 in bf16) where d % 4 == 0.  The sums are taken in float32, across the
//    warp with shuffles and across a row group's warps through shared
//    memory, in a fixed order.
//  - backward: the TPU kernel carries dscale and dbias across its
//    sequential grid.  Here a fixed number of blocks (independent of the
//    card) each walk a fixed set of rows, keep each thread's column sums in
//    registers, add the row groups of the block in order, and write one
//    partial row into a [blocks, d] buffer; a second kernel adds the
//    partials per column in a fixed order: deterministic, no atomics (the
//    pattern of csrc/conv1x1_stats.cu).
//
// What bounds it on an H100: bytes.  A row of d = 768 floats needs ~5 flops
// per byte moved at most, far below the ~20 flops per byte where the CUDA
// cores' float32 rate would take over.  At [16384, 768] the forward moves
// 100.7 MB (x read, y written), the backward 151 MB plus 2 x 512 x 768
// floats of partials, so 3.35 TB/s bounds them at ~0.030 and ~0.045 ms;
// bf16 x, y, dy and dx halve those bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;           // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int BWD_BLOCKS = 512;        // blocks of the backward's first pass

struct Row4 {
  float v[4];
};

// the thread's slot j of a row: elements e .. e + 3 with
// e = (j * 32 * WPR + lane_in_row) * 4
template <int WPR>
__device__ __forceinline__ int slot_base(int j, int lane_in_row) {
  return (j * 32 * WPR + lane_in_row) * 4;
}

__device__ __forceinline__ Row4 load4(const float* __restrict__ p, int e,
                                      int d, bool vec) {
  Row4 r;
  if (vec) {
    if (e < d) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
    } else {
      r.v[0] = r.v[1] = r.v[2] = r.v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) r.v[c] = (e + c < d) ? p[e + c] : 0.f;
  }
  return r;
}

__device__ __forceinline__ Row4 load4(const __nv_bfloat16* __restrict__ p,
                                      int e, int d, bool vec) {
  Row4 r;
  if (vec) {
    if (e < d) {
      __align__(8) __nv_bfloat162 t[2];
      *reinterpret_cast<uint2*>(t) = *reinterpret_cast<const uint2*>(p + e);
      const float2 a = __bfloat1622float2(t[0]), b = __bfloat1622float2(t[1]);
      r.v[0] = a.x; r.v[1] = a.y; r.v[2] = b.x; r.v[3] = b.y;
    } else {
      r.v[0] = r.v[1] = r.v[2] = r.v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r.v[c] = (e + c < d) ? __bfloat162float(p[e + c]) : 0.f;
  }
  return r;
}

__device__ __forceinline__ void store4(float* __restrict__ p, int e, int d,
                                       bool vec, const Row4& r) {
  if (vec) {
    if (e < d)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < d) p[e + c] = r.v[c];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ p, int e,
                                       int d, bool vec, const Row4& r) {
  if (vec) {
    if (e < d) {
      __align__(8) __nv_bfloat162 t[2];
      t[0] = __floats2bfloat162_rn(r.v[0], r.v[1]);
      t[1] = __floats2bfloat162_rn(r.v[2], r.v[3]);
      *reinterpret_cast<uint2*>(p + e) = *reinterpret_cast<const uint2*>(t);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < d) p[e + c] = __float2bfloat16_rn(r.v[c]);
  }
}

// sum (a, b) over the WPR warps of a row group: shuffles within each warp,
// then the warps' sums in order through shared memory (buffer `buf` of 2,
// alternated by the caller so consecutive reductions need one barrier each)
template <int WPR>
__device__ __forceinline__ void row_sum2(float& a, float& b,
                                         float (*red)[WARPS][2], int buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[buf][warp][0] = a;
      red[buf][warp][1] = b;
    }
    __syncthreads();
    const int first = warp - warp % WPR;
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) {
      a += red[buf][first + w][0];
      b += red[buf][first + w][1];
    }
  }
}

// T: the element type of x and y (float or __nv_bfloat16)
template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int rows,
              int d, float eps, bool vec) {
  constexpr int G = WARPS / WPR;       // rows a block holds at once
  __shared__ float red[2][WARPS][2];
  const int warp = threadIdx.x >> 5;
  const int lane_in_row = (warp % WPR) * 32 + (threadIdx.x & 31);
  const long long row = (long long)blockIdx.x * G + warp / WPR;
  const bool ok = row < rows;
  const T* xr = x + (ok ? row : 0) * (long long)d;

  Row4 v[NV];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = slot_base<WPR>(j, lane_in_row);
    v[j] = ok ? load4(xr, e, d, vec) : Row4{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s += v[j].v[c];
      s2 = fmaf(v[j].v[c], v[j].v[c], s2);
    }
  }
  row_sum2<WPR>(s, s2, red, 0);
  const float inv_d = 1.f / (float)d;
  const float m = s * inv_d;
  const float var = fmaxf(s2 * inv_d - m * m, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (!ok) return;
  T* yr = y + row * (long long)d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = slot_base<WPR>(j, lane_in_row);
    if (e >= d) continue;
    const Row4 sc = load4(scale, e, d, vec);
    const Row4 bi = load4(bias, e, d, vec);
    Row4 o;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o.v[c] = (v[j].v[c] - m) * rstd * sc.v[c] + bi.v[c];
    store4(yr, e, d, vec, o);
  }
}

// T: the element type of x, dy and dx
template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_db,
              int rows, int d, float eps, bool vec) {
  constexpr int G = WARPS / WPR;
  constexpr int SLOTS = 32 * WPR * 4 * NV;     // a row's padded length
  __shared__ float red[2][WARPS][2];
  // the row groups' column sums, added in order at the end
  __shared__ float acc_s[G > 1 ? G : 1][G > 1 ? SLOTS : 1];
  __shared__ float acc_b[G > 1 ? G : 1][G > 1 ? SLOTS : 1];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / WPR;
  const int lane_in_row = (warp % WPR) * 32 + (threadIdx.x & 31);
  const float inv_d = 1.f / (float)d;

  Row4 sc[NV], ads[NV], adb[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    sc[j] = load4(scale, slot_base<WPR>(j, lane_in_row), d, vec);
#pragma unroll
    for (int c = 0; c < 4; ++c) ads[j].v[c] = adb[j].v[c] = 0.f;
  }

  // all threads of a block walk the same iterations (barriers inside)
  for (long long r0 = (long long)blockIdx.x * G; r0 < rows;
       r0 += (long long)gridDim.x * G) {
    const long long row = r0 + grp;
    const bool ok = row < rows;
    const T* xr = x + (ok ? row : 0) * (long long)d;
    const T* gr = dy + (ok ? row : 0) * (long long)d;
    Row4 xv[NV], gv[NV];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = slot_base<WPR>(j, lane_in_row);
      xv[j] = ok ? load4(xr, e, d, vec) : Row4{{0.f, 0.f, 0.f, 0.f}};
      gv[j] = ok ? load4(gr, e, d, vec) : Row4{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s += xv[j].v[c];
        s2 = fmaf(xv[j].v[c], xv[j].v[c], s2);
      }
    }
    row_sum2<WPR>(s, s2, red, 0);
    const float m = s * inv_d;
    const float rstd = rsqrtf(fmaxf(s2 * inv_d - m * m, 0.f) + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // xhat kept in xv; padded slots hold x = 0 and dy = 0
        xv[j].v[c] = (xv[j].v[c] - m) * rstd;
        const float g = gv[j].v[c] * sc[j].v[c];
        sg += g;
        sgx = fmaf(g, xv[j].v[c], sgx);
      }
    row_sum2<WPR>(sg, sgx, red, 1);
    const float c1 = sg * inv_d, c2 = sgx * inv_d;
    if (ok) {
      T* dxr = dx + row * (long long)d;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = slot_base<WPR>(j, lane_in_row);
        if (e >= d) continue;
        Row4 o;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float g = gv[j].v[c] * sc[j].v[c];
          o.v[c] = rstd * (g - c1 - xv[j].v[c] * c2);
          ads[j].v[c] = fmaf(gv[j].v[c], xv[j].v[c], ads[j].v[c]);
          adb[j].v[c] += gv[j].v[c];
        }
        store4(dxr, e, d, vec, o);
      }
    }
  }

  // one partial row per block: the row groups' column sums in order
  const size_t at = (size_t)blockIdx.x * d;
  if constexpr (G == 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = slot_base<WPR>(j, lane_in_row);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e + c < d) {
          part_ds[at + e + c] = ads[j].v[c];
          part_db[at + e + c] = adb[j].v[c];
        }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = slot_base<WPR>(j, lane_in_row);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_s[grp][e + c] = ads[j].v[c];
        acc_b[grp][e + c] = adb[j].v[c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < d; e += THREADS) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        a += acc_s[k][e];
        b += acc_b[k][e];
      }
      part_ds[at + e] = a;
      part_db[at + e] = b;
    }
  }
}

constexpr int SC = 32;          // columns per block of the second pass
constexpr int SG = 8;           // row groups per block of the second pass

// out[c] = sum_r part[r][c] for both partial buffers, in a fixed order:
// row group g sums rows g, g + SG, ...; the SG group sums are added in order
__global__ void __launch_bounds__(SC * SG)
colsum_kernel(const float* __restrict__ part_ds,
              const float* __restrict__ part_db, float* __restrict__ ds,
              float* __restrict__ db, int prow, int d) {
  __shared__ float sh[2][SG][SC];
  const int c = blockIdx.x * SC + threadIdx.x;
  const int g = threadIdx.y;
  float a = 0.f, b = 0.f;
  if (c < d) {
    for (int r = g; r < prow; r += SG) {
      a += part_ds[(size_t)r * d + c];
      b += part_db[(size_t)r * d + c];
    }
  }
  sh[0][g][threadIdx.x] = a;
  sh[1][g][threadIdx.x] = b;
  __syncthreads();
  if (g == 0 && c < d) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      ta += sh[0][k][threadIdx.x];
      tb += sh[1][k][threadIdx.x];
    }
    ds[c] = ta;
    db[c] = tb;
  }
}

// the fewest warps a row (1, 2, 4, 8) that hold d in <= 4 float4 slots a
// thread; 0 when d is too wide
int warps_per_row(int d) {
  const int v = (d + 3) / 4;
  for (int w = 1; w <= 8; w *= 2)
    if (v <= 32 * w * 4) return w;
  return 0;
}

// slots a thread holds for d at wpr warps a row: 1..4 when wpr == 1; with
// more warps the row needs more than 2 slots a thread (else fewer warps
// would have done), so 3 or 4
int slots(int d, int wpr) {
  const int v = (d + 3) / 4;
  return (v + 32 * wpr - 1) / (32 * wpr);
}

template <typename T, int WPR, int NV>
int launch_fwd(const T* x, const float* s, const float* b, T* y, int rows,
               int d, float eps, bool vec, cudaStream_t st) {
  constexpr int G = WARPS / WPR;
  ln_fwd_kernel<T, WPR, NV><<<(rows + G - 1) / G, THREADS, 0, st>>>(
      x, s, b, y, rows, d, eps, vec);
  return (int)cudaGetLastError();
}

template <typename T, int WPR, int NV>
int launch_bwd(const T* x, const float* s, const T* dy, T* dx, float* part,
               int prow, int rows, int d, float eps, bool vec,
               cudaStream_t st) {
  ln_bwd_kernel<T, WPR, NV><<<prow, THREADS, 0, st>>>(
      x, s, dy, dx, part, part + (size_t)prow * d, rows, d, eps, vec);
  return (int)cudaGetLastError();
}

#define LN_DISPATCH(FN, T, ...)                                     \
  switch (wpr * 8 + nv) {                                           \
    case 9: return FN<T, 1, 1>(__VA_ARGS__);                        \
    case 10: return FN<T, 1, 2>(__VA_ARGS__);                       \
    case 11: return FN<T, 1, 3>(__VA_ARGS__);                       \
    case 12: return FN<T, 1, 4>(__VA_ARGS__);                       \
    case 19: return FN<T, 2, 3>(__VA_ARGS__);                       \
    case 20: return FN<T, 2, 4>(__VA_ARGS__);                       \
    case 35: return FN<T, 4, 3>(__VA_ARGS__);                       \
    case 36: return FN<T, 4, 4>(__VA_ARGS__);                       \
    case 67: return FN<T, 8, 3>(__VA_ARGS__);                       \
    case 68: return FN<T, 8, 4>(__VA_ARGS__);                       \
    default: return (int)cudaErrorInvalidValue;                     \
  }

// 4-element accesses need d % 4 == 0, the float32 vectors (scale, bias) on
// a 16-byte boundary and the row tensors on one of 4 elements of type T
template <typename T>
bool vectorizable(int d, std::initializer_list<const void*> vectors,
                  std::initializer_list<const void*> rows) {
  if (d % 4 != 0) return false;
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) != 0) return false;
  return true;
}

template <typename T>
int fwd(const void* x, const void* scale, const void* bias, void* y,
        int rows, int d, float eps, cudaStream_t st) {
  const int wpr = warps_per_row(d);
  const int nv = slots(d, wpr);
  const bool vec = vectorizable<T>(d, {scale, bias}, {x, y});
  LN_DISPATCH(launch_fwd, T, static_cast<const T*>(x),
              static_cast<const float*>(scale),
              static_cast<const float*>(bias), static_cast<T*>(y), rows, d,
              eps, vec, st)
}

template <typename T>
int bwd(const void* x, const void* scale, const void* dy, void* dx,
        float* pf, int prow, int rows, int d, float eps, cudaStream_t st) {
  const int wpr = warps_per_row(d);
  const int nv = slots(d, wpr);
  const bool vec = vectorizable<T>(d, {scale}, {x, dy, dx});
  LN_DISPATCH(launch_bwd, T, static_cast<const T*>(x),
              static_cast<const float*>(scale), static_cast<const T*>(dy),
              static_cast<T*>(dx), pf, prow, rows, d, eps, vec, st)
}

}  // namespace

extern "C" {

// the partial rows the backward writes, one per block of its first pass
// (the wrapper allocates 2 * this * d floats of scratch); 0 for a d the
// kernels do not take
int paddle_tpu_torch_layer_norm_partial_rows(int rows, int d) {
  const int wpr = warps_per_row(d);
  if (rows <= 0 || d <= 0 || wpr == 0) return 0;
  const int g = WARPS / wpr;
  const int blocks = (rows + g - 1) / g;
  return blocks < BWD_BLOCKS ? blocks : BWD_BLOCKS;
}

// y [rows, d] = LayerNorm(x) * scale + bias, x and y float32 (dtype 0) or
// bf16 (dtype 1), scale and bias float32; returns a cudaError_t
int paddle_tpu_torch_layer_norm_fwd(const void* x, const void* scale,
                                    const void* bias, void* y, int rows,
                                    int d, float eps, int dtype,
                                    void* stream) {
  if (rows <= 0 || d <= 0 || warps_per_row(d) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, scale, bias, y, rows, d, eps, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}

// dx [rows, d] from x and dy [rows, d] (all three float32, dtype 0, or
// bf16, dtype 1) and scale [d] float32; part: scratch of 2 * prow * d
// floats with prow from paddle_tpu_torch_layer_norm_partial_rows; grads:
// dscale then dbias, 2 * d floats.  Returns a cudaError_t.
int paddle_tpu_torch_layer_norm_bwd(const void* x, const void* scale,
                                    const void* dy, void* dx, void* part,
                                    void* grads, int rows, int d, float eps,
                                    int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || warps_per_row(d) == 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int prow = paddle_tpu_torch_layer_norm_partial_rows(rows, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  float* gf = static_cast<float*>(grads);
  const int err =
      dtype == 0 ? bwd<float>(x, scale, dy, dx, pf, prow, rows, d, eps, st)
                 : bwd<__nv_bfloat16>(x, scale, dy, dx, pf, prow, rows, d,
                                      eps, st);
  if (err != 0) return err;
  colsum_kernel<<<(d + SC - 1) / SC, dim3(SC, SG), 0, st>>>(
      pf, pf + (size_t)prow * d, gf, gf + d, prow, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
