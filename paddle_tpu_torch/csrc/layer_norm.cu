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
// What bounds it on an H100: bytes.  A row of d = 768 floats needs ~5 flops
// per byte moved at most, far below the ~20 flops per byte where the CUDA
// cores' float32 rate would take over.  At [16384, 768] the forward moves
// 100.7 MB (x read, y written), the backward 151 MB (x, dy read, dx
// written), so 3.35 TB/s bounds them at ~0.030 and ~0.045 ms; bf16 x, y,
// dy and dx halve those bytes.
//
// Forward, and the backward of rows wider than one warp holds: a row is
// held in registers by a group of WPR warps (1, 2, 4 or 8, the fewest that
// keep each thread at <= 4 slots of 4 elements), 8 warps a block, 4
// elements an access (16 bytes in float32, 8 in bf16) where d % 4 == 0.
// The sums are taken in float32, across the warp with shuffles and across a
// row group's warps through shared memory, in a fixed order.  The TPU
// kernel carries dscale and dbias across its sequential grid; this
// backward has a fixed number of blocks (independent of the card) each walk
// a fixed set of rows, keep each thread's column sums in registers, add the
// row groups of the block in order, and write one partial row into a
// [blocks, d] buffer; a second kernel adds the partials per column in a
// fixed order: deterministic, no atomics.
//
// The backward of rows up to ROW_MAX_D (768 float32, 1024 bf16: the widest
// ptxas holds in registers without spills) streams rows with no block
// barrier (ln_bwd_row_kernel):
//  - one warp a row, 16 bytes an access (a unit: 4 float32 or 8 bf16
//    elements; lane l holds units l, l + 32, ...), the row sums (s, s^2,
//    sum g, sum g * xhat) by warp shuffles alone;
//  - each warp issues the next row's x and dy loads into registers before
//    the current row's arithmetic and dx store, so consecutive rows'
//    loads and arithmetic overlap;
//  - dscale and dbias: each lane sums its columns in registers over the
//    rows its warp walks; a block adds its warps' sums in order in shared
//    memory; the CLUSTER blocks of a thread block cluster add their block
//    sums in rank order through distributed shared memory (mapa and
//    ld.shared::cluster between cluster barriers), one partial row per
//    cluster; a second kernel adds those few rows per column in order,
//    16 bytes an access.  The grid is a fixed number of clusters (by rows
//    and the row type, never the card's SM count), so every sum is taken
//    in the same order in every run and on every card.
// Rows whose d is not a multiple of a unit, or a tensor off 16 bytes, take
// the same kernel with element accesses (chosen before launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;           // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int BWD_BLOCKS = 512;        // blocks of the wide backward
constexpr int CLUSTER = 8;             // blocks of a cluster (row backward)

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

// --- the backward, one warp a row ------------------------------------------

// the row backward's form for row type T: the widest row, in units of 32
// lanes x 16 bytes (ptxas -v, sm_90a: no spill stores at MAX_NC; float32
// NC 6 holds 203 registers, bf16 NC 4 232), and the most clusters of its
// grid.  At d 768 a thread holds 185-203 registers, so an SM holds one
// block, and the card as many clusters of 8 as its layout of SMs allows
// (paddle_tpu_torch_layer_norm_active_clusters; fewer than 132 / 8): a
// grid of more runs in two waves.  12 leave room on any H100's layout.
template <typename T>
struct RowForm;
template <>
struct RowForm<float> {
  static constexpr int MAX_NC = 6, CLUSTERS = 12;        // d <= 768
};
template <>
struct RowForm<__nv_bfloat16> {
  static constexpr int MAX_NC = 4, CLUSTERS = 12;        // d <= 1024
};

template <typename T>
constexpr int row_max_d() {
  return RowForm<T>::MAX_NC * 32 * (16 / (int)sizeof(T));
}

// element i of a unit (16 bytes of T held as they were loaded)
__device__ __forceinline__ float unit_get(const uint4& r, int i,
                                          const float*) {
  return __uint_as_float((&r.x)[i]);
}
__device__ __forceinline__ float unit_get(const uint4& r, int i,
                                          const __nv_bfloat16*) {
  const uint32_t w = (&r.x)[i >> 1];     // a bf16 widens by a shift
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the unit of p at element e: one 16-byte load, or (vec false) element
// loads of those below d; elements past d read 0
template <typename T>
__device__ __forceinline__ uint4 unit_load(const T* p, int e, int d,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    return e < d ? *reinterpret_cast<const uint4*>(p + e)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (e + i >= d) break;
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(reinterpret_cast<const float*>(p)[e + i]);
    } else {
      w[i >> 1] |= (uint32_t)__bfloat16_as_ushort(
                       reinterpret_cast<const __nv_bfloat16*>(p)[e + i])
                   << (16 * (i & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void unit_store(T* p, int e, int d, bool vec,
                                           const float* v) {
  constexpr int VEC = 16 / sizeof(T);
  if (e >= d) return;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p + e) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (e + i < d) reinterpret_cast<float*>(p)[e + i] = v[i];
  } else {
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
               ((uint32_t)__bfloat16_as_ushort(
                    __float2bfloat16_rn(v[2 * i + 1])) << 16);
      *reinterpret_cast<uint4*>(p + e) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (e + i < d)
        reinterpret_cast<__nv_bfloat16*>(p)[e + i] =
            __float2bfloat16_rn(v[i]);
  }
}

// sum (a, b) over the warp; every lane gets the sums, in one fixed order
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// distributed shared memory: the address of `p` (this block's shared
// memory) in the block of cluster rank `rank`, a 16-byte load there, and a
// barrier of every thread of the cluster (writes before it are seen after)
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 cluster_ld4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// T: the element type of x, dy and dx; NC: the units a lane holds of a
// row (d <= NC * 32 * 16 / sizeof(T)).  part: [2][gridDim.x / CLUSTER][d]
// floats, one dscale and one dbias row a cluster.
template <typename T, int NC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
ln_bwd_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int rows, int d, float eps,
                  bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DP = NC * 32 * VEC;      // a row's padded length
  constexpr int SLICE = DP / CLUSTER;    // columns each block of a cluster adds
  __shared__ __align__(16) float red[WARPS][DP];
  __shared__ __align__(16) float blk[2][DP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.f / (float)d;

  float sc[NC][VEC], ads[NC][VEC], adb[NC][VEC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int e = (k * 32 + lane) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[k][i] = e + i < d ? scale[e + i] : 0.f;
      ads[k][i] = adb[k][i] = 0.f;
    }
  }

  // rows gw, gw + nw, ...: the next row's x and dy are loaded (xn, gn)
  // before the current row's arithmetic (two rows ahead measured no
  // faster on an H100 at d 768)
  const long long nw = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + warp;
  uint4 xn[NC], gn[NC];
  if (row < rows) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int e = (k * 32 + lane) * VEC;
      xn[k] = unit_load(x + row * d, e, d, vec);
      gn[k] = unit_load(dy + row * d, e, d, vec);
    }
  }
  for (; row < rows; row += nw) {
    uint4 xc[NC], gc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
    if (row + nw < rows) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int e = (k * 32 + lane) * VEC;
        xn[k] = unit_load(x + (row + nw) * d, e, d, vec);
        gn[k] = unit_load(dy + (row + nw) * d, e, d, vec);
      }
    }
    // padded elements hold x = 0 and dy = 0: they add nothing below
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = unit_get(xc[k], i, x);
        s += xv;
        s2 = fmaf(xv, xv, s2);
      }
    warp_sum2(s, s2);
    const float m = s * inv_d;
    const float rstd = rsqrtf(fmaxf(s2 * inv_d - m * m, 0.f) + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (unit_get(xc[k], i, x) - m) * rstd;
        const float gv = unit_get(gc[k], i, dy);
        const float g = gv * sc[k][i];
        sg += g;
        sgx = fmaf(g, xh, sgx);
        ads[k][i] = fmaf(gv, xh, ads[k][i]);
        adb[k][i] += gv;
      }
    warp_sum2(sg, sgx);
    const float c1 = sg * inv_d, c2 = sgx * inv_d;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (unit_get(xc[k], i, x) - m) * rstd;
        const float g = unit_get(gc[k], i, dy) * sc[k][i];
        o[i] = rstd * (g - c1 - xh * c2);
      }
      unit_store(dx + row * d, (k * 32 + lane) * VEC, d, vec, o);
    }
  }

  // the block's column sums: its warps' in order, dscale then dbias
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int e = (k * 32 + lane) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(&red[warp][e + i]) =
            q == 0 ? make_float4(ads[k][i], ads[k][i + 1], ads[k][i + 2],
                                 ads[k][i + 3])
                   : make_float4(adb[k][i], adb[k][i + 1], adb[k][i + 2],
                                 adb[k][i + 3]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < DP; c += THREADS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[w][c];
      blk[q][c] = t;
    }
    __syncthreads();
  }

  // the cluster's: block `rank` adds columns [rank * SLICE, + SLICE) of
  // both sums over the cluster's blocks in rank order, 4 at a time
  cluster_sync();
  const uint32_t rank = cluster_rank();
  const long long cl = blockIdx.x / CLUSTER, ncl = gridDim.x / CLUSTER;
  for (int t = threadIdx.x; t < 2 * SLICE / 4; t += THREADS) {
    const int q = t / (SLICE / 4);
    const int c = (int)rank * SLICE + (t % (SLICE / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float4 v = cluster_ld4(cluster_addr(&blk[q][c], (uint32_t)r));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    float* out = part + ((long long)q * ncl + cl) * d + c;
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < d) out[i] = av[i];
  }
  cluster_sync();                        // no block leaves while read
}

// grads [2][d] = the sums over prow partial rows of part [2][prow][d], row
// by row in order; a thread adds 4 columns (16-byte loads where vec), one
// warp a block
__global__ void __launch_bounds__(32)
colsum_rows_kernel(const float* __restrict__ part, float* __restrict__ grads,
                   int prow, int d, bool vec) {
  const int n4 = (d + 3) / 4;
  const int t = blockIdx.x * 32 + threadIdx.x;
  if (t >= 2 * n4) return;
  const int q = t / n4, c = (t % n4) * 4;
  const float* p = part + (long long)q * prow * d + c;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = 0; r < prow; ++r) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(p + (long long)r * d);
      a[0] += v.x;
      a[1] += v.y;
      a[2] += v.z;
      a[3] += v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < d) a[i] += p[(long long)r * d + i];
    }
  }
  float* out = grads + (long long)q * d + c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < d) out[i] = a[i];
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

// the row backward at the NC (units a lane) that holds d, on prow
// clusters, then the partial rows' sums
template <typename T, int NC>
int bwd_rows(const void* x, const void* scale, const void* dy, void* dx,
             float* pf, float* grads, int prow, int rows, int d, float eps,
             cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (NC > RowForm<T>::MAX_NC) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (d > NC * 32 * VEC)
      return bwd_rows<T, NC + 1>(x, scale, dy, dx, pf, grads, prow, rows, d,
                                 eps, st);
    // 16-byte accesses: whole units, every tensor on a 16-byte boundary
    bool vec = d % VEC == 0;
    for (const void* p : {x, scale, dy, static_cast<const void*>(dx)})
      vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    ln_bwd_row_kernel<T, NC><<<prow * CLUSTER, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const T*>(dy), static_cast<T*>(dx), pf, rows, d, eps,
        vec);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int n4 = (d + 3) / 4;
    colsum_rows_kernel<<<(2 * n4 + 31) / 32, 32, 0, st>>>(
        pf, grads, prow, d,
        d % 4 == 0 && reinterpret_cast<uintptr_t>(pf) % 16 == 0);
    return (int)cudaGetLastError();
  }
}

// the widest d the row backward takes for row type `dtype`
int widest_row(int dtype) {
  return dtype == 0 ? row_max_d<float>() : row_max_d<__nv_bfloat16>();
}

}  // namespace

extern "C" {

// the partial rows the backward writes (the wrapper allocates 2 * this * d
// floats of scratch): rows up to the row form's widest d (768 float32,
// 1024 bf16) take one a cluster, up to RowForm::CLUSTERS clusters of 8
// blocks of 8 warps, at least a row a warp; wider rows one a block of the
// multi-warp kernel, up to 512.  0 for a d or dtype the kernels do not take
int paddle_tpu_torch_layer_norm_partial_rows(int rows, int d, int dtype) {
  const int wpr = warps_per_row(d);
  if (rows <= 0 || d <= 0 || wpr == 0 || (dtype != 0 && dtype != 1))
    return 0;
  if (d <= widest_row(dtype)) {
    const int most = dtype == 0 ? RowForm<float>::CLUSTERS
                                : RowForm<__nv_bfloat16>::CLUSTERS;
    const int per = CLUSTER * WARPS;
    const int n = (rows + per - 1) / per;
    return n < most ? n : most;
  }
  const int g = WARPS / wpr;
  const int blocks = (rows + g - 1) / g;
  return blocks < BWD_BLOCKS ? blocks : BWD_BLOCKS;
}

// the clusters of the row backward the card holds at once for row type
// `dtype` (float32 0, bf16 1) at its widest row
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t: its grid of
// RowForm::CLUSTERS clusters runs in one wave where this is no smaller
int paddle_tpu_torch_layer_norm_active_clusters(int dtype) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * RowForm<float>::CLUSTERS);
  cfg.blockDim = dim3(THREADS);
  int n = 0;
  const cudaError_t e =
      dtype == 0
          ? cudaOccupancyMaxActiveClusters(
                &n,
                (const void*)ln_bwd_row_kernel<float, RowForm<float>::MAX_NC>,
                &cfg)
          : cudaOccupancyMaxActiveClusters(
                &n,
                (const void*)ln_bwd_row_kernel<
                    __nv_bfloat16, RowForm<__nv_bfloat16>::MAX_NC>,
                &cfg);
  return e != cudaSuccess ? -(int)e : n;
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
// floats, prow = paddle_tpu_torch_layer_norm_partial_rows (any other prow
// is refused); grads: dscale then dbias, 2 * d floats.  Launches two
// kernels and returns a cudaError_t.
int paddle_tpu_torch_layer_norm_bwd(const void* x, const void* scale,
                                    const void* dy, void* dx, void* part,
                                    int prow, void* grads, int rows, int d,
                                    float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || warps_per_row(d) == 0 ||
      (dtype != 0 && dtype != 1) ||
      prow != paddle_tpu_torch_layer_norm_partial_rows(rows, d, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  float* gf = static_cast<float*>(grads);
  if (d <= widest_row(dtype))
    return dtype == 0 ? bwd_rows<float, 1>(x, scale, dy, dx, pf, gf, prow,
                                           rows, d, eps, st)
                      : bwd_rows<__nv_bfloat16, 1>(x, scale, dy, dx, pf, gf,
                                                   prow, rows, d, eps, st);
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
