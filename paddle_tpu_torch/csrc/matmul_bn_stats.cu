// Matmul with the producer's batch-norm folded into its read and batch-norm
// statistics of its output (K6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/conv_bn.py
// matmul_bn_stats (:58, pallas_call :100, body _kernel :31).  For x [M, K]
// and w [K, N], each float32 or bfloat16, and optional producer statistics
// mu, inv, g, b [K] (float32):
//
//   a[m, k] = x[m, k]                                   (as float32)
//   a[m, k] = ((a - mu[k]) * inv[k]) * g[k] + b[k]      (with the statistics)
//   a[m, k] = max(a[m, k], 0)                           (relu; independent)
//   y[m, n] = sum_k bf16(a[m, k]) * bf16(w[k, n])       (float32 sums)
//   s[n]  = sum_m y[m, n],   s2[n] = sum_m y[m, n]^2    (of the float32 sums)
//
// y is written in x's type (rounded to nearest even for bf16); s and s2 come
// from the float32 accumulators, not from the rounded y.  The normalize is
// four separately rounded operations (__fsub_rn, __fmul_rn, __fadd_rn), so
// nvcc cannot contract it into FMAs: the float32 value before the bf16
// rounding is the one the plain PyTorch ops give, bit for bit.
//
// Design (simple and right first, K3's staging pattern):
//  - one block of 8 warps per (128-row, 64-column) output tile, on a 1-D
//    grid (row tile = block / column tiles, column tiles fastest, so blocks
//    sharing an x tile run side by side and share it through L2).  Each
//    warp owns a 32 x 32 tile: 2 x 4 mma.sync m16n8k16 tiles (bf16 in,
//    float32 accumulators in registers).
//  - each 32-deep K step loads x's and w's tiles into registers (16-byte
//    loads where the rows allow, a step ahead, in flight during the
//    products), then applies the prologue while it stores them into shared
//    memory as bf16: the normalize and the relu on x, then the bf16
//    rounding.  Rows past M and columns past K are zero AFTER the prologue
//    (a padded 0 would normalize to (0 - mu) * inv * g + b), so they add
//    exact zeros to the products and to the statistics.  x's tile is stored
//    [128][40] (k contiguous, as ldmatrix wants A), w's [32][72] as it lies
//    (n contiguous; B fragments by ldmatrix.trans); the padded rows keep
//    ldmatrix free of bank conflicts.
//  - the epilogue writes y from the fragments (two consecutive values a
//    thread and row) and sums each column's y and y^2 over the tile's valid
//    rows: over a thread's 4 rows, across the 8 lanes holding the column,
//    then the 4 warps along M in order, into a partials row per row tile.
//    The TPU carries s and s2 across its sequential grid; blocks here run in
//    no order, so a second kernel adds the partials per column in a fixed
//    order: deterministic, no atomics.
//
// What bounds it on an H100: at the ResNet-50 stage shapes of
// paddle_tpu_torch/tools/rn50_fused_bench.py every call moves far more bytes
// than its bf16 products need time (stage0's first call: x 411 MB + y 103 MB
// in bf16, 0.15 ms at 3.35 TB/s, against 26 GFLOP, 0.027 ms at 989 TFLOP/s),
// so memory bounds it.  This version's loads go through registers into one
// shared-memory stage with two barriers a step; a TMA-fed ring of stages is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // depth per step
constexpr int AP = BK + 8;      // padded row of the x tile (k contiguous)
constexpr int BP = BN + 8;      // padded row of the w tile (n contiguous)
constexpr int THREADS = 256;    // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;          // rows per warp
constexpr int WN = 32;          // columns per warp
static_assert(BM * BK / 8 == 2 * THREADS, "two 8-value x chunks a thread");
static_assert(BK * BN / 8 == THREADS, "one 8-value w chunk a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values from 16-byte aligned memory
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// row[c .. c + 7] with zeros past `cols`; `vec`: the row's 16-byte loads
// are aligned wherever c is a multiple of 8
template <typename T>
__device__ __forceinline__ void fetch8(const T* row, int c, int cols,
                                       bool vec, float (&v)[8]) {
  if (vec && c + 8 <= cols) {
    load8(row + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c + e < cols ? to_f32(row[c + e]) : 0.f;
  }
}

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&v)[8]) {
  __align__(16) __nv_bfloat162 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ void store_out(float* dst, float v0, float v1,
                                          bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (two) dst[1] = v1;
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float v0,
                                          float v1, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (two) dst[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lane l gives the address of row (l % 8) of
// matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: from rows of k (n contiguous) it gives
// the "col" B fragments of mma.sync
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// stats: mu, inv, g, b as 4 rows of k floats, or null for no normalize
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
mm_bn_stats_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ stats, TX* __restrict__ y,
                   float* __restrict__ part_s, float* __restrict__ part_s2,
                   int m, int k, int n, int ntn, int relu, int vec_x,
                   int vec_w) {
  __shared__ __align__(16) __nv_bfloat16 as[BM][AP];
  __shared__ __align__(16) __nv_bfloat16 bs[BK][BP];
  __shared__ float red[4][2][BN];       // [warp_m][s|s2][column]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int g = lane >> 2;              // fragment row group
  const int t = lane & 3;               // thread in group
  const int mt = blockIdx.x / ntn;
  const int n0 = (blockIdx.x % ntn) * BN;
  const long long m0 = (long long)mt * BM;
  const float* mu = stats;
  const float* inv = stats ? stats + k : nullptr;
  const float* gam = stats ? stats + 2 * k : nullptr;
  const float* bet = stats ? stats + 3 * k : nullptr;

  // this thread's x chunks: rows xrow[r], depth xc .. xc + 7 of each step;
  // its w chunk: depth wrow, columns n0 + wc .. + 7
  const int xc = (tid & 3) * 8;
  int xrow[2];
  bool xok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xrow[r] = (tid >> 2) + r * (BM / 2);
    xok[r] = m0 + xrow[r] < m;
  }
  const int wrow = tid >> 3;
  const int wc = (tid & 7) * 8;

  float xv[2][8], wv[8];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (xok[r]) {
        fetch8(x + (size_t)(m0 + xrow[r]) * k, k0 + xc, k, vec_x, xv[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[r][e] = 0.f;
      }
    }
    if (k0 + wrow < k) {
      fetch8(w + (size_t)(k0 + wrow) * n + n0, wc, n - n0, vec_w, wv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[e] = 0.f;
    }
  };

  // the prologue on the fetched x values, then both tiles into shared
  // memory as bf16
  auto stage = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = k0 + xc + e;
        const bool ok = xok[r] && kk < k;
        float v = xv[r][e];
        if (stats != nullptr && ok)
          v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, __ldg(mu + kk)),
                                            __ldg(inv + kk)),
                                  __ldg(gam + kk)),
                        __ldg(bet + kk));
        if (relu) v = v < 0.f ? 0.f : v;
        a[e] = ok ? v : 0.f;
      }
      store8_bf16(&as[xrow[r]][xc], a);
    }
    store8_bf16(&bs[wrow][wc], wv);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
    stage(k0);
    __syncthreads();
    if (k0 + BK < k) fetch(k0 + BK);    // in flight during the products
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &as[warp_m * WM + i * 16 + (lane & 15)]
                             [kb + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        // matrices: k 0-7 and 8-15 of n-tile j, then of n-tile j + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, &bs[kb + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                [warp_n * WN + j * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: this thread holds rows (g, g + 8) of each 16-row tile i and
  // columns (2t, 2t + 1) of each 8-column tile j of its warp's 32 x 32
  const bool pair = n % 2 == 0;         // two-value stores stay aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + warp_m * WM + i * 16 + h * 8 + g;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp_n * WN + j * 8 + 2 * t;
        if (col >= n) continue;
        store_out(y + (size_t)row * n + col, acc[i][j][h * 2],
                  acc[i][j][h * 2 + 1], col + 1 < n, pair);
      }
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m0 + warp_m * WM + i * 16 + h * 8 + g < m) {
            const float v = acc[i][j][h * 2 + e];
            s += v;
            s2 = fmaf(v, v, s2);
          }
        }
      // the 8 lanes of one t hold the warp's 32 rows of this column
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        red[warp_m][0][warp_n * WN + j * 8 + 2 * t + e] = s;
        red[warp_m][1][warp_n * WN + j * 8 + 2 * t + e] = s2;
      }
    }
  __syncthreads();
  // the four row-quarter warps of each column, added in order
  if (tid < BN && n0 + tid < n) {
    const size_t at = (size_t)mt * n + n0 + tid;
    part_s[at] = (red[0][0][tid] + red[1][0][tid]) + (red[2][0][tid] +
                                                      red[3][0][tid]);
    part_s2[at] = (red[0][1][tid] + red[1][1][tid]) + (red[2][1][tid] +
                                                       red[3][1][tid]);
  }
}

constexpr int SC = 32;          // columns per stats block
constexpr int SG = 32;          // row groups per stats block (N is small:
                                // 64 or 128 columns over thousands of rows)

// s[c] and s2[c] from the partials [rows, n], in a fixed order: row group g
// sums rows g, g + SG, ...; the SG group sums are added in order.
__global__ void __launch_bounds__(SC * SG)
stats_kernel(const float* __restrict__ part_s,
             const float* __restrict__ part_s2, float* __restrict__ s,
             float* __restrict__ s2, int rows, int n) {
  __shared__ float sh[2][SG][SC];
  const int c = blockIdx.x * SC + threadIdx.x;
  const int g = threadIdx.y;
  float a = 0.f, b = 0.f;
  if (c < n) {
    for (int r = g; r < rows; r += SG) {
      a += part_s[(size_t)r * n + c];
      b += part_s2[(size_t)r * n + c];
    }
  }
  sh[0][g][threadIdx.x] = a;
  sh[1][g][threadIdx.x] = b;
  __syncthreads();
  if (g == 0 && c < n) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int q = 0; q < SG; ++q) {
      ta += sh[0][q][threadIdx.x];
      tb += sh[1][q][threadIdx.x];
    }
    s[c] = ta;
    s2[c] = tb;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const float* stats, void* y,
           float* part, float* out, int m, int k, int n, int relu,
           cudaStream_t st) {
  const long long mtiles = (m + BM - 1) / BM;
  const int ntn = (n + BN - 1) / BN;
  if (mtiles * ntn > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte loads: an aligned start and rows a multiple of 16 bytes
  const int per16x = 16 / (int)sizeof(TX), per16w = 16 / (int)sizeof(TW);
  const int vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && k % per16x == 0;
  const int vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && n % per16w == 0;
  float* ps = part;
  float* ps2 = part + (size_t)mtiles * n;
  mm_bn_stats_kernel<TX, TW><<<(unsigned)(mtiles * ntn), THREADS, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), stats,
      static_cast<TX*>(y), ps, ps2, m, k, n, ntn, relu, vec_x, vec_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<(n + SC - 1) / SC, dim3(SC, SG), 0, st>>>(
      ps, ps2, out, out + n, (int)mtiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of the partials buffer the wrapper allocates: 2 * rows * n floats
long long paddle_tpu_torch_matmul_bn_stats_rows(int m) {
  return (m + BM - 1) / BM;
}

// y [m, n] (x's type) = act(norm(x [m, k])) @ w [k, n]; x and w float32
// (0) or bfloat16 (1) each; stats: mu, inv, g, b as 4 x k float32, or null
// for no normalize; part: scratch of 2 * rows * n floats; out: s then s2,
// 2 * n floats.  Returns a cudaError_t (0 = launched).
int paddle_tpu_torch_matmul_bn_stats(const void* x, const void* w,
                                     const void* stats, void* y, void* part,
                                     void* out, int m, int k, int n,
                                     int x_bf16, int w_bf16, int relu,
                                     void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(stats);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, sf, y, pf, of, m, k, n,
                                                relu, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, sf, y, pf, of, m, k, n, relu,
                                        st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, sf, y, pf, of, m, k, n, relu,
                                        st);
  return launch<float, float>(x, w, sf, y, pf, of, m, k, n, relu, st);
}

}  // extern "C"
