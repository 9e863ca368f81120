// 1x1 convolution with batch-norm statistics (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/conv_bn.py
// conv1x1_stats_nchw (:143, pallas_call :160, body _nchw_kernel :122).  For
// x [N, Cin, P] (an NCHW activation, P = H*W) and w [Cout, Cin], each
// float32 or bf16 (under AMP x arrives in bf16, w is the float32 master):
//
//   y[n, co, p] = sum_ci bf16(w[co, ci]) * bf16(x[n, ci, p])   (f32 sums)
//   s[co]  = sum_{n, p} y[n, co, p]
//   s2[co] = sum_{n, p} y[n, co, p]^2
//
// The operands are rounded to bfloat16 (round to nearest even; a bf16
// operand is read as it is) as the TPU kernel casts them, and multiplied on
// the tensor cores with float32 accumulation (mma.sync m16n8k16, bf16 in,
// f32 out), as the TPU's MXU does.  y is written in x's type (rounded once
// from the float32 sum), s and s2 come from the float32 sums (:128-140).
//
// Design:
//  - the product is one GEMM per call: rows are output channels, columns
//    the N*P pixels of all images (column c is pixel c % P of image
//    c / P), so the ragged P of ResNet's late stages (196, 49) wastes no
//    tile.  The TPU instead takes one whole P row per block, because no
//    128-multiple divides 3136, 784, 196 or 49.
//  - one block of 8 warps per (128-channel row tile, 128-pixel column
//    tile); each Cin step stages 32 input channels of w and x in shared
//    memory, rounded to bf16 as they are stored (x transposed, so both
//    operands are k-contiguous rows for ldmatrix; rows padded to 40
//    elements to keep it free of bank conflicts), while the next step's
//    values are already loading into registers; each warp runs a 32 x 64
//    tile as 2 x 8 mma tiles with float32 accumulators in registers.
//  - the epilogue stages the output tile in shared memory (over the
//    operand tiles, 64 rows at a time) so y is written in coalesced rows,
//    and reduces each channel's sum and sum of squares over the tile's
//    VALID pixels (columns past N*P hold zeros and are kept out all the
//    same) across the four threads sharing a row and then the two warps
//    sharing it, in a fixed order, into a partials buffer [column tiles,
//    Cout].  The TPU carries s and s2 across its sequential grid; blocks
//    here run in no order, so a second small kernel sums the partials per
//    channel in a fixed order: deterministic, no atomics.
//  - a strided input (the stride-2 shortcut) arrives as a contiguous copy
//    made by the caller.
//
// What bounds it on an H100: at ResNet-50's shapes every call moves more
// bytes (x, w and y, float32 or bf16) than its bf16 products need time at
// the tensor-core rate, so memory bounds the function; bf16 x and y halve
// those bytes.  This version
// stages its operands through registers with plain loads (no TMA), one step
// ahead, into a single shared-memory stage: each step's bf16 conversion and
// stores sit between two barriers, and at 228 registers a thread one block
// (8 warps) fits on an SM, so neither the loads nor the tensor cores are
// kept busy (the products run at 20-70 TFLOP/s).  A ring of stages filled
// by TMA with the conversion moved into the fragment loads, or wgmma, is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int BM = 128;         // output channels per block
constexpr int BN = 128;         // pixels (columns) per block
constexpr int BK = 32;          // input channels per stage
constexpr int KP = BK + 8;      // padded row length of the staged tiles
constexpr int THREADS = 256;    // 8 warps: 4 along channels x 2 along pixels
constexpr int WM = 32;          // channels per warp
constexpr int WN = 64;          // pixels per warp
constexpr int HM = BM / 2;      // output rows staged per epilogue pass
constexpr int YP = BN + 4;      // padded row length of the output tile
constexpr int AL = BM * BK / THREADS;   // w values a thread stages per step
constexpr int BL = BN * BK / THREADS;   // x values a thread stages per step
static_assert(BM * KP * 2 + BN * KP * 2 <= HM * YP * 4,
              "the staged operands fit in the output tile's space");
static_assert(BL * 2 == BK, "a thread stages half a column of x");

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l % 8) of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// TX: the element type of x and y; TW: that of w (float or __nv_bfloat16)
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
conv1x1_stats_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ y, float* __restrict__ part_s,
                     float* __restrict__ part_s2, int cin, int cout, int p,
                     long long ncols) {
  // the staged operands during the Cin loop, then half the output tile
  __shared__ __align__(16) unsigned char smem[HM * YP * 4];
  __shared__ float red[2][2][BM];                      // [warp_n][s|s2][row]
  auto as = reinterpret_cast<__nv_bfloat16 (*)[KP]>(smem);       // [BM][KP]
  auto bs = reinterpret_cast<__nv_bfloat16 (*)[KP]>(smem + BM * KP * 2);
  auto ys = reinterpret_cast<float (*)[YP]>(smem);               // [HM][YP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;          // channel quarter of the block
  const int warp_n = warp >> 2;         // pixel half of the block
  const int g = lane >> 2;              // fragment row group
  const int t = lane & 3;               // thread in group
  const long long col0 = (long long)blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;

  // this thread stages x's pixel column col0 + bc, input channels
  // kh .. kh + BL - 1 of each step, and writes that column of y at the end
  const int bc = tid % BN;
  const int kh = (tid / BN) * BL;
  const long long my_col = col0 + bc;
  const bool col_ok = my_col < ncols;
  size_t x_base = 0, y_base = 0;
  if (col_ok) {
    const long long n = my_col / p;
    const long long pix = my_col - n * p;
    x_base = (size_t)n * cin * p + (size_t)pix;
    y_base = (size_t)n * cout * p + (size_t)pix;
  }

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // global loads of one Cin step into registers: w consecutive threads
  // along ci, x consecutive threads along pixels
  // staged in their own type and rounded as they are stored: widened to
  // float32 here, each value would wait for its load before the products
  // (the bf16 form ran 1.7x slower so)
  TW wr[AL];
  TX xr[BL];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < AL; ++r) {
      const int idx = tid + r * THREADS;
      const int co = co0 + idx / BK, ci = k0 + idx % BK;
      wr[r] = (co < cout && ci < cin) ? w[(size_t)co * cin + ci] : TW(0.f);
    }
#pragma unroll
    for (int r = 0; r < BL; ++r) {
      const int ci = k0 + kh + r;
      xr[r] = (col_ok && ci < cin) ? x[x_base + (size_t)ci * p] : TX(0.f);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < cin; k0 += BK) {
    // round to bf16 into shared memory (x transposed: k-contiguous rows)
#pragma unroll
    for (int r = 0; r < AL; ++r) {
      const int idx = tid + r * THREADS;
      as[idx / BK][idx % BK] = ptt::to_bf16(wr[r]);
    }
#pragma unroll
    for (int r = 0; r < BL; r += 2)
      *reinterpret_cast<__nv_bfloat162*>(&bs[bc][kh + r]) =
          __halves2bfloat162(ptt::to_bf16(xr[r]), ptt::to_bf16(xr[r + 1]));
    __syncthreads();
    if (k0 + BK < cin) fetch(k0 + BK);    // in flight during the products
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &as[warp_m * WM + i * 16 + (lane & 15)]
                             [kb + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];          // b0, b1 of tile j, then of tile j + 1
        ldmatrix_x4(b, &bs[warp_n * WN + j * 8 + (lane & 7) +
                           ((lane >> 4) << 3)][kb + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[0],
                   b[1]);
          mma_bf16(acc[i][j + 1], a[i][0], a[i][1], a[i][2], a[i][3], b[2],
                   b[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue.  This thread holds rows (g, g + 8) of each 16-row tile i and
  // columns (2t, 2t + 1) of each 8-column tile j of its warp's 32 x 64.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp_m * WM + i * 16 + h * 8 + g;   // in the block
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col0 + warp_n * WN + j * 8 + 2 * t + e < ncols) {
            const float v = acc[i][j][h * 2 + e];
            s += v;
            s2 = fmaf(v, v, s2);
          }
        }
      // the four threads of a row group hold the warp's 64 columns of it
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      if (t == 0) {
        red[warp_n][0][row] = s;
        red[warp_n][1][row] = s2;
      }
    }
  // y through shared memory in two passes of 64 rows, so each row is
  // written by consecutive threads on consecutive pixels
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if ((warp_m >> 1) == half) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ys[(warp_m & 1) * WM + i * 16 + h * 8 + g]
                [warp_n * WN + j * 8 + 2 * t + e] = acc[i][j][h * 2 + e];
    }
    __syncthreads();
    if (col_ok) {
      for (int r = tid / BN; r < HM; r += THREADS / BN) {
        const int co = co0 + half * HM + r;
        if (co < cout) ptt::st(y + y_base + (size_t)co * p, ys[r][bc]);
      }
    }
    __syncthreads();
  }
  // the two pixel-half warps of each row, added in order
  if (tid < BM && co0 + tid < cout) {
    const size_t at = (size_t)blockIdx.x * cout + co0 + tid;
    part_s[at] = red[0][0][tid] + red[1][0][tid];
    part_s2[at] = red[0][1][tid] + red[1][1][tid];
  }
}

constexpr int SC = 32;          // channels per stats block
constexpr int SG = 8;           // row groups per stats block

// s[c] and s2[c] from the partials [rows, cout], in a fixed order: row group
// g sums rows g, g + SG, ...; the SG group sums are added in order.
__global__ void __launch_bounds__(SC * SG)
stats_kernel(const float* __restrict__ part_s,
             const float* __restrict__ part_s2, float* __restrict__ s,
             float* __restrict__ s2, int rows, int cout) {
  __shared__ float sh[2][SG][SC];
  const int c = blockIdx.x * SC + threadIdx.x;
  const int g = threadIdx.y;
  float a = 0.f, b = 0.f;
  if (c < cout) {
    for (int r = g; r < rows; r += SG) {
      a += part_s[(size_t)r * cout + c];
      b += part_s2[(size_t)r * cout + c];
    }
  }
  sh[0][g][threadIdx.x] = a;
  sh[1][g][threadIdx.x] = b;
  __syncthreads();
  if (g == 0 && c < cout) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      ta += sh[0][k][threadIdx.x];
      tb += sh[1][k][threadIdx.x];
    }
    s[c] = ta;
    s2[c] = tb;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, float* ps, float* sf,
           int cin, int cout, int p, long long ncols, long long ctiles,
           int rtiles, cudaStream_t st) {
  const size_t rows = (size_t)ctiles;
  conv1x1_stats_kernel<TX, TW><<<dim3((unsigned)ctiles, rtiles), THREADS, 0,
                                  st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), ps, ps + rows * cout, cin, cout, p, ncols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<(cout + SC - 1) / SC, dim3(SC, SG), 0, st>>>(
      ps, ps + rows * cout, sf, sf + cout, (int)rows, cout);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, cin, p] and y [n, cout, p] in x's type, w [cout, cin]: each float32
// (x_bf16 / w_bf16 = 0) or bf16 (1); part: scratch of
// 2 * ceil(n * p / 128) * cout floats; stats: s then s2, 2 * cout floats.
// Returns a cudaError_t (0 = launched).
extern "C" int paddle_tpu_torch_conv1x1_stats(
    const void* x, const void* w, void* y, void* part, void* stats, int n,
    int cin, int cout, int p, int x_bf16, int w_bf16, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long ncols = (long long)n * p;
  const long long ctiles = (ncols + BN - 1) / BN;
  const int rtiles = (cout + BM - 1) / BM;
  if (rtiles > 65535 || ctiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  using bf = __nv_bfloat16;
  switch (x_bf16 * 2 + w_bf16) {
    case 0: return launch<float, float>(x, w, y, ps, sf, cin, cout, p, ncols, ctiles, rtiles, st);
    case 1: return launch<float, bf>(x, w, y, ps, sf, cin, cout, p, ncols, ctiles, rtiles, st);
    case 2: return launch<bf, float>(x, w, y, ps, sf, cin, cout, p, ncols, ctiles, rtiles, st);
    case 3: return launch<bf, bf>(x, w, y, ps, sf, cin, cout, p, ncols, ctiles, rtiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
