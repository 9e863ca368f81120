// 1x1 convolution with batch-norm statistics (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/conv_bn.py
// conv1x1_stats_nchw (:143, pallas_call :160, body _nchw_kernel :122).  For
// x [N, Cin, P] (an NCHW activation, P = H*W) and w [Cout, Cin]:
//
//   y[n, co, p] = sum_ci bf16(w[co, ci]) * bf16(x[n, ci, p])   (f32 sums)
//   s[co]  = sum_{n, p} y[n, co, p]
//   s2[co] = sum_{n, p} y[n, co, p]^2
//
// The operands are rounded to bfloat16 (round to nearest even; a bf16
// operand is read as it is) as the TPU kernel casts them, and multiplied on
// the tensor cores with float32 accumulation, as the TPU's MXU does.  y is
// written in x's type (rounded once from the float32 sum), s and s2 come
// from the float32 sums (:128-140).  Two forms, by x's type:
//
// The bf16 form (AMP: bf16 x and y, the float32 master w or a bf16 w) runs
// on the GEMM core of sm90_gemm.cuh (persistent blocks, a producer
// warpgroup filling a ring of shared-memory stages, two consumer
// warpgroups with bf16 wgmma into float32 accumulators):
//  - rows are output channels: A is w, rounded once a call into a bf16
//    copy [Cout, Cin rounded up to 8] and read K-major by TMA.  Columns are
//    pixels: B is x, n contiguous, so MN-major.  A column tile holds whole
//    images where an image (its pixels rounded up to 64 for TMA, to 8
//    otherwise) fits in 128 columns, two images at P = 49; else 128 pixels
//    of one image (P = 3136, 784: 25 and 7 tiles an image; P = 196: 2).
//    The TPU takes one whole P row per block, because no 128-multiple
//    divides 3136, 784, 196 or 49; the mma.sync form below flattens the
//    N * P pixels instead, which TMA cannot describe.
//  - where an image row is whole 16-byte chunks (P = 3136, 784), TMA loads
//    B from a 3-d map [N][Cin][P] in boxes of 64 pixels x 64 channels of
//    one image, the consumer warpgroups take 128-channel tiles in turn
//    (ping-pong), and y goes out by TMA stores from a staged tile.  At
//    P = 196 and 49 (19 of an AMP ResNet-50 step's 36 launches) a row is
//    392 or 98 bytes and no tensor map can stride it: one producer thread
//    copies each image's slab of the stage's 64 channels (contiguous,
//    16-byte aligned since Cin % 8 == 0) into a ring of raw stages with
//    cp.async.bulk, and three producer warps lay the slabs out as B's
//    swizzled panels, 8 pixels (16 bytes) a store, neighbouring lanes on
//    neighbouring chunks, shifting each row's words into place; from 12 k
//    steps (Cin >= 768) both consumer warpgroups share each laid-out
//    stage over 256 channels, since the layout bounds those tiles; y goes
//    out from the registers (its rows are not whole 16-byte chunks).
//  - the epilogue sums each channel's y and y^2 over the tile's valid
//    pixels from the float32 accumulators; each consumer warpgroup adds
//    its tiles' sums into its own row of a partials buffer [2 x blocks,
//    Cout], one thread a channel, in a fixed order, and the second kernel
//    sums the rows per channel in a fixed order: deterministic, no
//    atomics.
//
// The float32 form (float32 x and y) keeps the first design: one GEMM over
// the flattened N*P pixels (column c is pixel c % P of image c / P), a
// block of 8 warps per 128 x 128 tile, each Cin step staging 32 channels
// of w and x in shared memory through registers, rounded to bf16 as they
// are stored, one step ahead; 2 x 8 mma.sync m16n8k16 tiles a warp; y
// staged through shared memory for coalesced rows; the statistics reduced
// per 128-pixel column tile into partials and summed by the same second
// kernel.  Its redesign on the core is queued.
//
// A strided input (the stride-2 shortcut) arrives as a contiguous copy
// made by the caller.
//
// What bounds it on an H100: at ResNet-50's shapes every call moves more
// bytes (x and y) than its products need time at the tensor-core rate, so
// memory bounds the function except for the late-stage shapes with large
// Cin and Cout at P = 49 ((1024, 2048, 49) by operations); an AMP step's 36
// launches have a bound of 2.605 ms.  On an H100 80GB HBM3 at 700 W the
// bf16 form takes ~7.8 ms a step: at the TMA shapes a tile's one to four
// k steps are short beside its epilogue (2.5-3 us a tile), and at P = 196
// and 49 the three laying-out warps bound the stage rate (~1.5-2 us a
// stage of 64 channels) and y's register stores its epilogue (~12 us a
// tile).  The float32 form stages its operands through registers into a
// single shared-memory stage (the products run at 20-70 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sm90_gemm.cuh"

namespace {

// --- the float32 form: mma.sync, operands staged through registers --------

namespace f32k {

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

// x and y float32; TW: the element type of w (float or __nv_bfloat16)
template <typename TW>
__global__ void __launch_bounds__(THREADS)
conv1x1_stats_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                     float* __restrict__ y, float* __restrict__ part_s,
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
  float xr[BL];
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
      xr[r] = (col_ok && ci < cin) ? x[x_base + (size_t)ci * p] : 0.f;
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

// s and s2 [cout] from the partials [2][rows][cout]
int launch_stats(float* ps, float* sf, int rows, int cout, cudaStream_t st) {
  stats_kernel<<<(cout + SC - 1) / SC, dim3(SC, SG), 0, st>>>(
      ps, ps + (size_t)rows * cout, sf, sf + cout, rows, cout);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch(const void* x, const void* w, void* y, float* ps, float* sf,
           int cin, int cout, int p, long long ncols, long long ctiles,
           int rtiles, cudaStream_t st) {
  const size_t rows = (size_t)ctiles;
  conv1x1_stats_kernel<TW><<<dim3((unsigned)ctiles, rtiles), THREADS, 0,
                                  st>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w),
      static_cast<float*>(y), ps, ps + rows * cout, cin, cout, p, ncols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_stats(ps, sf, (int)rows, cout, st);
}

}  // namespace f32k


// --- the bf16 form (AMP): bf16 x and y, float32 or bf16 w, on the GEMM
// core of sm90_gemm.cuh --------------------------------------------------

namespace bf16k {

using namespace sm90g;

constexpr int TMA_STAGES = 4;         // x's rows whole 16-byte chunks
constexpr int COOP_KTILES = 12;       // k steps from which it pays that
                                      // both warpgroups share a B stage
constexpr int RAW_STAGES = 3;         // ... behind a ring of raw x slabs
constexpr int GATHER_MAX_P = 256;     // the widest row laid out of a slab
constexpr int RAW_BYTES = BK * GATHER_MAX_P * 2;   // a stage's slabs
constexpr int GATHER_WARPS = 3;       // producer warps 1-3 lay slabs out
constexpr int UNIT_CHUNKS = 4;        // chunks of that loaded at a time

struct TmaLayout {
  Stages<TMA_STAGES> g;
  OutTiles out;              // y's tiles, staged for TMA stores
};

// AR: the A tile's rows, BM (ping-pong) or 2 BM (cooperative: both
// warpgroups on each laid-out B stage)
template <int AR>
struct GatherLayout {
  Stages<AR == BM ? 3 : 2, AR> g;
  alignas(128) uint8_t raw[RAW_STAGES][RAW_BYTES];
  uint8_t past[32];          // takes the reads past the last slab
  uint64_t raw_full[RAW_STAGES];
  uint64_t raw_empty[RAW_STAGES];
};

// The pixel columns of the GEMM.  Column tile ct covers images img0 ..
// img0 + ipt - 1, each `span` columns of the tile from pixel p0 (a tile
// holds whole images where a padded image fits, else one image's pixels
// p0 .. p0 + 127, per_img tiles an image).  inv: 2^20 / span rounded up,
// so that (col * inv) >> 20 = col / span for every column of a tile.
struct Cols {
  int span, ipt, per_img, inv;
  __device__ __forceinline__ int image(int col) const {
    return (col * inv) >> 20;
  }
  __device__ __forceinline__ void at(int ct, int& img0, int& p0) const {
    if (per_img) {
      img0 = ct / per_img, p0 = (ct % per_img) * BN;
    } else {
      img0 = ct * ipt, p0 = 0;
    }
  }
};

struct Args {
  const __nv_bfloat16* x;    // [n, cx, px]: cx >= cin channels, px >= p
  __nv_bfloat16* y;          // [n, cout, p]
  float* part_s;             // [2 gridDim.x, cout], zeroed (then part_s2)
  float* part_s2;
  int n, cin, cx, cout, p, px;
  Cols cols;
  Tiles tiles;                  // m tiles innermost: a wave shares x
  int ktiles;
};

// The consumer warpgroup's partial sums of y and y^2 per output channel
// for tile (mt, ct) (rows are output channels, columns pixels), and with
// STORE the tile's part of y, from the accumulators' registers.  A
// warpgroup adds its tiles' sums into its own row of the partials, each
// channel's by one thread, in its fixed tile order: the statistics are
// deterministic without atomics.
template <bool STORE>
__device__ __forceinline__ void epilogue(const Args& a, int c,
                                         float (&acc)[2][ACC], int mt,
                                         int ct) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int img0, p0;
  a.cols.at(ct, img0, p0);
  const int span = a.cols.span;
  int co[2][2];
  bool row_ok[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      co[h][r] = mt * BM + 64 * h + 16 * warp + lane / 4 + 8 * r;
      row_ok[h][r] = co[h][r] < a.cout;
    }
  const bool even_p = a.p % 2 == 0;  // every pair then starts on 4 bytes
  float s[2][2] = {}, s2[2][2] = {};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    // columns col, col + 1 lie in one image's span (span is even)
    const int col = 8 * i + 2 * (lane % 4);
    const int il = a.cols.image(col);
    const int pix = p0 + col - il * span;
    const bool v0 = il < a.cols.ipt && img0 + il < a.n && pix < a.p;
    const bool v1 = v0 && pix + 1 < a.p;
    // y[img][co][pix] = y[base + co * p]
    const long long base = (long long)(img0 + il) * a.cout * a.p + pix;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float y0 = v0 ? acc[h][4 * i + 2 * r] : 0.f;
        const float y1 = v1 ? acc[h][4 * i + 2 * r + 1] : 0.f;
        s[h][r] += y0 + y1;
        s2[h][r] = fmaf(y1, y1, fmaf(y0, y0, s2[h][r]));
        if (!STORE || !v0 || !row_ok[h][r]) continue;
        const long long at = base + (long long)co[h][r] * a.p;
        if (v1 && (even_p || at % 2 == 0)) {
          store2(a.y + at, y0, y1);
        } else {
          a.y[at] = __float2bfloat16_rn(y0);
          if (v1) a.y[at + 1] = __float2bfloat16_rn(y1);
        }
      }
  }
  // the four threads of a row hold its 128 columns: added in a fixed order
  float* ps = a.part_s + (long long)(2 * blockIdx.x + c) * a.cout;
  float* ps2 = a.part_s2 + (long long)(2 * blockIdx.x + c) * a.cout;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = s[h][r], t2 = s2[h][r];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t2 += __shfl_xor_sync(0xffffffffu, t2, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      t2 += __shfl_xor_sync(0xffffffffu, t2, 2);
      if (lane % 4 == 0 && row_ok[h][r]) {
        ps[co[h][r]] += t;
        ps2[co[h][r]] += t2;
      }
    }
}

// x's rows are whole 16-byte chunks (px % 8 == 0): B by TMA, boxes of 64
// pixels x 64 channels of one image from a 3-d map [n][cx][px]
template <bool TMA_Y>
__global__ void __launch_bounds__(THREADS, 1)
conv_tma_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_y, const Args a) {
  TmaLayout& sm = smem<TmaLayout>();
  const int c = setup<40>(sm.g, 1);
  if (c < 0) {
    if (threadIdx.x == 0)
      produce(sm.g, a.tiles, a.ktiles,
              [&](int s, uint64_t* full, int mt, int ct, int kt) {
                int img0, p0;
                a.cols.at(ct, img0, p0);
                const int per = a.cols.span / 64;    // panels an image
                mbar_expect_tx(full, A_BYTES + B_BYTES);
                tma_load_2d(sm.g.a[s], &map_w, full, kt * BK, mt * BM);
                for (int j = 0; j < BN / 64; ++j)
                  tma_load_3d(sm.g.b[s] + j * B_PANEL, &map_x, full,
                              p0 + 64 * (j % per), kt * BK, img0 + j / per);
              });
    return;
  }
  if constexpr (!TMA_Y) {
    consume(sm.g, c, a.tiles, a.ktiles,
            [&](float (&acc)[2][ACC], int mt, int ct) {
              epilogue<true>(a, c, acc, mt, ct);
            });
    return;
  }
  // y [n][cout][p] by TMA stores, boxes of 64 pixels x 64 channels of one
  // image (the ones past p, cout or n dropped), from the staged tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  consume(sm.g, c, a.tiles, a.ktiles,
          [&](float (&acc)[2][ACC], int mt, int ct) {
            epilogue<false>(a, c, acc, mt, ct);
            store_staged(
                sm.out.v[c], c,
                [&](uint8_t* buf) {
                  const uint32_t tile = smem_u32(buf);
#pragma unroll
                  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                      for (int r = 0; r < 2; ++r)
                        stage2<__nv_bfloat16>(
                            tile, BM, 64 * h + 16 * warp + lane / 4 + 8 * r,
                            8 * i + 2 * (lane % 4), acc[h][4 * i + 2 * r],
                            acc[h][4 * i + 2 * r + 1]);
                },
                [&](uint8_t* buf) {
                  int img0, p0;
                  a.cols.at(ct, img0, p0);
                  const int per = a.cols.span / 64;
                  for (int j = 0; j < BN / 64; ++j)
                    for (int h = 0; h < 2; ++h)
                      tma_store_3d(&map_y, buf + j * BM * 128 + h * 64 * 128,
                                   p0 + 64 * (j % per), mt * BM + 64 * h,
                                   img0 + j / per);
                });
          });
  if (threadIdx.x % 128 == 0) bulk_wait();
}

// the 8 bf16 from element sh on of the 16 in (lo, hi): two words, then
// one, then half a word
__device__ __forceinline__ uint4 shift8(const uint4& lo, const uint4& hi,
                                        int sh) {
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (sh & 4) {
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
  }
  if (sh & 2) {
#pragma unroll
    for (int j = 0; j < 7; ++j) w[j] = w[j + 1];
  }
  if (sh & 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __funnelshift_r(w[j], w[j + 1], 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the bf16 of v from element `keep` on set to 0 (keep < 8)
__device__ __forceinline__ uint4 keep_first(uint4 v, int keep) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    if (e >= keep) w[e / 2] = 0;
    else if (e + 1 >= keep) w[e / 2] &= 0xffffu;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// B's 16 bytes of 8 pixels at tile column col (a multiple of 8), channel
// row k: 64-column panels, 128-byte rows, 16-byte chunks swizzled by k % 8
__device__ __forceinline__ uint4* b_chunk(uint8_t* b, int k, int col) {
  return reinterpret_cast<uint4*>(b + (col / 64) * B_PANEL + k * PANEL_ROW +
                                  ((((col % 64) / 8) ^ (k & 7)) * 16));
}

// x's rows are not whole 16-byte chunks (P = 196, 49): warp 0 of the
// producer copies each image's slab of the stage's channels ([BK, px],
// contiguous, 16-byte aligned as cx % 8 == 0) into a raw ring with
// cp.async.bulk; warps 1-3 issue the A tile by TMA and lay each slab out
// as the B tile's swizzled MN-major panels (8 pixels, 16 bytes, a store;
// an image's row starts on a 16-byte chunk of the tile, span columns
// apart).
template <int AR>
__global__ void __launch_bounds__(THREADS, 1)
conv_gather_kernel(const __grid_constant__ CUtensorMap map_w, const Args a) {
  GatherLayout<AR>& sm = smem<GatherLayout<AR>>();
  if (threadIdx.x == 0) {
    for (int r = 0; r < RAW_STAGES; ++r) {
      mbar_init(&sm.raw_full[r], 1);
      mbar_init(&sm.raw_empty[r], GATHER_WARPS);
    }
  }
  const int c = setup<88>(sm.g, GATHER_WARPS * 32);
  const int span = a.cols.span, ipt = a.cols.ipt;
  if (c < 0) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane != 0) return;
      Ring<RAW_STAGES> r;
      for (int t = blockIdx.x; t < a.tiles.count(); t += gridDim.x) {
        int mt, ct, img0, p0;
        a.tiles.at(t, mt, ct);
        a.cols.at(ct, img0, p0);
        const int imgs = min(ipt, a.n - img0);
        for (int kt = 0; kt < a.ktiles; ++kt, r.next()) {
          const int rows = min(BK, a.cx - kt * BK);
          const uint32_t bytes = (uint32_t)rows * a.px * 2;
          wait(&sm.raw_empty[r.s], r.phase ^ 1);
          mbar_expect_tx(&sm.raw_full[r.s], rows > 0 ? imgs * bytes : 0);
          for (int il = 0; rows > 0 && il < imgs; ++il) {
            const __nv_bfloat16* src =
                a.x + ((long long)(img0 + il) * a.cx + kt * BK) * a.px;
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];\n"
                :: "r"(smem_u32(sm.raw[r.s] + il * bytes)), "l"(src),
                   "r"(bytes), "r"(smem_u32(&sm.raw_full[r.s]))
                : "memory");
          }
        }
      }
      return;
    }
    // warps 1-3: lay the raw slabs out into the GEMM stages.  A channel
    // row of the tile is cpr = ipt * nch 16-byte chunks (at most 16), each
    // 8 pixels of one image; the stage's 64 * cpr chunks go to the threads
    // in turn, so neighbouring lanes read neighbouring words of a slab and
    // store neighbouring chunks of a panel row (no bank conflicts).
    const int tid = threadIdx.x - 32;
    const int nch = span / 8;              // chunks an image's span
    const int cpr = ipt * nch;             // chunks a channel row
    // this thread's chunks, the same at every stage: k << 8 | il << 4 |
    // ch, -1 past the last
    constexpr int MAX_CHUNKS =
        (BK * (BN / 8) + GATHER_WARPS * 32 - 1) / (GATHER_WARPS * 32);
    int chunk[MAX_CHUNKS];
#pragma unroll
    for (int j = 0; j < MAX_CHUNKS; ++j) {
      const int z = tid + j * GATHER_WARPS * 32;
      const int k = z / cpr, f = z % cpr;
      chunk[j] = k < BK ? k << 8 | (f / nch) << 4 | f % nch : -1;
    }
    Ring<RAW_STAGES> r;
    produce(sm.g, a.tiles, a.ktiles,
            [&](int s, uint64_t* full, int mt, int ct, int kt) {
              if (tid == 0) {
                mbar_expect_tx_only(full, AR / BM * A_BYTES);
#pragma unroll
                for (int h = 0; h < AR / BM; ++h)
                  tma_load_2d(sm.g.a[s] + h * A_BYTES, &map_w, full,
                              kt * BK, mt * AR + h * BM);
              }
              int img0, p0;
              a.cols.at(ct, img0, p0);
              const int rows = min(BK, a.cx - kt * BK);
              const int slab = rows * a.px;          // elements an image
              wait(&sm.raw_full[r.s], r.phase);
              const uint8_t* raw = sm.raw[r.s];
              uint8_t* b = sm.g.b[s];
              // UNIT_CHUNKS chunks at a time: their two 16-byte words each
              // (from the slab's aligned start; words past the last slab
              // lie in sm.past, read and never used) all loaded before any
              // is shifted into place
#pragma unroll
              for (int j0 = 0; j0 < MAX_CHUNKS; j0 += UNIT_CHUNKS) {
                uint4 lo[UNIT_CHUNKS], hi[UNIT_CHUNKS];
                int sh[UNIT_CHUNKS], keep[UNIT_CHUNKS];
#pragma unroll
                for (int q = 0; q < UNIT_CHUNKS; ++q) {
                  const int j = j0 + q;
                  const int cj = j < MAX_CHUNKS ? chunk[j] : -1;
                  const int k = cj >> 8, il = (cj >> 4) & 15;
                  const int pix = p0 + 8 * (cj & 15);
                  const bool live = cj >= 0 && k < rows && img0 + il < a.n &&
                                    pix < a.p;
                  const int f = k * a.px + pix;
                  const uint4* w = reinterpret_cast<const uint4*>(
                                       raw + (long long)il * slab * 2) + f / 8;
                  lo[q] = live ? w[0] : make_uint4(0, 0, 0, 0);
                  hi[q] = live ? w[1] : make_uint4(0, 0, 0, 0);
                  sh[q] = f % 8;
                  keep[q] = live ? min(8, a.p - pix) : 0;
                }
#pragma unroll
                for (int q = 0; q < UNIT_CHUNKS; ++q) {
                  const int j = j0 + q;
                  const int cj = j < MAX_CHUNKS ? chunk[j] : -1;
                  if (cj < 0) continue;
                  uint4 v = shift8(lo[q], hi[q], sh[q]);
                  if (keep[q] < 8) v = keep_first(v, keep[q]);
                  *b_chunk(b, cj >> 8,
                           ((cj >> 4) & 15) * span + 8 * (cj & 15)) = v;
                }
              }
              fence_async_shared();
              __syncwarp();
              if ((tid & 31) == 0) mbar_arrive(&sm.raw_empty[r.s]);
              mbar_arrive(full);
              r.next();
            });
    return;
  }
  consume(sm.g, c, a.tiles, a.ktiles,
          [&](float (&acc)[2][ACC], int mt, int ct) {
            epilogue<true>(a, c, acc, mt, ct);
          });
}

// w [cout, cin] (float32 or bf16) rounded to bf16 rows of cin8 elements
template <typename TW>
__global__ void __launch_bounds__(256)
round_w_kernel(const TW* __restrict__ w, __nv_bfloat16* __restrict__ out,
               int cout, int cin, int cin8) {
  const long long n = (long long)cout * cin8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / cin8), k = (int)(i % cin8);
    out[i] = k < cin ? ptt::to_bf16(w[(long long)r * cin + k])
                     : __float2bfloat16_rn(0.f);
  }
}

Cols columns(int p, bool tma) {
  // TMA lands an image's pixels in whole 64-column panels; a gathered
  // image's take 16-byte chunks
  int span = tma ? (p + 63) / 64 * 64 : (p + 7) / 8 * 8;
  if (span > BN) span = BN;
  return {span, BN / span, span == BN ? (p + BN - 1) / BN : 0,
          (1 << 20) / span + 1};
}

long long column_tiles(int n, const Cols& c) {
  return c.per_img ? (long long)n * c.per_img
                   : ((long long)n + c.ipt - 1) / c.ipt;
}

bool use_tma(int px) { return px % 8 == 0; }

// how a call runs: TMA or laid-out B, its columns, its tiles (128 rows
// ping-pong; or, laying B out over at least COOP_KTILES k steps, 256 rows
// with both warpgroups on each B stage, `coop`: the layout bounds those
// tiles, and it is then shared) and its grid; m_tiles 0 if the tiles
// overflow an int
struct Plan {
  bool tma, coop;
  Cols cols;
  Tiles tiles;
  unsigned grid;
};

Plan plan(int n, int cin, int cout, int p, int px) {
  Plan pl;
  pl.tma = use_tma(px);
  pl.cols = columns(p, pl.tma);
  pl.coop = !pl.tma && (cin + BK - 1) / BK >= COOP_KTILES;
  const long long ctiles = column_tiles(n, pl.cols);
  const int rows = pl.coop ? 2 * BM : BM;
  long long m_tiles = (cout + rows - 1) / rows;
  if (m_tiles * ctiles > 0x7fffffffLL) m_tiles = 0;
  pl.tiles = {(int)m_tiles, (int)ctiles, true};
  pl.grid = grid_for((long long)m_tiles * ctiles, pl.coop);
  return pl;
}

}  // namespace bf16k

// the bf16 form on the card: rounds w, then the GEMM, then the statistics
namespace bf16k {

template <typename TW>
int launch(const void* x, const void* w, void* y, __nv_bfloat16* wcopy,
           float* part, float* stats, int n, int cin, int cx, int cout,
           int p, int px, cudaStream_t st) {
  const int cin8 = (cin + 7) / 8 * 8;
  const long long welems = (long long)cout * cin8;
  const long long wblocks = (welems + 255) / 256;
  round_w_kernel<TW><<<(unsigned)(wblocks < 1024 ? wblocks : 1024), 256, 0,
                       st>>>(static_cast<const TW*>(w), wcopy, cout, cin,
                             cin8);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  CUtensorMap mw;
  err = encode_2d(&mw, wcopy, cout, cin, cin8, BM);
  if (err != 0) return err;
  const Plan pl = plan(n, cin, cout, p, px);
  if (pl.tiles.m_tiles == 0) return (int)cudaErrorInvalidValue;
  const bool tma = pl.tma;
  const Cols cols = pl.cols;
  const Tiles tiles = pl.tiles;
  const unsigned grid = pl.grid;
  const int rows = 2 * grid;             // one a consumer warpgroup
  float* part_s2 = part + (size_t)rows * cout;
  cudaError_t e = cudaMemsetAsync(part, 0, sizeof(float) * 2 * rows * cout,
                                  st);
  if (e != cudaSuccess) return (int)e;
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<__nv_bfloat16*>(y), part, part_s2, n, cin, cx,
               cout, p, px, cols, tiles, (cin + BK - 1) / BK};
  if (tma) {
    // y by TMA stores where its rows are whole 16-byte chunks (a wide
    // ragged x arrives padded, its y is not)
    const bool tma_y = p % 8 == 0;
    CUtensorMap mx, my = {};
    err = encode_rows(&mx, x, n, cx, px);
    if (err == 0 && tma_y) err = encode_rows(&my, y, n, cout, p);
    if (err != 0) return err;
    constexpr int bytes = smem_bytes<TmaLayout>();
    auto kernel = tma_y ? conv_tma_kernel<true> : conv_tma_kernel<false>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, bytes, st>>>(mw, mx, my, a);
  } else {
    const int bytes = pl.coop ? smem_bytes<GatherLayout<2 * BM>>()
                              : smem_bytes<GatherLayout<BM>>();
    auto kernel = pl.coop ? conv_gather_kernel<2 * BM>
                          : conv_gather_kernel<BM>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, bytes, st>>>(mw, a);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return f32k::launch_stats(part, stats, rows, cout, st);
}

}  // namespace bf16k

}  // namespace

extern "C" {

// x [n, cin, p] float32 and y [n, cout, p] float32, w [cout, cin] float32
// (w_bf16 = 0) or bf16 (1); part: scratch of 2 * ceil(n * p / 128) * cout
// floats; stats: s then s2, 2 * cout floats.  Returns a cudaError_t (0 =
// launched).
int paddle_tpu_torch_conv1x1_stats(const void* x, const void* w, void* y,
                                   void* part, void* stats, int n, int cin,
                                   int cout, int p, int w_bf16,
                                   void* stream) {
  using namespace f32k;
  if (n <= 0 || cin <= 0 || cout <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  const long long ncols = (long long)n * p;
  const long long ctiles = (ncols + BN - 1) / BN;
  const int rtiles = (cout + BM - 1) / BM;
  if (rtiles > 65535 || ctiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  return w_bf16 ? launch<__nv_bfloat16>(x, w, y, ps, sf, cin, cout, p,
                                        ncols, ctiles, rtiles, st)
                : launch<float>(x, w, y, ps, sf, cin, cout, p, ncols, ctiles,
                                rtiles, st);
}

// the rows of the bf16 form's partials (one a consumer warpgroup of its
// grid) for n images of cin channels and p pixels stored in rows of px,
// and cout output channels
long long paddle_tpu_torch_conv1x1_stats_bf16_rows(int n, int cin, int p,
                                                   int px, int cout) {
  return 2 * (long long)bf16k::plan(n, cin, cout, p, px).grid;
}

// The bf16 form: x [n, cx, px] bf16 (cx >= cin channels, a multiple of 8,
// those past cin zero; px >= p pixels, those past p ignored; 16-byte
// aligned; px a multiple of 8, or px = p <= 256), w [cout, cin] float32
// (w_bf16 = 0) or bf16 (1), y [n, cout, p] bf16; wcopy: scratch of cout *
// ceil8(cin) bf16 (16-byte aligned); part: 2 * rows * cout floats (rows
// from paddle_tpu_torch_conv1x1_stats_bf16_rows); stats: s then s2.
// Returns a cudaError_t (0 = launched), or sm90::TENSOR_MAP_ERROR + the
// CUresult of a tensor map.
int paddle_tpu_torch_conv1x1_stats_bf16(const void* x, const void* w,
                                        void* y, void* wcopy, void* part,
                                        void* stats, int n, int cin, int cx,
                                        int cout, int p, int px, int w_bf16,
                                        void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || p <= 0 || cx < cin || cx % 8 ||
      px < p ||
      (!bf16k::use_tma(px) && (px > bf16k::GATHER_MAX_P || px != p)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wcopy) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wc = static_cast<__nv_bfloat16*>(wcopy);
  float* ps = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  return w_bf16 ? bf16k::launch<__nv_bfloat16>(x, w, y, wc, ps, sf, n, cin,
                                               cx, cout, p, px, st)
                : bf16k::launch<float>(x, w, y, wc, ps, sf, n, cin, cx,
                                       cout, p, px, st);
}

}  // extern "C"
