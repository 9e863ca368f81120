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
// four separately rounded operations (__fsub_rn, __fmul_rn, __fmul_rn,
// __fadd_rn), so nvcc cannot contract it into FMAs: the float32 value before
// the bf16 rounding is the one the plain PyTorch ops give, bit for bit.
//
// Design: the GEMM core of sm90_gemm.cuh (persistent blocks, a producer
// warpgroup keeping a ring of TMA stages filled, two consumer warpgroups
// taking output tiles in turn, so one runs its epilogue while the other
// runs its products; bf16 wgmma into float32 accumulators):
//  - A is x, K-major, loaded by TMA in its own type (128 rows x 128 bytes a
//    box: 64 bf16 or 32 float32 columns; 4 stages of bf16, 3 of float32);
//    a stage also holds its 64 k's statistics (mu, inv, g, b), one
//    cp.async.bulk from a [K][4] copy.  A bf16 x with no statistics and no
//    relu goes straight into SS wgmma; every other x is read by each
//    consumer thread from the stage into the registers of its A fragments,
//    normalized, relu'd and rounded to bf16 there (consume_rs).  Rows past
//    M and columns past K are zeroed AFTER the prologue (a padded 0 would
//    normalize to (0 - mu) * inv * g + b), so they add exact zeros to the
//    products and to the statistics.
//  - B is w, rounded once a call into a bf16 copy [K, N rounded up to 8]
//    (at most 512 x 128 on the tool's path, so it stays in L2), MN-major, as
//    K5's w.  Tiles are 128 rows x 64 columns where N <= 64 (wgmma m64n64),
//    else 128 x 128.
//  - the epilogue sums each column's y and y^2 over the tile's rows from
//    the float32 accumulators (sm90_gemm.cuh column_stats) into its
//    warpgroup's row of a partials buffer [2 x blocks, N], and a second
//    kernel adds the rows per column in a fixed order: deterministic, no
//    atomics.  y goes out by TMA stores of a staged tile where its rows are
//    whole 16-byte chunks, else from the registers.
//  - each k16 step's bf16 products are summed into one float32 accumulator
//    in order, as the mma.sync form before it did: y is the same bits.
//
// What bounds it on an H100: at the ResNet-50 stage shapes of
// paddle_tpu_torch/tools/rn50_fused_bench.py every call moves far more bytes
// than its bf16 products need time (stage0's first call: x 411 MB + y 103 MB
// in bf16, 0.15 ms at 3.35 TB/s, against 26 GFLOP, 0.027 ms at 989 TFLOP/s),
// so memory bounds it: x streams through the ring once while the other
// warpgroup's epilogue runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace sm90g;

// the register split: the consumers of 128-column tiles spill at 232
// registers (ptxas) and fit in 240; the producer fits in 24
constexpr int PRODUCER_REGS = 24;
constexpr int P_BYTES = BK * 16;        // a stage's k statistics: 64 float4

template <typename TX, int BNK>
struct Layout {
  static constexpr int A_TILE = BM * BK * (int)sizeof(TX);
  Stages<sizeof(TX) == 2 ? 4 : 3, BM, A_TILE + P_BYTES, BK * BNK * 2> g;
  OutTiles out;                   // y's tiles, staged for TMA stores
  float red[2][4][2][BNK];        // column_stats, a consumer warpgroup each
};

struct Args {
  void* y;                   // [m, n], x's type
  float* part_s;             // [2 gridDim.x, n], zeroed (then part_s2)
  float* part_s2;
  const float4* pk;          // [k] of (mu, inv, g, b), or null
  int m, k, n, relu;
  Tiles tiles;               // row tiles x column tiles (innermost)
  int ktiles;
};

// the prologue of one value of column k: normalize (four separately
// rounded operations) with q = (mu, inv, g, b), then relu
__device__ __forceinline__ float prologue(float v, float4 q, bool stats,
                                          bool relu) {
  if (stats)
    v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, q.x), q.y), q.z), q.w);
  if (relu) v = v < 0.f ? 0.f : v;
  return v;
}

// columns k, k + 1 (k even) of a stage's A row R (row % 8 == g) as float32:
// a bf16 tile is one box of 64 columns, a float32 one two boxes of 32
template <typename TX>
__device__ __forceinline__ float2 load_pair(const uint8_t* as, int R, int k,
                                            int g) {
  if constexpr (sizeof(TX) == 2) {
    const uint32_t at = smem_u32(as) + R * PANEL_ROW +
                        ((((k / 8) ^ g) & 7) * 16) + (k % 8) * 2;
    uint32_t u;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u) : "r"(at) : "memory");
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  } else {
    const uint32_t at = smem_u32(as) + (k / 32) * BM * PANEL_ROW +
                        R * PANEL_ROW + (((((k % 32) / 4) ^ g) & 7) * 16) +
                        (k % 4) * 4;
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y) : "r"(at) : "memory");
    return v;
  }
}

// two neighbouring outputs of a row in y's type, paired where aligned
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

// RS: A built in registers (else SS, a bf16 x as it lies); TMA_Y: y by TMA
// stores of a staged tile (map_y), else from the registers
template <typename TX, int BNK, bool RS, bool TMA_Y>
__global__ void __launch_bounds__(THREADS, 1)
mm_stats_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_y, const Args a) {
  using L = Layout<TX, BNK>;
  constexpr int NA = BNK / 2;
  L& sm = smem<L>();
  init_barriers(sm.g, 1);
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce(sm.g, a.tiles, a.ktiles,
              [&](int s, uint64_t* full, int mt, int ct, int kt) {
                const int prow = a.pk ? min(BK, a.k - kt * BK) : 0;
                mbar_expect_tx(full, L::A_TILE + BK * BNK * 2 + prow * 16);
#pragma unroll
                for (int j = 0; j < L::A_TILE / (BM * PANEL_ROW); ++j)
                  tma_load_2d(sm.g.a[s] + j * BM * PANEL_ROW, &map_x, full,
                              kt * BK + j * (PANEL_ROW / (int)sizeof(TX)),
                              mt * BM);
#pragma unroll
                for (int j = 0; j < BNK / 64; ++j)
                  tma_load_2d(sm.g.b[s] + j * B_PANEL, &map_w, full,
                              ct * BNK + 64 * j, kt * BK);
                if (prow > 0)
                  bulk_load(sm.g.a[s] + L::A_TILE, a.pk + kt * BK, prow * 16,
                            full);
              });
    return;
  }
  regs_inc<consumer_regs(PRODUCER_REGS)>();
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  auto epi = [&](float (&acc)[2][NA], int mt, int ct) {
    const long long prow = (long long)(2 * blockIdx.x + c) * a.n;
    column_stats<NA>(acc, sm.red[c], c, a.part_s + prow, a.part_s2 + prow,
                     ct * BNK, a.n);
    if constexpr (TMA_Y) {
      // a bf16 tile, or a float32 one of 64 columns, staged whole (at most
      // 32 KB); a float32 one of 128 columns in 64-row halves
      constexpr int HALVES = sizeof(TX) == 2 || BNK == 64 ? 1 : 2;
      constexpr int ROWS = BM / HALVES, PER = 128 / (int)sizeof(TX);
#pragma unroll
      for (int hp = 0; hp < HALVES; ++hp)
        store_staged(
            sm.out.v[c], c,
            [&](uint8_t* buf) {
              const uint32_t tile = smem_u32(buf);
#pragma unroll
              for (int i = 0; i < BNK / 8; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  if (HALVES == 2 && h != hp) continue;
#pragma unroll
                  for (int hi = 0; hi < 2; ++hi)
                    stage2<TX>(tile, ROWS,
                               64 * (h - hp) + 16 * warp + g + 8 * hi,
                               8 * i + 2 * t, acc[h][4 * i + 2 * hi],
                               acc[h][4 * i + 2 * hi + 1]);
                }
            },
            [&](uint8_t* buf) {
#pragma unroll
              for (int j = 0; j < BNK / PER; ++j)
                tma_store_2d(&map_y, buf + j * ROWS * PANEL_ROW,
                             ct * BNK + PER * j, mt * BM + ROWS * hp);
            });
      wait_stores_after_last(a.tiles, mt, ct);
    } else {
      TX* y = static_cast<TX*>(a.y);
      const bool pair = a.n % 2 == 0;     // paired stores stay aligned
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const long long row =
              (long long)mt * BM + 64 * h + 16 * warp + g + 8 * hi;
          if (row >= a.m) continue;
#pragma unroll
          for (int i = 0; i < BNK / 8; ++i) {
            const int col = ct * BNK + 8 * i + 2 * t;
            if (col >= a.n) continue;
            store_out(y + row * a.n + col, acc[h][4 * i + 2 * hi],
                      acc[h][4 * i + 2 * hi + 1], col + 1 < a.n, pair);
          }
        }
    }
  };
  if constexpr (RS) {
    const bool stats = a.pk != nullptr, relu = a.relu != 0;
    auto load_a = [&](uint32_t (&f)[4][4], int s, int h, int kt, int mt) {
      const uint8_t* as = sm.g.a[s];
      const float4* prm = reinterpret_cast<const float4*>(as + L::A_TILE);
      const int r0 = 64 * h + 16 * warp + g;       // row in the tile
      // rows left in x from this thread's first row of the half
      const long long rows_left = a.m - ((long long)mt * BM + r0);
      const int klim = a.k - kt * BK;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 16 * kk + 8 * j + 2 * t;    // the pair's first k
          float4 q0 = {}, q1 = {};
          if (stats) {
            q0 = prm[k];
            q1 = prm[k + 1];
          }
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float2 v = load_pair<TX>(as, r0 + 8 * hi, k, g);
            const float v0 = prologue(v.x, q0, stats, relu);
            const float v1 = prologue(v.y, q1, stats, relu);
            const bool ok = 8 * hi < rows_left;
            f[kk][2 * j + hi] = pack_bf16(ok && k < klim ? v0 : 0.f,
                                          ok && k + 1 < klim ? v1 : 0.f);
          }
        }
    };
    auto desc_b = [&](int s, int kk) {
      return desc_mn(sm.g.b[s], kk, B_PANEL);
    };
    consume_rs<NA, 1>(sm.g, c, a.tiles, a.ktiles, load_a, desc_b, epi);
  } else {
    consume<NA>(sm.g, c, a.tiles, a.ktiles, epi);
  }
}

constexpr int SC = 32;          // columns per stats block
constexpr int SG = 32;          // row groups per stats block

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

// a call's tiles (128 rows x bnk columns, the column tiles innermost: the
// blocks working at one time share x's rows) and grid; m_tiles 0 if the
// tiles overflow an int
struct Plan {
  int bnk;
  Tiles tiles;
  unsigned grid;
};

Plan plan(int m, int n) {
  Plan pl;
  pl.bnk = n <= 64 ? 64 : 128;
  long long m_tiles = (m + BM - 1) / BM;
  const long long n_tiles = (n + pl.bnk - 1) / pl.bnk;
  if (m_tiles * n_tiles > 0x7fffffffLL) m_tiles = 0;
  pl.tiles = {(int)m_tiles, (int)n_tiles, false};
  pl.grid = grid_for(m_tiles * n_tiles);
  return pl;
}

template <typename TX, int BNK, bool RS, bool TMA_Y>
int run(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
        const Args& a, unsigned grid, cudaStream_t st) {
  constexpr int bytes = smem_bytes<Layout<TX, BNK>>();
  auto kernel = mm_stats_kernel<TX, BNK, RS, TMA_Y>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, bytes, st>>>(mx, mw, my, a);
  return (int)cudaGetLastError();
}

// the kernel for x's type, the tile width, the A path and y's store
template <typename TX, int BNK>
int run_for(const CUtensorMap& mx, const CUtensorMap& mw,
            const CUtensorMap& my, const Args& a, bool tma_y, unsigned grid,
            cudaStream_t st) {
  const bool rs = sizeof(TX) == 4 || a.pk != nullptr || a.relu;
  if (rs)
    return tma_y ? run<TX, BNK, true, true>(mx, mw, my, a, grid, st)
                 : run<TX, BNK, true, false>(mx, mw, my, a, grid, st);
  if constexpr (sizeof(TX) == 2)
    return tma_y ? run<TX, BNK, false, true>(mx, mw, my, a, grid, st)
                 : run<TX, BNK, false, false>(mx, mw, my, a, grid, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int launch(const void* x, int kx, const __nv_bfloat16* wcopy,
           const float4* pk, void* y, float* part, float* out, int m, int k,
           int n, int relu, cudaStream_t st) {
  const Plan pl = plan(m, n);
  if (pl.tiles.m_tiles == 0) return (int)cudaErrorInvalidValue;
  constexpr bool F32 = sizeof(TX) == 4;
  // y's rows whole 16-byte chunks: TMA stores, staged in at most 32 KB
  const bool tma_y = (long long)n * sizeof(TX) % 16 == 0;
  const int y_rows = F32 && pl.bnk == 128 ? BM / 2 : BM;
  CUtensorMap mx, mw, my = {};
  const int n8 = (n + 7) / 8 * 8;
  int err = encode_2d(&mx, x, m, k, kx, BM, F32);
  if (err == 0) err = encode_2d(&mw, wcopy, k, n, n8, BK);
  if (err == 0 && tma_y) err = encode_2d(&my, y, m, n, n, y_rows, F32);
  if (err != 0) return err;
  const int rows = 2 * pl.grid;            // one a consumer warpgroup
  const cudaError_t e = cudaMemsetAsync(
      part, 0, sizeof(float) * 2 * rows * n, st);
  if (e != cudaSuccess) return (int)e;
  const Args a{y, part, part + (size_t)rows * n, pk, m, k, n, relu,
               pl.tiles, (k + BK - 1) / BK};
  err = pl.bnk == 64 ? run_for<TX, 64>(mx, mw, my, a, tma_y, pl.grid, st)
                     : run_for<TX, 128>(mx, mw, my, a, tma_y, pl.grid, st);
  if (err != 0) return err;
  stats_kernel<<<(n + SC - 1) / SC, dim3(SC, SG), 0, st>>>(
      part, part + (size_t)rows * n, out, out + n, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of the partials buffer the wrapper allocates (2 * rows * n floats):
// one a consumer warpgroup of the grid for m rows and n columns
long long paddle_tpu_torch_matmul_bn_stats_rows(int m, int n) {
  return 2 * (long long)plan(m, n).grid;
}

// y [m, n] (x's type) = act(norm(x [m, k])) @ w [k, n]; x float32 (x_bf16
// 0) or bfloat16 (1) in rows of kx >= k elements (whole 16-byte chunks,
// 16-byte aligned), w [k, n] float32 (w_bf16 0) or bfloat16 (1); pk: the
// statistics as k float32 (mu, inv, g, b) quadruples (16-byte aligned), or
// null for no normalize; wcopy: scratch of k * ceil8(n) bf16 (16-byte
// aligned); part: 2 * rows * n floats (rows from
// paddle_tpu_torch_matmul_bn_stats_rows); out: s then s2, 2 * n floats.
// Returns a cudaError_t (0 = launched), or sm90::TENSOR_MAP_ERROR + the
// CUresult of a tensor map.
int paddle_tpu_torch_matmul_bn_stats(const void* x, const void* w,
                                     const void* pk, void* y, void* wcopy,
                                     void* part, void* out, int m, int k,
                                     int kx, int n, int x_bf16, int w_bf16,
                                     int relu, void* stream) {
  const int size = x_bf16 ? 2 : 4;
  if (m <= 0 || k <= 0 || n <= 0 || kx < k || (long long)kx * size % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(wcopy) % 16 ||
      reinterpret_cast<uintptr_t>(pk) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wc = static_cast<__nv_bfloat16*>(wcopy);
  const int err = w_bf16 ? round_w<__nv_bfloat16>(w, wc, k, n, st)
                         : round_w<float>(w, wc, k, n, st);
  if (err != 0) return err;
  const float4* pq = static_cast<const float4*>(pk);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  return x_bf16 ? launch<__nv_bfloat16>(x, kx, wc, pq, y, pf, of, m, k, n,
                                        relu, st)
                : launch<float>(x, kx, wc, pq, y, pf, of, m, k, n, relu, st);
}

}  // extern "C"
