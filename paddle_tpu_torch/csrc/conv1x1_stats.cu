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
// from the float32 sums (:128-140).  Both forms run on the GEMM core of
// sm90_gemm.cuh (persistent blocks, a producer warpgroup filling a ring of
// shared-memory stages, two consumer warpgroups taking tiles in turn with
// bf16 wgmma into float32 accumulators); each consumer warpgroup adds its
// tiles' statistics into its own row of a partials buffer [2 x blocks,
// Cout] in a fixed order, and a second kernel sums the rows per channel in
// a fixed order: deterministic, no atomics.
//
// The bf16 form (AMP: bf16 x and y, the float32 master w or a bf16 w):
//  - rows are output channels: A is w, rounded once a call into a bf16
//    copy [Cout, Cin rounded up to 8] and read K-major by TMA.  Columns are
//    pixels: B is x, n contiguous, so MN-major.  A column tile holds whole
//    images where an image (its pixels rounded up to 64 for TMA, to 8
//    otherwise) fits in 128 columns, two images at P = 49; else 128 pixels
//    of one image (P = 3136, 784: 25 and 7 tiles an image; P = 196: 2).
//    The TPU takes one whole P row per block, because no 128-multiple
//    divides 3136, 784, 196 or 49.
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
//    pixels from the float32 accumulators.
//
// The float32 form (float32 x and y): wgmma takes no float32 operand but
// as tf32, which is not the TPU kernel's arithmetic, and takes a shared-
// memory operand MN-major only in 16-bit types; so x reaches the tensor
// cores through registers:
//  - rows are pixels: A is x, loaded by the producer in float32 as it lies
//    and read by each consumer thread from the stage into the registers of
//    its A fragments, rounded to bf16 there (sm90_gemm.cuh consume_rs).
//    Columns are output channels: B is the bf16 copy of w, read K-major.
//    Tiles are 128 pixels x 128 channels, the channel tiles innermost (the
//    blocks working at one time share x's tile in L2).
//  - TMA route, where an image row is whole 16-byte chunks in float32
//    (P % 4 == 0: P = 3136, 784, 196, 30 of a ResNet-50 step's 36
//    launches): a tile is 128 pixels of one image, loaded from a 3-d map
//    [N][Cin][P] in boxes of 32 pixels x 64 channels (128-byte swizzle;
//    pixels past P and channels past Cin arrive as zeros, which add exact
//    zeros to the products and the statistics).  A thread's fragment
//    reads (rows 16w + l/4 (+8), channels 2(l%4) (+1, +8, +9)) fall on 32
//    distinct banks under the swizzle.  y [N][Cout][P] goes out by TMA
//    stores from a tile staged transposed (channel rows, 64 pixels a half)
//    in the boxes' layout.
//  - slab route, P <= 64 (P = 49, 6 launches): a tile holds two images,
//    one a 64-row half; the producer copies each image's slab of the
//    stage's channels ([64, P], contiguous) with one cp.async.bulk, and the
//    consumers read their fragments from the slab where it landed.  Row r
//    of a half is pixel 32(w/2) + 4(w%2) + 8(g/2) + g%2 + 2(r%16 >= 8) (w
//    the warp, g = l/4): at P = 49 a warp's 32 reads then fall on 32
//    distinct banks.  Rows past P or the last image, and channels past the
//    slab, are zeroed in the registers.  y goes out from the same tile
//    staged as [channels][P], one cp.async.bulk store an image (its
//    channels' rows are contiguous in y).
//  - another x is first copied with zero padding by the wrapper (a row
//    P > 64 with P % 4 != 0: pixels padded to 4; Cin * P % 4 != 0 at
//    P <= 64: channels padded to 4; an unaligned base), and y whose rows
//    no store above can take goes out from the registers.
//  - the products sum each k16 step of bf16 products into one float32
//    accumulator, in order, as the mma.sync form before it did: y is the
//    same bits.
//
// A strided input (the stride-2 shortcut) arrives as a contiguous copy
// made by the caller.
//
// What bounds it on an H100: at ResNet-50's shapes every call moves more
// bytes (x and y) than its products need time at the tensor-core rate, so
// memory bounds the function except for the late-stage shapes with large
// Cin and Cout at P = 49 ((1024, 2048, 49) by operations); a float32 step's
// 36 launches at batch 128 have a bound of 2.535 ms, an AMP step's at batch
// 256 of 2.605 ms.  On an H100 80GB HBM3 at 700 W the bf16 form takes ~8.3
// ms an AMP step: at the TMA shapes a tile's one to four k steps are short
// beside its epilogue (2.5-3 us a tile), and at P = 196 and 49 the three
// laying-out warps bound the stage rate (~1.5-2 us a stage of 64 channels)
// and y's register stores its epilogue (~12 us a tile).  The float32
// form takes ~4.4 ms a step at batch 128 (58% of its bound); its consumer
// builds A from 32 KB of shared memory a stage (64 loads a thread) beside
// the products, which take turns between the warpgroups.  Its shapes
// reach 61-82% of their bounds at P = 3136 and 784, 30-47% at P = 196 and
// 22-30% at P = 49, whose pixel tiles' x is read from L2 again for each
// of up to 16 channel tiles, over up to 32 k steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sm90_gemm.cuh"

namespace {

// --- shared by both forms ----------------------------------------------------

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

// rounds w [cout, cin] into wcopy [cout, ceil8(cin)] and makes its map
// (boxes of 64 k x 128 rows); returns a cudaError_t or TENSOR_MAP_ERROR +
// the CUresult
template <typename TW>
int round_w_map(const void* w, __nv_bfloat16* wcopy, CUtensorMap* map,
                int cout, int cin, cudaStream_t st) {
  const int err = sm90g::round_w<TW>(w, wcopy, cout, cin, st);
  if (err != 0) return err;
  return sm90g::encode_2d(map, wcopy, cout, cin, (cin + 7) / 8 * 8,
                          sm90g::BM);
}

// --- the float32 form: float32 x and y, A built in registers -----------------

namespace f32k {

using namespace sm90g;

// the float32 form's register split: the slab route's producer spills
// below 40 registers (ptxas), and the consumers fit in 232
constexpr int PRODUCER_REGS = 40;
constexpr int STAGES = 3;
constexpr int A_TILE = BM * BK * 4;       // 128 pixels x 64 channels: 32 KB
constexpr int SLAB_MAX_P = 64;            // the widest image of the slab route
constexpr int SLAB_BYTES = BK * SLAB_MAX_P * 4;   // an image's slab: 16 KB
static_assert(2 * SLAB_BYTES == A_TILE, "two slabs fill an A stage");

struct Layout {
  Stages<STAGES, BM, A_TILE> g;   // B: w's copy, 128 channels x 64 k
  OutTiles out;                   // y's tiles, staged for the stores
  float red[2][4][2][BN];         // column_stats, a consumer warpgroup each
};

// how y goes out: from the registers, by TMA stores of a staged tile
// (rows of whole 16-byte chunks), or one bulk store an image (slab route)
enum { Y_REGS = 0, Y_TMA = 1, Y_BULK = 2 };

struct Args {
  const float* x;            // [n, cx, px]: cx >= cin channels, px >= p
  float* y;                  // [n, cout, p]
  float* part_s;             // [2 gridDim.x, cout], zeroed (then part_s2)
  float* part_s2;
  int n, cx, cout, p, px;
  int per_img;               // TMA route: pixel tiles an image; slab: 0
  Tiles tiles;               // pixel tiles x channel tiles (innermost)
  int ktiles;
};

// the pixel of row r = 16 w + g (+ 8 hi) of a slab route half
__device__ __forceinline__ int slab_pixel(int w, int g, int hi) {
  return 32 * (w / 2) + 4 * (w % 2) + 8 * (g / 2) + g % 2 + 2 * hi;
}

__device__ __forceinline__ float lds_f32(uint32_t at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(at) : "memory");
  return v;
}

// SLAB: the route (else TMA); YS: how y goes out
template <bool SLAB, int YS>
__global__ void __launch_bounds__(THREADS, 1)
conv_f32_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_y, const Args a) {
  Layout& sm = smem<Layout>();
  init_barriers(sm.g, 1);
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce(sm.g, a.tiles, a.ktiles,
              [&](int s, uint64_t* full, int mt, int ct, int kt) {
                if constexpr (SLAB) {
                  const int img0 = 2 * mt, imgs = min(2, a.n - img0);
                  const int rows = min(BK, a.cx - kt * BK);
                  const uint32_t bytes = (uint32_t)rows * a.px * 4;
                  mbar_expect_tx(full, B_BYTES + imgs * bytes);
                  tma_load_2d(sm.g.b[s], &map_w, full, kt * BK, ct * BN);
                  for (int il = 0; il < imgs; ++il)
                    bulk_load(sm.g.a[s] + il * SLAB_BYTES,
                              a.x + ((long long)(img0 + il) * a.cx +
                                     kt * BK) * a.px,
                              bytes, full);
                } else {
                  const int img = mt / a.per_img;
                  const int p0 = (mt % a.per_img) * BM;
                  mbar_expect_tx(full, A_TILE + B_BYTES);
                  tma_load_2d(sm.g.b[s], &map_w, full, kt * BK, ct * BN);
#pragma unroll
                  for (int j = 0; j < BM / 32; ++j)
                    tma_load_3d(sm.g.a[s] + j * BK * PANEL_ROW, &map_x, full,
                                p0 + 32 * j, kt * BK, img);
                }
              });
    return;
  }
  regs_inc<consumer_regs(PRODUCER_REGS)>();
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the row in a half of this thread's fragment rows g + 8 hi: its pixel
  // (slab route), or its row in the half's 64 (TMA route)
  auto pix = [&](int hi) {
    return SLAB ? slab_pixel(warp, g, hi) : 16 * warp + g + 8 * hi;
  };
  // the byte offset in a stage's first half of this thread's A value of
  // row set hi, channel 2t + e (then + 16 kk + 8 j): the slab's
  // [channel][P], or the boxes' 64-channel rows of 32 pixels (the
  // swizzle's chunk is the pixel's, xor the channel's row % 8 = 2t + e)
  auto off = [&](int hi, int e) -> uint32_t {
    const int k = 2 * t + e;
    if constexpr (SLAB) return (uint32_t)(k * a.px + pix(hi)) * 4;
    const int q = 16 * (warp % 2) + g + 8 * hi;      // pixel in the panel
    return (warp / 2) * BK * PANEL_ROW + k * PANEL_ROW +
           (((q / 4) ^ k) * 16) + (q % 4) * 4;
  };
  const uint32_t kstep = SLAB ? 8 * a.px * 4 : 8 * PANEL_ROW;   // 8 channels
  auto load_a = [&](uint32_t (&f)[4][4], int s, int h, int kt, int mt) {
    const uint32_t as = smem_u32(sm.g.a[s]) +
                        h * (SLAB ? SLAB_BYTES : 2 * BK * PANEL_ROW);
    const bool img_ok = !SLAB || 2 * mt + h < a.n;
    const int krows = SLAB ? min(BK, a.cx - kt * BK) : BK;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool ok = img_ok && (!SLAB || pix(hi) < a.p);
      const uint32_t at0 = as + off(hi, 0), at1 = as + off(hi, 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t step = (2 * kk + j) * kstep;
          float v0 = lds_f32(at0 + step);
          float v1 = lds_f32(at1 + step);
          if constexpr (SLAB) {
            const int k = 16 * kk + 8 * j + 2 * t;
            v0 = ok && k < krows ? v0 : 0.f;
            v1 = ok && k + 1 < krows ? v1 : 0.f;
          }
          f[kk][2 * j + hi] = pack_bf16(v0, v1);
        }
    }
  };
  auto desc_b = [&](int s, int kk) { return desc_k(sm.g.b[s], kk); };
  consume_rs<ACC, 0>(
      sm.g, c, a.tiles, a.ktiles, load_a, desc_b,
      [&](float (&acc)[2][ACC], int mt, int ct) {
        const long long prow = (long long)(2 * blockIdx.x + c) * a.cout;
        column_stats<ACC>(acc, sm.red[c], c, a.part_s + prow,
                          a.part_s2 + prow, ct * BN, a.cout);
        // the tile's images and first pixel
        const int img0 = SLAB ? 2 * mt : mt / a.per_img;
        const int p0 = SLAB ? 0 : (mt % a.per_img) * BM;
        if constexpr (YS == Y_REGS) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int img = SLAB ? img0 + h : img0;
              const int px = SLAB ? pix(hi) : p0 + 64 * h + pix(hi);
              if (img >= a.n || px >= a.p) continue;
              float* yr = a.y + (long long)img * a.cout * a.p + px;
#pragma unroll
              for (int i = 0; i < BN / 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int ch = ct * BN + 8 * i + 2 * t + e;
                  if (ch < a.cout)
                    yr[(long long)ch * a.p] = acc[h][4 * i + 2 * hi + e];
                }
            }
        } else if constexpr (YS == Y_TMA) {
          // a half's 64 pixels x 128 channels, staged as channel rows
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (p0 + 64 * h >= a.p) continue;
            store_staged(
                sm.out.v[c], c,
                [&](uint8_t* buf) {
                  const uint32_t tile = smem_u32(buf);
#pragma unroll
                  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
                    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
                      for (int e = 0; e < 2; ++e)
                        stage1f(tile, BN, 8 * i + 2 * t + e, pix(hi),
                                acc[h][4 * i + 2 * hi + e]);
                },
                [&](uint8_t* buf) {
#pragma unroll
                  for (int j = 0; j < 2; ++j)
                    tma_store_3d(&map_y, buf + j * BN * PANEL_ROW,
                                 p0 + 64 * h + 32 * j, ct * BN, img0);
                });
          }
        } else {
          // an image's [channels][P] block of y is contiguous
          const int nch = min(BN, a.cout - ct * BN);
          const uint32_t row8 = 8 * a.p * 4;        // 8 channels of it
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (img0 + h >= a.n) continue;
            store_staged(
                sm.out.v[c], c,
                [&](uint8_t* buf) {
#pragma unroll
                  for (int hi = 0; hi < 2; ++hi) {
                    if (pix(hi) >= a.p) continue;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      uint32_t at = smem_u32(buf) +
                                    ((2 * t + e) * a.p + pix(hi)) * 4;
#pragma unroll
                      for (int i = 0; i < BN / 8; ++i, at += row8)
                        asm volatile("st.shared.f32 [%0], %1;\n"
                                     :: "r"(at),
                                        "f"(acc[h][4 * i + 2 * hi + e])
                                     : "memory");
                    }
                  }
                },
                [&](uint8_t* buf) {
                  bulk_store(a.y + ((long long)(img0 + h) * a.cout +
                                    ct * BN) * a.p,
                             buf, (uint32_t)(nch * a.p * 4));
                });
          }
        }
        if constexpr (YS != Y_REGS) wait_stores_after_last(a.tiles, mt, ct);
      });
}

// how a call runs: its route, tiles and grid; m_tiles 0 if the tiles
// overflow an int
struct Plan {
  bool slab;
  int per_img;
  Tiles tiles;
  unsigned grid;
};

Plan plan(int n, int cout, int p, bool slab) {
  Plan pl;
  pl.slab = slab;
  pl.per_img = pl.slab ? 0 : (p + BM - 1) / BM;
  long long m_tiles = pl.slab ? (n + 1) / 2 : (long long)n * pl.per_img;
  const long long n_tiles = (cout + BN - 1) / BN;
  if (m_tiles * n_tiles > 0x7fffffffLL) m_tiles = 0;
  pl.tiles = {(int)m_tiles, (int)n_tiles, false};
  pl.grid = grid_for(m_tiles * n_tiles);
  return pl;
}

template <bool SLAB, int YS>
int run(const CUtensorMap& mw, const CUtensorMap& mx, const CUtensorMap& my,
        const Args& a, unsigned grid, cudaStream_t st) {
  constexpr int bytes = smem_bytes<Layout>();
  const cudaError_t e = cudaFuncSetAttribute(
      conv_f32_kernel<SLAB, YS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  conv_f32_kernel<SLAB, YS><<<grid, THREADS, bytes, st>>>(mw, mx, my, a);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch(const void* x, const void* w, void* y, __nv_bfloat16* wcopy,
           float* part, float* stats, int n, int cin, int cx, int cout,
           int p, int px, bool slab, cudaStream_t st) {
  CUtensorMap mw, mx = {}, my = {};
  int err = round_w_map<TW>(w, wcopy, &mw, cout, cin, st);
  if (err != 0) return err;
  const Plan pl = plan(n, cout, p, slab);
  if (pl.tiles.m_tiles == 0) return (int)cudaErrorInvalidValue;
  const int rows = 2 * pl.grid;          // one a consumer warpgroup
  const cudaError_t e = cudaMemsetAsync(
      part, 0, sizeof(float) * 2 * rows * cout, st);
  if (e != cudaSuccess) return (int)e;
  const Args a{static_cast<const float*>(x), static_cast<float*>(y), part,
               part + (size_t)rows * cout, n, cx, cout, p, px, pl.per_img,
               pl.tiles, (cin + BK - 1) / BK};
  if (pl.slab) {
    err = (long long)cout * p % 4 == 0
              ? run<true, Y_BULK>(mw, mx, my, a, pl.grid, st)
              : run<true, Y_REGS>(mw, mx, my, a, pl.grid, st);
  } else {
    const bool tma_y = p % 4 == 0;
    err = encode_3d_f32(&mx, x, px, cx, n, BK);
    if (err == 0 && tma_y) err = encode_3d_f32(&my, y, p, cout, n, BN);
    if (err != 0) return err;
    err = tma_y ? run<false, Y_TMA>(mw, mx, my, a, pl.grid, st)
                : run<false, Y_REGS>(mw, mx, my, a, pl.grid, st);
  }
  if (err != 0) return err;
  return launch_stats(part, stats, rows, cout, st);
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
  CUtensorMap mw;
  int err = round_w_map<TW>(w, wcopy, &mw, cout, cin, st);
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
  return launch_stats(part, stats, rows, cout, st);
}

}  // namespace bf16k

}  // namespace

extern "C" {

// the rows of the float32 form's partials (one a consumer warpgroup of its
// grid) for n images of p pixels and cout output channels, read by the
// slab route (slab = 1) or by TMA (0)
long long paddle_tpu_torch_conv1x1_stats_rows(int n, int p, int cout,
                                              int slab) {
  return 2 * (long long)f32k::plan(n, cout, p, slab != 0).grid;
}

// The float32 form: x [n, cx, px] float32 (cx >= cin channels, those past
// cin zero; px >= p pixels, those past p zero; 16-byte aligned), read by
// the route the caller names: TMA (slab = 0; px a multiple of 4) or slabs
// (slab = 1; px = p <= 64, cx * px a multiple of 4); w [cout, cin]
// float32 (w_bf16 = 0) or bf16 (1), y [n, cout, p] float32; wcopy:
// scratch of cout * ceil8(cin) bf16 (16-byte aligned); part: 2 * rows * cout floats (rows from
// paddle_tpu_torch_conv1x1_stats_rows); stats: s then s2.  Returns a
// cudaError_t (0 = launched), or sm90::TENSOR_MAP_ERROR + the CUresult of
// a tensor map.
int paddle_tpu_torch_conv1x1_stats(const void* x, const void* w, void* y,
                                   void* wcopy, void* part, void* stats,
                                   int n, int cin, int cx, int cout, int p,
                                   int px, int slab, int w_bf16,
                                   void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || p <= 0 || cx < cin || px < p ||
      (slab ? px != p || px > f32k::SLAB_MAX_P || (long long)cx * px % 4
            : px % 4) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(wcopy) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wc = static_cast<__nv_bfloat16*>(wcopy);
  float* ps = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  return w_bf16 ? f32k::launch<__nv_bfloat16>(x, w, y, wc, ps, sf, n, cin,
                                              cx, cout, p, px, slab != 0, st)
                : f32k::launch<float>(x, w, y, wc, ps, sf, n, cin, cx, cout,
                                      p, px, slab != 0, st);
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
