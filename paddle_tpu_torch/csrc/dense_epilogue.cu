// Dense layer with its epilogue (K5) for Hopper (sm_90a):
// y = act(x @ w + b).
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/dense_epilogue.py
// _mba_fwd_impl (:69, pallas_call :82, body _kernel :40).  For x [M, K],
// w [K, N] (each float32 or bf16; under AMP both bf16) and b [N] float32:
//
//   y[m, n] = act(sum_k bf16(x[m, k]) * bf16(w[k, n]) + b[n])   (f32 sums)
//
// with act one of none, relu, gelu (erf) and gelu (tanh), and y in x's type
// (:84, :90).  The operands are rounded to bfloat16 (round to nearest even)
// as the TPU kernel casts them and multiplied on the tensor cores with
// float32 accumulation, as the TPU's MXU does; the bias and the activation
// are applied to the float32 accumulators, and y is written once, rounded
// once where it is bf16.
//
// Design: the GEMM core of sm90_gemm.cuh (persistent blocks, a 4-stage TMA
// ring, a producer warpgroup and two consumer warpgroups that take 128 x
// 128 output tiles in turn, bf16 wgmma m64n128k16 into float32
// accumulators; one warpgroup's epilogue runs beside the other's
// products).
//  - A is x, K-major, through a 2-d tensor map in 128 x 64 boxes; B is w,
//    n contiguous, so MN-major (wgmma's transpose bit), in 64 x 64 boxes.
//    TMA fills the ragged M, N and K edges with zeros.
//  - a bf16 operand whose rows are whole 16-byte chunks (K, respectively
//    N, a multiple of 8, and a 16-byte aligned start) is read where it
//    lies.  A float32 operand (or a bf16 one of another shape) is first
//    rounded to bf16 into a copy whose rows are padded to a multiple of 8
//    (round_pad_kernel: ~2 bytes read and ~1 written per element in
//    float32, x: 75 MB of 261 at the main path's shape); the TPU casts
//    inside the kernel.
//  - the epilogue adds b and applies the activation (a template
//    parameter: one kernel each) to the float32 sums, stages the tile in
//    shared memory (bf16 whole, float32 in 64-row halves) and writes it
//    with TMA stores, which drop what lies past M and N and run while the
//    warpgroup goes on; y's rows must be whole 16-byte chunks for that,
//    and otherwise the epilogue stores from its registers.
//
// What bounds it on an H100: at the main path's shape, x [16384, 768] @
// w [768, 3072], 77.3 GFLOP of bf16 products at 989 TFLOP/s take 0.078 ms;
// in bf16 (AMP) x, w and y move 131 MB (0.039 ms), so the products bound
// it.  In float32 the 261 MB of x, w, b and y also take 0.078 ms: the two
// bounds meet, and the rounding pass adds its own pass over x and w.  On
// an H100 80GB HBM3 at 700 W a tile's products take ~5.3 us (shared
// memory's bandwidth, sm90_gemm.cuh), and the epilogue ~1.4 us without an
// activation but ~12 us with gelu's erf: the gelu form is bound by its
// epilogue, ~2.2 times the products' time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace sm90g;

constexpr int STAGES = 4;
struct Layout {
  Stages<STAGES> g;
  OutTiles out;
};

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

// dst[r][c] = bf16(src[r][c]) inside [rows, cols], 0 in the padding up to
// cols_p columns (a multiple of 8); each thread writes 8 consecutive
// columns (16 bytes).  vec: 16-byte loads of a float32 source
template <typename S>
__global__ void __launch_bounds__(256)
round_pad_kernel(const S* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                 int rows, int cols, int cols_p, bool vec) {
  const long long chunks = (long long)rows * (cols_p / 8);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / (cols_p / 8));
    const int c0 = (int)(i % (cols_p / 8)) * 8;
    float v[8];
    if (sizeof(S) == 4 && vec && c0 + 8 <= cols) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)r * cols + c0);
      const float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = c0 + k < cols ? ptt::ld(src + (size_t)r * cols + c0 + k)
                             : 0.f;
    }
    __align__(16) __nv_bfloat162 o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols_p + c0) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  switch (ACT) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_GELU:
      return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
    case ACT_GELU_TANH: {
      const float u = 0.7978845608028654f * fmaf(0.044715f * v, v * v, v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    default:
      return v;
  }
}

// y in the output's type: two consecutive values of a row
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1,
                                           bool two, bool pair_ok) {
  if (two && pair_ok) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (two) dst[1] = v1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float v0,
                                           float v1, bool two, bool pair_ok) {
  if (two && pair_ok) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (two) dst[1] = __float2bfloat16_rn(v1);
  }
}

// y [m, n] = act(x . w + bias) over tiles (m tile mt, column tile ct).
// TMA_Y: y's rows are whole 16-byte chunks, and each tile goes out by TMA
// stores from a staged copy (map_y); else from the registers.
template <typename TY, int ACT, bool TMA_Y>
__global__ void __launch_bounds__(THREADS, 1)
dense_act_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_y,
                 const float* __restrict__ bias, TY* __restrict__ y, int m,
                 int n, Tiles tl, int ktiles) {
  Layout& sm = smem<Layout>();
  const int c = setup<40>(sm.g, 1);
  if (c < 0) {
    if (threadIdx.x == 0)
      produce(sm.g, tl, ktiles,
              [&](int s, uint64_t* full, int mt, int ct, int kt) {
                mbar_expect_tx(full, A_BYTES + B_BYTES);
                tma_load_2d(sm.g.a[s], &map_x, full, kt * BK, mt * BM);
#pragma unroll
                for (int j = 0; j < BN / 64; ++j)
                  tma_load_2d(sm.g.b[s] + j * B_PANEL, &map_w, full,
                              ct * BN + 64 * j, kt * BK);
              });
    return;
  }
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool pair_ok = n % 2 == 0;       // paired stores stay aligned
  if constexpr (TMA_Y) {
    // a bf16 tile staged whole (32 KB), a float32 one in 64-row halves
    constexpr int HALVES = sizeof(TY) == 2 ? 1 : 2;
    constexpr int ROWS = BM / HALVES, PER = 128 / sizeof(TY);
    consume(sm.g, c, tl, ktiles, [&](float (&acc)[2][ACC], int mt, int ct) {
#pragma unroll
      for (int hp = 0; hp < HALVES; ++hp)
        store_staged(
            sm.out.v[c], c,
            [&](uint8_t* buf) {
              const uint32_t tile = smem_u32(buf);
#pragma unroll
              for (int i = 0; i < BN / 8; ++i) {
                const int cl = 8 * i + 2 * (lane % 4), col = ct * BN + cl;
                const float b0 = col < n ? bias[col] : 0.f;
                const float b1 = col + 1 < n ? bias[col + 1] : 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  if (HALVES == 2 && h != hp) continue;
#pragma unroll
                  for (int r = 0; r < 2; ++r)
                    stage2<TY>(tile, ROWS,
                               64 * (h - hp) + 16 * warp + lane / 4 + 8 * r,
                               cl, activate<ACT>(acc[h][4 * i + 2 * r] + b0),
                               activate<ACT>(acc[h][4 * i + 2 * r + 1] + b1));
                }
              }
            },
            [&](uint8_t* buf) {
#pragma unroll
              for (int j = 0; j < BN / PER; ++j)
                tma_store_2d(&map_y, buf + j * ROWS * 128, ct * BN + PER * j,
                             mt * BM + ROWS * hp);
            });
    });
    if (threadIdx.x % 128 == 0) bulk_wait();
    return;
  }
  consume(sm.g, c, tl, ktiles, [&](float (&acc)[2][ACC], int mt, int ct) {
    // column pair by column pair, each pair's 4 rows (h, r): a pair's
    // bias is loaded once and its accumulators free as they are stored
    const int col0 = ct * BN + 2 * (lane % 4);
    TY* yrow[2][2];
    bool row_ok[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mt * BM + 64 * h + 16 * warp + lane / 4 + 8 * r;
        row_ok[h][r] = row < m;
        yrow[h][r] = y + (size_t)row * n;
      }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = col0 + 8 * i;
      if (col >= n) continue;
      const bool two = col + 1 < n;
      const float b0 = bias[col], b1 = two ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row_ok[h][r])
            store_pair(yrow[h][r] + col,
                       activate<ACT>(acc[h][4 * i + 2 * r] + b0),
                       activate<ACT>(acc[h][4 * i + 2 * r + 1] + b1), two,
                       pair_ok);
    }
  });
}

long long round_up(long long v, long long to) { return (v + to - 1) / to * to; }

// whether the GEMM reads a bf16 operand of `cols` columns where it lies
bool direct(const void* p, int cols, int is_bf16) {
  return is_bf16 && cols % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_round_pad(const void* src, int is_bf16, __nv_bfloat16* dst,
                     int rows, int cols, int cols_p, cudaStream_t st) {
  const long long chunks = (long long)rows * (cols_p / 8);
  long long blocks = (chunks + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (is_bf16) {
    round_pad_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), dst, rows, cols, cols_p,
        false);
  } else {
    // 16-byte loads need 16-byte rows and a 16-byte aligned start
    const bool vec =
        cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    round_pad_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(src), dst, rows, cols, cols_p, vec);
  }
  return (int)cudaGetLastError();
}

// x: bf16 [m, k] with rows of ldx elements; w: bf16 [k, n], rows of ldw
template <typename TY, int ACT, bool TMA_Y>
int launch_gemm(const __nv_bfloat16* x, int ldx, const __nv_bfloat16* w,
                int ldw, const float* b, void* y, int m, int k, int n,
                cudaStream_t st) {
  CUtensorMap mx, mw, my = {};
  int err = encode_2d(&mx, x, m, k, ldx, BM);
  if (err == 0) err = encode_2d(&mw, w, k, n, ldw, BK);
  if (err == 0 && TMA_Y)
    err = encode_2d(&my, y, m, n, n, sizeof(TY) == 2 ? BM : BM / 2,
                    sizeof(TY) == 4);
  if (err != 0) return err;
  const long long m_tiles = (m + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the column tiles innermost: the blocks working at one time share x's
  // rows (x is read from device memory once) and w stays in L2
  const Tiles tl{(int)m_tiles, (int)n_tiles, false};
  constexpr int smem_size = smem_bytes<Layout>();
  cudaError_t e = cudaFuncSetAttribute(
      dense_act_kernel<TY, ACT, TMA_Y>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_size);
  if (e != cudaSuccess) return (int)e;
  dense_act_kernel<TY, ACT, TMA_Y><<<grid_for(tl.count()), THREADS,
                                     smem_size, st>>>(
      mx, mw, my, b, static_cast<TY*>(y), m, n, tl, (k + BK - 1) / BK);
  return (int)cudaGetLastError();
}

// y by TMA stores where its rows are whole 16-byte chunks
template <typename TY, int ACT>
int launch_store(const __nv_bfloat16* x, int ldx, const __nv_bfloat16* w,
                 int ldw, const float* b, void* y, int m, int k, int n,
                 cudaStream_t st) {
  if (n * sizeof(TY) % 16 == 0)
    return launch_gemm<TY, ACT, true>(x, ldx, w, ldw, b, y, m, k, n, st);
  return launch_gemm<TY, ACT, false>(x, ldx, w, ldw, b, y, m, k, n, st);
}

// one kernel an activation (its code alone in the epilogue)
template <typename TY>
int launch_act(const __nv_bfloat16* x, int ldx, const __nv_bfloat16* w,
               int ldw, const float* b, void* y, int m, int k, int n,
               int act, cudaStream_t st) {
  switch (act) {
    case ACT_RELU:
      return launch_store<TY, ACT_RELU>(x, ldx, w, ldw, b, y, m, k, n, st);
    case ACT_GELU:
      return launch_store<TY, ACT_GELU>(x, ldx, w, ldw, b, y, m, k, n, st);
    case ACT_GELU_TANH:
      return launch_store<TY, ACT_GELU_TANH>(x, ldx, w, ldw, b, y, m, k, n,
                                             st);
    default:
      return launch_store<TY, ACT_NONE>(x, ldx, w, ldw, b, y, m, k, n, st);
  }
}

}  // namespace

extern "C" {

// bf16 elements of scratch the wrapper allocates: the rounded copies of the
// operands the GEMM cannot read where they lie (x, then w)
long long paddle_tpu_torch_dense_act_scratch(const void* x, const void* w,
                                             int m, int k, int n, int x_bf16,
                                             int w_bf16) {
  long long elems = 0;
  if (!direct(x, k, x_bf16)) elems += (long long)m * round_up(k, 8);
  if (!direct(w, n, w_bf16)) elems += (long long)k * round_up(n, 8);
  return elems;
}

// y [m, n] = act(x [m, k] @ w [k, n] + b [n]); x and w float32 or bf16
// (x_bf16, w_bf16), b float32, y in x's type; scratch: the bf16 elements
// paddle_tpu_torch_dense_act_scratch names (16-byte aligned); act: 0 none,
// 1 relu, 2 gelu (erf), 3 gelu (tanh).  Returns a cudaError_t (0 =
// launched), or sm90::TENSOR_MAP_ERROR + the CUresult of a tensor map.
int paddle_tpu_torch_dense_act(const void* x, const void* w, const void* b,
                               void* y, void* scratch, int m, int k, int n,
                               int act, int x_bf16, int w_bf16,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const long long kp = round_up(k, 8), np = round_up(n, 8);
  if (kp > 0x7fffffffLL || np > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* free_at = static_cast<__nv_bfloat16*>(scratch);
  const __nv_bfloat16* xa = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(w);
  int ldx = k, ldw = n;
  if (!direct(x, k, x_bf16)) {
    const int err = launch_round_pad(x, x_bf16, free_at, m, k, (int)kp, st);
    if (err != 0) return err;
    xa = free_at, ldx = (int)kp;
    free_at += (long long)m * kp;
  }
  if (!direct(w, n, w_bf16)) {
    const int err = launch_round_pad(w, w_bf16, free_at, k, n, (int)np, st);
    if (err != 0) return err;
    wa = free_at, ldw = (int)np;
  }
  const float* bf = static_cast<const float*>(b);
  return x_bf16 ? launch_act<__nv_bfloat16>(xa, ldx, wa, ldw, bf, y, m, k, n,
                                            act, st)
                : launch_act<float>(xa, ldx, wa, ldw, bf, y, m, k, n, act,
                                    st);
}

}  // extern "C"
