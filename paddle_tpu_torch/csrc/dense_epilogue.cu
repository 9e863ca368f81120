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
// as the TPU kernel casts them, multiplied on the tensor cores with float32
// accumulation (mma.sync m16n8k16, bf16 in, f32 out), as the TPU's MXU does;
// the bias and the activation are applied to the float32 accumulators, and
// y is written once, rounded once where it is bf16.
//
// Design:
//  - a bf16 operand whose rows are whole 16-byte chunks (K, respectively
//    N, a multiple of 8, and a 16-byte aligned start) is read by the GEMM
//    where it lies: the tile loads zero-fill the rows and chunks past the
//    operand's edge (cp.async with a source size of 0).  A float32 operand
//    (or a bf16 one of another shape) is first rounded to bf16 into a
//    zero-padded copy whose sides are multiples of the GEMM's tiles (M and
//    N of 128, K of 32), which costs ~2 bytes read and ~1 written per
//    element in float32 (x: 75 MB of 261 at the main path's shape); the TPU
//    casts inside the kernel.  Only the epilogue masks the ragged M and N.
//  - the GEMM: one block of 8 warps per 128 x 128 output tile; the K loop
//    runs over 32-deep stages, 4 of them in shared memory filled by
//    cp.async (16-byte copies, three stages in flight while one is
//    multiplied).  x's tile is stored [128][32] (k contiguous, as ldmatrix
//    wants A), w's tile [32][128] as it lies in memory (n contiguous), so B's
//    fragments come from ldmatrix.trans; rows are padded by 8 elements to
//    keep ldmatrix free of bank conflicts.  Each warp owns a 32 x 64 tile:
//    2 x 8 mma tiles with their float32 accumulators in registers.
//  - the epilogue adds b and applies the activation on the accumulator
//    fragments and writes y (two consecutive values a thread and row).
//
// What bounds it on an H100: at the main path's shape, x [16384, 768] @
// w [768, 3072], 77.3 GFLOP of bf16 products at 989 TFLOP/s take 0.078 ms,
// the 261 MB of x, w, b and y in float32 at 3.35 TB/s also 0.078 ms: the
// two bounds meet.  In bf16 (AMP) the operands and y move 131 MB (0.039
// ms), so the products bound it.  mma.sync reaches about two thirds of the
// tensor cores' rate on Hopper (wgmma the rest), so this version cannot
// reach the bound; a TMA + wgmma kernel is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 128;         // output columns per block
constexpr int BK = 32;          // depth per stage
constexpr int STAGES = 4;
constexpr int AP = BK + 8;      // padded row of the A tile (k contiguous)
constexpr int BP = BN + 8;      // padded row of the B tile (n contiguous)
constexpr int THREADS = 256;    // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;          // rows per warp
constexpr int WN = 64;          // columns per warp
constexpr int A_STAGE = BM * AP;        // bf16 elements of one A stage
constexpr int B_STAGE = BK * BP;        // bf16 elements of one B stage
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2;   // bytes

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

// dst[r][c] = bf16(src[r][c]) inside [rows, cols], 0 in the padding up to
// [rows_p, cols_p]; each thread writes 8 consecutive columns (16 bytes).
// vec: 16-byte loads of a float32 source
template <typename S>
__global__ void __launch_bounds__(256)
round_pad_kernel(const S* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                 int rows, int cols, int rows_p, int cols_p, bool vec) {
  const long long chunks = (long long)rows_p * (cols_p / 8);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / (cols_p / 8));
    const int c0 = (int)(i % (cols_p / 8)) * 8;
    float v[8];
    if (sizeof(S) == 4 && r < rows && vec && c0 + 8 <= cols) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)r * cols + c0);
      const float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (r < rows && c0 + k < cols)
                   ? ptt::ld(src + (size_t)r * cols + c0 + k)
                   : 0.f;
    }
    __align__(16) __nv_bfloat162 o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols_p + c0) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// 16 bytes from gmem into smem, or 16 zero bytes when !in (the source is
// then not read: its size is 0)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
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

// An operand as the GEMM reads it: bf16 rows of `ld` elements, of which
// `rows` x `cols` hold values (the tile loads zero-fill the rest); `cols`
// is a multiple of 8
struct Operand {
  const __nv_bfloat16* p;
  int ld, rows, cols;
};

// y [M, N] = act(x . w + bias); ktiles = ceil(K / BK)
template <typename TY>
__global__ void __launch_bounds__(THREADS)
dense_act_kernel(Operand xa, Operand wa, const float* __restrict__ bias,
                 TY* __restrict__ y, int m, int n, int ktiles, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto as = reinterpret_cast<__nv_bfloat16(*)[BM][AP]>(smem);   // [S][BM][AP]
  auto bs = reinterpret_cast<__nv_bfloat16(*)[BK][BP]>(
      smem + STAGES * A_STAGE * 2);                             // [S][BK][BP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // one stage: A 128 rows x 4 chunks, B 32 rows x 16 chunks of 16 bytes;
  // two chunks of each a thread
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx >> 2, ch = idx & 3;
      const int gr = m0 + row, gc = k0 + ch * 8;
      const bool in = gr < xa.rows && gc < xa.cols;
      cp_async16(&as[stage][row][ch * 8],
                 in ? xa.p + (size_t)gr * xa.ld + gc : xa.p, in);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx >> 4, ch = idx & 15;
      const int gr = k0 + row, gc = n0 + ch * 8;
      const bool in = gr < wa.rows && gc < wa.cols;
      cp_async16(&bs[stage][row][ch * 8],
                 in ? wa.p + (size_t)gr * wa.ld + gc : wa.p, in);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage every warp finished multiplying at kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next * BK);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &as[st][warp_m * WM + i * 16 + (lane & 15)]
                             [kb + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // matrices: k 0-7 and 8-15 of n-tile j, then of n-tile j + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, &bs[st][kb + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                [warp_n * WN + j * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: this thread holds rows (g, g + 8) of each 16-row tile i and
  // columns (2t, 2t + 1) of each 8-column tile j of its warp's 32 x 64
  const bool pair_ok = n % 2 == 0;       // paired stores stay aligned
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + warp_n * WN + j * 8 + 2 * t;
    if (col >= n) continue;
    const bool two = col + 1 < n;
    const float b0 = bias[col], b1 = two ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp_m * WM + i * 16 + h * 8 + g;
        if (row >= m) continue;
        store_pair(y + (size_t)row * n + col,
                   activate(acc[i][j][h * 2] + b0, act),
                   activate(acc[i][j][h * 2 + 1] + b1, act), two, pair_ok);
      }
  }
}

long long round_up(long long v, long long to) { return (v + to - 1) / to * to; }

// whether the GEMM reads a bf16 operand of `cols` columns where it lies
bool direct(const void* p, int cols, int is_bf16) {
  return is_bf16 && cols % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_round_pad(const void* src, int is_bf16, __nv_bfloat16* dst,
                     int rows, int cols, int rows_p, int cols_p,
                     cudaStream_t st) {
  const long long chunks = (long long)rows_p * (cols_p / 8);
  long long blocks = (chunks + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (is_bf16) {
    round_pad_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), dst, rows, cols, rows_p,
        cols_p, false);
  } else {
    // 16-byte loads need 16-byte rows and a 16-byte aligned start
    const bool vec =
        cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    round_pad_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(src), dst, rows, cols, rows_p, cols_p,
        vec);
  }
  return (int)cudaGetLastError();
}

template <typename TY>
int launch_gemm(Operand xa, Operand wa, const float* b, void* y, int m,
                int n, int ktiles, int act, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      dense_act_kernel<TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  dense_act_kernel<TY><<<dim3((unsigned)((n + BN - 1) / BN),
                              (unsigned)((m + BM - 1) / BM)),
                         THREADS, SMEM, st>>>(xa, wa, b, static_cast<TY*>(y),
                                              m, n, ktiles, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 elements of scratch the wrapper allocates: the padded copies of the
// operands the GEMM cannot read where they lie (x, then w)
long long paddle_tpu_torch_dense_act_scratch(const void* x, const void* w,
                                             int m, int k, int n, int x_bf16,
                                             int w_bf16) {
  long long elems = 0;
  if (!direct(x, k, x_bf16)) elems += round_up(m, BM) * round_up(k, BK);
  if (!direct(w, n, w_bf16)) elems += round_up(k, BK) * round_up(n, BN);
  return elems;
}

// y [m, n] = act(x [m, k] @ w [k, n] + b [n]); x and w float32 or bf16
// (x_bf16, w_bf16), b float32, y in x's type; scratch: the bf16 elements
// paddle_tpu_torch_dense_act_scratch names; act: 0 none, 1 relu, 2 gelu
// (erf), 3 gelu (tanh).  Returns a cudaError_t (0 = launched).
int paddle_tpu_torch_dense_act(const void* x, const void* w, const void* b,
                               void* y, void* scratch, int m, int k, int n,
                               int act, int x_bf16, int w_bf16,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const long long mp = round_up(m, BM), kp = round_up(k, BK),
                  np = round_up(n, BN);
  if (mp / BM > 65535 || kp > 0x7fffffffLL || np > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* free_at = static_cast<__nv_bfloat16*>(scratch);
  Operand xa, wa;
  if (direct(x, k, x_bf16)) {
    xa = {static_cast<const __nv_bfloat16*>(x), k, m, k};
  } else {
    const int err = launch_round_pad(x, x_bf16, free_at, m, k, (int)mp,
                                     (int)kp, st);
    if (err != 0) return err;
    xa = {free_at, (int)kp, (int)mp, (int)kp};
    free_at += mp * kp;
  }
  if (direct(w, n, w_bf16)) {
    wa = {static_cast<const __nv_bfloat16*>(w), n, k, n};
  } else {
    const int err = launch_round_pad(w, w_bf16, free_at, k, n, (int)kp,
                                     (int)np, st);
    if (err != 0) return err;
    wa = {free_at, (int)np, (int)kp, (int)np};
  }
  const int ktiles = (int)(kp / BK);
  const float* bf = static_cast<const float*>(b);
  return x_bf16 ? launch_gemm<__nv_bfloat16>(xa, wa, bf, y, m, n, ktiles,
                                             act, st)
                : launch_gemm<float>(xa, wa, bf, y, m, n, ktiles, act, st);
}

}  // extern "C"
