// Attention skeletons (K8) for Hopper (sm_90a): the flash-attention
// kernels' matrix products with the softmax taken out, float32.
//
// Replaces the Pallas TPU kernels of tools/attn_shape_ceiling.py:
// _fwd_skeleton (:38, pallas_call :64) and _bwd_skeleton (:78, pallas_call
// :120).  For q, k, v, do [bh, T, d] (float32):
//
//   forward:  o = (q . k^T) . v                     (no scale, mask, softmax)
//   backward: s = q . k^T,  dp = do . v^T,  ds = s * dp
//             dq        = ds . k
//             dkp[b, i] = ds_i^T . q_i,   dvp[b, i] = s_i^T . do_i
//
// where _i is the i-th block of block_q query rows, so dkp and dvp are
// [bh, T / block_q, T, d]: the per-q-block partials the TPU's combined
// backward writes.  What the skeletons leave out of K1 and K2 (the softmax,
// its running max and sum, the masks, lse and delta) is what "real kernel /
// skeleton" measures, so they keep K1/K2's design:
//  - 64 x 64 tiles, a 16 x 16 thread block, each thread 4 rows x 4 columns
//    of a score tile and 4 rows x ceil(d / 16) columns of an output tile,
//    all arithmetic float32 FMAs on the CUDA cores, tiles in shared memory
//    with odd row strides (conflict-free column reads).
//  - forward (K1's loop): one block per (bh, 64-row q tile) walks the key
//    tiles, S to shared memory, o accumulated in registers.
//  - backward (the TPU's combined kernel): one block per (bh, block_q-row
//    block).  For each 64-row q sub-tile and each key tile it computes S and
//    dP, keeps dq in registers, and writes that key tile's dk and dv
//    partial rows; the block's later sub-tiles add theirs to what the same
//    threads wrote, in order: deterministic, no atomics.
// T must be a multiple of 64 and block_q a multiple of 64 dividing T (the
// wrapper checks both); d is at most 128, zero-padded to a multiple of 16.
//
// What bounds it on an H100: operations.  At (bh 24, T 2048, d 64) the
// forward is 25.8 GFLOP (0.385 ms at 67 TFLOP/s float32) against 50 MB; the
// backward 64.4 GFLOP (0.96 ms) against 0.8 GB of partials and 63 MB (0.26
// ms at 3.35 TB/s).  The inner loops issue one shared-memory load per two
// FMAs, as K1's and K2's do.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;        // rows of every tile
constexpr int TX = 16;          // threads along a tile's columns
constexpr int TY = 16;          // threads along a tile's rows
constexpr int RPT = TILE / TY;  // tile rows per thread
constexpr int CPT = TILE / TX;  // score columns per thread
constexpr int LDP = TILE + 1;   // row stride of a score tile

// rows row0 .. row0 + 63 of a [T, d] matrix into a [64][ld] shared tile,
// zero-padded past d columns (ld - 1 = NJ * TX >= d)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int d, int ld, int tid) {
  const int w = ld - 1;
  for (int idx = tid; idx < TILE * w; idx += TX * TY) {
    const int r = idx / w, c = idx - r * w;
    dst[r * ld + c] = c < d ? src[(long long)(row0 + r) * d + c] : 0.f;
  }
}

// NJ = ceil(d / 16): head-dim columns each thread accumulates
template <int NJ>
__global__ void __launch_bounds__(TX * TY)
skeleton_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int t,
                    int d) {
  extern __shared__ float smem[];
  const int ld = NJ * TX + 1;
  float* sQ = smem;                   // [64][ld]
  float* sK = sQ + TILE * ld;         // [64][ld]
  float* sV = sK + TILE * ld;         // [64][ld]
  float* sP = sV + TILE * ld;         // [64][LDP], S

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const long long base = (long long)blockIdx.x * t * d;
  const int q0 = blockIdx.y * TILE;

  load_tile(sQ, q + base, q0, d, ld, tid);
  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < t; k0 += TILE) {
    __syncthreads();            // the previous tile's sK/sV/sP are consumed
    load_tile(sK, k + base, k0, d, ld, tid);
    load_tile(sV, v + base, k0, d, ld, tid);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * ld + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + j * TX) * ld + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sP[(ty * RPT + i) * LDP + tx + j * TX] = s[i][j];
    __syncthreads();

    for (int kk = 0; kk < TILE; ++kk) {   // o += S . V
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * ld + tx + j * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = o + base + (long long)(q0 + ty * RPT + i) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + j * TX;
      if (col < d) row[col] = acc[i][j];
    }
  }
}

// rows k0 .. k0 + 63 of one [T, d] partial: the product of the transposed
// score tile `sT` ([64 q][LDP], columns = this tile's keys) with the
// [64 q][ld] tile `sX`; written when `first`, else added to what this same
// thread wrote for the block's earlier sub-tiles
template <int NJ>
__device__ __forceinline__ void partial_rows(const float* sT, const float* sX,
                                             float* dst, int k0, int d,
                                             int ld, int tx, int ty,
                                             bool first) {
  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int qq = 0; qq < TILE; ++qq) {
    float sv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sv[i] = sT[qq * LDP + ty * RPT + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float x = sX[qq * ld + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(sv[i], x, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = dst + (long long)(k0 + ty * RPT + i) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + j * TX;
      if (col < d) row[col] = first ? acc[i][j] : row[col] + acc[i][j];
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(TX * TY)
skeleton_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dkp, float* __restrict__ dvp, int t,
                    int d, int block_q) {
  extern __shared__ float smem[];
  const int ld = NJ * TX + 1;
  float* sQ = smem;                   // [64][ld] the q sub-tile
  float* sO = sQ + TILE * ld;         // [64][ld] its output gradient do
  float* sK = sO + TILE * ld;         // [64][ld]
  float* sV = sK + TILE * ld;         // [64][ld]
  float* sS = sV + TILE * ld;         // [64][LDP] S
  float* sD = sS + TILE * LDP;        // [64][LDP] dS

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const long long base = (long long)blockIdx.x * t * d;
  // this block's partials: [bh, nq, T, d] at (bh, i)
  const long long part =
      ((long long)blockIdx.x * gridDim.y + blockIdx.y) * t * d;

  for (int sub = 0; sub < block_q / TILE; ++sub) {
    const int q0 = blockIdx.y * block_q + sub * TILE;
    __syncthreads();            // the previous sub-tile is consumed
    load_tile(sQ, q + base, q0, d, ld, tid);
    load_tile(sO, dout + base, q0, d, ld, tid);
    float acc[RPT][NJ];         // dq of the sub-tile's rows
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < t; k0 += TILE) {
      __syncthreads();          // the previous key tile is consumed
      load_tile(sK, k + base, k0, d, ld, tid);
      load_tile(sV, v + base, k0, d, ld, tid);
      __syncthreads();

      // s = Q . K^T and dp = dO . V^T, [q rows][k cols]
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          qv[i] = sQ[(ty * RPT + i) * ld + c];
          ov[i] = sO[(ty * RPT + i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          kv[j] = sK[(tx + j * TX) * ld + c];
          vv[j] = sV[(tx + j * TX) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int at = (ty * RPT + i) * LDP + tx + j * TX;
          sS[at] = s[i][j];
          sD[at] = s[i][j] * dp[i][j];
        }
      __syncthreads();

      for (int kk = 0; kk < TILE; ++kk) {   // dQ += dS . K
        float sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sv[i] = sD[(ty * RPT + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = sK[kk * ld + tx + j * TX];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(sv[i], x, acc[i][j]);
        }
      }
      // dV partial += S^T . dO,  dK partial += dS^T . Q
      partial_rows<NJ>(sS, sO, dvp + part, k0, d, ld, tx, ty, sub == 0);
      partial_rows<NJ>(sD, sQ, dkp + part, k0, d, ld, tx, ty, sub == 0);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float* row = dq + base + (long long)(q0 + ty * RPT + i) * d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + j * TX;
        if (col < d) row[col] = acc[i][j];
      }
    }
  }
}

template <int NJ>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, int bh, int t, int d, cudaStream_t st) {
  const int ld = NJ * TX + 1;
  const size_t smem = sizeof(float) * (3 * TILE * (size_t)ld + TILE * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      skeleton_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  skeleton_fwd_kernel<NJ><<<dim3(bh, t / TILE), dim3(TX, TY), smem, st>>>(
      q, k, v, o, t, d);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* dout, float* dq, float* dkp, float* dvp,
                       int bh, int t, int d, int block_q, cudaStream_t st) {
  const int ld = NJ * TX + 1;
  const size_t smem =
      sizeof(float) * (4 * TILE * (size_t)ld + 2 * TILE * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      skeleton_bwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  skeleton_bwd_kernel<NJ><<<dim3(bh, t / block_q), dim3(TX, TY), smem,
                            st>>>(q, k, v, dout, dq, dkp, dvp, t, d, block_q);
  return cudaGetLastError();
}

bool bad_shape(int bh, int t, int d) {
  return bh <= 0 || t <= 0 || t % TILE || t / TILE > 65535 || d <= 0 ||
         d > 128;
}

}  // namespace

extern "C" {

// o [bh, t, d] = (q . k^T) . v for q, k, v [bh, t, d]; float32, contiguous,
// on the device; t a multiple of 64, d at most 128.  Returns a cudaError_t
// (0 = launched).
int paddle_tpu_torch_attn_skeleton_fwd(const void* q, const void* k,
                                       const void* v, void* o, int bh, int t,
                                       int d, void* stream) {
  if (bad_shape(bh, t, d)) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + TX - 1) / TX) {
    case 1: return (int)launch_fwd<1>(qf, kf, vf, of, bh, t, d, s);
    case 2: return (int)launch_fwd<2>(qf, kf, vf, of, bh, t, d, s);
    case 3: return (int)launch_fwd<3>(qf, kf, vf, of, bh, t, d, s);
    case 4: return (int)launch_fwd<4>(qf, kf, vf, of, bh, t, d, s);
    case 5: return (int)launch_fwd<5>(qf, kf, vf, of, bh, t, d, s);
    case 6: return (int)launch_fwd<6>(qf, kf, vf, of, bh, t, d, s);
    case 7: return (int)launch_fwd<7>(qf, kf, vf, of, bh, t, d, s);
    default: return (int)launch_fwd<8>(qf, kf, vf, of, bh, t, d, s);
  }
}

// dq [bh, t, d], dkp and dvp [bh, t / block_q, t, d] from q, k, v, do
// [bh, t, d]; float32, contiguous, on the device; block_q a multiple of 64
// dividing t.  Returns a cudaError_t (0 = launched).
int paddle_tpu_torch_attn_skeleton_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       void* dq, void* dkp, void* dvp,
                                       int bh, int t, int d, int block_q,
                                       void* stream) {
  if (bad_shape(bh, t, d) || block_q <= 0 || block_q % TILE || t % block_q)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(dout);
  float* a = static_cast<float*>(dq);
  float* b = static_cast<float*>(dkp);
  float* c = static_cast<float*>(dvp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + TX - 1) / TX) {
    case 1: return (int)launch_bwd<1>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 2: return (int)launch_bwd<2>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 3: return (int)launch_bwd<3>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 4: return (int)launch_bwd<4>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 5: return (int)launch_bwd<5>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 6: return (int)launch_bwd<6>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    case 7: return (int)launch_bwd<7>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
    default: return (int)launch_bwd<8>(qf, kf, vf, gf, a, b, c, bh, t, d, block_q, s);
  }
}

}  // extern "C"
