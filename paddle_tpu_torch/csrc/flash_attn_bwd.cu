// Flash-attention backward for Hopper (sm_90a): float32 operands and
// arithmetic.  (bf16 operands go to flash_attn_bwd_sm90.cu.)
//
// Replaces the Pallas TPU kernels of paddle_tpu/pallas/flash_attention.py
// behind _flash_bwd_pallas (:499): the combined kernel (:446, body
// _bwd_combined_kernel :353) and the split kernels (:515, bodies
// _bwd_dq_kernel :254 and _bwd_dkv_kernel :299).  It ports their contract,
// the FlashAttention-2 backward recomputed from the forward's logsumexp:
//
//   delta = rowsum(do * o)                                  (float32)
//   p     = exp(q*sm_scale . k^T - lse), and 0 where the pair is masked
//   dv    = p^T . do
//   ds    = p * (do . v^T - delta)
//   dq    = sm_scale * ds . k,   dk = sm_scale * ds^T . q   (scale folded
//                                                            into q)
//
// for float32 q, k, v, o, do, lse, dq, dk and dv: delta, p, ds and the
// three gradients are float32, as in the TPU kernels.  With the causal rule
// q + (Tk - Tq) >= k, keys past Tk and queries past Tq contributing
// nothing, and p = 0 on every masked pair: a row with no live
// key at all (causal, Tq > Tk) gets zero gradients, as in the reference
// (the score NEG_INF there makes p = 0 through s <= NEG_INF/2).  No bias: a
// biased backward runs the plain version, as the reference runs
// _flash_bwd_jax for it.
//
// Design (simple and right first; deterministic, no atomics):
//  - delta: one warp per row.
//  - dK/dV pass: one thread block per (bh, 64-row k tile).  A loop inside the
//    block walks the q tiles from the diagonal down, keeping the dk and dv
//    accumulators of its k tile in registers.  This loop replaces the TPU's
//    sequential q grid axis and its VMEM scratch.  The heaviest k tiles
//    (the first ones, under a causal mask) are issued first.
//  - dQ pass: one thread block per (bh, 64-row q tile), walking the k tiles
//    up to the diagonal, with dq in registers.  The heaviest q tiles (the
//    last ones) are issued first.
//  - causal tiles wholly above the diagonal are skipped; masks run only on
//    diagonal and ragged tiles.
//  - each pass holds four 64-row tiles (k, v, q, do) with an odd row stride
//    (conflict-free column reads) and one P/dS tile in shared memory:
//    83 KB at d = 64 and 148 KB at d = 128, so the dynamic shared-memory
//    limit is raised before each launch.  The TPU's combined variant writes
//    per-q-block dk/dv partials (2*bh*nq*Tk*d*4 bytes, quadratic in T); this
//    design writes each gradient once.
//
// What bounds it on an H100: at the training shape [96, 2048, 64] causal the
// live triangle (201.4 M pairs) needs 10*d flops a pair, 128.9 GFLOP, which
// is 1.92 ms at the 67 TFLOP/s of float32 on the CUDA cores, against 404 MB
// of q/k/v/o/do/lse/delta and dq/dk/dv (0.12 ms at 3.35 TB/s): operations
// bound it.  Both passes recompute S and dP (14*d flops a pair are run in
// all), and the inner loops issue one shared-memory load per two FMAs, so
// shared-memory bandwidth is what this simple version runs into.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int TX = 16;          // threads along the tile's columns
constexpr int TY = 16;          // threads along the tile's rows
constexpr int RPT = 64 / TY;    // tile rows per thread
constexpr int CPT = 64 / TX;    // tile columns per thread

// rows of a [bh, t, d] tensor into a float32 [64][ld] shared tile,
// zero-padded past t rows and past d columns (ld - 1 = NJ * TX >= d);
// scaled by `scale`
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int t, int d, int ld,
                                          float scale, int tid) {
  const int w = ld - 1;
  for (int idx = tid; idx < 64 * w; idx += TX * TY) {
    const int r = idx / w, c = idx - r * w;
    const int gr = row0 + r;
    dst[r * ld + c] =
        (gr < t && c < d) ? src[(long long)gr * d + c] * scale
                          : 0.f;
  }
}

__global__ void flash_bwd_delta_kernel(const float* __restrict__ o,
                                       const float* __restrict__ dout,
                                       float* __restrict__ delta,
                                       long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + row * d;
  const float* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(orow[c], drow[c], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// NJ = ceil(d / 16): head-dim columns each thread accumulates
template <int NJ>
__global__ void __launch_bounds__(TX * TY)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int tq, int tk, int d,
                      float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = NJ * TX + 1;   // odd: conflict-free column reads
  const int ldp = BQ + 1;
  float* sK = smem;             // [BK][ld]
  float* sV = sK + BK * ld;     // [BK][ld]
  float* sQ = sV + BK * ld;     // [BQ][ld], pre-scaled by sm_scale
  float* sO = sQ + BQ * ld;     // [BQ][ld], the output gradient do
  float* sP = sO + BQ * ld;     // [BK][ldp], P^T then dS^T
  float* sL = sP + BK * ldp;    // [BQ] lse of the q tile
  float* sD = sL + BQ;          // [BQ] delta of the q tile

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int offset = tk - tq;

  const float* qb = q + (long long)bh * tq * d;
  const float* ob = dout + (long long)bh * tq * d;
  const float* lb = lse + (long long)bh * tq;
  const float* db = delta + (long long)bh * tq;

  load_tile(sK, k + (long long)bh * tk * d, k0, tk, d, ld, 1.f, tid);
  load_tile(sV, v + (long long)bh * tk * d, k0, tk, d, ld, 1.f, tid);

  float acc_k[RPT][NJ], acc_v[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the first q row that sees a key of this tile is k0 - offset
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / BQ * BQ;

  for (int q0 = q_begin; q0 < tq; q0 += BQ) {
    __syncthreads();            // the previous q tile is consumed
    load_tile(sQ, qb, q0, tq, d, ld, sm_scale, tid);
    load_tile(sO, ob, q0, tq, d, ld, 1.f, tid);
    if (tid < BQ) {
      const int qr = q0 + tid;
      sL[tid] = qr < tq ? lb[qr] : 0.f;
      sD[tid] = qr < tq ? db[qr] : 0.f;
    }
    __syncthreads();

    const bool masked = (q0 + BQ > tq) || (k0 + BK > tk) ||
                        (causal && q0 + offset < k0 + BK - 1);

    // s = S^T = K . (Q*scale)^T and dp = dP^T = V . dO^T, [k rows][q cols]
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = sK[(ty * RPT + i) * ld + c];
        vv[i] = sV[(ty * RPT + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = sQ[(tx + j * TX) * ld + c];
        ov[j] = sO[(tx + j * TX) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

    // P^T to shared memory; dS^T = P^T * (dP^T - delta) kept in dp
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int kr = k0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int qc = tx + j * TX;
        const int qr = q0 + qc;
        const bool live = !masked || (qr < tq && kr < tk &&
                                      (!causal || qr + offset >= kr));
        const float p = live ? expf(s[i][j] - sL[qc]) : 0.f;
        dp[i][j] = p * (dp[i][j] - sD[qc]);
        sP[(ty * RPT + i) * ldp + qc] = p;
      }
    }
    __syncthreads();

    const int qn = min(BQ, tq - q0);
    for (int qq = 0; qq < qn; ++qq) {   // dV += P^T . dO
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * ldp + qq];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = sO[qq * ld + tx + j * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc_v[i][j] = fmaf(pv[i], x, acc_v[i][j]);
      }
    }
    __syncthreads();            // P^T is consumed: the tile takes dS^T
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sP[(ty * RPT + i) * ldp + tx + j * TX] = dp[i][j];
    __syncthreads();
    for (int qq = 0; qq < qn; ++qq) {   // dK += dS^T . (Q*scale)
      float sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sP[(ty * RPT + i) * ldp + qq];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = sQ[qq * ld + tx + j * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc_k[i][j] = fmaf(sv[i], x, acc_k[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kr = k0 + ty * RPT + i;
    if (kr >= tk) continue;
    float* dkrow = dk + ((long long)bh * tk + kr) * d;
    float* dvrow = dv + ((long long)bh * tk + kr) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + j * TX;
      if (col < d) {
        dkrow[col] = acc_k[i][j];
        dvrow[col] = acc_v[i][j];
      }
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(TX * TY)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int tq, int tk, int d, float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = NJ * TX + 1;
  const int ldp = BK + 1;
  float* sQ = smem;             // [BQ][ld], pre-scaled by sm_scale
  float* sO = sQ + BQ * ld;     // [BQ][ld]
  float* sK = sO + BQ * ld;     // [BK][ld]
  float* sV = sK + BK * ld;     // [BK][ld]
  float* sS = sV + BK * ld;     // [BQ][ldp], dS
  float* sL = sS + BQ * ldp;    // [BQ]
  float* sD = sL + BQ;          // [BQ]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = tk - tq;

  const float* kb = k + (long long)bh * tk * d;
  const float* vb = v + (long long)bh * tk * d;
  load_tile(sQ, q + (long long)bh * tq * d, q0, tq, d, ld, sm_scale, tid);
  load_tile(sO, dout + (long long)bh * tq * d, q0, tq, d, ld, 1.f, tid);
  if (tid < BQ) {
    const int qr = q0 + tid;
    sL[tid] = qr < tq ? lse[(long long)bh * tq + qr] : 0.f;
    sD[tid] = qr < tq ? delta[(long long)bh * tq + qr] : 0.f;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys this q tile sees; none at all for rows above the shifted diagonal
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) - 1 + offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();            // the previous k tile is consumed
    load_tile(sK, kb, k0, tk, d, ld, 1.f, tid);
    load_tile(sV, vb, k0, tk, d, ld, 1.f, tid);
    __syncthreads();

    const bool masked = (q0 + BQ > tq) || (k0 + BK > tk) ||
                        (causal && k0 + BK - 1 > q0 + offset);

    // s = (Q*scale) . K^T and dp = dO . V^T, [q rows][k cols]
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
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int qr = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kc = tx + j * TX;
        const int kr = k0 + kc;
        const bool live = !masked || (qr < tq && kr < tk &&
                                      (!causal || qr + offset >= kr));
        const float p = live ? expf(s[i][j] - sL[r]) : 0.f;
        sS[r * ldp + kc] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

    const int kn = min(BK, tk - k0);
    for (int kk = 0; kk < kn; ++kk) {   // dQ += dS . K
      float sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty * RPT + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = sK[kk * ld + tx + j * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(sv[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + ty * RPT + i;
    if (qr >= tq) continue;
    float* row = dq + ((long long)bh * tq + qr) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + j * TX;
      if (col < d) row[col] = acc[i][j] * sm_scale;
    }
  }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* lse, const float* dout, float* delta, float* dq,
                   float* dk, float* dv, int bh, int tq, int tk, int d,
                   float sm_scale, int causal, int delta_ready,
                   cudaStream_t stream) {
  const int ld = NJ * TX + 1;
  const size_t smem =
      sizeof(float) * (4 * 64 * (size_t)ld + 64 * 65 + 2 * 64);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;

  if (!delta_ready) {
    const long long rows = (long long)bh * tq;
    const int warps = 8;
    flash_bwd_delta_kernel<<<(unsigned)((rows + warps - 1) / warps),
                                32 * warps, 0, stream>>>(o, dout, delta,
                                                         rows, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const dim3 block(TX, TY);
  flash_bwd_dkdv_kernel<NJ><<<dim3(bh, (tk + BK - 1) / BK), block, smem,
                                 stream>>>(q, k, v, dout, lse, delta, dk, dv, tq,
                                        tk, d, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<NJ><<<dim3(bh, (tq + BQ - 1) / BQ), block, smem,
                               stream>>>(q, k, v, dout, lse, delta, dq, tq, tk,
                                      d, sm_scale, causal);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int bh, int tq, int tk, int d,
             float sm_scale, int causal, int delta_ready, cudaStream_t s) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(o);
  const float* gt = static_cast<const float*>(dout);
  float* dqt = static_cast<float*>(dq);
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  switch ((d + TX - 1) / TX) {
    case 1: return (int)launch<1>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 2: return (int)launch<2>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 3: return (int)launch<3>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 4: return (int)launch<4>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 5: return (int)launch<5>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 6: return (int)launch<6>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 7: return (int)launch<7>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    case 8: return (int)launch<8>(qt, kt, vt, ot, lse, gt, delta, dqt, dkt, dvt, bh, tq, tk, d, sm_scale, causal, delta_ready, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q/o/do/dq [bh,tq,d] and
// k/v/dk/dv [bh,tk,d] float32 (bf16 operands go to flash_attn_bwd_sm90.cu);
// lse/delta [bh,tq] float32; all contiguous, on the device.  With
// delta_ready 0, delta is scratch the caller allocates and the first of three
// kernels fills it; with delta_ready 1 it holds rowsum(do * o) already (ring
// attention computes it once per backward, not once per ring step) and only
// the dK/dV and dQ kernels run.  Launches on `stream` and returns the
// cudaError_t of the launches (0 when all were accepted).
extern "C" int paddle_tpu_torch_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int bh, int tq, int tk, int d, float sm_scale, int causal,
    int delta_ready, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (tq + BQ - 1) / BQ > 65535 || (tk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, static_cast<const float*>(lse), dout,
                  static_cast<float*>(delta), dq, dk, dv, bh, tq, tk, d,
                  sm_scale, causal, delta_ready,
                  static_cast<cudaStream_t>(stream));
}
