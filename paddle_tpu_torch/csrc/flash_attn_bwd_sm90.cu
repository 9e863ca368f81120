// Flash-attention backward for Hopper (sm_90a), bf16 operands: TMA-fed,
// warp-specialized, bf16 wgmma with float32 sums.
//
// Replaces the Pallas TPU kernels of paddle_tpu/pallas/flash_attention.py
// behind _flash_bwd_pallas (:499): the combined kernel (:446, body
// _bwd_combined_kernel :353) and the split kernels (:515, bodies
// _bwd_dq_kernel :254 and _bwd_dkv_kernel :299), for bf16 q, k, v, o and do
// (AMP).  It ports their contract, the FlashAttention-2 backward recomputed
// from the forward's logsumexp:
//
//   delta = rowsum(do * o)                                  (float32)
//   p     = exp(q . k^T * sm_scale - lse), and 0 where the pair is masked
//   dv    = p^T . do
//   ds    = p * (do . v^T - delta)
//   dq    = sm_scale * ds . k,   dk = sm_scale * ds^T . q
//
// with lse and delta in float32 and dq, dk, dv in bf16, each rounded once
// from its float32 sum.  The causal rule is q + (Tk - Tq) >= k; keys past Tk
// and queries past Tq contribute nothing, and p = 0 on every masked pair, so
// a row with no live key at all (causal, Tq > Tk) gets zero gradients, as in
// the reference.  No bias: a biased backward runs the plain version, as the
// reference runs _flash_bwd_jax for it.
//
// Arithmetic.  S = q . k^T and dP = do . v^T are bf16 wgmma products with
// float32 sums: exact bf16 products, so they are the TPU kernel's float32
// products (:270-289) up to the order of the sums.  sm_scale multiplies the
// float32 S and the float32 dq and dk sums; P = expf(S - lse), as the plain
// version computes it.  P and dS are float32 and are the values a bf16 wgmma
// cannot take as they are: each is split into three bf16 terms, hi =
// bf16(x), mid = bf16(x - hi), lo = x - hi - mid, which hold it exactly (24
// significant bits, 8 a term), and its product is issued three times (dv +=
// P_hi^T do + P_mid^T do + P_lo^T do, and likewise dk, dq).  Each tile's
// product starts from zero in two short tensor-core chains (hi; mid and lo)
// and joins the gradient by float32 adds, since the tensor cores' float32
// sums truncate and one chain carried over every tile drifts toward zero:
// the gradients are the float32 products up to the order of the sums (see
// the forward for what the two-term and one-chain designs failed).
//
// Design (two passes, no atomics, so the results are deterministic):
//  - delta: one warp per row, unless the caller hands delta in (ring
//    attention computes it once for all its steps);
//  - dK/dV pass: one block (384 threads) per (bh, 128-key tile), on
//    gridDim.x, the heaviest causal tiles (the first ones) first.  The
//    producer warpgroup (setmaxnreg 40) loads the block's K and V by TMA
//    once, then streams 64-row tiles of q and do by TMA, and lse and delta
//    (its lanes' loads: a TMA row of them would need Tq to be a multiple of
//    4), into a ring of 2 stages with full and empty mbarriers.  Two
//    consumer warpgroups (setmaxnreg 232) of 64 keys each compute per tile
//    S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major in
//    shared memory), P^T and dS^T = P^T (dP^T - delta) in float32 on the
//    fragment, then dV += P^T dO and dK += dS^T Q (m64n64k16 a 64-column
//    panel, A from registers, B read MN-major), each with the three-term
//    split and fresh accumulators, dV's products waited for before dK's
//    terms are packed (fewer live registers);
//  - dQ pass: one block per (bh, 128-row q tile), heaviest first; q, do,
//    lse and delta stay, the producer streams 64-key tiles of K and V; the
//    consumers (64 rows each) compute S, dP and dS, then dQ += dS K;
//  - causal tiles wholly above the diagonal are skipped; masks run only on
//    diagonal and ragged tiles; the head dim is padded to 64 or 128 in
//    shared memory (TMA fills zeros past d, Tq and Tk) and the stores are
//    masked.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at [96, 2048,
// 64] causal the live triangle (201.4 M pairs) needs 10 d operations a pair,
// 128.9 GFLOP, 0.130 ms, against 203 MB of q, k, v, o, do, lse, delta and
// dq, dk, dv (0.061 ms): the tensor cores bound it.  Both passes recompute S
// and dP (14 d a pair run) and the three split products run three times,
// so about 2.6x the counted operations are issued.  Each wgmma group is
// waited for before the element-wise work (no overlap yet).
//
// Budget (ptxas -v on sm_90a, CUDA 12.8; chip_smoke.py's kernel_bf16 phase
// prints it): 168 registers a thread at launch (384 threads, one block an
// SM), then 40 for the producer and 232 for the consumers; no spills at
// d <= 64; at d <= 128 the dK/dV pass spills 508 bytes (dk, dv, the panel's
// two fresh accumulators and a term set need ~270 registers), the dQ pass
// none.  Shared memory a block: dK/dV 68,672 bytes at d <= 64 (K and V
// 32 KB, 2 stages of q, do, lse and delta 34 KB), 134,208 at d <= 128; dQ
// 66,624 and 132,160.

#include <climits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 384;
constexpr int STAGES = 2;

__global__ void flash_bwd_sm90_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* orow = o + row * d;
  const __nv_bfloat16* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(__bfloat162float(orow[c]), __bfloat162float(drow[c]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// rows r0 and r0 + 8 of a consumer fragment with D / 2 float32 values a
// thread (columns 8i + col2 + {0, 1}), times `scale`, into bf16 [.., d]
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int r0,
                                           int rows, int d, int col2,
                                           const float (&acc)[D / 2],
                                           float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* row = base + (long long)r * d;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + col2;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h] * scale,
                                  acc[4 * i + 2 * h + 1] * scale);
    }
  }
}

// ---- dK/dV pass ----------------------------------------------------------

constexpr int KV_BK = 128;      // keys a block: 2 warpgroups x 64
constexpr int KV_BQ = 64;       // q rows a stage

template <int D>
struct DkdvLayout {
  static constexpr int KT = KV_BK * D * 2;    // the K (or V) tile
  static constexpr int QT = KV_BQ * D * 2;    // a q (or do) tile
  // a stage: q, do, then lse and delta (64 floats each), 1024-aligned
  static constexpr int STAGE = 2 * QT + 1024;
  static constexpr int STAGES_AT = 2 * KT;
  static constexpr int BARS = STAGES_AT + STAGES * STAGE;
  static constexpr int BYTES = BARS + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_sm90_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int bh, int tq, int tk, int d,
    float sm_scale, int causal) {
  using L = DkdvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + L::KT;
  uint8_t* stages = smem + L::STAGES_AT;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x % bh;
  const int k0 = (int)(blockIdx.x / bh) * KV_BK;
  const int offset = tk - tq;
  // the first q row that sees a key of this tile is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / KV_BQ * KV_BQ : 0;
  const int n_q = q_begin < tq ? (tq - q_begin + KV_BQ - 1) / KV_BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0 copies lse and delta, its lane 0
    // issues every TMA ----
    regs_dealloc();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KT);
        tma_load_tile<D>(sK, &tm_k, bar_kv, k0, b, KV_BK, KV_BK / BOX);
        tma_load_tile<D>(sV, &tm_v, bar_kv, k0, b, KV_BK, KV_BK / BOX);
      }
      const float* lb = lse + (long long)b * tq;
      const float* db = delta + (long long)b * tq;
      for (int j = 0; j < n_q; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* st = stages + s * L::STAGE;
        float* sL = reinterpret_cast<float*>(st + 2 * L::QT);
        const int q0 = q_begin + j * KV_BQ;
        for (int r = lane; r < KV_BQ; r += 32) {
          const int qr = q0 + r;
          sL[r] = qr < tq ? lb[qr] : 0.f;
          sL[KV_BQ + r] = qr < tq ? db[qr] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::QT);
          tma_load_tile<D>(st, &tm_q, &full[s], q0, b, KV_BQ, 1);
          tma_load_tile<D>(st + L::QT, &tm_do, &full[s], q0, b, KV_BQ, 1);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    regs_alloc();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int kr0 = k0 + 64 * c;
    const int krow = kr0 + 16 * warp + lane / 4;  // and krow + 8
    const int col2 = 2 * (lane % 4);
    const uint8_t* krows = sK + 64 * c * PANEL_ROW;
    const uint8_t* vrows = sV + 64 * c * PANEL_ROW;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint8_t* sQ = stages + s * L::STAGE;
      const uint8_t* sO = sQ + L::QT;
      const float* sL = reinterpret_cast<const float*>(sQ + 2 * L::QT);
      const float* sD = sL + KV_BQ;

      float st[32], dpt[32];          // S^T and dP^T: 64 keys x 64 q rows
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(st, desc_k(krows + p * KV_BK * PANEL_ROW, kk),
                   desc_k(sQ + p * KV_BQ * PANEL_ROW, kk), p + kk > 0);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(dpt, desc_k(vrows + p * KV_BK * PANEL_ROW, kk),
                   desc_k(sO + p * KV_BQ * PANEL_ROW, kk), p + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const int q0 = q_begin + j * KV_BQ;
      const bool masked = q0 + KV_BQ > tq || kr0 + 64 > tk ||
                          (causal && q0 + offset < kr0 + 63);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = krow + 8 * (e >> 1);
          const int qc = 8 * i + col2 + (e & 1);
          const int qr = q0 + qc;
          const bool live = !masked || (qr < tq && kr < tk &&
                                        (!causal || qr + offset >= kr));
          const float p =
              live ? expf(st[4 * i + e] * sm_scale - sL[qc]) : 0.f;
          st[4 * i + e] = p;
          dpt[4 * i + e] = p * (dpt[4 * i + e] - sD[qc]);
        }

      uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_a(st, kk, hi[kk], mid[kk], lo[kk]);
      add_split_product(dv_acc, hi, mid, lo, sO, KV_BQ * PANEL_ROW);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        split_a(dpt, kk, hi[kk], mid[kk], lo[kk]);
      add_split_product(dk_acc, hi, mid, lo, sQ, KV_BQ * PANEL_ROW);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows<D>(dk + (long long)b * tk * d, krow, tk, d, col2, dk_acc,
                  sm_scale);
    store_rows<D>(dv + (long long)b * tk * d, krow, tk, d, col2, dv_acc,
                  1.f);
  }
}

// ---- dQ pass -------------------------------------------------------------

constexpr int Q_BQ = 128;       // q rows a block: 2 warpgroups x 64
constexpr int Q_BK = 64;        // keys a stage

template <int D>
struct DqLayout {
  static constexpr int QT = Q_BQ * D * 2;     // the q (or do) tile
  static constexpr int KT = Q_BK * D * 2;     // a K (or V) tile
  static constexpr int STAGES_AT = 2 * QT;
  static constexpr int BARS = STAGES_AT + STAGES * 2 * KT;
  static constexpr int BYTES = BARS + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_sm90_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int bh,
    int tq, int tk, int d, float sm_scale, int causal) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sO = smem + L::QT;
  uint8_t* stages = smem + L::STAGES_AT;  // stage s: K, then V
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int n_qt = (tq + Q_BQ - 1) / Q_BQ;
  const int b = blockIdx.x % bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh)) * Q_BQ;
  const int offset = tk - tq;
  // keys this q tile sees; none at all for rows above the shifted diagonal
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + Q_BQ, tq) - 1 + offset + 1);
  const int n_k = k_end > 0 ? (k_end + Q_BK - 1) / Q_BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dealloc();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * L::QT);
      tma_load_tile<D>(sQ, &tm_q, bar_q, q0, b, Q_BQ, Q_BQ / BOX);
      tma_load_tile<D>(sO, &tm_do, bar_q, q0, b, Q_BQ, Q_BQ / BOX);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* st = stages + s * 2 * L::KT;
        mbar_expect_tx(&full[s], 2 * L::KT);
        tma_load_tile<D>(st, &tm_k, &full[s], j * Q_BK, b, Q_BK, 1);
        tma_load_tile<D>(st + L::KT, &tm_v, &full[s], j * Q_BK, b, Q_BK, 1);
      }
    }
  } else {
    regs_alloc();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int q0w = q0 + 64 * c;
    const int row0 = q0w + 16 * warp + lane / 4;  // and row0 + 8
    const int col2 = 2 * (lane % 4);
    const uint8_t* qrows = sQ + 64 * c * PANEL_ROW;
    const uint8_t* orows = sO + 64 * c * PANEL_ROW;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      lse_r[h] = r < tq ? lse[(long long)b * tq + r] : 0.f;
      delta_r[h] = r < tq ? delta[(long long)b * tq + r] : 0.f;
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint8_t* sK = stages + s * 2 * L::KT;
      const uint8_t* sV = sK + L::KT;

      float sc[32], dp[32];           // S and dP: 64 q rows x 64 keys
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, desc_k(qrows + p * Q_BQ * PANEL_ROW, kk),
                   desc_k(sK + p * Q_BK * PANEL_ROW, kk), p + kk > 0);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(dp, desc_k(orows + p * Q_BQ * PANEL_ROW, kk),
                   desc_k(sV + p * Q_BK * PANEL_ROW, kk), p + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const int k0 = j * Q_BK;
      const bool masked = q0w + 64 > tq || k0 + Q_BK > tk ||
                          (causal && k0 + Q_BK - 1 > q0w + offset);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int r = row0 + 8 * h;
          const int kc = k0 + 8 * i + col2 + (e & 1);
          const bool live = !masked || (r < tq && kc < tk &&
                                        (!causal || r + offset >= kc));
          const float p =
              live ? expf(sc[4 * i + e] * sm_scale - lse_r[h]) : 0.f;
          dp[4 * i + e] = p * (dp[4 * i + e] - delta_r[h]);
        }

      uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_a(dp, kk, hi[kk], mid[kk], lo[kk]);
      add_split_product(dq_acc, hi, mid, lo, sK, Q_BK * PANEL_ROW);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows<D>(dq + (long long)b * tq * d, row0, tq, d, col2, dq_acc,
                  sm_scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int bh, int tq, int tk, int d, float sm_scale,
           int causal, int delta_ready, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_rows(&mq, q, bh, tq, d);
  if (err == 0) err = encode_rows(&mk, k, bh, tk, d);
  if (err == 0) err = encode_rows(&mv, v, bh, tk, d);
  if (err == 0) err = encode_rows(&mdo, dout, bh, tq, d);
  if (err != 0) return err;
  const int smem_kv = DkdvLayout<D>::BYTES, smem_q = DqLayout<D>::BYTES;
  const cudaFuncAttribute smem_attr =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_sm90_dkdv_kernel<D>,
                                       smem_attr, smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_sm90_dq_kernel<D>, smem_attr, smem_q);
  if (e != cudaSuccess) return (int)e;
  if (!delta_ready) {
    const long long rows = (long long)bh * tq;
    const int warps = 8;
    flash_bwd_sm90_delta_kernel<<<(unsigned)((rows + warps - 1) / warps),
                                  32 * warps, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, rows, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long kv_blocks = (long long)bh * ((tk + KV_BK - 1) / KV_BK);
  flash_bwd_sm90_dkdv_kernel<D>
      <<<(unsigned)kv_blocks, THREADS, smem_kv, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bh, tq, tk, d, sm_scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long q_blocks = (long long)bh * ((tq + Q_BQ - 1) / Q_BQ);
  flash_bwd_sm90_dq_kernel<D>
      <<<(unsigned)q_blocks, THREADS, smem_q, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), bh, tq,
      tk, d, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  q/o/do/dq [bh,tq,d] and
// k/v/dk/dv [bh,tk,d] bf16; lse/delta [bh,tq] float32; all contiguous on
// the device, q, k, v, do 16-byte aligned, d a multiple of 8 up to 128.
// With delta_ready 0, delta is scratch the caller allocates and the first of
// three kernels fills it; with delta_ready 1 it holds rowsum(do * o) already
// and only the dK/dV and dQ kernels run.  Launches on `stream`; returns 0,
// the cudaError_t of the launches, or sm90::TENSOR_MAP_ERROR + the CUresult
// when a TMA map cannot be made.
extern "C" int paddle_tpu_torch_flash_attn_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int bh, int tq, int tk, int d, float sm_scale, int causal,
    int delta_ready, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
      (long long)bh * ((tq + Q_BQ - 1) / Q_BQ) > INT_MAX ||
      (long long)bh * ((tk + KV_BK - 1) / KV_BK) > INT_MAX ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, lf, dout, df, dq, dk, dv, bh, tq, tk, d,
                      sm_scale, causal, delta_ready, s);
  return launch<128>(q, k, v, o, lf, dout, df, dq, dk, dv, bh, tq, tk, d,
                     sm_scale, causal, delta_ready, s);
}

// The dynamic shared memory a block of the dK/dV pass (pass 0) or of the dQ
// pass (pass 1) takes at head dim d (what ptxas -v does not report).
extern "C" int paddle_tpu_torch_flash_attn_bwd_sm90_smem(int d, int pass) {
  if (pass == 0)
    return d <= 64 ? DkdvLayout<64>::BYTES : DkdvLayout<128>::BYTES;
  return d <= 64 ? DqLayout<64>::BYTES : DqLayout<128>::BYTES;
}
