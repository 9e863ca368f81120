// Flash-attention backward for Hopper (sm_90a): TMA-fed, warp-specialized,
// bf16 wgmma with float32 sums, for bf16 (AMP) and float32 q, k, v, o, do.
//
// Replaces the Pallas TPU kernels of paddle_tpu/pallas/flash_attention.py
// behind _flash_bwd_pallas (:499): the combined kernel (:446, body
// _bwd_combined_kernel :353) and the split kernels (:515, bodies
// _bwd_dq_kernel :254 and _bwd_dkv_kernel :299).  It ports their contract,
// the FlashAttention-2 backward recomputed from the forward's logsumexp:
//
//   delta = rowsum(do * o)                                  (float32)
//   p     = exp(q . k^T * sm_scale - lse), and 0 where the pair is masked
//   dv    = p^T . do
//   ds    = p * (do . v^T - delta)
//   dq    = sm_scale * ds . k,   dk = sm_scale * ds^T . q
//
// with lse and delta in float32 and dq, dk, dv in the operands' dtype,
// each rounded once from its float32 sum.  The causal rule is q + (Tk - Tq)
// >= k; keys past Tk and queries past Tq contribute nothing, and p = 0 on
// every masked pair, so a row with no live key at all (causal, Tq > Tk)
// gets zero gradients, as in the reference.  No bias: a biased backward
// runs the plain version, as the reference runs _flash_bwd_jax for it.
//
// Arithmetic.  bf16 operands (T = 1 term plane): S = q . k^T and dP = do .
// v^T are bf16 wgmma products with float32 sums, exact bf16 products, so
// they are the TPU kernel's float32 products (:270-289) up to the order of
// the sums.  float32 operands (T = 3): a split pass in this source first
// writes q, k, v and do as three bf16 term planes each (sm90.cuh), which
// hold them exactly, and every product is issued as the six bf16 products
// of weight 2^-16 and above, float32-exact up to ~2^-24 of the sum of the
// terms' magnitudes and the order of the sums.  sm_scale multiplies the
// float32 S and the float32 dq and dk sums; P = expf(S - lse), as the
// plain version computes it.  P and dS are float32 and are split into
// three bf16 terms in registers, and each of their products is issued
// three times (bf16 B) or six (B's three planes): dv += P^T do, dk += dS^T
// q, dq += dS k.  Each tile's product starts from zero in two short
// tensor-core chains (the hi terms'; the lower terms') and joins the
// gradient by float32 adds, since the tensor cores' float32 sums truncate
// and one chain carried over every tile drifts toward zero: the gradients
// are the float32 products up to the order of the sums (see the forward
// for what the two-term and one-chain designs failed).
//
// Design (two passes, no atomics, so the results are deterministic):
//  - delta: one warp per row, unless the caller hands delta in (ring
//    attention computes it once for all its steps);
//  - dK/dV pass: one block per (bh, 64 * NC-key tile), on gridDim.x, the
//    heaviest causal tiles (the first ones) first.  The producer warpgroup
//    (setmaxnreg 40) loads the block's K and V (their T planes) by TMA
//    once, then streams 64-row tiles of q and do by TMA, and lse and delta
//    (its lanes' loads: a TMA row of them would need Tq to be a multiple of
//    4), into a ring of stages with full and empty mbarriers.  NC consumer
//    warpgroups (setmaxnreg 232) of 64 keys each compute per tile S^T = K
//    Q^T and dP^T = V dO^T (m64n64k16, both operands K-major in shared
//    memory), P^T and dS^T = P^T (dP^T - delta) in float32 on the
//    fragment, then dV += P^T dO and dK += dS^T Q (m64n64k16 a 64-column
//    panel, A from registers, B read MN-major), each with the three-term
//    split and fresh accumulators, dV's products waited for before dK's
//    terms are packed (fewer live registers);
//  - dQ pass: one block per (bh, 64 * NC-row q tile), heaviest first; q,
//    do, lse and delta stay, the producer streams 64-key tiles of K and V;
//    the consumers (64 rows each) compute S, dP and dS, then dQ += dS K;
//  - causal tiles wholly above the diagonal are skipped; masks run only on
//    diagonal and ragged tiles; the head dim is padded to 64 or 128 in
//    shared memory (TMA fills zeros past d, Tq and Tk) and the stores are
//    masked;
//  - tiles: NC = 2 consumer warpgroups and 2 stages, but for float32 at
//    d <= 128, where every tile has three planes: NC = 1 and 1 stage, to
//    fit the 227 KB a block may hold.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at [96, 2048,
// 64] causal the live triangle (201.4 M pairs) needs 10 d operations a pair,
// 128.9 GFLOP, 0.130 ms in bf16, against 203 MB of q, k, v, o, do, lse,
// delta and dq, dk, dv (0.061 ms): the tensor cores bound it.  Both passes
// recompute S and dP (14 d a pair run) and the three split products run
// three times, so bf16 issues about 2.6x the counted operations.  float32
// issues every product six times: its float32-exact rate is 989 / 6 =
// 164.8 TFLOP/s and its bound 0.782 ms (404 MB, 0.121 ms, plus the split
// pass's 503 MB of planes); the CUDA-core rate would give 1.924 ms.  Each
// wgmma group is waited for before the element-wise work (no overlap yet).
//
// Budget (ptxas -v on sm_90a; chip_smoke.py's kernel phase prints each
// form's lines and shared memory): 168 registers a thread at launch (384
// threads, one block an SM), then 40 for the producer and 232 for the
// consumers.  bf16: no spills at d <= 64; at d <= 128 the dK/dV pass
// spills 508 bytes (dk, dv, the panel's two fresh accumulators and a term
// set need ~270 registers), the dQ pass none.  float32: no spills at d <=
// 64; at d <= 128 the dK/dV pass spills 804 bytes and the dQ pass 116
// (S's and dP's two chains each live at once).  Shared memory a block:
// bf16 dK/dV 68,672 bytes at d <= 64 (K and V 32 KB, 2 stages of q, do,
// lse and delta 34 KB), 134,208 at d <= 128; dQ 66,624 and 132,160;
// float32 dK/dV 199,744 at d <= 64 (the planes of K and V 96 KB, 2 stages
// of q's and do's planes, lse and delta 98 KB), 198,720 at d <= 128; dQ
// 197,696 and 197,696.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int MAX_THREADS = 384;  // the most a block runs: 3 warpgroups

template <int T>
using Elem = std::conditional_t<T == 1, __nv_bfloat16, float>;

// consumer warpgroups a block and stages of the ring: the float32 form at
// d <= 128 keeps three planes of every tile, so it runs 1 and 1
template <int D, int T>
struct Shape {
  static constexpr int NC = T == 3 && D == 128 ? 1 : 2;
  static constexpr int STAGES = T == 3 && D == 128 ? 1 : 2;
  static constexpr int THREADS = 128 * (NC + 1);
};

template <typename E>
__global__ void flash_bwd_sm90_delta_kernel(const E* __restrict__ o,
                                            const E* __restrict__ dout,
                                            float* __restrict__ delta,
                                            long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const E* orow = o + row * d;
  const E* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(widen(orow[c]), widen(drow[c]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// rows r0 and r0 + 8 of a consumer fragment with D / 2 float32 values a
// thread (columns 8i + col2 + {0, 1}), times `scale`, into [.., d]
template <int D, typename E>
__device__ __forceinline__ void store_rows(E* base, int r0, int rows, int d,
                                           int col2,
                                           const float (&acc)[D / 2],
                                           float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    E* row = base + (long long)r * d;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + col2;
      if (col < d)
        store2(row + col, acc[4 * i + 2 * h] * scale,
               acc[4 * i + 2 * h + 1] * scale);
    }
  }
}

// ---- dK/dV pass ----------------------------------------------------------

constexpr int KV_BQ = 64;       // q rows a stage

template <int D, int T>
struct DkdvLayout : Shape<D, T> {
  static constexpr int BK = 64 * Shape<D, T>::NC;    // keys a block
  static constexpr int KP = BK * D * 2;       // a plane of the K (or V) tile
  static constexpr int QP = KV_BQ * D * 2;    // a plane of a q (or do) tile
  // a stage: q's planes, do's, then lse and delta (64 floats each),
  // 1024-aligned
  static constexpr int STAGE = 2 * T * QP + 1024;
  static constexpr int STAGES_AT = 2 * T * KP;
  static constexpr int BARS = STAGES_AT + Shape<D, T>::STAGES * STAGE;
  static constexpr int BYTES = BARS + 64 + 1024;
};

template <int D, int T>
__global__ void __launch_bounds__(MAX_THREADS, 1) flash_bwd_sm90_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, Elem<T>* __restrict__ dk,
    Elem<T>* __restrict__ dv, int bh, int tq, int tk, int d, float sm_scale,
    int causal) {
  using L = DkdvLayout<D, T>;
  constexpr int STAGES = L::STAGES, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + T * L::KP;
  uint8_t* stages = smem + L::STAGES_AT;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x % bh;
  const int k0 = (int)(blockIdx.x / bh) * BK;
  const int offset = tk - tq;
  // the first q row that sees a key of this tile is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / KV_BQ * KV_BQ : 0;
  const int n_q = q_begin < tq ? (tq - q_begin + KV_BQ - 1) / KV_BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::NC);  // one arrival per consumer warp
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
        mbar_expect_tx(bar_kv, 2 * T * L::KP);
        tma_load_planes<D, T>(sK, &tm_k, bar_kv, k0, b, bh, BK, BK / BOX);
        tma_load_planes<D, T>(sV, &tm_v, bar_kv, k0, b, bh, BK, BK / BOX);
      }
      const float* lb = lse + (long long)b * tq;
      const float* db = delta + (long long)b * tq;
      for (int j = 0; j < n_q; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* st = stages + s * L::STAGE;
        float* sL = reinterpret_cast<float*>(st + 2 * T * L::QP);
        const int q0 = q_begin + j * KV_BQ;
        for (int r = lane; r < KV_BQ; r += 32) {
          const int qr = q0 + r;
          sL[r] = qr < tq ? lb[qr] : 0.f;
          sL[KV_BQ + r] = qr < tq ? db[qr] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * T * L::QP);
          tma_load_planes<D, T>(st, &tm_q, &full[s], q0, b, bh, KV_BQ, 1);
          tma_load_planes<D, T>(st + T * L::QP, &tm_do, &full[s], q0, b, bh,
                                KV_BQ, 1);
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
      const uint8_t* sO = sQ + T * L::QP;
      const float* sL = reinterpret_cast<const float*>(sQ + 2 * T * L::QP);
      const float* sD = sL + KV_BQ;

      // S^T and dP^T: 64 keys x 64 q rows (and their lower chains)
      float st[32], stl[32], dpt[32], dptl[32];
      wgmma_fence();
      product_ss<D, T>(st, stl, krows, BK * PANEL_ROW, L::KP, sQ,
                       KV_BQ * PANEL_ROW, L::QP);
      product_ss<D, T>(dpt, dptl, vrows, BK * PANEL_ROW, L::KP, sO,
                       KV_BQ * PANEL_ROW, L::QP);
      wgmma_commit();
      wgmma_wait_all();
      finish_product<T>(st, stl);
      finish_product<T>(dpt, dptl);

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
      add_split_product<4, D / 2, T>(dv_acc, hi, mid, lo, sO,
                                     KV_BQ * PANEL_ROW, L::QP);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        split_a(dpt, kk, hi[kk], mid[kk], lo[kk]);
      add_split_product<4, D / 2, T>(dk_acc, hi, mid, lo, sQ,
                                     KV_BQ * PANEL_ROW, L::QP);
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

constexpr int Q_BK = 64;        // keys a stage

template <int D, int T>
struct DqLayout : Shape<D, T> {
  static constexpr int BQ = 64 * Shape<D, T>::NC;    // q rows a block
  static constexpr int QP = BQ * D * 2;       // a plane of the q (or do) tile
  static constexpr int KP = Q_BK * D * 2;     // a plane of a K (or V) tile
  static constexpr int STAGES_AT = 2 * T * QP;
  static constexpr int BARS =
      STAGES_AT + Shape<D, T>::STAGES * 2 * T * KP;
  static constexpr int BYTES = BARS + 64 + 1024;
};

template <int D, int T>
__global__ void __launch_bounds__(MAX_THREADS, 1) flash_bwd_sm90_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, Elem<T>* __restrict__ dq, int bh,
    int tq, int tk, int d, float sm_scale, int causal) {
  using L = DqLayout<D, T>;
  constexpr int STAGES = L::STAGES, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sO = smem + T * L::QP;
  uint8_t* stages = smem + L::STAGES_AT;  // stage s: K's planes, then V's
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int n_qt = (tq + BQ - 1) / BQ;
  const int b = blockIdx.x % bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh)) * BQ;
  const int offset = tk - tq;
  // keys this q tile sees; none at all for rows above the shifted diagonal
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) - 1 + offset + 1);
  const int n_k = k_end > 0 ? (k_end + Q_BK - 1) / Q_BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dealloc();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * T * L::QP);
      tma_load_planes<D, T>(sQ, &tm_q, bar_q, q0, b, bh, BQ, BQ / BOX);
      tma_load_planes<D, T>(sO, &tm_do, bar_q, q0, b, bh, BQ, BQ / BOX);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* st = stages + s * 2 * T * L::KP;
        mbar_expect_tx(&full[s], 2 * T * L::KP);
        tma_load_planes<D, T>(st, &tm_k, &full[s], j * Q_BK, b, bh, Q_BK,
                              1);
        tma_load_planes<D, T>(st + T * L::KP, &tm_v, &full[s], j * Q_BK, b,
                              bh, Q_BK, 1);
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
      const uint8_t* sK = stages + s * 2 * T * L::KP;
      const uint8_t* sV = sK + T * L::KP;

      // S and dP: 64 q rows x 64 keys (and their lower chains)
      float sc[32], scl[32], dp[32], dpl[32];
      wgmma_fence();
      product_ss<D, T>(sc, scl, qrows, BQ * PANEL_ROW, L::QP, sK,
                       Q_BK * PANEL_ROW, L::KP);
      product_ss<D, T>(dp, dpl, orows, BQ * PANEL_ROW, L::QP, sV,
                       Q_BK * PANEL_ROW, L::KP);
      wgmma_commit();
      wgmma_wait_all();
      finish_product<T>(sc, scl);
      finish_product<T>(dp, dpl);

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
      add_split_product<4, D / 2, T>(dq_acc, hi, mid, lo, sK,
                                     Q_BK * PANEL_ROW, L::KP);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows<D>(dq + (long long)b * tq * d, row0, tq, d, col2, dq_acc,
                  sm_scale);
  }
}

// q, k, v, dout: bf16 [bh, t, d] (T = 1) or their term planes [3 * bh, t,
// d]; o and dout_e (for delta) in the operands' own dtype
template <int D, int T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, const void* dout_e,
           float* delta, void* dq, void* dk, void* dv, int bh, int tq,
           int tk, int d, float sm_scale, int causal, int delta_ready,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_rows(&mq, q, T * bh, tq, d);
  if (err == 0) err = encode_rows(&mk, k, T * bh, tk, d);
  if (err == 0) err = encode_rows(&mv, v, T * bh, tk, d);
  if (err == 0) err = encode_rows(&mdo, dout, T * bh, tq, d);
  if (err != 0) return err;
  using KV = DkdvLayout<D, T>;
  using Q = DqLayout<D, T>;
  using E = Elem<T>;
  const cudaFuncAttribute smem_attr =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_sm90_dkdv_kernel<D, T>,
                                       smem_attr, KV::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_sm90_dq_kernel<D, T>, smem_attr,
                             Q::BYTES);
  if (e != cudaSuccess) return (int)e;
  if (!delta_ready) {
    const long long rows = (long long)bh * tq;
    const int warps = 8;
    flash_bwd_sm90_delta_kernel<E>
        <<<(unsigned)((rows + warps - 1) / warps), 32 * warps, 0, stream>>>(
            static_cast<const E*>(o), static_cast<const E*>(dout_e), delta,
            rows, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long kv_blocks = (long long)bh * ((tk + KV::BK - 1) / KV::BK);
  flash_bwd_sm90_dkdv_kernel<D, T>
      <<<(unsigned)kv_blocks, KV::THREADS, KV::BYTES, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<E*>(dk), static_cast<E*>(dv),
      bh, tq, tk, d, sm_scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long q_blocks = (long long)bh * ((tq + Q::BQ - 1) / Q::BQ);
  flash_bwd_sm90_dq_kernel<D, T>
      <<<(unsigned)q_blocks, Q::THREADS, Q::BYTES, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<E*>(dq), bh, tq, tk, d,
      sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  q/o/do/dq [bh,tq,d] and
// k/v/dk/dv [bh,tk,d] of one dtype, bf16 (f32 0) or float32 (f32 1);
// lse/delta [bh,tq] float32; all contiguous on the device, d a multiple of
// 8 up to 128.  bf16 q, k, v, do are read by TMA and must be 16-byte
// aligned.  float32 ones are first split into term planes in `planes`,
// scratch of 3 * (2*bh*tq + 2*bh*tk) * d bf16 values (16-byte aligned) that
// the caller allocates (null for bf16).  With delta_ready 0, delta is
// scratch the caller allocates and the first kernel fills it; with
// delta_ready 1 it holds rowsum(do * o) already and only the dK/dV and dQ
// kernels run.  Launches on `stream`; returns 0, the cudaError_t of a
// launch, or sm90::TENSOR_MAP_ERROR + the CUresult when a TMA map cannot be
// made.
extern "C" int paddle_tpu_torch_flash_attn_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, void* planes, int bh, int tq, int tk, int d, float sm_scale,
    int causal, int delta_ready, int f32, void* stream) {
  const uintptr_t tma = f32 ? reinterpret_cast<uintptr_t>(planes)
                            : (reinterpret_cast<uintptr_t>(q) |
                               reinterpret_cast<uintptr_t>(k) |
                               reinterpret_cast<uintptr_t>(v) |
                               reinterpret_cast<uintptr_t>(dout));
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
      (long long)bh * ((tq + 63) / 64) > INT_MAX ||
      (long long)bh * ((tk + 63) / 64) > INT_MAX || (f32 && !planes) ||
      (tma & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32) {
    if (d <= 64)
      return launch<64, 1>(q, k, v, o, lf, dout, dout, df, dq, dk, dv, bh,
                           tq, tk, d, sm_scale, causal, delta_ready, s);
    return launch<128, 1>(q, k, v, o, lf, dout, dout, df, dq, dk, dv, bh,
                          tq, tk, d, sm_scale, causal, delta_ready, s);
  }
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* kp = qp + 3LL * bh * tq * d;
  __nv_bfloat16* vp = kp + 3LL * bh * tk * d;
  __nv_bfloat16* dop = vp + 3LL * bh * tk * d;
  const long long nq = (long long)bh * tq * d, nk = (long long)bh * tk * d;
  int err = split_planes(static_cast<const float*>(q), qp, nq, s);
  if (err == 0) err = split_planes(static_cast<const float*>(k), kp, nk, s);
  if (err == 0) err = split_planes(static_cast<const float*>(v), vp, nk, s);
  if (err == 0)
    err = split_planes(static_cast<const float*>(dout), dop, nq, s);
  if (err != 0) return err;
  if (d <= 64)
    return launch<64, 3>(qp, kp, vp, o, lf, dop, dout, df, dq, dk, dv, bh,
                         tq, tk, d, sm_scale, causal, delta_ready, s);
  return launch<128, 3>(qp, kp, vp, o, lf, dop, dout, df, dq, dk, dv, bh,
                        tq, tk, d, sm_scale, causal, delta_ready, s);
}

// The dynamic shared memory a block of the dK/dV pass (pass 0) or of the dQ
// pass (pass 1) takes at head dim d, for bf16 (f32 0) or float32 (f32 1)
// operands (what ptxas -v does not report).
extern "C" int paddle_tpu_torch_flash_attn_bwd_sm90_smem(int d, int pass,
                                                         int f32) {
  if (f32) {
    if (pass == 0)
      return d <= 64 ? DkdvLayout<64, 3>::BYTES : DkdvLayout<128, 3>::BYTES;
    return d <= 64 ? DqLayout<64, 3>::BYTES : DqLayout<128, 3>::BYTES;
  }
  if (pass == 0)
    return d <= 64 ? DkdvLayout<64, 1>::BYTES : DkdvLayout<128, 1>::BYTES;
  return d <= 64 ? DqLayout<64, 1>::BYTES : DqLayout<128, 1>::BYTES;
}
