// Attention skeletons (K8) for Hopper (sm_90a): the float32 flash-attention
// kernels' matrix products with the softmax taken out, in the arithmetic
// those kernels use (float32-exact products as bf16 wgmma term products).
//
// Replaces the Pallas TPU kernels of tools/attn_shape_ceiling.py:
// _fwd_skeleton (:38, pallas_call :64) and _bwd_skeleton (:78, pallas_call
// :120).  For float32 q, k, v, do [bh, T, d]:
//
//   forward:  o = (q . k^T) . v                     (no scale, mask, softmax)
//   backward: s = q . k^T,  dp = do . v^T,  ds = s * dp
//             dq        = ds . k
//             dkp[b, i] = ds_i^T . q_i,   dvp[b, i] = s_i^T . do_i
//
// where _i is the i-th block of block_q query rows, so dkp and dvp are
// [bh, T / block_q, T, d]: the per-q-block partials of the TPU's combined
// backward.  A skeleton is the real kernel less its softmax (the running
// max and sum, exp, masks, lse and delta), so that "real kernel /
// skeleton" (attn_shape_ceiling.py) measures the softmax's share and
// "operations / skeleton time" the rate the shape allows.  So the
// skeletons run the float32 K1/K2's arithmetic (flash_attn_fwd_sm90.cu):
// a split pass (sm90.cuh split_planes, part of each launch, as it is of
// K1's and K2's) writes each float32 operand as three bf16 term planes
// that hold it exactly; every product is issued as the six bf16 products
// of weight 2^-16 and above, in two chains from zero (hi.hi; the five
// lower ones), since the tensor cores' float32 sums truncate and a long
// chain drifts toward zero; a float32 product that feeds another product
// (S, dS) is split in registers into its three bf16 terms; each tile's
// product joins its sum by float32 adds.  Everything is float32-exact up
// to ~2^-22 of the sum of the terms' magnitudes (the check holds it to
// 2^-20 of that sum).
//
// Forward: K1's float32 design (flash_attn_fwd_sm90.cu) with the softmax
// taken out.  One block (384 threads) per (bh, 128-row q tile); warpgroup
// 0 produces (one thread issues TMA for q's planes once, then K's and V's
// planes of 64-key tiles into a ring of stages: 2 at d <= 64, 1 at
// d <= 128); warpgroups 1 and 2 consume, 64 q rows each: S = Q K^T (SS
// wgmma, both K-major), S split into its terms in registers, O += S V (A
// from registers, V read MN-major), O stored from the registers.
//
// Backward: the reference's combined kernel, one pass of five products a
// (64-key, 64-query) tile pair, no atomics, deterministic.  Keys are M:
//  - S^T = K Q^T and dP^T = V dO^T (SS wgmma, both K-major);
//  - dS^T = S^T * dP^T on the fragment; its three terms are stored into a
//    64 x 64 staging tile (keys as rows, the 128-byte swizzle of a TMA
//    box, conflict-free: a warp's 32 stores fall on 32 banks);
//  - dvp += S^T dO: A = S^T's terms from registers, dO read MN-major;
//  - dkp += dS^T Q: A = the staged dS^T, K-major; Q read MN-major;
//  - dq += dS K: A = the staged tile read MN-major (dS, queries as M), K
//    read MN-major (sm90.cuh wgmma_ss_tt).
// block_q 64 (the tool's blocks): one block per (bh, 64-row q block), q's
// and do's planes resident; at d <= 64 two consumer warpgroups take the
// key tiles in turn (each its own stage of K's and V's planes and its own
// staging tile; one producer thread each), each keeps a dq for the block's
// 64 rows in registers, and the two are added in a fixed order at the end
// through shared memory; at d <= 128 one consumer warpgroup.  Each pair's
// dkp and dvp tiles are the partials of (q block, key tile): stored once,
// from the registers, after the stage is released, so that the stores
// overlap its refill (storing each panel as soon as its product is done
// measured slower on an H100).
// block_q = 64 n, n > 1: one block per (bh, q block), one consumer
// warpgroup; for each key tile (its K and V planes resident) it walks the
// block's n 64-row sub-tiles (q's and do's planes streamed in stages: 2 at
// d <= 64, 1 at d <= 128), adds each sub-tile's dvp and dkp into register
// sums in sub-tile order, and stores each partial once.  A q block's dq
// (block_q x d float32) does not fit on chip at every block_q, so each
// sub-tile's dq is added into the output in key-tile order by the threads
// that own its values (the first key tile stores).
// T is a multiple of 64 and block_q a multiple of 64 dividing T (the
// wrapper checks both); d is a multiple of 8 up to 128 (the wrapper pads
// other d with zero columns), padded to 64 or 128 in shared memory (TMA
// fills zeros past d; the stores are masked to d).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.
// Counted as float32 work, the forward at (bh 24, T 2048, d 64) is 25.8
// GFLOP, the backward 64.4 GFLOP; at float32-exact products as six bf16
// term products (164.8 TFLOP/s) that is 0.156 and 0.391 ms, against 50 MB
// (0.015 ms) and 868 MB (0.259 ms: the partials are 805 MB) of bytes.  The
// split passes move 94 and 126 MB more.  This first design waits for each
// wgmma group before the element-wise work and stores the partials from
// the registers (later work: overlap, TMA stores).
//
// Budget: the forward as K1's float32 form (384 threads, setmaxnreg 40 /
// 232); the backward at block_q 64, d <= 64 the same split, else 256
// threads (one consumer warpgroup, up to 255 registers, no split).
// chip_smoke.py's kernel phase prints what ptxas -v says of each kernel
// (registers, spills, the C7507 / C7512 notes).  Shared memory: the
// layouts below, paddle_tpu_torch_attn_skeleton_smem (and
// kernels/attn_skeleton.py shared_bytes, which a CPU test holds to the
// 227 KB a block may use).

#include <climits>

#include "sm90_gemm.cuh"

namespace {

using namespace sm90;
using sm90g::consumer_regs;
using sm90g::fence_async_shared;
using sm90g::regs_dec;
using sm90g::regs_inc;
using sm90g::wg_sync;
using sm90g::wgmma_ss_mn;

constexpr int TILE = 64;                   // rows of a q, key or dS tile
constexpr int TERMS = 3;                   // bf16 term planes a float32 tile
constexpr int PRODUCER_REGS = 40;

// ---- forward ---------------------------------------------------------------

constexpr int FWD_BQ = 128;                // q rows a block: 2 x 64
constexpr int FWD_THREADS = 384;

template <int D>
struct FwdLayout {
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int QP = FWD_BQ * D * 2;   // a plane of the q tile
  static constexpr int KVP = TILE * D * 2;    // a plane of a K or V tile
  static constexpr int Q = TERMS * QP;
  static constexpr int KV = TERMS * KVP;
  static constexpr int BARS = Q + STAGES * 2 * KV;
  static constexpr int BYTES = BARS + 64 + 1024;  // + barriers, alignment
};

// q, k, v are read through maps over their term planes [3 * bh, t, d]
// (plane p of sequence b at leading index b + p * bh)
template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1) skeleton_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int bh,
    int t, int d) {
  using L = FwdLayout<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::Q;   // stage s: K's planes at s * 2 * KV, V's next
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x % bh;
  const int q0 = (int)(blockIdx.x / bh) * FWD_BQ;
  const int n_kv = t / TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q);
      tma_load_planes<D, TERMS>(sQ, &tm_q, bar_q, q0, b, bh, FWD_BQ,
                                FWD_BQ / BOX);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) sm90g::wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* sK = sKV + s * 2 * L::KV;
        mbar_expect_tx(&full[s], 2 * L::KV);
        tma_load_planes<D, TERMS>(sK, &tm_k, &full[s], j * TILE, b, bh, TILE,
                                  1);
        tma_load_planes<D, TERMS>(sK + L::KV, &tm_v, &full[s], j * TILE, b,
                                  bh, TILE, 1);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    regs_inc<consumer_regs(PRODUCER_REGS)>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;  // and row0 + 8
    const int col2 = 2 * (lane % 4);
    const uint8_t* qrows = sQ + 64 * c * PANEL_ROW;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    sm90g::wait(bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      sm90g::wait(&full[s], (j / STAGES) & 1);
      const uint8_t* sK = sKV + s * 2 * L::KV;
      const uint8_t* sV = sK + L::KV;

      float x[32], xl[32];                      // S: 64 q rows x 64 keys
      wgmma_fence();
      product_ss<D, TERMS>(x, xl, qrows, FWD_BQ * PANEL_ROW, L::QP, sK,
                           TILE * PANEL_ROW, L::KVP);
      wgmma_commit();
      wgmma_wait_all();
      finish_product<TERMS>(x, xl);

      uint32_t sh[4][4], sm[4][4], sl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_a(x, kk, sh[kk], sm[kk], sl[kk]);
      add_split_product<4, D / 2, TERMS>(acc, sh, sm, sl, sV,
                                         TILE * PANEL_ROW, L::KVP);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= t) continue;
      float* orow = o + ((long long)b * t + r) * d;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + col2;
        if (col < d) store2(orow + col, acc[4 * i + 2 * h],
                            acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// ---- backward --------------------------------------------------------------

constexpr int DS_PLANE = TILE * TILE * 2;  // a term plane of the dS^T tile
constexpr int DS_BYTES = TERMS * DS_PLANE;

// The backward's shared memory at head dim D, for block_q 64 (ONE) or
// larger.  ONE: q's and do's planes resident (FIXED), one stage of K's and
// V's planes and one dS staging tile a consumer warpgroup.  Else: K's and
// V's planes of the current key tile (FIXED), QSTAGES stages of a
// sub-tile's q and do planes, one dS staging tile.
template <int D, bool ONE>
struct BwdLayout {
  static constexpr int NC = ONE && D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int P = TILE * D * 2;     // a plane of a 64-row tile
  static constexpr int OP = TERMS * P;       // an operand tile's planes
  static constexpr int STAGES = ONE ? NC : (D == 64 ? 2 : 1);
  static constexpr int FIXED = 2 * OP;
  static constexpr int STAGE = 2 * OP;
  static constexpr int DS_AT = FIXED + STAGES * STAGE;
  static constexpr int BARS = DS_AT + NC * DS_BYTES;
  static constexpr int BYTES = BARS + 64 + 1024;
};

// The three bf16 terms of the 64 x 64 fragment x (split_a: rows 16w + l/4
// (+ 8), columns 8i + 2(l % 4) + {0, 1}) stored as three 64-row planes of
// 128-byte rows DS_PLANE apart, with the 128-byte swizzle of a TMA box
// (16-byte chunk c of row r at chunk c ^ (r % 8)), so that wgmma reads the
// tile K-major as A (rows M) or MN-major (columns M).  A warp's 32 stores
// hit 8 rows in 8 different chunks: 32 banks.
__device__ __forceinline__ void stage_terms(const float (&x)[32],
                                            uint8_t* ds, int warp,
                                            int lane) {
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t h[4], m[4], l[4];
    split_a(x, kk, h, m, l);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // h[r]: row r0 + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2 (l % 4)
      const int off = (r0 + 8 * (r & 1)) * PANEL_ROW +
                      (((2 * kk + (r >> 1)) ^ (lane / 4)) << 4) +
                      4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(ds + off) = h[r];
      *reinterpret_cast<uint32_t*>(ds + DS_PLANE + off) = m[r];
      *reinterpret_cast<uint32_t*>(ds + 2 * DS_PLANE + off) = l[r];
    }
  }
}

// d (+)= A . B over k16 step kk, A the plane `a` of the staged dS tile read
// K-major (TA 0: dS^T, keys as M) or MN-major (TA 1: dS, queries as M), B
// MN-major (descriptor db)
template <int TA>
__device__ __forceinline__ void ds_mma(float (&d)[32], const uint8_t* a,
                                       int kk, uint64_t db, int scale_d) {
  if constexpr (TA == 0)
    wgmma_ss_mn(d, desc_k(a, kk), db, scale_d);
  else
    wgmma_ss_tt(d, desc_mn(a, kk, DS_PLANE), db, scale_d);
}

// A . B where A is the staged 64 x 64 dS tile's three planes (`a`, read as
// ds_mma<TA> reads them) and B a 64-row tile's three planes read MN-major
// (`b`, planes `b_plane` apart, 64-column panels TILE * PANEL_ROW apart).
// For each of B's N / 32 panels p, the hi.hi chain and the chain of the
// five lower products, each from zero, go to sink(p, hi, lo) once
// complete.
template <int TA, int N, class Sink>
__device__ __forceinline__ void ds_product(const uint8_t* a,
                                           const uint8_t* b,
                                           uint32_t b_plane, Sink sink) {
  constexpr uint32_t PANEL = TILE * PANEL_ROW;
#pragma unroll
  for (int p = 0; p < N / 32; ++p) {
    const uint8_t* bp = b + p * PANEL;
    float th[32], tl[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ds_mma<TA>(th, a, kk, desc_mn(bp, kk, PANEL), kk > 0);
#pragma unroll
    for (int t = 0; t < 5; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ds_mma<TA>(tl, a + low_a(t) * DS_PLANE, kk,
                   desc_mn(bp + low_b(t) * b_plane, kk, PANEL), t + kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(th);
    fence_regs(tl);
    sink(p, th, tl);
  }
}

// panel p's two chains added (hi + lo) into its 32 values of the running
// sum `acc` (a fragment of N values a thread)
template <int N>
__device__ __forceinline__ void add_panel(float (&acc)[N], int p,
                                          const float (&hi)[32],
                                          const float (&lo)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[32 * p + i] += hi[i] + lo[i];
}

// One (64-key, 64-query) tile pair by consumer warpgroup c: S^T = K Q^T,
// dP^T = V dO^T, dS^T = S^T * dP^T (staged into `ds`); dv += S^T dO,
// dk += dS^T Q, and dq_sink(p, hi, lo) gets panel p of dS K (its two
// chains).  sK, sV, sQ, sO: the 64-row tiles' planes (P bytes apart).
// SERIAL waits for S^T before dP^T is issued (fewer live registers).
template <int D, bool SERIAL, class DqSink>
__device__ __forceinline__ void tile_pair(const uint8_t* sK,
                                          const uint8_t* sV,
                                          const uint8_t* sQ,
                                          const uint8_t* sO, uint8_t* ds,
                                          int c, int warp, int lane,
                                          float (&dv)[D / 2],
                                          float (&dk)[D / 2],
                                          DqSink dq_sink) {
  constexpr uint32_t P = TILE * D * 2, PANEL = TILE * PANEL_ROW;
  float st[32], stl[32], dpt[32], dptl[32];
  wgmma_fence();
  product_ss<D, TERMS>(st, stl, sK, PANEL, P, sQ, PANEL, P);
  if constexpr (SERIAL) {
    wgmma_commit();
    wgmma_wait_all();
    finish_product<TERMS>(st, stl);
    wgmma_fence();
  }
  product_ss<D, TERMS>(dpt, dptl, sV, PANEL, P, sO, PANEL, P);
  wgmma_commit();
  wgmma_wait_all();
  if constexpr (!SERIAL) finish_product<TERMS>(st, stl);
  finish_product<TERMS>(dpt, dptl);
#pragma unroll
  for (int i = 0; i < 32; ++i) dpt[i] *= st[i];   // dS^T

  stage_terms(dpt, ds, warp, lane);
  fence_async_shared();
  wg_sync(c);

  uint32_t sh[4][4], sm[4][4], sl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) split_a(st, kk, sh[kk], sm[kk], sl[kk]);
  add_split_product<4, D / 2, TERMS>(dv, sh, sm, sl, sO, PANEL, P);
  ds_product<0, D / 2>(ds, sQ, P, [&](int p, float (&hi)[32],
                                      float (&lo)[32]) {
    add_panel(dk, p, hi, lo);
  });
  ds_product<1, D / 2>(ds, sK, P, dq_sink);
}

// rows r0 and r0 + 8 of a fragment of N values a thread (columns 8i +
// col2 + {0, 1}) into the float32 rows [.., d] at `base`, masked to d
template <int N>
__device__ __forceinline__ void store_frag(float* base, int r0, int d,
                                           int col2, const float (&x)[N]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = base + (long long)(r0 + 8 * h) * d;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int col = 8 * i + col2;
      if (col < d) store2(row + col, x[4 * i + 2 * h], x[4 * i + 2 * h + 1]);
    }
  }
}

// One block per (bh, q block of block_q rows); see the header.  q, k, v and
// do are read through maps over their term planes [3 * bh, t, d].
template <int D, bool ONE>
__global__ void __launch_bounds__(BwdLayout<D, ONE>::THREADS, 1)
    skeleton_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             float* __restrict__ dq, float* __restrict__ dkp,
                             float* __restrict__ dvp, int bh, int t, int d,
                             int block_q) {
  using L = BwdLayout<D, ONE>;
  constexpr int NC = L::NC, STAGES = L::STAGES, OP = L::OP;
  constexpr bool SERIAL = !ONE && D == 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* fixed = smem;           // ONE: q, do; else K, V of a key tile
  uint8_t* stages = smem + L::FIXED;
  uint64_t* bar_fixed = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* fixed_empty = bar_fixed + 1;
  uint64_t* full = fixed_empty + 1;
  uint64_t* empty = full + STAGES;

  const int nq = t / block_q, n_sub = block_q / TILE, n_k = t / TILE;
  const int b = blockIdx.x % bh;
  const int qb = (int)(blockIdx.x / bh);
  const int q0 = qb * block_q;
  const long long part = ((long long)b * nq + qb) * t * d;

  if (threadIdx.x == 0) {
    mbar_init(bar_fixed, 1);
    mbar_init(fixed_empty, 4);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of its consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    if constexpr (NC == 2) regs_dec<PRODUCER_REGS>();
    if (lane != 0) return;
    if constexpr (ONE) {
      // warp w fills consumer w's stage with the key tiles w, w + NC, ...
      if (warp >= NC) return;
      if (warp == 0) {
        mbar_expect_tx(bar_fixed, 2 * OP);
        tma_load_planes<D, TERMS>(fixed, &tm_q, bar_fixed, q0, b, bh, TILE,
                                  1);
        tma_load_planes<D, TERMS>(fixed + OP, &tm_do, bar_fixed, q0, b, bh,
                                  TILE, 1);
      }
      uint8_t* st = stages + warp * L::STAGE;
      for (int m = 0; warp + m * NC < n_k; ++m) {
        const int j = warp + m * NC;
        if (m > 0) sm90g::wait(&empty[warp], (m - 1) & 1);
        mbar_expect_tx(&full[warp], 2 * OP);
        tma_load_planes<D, TERMS>(st, &tm_k, &full[warp], j * TILE, b, bh,
                                  TILE, 1);
        tma_load_planes<D, TERMS>(st + OP, &tm_v, &full[warp], j * TILE, b,
                                  bh, TILE, 1);
      }
    } else if (warp == 0) {
      // K's and V's planes of each key tile, once the last was released
      for (int j = 0; j < n_k; ++j) {
        if (j > 0) sm90g::wait(fixed_empty, (j - 1) & 1);
        mbar_expect_tx(bar_fixed, 2 * OP);
        tma_load_planes<D, TERMS>(fixed, &tm_k, bar_fixed, j * TILE, b, bh,
                                  TILE, 1);
        tma_load_planes<D, TERMS>(fixed + OP, &tm_v, bar_fixed, j * TILE, b,
                                  bh, TILE, 1);
      }
    } else if (warp == 1) {
      // q's and do's planes of each sub-tile, for each key tile
      for (int it = 0; it < n_k * n_sub; ++it) {
        const int s = it % STAGES, sub = it % n_sub;
        if (it >= STAGES) sm90g::wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* st = stages + s * L::STAGE;
        mbar_expect_tx(&full[s], 2 * OP);
        tma_load_planes<D, TERMS>(st, &tm_q, &full[s], q0 + sub * TILE, b,
                                  bh, TILE, 1);
        tma_load_planes<D, TERMS>(st + OP, &tm_do, &full[s], q0 + sub * TILE,
                                  b, bh, TILE, 1);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NC == 2) regs_inc<consumer_regs(PRODUCER_REGS)>();
  const int c = threadIdx.x / 128 - 1;
  const int r0 = 16 * warp + lane / 4;      // fragment rows r0, r0 + 8
  const int col2 = 2 * (lane % 4);
  uint8_t* ds = smem + L::DS_AT + c * DS_BYTES;
  if constexpr (ONE) {
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint8_t* sQ = fixed;
    const uint8_t* sO = fixed + OP;
    const uint8_t* sK = stages + c * L::STAGE;
    sm90g::wait(bar_fixed, 0);
    float dv[D / 2], dk[D / 2];
    for (int m = 0; c + m * NC < n_k; ++m) {
      const int k0 = (c + m * NC) * TILE;
      sm90g::wait(&full[c], m & 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
      tile_pair<D, SERIAL>(sK, sK + OP, sQ, sO, ds, c, warp, lane, dv, dk,
                           [&](int p, float (&hi)[32], float (&lo)[32]) {
                             add_panel(dq_acc, p, hi, lo);
                           });
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c]);
      // the partials of (q block, key tile), stored once, while the
      // stage refills
      store_frag(dvp + part + (long long)k0 * d, r0, d, col2, dv);
      store_frag(dkp + part + (long long)k0 * d, r0, d, col2, dk);
    }
    if constexpr (NC == 2) {
      // dq = warpgroup 0's sum + warpgroup 1's, through warpgroup 1's
      // stage (its last tile consumed), each thread its own slots
      float* xch = reinterpret_cast<float*>(stages + L::STAGE);
      const int tid = threadIdx.x % 128;
      if (c == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xch[i * 128 + tid] = dq_acc[i];
      }
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      if (c == 1) return;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] += xch[i * 128 + tid];
    }
    store_frag(dq + ((long long)b * t + q0) * d, r0, d, col2, dq_acc);
  } else {
    const uint8_t* sK = fixed;
    const uint8_t* sV = fixed + OP;
    float dv[D / 2], dk[D / 2];
    for (int j = 0; j < n_k; ++j) {
      sm90g::wait(bar_fixed, j & 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
      for (int sub = 0; sub < n_sub; ++sub) {
        const int it = j * n_sub + sub, s = it % STAGES;
        sm90g::wait(&full[s], (it / STAGES) & 1);
        const uint8_t* sQ = stages + s * L::STAGE;
        float* dq_rows = dq + ((long long)b * t + q0 + sub * TILE) * d;
        tile_pair<D, SERIAL>(
            sK, sV, sQ, sQ + OP, ds, c, warp, lane, dv, dk,
            [&](int p, float (&hi)[32], float (&lo)[32]) {
              // this sub-tile's dq, panel p: stored at the first key
              // tile, then added to in key-tile order by the same thread
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float* row = dq_rows + (long long)(r0 + 8 * h) * d;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const int col = 64 * p + 8 * i + col2;
                  if (col >= d) continue;
                  float x0 = hi[4 * i + 2 * h] + lo[4 * i + 2 * h];
                  float x1 = hi[4 * i + 2 * h + 1] + lo[4 * i + 2 * h + 1];
                  if (j > 0) {
                    const float2 old =
                        *reinterpret_cast<const float2*>(row + col);
                    x0 = old.x + x0;
                    x1 = old.y + x1;
                  }
                  store2(row + col, x0, x1);
                }
              }
            });
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(fixed_empty);
      store_frag(dvp + part + (long long)j * TILE * d, r0, d, col2, dv);
      store_frag(dkp + part + (long long)j * TILE * d, r0, d, col2, dk);
    }
  }
}

template <class K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const __nv_bfloat16* qp, const __nv_bfloat16* kp,
               const __nv_bfloat16* vp, float* o, int bh, int t, int d,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_rows(&mq, qp, TERMS * bh, t, d);
  if (err == 0) err = encode_rows(&mk, kp, TERMS * bh, t, d);
  if (err == 0) err = encode_rows(&mv, vp, TERMS * bh, t, d);
  if (err == 0)
    err = allow_smem(skeleton_fwd_sm90_kernel<D>, FwdLayout<D>::BYTES);
  if (err != 0) return err;
  const long long blocks = (long long)bh * ((t + FWD_BQ - 1) / FWD_BQ);
  skeleton_fwd_sm90_kernel<D>
      <<<(unsigned)blocks, FWD_THREADS, FwdLayout<D>::BYTES, stream>>>(
          mq, mk, mv, o, bh, t, d);
  return (int)cudaGetLastError();
}

template <int D, bool ONE>
int launch_bwd(const __nv_bfloat16* qp, const __nv_bfloat16* kp,
               const __nv_bfloat16* vp, const __nv_bfloat16* dop, float* dq,
               float* dkp, float* dvp, int bh, int t, int d, int block_q,
               cudaStream_t stream) {
  using L = BwdLayout<D, ONE>;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_rows(&mq, qp, TERMS * bh, t, d);
  if (err == 0) err = encode_rows(&mk, kp, TERMS * bh, t, d);
  if (err == 0) err = encode_rows(&mv, vp, TERMS * bh, t, d);
  if (err == 0) err = encode_rows(&mdo, dop, TERMS * bh, t, d);
  if (err == 0)
    err = allow_smem(skeleton_bwd_sm90_kernel<D, ONE>, L::BYTES);
  if (err != 0) return err;
  const long long blocks = (long long)bh * (t / block_q);
  skeleton_bwd_sm90_kernel<D, ONE>
      <<<(unsigned)blocks, L::THREADS, L::BYTES, stream>>>(
          mq, mk, mv, mdo, dq, dkp, dvp, bh, t, d, block_q);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int t, int d, const void* planes) {
  return bh <= 0 || t <= 0 || t % TILE || d <= 0 || d > 128 || d % 8 ||
         planes == nullptr || (reinterpret_cast<uintptr_t>(planes) & 15) ||
         (long long)bh * (t / TILE) > INT_MAX;
}

// the float32 operands' term planes, one after another in `planes`
int split_all(const void* const* x, int n, __nv_bfloat16* planes,
              long long count, cudaStream_t s) {
  for (int i = 0; i < n; ++i) {
    const int err = split_planes(static_cast<const float*>(x[i]),
                                 planes + 3 * count * i, count, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// o [bh, t, d] = (q . k^T) . v for q, k, v [bh, t, d]; float32, contiguous,
// on the device; t a multiple of 64, d a multiple of 8 up to 128.  planes:
// scratch of 3 * 3 * bh * t * d bf16 values (16-byte aligned) that the
// caller allocates, for the split pass.  Launches on `stream`; returns 0,
// a cudaError_t, or sm90::TENSOR_MAP_ERROR + the CUresult.
int paddle_tpu_torch_attn_skeleton_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* planes,
                                       int bh, int t, int d, void* stream) {
  if (bad_shape(bh, t, d, planes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)bh * t * d;
  __nv_bfloat16* p = static_cast<__nv_bfloat16*>(planes);
  const void* x[3] = {q, k, v};
  const int err = split_all(x, 3, p, n, s);
  if (err != 0) return err;
  float* of = static_cast<float*>(o);
  if (d <= 64) return launch_fwd<64>(p, p + 3 * n, p + 6 * n, of, bh, t, d, s);
  return launch_fwd<128>(p, p + 3 * n, p + 6 * n, of, bh, t, d, s);
}

// dq [bh, t, d], dkp and dvp [bh, t / block_q, t, d] from q, k, v, do
// [bh, t, d]; float32, contiguous, on the device; t and d as for the
// forward, block_q a multiple of 64 dividing t.  planes: scratch of
// 3 * 4 * bh * t * d bf16 values (16-byte aligned).  Returns as the forward.
int paddle_tpu_torch_attn_skeleton_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       void* dq, void* dkp, void* dvp,
                                       void* planes, int bh, int t, int d,
                                       int block_q, void* stream) {
  if (bad_shape(bh, t, d, planes) || block_q <= 0 || block_q % TILE ||
      t % block_q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)bh * t * d;
  __nv_bfloat16* p = static_cast<__nv_bfloat16*>(planes);
  const void* x[4] = {q, k, v, dout};
  const int err = split_all(x, 4, p, n, s);
  if (err != 0) return err;
  float* a = static_cast<float*>(dq);
  float* bk = static_cast<float*>(dkp);
  float* bv = static_cast<float*>(dvp);
  const __nv_bfloat16 *qp = p, *kp = p + 3 * n, *vp = p + 6 * n,
                      *op = p + 9 * n;
  if (block_q == TILE) {
    if (d <= 64)
      return launch_bwd<64, true>(qp, kp, vp, op, a, bk, bv, bh, t, d,
                                  block_q, s);
    return launch_bwd<128, true>(qp, kp, vp, op, a, bk, bv, bh, t, d,
                                 block_q, s);
  }
  if (d <= 64)
    return launch_bwd<64, false>(qp, kp, vp, op, a, bk, bv, bh, t, d,
                                 block_q, s);
  return launch_bwd<128, false>(qp, kp, vp, op, a, bk, bv, bh, t, d, block_q,
                                s);
}

// The dynamic shared memory a block takes at head dim d (what ptxas -v does
// not report): the forward (which 0), the backward at block_q 64 (which 1)
// or at a larger block_q (which 2).
int paddle_tpu_torch_attn_skeleton_smem(int d, int which) {
  if (which == 0)
    return d <= 64 ? FwdLayout<64>::BYTES : FwdLayout<128>::BYTES;
  if (which == 1)
    return d <= 64 ? BwdLayout<64, true>::BYTES : BwdLayout<128, true>::BYTES;
  return d <= 64 ? BwdLayout<64, false>::BYTES : BwdLayout<128, false>::BYTES;
}

}  // extern "C"
