// Flash-attention forward for Hopper (sm_90a): TMA-fed, warp-specialized,
// bf16 wgmma with float32 sums, for bf16 (AMP) and float32 q, k, v.
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/flash_attention.py
// _flash_fwd_pallas (:179, pallas_call :227, body _fwd_kernel :114).  It
// computes what paddle_tpu's _flash_fwd returns:
//
//   o   = softmax(q . k^T * sm_scale + bias, causal end-aligned) . v
//   lse = m + log(l)                                   (float32, [bh, Tq])
//
// with o in the operands' dtype, rounded once from its float32 sum.  Masked
// scores are NEG_INF = -1e30 (not -inf), the causal rule q + (Tk - Tq) >=
// k, keys past Tk weigh exactly 0 (-inf), and l == 0 reads as 1: a row
// whose every score is -inf gives o = 0, lse = NEG_INF; a row that sees no
// key (causal, Tq > Tk) averages v over the keys, as the reference does.
//
// Arithmetic.  bf16 operands (T = 1 term plane): S = q . k^T is a bf16
// wgmma with float32 sums; the product of two bf16 values is exact in
// float32, so S is the TPU kernel's float32 product (:144-163) up to the
// order of the sums.  float32 operands (T = 3): a split pass in this
// source first writes each of q, k and v as three bf16 term planes (hi,
// mid, lo; sm90.cuh), which hold it exactly, and every product is issued
// as the six bf16 products of weight 2^-16 and above: S = q . k^T is
// float32-exact up to ~2^-24 of sum |q||k| and the order of the sums, on
// the tensor cores.  Either way sm_scale multiplies the float32 S (the
// plain version folds it into q; the two differ by a float32 rounding);
// the optional float32 bias is added to S in float32; P = expf(S - m), as
// the plain version computes it.  P is float32 and is split into its three
// bf16 terms in registers, and O += P . V is issued three times (bf16 V)
// or six times (V's three planes).  The tensor cores' float32 sums
// truncate, and a chain of them drifts toward zero (on an H100, one
// accumulator carried over every tile left 0.4% of a bf16 o at [24, 2048,
// 64] on the other bf16 neighbour of the plain version's, two thirds of
// them toward zero), so each tile's product starts from zero in two short
// chains, the hi terms' and the lower terms', and joins O by float32 adds:
// O is the float32 P . V up to the order of the sums.  Ring attention
// rounds and merges one partial o a ring step and is held value by value
// to its plain version (chip_smoke.py ring_kernel); two terms (hi + lo,
// ~2^-18 of P) or one long chain failed that check.
//
// Design:
//  - one block (384 threads) per (bh, 128-row q tile), all on gridDim.x
//    (bh * tiles blocks), the heaviest causal tiles (the last ones) first;
//  - warpgroup 0 is the producer: one thread issues TMA for the q tile (its
//    T planes) once, then for K and V tiles of BKV keys into a ring of
//    stages, each with a full and an empty mbarrier; it gives up registers
//    (setmaxnreg 40);
//  - warpgroups 1 and 2 consume, 64 query rows each (setmaxnreg 232).  Per
//    K/V tile: S = Q K^T by m64nBKVk16 wgmma (A = Q, B = K, both K-major in
//    shared memory; T = 3: a chain of the hi products and one of the five
//    lower ones); the online softmax on the accumulator fragment (quad
//    shuffles for the row max, per-thread row sums reduced once at the
//    end); P split into its three bf16 terms, laid out from the accumulator
//    straight into the register-A fragment; O += P . V by m64n64k16 wgmma
//    (one 64-column panel of V at a time, fresh accumulators each tile)
//    with A from registers and B = V read MN-major (transposed) from shared
//    memory;
//  - masks run only on diagonal and ragged tiles; tiles above the causal
//    diagonal are not loaded;
//  - the head dim is padded to 64 or 128 in shared memory: TMA fills zeros
//    past d (and past Tq and Tk rows) and the stores are masked to d.
//  - tiles: bf16 BKV 128 keys in 2 stages; float32 (three planes of every
//    tile) BKV 64 in 2 stages at d <= 64 and in 1 stage at d <= 128, to fit
//    the 227 KB a block may hold.
//
// What bounds it on an H100 (989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s): at [96, 2048, 64] causal the live triangle is 51.6 GFLOP (4 d per
// pair), 0.052 ms in bf16, against 101 MB of q, k, v, o and lse (bf16),
// 0.030 ms: the tensor cores bound it.  bf16 issues 2x the counted
// operations (P . V three times).  float32 issues every product six times,
// so its float32-exact rate is 989 / 6 = 164.8 TFLOP/s and its bound 0.313
// ms (202 MB, 0.060 ms, plus the split pass's 377 MB of planes); the
// CUDA-core rate (67 TFLOP/s) would give 0.770 ms.  This first design
// waits for each wgmma group before the softmax and does not overlap the
// two (later work: intra-warpgroup pipelining, persistent blocks).
//
// Budget (ptxas -v on sm_90a; chip_smoke.py's kernel phase prints each
// form's lines and shared memory): 168 registers a thread at launch (384
// threads, one block an SM), then 40 for the producer and 232 for the
// consumers.  bf16: no spills at d <= 64, 48 bytes at d <= 128 (O, the
// panel's two fresh accumulators and the 96 registers of P's terms);
// 83,008 bytes of shared memory a block at d <= 64 (q 16 KB, 2 stages of K
// and V 64 KB), 164,928 at d <= 128.  float32: no spills; 148,544 bytes
// at d <= 64 (q's planes 48 KB, 2 stages of K's and V's planes 96 KB),
// 197,696 at d <= 128.

#include <climits>
#include <math_constants.h>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;         // query rows a block: 2 warpgroups x 64
constexpr int THREADS = 384;
constexpr float NEG_INF = -1e30f;

// the tiles of the bf16 (T = 1) and float32 (T = 3 term planes) forms
template <int D, int T>
struct Layout {
  static constexpr int BKV = T == 1 ? 128 : 64;     // keys a K/V tile
  static constexpr int STAGES = T == 3 && D == 128 ? 1 : 2;
  static constexpr int QP = BQ * D * 2;       // a plane of the q tile
  static constexpr int KVP = BKV * D * 2;     // a plane of a K or V tile
  static constexpr int Q = T * QP;
  static constexpr int KV = T * KVP;          // K's (or V's) planes
  static constexpr int BARS = Q + STAGES * 2 * KV;
  static constexpr int BYTES = BARS + 64 + 1024;  // + barriers, alignment
};

// q, k, v are read through the maps tm_q, tm_k, tm_v, over [T * bh, t, d]
// bf16 (plane p of sequence b at leading index b + p * bh)
template <int D, int T>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
    std::conditional_t<T == 1, __nv_bfloat16, float>* __restrict__ o,
    float* __restrict__ lse, int bh, int tq, int tk, int d,
    long long bias_stride, float sm_scale, int causal) {
  using L = Layout<D, T>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::Q;   // stage s: K at s * 2 * KV, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int n_qt = (tq + BQ - 1) / BQ;
  const int b = blockIdx.x % bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh)) * BQ;
  const int offset = tk - tq;
  // keys this q tile can see.  A tile holding a row with no live key at all
  // (causal with Tq > Tk) walks every tile, masked, as the reference does.
  int k_end = tk;
  if (causal && q0 + offset >= 0)
    k_end = min(tk, min(q0 + BQ, tq) - 1 + offset + 1);
  const int n_kv = (k_end + BKV - 1) / BKV;

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
    regs_dealloc();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q);
      tma_load_planes<D, T>(sQ, &tm_q, bar_q, q0, b, bh, BQ, BQ / BOX);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* sK = sKV + s * 2 * L::KV;
        mbar_expect_tx(&full[s], 2 * L::KV);
        tma_load_planes<D, T>(sK, &tm_k, &full[s], j * BKV, b, bh, BKV,
                              BKV / BOX);
        tma_load_planes<D, T>(sK + L::KV, &tm_v, &full[s], j * BKV, b, bh,
                              BKV, BKV / BOX);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    regs_alloc();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int q0w = q0 + 64 * c;
    const int row0 = q0w + 16 * warp + lane / 4;  // and row0 + 8
    const int col2 = 2 * (lane % 4);
    const uint8_t* qrows = sQ + 64 * c * PANEL_ROW;
    const float* bb = bias ? bias + (long long)b * bias_stride : nullptr;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint8_t* sK = sKV + s * 2 * L::KV;
      const uint8_t* sV = sK + L::KV;

      float x[BKV / 2], xl[BKV / 2];            // S, then P: 64 x BKV
      wgmma_fence();
      product_ss<D, T>(x, xl, qrows, BQ * PANEL_ROW, L::QP, sK,
                       BKV * PANEL_ROW, L::KVP);
      wgmma_commit();
      wgmma_wait_all();
      finish_product<T>(x, xl);

      const int k0 = j * BKV;
      // mask-free unless the tile is ragged or crosses the diagonal of the
      // warpgroup's first row (whose causal limit is the smallest)
      const bool masked =
          k0 + BKV > tk || (causal && k0 + BKV - 1 > q0w + offset);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e >> 1);
          const int kc = k0 + 8 * i + col2 + (e & 1);
          float v = x[4 * i + e] * sm_scale;
          if (bb != nullptr && r < tq && kc < tk)
            v += bb[(long long)r * tk + kc];
          if (masked) {
            if (kc >= tk)
              v = -CUDART_INF_F;        // past the keys: weight exactly 0
            else if (causal && r + offset < kc)
              v = NEG_INF;
          }
          x[4 * i + e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const float p = expf(x[i] - m[(i >> 1) & 1]);
        x[i] = p;
        l[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      uint32_t ph[BKV / 16][4], pm[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        split_a(x, kk, ph[kk], pm[kk], pl[kk]);
      add_split_product<BKV / 16, D / 2, T>(acc, ph, pm, pl, sV,
                                            BKV * PANEL_ROW, L::KVP);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    float ls[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      ls[h] = l[h] == 0.f ? 1.f : l[h];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= tq) continue;
      auto* orow = o + ((long long)b * tq + r) * d;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + col2;
        if (col < d)
          store2(orow + col, acc[4 * i + 2 * h] / ls[h],
                 acc[4 * i + 2 * h + 1] / ls[h]);
      }
      if (lane % 4 == 0) lse[(long long)b * tq + r] = m[h] + logf(ls[h]);
    }
  }
}

// q, k, v: bf16 [bh, t, d] (T = 1) or their term planes [3 * bh, t, d]
template <int D, int T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int bh, int tq, int tk, int d,
           long long bias_stride, float sm_scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_rows(&mq, q, T * bh, tq, d);
  if (err == 0) err = encode_rows(&mk, k, T * bh, tk, d);
  if (err == 0) err = encode_rows(&mv, v, T * bh, tk, d);
  if (err != 0) return err;
  const int smem = Layout<D, T>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  using Out = std::conditional_t<T == 1, __nv_bfloat16, float>;
  const long long blocks = (long long)bh * ((tq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<D, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      mq, mk, mv, bias, static_cast<Out*>(o), lse, bh, tq, tk, d,
      bias_stride, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  q [bh,tq,d], k/v [bh,tk,d] and
// o [bh,tq,d] of one dtype, bf16 (f32 0) or float32 (f32 1); bias [bh or
// 1, tq, tk] float32 or null (bias_stride = tq*tk per bh, or 0 for a shared
// plane), lse [bh,tq] float32; all contiguous on the device, d a multiple of
// 8 up to 128.  bf16 q, k, v are read by TMA and must be 16-byte aligned.
// float32 ones are first split into term planes in `planes`, scratch of
// 3 * (bh*tq + 2*bh*tk) * d bf16 values (16-byte aligned) that the caller
// allocates (null for bf16).  Launches on `stream`; returns 0, the
// cudaError_t of a launch, or sm90::TENSOR_MAP_ERROR + the CUresult when a
// TMA map cannot be made.
extern "C" int paddle_tpu_torch_flash_attn_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, void* planes, int bh, int tq, int tk, int d,
    long long bias_stride, float sm_scale, int causal, int f32,
    void* stream) {
  const uintptr_t tma = f32 ? reinterpret_cast<uintptr_t>(planes)
                            : (reinterpret_cast<uintptr_t>(q) |
                               reinterpret_cast<uintptr_t>(k) |
                               reinterpret_cast<uintptr_t>(v));
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
      (long long)bh * ((tq + BQ - 1) / BQ) > INT_MAX || (f32 && !planes) ||
      (tma & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(bias);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32) {
    if (d <= 64)
      return launch<64, 1>(q, k, v, bf, o, lf, bh, tq, tk, d, bias_stride,
                           sm_scale, causal, s);
    return launch<128, 1>(q, k, v, bf, o, lf, bh, tq, tk, d, bias_stride,
                          sm_scale, causal, s);
  }
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* kp = qp + 3LL * bh * tq * d;
  __nv_bfloat16* vp = kp + 3LL * bh * tk * d;
  int err = split_planes(static_cast<const float*>(q), qp,
                         (long long)bh * tq * d, s);
  if (err == 0)
    err = split_planes(static_cast<const float*>(k), kp,
                       (long long)bh * tk * d, s);
  if (err == 0)
    err = split_planes(static_cast<const float*>(v), vp,
                       (long long)bh * tk * d, s);
  if (err != 0) return err;
  if (d <= 64)
    return launch<64, 3>(qp, kp, vp, bf, o, lf, bh, tq, tk, d, bias_stride,
                         sm_scale, causal, s);
  return launch<128, 3>(qp, kp, vp, bf, o, lf, bh, tq, tk, d, bias_stride,
                        sm_scale, causal, s);
}

// The dynamic shared memory a block of the kernel takes at head dim d, for
// bf16 (f32 0) or float32 (f32 1) operands (what ptxas -v does not report).
extern "C" int paddle_tpu_torch_flash_attn_fwd_sm90_smem(int d, int f32) {
  if (f32) return d <= 64 ? Layout<64, 3>::BYTES : Layout<128, 3>::BYTES;
  return d <= 64 ? Layout<64, 1>::BYTES : Layout<128, 1>::BYTES;
}
