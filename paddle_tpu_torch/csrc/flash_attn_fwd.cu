// Flash-attention forward for Hopper (sm_90a): float32 operands and
// arithmetic.  (bf16 operands go to flash_attn_fwd_sm90.cu.)
//
// Replaces the Pallas TPU kernel paddle_tpu/pallas/flash_attention.py
// _flash_fwd_pallas (:179, pallas_call :227, body _fwd_kernel :114).  It
// computes exactly what paddle_tpu's _flash_fwd returns:
//
//   o   = softmax(q * sm_scale . k^T + bias, causal end-aligned) . v
//   lse = m + log(l)                                   (float32, [bh, Tq])
//
// for float32 q, k, v, o and lse: the products, p and the accumulation are
// float32, as in the TPU kernel's body (:144-163).  Masked
// scores are NEG_INF = -1e30 (not -inf), the causal rule
// q + (Tk - Tq) >= k, and l == 0 read as 1 (a row whose every score is -inf
// gives o = 0, lse = m).  Keys past Tk contribute nothing.
//
// Design (simple and right first):
//  - one thread block per (bh, 64-row q tile); a loop inside the block walks
//    the 64-key tiles in order with an online softmax.  This loop replaces
//    the TPU's sequential ik grid axis and its VMEM carry.
//  - causal tiles wholly above the diagonal are skipped; masks run only on
//    diagonal and ragged tiles (the rule of _block_dispatch :76-111).
//  - Q, K, V and the P tile sit in shared memory (padded rows keep the
//    loads free of bank conflicts); all arithmetic is float32 on
//    the CUDA cores.  At d = 64 the block needs 66 KB and at d = 128 113 KB, so the
//    dynamic shared-memory limit is raised before each launch.
//
// What bounds it on an H100: at the serving shape [96, 2048, 64] causal the
// live triangle is 51.6 GFLOP against 202 MB of q/k/v/o/lse, so the float32
// CUDA-core rate (67 TFLOP/s, 0.77 ms) bounds it, not memory (0.06 ms).  The
// inner loops issue one shared-memory load per two FMAs, so shared-memory
// bandwidth, not the FMA rate, is what this simple version runs into.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;          // threads along keys and along the head dim
constexpr int TY = 16;          // threads along query rows
constexpr int RPT = BQ / TY;    // query rows per thread
constexpr int CPT = BK / TX;    // key columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float row_max16(float x) {
  // the 16 threads sharing a row are one half of a warp
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NJ = ceil(d / 16): head-dim columns of o each thread accumulates
template <int NJ>
__global__ void __launch_bounds__(TX * TY)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int tq, int tk,
                 int d, long long bias_stride, float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = d + 1;        // odd strides: conflict-free column reads
  const int ldk = d + 1;
  const int ldv = NJ * TX;      // zero-padded to the thread tiling
  const int ldp = BK + 1;
  float* sQ = smem;                   // [BQ][ldq], pre-scaled by sm_scale
  float* sK = sQ + BQ * ldq;          // [BK][ldk]
  float* sV = sK + BK * ldk;          // [BK][ldv]
  float* sP = sV + BK * ldv;          // [BQ][ldp]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bh = blockIdx.x;
  // the last q tiles carry the most causal work: start them first (blocks
  // are issued x-fastest, so the first wave holds every bh at that tile)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = tk - tq;

  const float* qb = q + (long long)bh * tq * d;
  const float* kb = k + (long long)bh * tk * d;
  const float* vb = v + (long long)bh * tk * d;
  const float* bb = bias ? bias + (long long)bh * bias_stride : nullptr;

  for (int idx = tid; idx < BQ * d; idx += TX * TY) {
    const int r = idx / d, c = idx - r * d;
    const int qr = q0 + r;
    sQ[r * ldq + c] =
        qr < tq ? qb[(long long)qr * d + c] * sm_scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // keys this q tile can see.  A tile holding a row with no live key at
  // all (causal with Tq > Tk) walks every tile, masked, as the reference
  // does: such a row averages v over the keys.
  int k_end = tk;
  if (causal && q0 + offset >= 0) {
    const int q_last = min(q0 + BQ, tq) - 1;
    k_end = min(tk, q_last + offset + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();            // the previous tile's sK/sV/sP are consumed
    for (int idx = tid; idx < BK * ldv; idx += TX * TY) {
      const int r = idx / ldv, c = idx - r * ldv;
      const int kr = k0 + r;
      const bool in = kr < tk && c < d;
      if (c < d) sK[r * ldk + c] = in ? kb[(long long)kr * d + c] : 0.f;
      sV[r * ldv + c] = in ? vb[(long long)kr * d + c] : 0.f;
    }
    __syncthreads();

    // mask-free unless the tile is ragged or crosses the diagonal of the
    // tile's first row (whose causal limit is the smallest)
    const bool masked = (k0 + BK > tk) || (causal && k0 + BK - 1 > q0 + offset);

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * ldq + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + j * TX) * ldk + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int qr = q0 + r;
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kr = k0 + tx + j * TX;
        float x = s[i][j];
        if (bb != nullptr && qr < tq && kr < tk)
          x += bb[(long long)qr * tk + kr];
        if (masked) {
          if (kr >= tk)
            x = -CUDART_INF_F;          // past the keys: weight exactly 0
          else if (causal && qr + offset < kr)
            x = NEG_INF;
        }
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = row_max16(mc);
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[r * ldp + tx + j * TX] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, tk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * ldv + tx + j * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + ty * RPT + i;
    if (qr >= tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + ((long long)bh * tq + qr) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + j * TX;
      if (col < d) orow[col] = acc[i][j] / ls;
    }
    if (tx == 0) lse[(long long)bh * tq + qr] = m[i] + logf(ls);
  }
}

template <int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* lse, int bh, int tq,
                   int tk, int d, long long bias_stride, float sm_scale,
                   int causal, cudaStream_t stream) {
  const int ldv = NJ * TX;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) +
                       (size_t)BK * ldv + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BQ - 1) / BQ);
  const dim3 block(TX, TY);
  flash_fwd_kernel<NJ><<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, tq, tk, d,
      bias_stride, sm_scale, causal);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int bh, int tq, int tk, int d,
             long long bias_stride, float sm_scale, int causal,
             cudaStream_t s) {
  switch ((d + TX - 1) / TX) {
    case 1: return (int)launch<1>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 2: return (int)launch<2>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 3: return (int)launch<3>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 4: return (int)launch<4>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 5: return (int)launch<5>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 6: return (int)launch<6>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 7: return (int)launch<7>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    case 8: return (int)launch<8>(q, k, v, bias, o, lse, bh, tq, tk, d, bias_stride, sm_scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q [bh,tq,d], k/v [bh,tk,d] and
// o [bh,tq,d] float32 (bf16 operands go to flash_attn_fwd_sm90.cu); bias
// [bh or 1, tq, tk] float32 or null (bias_stride = tq*tk per bh, or 0 for a
// shared plane), lse [bh,tq] float32; all contiguous, on the device.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int paddle_tpu_torch_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int bh, int tq, int tk, int d, long long bias_stride,
    float sm_scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, static_cast<const float*>(bias), o,
                  static_cast<float*>(lse), bh, tq, tk, d, bias_stride,
                  sm_scale, causal, static_cast<cudaStream_t>(stream));
}
