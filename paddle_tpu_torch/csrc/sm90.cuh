// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attn_fwd_sm90.cu, flash_attn_bwd_sm90.cu), the attention skeletons
// (attn_skeleton_sm90.cu) and the GEMM core (sm90_gemm.cuh), in raw PTX:
// mbarriers, TMA tile loads, wgmma descriptors and the wgmma shapes the
// kernels issue, the exact three-term bf16 split of a float32 operand (in
// registers as wgmma's A fragments, or in device memory as three bf16
// planes that TMA loads like any bf16 tile) and the products over those
// terms, and the host-side TMA tensor map of a [n, t, d] bf16 tensor.
//
// Term planes.  The kernels take bf16 operands as they are (T = 1 term
// plane) and float32 operands as three planes, hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), which hold x exactly (24 significant bits,
// 8 a term).  A product of two split operands is issued as the six bf16
// products of weight 2^-16 and above; the three dropped (mid.lo, lo.mid,
// lo.lo) are at most ~2^-24 of the product, below float32's own rounding.
//
// Shared-memory tiles.  A tile of R rows and a head dim padded to D (64 or
// 128) is kept as D / 64 column panels of R rows x 64 bf16 (128 bytes a
// row), each filled by TMA with the 128-byte swizzle in boxes of 64 x 64
// (8 KB); panels and boxes start on 1024-byte boundaries, where the
// swizzle pattern repeats, and a split operand's T planes of a tile follow
// one another.  wgmma reads such a panel:
//  - K-major (the reduction runs along the row): 8-row groups 1024 bytes
//    apart (SBO), k16 steps 32 bytes apart inside the 128-byte row;
//  - MN-major (the reduction runs down the rows, transposed B): 16-row k
//    steps 2048 bytes apart, 8-row groups 1024 bytes apart (SBO), the next
//    64 columns one panel further (LBO).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BOX = 64;                  // TMA box: 64 rows x 64 columns
constexpr int PANEL_ROW = 128;           // bytes a panel row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more transactions for this phase to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// --- TMA ------------------------------------------------------------------

// box (c0 columns, c1 rows, c2 the leading index) of a 3-d tensor map into
// shared memory; completes `bytes` transactions on `bar`.  Elements past
// the tensor's edges arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [row0, row0 + 64 * nbox) of the tile of `map` at leading index `n`,
// all D / 64 panels, into a tile of `rows` rows at `dst`
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int n, int rows, int nbox) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    for (int b = 0; b < nbox; ++b)
      tma_load_3d(dst + p * rows * PANEL_ROW + b * BOX * PANEL_ROW, map, bar,
                  p * 64, row0 + b * BOX, n);
}

// the T term planes of the tile at leading index `n` of a map over the
// planes of `nlead` leading indices each (plane p at n + p * nlead), as
// tma_load_tile loads one, into T tiles of `rows` rows one after another
template <int D, int T>
__device__ __forceinline__ void tma_load_planes(uint8_t* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int row0,
                                                int n, int nlead, int rows,
                                                int nbox) {
#pragma unroll
  for (int p = 0; p < T; ++p)
    tma_load_tile<D>(dst + p * rows * D * 2, map, bar, row0, n + p * nlead,
                     rows, nbox);
}

// --- wgmma ----------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `addr` (shared), with the
// leading and stride byte offsets `lbo`, `sbo`
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K-major operand: 64 (A) or N (B) rows of a panel, the k16 step `kk` (0-3)
__device__ __forceinline__ uint64_t desc_k(const uint8_t* panel_rows,
                                           int kk) {
  return desc(smem_u32(panel_rows) + kk * 32, 16, 1024);
}

// MN-major B: k16 step `kk` down the rows of a tile whose panels are
// `panel_bytes` apart
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk,
                                            uint32_t panel_bytes) {
  return desc(smem_u32(tile) + kk * 16 * PANEL_ROW, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x = hi + mid + lo exactly: the three bf16 terms of a float32 value (24
// significant bits, 8 a term; each remainder is exact in float32), packed
// as the register-A fragments of k16 step kk of the m64 x (16 * steps)
// operand x.  x is laid out as the float32 accumulator of an m64nN product:
// thread (warp w, lane l) holds rows 16w + l/4 (+8) and columns 8i +
// 2(l%4) + {0, 1} as x[4i + {0, 1}] (+ {2, 3} for row + 8), which is the
// layout of the A registers a0-a7 for columns 16kk...16kk+15.  Values below
// ~2^-100 lose their last bits to bf16's exponent range, far below any sum
// they join.
template <int N>
__device__ __forceinline__ void split_a(const float (&x)[N], int kk,
                                        uint32_t (&hi)[4],
                                        uint32_t (&mid)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float ra = a - __low2float(h), rb = b - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
    const __nv_bfloat162 t = __floats2bfloat162_rn(ra - __low2float(m),
                                                   rb - __high2float(m));
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    mid[r] = *reinterpret_cast<const uint32_t*>(&m);
    lo[r] = *reinterpret_cast<const uint32_t*>(&t);
  }
}

__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// --- the wgmma shapes (m64, k16, bf16 operands, float32 sums) -------------

// d[32] (+)= A . B over k16: A [64 x 16] and B [64 x 16], both
// K-major in shared memory (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] (+)= A . B over k16: A [64 x 16] and B [128 x 16], both
// K-major in shared memory (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A . B over k16: A [64 x 16] bf16 in registers (split_a),
// B [16 x 64] MN-major in shared memory (descriptor db, transposed);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d[32] (+)= A . B over k16: A [16 x 64] and B [16 x 64], both MN-major in
// shared memory (transposed; descriptors of desc_mn's form); scale_d 0
// overwrites d.  The attention skeleton's dq = dS . K reads dS from the
// tile it staged with keys as rows.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}


// The terms of the five lower products of two split operands, by weight:
// 2^-8 (hi.mid, mid.hi), then 2^-16 (hi.lo, mid.mid, lo.hi); t = 0..4
__device__ __forceinline__ constexpr int low_a(int t) {
  return t == 1 || t == 3 ? 1 : t == 4 ? 2 : 0;
}
__device__ __forceinline__ constexpr int low_b(int t) {
  return t == 0 || t == 3 ? 1 : t == 2 ? 2 : 0;
}

// hi (and lo) = A . B^T over a reduction of D columns (D / 64 panels x 4
// k16 steps), A and B K-major in shared memory: `a` is the warpgroup's 64
// rows in the first panel of A's first term plane, A's panels `a_panel`
// bytes apart and its planes `a_plane` apart; likewise `b`.  With T = 1
// (bf16 operands) one chain into hi.  With T = 3 (split float32 operands)
// hi = A_hi . B_hi and lo = the five lower products, each chain from zero
// (the tensor cores' float32 sums truncate, so no small term is added into
// the large chain); the caller adds lo into hi (finish_product).  Issues
// the wgmmas only: the caller fences, commits and waits.
template <int D, int T, int N>
__device__ __forceinline__ void product_ss(float (&hi)[N], float (&lo)[N],
                                           const uint8_t* a,
                                           uint32_t a_panel,
                                           uint32_t a_plane,
                                           const uint8_t* b,
                                           uint32_t b_panel,
                                           uint32_t b_plane) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(hi, desc_k(a + p * a_panel, kk), desc_k(b + p * b_panel, kk),
               p + kk > 0);
  if constexpr (T == 3) {
#pragma unroll
    for (int t = 0; t < 5; ++t)
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(lo,
                   desc_k(a + low_a(t) * a_plane + p * a_panel, kk),
                   desc_k(b + low_b(t) * b_plane + p * b_panel, kk),
                   t + p + kk > 0);
  }
}

// after the wait for product_ss: hi += lo (T = 3)
template <int T, int N>
__device__ __forceinline__ void finish_product(float (&hi)[N],
                                               float (&lo)[N]) {
  fence_regs(hi);
  if constexpr (T == 3) {
    fence_regs(lo);
#pragma unroll
    for (int i = 0; i < N; ++i) hi[i] += lo[i];
  }
}

// acc += x . B, where x is a 64 x (16 * K) float32 operand given as its
// three bf16 terms (split_a: hi, mid, lo, K k16 steps each) and B a tile of
// 16 * K rows read MN-major, whose 64-column panels are `panel_bytes`
// apart, bf16 (T = 1) or the three term planes of a float32 tile (T = 3),
// `plane_bytes` apart; acc is the m64 accumulator of all D = 64 * (N / 32)
// columns.  The tensor cores' float32 sums truncate, and a long chain of
// them drifts toward zero, so each panel's product starts from zero in two
// short chains, x_hi . B_hi and the lower products (T = 1: mid and lo
// times B; T = 3: the five of weight 2^-8 and 2^-16), so that no small
// term is added into the larger sum, and joins acc by float32 adds.  Waits
// for its wgmmas.
template <int K, int N, int T>
__device__ __forceinline__ void add_split_product(
    float (&acc)[N], const uint32_t (&hi)[K][4], const uint32_t (&mid)[K][4],
    const uint32_t (&lo)[K][4], const uint8_t* b, uint32_t panel_bytes,
    uint32_t plane_bytes) {
#pragma unroll
  for (int p = 0; p < N / 32; ++p) {
    const uint8_t* bp = b + p * panel_bytes;
    float th[32], tl[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      wgmma_rs(th, hi[kk], desc_mn(bp, kk, panel_bytes), kk > 0);
    if constexpr (T == 1) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, mid[kk], desc_mn(bp, kk, panel_bytes), kk > 0);
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, lo[kk], desc_mn(bp, kk, panel_bytes), 1);
    } else {
      const uint8_t* bm = bp + plane_bytes;
      const uint8_t* bl = bm + plane_bytes;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, hi[kk], desc_mn(bm, kk, panel_bytes), kk > 0);
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, mid[kk], desc_mn(bp, kk, panel_bytes), 1);
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, hi[kk], desc_mn(bl, kk, panel_bytes), 1);
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, mid[kk], desc_mn(bm, kk, panel_bytes), 1);
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        wgmma_rs(tl, lo[kk], desc_mn(bp, kk, panel_bytes), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(th);
    fence_regs(tl);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[32 * p + j] += th[j] + tl[j];
  }
}

// two neighbouring outputs, rounded once to the output dtype
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// --- float32 operands into term planes ----------------------------------

// the three bf16 terms of each of the n float32 values of x: hi to
// planes[i], mid to planes[n + i], lo to planes[2n + i].  V = 4 reads 16
// bytes a thread (x 16-byte aligned, n a multiple of 4), V = 1 one value.
template <int V>
__global__ void split_planes_kernel(const float* __restrict__ x,
                                    __nv_bfloat16* __restrict__ planes,
                                    long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       i < n; i += stride) {
    float v[V];
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(x + i);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = x[i];
    }
    __nv_bfloat16 t[3][V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      t[0][e] = __float2bfloat16_rn(v[e]);
      const float r = v[e] - __bfloat162float(t[0][e]);
      t[1][e] = __float2bfloat16_rn(r);
      t[2][e] = __float2bfloat16_rn(r - __bfloat162float(t[1][e]));
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if constexpr (V == 4) {
        const __nv_bfloat162 a = __halves2bfloat162(t[p][0], t[p][1]);
        const __nv_bfloat162 b = __halves2bfloat162(t[p][2], t[p][3]);
        *reinterpret_cast<uint2*>(planes + p * n + i) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                       *reinterpret_cast<const uint32_t*>(&b));
      } else {
        planes[p * n + i] = t[p][0];
      }
    }
  }
}

// launches split_planes_kernel on `stream` (16-byte loads where x allows);
// returns the launch's cudaError_t
inline int split_planes(const float* x, __nv_bfloat16* planes, long long n,
                        cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && n % 4 == 0;
  const int threads = 256;
  const long long items = vec ? n / 4 : n;
  const long long blocks = (items + threads - 1) / threads;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
  if (vec)
    split_planes_kernel<4><<<grid, threads, 0, stream>>>(x, planes, n);
  else
    split_planes_kernel<1><<<grid, threads, 0, stream>>>(x, planes, n);
  return (int)cudaGetLastError();
}

// --- host: TMA tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time through the
// CUDA runtime's entry-point query (no -lcuda at link time)
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// what the C entry points return when a tensor map cannot be made: the
// CUresult plus this
constexpr int TENSOR_MAP_ERROR = 10000;

// the map of a contiguous bf16 tensor [n, t, d] (d a multiple of 8, the
// base 16-byte aligned) in boxes of 64 rows x 64 columns with the 128-byte
// swizzle; reads past t rows or d columns fill zeros.  Returns 0 or
// TENSOR_MAP_ERROR + the CUresult.
inline int encode_rows(CUtensorMap* map, const void* base, int n, int t,
                       int d) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

}  // namespace sm90
