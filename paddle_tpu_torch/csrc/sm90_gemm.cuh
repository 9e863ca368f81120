// Hopper (sm_90a) GEMM core shared by the dense layer with its epilogue
// (K5, dense_epilogue.cu), the 1x1 convolution with batch-norm statistics
// (K3, conv1x1_stats.cu) and the matmul with the producer's batch-norm
// folded in (K6, matmul_bn_stats.cu):
//
//   D [M, N] = A [M, K] . B [K, N]        bf16 operands, float32 sums
//
// handed tile by tile to an epilogue that each kernel writes itself.  A
// reaches the tensor cores K-major from shared memory (x of K5, the bf16
// copy of w of the bf16 K3, a bf16 x of K6: consume) or from registers,
// built by the consumer from a stage that holds the operand in its own
// type and layout (the float32 x of K3, x of K6 with its prologue:
// consume_rs); B is MN-major (w of K5 and K6, the pixels of x of the bf16
// K3) or K-major (the bf16 copy of w of the float32 K3).  Built on
// sm90.cuh (mbarriers, TMA, wgmma descriptors).
//
// Design:
//  - one persistent block of 384 threads on each SM walks output tiles of
//    128 x 128 (tile t, t + gridDim.x, ...), in an order that lets the
//    blocks working at one time share the larger operand's tiles in L2
//    (Tiles).  Warpgroup 0 produces; consumer warpgroups 1 and 2 consume.
//  - ping-pong (the rule): the consumer warpgroups take the block's tiles
//    in turn, each a whole tile, and their products take turns, so one
//    runs its epilogue while the other runs its products.  Cooperative (K3
//    where the producer lays B out, over long K): both take every tile of
//    256 rows, 128 each, so that one B stage serves both.
//  - a ring of shared-memory stages, each an A tile of 128 (or 256) x 64
//    (TMA boxes, 128-byte swizzle, K-major) and a B tile of 64 k rows x
//    128 columns (two 64-column panels, 128-byte swizzle, MN-major).  The
//    producer fills the stages in tile order after their consumers free
//    them (mbarriers `empty`, one arrival per consuming warp) and completes
//    each on `full`: TMA alone (K5, and K3 where a pixel row is whole
//    16-byte chunks), or TMA for A and the producer warpgroup's own layout
//    of B (K3 at other P).  The ring runs across tiles; in ping-pong a
//    warpgroup skips the other's k steps in it.
//  - a consumer warpgroup issues bf16 wgmma m64n128k16 (B transposed) for
//    its two 64-row halves into 2 x 64 float32 accumulators a thread: four
//    k16 steps a stage, one group kept in flight, a stage freed once the
//    group after it waits.  setmaxnreg is to give the consumers the
//    producer's registers; ptxas ignores it in K5 and the bf16 K3 (see
//    setup) and honours it where the kernel splits in its own branches
//    (the float32 K3, K6: consumer_regs).  Waits on mbarriers suspend the
//    thread, so a waiting warp leaves its scheduler to the epilogue's
//    warps.
//  - the epilogue is a functor called with the accumulators of a finished
//    tile: thread (warp w, lane l) holds rows 64h + 16w + l/4 (+ 8) and
//    columns 8i + 2(l % 4) + {0, 1} of the tile as acc[h][4i + {0, 1}]
//    (+ {2, 3} for the row + 8), h = 0, 1, i = 0..15.  Where the output's
//    rows are whole 16-byte chunks it stages the tile in shared memory
//    (OutTiles, in the layout of TMA's boxes: stage2) and writes it with
//    TMA stores that run while the warpgroup goes on (store_staged); else
//    it stores from the registers, 8 rows x 16 bytes a warp instruction,
//    which measured 3-5 times slower for the same bytes.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W): a stage's
// products read 48 KB of shared memory (B once for each 64-row half) while
// TMA writes 32 KB into it, ~160 bytes a cycle at the tensor cores' rate
// against the ~128 an SM's shared memory serves, so the products of a
// 128 x 128 x 768 tile take ~5.3 us, ~60% of the tensor cores' rate
// (K5's bound: 77.3 GFLOP at 989 TFLOP/s, 0.078 ms).  The epilogue hides
// behind the other warpgroup's products only while it is shorter: gelu's
// erf, 16 K values a warpgroup, takes ~12 us a tile.  At K3's short K
// (one to eight k steps) the tile's bytes and its epilogue set the time,
// and where the producer lays B out, its three warps (~1-2 us a stage).
#pragma once

#include "elem.cuh"
#include "sm90.cuh"

namespace sm90g {

using namespace sm90;

constexpr int BM = 128;                    // output rows a tile
constexpr int BN = 128;                    // output columns a tile
constexpr int BK = 64;                     // reduction depth a stage
constexpr int THREADS = 384;               // producer + 2 consumer WGs
constexpr int A_BYTES = BM * BK * 2;       // 16 KB
constexpr int B_PANEL = BK * PANEL_ROW;    // 8 KB: 64 k rows x 64 columns
constexpr int B_BYTES = BN / 64 * B_PANEL; // 16 KB
constexpr int ACC = BN / 2;                // accumulators a 64-row half

// a consumer warpgroup's 32 KB staging tile for its TMA stores (1024-byte
// aligned: the 128-byte swizzle's period)
constexpr int STAGE_OUT = 32768;
struct OutTiles {
  alignas(1024) uint8_t v[2][STAGE_OUT];
};

// the ring of S stages and its barriers; A tiles of AR rows: BM
// (ping-pong, a warpgroup a tile) or 2 BM (cooperative: both warpgroups on
// one tile of 2 BM rows, BM each, sharing its B).  A stage holds A_STAGE_
// bytes of A (bf16 boxes by default; a kernel that builds A in registers
// keeps its operand there in its own type and layout) and B_STAGE_ of B.
template <int S, int AR = BM, int A_STAGE_ = AR * BK * 2,
          int B_STAGE_ = B_BYTES>
struct Stages {
  static constexpr int COUNT = S, ROWS = AR;
  static constexpr int A_STAGE = A_STAGE_, B_STAGE = B_STAGE_;
  uint8_t a[S][A_STAGE];
  uint8_t b[S][B_STAGE];
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t turn[2];     // consumer warpgroup c may start its next products
};

// dynamic shared memory a block for the layout L (whose first member is
// its Stages): L and the slack to align it on 1024 bytes (the swizzle's
// period)
template <class L>
constexpr int smem_bytes() {
  return (int)sizeof(L) + 1024;
}

template <class L>
__device__ __forceinline__ L& smem() {
  extern __shared__ uint8_t smem_raw[];
  return *reinterpret_cast<L*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
}

// --- PTX the core adds to sm90.cuh ---------------------------------------

// box (c0 columns, c1 rows) of a 2-d tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` more transactions for the current phase, without an arrival
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity`, the thread suspended (up to 10
// ms a try) rather than spinning: a spinning waiter takes issue slots from
// the warps that share its scheduler.  Traps (a launch failure the caller
// sees) should a phase not complete within 10 s.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 10000000;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) __trap();
  }
}

// shared-memory stores of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup c (named barrier 1 + c)
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
}

// TMA stores from shared memory: a box of a 2-d (c0, c1) or 3-d map
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R) : "memory");
}

// --- the wgmma shape of the core ------------------------------------------

// d[64] (+)= A . B over k16: A [64 x 16] K-major and B [16 x 128] MN-major
// (transposed), both in shared memory (descriptors da, db); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// the accumulator operands of an m64n64 and an m64n128 wgmma
#define SM90G_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90G_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SM90G_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define SM90G_OUT64(d)                                                     \
  SM90G_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[32] (+)= A . B over k16: A [64 x 16] K-major and B [16 x 64] MN-major
// (transposed), both in shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90G_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SM90G_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] (+)= A . B over k16: A [64 x 16] bf16 in registers (the fragment
// layout of split_a, sm90.cuh), B in shared memory, K-major (TB 0: B
// [128 x 16], k contiguous) or MN-major (TB 1, B transposed: [16 x 128], n
// contiguous); scale_d 0 overwrites d.  The 64-column form is sm90.cuh's
// wgmma_rs (B MN-major).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90G_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SM90G_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  static_assert(TB == 1, "the 64-column register-A wgmma takes B MN-major");
  wgmma_rs(d, a, db, scale_d);
}

// two values as the bf16 pair of an A fragment register (round to nearest
// even; lo in the low half: the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- the walk over tiles ---------------------------------------------------

// The output tiles: m_tiles x n_tiles (BM x BN each), walked with the m
// tiles innermost (`m_inner`: the blocks working at one time share a
// column tile of B) or the column tiles innermost (they share A's rows)
struct Tiles {
  int m_tiles, n_tiles;
  bool m_inner;
  __host__ __device__ __forceinline__ int count() const {
    return m_tiles * n_tiles;
  }
  __device__ __forceinline__ void at(int t, int& mt, int& ct) const {
    if (m_inner)
      mt = t % m_tiles, ct = t / m_tiles;
    else
      ct = t % n_tiles, mt = t / n_tiles;
  }
};

// a ring's position: stage s of S, in the pass of parity `phase`
template <int S>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == S) s = 0, phase ^= 1;
  }
  __device__ __forceinline__ void skip(int n) {
    for (int i = 0; i < n % (2 * S); ++i) next();
  }
};

// Sets up the barriers (the block's first thread) and waits for the block.
// `full_arrivals`: 1 where one thread's expect_tx and TMA fill a stage,
// else the number of producer threads that store into it.
template <class G>
__device__ __forceinline__ void init_barriers(G& sm, int full_arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::COUNT; ++s) {
      mbar_init(&sm.full[s], full_arrivals);
      // one arrival per consuming warp
      mbar_init(&sm.empty[s], G::ROWS == BM ? 4 : 8);
    }
    mbar_init(&sm.turn[0], 1);
    mbar_init(&sm.turn[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// init_barriers and the register split; returns the consumer warpgroup (0
// or 1), or -1 in the producer warpgroup.  ptxas ignores this split in K5
// and the bf16 K3 ((C7507) "'setmaxnreg' ignored to maintain minimum
// register requirements": a split made before the kernel's branch, and a
// wait for the bulk stores after the consumer's last tile), so every
// thread there keeps the entry count (168 at 384 threads).  The kernels
// that build A in registers split in their own branches instead
// (consumer_regs) and wait for their stores in the tile loop
// (wait_stores_after_last).
template <int PRODUCER_REGS, class G>
__device__ __forceinline__ int setup(G& sm, int full_arrivals) {
  init_barriers(sm, full_arrivals);
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    return -1;
  }
  // the block's registers (168 a thread at 384 threads) split: the
  // producer's 128 threads give up what the consumers' 256 take
  regs_inc<(504 - PRODUCER_REGS) / 2>();
  return threadIdx.x / 128 - 1;
}

// The consumers' registers where the producer warpgroup keeps `producer`
// of the block's 168 a thread at 384 threads (a multiple of 8, as
// setmaxnreg takes): a kernel calls regs_dec<P>() first thing in its
// producer branch and regs_inc<consumer_regs(P)>() first thing in its
// consumers' (after init_barriers, the two branches never joining)
__host__ __device__ constexpr int consumer_regs(int producer) {
  return (504 - producer) / 2;
}

// The producer's walk: for each of this block's tiles (m tile mt, column
// tile ct) and k step kt, waits for the stage to be free and calls
// fill(ring stage s, full barrier, mt, ct, kt).  Run by the threads that
// fill stages (one thread, or several).
template <class G, class Fill>
__device__ __forceinline__ void produce(G& sm, const Tiles& tl, int ktiles,
                                        Fill fill) {
  Ring<G::COUNT> r;
  for (int t = blockIdx.x; t < tl.count(); t += gridDim.x) {
    int mt, ct;
    tl.at(t, mt, ct);
    for (int kt = 0; kt < ktiles; ++kt, r.next()) {
      wait(&sm.empty[r.s], r.phase ^ 1);   // a new ring passes at once
      fill(r.s, &sm.full[r.s], mt, ct, kt);
    }
  }
}

// Consumer warpgroup c's walk.  Ping-pong (AR = BM): the block's tiles c,
// c + 2, c + 4, ... (in the producer's order); acc = A . B over each
// tile's k steps, then epi(acc, mt, ct) with the layout of the header
// (NA = 64 accumulators a 64-row half: 128 columns; 32: 64 columns).
// The two warpgroups' products take turns (`turn`): a warpgroup starts a
// tile's products once the other has seen every stage of its own tile
// arrive.  So each `full` barrier has completed the use of its stage
// before this one when it is waited on (its parity names one phase only),
// and the tensor cores run one tile at a time while the other warpgroup
// runs its epilogue.  Cooperative (AR = 2 BM): both warpgroups take every
// tile, c its rows BM c .. BM c + BM - 1, and epi gets m tile 2 mt + c.
template <int NA = ACC, class G, class Epi>
__device__ __forceinline__ void consume(G& sm, int c, const Tiles& tl,
                                        int ktiles, Epi epi) {
  constexpr bool COOP = G::ROWS == 2 * BM;
  Ring<G::COUNT> r;
  if (!COOP) r.skip(c * ktiles);
  const int lane = threadIdx.x % 32;
  float acc[2][NA];
  uint32_t turns = 0;                  // turns this warpgroup has waited
  for (int t = blockIdx.x + (COOP ? 0 : c) * gridDim.x; t < tl.count();
       t += (COOP ? 1 : 2) * gridDim.x) {
    int mt, ct;
    tl.at(t, mt, ct);
    if (!COOP && (c == 1 || t != (int)blockIdx.x))
      wait(&sm.turn[c], turns++ & 1);
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, r.next()) {
      wait(&sm.full[r.s], r.phase);
      const uint8_t* a = sm.a[r.s] + (COOP ? c * BM * PANEL_ROW : 0);
      const uint8_t* b = sm.b[r.s];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_mn(b, kk, B_PANEL);
        wgmma_ss_mn(acc[0], desc_k(a, kk), db, kt + kk > 0);
        wgmma_ss_mn(acc[1], desc_k(a + 64 * PANEL_ROW, kk), db, kt + kk > 0);
      }
      wgmma_commit();
      if (prev >= 0) {
        // the group of step kt - 1 is done: its stage is free
        wgmma_wait_one();
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[prev]);
      }
      prev = r.s;
    }
    if (!COOP && threadIdx.x % 128 == 0) mbar_arrive(&sm.turn[c ^ 1]);
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    epi(acc, COOP ? 2 * mt + c : mt, ct);
    if (!COOP) r.skip(ktiles);    // the other warpgroup's tile
  }
}

// Consumer warpgroup c's walk (ping-pong, as consume) with A built in
// registers: for each k step and 64-row half h, load_a(a, s, h, kt, mt)
// fills a[kk] with the bf16 A fragments of the half's four k16 steps from
// stage s (the operand in its own type and layout, transformed there), and
// the warpgroup issues them with B from the stage (descriptor desc_b(s, kk),
// K-major for TB 0, MN-major for TB 1).  Each (k step, half) is one wgmma
// group, so a half's A is built while the group before it runs; the
// registers of a group (a0 for half 0, a1 for half 1) are built again only
// after wgmma_wait_one has seen that group complete.
template <int NA, int TB, class G, class LoadA, class DescB, class Epi>
__device__ __forceinline__ void consume_rs(G& sm, int c, const Tiles& tl,
                                           int ktiles, LoadA load_a,
                                           DescB desc_b, Epi epi) {
  Ring<G::COUNT> r;
  r.skip(c * ktiles);
  const int lane = threadIdx.x % 32;
  float acc[2][NA];
  uint32_t a0[4][4], a1[4][4];
  uint32_t turns = 0;
  for (int t = blockIdx.x + c * gridDim.x; t < tl.count();
       t += 2 * gridDim.x) {
    int mt, ct;
    tl.at(t, mt, ct);
    if (c == 1 || t != (int)blockIdx.x) wait(&sm.turn[c], turns++ & 1);
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, r.next()) {
      wait(&sm.full[r.s], r.phase);
      load_a(a0, r.s, 0, kt, mt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n<TB>(acc[0], a0[kk], desc_b(r.s, kk), kt + kk > 0);
      wgmma_commit();
      // the group of (kt - 1, half 1) is done: a1 and stage kt - 1 are free
      wgmma_wait_one();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[prev]);
      }
      load_a(a1, r.s, 1, kt, mt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n<TB>(acc[1], a1[kk], desc_b(r.s, kk), kt + kk > 0);
      wgmma_commit();
      wgmma_wait_one();        // (kt, half 0) is done: a0 is free
      prev = r.s;
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&sm.turn[c ^ 1]);
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    epi(acc, mt, ct);
    r.skip(ktiles);            // the other warpgroup's tile
  }
}

// The epilogue's batch-norm statistics: the sums of each tile column's
// values and squares over the tile's rows (rows the kernel zeroed, or that
// TMA filled with zeros, add exact zeros), added into this warpgroup's row
// of the partials (ps, ps2: columns col0 .. col0 + 2 NA - 1, those below
// ncols).  In a fixed order, so deterministic without atomics: within the
// thread's four rows, across the eight lanes that hold the column
// (xor-shuffles over l / 4), across the four warps (red: [4][2][2 NA]
// floats in shared memory, this warpgroup's), then by the column's thread.
template <int NA>
__device__ __forceinline__ void column_stats(const float (&acc)[2][NA],
                                             float (*red)[2][2 * NA], int c,
                                             float* ps, float* ps2, int col0,
                                             int ncols) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  wg_sync(c);                 // the last tile's reads of red are done
#pragma unroll
  for (int i = 0; i < NA / 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = acc[h][4 * i + 2 * r + e];
          s += v;
          s2 = fmaf(v, v, s2);
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane < 4) {
        red[warp][0][8 * i + 2 * lane + e] = s;
        red[warp][1][8 * i + 2 * lane + e] = s2;
      }
    }
  wg_sync(c);
  const int j = threadIdx.x % 128;
  if (j < 2 * NA && col0 + j < ncols) {
    ps[col0 + j] += (red[0][0][j] + red[1][0][j]) + (red[2][0][j] + red[3][0][j]);
    ps2[col0 + j] += (red[0][1][j] + red[1][1][j]) + (red[2][1][j] + red[3][1][j]);
  }
}

// Stores the float32 value of (row, col) into a staging tile at shared
// address `tile` laid out as TMA boxes of `rows` rows x 32 columns (128-byte
// rows, 128-byte swizzle), panels rows * 128 bytes apart: a tile whose
// rows are the accumulator's columns (a transposed store)
__device__ __forceinline__ void stage1f(uint32_t tile, int rows, int row,
                                        int col, float v) {
  const uint32_t at = tile + (col / 32) * rows * 128 + row * 128 +
                      ((((col % 32) / 4) ^ (row & 7)) * 16) + (col % 4) * 4;
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(at), "f"(v) : "memory");
}

// `bytes` (a multiple of 16) from shared memory to device memory (both
// 16-byte aligned), asynchronously, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) from device memory to shared memory (both
// 16-byte aligned), completing as transactions on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Stores the neighbouring values (row, col), (row, col + 1) (col even)
// into a staging tile at shared address `tile`, of `rows` rows laid out as
// TMA boxes of 128-byte rows with the 128-byte swizzle: 128 / sizeof(T)
// columns a panel, panels rows * 128 bytes apart, rounded to T.  Rows of
// the same 16-byte chunk index land in other banks, so a warp's fragment
// stores do not conflict.
template <typename T>
__device__ __forceinline__ void stage2(uint32_t tile, int rows, int row,
                                       int col, float a, float b) {
  constexpr int PER = 128 / sizeof(T);      // columns a panel
  const int in = col % PER;
  const uint32_t at = tile + (col / PER) * rows * 128 + row * 128 +
                      ((in * (int)sizeof(T) / 16) ^ (row & 7)) * 16 +
                      (in * (int)sizeof(T)) % 16;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(at), "r"(*reinterpret_cast<const uint32_t*>(&v))
                 : "memory");
  } else {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                 :: "r"(at), "f"(a), "f"(b) : "memory");
  }
}

// The epilogue's TMA store of a staged tile: waits until the warpgroup's
// last stores have read the buffer, lets write(buf) fill it (each thread
// its fragments, through `stage2` at smem_u32(buf)), then has one thread
// issue store(buf), the TMA stores, asynchronously.  c: the consumer
// warpgroup.
template <class W, class S>
__device__ __forceinline__ void store_staged(uint8_t* buf, int c, W write,
                                             S store) {
  const bool lead = threadIdx.x % 128 == 0;
  if (lead) bulk_wait_read();
  wg_sync(c);
  write(buf);
  fence_async_shared();
  wg_sync(c);
  if (lead) {
    store(buf);
    bulk_commit();
  }
}

// The end of an epilogue that stored with store_staged: after the
// warpgroup's last tile (t, in the walk's order, the last below `count`
// for this warpgroup) its issuing thread waits until the stores have read
// their shared memory, so the block may exit.  Called inside the tile loop:
// ptxas ignores the kernel's setmaxnreg split ((C7507), every thread then
// keeps 168 registers) when a consumer waits for its bulk stores after the
// loop, and serializes the wgmmas of a consumer that needs more (C7512).
__device__ __forceinline__ void wait_stores_after_last(const Tiles& tl,
                                                       int mt, int ct) {
  const int t = tl.m_inner ? mt + ct * tl.m_tiles : ct + mt * tl.n_tiles;
  if (threadIdx.x % 128 == 0 && t + 2 * (int)gridDim.x >= tl.count())
    bulk_wait_read();
}

// --- host -------------------------------------------------------------------

// the map of a bf16 (or, `f32`, float32) matrix of `rows` x `cols` (row
// stride `ld` elements, 16-byte rows; the base 16-byte aligned) in boxes
// of `box_rows` rows x 128 bytes with the 128-byte swizzle; reads past its
// edges fill zeros, stores past them are dropped.  Returns 0 or
// TENSOR_MAP_ERROR + the CUresult.
inline int encode_2d(CUtensorMap* map, const void* base, long long rows,
                     long long cols, long long ld, int box_rows,
                     bool f32 = false) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const int size = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * size)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / size), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// the map of a float32 tensor [d2, d1, d0] (d0 a multiple of 4, the base
// 16-byte aligned) in boxes of 32 x `box1` x 1 with the 128-byte swizzle;
// reads past its edges fill zeros, stores past them are dropped.  Returns
// 0 or TENSOR_MAP_ERROR + the CUresult.
inline int encode_3d_f32(CUtensorMap* map, const void* base, long long d0,
                         long long d1, long long d2, int box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * 4),
                                 (cuuint64_t)(d0 * d1 * 4)};
  const cuuint32_t box[3] = {32, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// src [rows, cols] (float32 or bf16) rounded to bf16 rows of cols8
// elements (zeros past cols): the bf16 copy of w that the kernels read by
// TMA
template <typename T>
__global__ void __launch_bounds__(256)
round_w_kernel(const T* __restrict__ src, __nv_bfloat16* __restrict__ out,
               int rows, int cols, int cols8) {
  const long long n = (long long)rows * cols8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / cols8), k = (int)(i % cols8);
    out[i] = k < cols ? ptt::to_bf16(src[(long long)r * cols + k])
                      : __float2bfloat16_rn(0.f);
  }
}

// launches round_w_kernel on `st`; returns its cudaError_t
template <typename T>
int round_w(const void* src, __nv_bfloat16* out, int rows, int cols,
            cudaStream_t st) {
  const int cols8 = (cols + 7) / 8 * 8;
  const long long blocks = ((long long)rows * cols8 + 255) / 256;
  round_w_kernel<T><<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                      st>>>(static_cast<const T*>(src), out, rows, cols,
                            cols8);
  return (int)cudaGetLastError();
}

// blocks of a persistent grid over `tiles` tiles: one a streaming
// multiprocessor of the current device, at most one a pair of tiles
// (ping-pong) or a tile (`coop`)
inline unsigned grid_for(long long tiles, bool coop = false) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  const long long need = coop ? tiles : (tiles + 1) / 2;
  return (unsigned)(need < sms ? need : sms);
}

}  // namespace sm90g
