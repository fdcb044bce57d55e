// Hopper (sm_90a) kernels for the gradient of flash attention (K5's
// backward), in bfloat16 and in float32.
//
// Built by kernels/build.py with nvcc into a shared library of its own,
// with a plain C interface, loaded with ctypes; no PyTorch header is
// included.  The entry points launch on the stream they are given,
// allocate nothing, do not synchronise and return cudaGetLastError().
//
//   repro_attn_bwd      dq, dk, dv of softmax attention over folded heads,
//                       from q (BH, Sq, Dqk), k (BH, Skv, Dqk), v (BH, Skv,
//                       Dv), the forward's o and row log-sum-exp lse, and
//                       the output's gradient dO, all bfloat16 but lse
//                       (float32); queries aligned to the keys' suffix,
//                       causal and sliding-window masks as the forward's
//   repro_attn_bwd_f32  the same for float32 operands, at float32 grade,
//                       through scratch the caller allocates
//
// Replaces no TPU kernel: the reference's flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no VJP, and the reference
// differentiates its jnp attention.  It replaces this port's first
// backward (lm.cu's flash_attention_bwd_{delta,dkdv,dq}_kernel, mma.sync
// on tiles loaded synchronously, three launches).  Two launches a call:
// a prologue (delta; in float32 also the operands' split, below), then
// one grid of the dK/dV and the dQ blocks.  With c = 1/sqrt(Dqk), P =
// exp(c Q K' - lse) and dO the output's gradient:
//   (1) delta_i = sum_d dO_id O_id                          (float32)
//   (2) per key tile:   dV = P' dO,  dS = P o (dO V' - delta),  dK = c dS' Q
//   (3) per query tile:              dQ = c dS K
//
// Bound on an H100: five products a visible (query, key) pair, 2 Dqk each
// for Q K', dK and dQ, 2 Dv each for dO V' and dV.  At h2o-danube-3-4b's
// training call (BH 256, S 4096, D 120) causal that is 2.58 TFLOP: 2.606
// ms at the 989 TFLOP/s bf16 rate, bound by operations (q k v o dO in,
// dq dk dv out are 1.8 GB: 0.54 ms).  In float32 the same work at float32
// grade costs three TF32 passes (or six bf16 ones) a product: 165 TFLOP/s,
// 1.354 ms at deepseek-v2-lite's MLA call (BH 64, S 2048, Dqk 192, Dv 128)
// causal, bound by operations.  The kernels they replace took 40.41 and
// 19.61 ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design, against the four faults of the kernels it replaces:
// - Tensor cores through wgmma (they had mma.sync, each warp reloading its
//   B fragments with ldmatrix).  Consumer warpgroups of 64 rows issue
//   wgmma.mma_async m64nNk16 bf16 with float32 accumulators.  (2): S' =
//   K Q' and dP' = V dO' take both operands from shared memory (K-major);
//   dV += P' dO and dK += dS' Q take P' and dS' from registers (the
//   accumulator fragments) and the Q or dO tile as B with the transpose
//   bit (MN-major: those tiles sit query-major).  (3) mirrored: S = Q K',
//   dP = dO V' from shared memory, dQ += dS K with dS from registers.  The
//   register-A products run m64n128k16 over each pair of 64-column panels
//   (m64n64k16 for an odd one), so an A fragment feeds 128 columns.
// - Asynchronous copies (they loaded every tile synchronously between two
//   __syncthreads()).  A producer warpgroup (one thread issuing) keeps a
//   two-stage ring of the walked tiles full with TMA loads that complete
//   on mbarriers: Q and dO for (2), K and V for (3); the block's own
//   tiles are loaded once.  (2)'s stages also hold the step's lse and
//   delta, which the producer's first warp loads and stores itself before
//   it arrives on the stage's barrier: a 1-D tensor map over the BH Sq
//   rows faulted on the card wherever Sq % 4 != 0 (its boxes then start
//   off 16 bytes).  3-D tensor maps over (lanes, rows, depth) bring rows
//   past Sq or Skv and depth past D in as zeros within each lane; the
//   boxes are 64 columns (128 bytes) wide with the 128-byte swizzle that
//   wgmma's descriptors read, so D is padded in shared memory to a
//   multiple of 64 (h2o's 120 to 128).
// - Larger tiles (they took 64 keys against 32-query steps, 128 threads),
//   by type below.
// - Products.  dQ stays a pass of its own, so a visible pair costs seven
//   products where five are needed (Q K' and dO V' twice): folding dQ
//   into (2) without atomics needs each query tile's partials added in
//   key-tile order through a counter (FlashAttention-3's deterministic
//   mode); float atomics would change the bits from run to run, and a
//   float32 partial a key tile is 17 GB at h2o's row.  Every output is
//   written by one block, summed in a fixed order: the same inputs give
//   the same bits.  The two passes' blocks share one grid, so a small
//   call runs in about the time of one pass.
// - Masks as the forward's (causal, window, queries aligned to the keys'
//   suffix, Sq != Skv where nothing is masked); the tiles no query or key
//   of a block can see are not walked, a warpgroup skips the steps none
//   of its rows can see, and only diagonal and edge tiles are masked
//   element by element.  Causal blocks run heaviest first: (2) from the
//   first key tile, (3) from the last query tile.
// - Depth classes: Dqk, Dv are padded to (64, 64), (128, 128) or (192,
//   128) by the tensor maps' zero fill, which does not change the
//   function; every pair of kernels/flash_attention.py DEPTH_PAIRS falls
//   in one.  Skipped rows, padded depth and ragged edges add no work to
//   the bound, which counts the real D.
//
// bfloat16: P' and dS' rounded once to bf16 as the A operands.  (2): 128
// keys a block (two consumer warpgroups) against 64-query steps, 32-query
// steps at Dqk 192 (MLA), where the dK accumulator alone is 96 registers a
// thread.  (3): 128 queries a block against 128-key steps (64 at Dqk 192).
// 384 threads a block, one block an SM; setmaxnreg gives the consumers 240
// registers (PERF.md has ptxas's spills).  A third ring stage, and issuing
// a step's S' before the last step's dV, dK products completed, were
// slower (the latter spilled).  delta is a launch of its own (16-byte
// loads, a warp a row); dq, dk and dv go out through tensor maps of their
// own, which clip the padding and the ragged rows.
//
// float32, at float32 grade on the bf16 tensor cores.  Every operand x is
// split into three bf16 parts, x = b0 + b1 + b2 (each the remainder so far
// rounded to nearest; b0 rounded toward zero where rounding to nearest
// would overflow), which is exact for |x| >= 2^-110: 24 significant bits.
// A product takes six passes, smallest first, b2 c0, b1 c1, b0 c2, b1 c0,
// b0 c1, b0 c0; the dropped b1 c2 + b2 c1 + b2 c2 are within about 2^-25
// of |b||c|, under float32's own rounding.  Six passes at the 989 TFLOP/s
// bf16 rate cost what three TF32 passes (the other route to float32 grade,
// hi + lo, at 495) cost, but TF32 wgmma takes its shared-memory operands
// K-major only: dV += P' dO, dK += dS' Q and dQ += dS K would each need a
// transposed copy of dO, Q or K in hi and lo beside the K-major one, 16
// bytes an element against the split's 6, and a layout and descriptors
// no kernel here has verified.  The bf16 parts reuse the bf16 kernels'
// ring, descriptors and swizzle unchanged.
// - The prologue (one launch, a warp a row) computes delta and writes q,
//   k, v and dO as their parts into scratch the caller allocates, (BH, 3,
//   S, D rounded up to 8) bf16 each: the main grid's tensor maps read only
//   the scratch, with 16-byte strides whatever D (17 too) and whatever the
//   float32 operands' alignment.  It is bound by memory: at MLA's row 403
//   MB read, 503 MB written, 0.27 ms at 3.35 TB/s (PERF.md has its
//   measured share of the call).
// - Shared memory holds an operand's three parts, 6 bytes an element: a
//   panel stacks part 0, 1, 2 of a tile's rows, each a box of its own from
//   lane 3 bh + part.  At (64, 64) the bf16 tiling fits (two consumer
//   warpgroups, 128 own rows against 64-row steps: 195 KB).  Past it one
//   consumer warpgroup owns 64 rows (a block of 256 threads, no
//   setmaxnreg): against 32-row steps at (128, 128) (195 KB) and 16-row
//   steps at (192, 128) (183 KB: 120 KB of own K and V parts; a third ring
//   stage there, 213 KB, was slower).  Narrow steps read A from shared
//   memory more often a product (its wgmma's N is the step's rows); the
//   register-A products are not affected.  ptxas spills at (192, 128)
//   (PERF.md); the own tiles' addresses are made opaque each step, so that
//   their parts' 60 descriptors are not held across the loop (held, they
//   spilled more, and the kernel was slower).
// - wgmma, like mma.sync (lm.cu's float32 forward), drifts when a long run
//   of sums goes into one accumulator: on the card the error from the
//   plain backward grew with the run's length.  So dK, dV and dQ are
//   flushed every AB_FLUSH_ROWS walked rows: added in float32 into the
//   output, which only this block writes (a panel's old values loaded
//   together, then stored), and restarted from zero.  The outputs are
//   written with plain stores (any D, any alignment).
// - The grid puts the tiles on x and the lanes on y (a lane count up to
//   65535, as the float32 forward's), and numbers the blocks as the bf16
//   grid does, lane fastest, so every lane's heaviest tiles start first.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int AB_WG = 128;                  // threads of a warpgroup
constexpr int AB_STAGES = 2;                // the walked tiles' ring
constexpr int AB_ROW = 128;                 // bytes of a panel row (64 bf16)
constexpr float AB_LOG2E = 1.4426950408889634f;
// an mbarrier wait that has spun this many cycles (about 10 s) traps: a
// fault in the pipeline ends the launch with an error instead of hanging
constexpr long long AB_SPIN_CYCLES = 20000000000LL;
// float32: the walked rows between two flushes of an accumulator into
// its output: 192 sums at 16-row steps (fewer rows kept the result nearer
// the plain backward and cost time; more drifted further)
constexpr int AB_FLUSH_ROWS = 512;
// float32: the bf16 parts of an operand
constexpr int AB_PARTS = 3;

// bf16: query rows of a dK/dV step, 32 at Dqk 192, where the dK
// accumulator is 96 registers a thread
__host__ __device__ constexpr int ab_bq(int dqk)
{
    return dqk > 128 ? 32 : 64;
}

// bf16: keys of a dQ step, 64 at Dqk 192
__host__ __device__ constexpr int ab_bkd(int dqk)
{
    return dqk > 128 ? 64 : 128;
}

__host__ __device__ constexpr int ab_round1024(int n)
{
    return (n + 1023) / 1024 * 1024;
}

// the tiles of a build at the depth class (DQK, DV) with NP parts an
// operand (1: bf16; 3: float32 as three bf16 parts)
template <int DQK_, int DV_, int NP_>
struct AbCfg {
    static constexpr int DQK = DQK_, DV = DV_, NP = NP_;
    // consumer warpgroups, each owning 64 rows of a block's own tile
    static constexpr int NC = NP == 1 || DQK <= 64 ? 2 : 1;
    static constexpr int OWN = 64 * NC;     // keys of (2), queries of (3)
    // walked rows a step: queries of (2), keys of (3)
    static constexpr int BQ =
        NP == 1 ? ab_bq(DQK) : DQK <= 64 ? 64 : DQK <= 128 ? 32 : 16;
    static constexpr int BKD = NP == 1 ? ab_bkd(DQK) : BQ;
    static constexpr int THREADS = (NC + 1) * AB_WG;
    // passes a product: the last PASSES of ab_pa / ab_pb's six
    static constexpr int PASSES = NP == 1 ? 1 : 6;
};

// the parts (of A, of B) of pass n of a product over three-part operands,
// smallest first: (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0); a
// one-part product takes the last alone
__host__ __device__ constexpr int ab_pa(int n)
{
    return n == 0 ? 2 : (n == 1 || n == 3) ? 1 : 0;
}
__host__ __device__ constexpr int ab_pb(int n)
{
    return (n == 1 || n == 4) ? 1 : n == 2 ? 2 : 0;
}

// the shared memory of a dK/dV block: its K and V tiles (OWN keys), then
// the ring's stages (Q, dO, lse, delta of BQ queries), then the
// mbarriers; every tile is depth / 64 panels of NP x rows x 128 bytes
// (part-major within a panel)
template <class C>
struct AbKV {
    static constexpr int BQ = C::BQ;
    static constexpr int K = C::NP * C::OWN * C::DQK * 2;
    static constexpr int V = C::NP * C::OWN * C::DV * 2;
    static constexpr int Q = C::NP * BQ * C::DQK * 2;
    static constexpr int DO = C::NP * BQ * C::DV * 2;
    static constexpr int TX = Q + DO;
    static constexpr int STAGE = ab_round1024(TX + 2 * BQ * 4);
    static constexpr int BARS = K + V + AB_STAGES * STAGE;
    static constexpr int SMEM = 1024 + BARS + 8 * (2 * AB_STAGES + 1);
};

// a dQ block's: its Q and dO tiles (OWN queries), the ring's stages (K
// and V of BKD keys), the mbarriers
template <class C>
struct AbQ {
    static constexpr int BKD = C::BKD;
    static constexpr int Q = C::NP * C::OWN * C::DQK * 2;
    static constexpr int DO = C::NP * C::OWN * C::DV * 2;
    static constexpr int K = C::NP * BKD * C::DQK * 2;
    static constexpr int V = C::NP * BKD * C::DV * 2;
    static constexpr int TX = K + V;
    static constexpr int STAGE = ab_round1024(TX);
    static constexpr int BARS = Q + DO + AB_STAGES * STAGE;
    static constexpr int SMEM = 1024 + BARS + 8 * (2 * AB_STAGES + 1);
};

template <class C>
constexpr int ab_smem_bytes()
{
    return AbKV<C>::SMEM > AbQ<C>::SMEM ? AbKV<C>::SMEM : AbQ<C>::SMEM;
}
static_assert(ab_smem_bytes<AbCfg<64, 64, 3>>() <= 232448, "smem");
static_assert(ab_smem_bytes<AbCfg<128, 128, 3>>() <= 232448, "smem");
static_assert(ab_smem_bytes<AbCfg<192, 128, 3>>() <= 232448, "smem");
static_assert(ab_smem_bytes<AbCfg<192, 128, 1>>() <= 232448, "smem");

__device__ __forceinline__ uint32_t ab_smem(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    long long t0 = 0;
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == 0)
            t0 = clock64();
        else if ((spins & 1023) == 0 && clock64() - t0 > AB_SPIN_CYCLES)
            __trap();
    }
}

// a box of the 3-D map (columns c0.., rows c1.., lane c2) into shared
// memory at dst, completing on the mbarrier bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t bar)
{
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global"
                 ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
                 "[%5];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(c2), "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2)
{
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
                 "[%0, {%2, %3, %4}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0),
                    "r"(c1), "r"(c2) : "memory");
}
// the stores issued so far have read their shared memory
__device__ __forceinline__ void tma_store_drain()
{
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
// that completes it
template <int R>
__device__ __forceinline__ void wg_hold(float (&d)[R])
{
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// a wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
        | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand: 64 (A) or N (B) rows of a tile at `tile` whose panels
// hold `rows` rows, depth step kk (16 columns: a 32-byte step inside the
// swizzled 128-byte row); 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk)
{
    return wg_desc(tile + (kk >> 2) * rows * AB_ROW + (kk & 3) * 32, 16,
                   1024);
}
// MN-major B: the tile's rows are the product's depth, step kk its rows
// 16 kk.., panel p its columns 64 p..; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk,
                                            int p)
{
    return wg_desc(tile + p * rows * AB_ROW + kk * 2048, rows * AB_ROW, 1024);
}

// d (64 x 64, float32) (+)= A B from shared memory: A 64 x 16 and B
// 64 x 16, both K-major (descriptors a, b); acc 0 overwrites d
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b, int acc)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 16, float32) (+)= A B from shared memory: A 64 x 16 and B
// 16 x 16, both K-major (descriptors a, b); acc 0 overwrites d
__device__ __forceinline__ void wg_ss16(float (&d)[8], uint64_t a,
                                        uint64_t b, int acc)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32, float32) (+)= A B from shared memory: A 64 x 16 and B
// 32 x 16, both K-major (descriptors a, b); acc 0 overwrites d
__device__ __forceinline__ void wg_ss32(float (&d)[16], uint64_t a,
                                        uint64_t b, int acc)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, float32) += A B: A 64 x 16 bf16 in registers (the
// accumulator fragment's layout), B 16 x 64 MN-major in shared memory
__device__ __forceinline__ void wg_rs64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128, float32) (+)= A B from shared memory: A 64 x 16 and B
// 128 x 16, both K-major (descriptors a, b); acc 0 overwrites d
__device__ __forceinline__ void wg_ss128(float (&d)[64], uint64_t a,
                                        uint64_t b, int acc)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, float32) += A B: A 64 x 16 bf16 in registers (the
// accumulator fragment's layout), B 16 x 128 MN-major in shared memory
__device__ __forceinline__ void wg_rs128(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wg_ss(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int acc)
{
    if constexpr (N == 128) wg_ss128(d, a, b, acc);
    else if constexpr (N == 64) wg_ss64(d, a, b, acc);
    else if constexpr (N == 32) wg_ss32(d, a, b, acc);
    else wg_ss16(d, a, b, acc);
}

// d (64 x D, D / 64 accumulator panels) += A B, A 64 x 16 in registers,
// B the 16 rows kk.. of a tile at `tile` (panels of `rows` rows), MN-major:
// one m64n128 product a pair of panels, m64n64 for an odd one
template <int D>
__device__ __forceinline__ void wg_rs(float (&d)[D / 64][32],
                                      const uint32_t (&a)[4], uint32_t tile,
                                      int rows, int kk)
{
#pragma unroll
    for (int p = 0; p + 1 < D / 64; p += 2)
        wg_rs128(*reinterpret_cast<float(*)[64]>(&d[p][0]), a,
                 desc_mn(tile, rows, kk, p));
    if constexpr (D / 64 % 2 == 1)
        wg_rs64(d[D / 64 - 1], a, desc_mn(tile, rows, kk, D / 64 - 1));
}

__device__ __forceinline__ uint32_t ab_pack(float x0, float x1)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// x as three bf16 parts h + m + l, each the remainder so far rounded to
// nearest: exact for |x| >= 2^-110.  wide: h rounded toward zero where
// rounding to nearest would overflow (the operands; P' and dS' are far
// from it)
template <bool WIDE>
__device__ __forceinline__ void ab_split(float x, __nv_bfloat16& h,
                                         __nv_bfloat16& m, __nv_bfloat16& l)
{
    h = __float2bfloat16_rn(x);
    if (WIDE && isinf(__bfloat162float(h)) && !isinf(x))
        h = __float2bfloat16_rz(x);
    const float r = x - __bfloat162float(h);
    m = __float2bfloat16_rn(r);
    l = __float2bfloat16_rn(r - __bfloat162float(m));
}

__device__ __forceinline__ uint32_t ab_pack2(__nv_bfloat16 a,
                                             __nv_bfloat16 b)
{
    return (uint32_t)__bfloat16_as_ushort(a)
        | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// the A fragments of a 64 x 16 kk step from an accumulator (64 x N):
// rounded once to bf16 (NP 1) or as the three parts of each value
template <int N, int NP>
__device__ __forceinline__ void ab_frags(uint32_t (&a)[N / 16][NP][4],
                                         const float (&d)[N / 2])
{
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
            if constexpr (NP == 1) {
                a[kk][0][r] = ab_pack(x0, x1);
            } else {
                __nv_bfloat16 h0, m0, l0, h1, m1, l1;
                ab_split<false>(x0, h0, m0, l0);
                ab_split<false>(x1, h1, m1, l1);
                a[kk][0][r] = ab_pack2(h0, h1);
                a[kk][1][r] = ab_pack2(m0, m1);
                a[kk][2][r] = ab_pack2(l0, l1);
            }
        }
}

// float32: a warpgroup's accumulator d (64 rows of D / 64 panels; this
// thread's rows row0 and row0 + 8), times mul, into out (rows x depth,
// row-major): stored on the first flush, added in float32 after it; then
// d restarts from zero.  Only this block writes these rows.  A panel's
// old values are all loaded before any is stored, so that the loads are
// in flight together
template <int D>
__device__ __forceinline__ void ab_flush(float* __restrict__ out,
                                         float (&d)[D / 64][32], int row0,
                                         int rows, int depth, float mul,
                                         bool first)
{
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int p = 0; p < D / 64; ++p) {
        float old[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = row0 + 8 * ((i >> 1) & 1);
            const int c = 64 * p + 8 * (i >> 2) + 2 * t + (i & 1);
            old[i] = !first && r < rows && c < depth
                ? out[(long long)r * depth + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = row0 + 8 * ((i >> 1) & 1);
            const int c = 64 * p + 8 * (i >> 2) + 2 * t + (i & 1);
            if (r < rows && c < depth)
                out[(long long)r * depth + c] = old[i] + d[p][i] * mul;
            d[p][i] = 0.f;
        }
    }
}

// a warpgroup's 64 x 64 accumulator panel, times mul, in bf16 into the
// 128-byte-swizzled panel rows at `rows` (64 rows of 128 bytes, 1024-byte
// aligned), as a TMA box of that map reads them
__device__ __forceinline__ void ab_stage_out(unsigned char* rows,
                                             const float (&d)[32], float mul)
{
    const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * wr + g + 8 * h;
            *reinterpret_cast<uint32_t*>(rows + r * AB_ROW
                                         + ((j ^ (r & 7)) << 4) + 4 * t) =
                ab_pack(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
        }
}

__device__ __forceinline__ bool ab_visible(int key, int qi, int sq, int skv,
                                           int off, int causal, int window)
{
    bool ok = key < skv && qi < sq;
    if (causal) ok = ok && key <= qi + off;
    if (window > 0) ok = ok && key > qi + off - window;
    return ok;
}

// ---------------------------------------------------------------------------
// (1) delta = rowsum(dO o O): a warp a row, 16-byte loads (Dv % 8 == 0)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int dv)
{
    const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * dv);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + row * dv);
    float acc = 0.f;
    for (int c = lane; c < dv / 8; c += 32) {
        const uint4 a = orow[c], b = drow[c];
        const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 x = __bfloat1622float2(ah[i]);
            const float2 y = __bfloat1622float2(bh[i]);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// (1) in float32, the prologue: a warp a row of a lane (blockIdx.y), the
// lane's Sq query rows then its Skv key rows.  A query row writes q's and
// dO's parts and delta (summed as lm.cu's float32 delta summed it), a key
// row k's and v's parts; parts at (lane, part, row, column) with dp
// columns a row, zeros in [depth, dp)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ab_split_row(const float* __restrict__ src,
                                             __nv_bfloat16* __restrict__ dst,
                                             long long part_stride,
                                             int depth, int dp, int lane)
{
    for (int c = lane; c < dp; c += 32) {
        __nv_bfloat16 h, m, l;
        ab_split<true>(c < depth ? src[c] : 0.f, h, m, l);
        dst[c] = h;
        dst[part_stride + c] = m;
        dst[2 * part_stride + c] = l;
    }
}

__global__ void __launch_bounds__(256)
attn_bwd_split_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      float* __restrict__ delta, __nv_bfloat16* __restrict__ qp,
                      __nv_bfloat16* __restrict__ kp,
                      __nv_bfloat16* __restrict__ vp,
                      __nv_bfloat16* __restrict__ dop, int sq, int skv,
                      int dqk, int dv, int dqp, int dvp)
{
    const long long bh = blockIdx.y;
    const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r < sq) {
        const long long row = bh * sq + r;
        ab_split_row(q + row * dqk, qp + (bh * AB_PARTS * sq + r) * dqp,
                     (long long)sq * dqp, dqk, dqp, lane);
        ab_split_row(dout + row * dv, dop + (bh * AB_PARTS * sq + r) * dvp,
                     (long long)sq * dvp, dv, dvp, lane);
        const float* orow = o + row * dv;
        const float* drow = dout + row * dv;
        float acc = 0.f;
        for (int c = lane; c < dv; c += 32) acc += orow[c] * drow[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) delta[row] = acc;
    } else if (r < (long long)sq + skv) {
        const long long kr = r - sq, row = bh * skv + kr;
        ab_split_row(k + row * dqk, kp + (bh * AB_PARTS * skv + kr) * dqp,
                     (long long)skv * dqp, dqk, dqp, lane);
        ab_split_row(v + row * dv, vp + (bh * AB_PARTS * skv + kr) * dvp,
                     (long long)skv * dvp, dv, dvp, lane);
    }
}

// ---------------------------------------------------------------------------
// (2) dK, dV: a block per (lane bh, OWN-key tile kt), from the first tile
// (the heaviest under a causal mask).  Consumer warpgroup w owns keys
// 64 w .. 64 w + 63 of the tile; the last warpgroup is the producer.  The
// maps are the launch's parameters; a map's lane coordinate is NP bh +
// part.  bf16 writes dK, dV through dk_map, dv_map; float32 into dk_out,
// dv_out (the lane's rows) by ab_flush.
// ---------------------------------------------------------------------------
template <class C>
__device__ __forceinline__ void
attn_bwd_dkdv(const CUtensorMap* q_map, const CUtensorMap* do_map,
              const CUtensorMap* k_map, const CUtensorMap* v_map,
              const CUtensorMap* dk_map, const CUtensorMap* dv_map,
              float* __restrict__ dk_out, float* __restrict__ dv_out,
              const float* __restrict__ lse, const float* __restrict__ delta,
              unsigned char* smem, int bh, int kt, int sq, int skv, int dqk,
              int dv_depth, int causal, int window, float scale)
{
    using L = AbKV<C>;
    constexpr int DQK = C::DQK, DV = C::DV, NP = C::NP, OWN = C::OWN;
    constexpr int BQ = L::BQ, PASSES = C::PASSES;
    unsigned char* ks = smem;
    unsigned char* vs = ks + L::K;
    unsigned char* ring = vs + L::V;
    const uint32_t bar0 = ab_smem(smem + L::BARS);
    // full[s] at bar0 + 8 s, empty[s] at bar0 + 8 (S + s), the K/V tiles'
    const uint32_t kv_bar = bar0 + 16 * AB_STAGES;

    const int tid = threadIdx.x;
    const int k0 = kt * OWN, off = skv - sq;
    // the queries that see some key of the tile: [q_lo, q_hi)
    const int k_last = min(k0 + OWN, skv) - 1;
    int q_lo = 0, q_hi = sq;
    if (causal) q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(sq, k_last + window - off);
    q_lo = q_lo / BQ * BQ;
    const int n_steps = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;

    if (tid == 0) {
        // full[s]: lane 0's expect_tx and the 32 lanes' arrivals after
        // they stored lse and delta, then the copies' bytes
        for (int s = 0; s < AB_STAGES; ++s) {
            mbar_init(bar0 + 8 * s, 1 + 32);
            mbar_init(bar0 + 8 * (AB_STAGES + s), C::NC * AB_WG);
        }
        mbar_init(kv_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= C::NC * AB_WG) {
        // the producer's first warp: lane 0 issues the copies, every lane
        // stages the step's lse and delta and arrives on its full barrier
        if constexpr (C::NC == 2)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid < C::NC * AB_WG + 32) {
            const int lane = tid & 31;
            if (lane == 0) {
                mbar_expect(kv_bar, L::K + L::V);
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
                    for (int i = 0; i < NP; ++i)
                        tma_load3(ab_smem(ks + (p * NP + i) * OWN * AB_ROW),
                                  k_map, 64 * p, k0, bh * NP + i, kv_bar);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
#pragma unroll
                    for (int i = 0; i < NP; ++i)
                        tma_load3(ab_smem(vs + (p * NP + i) * OWN * AB_ROW),
                                  v_map, 64 * p, k0, bh * NP + i, kv_bar);
            }
            for (int i = 0; i < n_steps; ++i) {
                const int s = i % AB_STAGES;
                if (i >= AB_STAGES)
                    mbar_wait(bar0 + 8 * (AB_STAGES + s),
                              (i / AB_STAGES - 1) & 1);
                const int q0 = q_lo + i * BQ;
                const uint32_t full = bar0 + 8 * s;
                unsigned char* sbp = ring + s * L::STAGE;
                if (lane == 0) {
                    const uint32_t sb = ab_smem(sbp);
                    mbar_expect(full, L::TX);
#pragma unroll
                    for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
                        for (int j = 0; j < NP; ++j)
                            tma_load3(sb + (p * NP + j) * BQ * AB_ROW, q_map,
                                      64 * p, q0, bh * NP + j, full);
#pragma unroll
                    for (int p = 0; p < DV / 64; ++p)
#pragma unroll
                        for (int j = 0; j < NP; ++j)
                            tma_load3(sb + L::Q + (p * NP + j) * BQ * AB_ROW,
                                      do_map, 64 * p, q0, bh * NP + j, full);
                }
                float* st = reinterpret_cast<float*>(sbp + L::Q + L::DO);
                for (int r = lane; r < BQ; r += 32) {
                    const bool in = q0 + r < sq;
                    const long long at = (long long)bh * sq + q0 + r;
                    st[r] = in ? lse[at] : 0.f;
                    st[BQ + r] = in ? delta[at] : 0.f;
                }
                mbar_arrive(full);
            }
        }
    } else {
        if constexpr (C::NC == 2)
            asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int w = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wk0 = k0 + 64 * w, wk1 = min(wk0 + 63, skv - 1);
        const int key0 = wk0 + 16 * wr + g;     // this thread's keys: +0, +8
        const float sl2 = scale * AB_LOG2E;
        // part i of this warpgroup's K (V) rows at ka (va) + i OWN rows
        const uint32_t ka = ab_smem(ks) + 64 * w * AB_ROW;
        const uint32_t va = ab_smem(vs) + 64 * w * AB_ROW;
        float dk[DQK / 64][32], dv[DV / 64][32], s[BQ / 2], dp[BQ / 2];
#pragma unroll
        for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dk[p][i] = 0.f;
#pragma unroll
        for (int p = 0; p < DV / 64; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dv[p][i] = 0.f;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
        bool flushed = false;
        mbar_wait(kv_bar, 0);

        for (int i = 0; i < n_steps; ++i) {
            const int st = i % AB_STAGES;
            unsigned char* sbp = ring + st * L::STAGE;
            // float32: the own tiles' addresses anew each step, so that
            // the compiler does not hold the 60 descriptors of their parts
            // across the loop (it spilled)
            uint32_t ka_s = ka, va_s = va;
            if constexpr (NP > 1)
                asm volatile("" : "+r"(ka_s), "+r"(va_s));
            // part j of the step's Q (dO) rows at qa (da) + j BQ rows
            const uint32_t qa = ab_smem(sbp), da = qa + L::Q;
            const float* lse_s = reinterpret_cast<const float*>(
                sbp + L::Q + L::DO);
            const float* dl_s = lse_s + BQ;
            const int q0 = q_lo + i * BQ;
            const int qv1 = min(q0 + BQ, sq) - 1;
            bool sees = wk0 < skv;
            if (causal) sees = sees && wk0 <= qv1 + off;
            if (window > 0) sees = sees && wk1 > q0 + off - window;
            mbar_wait(bar0 + 8 * st, (i / AB_STAGES) & 1);
            if (sees) {
                bool full = wk0 + 63 < skv && q0 + BQ <= sq;
                if (causal) full = full && wk0 + 63 <= q0 + off;
                if (window > 0)
                    full = full && wk0 > q0 + BQ - 1 + off - window;
                // S' = K Q', dP' = V dO'
                wg_fence();
#pragma unroll
                for (int n = 6 - PASSES; n < 6; ++n)
#pragma unroll
                    for (int kk = 0; kk < DQK / 16; ++kk)
                        wg_ss<BQ>(s,
                                  desc_k(ka_s + ab_pa(n) * OWN * AB_ROW,
                                         NP * OWN, kk),
                                  desc_k(qa + ab_pb(n) * BQ * AB_ROW, NP * BQ,
                                         kk),
                                  n > 6 - PASSES || kk > 0);
                wg_commit();
#pragma unroll
                for (int n = 6 - PASSES; n < 6; ++n)
#pragma unroll
                    for (int kk = 0; kk < DV / 16; ++kk)
                        wg_ss<BQ>(dp,
                                  desc_k(va_s + ab_pa(n) * OWN * AB_ROW,
                                         NP * OWN, kk),
                                  desc_k(da + ab_pb(n) * BQ * AB_ROW, NP * BQ,
                                         kk),
                                  n > 6 - PASSES || kk > 0);
                wg_commit();
                wg_wait<1>();
                wg_hold(s);
                // P' = exp(c S' - lse) where visible
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = 8 * j + 2 * t + (e & 1);
                        float p = exp2f(s[4 * j + e] * sl2
                                        - lse_s[c] * AB_LOG2E);
                        if (!full && !ab_visible(key0 + 8 * (e >> 1), q0 + c,
                                                 sq, skv, off, causal,
                                                 window))
                            p = 0.f;
                        s[4 * j + e] = p;
                    }
                wg_wait<0>();
                wg_hold(dp);
                // dS' = P' o (dP' - delta)
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        dp[4 * j + e] = s[4 * j + e]
                            * (dp[4 * j + e] - dl_s[8 * j + 2 * t + (e & 1)]);
                uint32_t pa[BQ / 16][NP][4], sa[BQ / 16][NP][4];
                ab_frags<BQ, NP>(pa, s);
                ab_frags<BQ, NP>(sa, dp);
                // dV += P' dO, dK += dS' Q
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
                    for (int n = 6 - PASSES; n < 6; ++n) {
                        wg_rs<DV>(dv, pa[kk][ab_pa(n)],
                                  da + ab_pb(n) * BQ * AB_ROW, NP * BQ, kk);
                        wg_rs<DQK>(dk, sa[kk][ab_pa(n)],
                                   qa + ab_pb(n) * BQ * AB_ROW, NP * BQ, kk);
                    }
                wg_commit();
                wg_wait<0>();
#pragma unroll
                for (int p = 0; p < DV / 64; ++p) wg_hold(dv[p]);
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p) wg_hold(dk[p]);
            }
            mbar_arrive(bar0 + 8 * (AB_STAGES + st));
            if constexpr (NP > 1) {
                if ((i + 1) % (AB_FLUSH_ROWS / BQ) == 0 && i + 1 < n_steps
                    && wk0 < skv) {
                    ab_flush<DQK>(dk_out, dk, key0, skv, dqk, scale,
                                  !flushed);
                    ab_flush<DV>(dv_out, dv, key0, skv, dv_depth, 1.f,
                                 !flushed);
                    flushed = true;
                }
            }
        }

        if constexpr (NP > 1) {
            if (wk0 < skv) {
                ab_flush<DQK>(dk_out, dk, key0, skv, dqk, scale, !flushed);
                ab_flush<DV>(dv_out, dv, key0, skv, dv_depth, 1.f, !flushed);
            }
        } else if (wk0 < skv) {
            // c dK and dV in bf16 over this warpgroup's rows of the K and V
            // tiles, then out through the maps (which clip rows past Skv
            // and depth past D)
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
                ab_stage_out(ks + (p * OWN + 64 * w) * AB_ROW, dk[p], scale);
#pragma unroll
            for (int p = 0; p < DV / 64; ++p)
                ab_stage_out(vs + (p * OWN + 64 * w) * AB_ROW, dv[p], 1.f);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(AB_WG)
                         : "memory");
            if ((tid & (AB_WG - 1)) == 0) {
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
                    tma_store3(dk_map,
                               ab_smem(ks + (p * OWN + 64 * w) * AB_ROW),
                               64 * p, wk0, bh);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
                    tma_store3(dv_map,
                               ab_smem(vs + (p * OWN + 64 * w) * AB_ROW),
                               64 * p, wk0, bh);
                tma_store_drain();
            }
        }
    }
}

// ---------------------------------------------------------------------------
// (3) dQ: a block per (lane bh, OWN-query tile), `qt` counting from the
// last tile (the heaviest under a causal mask).  Consumer warpgroup w owns
// queries 64 w .. 64 w + 63 of the tile; the last warpgroup is the
// producer.  bf16 writes dQ through dq_map, float32 into dq_out.
// ---------------------------------------------------------------------------
template <class C>
__device__ __forceinline__ void
attn_bwd_dq(const CUtensorMap* q_map, const CUtensorMap* do_map,
            const CUtensorMap* k_map, const CUtensorMap* v_map,
            const CUtensorMap* dq_map, float* __restrict__ dq_out,
            const float* __restrict__ lse, const float* __restrict__ delta,
            unsigned char* smem, int bh, int qt, int sq, int skv, int dqk,
            int causal, int window, float scale)
{
    using L = AbQ<C>;
    constexpr int DQK = C::DQK, DV = C::DV, NP = C::NP, OWN = C::OWN;
    constexpr int BKD = L::BKD, PASSES = C::PASSES;
    unsigned char* qs = smem;
    unsigned char* dos = qs + L::Q;
    unsigned char* ring = dos + L::DO;
    const uint32_t bar0 = ab_smem(smem + L::BARS);
    const uint32_t own_bar = bar0 + 16 * AB_STAGES;

    const int tid = threadIdx.x;
    const int n_qt = (sq + OWN - 1) / OWN;
    const int q0 = (n_qt - 1 - qt) * OWN, off = skv - sq;
    // the keys some query of the tile sees: [k_lo, k_hi)
    const int qa_lo = q0 + off, qa_hi = min(q0 + OWN, sq) - 1 + off;
    int k_lo = 0, k_hi = skv;
    if (window > 0) k_lo = max(0, qa_lo - window + 1);
    if (causal) k_hi = min(skv, qa_hi + 1);
    k_lo = k_lo / BKD * BKD;
    const int n_steps = k_hi > k_lo ? (k_hi - k_lo + BKD - 1) / BKD : 0;

    if (tid == 0) {
        for (int s = 0; s < AB_STAGES; ++s) {
            mbar_init(bar0 + 8 * s, 1);
            mbar_init(bar0 + 8 * (AB_STAGES + s), C::NC * AB_WG);
        }
        mbar_init(own_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= C::NC * AB_WG) {
        if constexpr (C::NC == 2)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid == C::NC * AB_WG) {
            mbar_expect(own_bar, L::Q + L::DO);
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
                for (int i = 0; i < NP; ++i)
                    tma_load3(ab_smem(qs + (p * NP + i) * OWN * AB_ROW),
                              q_map, 64 * p, q0, bh * NP + i, own_bar);
#pragma unroll
            for (int p = 0; p < DV / 64; ++p)
#pragma unroll
                for (int i = 0; i < NP; ++i)
                    tma_load3(ab_smem(dos + (p * NP + i) * OWN * AB_ROW),
                              do_map, 64 * p, q0, bh * NP + i, own_bar);
            for (int i = 0; i < n_steps; ++i) {
                const int s = i % AB_STAGES;
                if (i >= AB_STAGES)
                    mbar_wait(bar0 + 8 * (AB_STAGES + s),
                              (i / AB_STAGES - 1) & 1);
                const int kb = k_lo + i * BKD;
                const uint32_t full = bar0 + 8 * s;
                const uint32_t sb = ab_smem(ring + s * L::STAGE);
                mbar_expect(full, L::TX);
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
                    for (int j = 0; j < NP; ++j)
                        tma_load3(sb + (p * NP + j) * BKD * AB_ROW, k_map,
                                  64 * p, kb, bh * NP + j, full);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
#pragma unroll
                    for (int j = 0; j < NP; ++j)
                        tma_load3(sb + L::K + (p * NP + j) * BKD * AB_ROW,
                                  v_map, 64 * p, kb, bh * NP + j, full);
            }
        }
    } else {
        if constexpr (C::NC == 2)
            asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int w = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wq0 = q0 + 64 * w, wq1 = min(wq0 + 63, sq - 1);
        const int row0 = wq0 + 16 * wr + g;     // this thread's rows: +0, +8
        const float sl2 = scale * AB_LOG2E;
        float lse2[2], dl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            const long long at = (long long)bh * sq + row;
            lse2[h] = row < sq ? lse[at] * AB_LOG2E : 0.f;
            dl[h] = row < sq ? delta[at] : 0.f;
        }
        // part i of this warpgroup's Q (dO) rows at qa (da) + i OWN rows
        const uint32_t qa = ab_smem(qs) + 64 * w * AB_ROW;
        const uint32_t da = ab_smem(dos) + 64 * w * AB_ROW;
        float dq[DQK / 64][32], s[BKD / 2], dp[BKD / 2];
#pragma unroll
        for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
#pragma unroll
        for (int i = 0; i < BKD / 2; ++i) s[i] = dp[i] = 0.f;
        bool flushed = false;
        mbar_wait(own_bar, 0);

        for (int i = 0; i < n_steps; ++i) {
            const int st = i % AB_STAGES;
            uint32_t qa_s = qa, da_s = da;      // as in (2)
            if constexpr (NP > 1)
                asm volatile("" : "+r"(qa_s), "+r"(da_s));
            // part j of the step's K (V) rows at ka (va) + j BKD rows
            const uint32_t ka = ab_smem(ring + st * L::STAGE), va = ka + L::K;
            const int kb = k_lo + i * BKD;
            bool sees = wq0 < sq && kb < skv;
            if (causal) sees = sees && kb <= wq1 + off;
            if (window > 0) sees = sees && kb + BKD - 1 > wq0 + off - window;
            mbar_wait(bar0 + 8 * st, (i / AB_STAGES) & 1);
            if (sees) {
                bool full = wq0 + 63 < sq && kb + BKD <= skv;
                if (causal) full = full && kb + BKD - 1 <= wq0 + off;
                if (window > 0) full = full && kb > wq0 + 63 + off - window;
                // S = Q K', dP = dO V'
                wg_fence();
#pragma unroll
                for (int n = 6 - PASSES; n < 6; ++n)
#pragma unroll
                    for (int kk = 0; kk < DQK / 16; ++kk)
                        wg_ss<BKD>(s,
                                   desc_k(qa_s + ab_pa(n) * OWN * AB_ROW,
                                          NP * OWN, kk),
                                   desc_k(ka + ab_pb(n) * BKD * AB_ROW,
                                          NP * BKD, kk),
                                   n > 6 - PASSES || kk > 0);
                wg_commit();
#pragma unroll
                for (int n = 6 - PASSES; n < 6; ++n)
#pragma unroll
                    for (int kk = 0; kk < DV / 16; ++kk)
                        wg_ss<BKD>(dp,
                                   desc_k(da_s + ab_pa(n) * OWN * AB_ROW,
                                          NP * OWN, kk),
                                   desc_k(va + ab_pb(n) * BKD * AB_ROW,
                                          NP * BKD, kk),
                                   n > 6 - PASSES || kk > 0);
                wg_commit();
                wg_wait<1>();
                wg_hold(s);
#pragma unroll
                for (int j = 0; j < BKD / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float p = exp2f(s[4 * j + e] * sl2 - lse2[e >> 1]);
                        if (!full && !ab_visible(kb + 8 * j + 2 * t + (e & 1),
                                                 row0 + 8 * (e >> 1), sq,
                                                 skv, off, causal, window))
                            p = 0.f;
                        s[4 * j + e] = p;
                    }
                wg_wait<0>();
                wg_hold(dp);
#pragma unroll
                for (int i2 = 0; i2 < BKD / 2; ++i2)
                    dp[i2] = s[i2] * (dp[i2] - dl[(i2 >> 1) & 1]);
                uint32_t sa[BKD / 16][NP][4];
                ab_frags<BKD, NP>(sa, dp);
                // dQ += dS K
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BKD / 16; ++kk)
#pragma unroll
                    for (int n = 6 - PASSES; n < 6; ++n)
                        wg_rs<DQK>(dq, sa[kk][ab_pa(n)],
                                   ka + ab_pb(n) * BKD * AB_ROW, NP * BKD,
                                   kk);
                wg_commit();
                wg_wait<0>();
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p) wg_hold(dq[p]);
            }
            mbar_arrive(bar0 + 8 * (AB_STAGES + st));
            if constexpr (NP > 1) {
                if ((i + 1) % (AB_FLUSH_ROWS / BKD) == 0 && i + 1 < n_steps
                    && wq0 < sq) {
                    ab_flush<DQK>(dq_out, dq, row0, sq, dqk, scale, !flushed);
                    flushed = true;
                }
            }
        }

        if constexpr (NP > 1) {
            if (wq0 < sq)
                ab_flush<DQK>(dq_out, dq, row0, sq, dqk, scale, !flushed);
        } else if (wq0 < sq) {
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
                ab_stage_out(qs + (p * OWN + 64 * w) * AB_ROW, dq[p], scale);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(AB_WG)
                         : "memory");
            if ((tid & (AB_WG - 1)) == 0) {
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
                    tma_store3(dq_map,
                               ab_smem(qs + (p * OWN + 64 * w) * AB_ROW),
                               64 * p, wq0, bh);
                tma_store_drain();
            }
        }
    }
}

// ---------------------------------------------------------------------------
// (2) and (3) in one launch.  bf16: blockIdx.x is the lane, blockIdx.y
// below ceil(Skv / 128) a dK/dV block, above it a dQ block, so the two
// passes' blocks share the card (small calls run in the time of one pass,
// large ones lose one tail).  The shared memory is the larger pass's.
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__global__ void __launch_bounds__(AbCfg<DQK, DV, 1>::THREADS, 1)
attn_bwd_kernel(const __grid_constant__ CUtensorMap q_walk,
                const __grid_constant__ CUtensorMap do_walk,
                const __grid_constant__ CUtensorMap k_own,
                const __grid_constant__ CUtensorMap v_own,
                const __grid_constant__ CUtensorMap dk_out,
                const __grid_constant__ CUtensorMap dv_out,
                const __grid_constant__ CUtensorMap q_own,
                const __grid_constant__ CUtensorMap do_own,
                const __grid_constant__ CUtensorMap k_walk,
                const __grid_constant__ CUtensorMap v_walk,
                const __grid_constant__ CUtensorMap dq_out,
                const float* __restrict__ lse,
                const float* __restrict__ delta, int sq, int skv,
                int causal, int window, float scale)
{
    using C = AbCfg<DQK, DV, 1>;
    extern __shared__ unsigned char ab_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(ab_raw) + 1023) & ~(uintptr_t)1023);
    const int n_kt = (skv + C::OWN - 1) / C::OWN;
    if ((int)blockIdx.y < n_kt)
        attn_bwd_dkdv<C>(&q_walk, &do_walk, &k_own, &v_own, &dk_out, &dv_out,
                         nullptr, nullptr, lse, delta, smem, blockIdx.x,
                         blockIdx.y, sq, skv, DQK, DV, causal, window, scale);
    else
        attn_bwd_dq<C>(&q_own, &do_own, &k_walk, &v_walk, &dq_out, nullptr,
                       lse, delta, smem, blockIdx.x,
                       (int)blockIdx.y - n_kt, sq, skv, DQK, causal, window,
                       scale);
}

// float32: the tiles on x, the lanes on y; block b = y gridDim.x + x is
// lane b % BH of tile b / BH (the bf16 grid's order: lane fastest).  The
// maps read the prologue's parts; dq, dk, dv are the caller's outputs
template <int DQK, int DV>
__global__ void __launch_bounds__(AbCfg<DQK, DV, AB_PARTS>::THREADS, 1)
attn_bwd_f32_kernel(const __grid_constant__ CUtensorMap q_walk,
                    const __grid_constant__ CUtensorMap do_walk,
                    const __grid_constant__ CUtensorMap k_own,
                    const __grid_constant__ CUtensorMap v_own,
                    const __grid_constant__ CUtensorMap q_own,
                    const __grid_constant__ CUtensorMap do_own,
                    const __grid_constant__ CUtensorMap k_walk,
                    const __grid_constant__ CUtensorMap v_walk,
                    float* __restrict__ dq, float* __restrict__ dk,
                    float* __restrict__ dv, const float* __restrict__ lse,
                    const float* __restrict__ delta, int sq, int skv,
                    int dqk, int dv_depth, int causal, int window,
                    float scale)
{
    using C = AbCfg<DQK, DV, AB_PARTS>;
    extern __shared__ unsigned char ab_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(ab_raw) + 1023) & ~(uintptr_t)1023);
    const int n_kt = (skv + C::OWN - 1) / C::OWN;
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    const int bh = (int)(b % gridDim.y), tile = (int)(b / gridDim.y);
    if (tile < n_kt)
        attn_bwd_dkdv<C>(&q_walk, &do_walk, &k_own, &v_own, nullptr, nullptr,
                         dk + (long long)bh * skv * dqk,
                         dv + (long long)bh * skv * dv_depth, lse, delta,
                         smem, bh, tile, sq, skv, dqk, dv_depth, causal,
                         window, scale);
    else
        attn_bwd_dq<C>(&q_own, &do_own, &k_walk, &v_walk, nullptr,
                       dq + (long long)bh * sq * dqk, lse, delta, smem, bh,
                       tile - n_kt, sq, skv, dqk, causal, window, scale);
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------
typedef CUresult (*AbEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
AbEncodeTiled ab_encoder()
{
    static AbEncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &found)
                == cudaSuccess
            && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<AbEncodeTiled>(p);
    }
    return fn;
}

// a (BH, rows, depth) bf16 tensor as a 3-D map: boxes of 64 columns x
// box_rows rows of one lane, 128-byte swizzle, zeros past the edges
bool ab_map3(AbEncodeTiled enc, CUtensorMap* m, const void* ptr, int bh,
             int rows, int depth, int box_rows)
{
    const cuuint64_t dims[3] = {(cuuint64_t)depth, (cuuint64_t)rows,
                                (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)depth * 2,
                                   (cuuint64_t)rows * depth * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted)
{
    if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) *granted = bytes;
    return err;
}

// the launch of (2) and (3) at the depth class (DQK, DV), after delta
template <int DQK, int DV>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dvo,
                            int bh, int sq, int skv, int dqk, int dv,
                            int causal, int window, float scale,
                            cudaStream_t stream)
{
    using C = AbCfg<DQK, DV, 1>;
    constexpr int SMEM = ab_smem_bytes<C>();
    static size_t granted = 0;
    cudaError_t err = allow_smem(attn_bwd_kernel<DQK, DV>, SMEM, &granted);
    if (err != cudaSuccess) return err;
    const AbEncodeTiled enc = ab_encoder();
    if (enc == nullptr) return cudaErrorNotSupported;
    CUtensorMap m_qw, m_dow, m_k, m_v, m_dk, m_dv;
    CUtensorMap m_q, m_do, m_kw, m_vw, m_dq;
    const bool ok =
        ab_map3(enc, &m_qw, q, bh, sq, dqk, C::BQ)
        && ab_map3(enc, &m_dow, dout, bh, sq, dv, C::BQ)
        && ab_map3(enc, &m_k, k, bh, skv, dqk, C::OWN)
        && ab_map3(enc, &m_v, v, bh, skv, dv, C::OWN)
        && ab_map3(enc, &m_dk, dk, bh, skv, dqk, 64)
        && ab_map3(enc, &m_dv, dvo, bh, skv, dv, 64)
        && ab_map3(enc, &m_q, q, bh, sq, dqk, C::OWN)
        && ab_map3(enc, &m_do, dout, bh, sq, dv, C::OWN)
        && ab_map3(enc, &m_kw, k, bh, skv, dqk, C::BKD)
        && ab_map3(enc, &m_vw, v, bh, skv, dv, C::BKD)
        && ab_map3(enc, &m_dq, dq, bh, sq, dqk, 64);
    if (!ok) return cudaErrorInvalidValue;
    const int n_kt = (skv + C::OWN - 1) / C::OWN;
    const int n_qt = (sq + C::OWN - 1) / C::OWN;
    attn_bwd_kernel<DQK, DV><<<dim3(bh, n_kt + n_qt), C::THREADS, SMEM,
                               stream>>>(
        m_qw, m_dow, m_k, m_v, m_dk, m_dv, m_q, m_do, m_kw, m_vw,
        m_dq, (const float*)lse, (const float*)delta, sq, skv, causal, window,
        scale);
    return cudaGetLastError();
}

// float32: the launch of (2) and (3) at the depth class (DQK, DV) on the
// prologue's parts (qp, kp, vp, dop: (BH, 3, S, dqp or dvp) bf16)
template <int DQK, int DV>
cudaError_t launch_attn_bwd_f32(const void* qp, const void* kp,
                                const void* vp, const void* dop,
                                const void* lse, const void* delta, void* dq,
                                void* dk, void* dvo, int bh, int sq, int skv,
                                int dqk, int dv, int dqp, int dvp,
                                int causal, int window, float scale,
                                cudaStream_t stream)
{
    using C = AbCfg<DQK, DV, AB_PARTS>;
    constexpr int SMEM = ab_smem_bytes<C>();
    static size_t granted = 0;
    cudaError_t err = allow_smem(attn_bwd_f32_kernel<DQK, DV>, SMEM,
                                 &granted);
    if (err != cudaSuccess) return err;
    const AbEncodeTiled enc = ab_encoder();
    if (enc == nullptr) return cudaErrorNotSupported;
    const int lanes = AB_PARTS * bh;
    CUtensorMap m_qw, m_dow, m_k, m_v, m_q, m_do, m_kw, m_vw;
    const bool ok =
        ab_map3(enc, &m_qw, qp, lanes, sq, dqp, C::BQ)
        && ab_map3(enc, &m_dow, dop, lanes, sq, dvp, C::BQ)
        && ab_map3(enc, &m_k, kp, lanes, skv, dqp, C::OWN)
        && ab_map3(enc, &m_v, vp, lanes, skv, dvp, C::OWN)
        && ab_map3(enc, &m_q, qp, lanes, sq, dqp, C::OWN)
        && ab_map3(enc, &m_do, dop, lanes, sq, dvp, C::OWN)
        && ab_map3(enc, &m_kw, kp, lanes, skv, dqp, C::BKD)
        && ab_map3(enc, &m_vw, vp, lanes, skv, dvp, C::BKD);
    if (!ok) return cudaErrorInvalidValue;
    const long long tiles = ((long long)skv + C::OWN - 1) / C::OWN
        + ((long long)sq + C::OWN - 1) / C::OWN;
    attn_bwd_f32_kernel<DQK, DV><<<dim3((unsigned)tiles, bh), C::THREADS,
                                   SMEM, stream>>>(
        m_qw, m_dow, m_k, m_v, m_q, m_do, m_kw, m_vw, (float*)dq, (float*)dk,
        (float*)dvo, (const float*)lse, (const float*)delta, sq, skv, dqk,
        dv, causal, window, scale);
    return cudaGetLastError();
}

// the depth classes the kernels are built for: (Dqk, Dv) padded up to
// (64, 64), (128, 128) or (192, 128); 0 where none takes the pair
inline int ab_class(int dqk, int dv)
{
    if (dqk <= 64 && dv <= 64) return 1;
    if (dqk <= 128 && dv <= 128) return 2;
    if (dqk <= 192 && dv <= 128) return 3;
    return 0;
}

}  // namespace

// K5's bf16 backward in two launches (delta, then dK/dV and dQ) on the
// forward's o and lse (BH, Sq) float32: dq, dk, dv (q's, k's and v's
// shapes) and the scratch delta (BH, Sq) float32 are the caller's.  Masks
// as the forward's (Sq <= Skv unless nothing is masked); Dqk, Dv % 8 == 0
// within a depth class; ceil(Sq / 128) + ceil(Skv / 128) at most 65535;
// BH Sq rows at most 8 (2^31 - 1) (delta's grid, a warp a row); every
// tensor 16-byte aligned (the tensor maps' rule)
extern "C" int repro_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse,
                              const void* dout, void* delta, void* dq,
                              void* dk, void* dvo, int bh, int sq, int skv,
                              int dqk, int dv, int causal, int window,
                              float scale, void* stream)
{
    using C = AbCfg<64, 64, 1>;                 // every class's OWN: 128
    const int cls = ab_class(dqk, dv);
    if (bh < 1 || sq < 1 || skv < 1 || dqk < 8 || dv < 8 || dqk % 8 != 0
        || dv % 8 != 0 || cls == 0 || (sq > skv && (causal || window > 0))
        || (skv + C::OWN - 1) / C::OWN + (sq + C::OWN - 1) / C::OWN > 65535
        || (long long)bh * sq > 8LL * 2147483647
        || (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o
             | (uintptr_t)lse | (uintptr_t)dout | (uintptr_t)delta
             | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dvo) & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const long long rows = (long long)bh * sq;
    attn_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta,
        rows, dv);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (cls) {
    case 1:
        return (int)launch_attn_bwd<64, 64>(q, k, v, dout, lse, delta, dq, dk,
                                            dvo, bh, sq, skv, dqk, dv, causal,
                                            window, scale, st);
    case 2:
        return (int)launch_attn_bwd<128, 128>(q, k, v, dout, lse, delta, dq,
                                              dk, dvo, bh, sq, skv, dqk, dv,
                                              causal, window, scale, st);
    default:
        return (int)launch_attn_bwd<192, 128>(q, k, v, dout, lse, delta, dq,
                                              dk, dvo, bh, sq, skv, dqk, dv,
                                              causal, window, scale, st);
    }
}

// K5's float32 backward in two launches (the prologue: delta and the
// parts; then dK/dV and dQ) on the forward's o and lse (BH, Sq) float32:
// dq, dk, dv (q's, k's and v's shapes), the scratch delta (BH, Sq) float32
// and the scratch parts qp, kp, vp, dop (BH, 3, S, D rounded up to 8)
// bf16 of q, k, v, dO are the caller's.  Masks as the forward's (Sq <= Skv
// unless nothing is masked); any Dqk, Dv within a depth class; BH at most
// 65535 (the grid's y); the parts 16-byte aligned (the tensor maps' rule),
// the float32 tensors at any float's alignment
extern "C" int repro_attn_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout,
                                  void* delta, void* qp, void* kp, void* vp,
                                  void* dop, void* dq, void* dk, void* dvo,
                                  int bh, int sq, int skv, int dqk, int dv,
                                  int causal, int window, float scale,
                                  void* stream)
{
    const int cls = ab_class(dqk, dv);
    if (bh < 1 || bh > 65535 || sq < 1 || skv < 1 || dqk < 1 || dv < 1
        || cls == 0 || (sq > skv && (causal || window > 0))
        || (((uintptr_t)qp | (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)dop)
            & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int dqp = (dqk + 7) / 8 * 8, dvp = (dv + 7) / 8 * 8;
    const dim3 grid((unsigned)(((long long)sq + skv + 7) / 8), bh);
    attn_bwd_split_kernel<<<grid, 256, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)dout, (float*)delta, (__nv_bfloat16*)qp,
        (__nv_bfloat16*)kp, (__nv_bfloat16*)vp, (__nv_bfloat16*)dop, sq, skv,
        dqk, dv, dqp, dvp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (cls) {
    case 1:
        return (int)launch_attn_bwd_f32<64, 64>(
            qp, kp, vp, dop, lse, delta, dq, dk, dvo, bh, sq, skv, dqk, dv,
            dqp, dvp, causal, window, scale, st);
    case 2:
        return (int)launch_attn_bwd_f32<128, 128>(
            qp, kp, vp, dop, lse, delta, dq, dk, dvo, bh, sq, skv, dqk, dv,
            dqp, dvp, causal, window, scale, st);
    default:
        return (int)launch_attn_bwd_f32<192, 128>(
            qp, kp, vp, dop, lse, delta, dq, dk, dvo, bh, sq, skv, dqk, dv,
            dqp, dvp, causal, window, scale, st);
    }
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
