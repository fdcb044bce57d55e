// Hopper (sm_90a) kernels for the gradient of flash attention in
// bfloat16 (K5's backward).
//
// Built by kernels/build.py with nvcc into a shared library of its own,
// with a plain C interface, loaded with ctypes; no PyTorch header is
// included.  The entry point launches on the stream it is given,
// allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
//   repro_attn_bwd   dq, dk, dv of softmax attention over folded heads,
//                    from q (BH, Sq, Dqk), k (BH, Skv, Dqk), v (BH, Skv,
//                    Dv), the forward's o and row log-sum-exp lse, and
//                    the output's gradient dO, all bfloat16 but lse
//                    (float32); queries aligned to the keys' suffix,
//                    causal and sliding-window masks as the forward's
//
// Replaces no TPU kernel: the reference's flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no VJP, and the reference
// differentiates its jnp attention.  It replaces the first bf16 backward
// of this port (flash_attention_bwd_{delta,dkdv,dq}_kernel in lm.cu,
// mma.sync on tiles loaded synchronously), which lm.cu keeps for float32
// operands only.  Two launches: delta, then one grid of the dK/dV and
// the dQ blocks.  With c = 1/sqrt(Dqk), P = exp(c Q K' - lse) and dO the
// output's gradient:
//   (1) delta_i = sum_d dO_id O_id                          (float32)
//   (2) per key tile:   dV = P' dO,  dS = P o (dO V' - delta),  dK = c dS' Q
//   (3) per query tile:              dQ = c dS K
//
// Bound on an H100: five products a visible (query, key) pair, 2 Dqk each
// for Q K', dK and dQ, 2 Dv each for dO V' and dV.  At h2o-danube-3-4b's
// training call (BH 256, S 4096, D 120) causal that is 2.58 TFLOP: 2.606
// ms at the 989 TFLOP/s bf16 rate, bound by operations (q k v o dO in,
// dq dk dv out are 1.8 GB: 0.54 ms).  The kernel it replaces took 40.41
// ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design, against the four faults of the kernel it replaces:
// - Tensor cores through wgmma (it had mma.sync, each warp reloading its
//   B fragments with ldmatrix).  Consumer warpgroups of 64 rows issue
//   wgmma.mma_async m64nNk16 bf16 with float32 accumulators.  (2): S' =
//   K Q' and dP' = V dO' take both operands from shared memory (K-major);
//   dV += P' dO and dK += dS' Q take P' and dS' from registers (the
//   accumulator fragments rounded once to bf16, as before) and the Q or
//   dO tile as B with the transpose bit (MN-major: those tiles sit
//   query-major).  (3) mirrored: S = Q K', dP = dO V' from shared memory,
//   dQ += dS K with dS from registers.  The register-A products run
//   m64n128k16 over each pair of 64-column panels (m64n64k16 for an odd
//   one), so an A fragment feeds 128 columns.
// - Asynchronous copies (it loaded every tile synchronously between two
//   __syncthreads()).  A producer warpgroup (one thread issuing, its
//   registers given to the consumers by setmaxnreg) keeps a two-stage
//   ring of the walked tiles full with TMA loads that complete on
//   mbarriers: Q and dO for (2), K and V for (3); the block's own tiles
//   are loaded once.  (2)'s stages also hold the step's lse and delta,
//   which the producer's first warp loads and stores itself before it
//   arrives on the stage's barrier: a 1-D tensor map over the BH Sq rows
//   faulted on the card wherever Sq % 4 != 0 (its boxes then start off
//   16 bytes).  3-D tensor maps over (BH, S, D) bring
//   rows past Sq or Skv and depth past D in as zeros within each lane;
//   the boxes are 64 columns (128 bytes) wide with the 128-byte swizzle
//   that wgmma's descriptors read, so D is padded in shared memory to a
//   multiple of 64 (h2o's 120 to 128).  dq, dk and dv go out through
//   maps of their own, which clip the padding and the ragged rows.
// - Larger tiles (it took 64 keys against 32-query steps, 128 threads).
//   (2): 128 keys a block (two consumer warpgroups) against 64-query
//   steps, 32-query steps at Dqk 192 (MLA), where the dK accumulator
//   alone is 96 registers a thread.  (3): 128 queries a block against
//   128-key steps (64 at Dqk 192).  384 threads a block, one block an SM;
//   the consumers get 240 registers (PERF.md has ptxas's spills).  A
//   third ring stage, and issuing a step's S' before the last step's dV,
//   dK products completed, were slower (the latter spilled).
// - Products.  dQ stays a pass of its own, so a visible pair costs seven
//   products where five are needed (Q K' and dO V' twice), as before:
//   folding dQ into (2) without atomics needs each query tile's partials
//   added in key-tile order through a counter (FlashAttention-3's
//   deterministic mode); float atomics would change the bits from run to
//   run, and a float32 partial a key tile is 17 GB at h2o's row.  Every
//   output is written by one block, summed in a fixed order: the same
//   inputs give the same bits.  The two passes' blocks share one grid,
//   so a small call runs in about the time of one pass.
// - Masks as the forward's (causal, window, queries aligned to the keys'
//   suffix, Sq != Skv where nothing is masked); the tiles no query or key
//   of a block can see are not walked, a warpgroup skips the steps none
//   of its rows can see, and only diagonal and edge tiles are masked
//   element by element.  Causal blocks run heaviest first: (2) from the
//   first key tile, (3) from the last query tile.
// - Depth classes: Dqk, Dv are padded to (64, 64), (128, 128) or (192,
//   128) by the tensor maps' zero fill, which does not change the
//   function; every bf16 pair of kernels/flash_attention.py DEPTH_PAIRS
//   falls in one.  Skipped rows, padded depth and ragged edges add no
//   work to the bound, which counts the real D.
// - delta is a launch of its own, 16-byte loads, a warp a row.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int AB_WG = 128;                  // threads of a warpgroup
// two consumer warpgroups and a producer
constexpr int AB_THREADS = 3 * AB_WG;
constexpr int AB_BKV = 2 * 64;              // keys of a dK/dV block
constexpr int AB_BQD = 2 * 64;              // queries of a dQ block
constexpr int AB_STAGES = 2;                // the walked tiles' ring
constexpr int AB_ROW = 128;                 // bytes of a panel row (64 bf16)
constexpr float AB_LOG2E = 1.4426950408889634f;
// an mbarrier wait that has spun this many cycles (about 10 s) traps: a
// fault in the pipeline ends the launch with an error instead of hanging
constexpr long long AB_SPIN_CYCLES = 20000000000LL;

// query rows of a dK/dV step: 32 at Dqk 192, where the dK accumulator is
// 96 registers a thread
__host__ __device__ constexpr int ab_bq(int dqk)
{
    return dqk > 128 ? 32 : 64;
}

// keys of a dQ step: 64 at Dqk 192
__host__ __device__ constexpr int ab_bkd(int dqk)
{
    return dqk > 128 ? 64 : 128;
}

__host__ __device__ constexpr int ab_round1024(int n)
{
    return (n + 1023) / 1024 * 1024;
}

// the shared memory of a dK/dV block: its K and V tiles (128 keys), then
// the ring's stages (Q, dO, lse, delta of BQ queries), then the
// mbarriers; every tile is depth / 64 panels of rows x 128 bytes
template <int DQK, int DV>
struct AbKV {
    static constexpr int BQ = ab_bq(DQK);
    static constexpr int K = AB_BKV * DQK * 2, V = AB_BKV * DV * 2;
    static constexpr int Q = BQ * DQK * 2, DO = BQ * DV * 2;
    static constexpr int TX = Q + DO;
    static constexpr int STAGE = ab_round1024(TX + 2 * BQ * 4);
    static constexpr int BARS = K + V + AB_STAGES * STAGE;
    static constexpr int SMEM = 1024 + BARS + 8 * (2 * AB_STAGES + 1);
};

// a dQ block's: its Q and dO tiles (128 queries), the ring's stages (K
// and V of BKD keys), the mbarriers
template <int DQK, int DV>
struct AbQ {
    static constexpr int BKD = ab_bkd(DQK);
    static constexpr int Q = AB_BQD * DQK * 2, DO = AB_BQD * DV * 2;
    static constexpr int K = BKD * DQK * 2, V = BKD * DV * 2;
    static constexpr int TX = K + V;
    static constexpr int STAGE = ab_round1024(TX);
    static constexpr int BARS = Q + DO + AB_STAGES * STAGE;
    static constexpr int SMEM = 1024 + BARS + 8 * (2 * AB_STAGES + 1);
};

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
    else wg_ss32(d, a, b, acc);
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

// the A fragments of a 64 x 16 kk step from an accumulator (64 x N)
template <int N>
__device__ __forceinline__ void ab_frags(uint32_t (&a)[N / 16][4],
                                         const float (&d)[N / 2])
{
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a[kk][r] = ab_pack(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
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
// (2) dK, dV: a block per (lane, 128-key tile) `kt`, from the first tile
// (the heaviest under a causal mask).  Warpgroups 0 and 1 own keys 0-63
// and 64-127 of the tile; warpgroup 2 is the producer.  The maps are the
// launch's parameters.
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__device__ __forceinline__ void
attn_bwd_dkdv(const CUtensorMap* q_map, const CUtensorMap* do_map,
              const CUtensorMap* k_map, const CUtensorMap* v_map,
              const CUtensorMap* dk_map, const CUtensorMap* dv_map,
              const float* __restrict__ lse, const float* __restrict__ delta,
              unsigned char* smem, int kt, int sq, int skv, int causal,
              int window, float scale)
{
    using L = AbKV<DQK, DV>;
    constexpr int BQ = L::BQ;
    unsigned char* ks = smem;
    unsigned char* vs = ks + L::K;
    unsigned char* ring = vs + L::V;
    const uint32_t bar0 = ab_smem(smem + L::BARS);
    // full[s] at bar0 + 8 s, empty[s] at bar0 + 8 (S + s), the K/V tiles'
    const uint32_t kv_bar = bar0 + 16 * AB_STAGES;

    const int tid = threadIdx.x, bh = blockIdx.x;
    const int k0 = kt * AB_BKV, off = skv - sq;
    // the queries that see some key of the tile: [q_lo, q_hi)
    const int k_last = min(k0 + AB_BKV, skv) - 1;
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
            mbar_init(bar0 + 8 * (AB_STAGES + s), 2 * AB_WG);
        }
        mbar_init(kv_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 2 * AB_WG) {
        // the producer's first warp: lane 0 issues the copies, every lane
        // stages the step's lse and delta and arrives on its full barrier
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid < 2 * AB_WG + 32) {
            const int lane = tid & 31;
            if (lane == 0) {
                mbar_expect(kv_bar, L::K + L::V);
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
                    tma_load3(ab_smem(ks + p * AB_BKV * AB_ROW), k_map,
                              64 * p, k0, bh, kv_bar);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
                    tma_load3(ab_smem(vs + p * AB_BKV * AB_ROW), v_map,
                              64 * p, k0, bh, kv_bar);
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
                        tma_load3(sb + p * BQ * AB_ROW, q_map, 64 * p, q0,
                                  bh, full);
#pragma unroll
                    for (int p = 0; p < DV / 64; ++p)
                        tma_load3(sb + L::Q + p * BQ * AB_ROW, do_map,
                                  64 * p, q0, bh, full);
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
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int w = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wk0 = k0 + 64 * w, wk1 = min(wk0 + 63, skv - 1);
        const int key0 = wk0 + 16 * wr + g;     // this thread's keys: +0, +8
        const float sl2 = scale * AB_LOG2E;
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
        mbar_wait(kv_bar, 0);

        for (int i = 0; i < n_steps; ++i) {
            const int st = i % AB_STAGES;
            unsigned char* sbp = ring + st * L::STAGE;
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
                for (int kk = 0; kk < DQK / 16; ++kk)
                    wg_ss<BQ>(s, desc_k(ka, AB_BKV, kk), desc_k(qa, BQ, kk),
                              kk > 0);
                wg_commit();
#pragma unroll
                for (int kk = 0; kk < DV / 16; ++kk)
                    wg_ss<BQ>(dp, desc_k(va, AB_BKV, kk), desc_k(da, BQ, kk),
                              kk > 0);
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
                uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
                ab_frags<BQ>(pa, s);
                ab_frags<BQ>(sa, dp);
                // dV += P' dO, dK += dS' Q
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) {
                    wg_rs<DV>(dv, pa[kk], da, BQ, kk);
                    wg_rs<DQK>(dk, sa[kk], qa, BQ, kk);
                }
                wg_commit();
                wg_wait<0>();
#pragma unroll
                for (int p = 0; p < DV / 64; ++p) wg_hold(dv[p]);
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p) wg_hold(dk[p]);
            }
            mbar_arrive(bar0 + 8 * (AB_STAGES + st));
        }

        // c dK and dV in bf16 over this warpgroup's rows of the K and V
        // tiles, then out through the maps (which clip rows past Skv and
        // depth past D)
        if (wk0 < skv) {
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
                ab_stage_out(ks + (p * AB_BKV + 64 * w) * AB_ROW, dk[p],
                             scale);
#pragma unroll
            for (int p = 0; p < DV / 64; ++p)
                ab_stage_out(vs + (p * AB_BKV + 64 * w) * AB_ROW, dv[p], 1.f);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(AB_WG)
                         : "memory");
            if ((tid & (AB_WG - 1)) == 0) {
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
                    tma_store3(dk_map,
                               ab_smem(ks + (p * AB_BKV + 64 * w) * AB_ROW),
                               64 * p, wk0, bh);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
                    tma_store3(dv_map,
                               ab_smem(vs + (p * AB_BKV + 64 * w) * AB_ROW),
                               64 * p, wk0, bh);
                tma_store_drain();
            }
        }
    }
}

// ---------------------------------------------------------------------------
// (3) dQ: a block per (lane, 128-query tile), `qt` counting from the last
// tile (the heaviest under a causal mask).  Warpgroups 0 and 1 own
// queries 0-63 and 64-127 of the tile; warpgroup 2 is the producer.
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__device__ __forceinline__ void
attn_bwd_dq(const CUtensorMap* q_map, const CUtensorMap* do_map,
            const CUtensorMap* k_map, const CUtensorMap* v_map,
            const CUtensorMap* dq_map, const float* __restrict__ lse,
            const float* __restrict__ delta, unsigned char* smem, int qt,
            int sq, int skv, int causal, int window, float scale)
{
    using L = AbQ<DQK, DV>;
    constexpr int BKD = L::BKD;
    unsigned char* qs = smem;
    unsigned char* dos = qs + L::Q;
    unsigned char* ring = dos + L::DO;
    const uint32_t bar0 = ab_smem(smem + L::BARS);
    const uint32_t own_bar = bar0 + 16 * AB_STAGES;

    const int tid = threadIdx.x, bh = blockIdx.x;
    const int n_qt = (sq + AB_BQD - 1) / AB_BQD;
    const int q0 = (n_qt - 1 - qt) * AB_BQD, off = skv - sq;
    // the keys some query of the tile sees: [k_lo, k_hi)
    const int qa_lo = q0 + off, qa_hi = min(q0 + AB_BQD, sq) - 1 + off;
    int k_lo = 0, k_hi = skv;
    if (window > 0) k_lo = max(0, qa_lo - window + 1);
    if (causal) k_hi = min(skv, qa_hi + 1);
    k_lo = k_lo / BKD * BKD;
    const int n_steps = k_hi > k_lo ? (k_hi - k_lo + BKD - 1) / BKD : 0;

    if (tid == 0) {
        for (int s = 0; s < AB_STAGES; ++s) {
            mbar_init(bar0 + 8 * s, 1);
            mbar_init(bar0 + 8 * (AB_STAGES + s), 2 * AB_WG);
        }
        mbar_init(own_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 2 * AB_WG) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid == 2 * AB_WG) {
            mbar_expect(own_bar, L::Q + L::DO);
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
                tma_load3(ab_smem(qs + p * AB_BQD * AB_ROW), q_map, 64 * p,
                          q0, bh, own_bar);
#pragma unroll
            for (int p = 0; p < DV / 64; ++p)
                tma_load3(ab_smem(dos + p * AB_BQD * AB_ROW), do_map, 64 * p,
                          q0, bh, own_bar);
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
                    tma_load3(sb + p * BKD * AB_ROW, k_map, 64 * p, kb,
                              bh, full);
#pragma unroll
                for (int p = 0; p < DV / 64; ++p)
                    tma_load3(sb + L::K + p * BKD * AB_ROW, v_map, 64 * p,
                              kb, bh, full);
            }
        }
    } else {
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
        const uint32_t qa = ab_smem(qs) + 64 * w * AB_ROW;
        const uint32_t da = ab_smem(dos) + 64 * w * AB_ROW;
        float dq[DQK / 64][32], s[BKD / 2], dp[BKD / 2];
#pragma unroll
        for (int p = 0; p < DQK / 64; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
#pragma unroll
        for (int i = 0; i < BKD / 2; ++i) s[i] = dp[i] = 0.f;
        mbar_wait(own_bar, 0);

        for (int i = 0; i < n_steps; ++i) {
            const int st = i % AB_STAGES;
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
                for (int kk = 0; kk < DQK / 16; ++kk)
                    wg_ss<BKD>(s, desc_k(qa, AB_BQD, kk),
                               desc_k(ka, BKD, kk), kk > 0);
                wg_commit();
#pragma unroll
                for (int kk = 0; kk < DV / 16; ++kk)
                    wg_ss<BKD>(dp, desc_k(da, AB_BQD, kk),
                               desc_k(va, BKD, kk), kk > 0);
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
                uint32_t sa[BKD / 16][4];
                ab_frags<BKD>(sa, dp);
                // dQ += dS K
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BKD / 16; ++kk)
                    wg_rs<DQK>(dq, sa[kk], ka, BKD, kk);
                wg_commit();
                wg_wait<0>();
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p) wg_hold(dq[p]);
            }
            mbar_arrive(bar0 + 8 * (AB_STAGES + st));
        }

        if (wq0 < sq) {
#pragma unroll
            for (int p = 0; p < DQK / 64; ++p)
                ab_stage_out(qs + (p * AB_BQD + 64 * w) * AB_ROW, dq[p],
                             scale);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(AB_WG)
                         : "memory");
            if ((tid & (AB_WG - 1)) == 0) {
#pragma unroll
                for (int p = 0; p < DQK / 64; ++p)
                    tma_store3(dq_map,
                               ab_smem(qs + (p * AB_BQD + 64 * w) * AB_ROW),
                               64 * p, wq0, bh);
                tma_store_drain();
            }
        }
    }
}

// ---------------------------------------------------------------------------
// (2) and (3) in one launch: blockIdx.y below ceil(Skv / 128) is a dK/dV
// block, above it a dQ block, so the two passes' blocks share the card
// (small calls run in the time of one pass, large ones lose one tail).
// The shared memory is the larger pass's.
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__global__ void __launch_bounds__(AB_THREADS, 1)
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
    extern __shared__ unsigned char ab_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(ab_raw) + 1023) & ~(uintptr_t)1023);
    const int n_kt = (skv + AB_BKV - 1) / AB_BKV;
    if ((int)blockIdx.y < n_kt)
        attn_bwd_dkdv<DQK, DV>(&q_walk, &do_walk, &k_own, &v_own, &dk_out,
                               &dv_out, lse, delta, smem, blockIdx.y, sq,
                               skv, causal, window, scale);
    else
        attn_bwd_dq<DQK, DV>(&q_own, &do_own, &k_walk, &v_walk, &dq_out, lse,
                             delta, smem, (int)blockIdx.y - n_kt, sq, skv,
                             causal, window, scale);
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
    using KV = AbKV<DQK, DV>;
    using Q = AbQ<DQK, DV>;
    constexpr int SMEM = KV::SMEM > Q::SMEM ? KV::SMEM : Q::SMEM;
    static size_t granted = 0;
    cudaError_t err = allow_smem(attn_bwd_kernel<DQK, DV>, SMEM, &granted);
    if (err != cudaSuccess) return err;
    const AbEncodeTiled enc = ab_encoder();
    if (enc == nullptr) return cudaErrorNotSupported;
    CUtensorMap m_qw, m_dow, m_k, m_v, m_dk, m_dv;
    CUtensorMap m_q, m_do, m_kw, m_vw, m_dq;
    const bool ok =
        ab_map3(enc, &m_qw, q, bh, sq, dqk, KV::BQ)
        && ab_map3(enc, &m_dow, dout, bh, sq, dv, KV::BQ)
        && ab_map3(enc, &m_k, k, bh, skv, dqk, AB_BKV)
        && ab_map3(enc, &m_v, v, bh, skv, dv, AB_BKV)
        && ab_map3(enc, &m_dk, dk, bh, skv, dqk, 64)
        && ab_map3(enc, &m_dv, dvo, bh, skv, dv, 64)
        && ab_map3(enc, &m_q, q, bh, sq, dqk, AB_BQD)
        && ab_map3(enc, &m_do, dout, bh, sq, dv, AB_BQD)
        && ab_map3(enc, &m_kw, k, bh, skv, dqk, Q::BKD)
        && ab_map3(enc, &m_vw, v, bh, skv, dv, Q::BKD)
        && ab_map3(enc, &m_dq, dq, bh, sq, dqk, 64);
    if (!ok) return cudaErrorInvalidValue;
    const int n_kt = (skv + AB_BKV - 1) / AB_BKV;
    const int n_qt = (sq + AB_BQD - 1) / AB_BQD;
    attn_bwd_kernel<DQK, DV><<<dim3(bh, n_kt + n_qt), AB_THREADS, SMEM,
                               stream>>>(
        m_qw, m_dow, m_k, m_v, m_dk, m_dv, m_q, m_do, m_kw, m_vw,
        m_dq, (const float*)lse, (const float*)delta, sq, skv, causal, window,
        scale);
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
    const int cls = ab_class(dqk, dv);
    if (bh < 1 || sq < 1 || skv < 1 || dqk < 8 || dv < 8 || dqk % 8 != 0
        || dv % 8 != 0 || cls == 0 || (sq > skv && (causal || window > 0))
        || (skv + AB_BKV - 1) / AB_BKV + (sq + AB_BQD - 1) / AB_BQD > 65535
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

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
