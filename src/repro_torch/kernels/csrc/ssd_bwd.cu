// Hopper (sm_90a) kernels for the gradient of the Mamba-2 SSD chunked scan
// (K6's backward).
//
// Built by kernels/build.py with nvcc into a shared library of its own,
// with a plain C interface, loaded with ctypes; no PyTorch header is
// included.  The entry point launches on the stream it is given,
// allocates nothing, does not synchronise and returns cudaGetLastError().
//
//   repro_ssd_scan_bwd  dxbar (BH, S, P), dla (BH, S), dbm and dcm (BH /
//                       heads, S, N) of the scan y, S_final = ssd(xbar,
//                       la, bm, cm) from the output's gradient dy (BH, S,
//                       P) and the final state's dS_final (BH, N, P; null:
//                       zero), through the forward's scores and chunk
//                       states and scratch the caller allocates
//
// What it differentiates: the scan of ssd_scan_pallas
// (src/repro/kernels/ssd_scan.py:52), which is the function of the
// reference's jnp ssd_chunked (src/repro/models/ssm.py:32); the reference
// has no backward kernel and takes jax.value_and_grad through the jnp
// form.  Per lane and chunk of Q rows, with cl = cumsum(la) over the
// chunk, L = exp(clip(cl_i - cl_j, -60, 0)), W = tril(C B' * L), tail =
// exp(cl_Q - cl), S_in the state entering the chunk and G the gradient of
// the state leaving it:
//   (1) the reverse pass: G_c-1 = exp(cl_Q,c) G_c + (C_c * exp(cl_c))' dy_c
//       from G_last = dS_final (the forward's state passing in reverse);
//   (2) dxbar = W' dy + (B * tail) G;
//   (3) dS = tril(dy x') * L;  dC += dS B + exp(cl) * (dy S_in');
//       dB += dS' C + tail * (x G');
//   (4) dcl_i = sum_j<i g_ij - sum_k>i g_ki (g = dS * C B', 0 where the
//       clip at -60 bites) + exp(cl_i) sum_n C_in (dy S_in')_in - tail_i
//       r_i (r = rowsum(B * (x G')), i < Q), and at row Q also sum_j<Q
//       tail_j r_j + exp(cl_Q) <S_in, G>; dla = the reverse cumulative sum
//       of dcl within the chunk.  The diagonal's decay exp(cl_i - cl_i)
//       and the last row's tail exp(cl_Q - cl_Q) are the constant 1: their
//       two terms cancel exactly and are left out, where adding and
//       subtracting them would bury dla under their rounding wherever it
//       is small beside them (strong decay: la = -50 puts dla near 1e-20
//       against diagonal terms of order 1).
// dbm and dcm are summed over the `heads` lanes of a batch row that share
// them (Mamba-2's n_groups 1).
//
// Bound on an H100.  The function reads xbar, la, bm, cm, dy (and
// dS_final) and the forward's chunk states and scores, and writes dxbar,
// dla, dbm, dcm: at zamba2-7b's training call (BH 448, S 2048, P 64, N
// 64, Q 256, heads 112) 786 MB (xbar, dy and dxbar 235 MB each, the
// states 59 MB), 0.235 ms at 3.35 TB/s.  The sequential recurrence's
// gradient takes 11 N P operations a row and lane (the reverse state
// G_t = exp(la) G_t+1 + c dy': 3 N P; dx = b'G, db = G x, dc = S dy,
// dla = exp(la) <S_t-1, G_t>: 2 N P each), 41.3 GFLOP: 0.250 ms at the
// TF32 rate over the split's three passes (165 TFLOP/s), bound by
// operations.  At xlstm-350m's mLSTM (BH 16, S 2048, P 513, N 512, Q 256,
// heads 1) 94.7 GFLOP, 0.574 ms, bound by operations (about 640 MB:
// 0.19 ms).  The chunked form that the kernels compute does more: per
// (lane, chunk) four products of 2 Q N P ((1)'s term, (B tail) G, dy
// S_in', x G') and four over the 64 x 64 sub-tiles on and below the
// diagonal (dy x', W' dy, dS B, dS' C): about 105 GFLOP at zamba2's call
// (0.64 ms at 165 TFLOP/s) and 90 at xlstm's (0.55 ms).  This design
// forms dy x' twice (once in each kind of block below, +19 GFLOP at
// zamba2's call).
//
// This file replaces a first design (nine launches, eight at heads 1) that
// kept the tensor cores waiting: (i) every product loaded its operands
// synchronously into shared memory between two __syncthreads(), 32 deep
// a step, with no copy in flight while mma.sync (TF32 x 3) ran; (ii) dS
// made a round trip through device memory (a (BH, chunks, Qp, Qp)
// scratch, 587 MB of sub-tiles written, then read by two more launches,
// at zamba2's call); (iii) with heads > 1 each lane's dB and dC went to
// (BH, S, N) scratch (235 MB each) that a ninth launch read back to sum
// over the heads; (iv) dy and xbar were read by four and two launches;
// (v) nine launches a call.  It took 5.756 ms at zamba2's call and 4.946
// at xlstm's (NVIDIA H100 80GB HBM3, 700 W; PERF.md), 23x and 8.6x the
// bound.
//
// Design: four launches a call, whatever the heads.
//   (a) ssd_bwd_state_kernel, a block per (lane, chunk, 64 rows of N),
//       every 64 columns of P in turn: (C * exp(cl))' dy, the chunk's own
//       term of (1), into the scratch gst (BH, chunks, N, P);
//   (b) ssd_bwd_pass_kernel, per lane and state entry, the chunks in
//       reverse order: G_c over (a)'s term in place (sequential over
//       chunks: a small launch of its own; eight chunks' terms loaded
//       together);
//   (c) ssd_bwd_band_kernel (N, P <= 64) or ssd_bwd_wide_kernel, one grid
//       of two kinds of blocks, each a (batch row, head group, chunk,
//       64-row band of the chunk) walking the group's heads in order:
//       ROW blocks (band i): dy S_in' times exp(cl) (its row sums against
//       C: dcl's exp(cl) C u term), then for each 64-row sub-tile j <= i
//       the tile dS = tril(dy x') * L, g's row sums, dS B into dC;
//       COL blocks (band j): x G' (its row sums r against B) times the
//       tail, then for each sub-tile i >= j the tile dS' = tril(x dy') *
//       L', g's column sums, dS' C into dB and W' dy into dx, then (B G)
//       times the tail into dx.  The narrow kernel's block has its
//       band's single 64-column tile of each output and sums it in
//       registers across sub-tiles and in shared memory across heads; the
//       wide kernel's owns every one of its band's (xlstm's call: 8 of dB
//       and dC, 9 of dx), forms each dS tile once for all of them and adds
//       each product into its output tile in device memory.  At N = P =
//       64 the wide kernel took 7.33 ms at zamba2's call against the
//       narrow's 4.51 (6.15 with its sub-tiles' products chained in
//       registers; PERF.md), so both stay;
//   (d) ssd_bwd_tail_kernel: per (lane, chunk) <S_in, G>, dcl from the
//       blocks' row parts in a fixed order and its reverse cumulative sum
//       (dla); and, where heads share B and C, dbm and dcm as the sums of
//       the head groups' partials in group order.
// What it does about each fault:
// - Copies in flight (i).  A block of (a) and (c) is a consumer warpgroup
//   and two producer warpgroups, one for each step's A and B operand
//   tiles (64 x 64 float32).  A tile comes into a ring of float32 stages
//   in shared memory: by TMA through a 3-D tensor map (columns, rows,
//   lanes: zeros past a lane's rows and the columns) where the tensor's
//   rows are 16-byte multiples and its base 16-byte aligned, issued by the
//   producer's first thread; elsewhere (xlstm's P 513, and P 129, 33, 13,
//   N 7: rows a map cannot stride) by the producer's 128 threads as
//   4-byte cp.async, a thread a column, zero-filled past the edges.  Both
//   complete on the stage's mbarrier (expect_tx; and where any tensor
//   takes copies, one cp.async.mbarrier.arrive.noinc a thread), chosen per
//   tensor inside the library; nothing falls back to a plain version.
//   The producer then splits the float32 tile into the three bf16 parts
//   of route (ii) below into a ring of parts stages, laid out as a
//   SWIZZLE_128B TMA box would be, and signals the consumer on an
//   mbarrier.  Up to FS steps' copies are in flight while the consumer
//   multiplies.
// - dS on chip (ii).  ROW blocks form dS by row bands (what dC needs),
//   COL blocks by column bands (what dB and dx need, with W); each keeps
//   its 64 x 64 tile in registers, split into the A fragments of the next
//   product (wgmma's register A operand).  No (BH, chunks, Qp, Qp)
//   scratch: dy x' is formed twice instead (+19 GFLOP at zamba2's call,
//   against 1.76 GB of traffic).  The g sums are taken from the fragments
//   (their parts add up to dS exactly) while that next product runs, with
//   the scores copied by a producer into the step's free A slot.
// - Heads summed inside the kernel (iii).  A block walks the heads of
//   one head group in order, adding each head's dB (dC) into a total:
//   the narrow consumer's in shared memory (16 KB, out of its registers),
//   the wide one's in the output tile itself (written by the group's
//   first head, added to by the rest; the block alone writes it).  The
//   group's sum goes once into a partial (BH / heads, groups, S, N),
//   which (d) sums in group order.  HEAD_GROUPS 8: at zamba2's call (4
//   batch rows, 112 heads, 8 chunks) 14 heads a group and 2048 blocks of
//   about 221 KB of shared memory, one resident an SM, 15.5 a
//   multiprocessor: enough to even out the bands' unequal weights
//   (heaviest bands first), against 448 blocks (3.4 a multiprocessor) with
//   one group; the partials are 33.6 MB.  Where heads <= 8 every group is
//   one head; at heads 1 the blocks write dbm, dcm directly.  No (BH, S,
//   N) per-lane scratch.
// - Tensor cores through wgmma (route (ii)).  Every product runs
//   wgmma.mma_async m64n64k16 bf16 with float32 accumulators at float32
//   grade: each operand x split exactly into three bf16 parts, h and m
//   its top 16 bits and those of the remainder (truncated), l the rest (at
//   most 8 significant bits), six passes a product, smallest first (2,
//   0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0); the dropped terms are
//   within about 2^-22 of |a||b|, under the split-TF32 tier.  Most of
//   these products contract over the chunk's rows (dS B, dS' C, W' dy,
//   (a)'s C' dy) or over N (B G), along which bm, cm, dy and G lie
//   row-major: bf16 wgmma reads such a B operand MN-major with its
//   transpose bit, where TF32 wgmma (route (i), hi and lo parts) reads
//   K-major only and would need every such tile transposed in shared
//   memory in two parts.  Six bf16 passes at 989 TFLOP/s cost what three
//   TF32 passes at 495 cost.  The split happens in shared memory, inside
//   the kernel: no prologue writes parts to device memory (one would
//   write 1.5x the bytes of xbar and dy, 705 MB at zamba2's call and 101
//   MB at xlstm's, and read them back); the extra traffic is 0.  (a)'s C'
//   (MN-major as an A operand) and W' (formed by a producer from the
//   scores and L) are written transposed by the producer's split.
// - Fewer reads (iv): a block reads each operand tile once a head; the
//   band's own dy (ROW) or x (COL) tile again for each sub-tile (L2).
// - Launches (v): four a call ((c) of the first design went into (d), (h)
//   and (i) into (d)).
// What the card taught (PERF.md has the calls): the consumer's scalar
// epilogues were the bottleneck before the tensor cores were; a masked
// element written as `ok ? v : 0` with a costly v became a branch per
// element and serialised them, so masks are bitwise (keep); shared
// memory reached through an integer-aligned pointer lost its address
// space (generic loads), so the 1024-aligned base is pointer arithmetic
// on the extern array; an accumulator zeroed or scaled by ordinary
// instructions serialised every wgmma, so a product starts with scale-d
// 0 and the epilogues only read accumulators; the producers' registers
// are traded to the consumer with setmaxnreg (232 / 136: the exchange
// must balance, or setmaxnreg.inc waits forever).
// Accumulators: a phase's products run at most 9 panels (216 wgmma sums)
// into one accumulator before it is added in float32 into its total or
// output: a long run of sums into one wgmma accumulator drifts
// (attn_bwd.cu).  No float atomics: every output and every partial is
// written by one block and summed in a fixed order, so a repeated call
// gives the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_grant.cuh"

namespace {

constexpr int BT = 64;                  // tile rows and columns
constexpr int MAXQ = 256;               // longest chunk
constexpr int WG = 128;                 // threads of a warpgroup
// the consumer warpgroup, then two producer warpgroups (the A and the B
// tile of each step); setmaxnreg moves registers to the consumer
constexpr int THREADS = 3 * WG;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 136;
// a block starts with 65536 / THREADS registers a thread rounded down to
// 8 (168); setmaxnreg.inc waits until the decreases have freed what it
// asks for, so the two must balance within that
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
static_assert(WG * CONSUMER_REGS + 2 * WG * PRODUCER_REGS
                  <= THREADS * LAUNCH_REGS, "setmaxnreg would wait forever");
constexpr int NPART = 3;                // bf16 parts of an operand
constexpr int ROW_B = 128;              // bytes of a parts row (64 bf16)
constexpr int PART_B = BT * ROW_B;      // one part of a tile: 8 KB
constexpr int FTILE = BT * BT * 4;      // a float32 tile: 16 KB
constexpr int PTILE = NPART * PART_B;   // a tile's parts: 24 KB
constexpr int HEAD_GROUPS = 8;
constexpr int PASS_THREADS = 256;
constexpr int ROW_THREADS = 256;        // (d): a thread a chunk row

// head vectors: cl, exp(cl), the tail exp(cl_last - cl) of one lane's
// chunk, written by the producer one head ahead into HEAD_BUFS buffers
constexpr int HEAD_BUFS = 4;
constexpr int HEAD_VEC = 3 * MAXQ;
enum Tensor { T_X, T_DY, T_BM, T_CM, T_ST, T_GS, T_CB, NT };
// (a)'s state tiles; (c)'s band blocks, narrow (N, P <= 64: the band's
// single output tile) or wide (every output tile of its band)
enum Mode { M_STATE, M_BANDS, M_WIDE };

// a mode's rings and shared memory: the parts ring (PS stages of an A and
// a B tile), the float32 ring (FS stages), the head vectors, the narrow
// consumer's group total (32 floats a thread, kept out of its registers),
// the mbarriers.  The wide blocks keep no group total there and trade a
// float32 stage for a third parts stage: their copies waited little,
// their hand-offs between producers and consumer more (PERF.md)
template <int MODE>
struct Ring {
    static constexpr int FS = MODE == M_WIDE ? 2 : 3;
    static constexpr int PS = MODE == M_WIDE ? 3 : 2;
    static constexpr int FLOAT = PS * 2 * PTILE;
    static constexpr int VEC = FLOAT + FS * 2 * FTILE;
    static constexpr int TOT = VEC + HEAD_BUFS * HEAD_VEC * 4;
    static constexpr int BARS = TOT + (MODE == M_BANDS ? 32 * WG * 4 : 0);
    static constexpr int SMEM = 1024 + BARS + 8 * (2 * FS + 2 * PS);
};
static_assert(Ring<M_STATE>::SMEM <= 232448, "smem");
static_assert(Ring<M_BANDS>::SMEM <= 232448, "smem");
static_assert(Ring<M_WIDE>::SMEM <= 232448, "smem");
enum Kind { K_STATE, K_ROW, K_COL };
enum StepType { S_U, S_S, S_SB, S_V, S_BG, S_SP, S_SPC, S_WD, S_ST };
// how the producer stores a float32 tile: split into parts as it lies;
// transposed with its rows scaled by exp(cl) ((a)'s C'); copied as
// float32 (the scores for the g sums); W' = (scores * L)' split
enum TileMode { TM_PARTS, TM_SCALED_T, TM_COPY, TM_W };

struct Params {
    CUtensorMap map[NT];        // 3-D (columns, rows, lanes) where TMA reaches
    const float* ptr[NT];
    int width[NT];              // columns
    int rows[NT];               // rows a lane
    int tma;                    // bit t: tensor t has a map
    const float* la;
    float* dx;
    float* parts;
    float* out_b;               // dbm, or the head groups' partials
    float* out_c;
    float* gst;
    int s, p, n, q, qp, nc, heads, groups, hpg, ngrp, ntn, npt, nsub, npart;
    int wide;                   // N or P past 64: a band block owns them all
};

// ---------------------------------------------------------------------------
// cp.async, named barriers, wgmma descriptors (the rest: hopper.cuh)
// ---------------------------------------------------------------------------
// 4 bytes global -> shared, zeros where !full
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool full)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}
// the barrier's phase waits for this thread's cp.async copies so far
__device__ __forceinline__ void cp_async_arrive(uint32_t bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_sync(int id)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(WG) : "memory");
}

// K-major: the 64 rows of a part tile, depth step kk (16 columns: a
// 32-byte step inside the swizzled 128-byte row); 8-row groups 1024 apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk)
{
    return wg_desc(tile + kk * 32, 16, 1024);
}
// MN-major B: the part tile's rows are the product's depth, step kk its
// rows 16 kk..; its 64 columns the product's N
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk)
{
    return wg_desc(tile + kk * 2048, PART_B, 1024);
}

#define WG_D32                                                              \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
    "+f"(d[30]), "+f"(d[31])
#define WG_R32                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
    "%28, %29, %30, %31}"

// d (64 x 64) (+)= A B, both from shared memory, A K-major; B K-major
// (trans 0) or MN-major (trans 1); acc 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t a, uint64_t b,
                                      int acc)
{
    if constexpr (TRANS_B == 0)
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                     WG_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                     : WG_D32 : "l"(a), "l"(b), "r"(acc));
    else
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                     WG_R32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
                     : WG_D32 : "l"(a), "l"(b), "r"(acc));
}
// d (64 x 64) (+)= A B: A 64 x 16 bf16 in registers (the accumulator
// fragment's layout), B 16 x 64 MN-major in shared memory; acc 0
// overwrites d
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b, int acc)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 WG_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WG_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(acc));
}

// d (+)= A B over one 64-deep tile pair, both from their parts tiles;
// fresh: the first pass overwrites d (an accumulator is never zeroed or
// scaled by other instructions: wgmma would be serialised around them)
template <int TRANS_B>
__device__ __forceinline__ void prod_ss(float (&d)[32], uint32_t a,
                                        uint32_t b, bool fresh)
{
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
            wg_ss<TRANS_B>(d, desc_k(a + pass_a(n) * PART_B, kk),
                           TRANS_B ? desc_mn(b + pass_b(n) * PART_B, kk)
                                   : desc_k(b + pass_b(n) * PART_B, kk),
                           (n | kk) != 0 || !fresh);
}
// d (+)= A B, A 64 x 64 in registers as the parts' fragments, B MN-major
__device__ __forceinline__ void prod_rs(float (&d)[32],
                                        const uint32_t (&a)[4][NPART][4],
                                        uint32_t b, bool fresh)
{
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
            wg_rs(d, a[kk][pass_a(n)], desc_mn(b + pass_b(n) * PART_B, kk),
                  (n | kk) != 0 || !fresh);
}

// x as three bf16 parts h + m + l, exactly: h the top 16 bits of x, m
// those of the remainder x - h (both truncated), l = x - h - m (at most 8
// significant bits left: a bf16 exactly).  Each part as a float32 bit
// pattern whose low 16 bits are zero; truncation never overflows
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l)
{
    h = __float_as_uint(x) & 0xffff0000u;
    const float r = x - __uint_as_float(h);
    m = __float_as_uint(r) & 0xffff0000u;
    l = __float_as_uint(r - __uint_as_float(m));
}
// two parts' bf16 (their top 16 bits) into one register, a low
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b)
{
    return __byte_perm(a, b, 0x7632);
}

// fragment register r of depth step kk (A's row r & 1 of this thread's
// two, columns 16 kk + 8 (r >> 1) + 2 t + 0, 1) from the values v0, v1
__device__ __forceinline__ void frag_pair(uint32_t (&a)[4][NPART][4], int kk,
                                          int r, float v0, float v1)
{
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v0, h0, m0, l0);
    split3(v1, h1, m1, l1);
    a[kk][0][r] = pack2(h0, h1);
    a[kk][1][r] = pack2(m0, m1);
    a[kk][2][r] = pack2(l0, l1);
}

// the sum of v over the four lanes of a quad (the t of one row), the same
// bits on each
__device__ __forceinline__ float quad_sum(float v)
{
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// cl[0, MAXQ) = inclusive prefix sums of la[0, len), la taken as 0 past
// len: the forward's ssd_cumsum, so both see the same bits of cl.  One
// warp, 8 rows a lane; the caller synchronises
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ la,
                                             int len, float* cl)
{
    const int lane = threadIdx.x & 31;
    float v[MAXQ / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < MAXQ / 32; ++e) {
        const int i = (MAXQ / 32) * lane + e;
        run += i < len ? la[i] : 0.f;
        v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < MAXQ / 32; ++e)
        cl[(MAXQ / 32) * lane + e] = excl + v[e];
}

// exp(clip(d, -60, 0)), L's element (2^(d log2 e), at least 2^-87: no
// subnormal to handle)
__device__ __forceinline__ float decay_of(float d)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;"
        : "=f"(y) : "f"(fminf(fmaxf(d, -60.f), 0.f) * 1.4426950408889634f));
    return y;
}

// v where ok, else 0, by masking its bits: no branch (the compiler turns
// `ok ? v : 0` with a costly v into one per element, which serialises
// them), and 0 also where v is not finite (the scores past the ones the
// forward wrote)
__device__ __forceinline__ float keep(bool ok, float v)
{
    return __int_as_float(__float_as_int(v) & -(int)ok);
}

// ---------------------------------------------------------------------------
// the schedule: a block's steps, each one or two operand tiles and the
// product that consumes them.  Producer and consumer walk the same list.
// ---------------------------------------------------------------------------
struct Tile {
    int t;          // tensor, -1: none
    const float* base;          // the tensor
    const CUtensorMap* map;     // its map, null: 4-byte copies
    int width, rows;            // its columns, rows a lane
    int lane;       // the map's third coordinate
    int row0;       // first row within the lane
    int vr;         // rows kept (the rest zero)
    int col0;       // first column
    int mode;       // TileMode
};

struct Step {
    int type, h, sub;
    int tn;                     // the output's 64-column tile
    bool first, last;           // of its phase
    bool head_first, head_last;
    Tile a, b;
};

// n / d as a multiply-high by ceil(2^32 / d): exact while n d < 2^32
// (a schedule's indices and divisors are far below 2^16)
struct FastDiv {
    unsigned long long m;
};

__device__ __forceinline__ FastDiv fast_div(int d)
{
    FastDiv f;
    f.m = ((1ull << 32) + d - 1) / d;
    return f;
}

__device__ __forceinline__ int div_of(int n, FastDiv f)
{
    return (int)(((unsigned long long)n * f.m) >> 32);
}

struct Ctx {
    int kind, grp, hg, h0, h1, c, t0, len, nsl, band, tile;
    int npk, nnk, ntn, npt, sph, nsteps;
    bool wide;
    // the schedule's divisors: P's panels, N's panels, the steps of a ROW
    // and of a COL sub-tile
    FastDiv by_npk, by_nnk, by_row, by_col;
};

// a tile of tensor t (a constant where it is called, so that the
// tensor's fields are read from fixed places of the parameters); without
// TILES (the consumer, which reads no tile) only its tensor
template <bool TILES>
__device__ __forceinline__ Tile tile_of(const Params& p, int t, int lane,
                                        int row0, int vr, int col0,
                                        int mode = TM_PARTS)
{
    Tile x;
    x.t = t;
    if constexpr (!TILES) return x;
    x.base = p.ptr[t];
    x.map = (p.tma >> t) & 1 ? &p.map[t] : nullptr;
    x.width = p.width[t];
    x.rows = p.rows[t];
    x.lane = lane;
    x.row0 = row0;
    x.vr = vr;
    x.col0 = col0;
    x.mode = mode;
    return x;
}

// the block's context from its index; false where it has nothing to do
template <int MODE>
__device__ __forceinline__ bool block_ctx(const Params& p, Ctx& x)
{
    x.npk = x.npt = (p.p + BT - 1) / BT;
    x.nnk = x.ntn = (p.n + BT - 1) / BT;
    x.wide = MODE == M_WIDE;
    long long b = blockIdx.x;
    if constexpr (MODE == M_STATE) {
        x.kind = K_STATE;
        x.tile = (int)(b % p.ntn);
        b /= p.ntn;
        x.c = (int)(b % p.nc);
        const int ln = (int)(b / p.nc);
        x.grp = ln / p.heads;
        x.h0 = ln - x.grp * p.heads;
        x.h1 = x.h0 + 1;
        x.hg = 0;
        x.band = 0;
    } else {
        // blockIdx.y: COL j-band y / 2 (even y), ROW i-band nsub - 1 - y / 2
        // (odd y): the heaviest bands first
        const int y = blockIdx.y;
        x.kind = (y & 1) ? K_ROW : K_COL;
        x.band = x.kind == K_COL ? y >> 1 : p.nsub - 1 - (y >> 1);
        if (b >= (long long)p.groups * p.ngrp * p.nc) return false;
        x.tile = 0;             // the wide schedule names a step's tile
        x.c = (int)(b % p.nc);
        b /= p.nc;
        x.hg = (int)(b % p.ngrp);
        x.grp = (int)(b / p.ngrp);
        x.h0 = x.hg * p.hpg;
        x.h1 = min(p.heads, x.h0 + p.hpg);
    }
    x.t0 = x.c * p.q;
    x.len = min(p.q, p.s - x.t0);
    x.nsl = (x.len + BT - 1) / BT;
    if (x.band >= x.nsl || x.h0 >= x.h1) return false;
    x.by_npk = fast_div(x.npk);
    x.by_nnk = fast_div(x.nnk);
    if (x.kind == K_STATE) {
        // every p tile in turn: its 64-row sub-tiles
        x.sph = x.nsl;
        x.nsteps = x.npt * x.nsl;
    } else if (x.wide) {
        // a head's steps: ROW u over every n tile, then per sub-tile dS and
        // dS B into every n tile; COL v over every n tile, per sub-tile
        // dS', dS' C into every n tile and W' dy into every p tile, then
        // B G into every p tile
        x.by_row = fast_div(x.npk + x.ntn);
        x.by_col = fast_div(x.npk + x.ntn + x.npt);
        x.sph = x.kind == K_ROW
            ? x.ntn * x.npk + (x.band + 1) * (x.npk + x.ntn)
            : x.ntn * x.npk + (x.nsl - x.band) * (x.npk + x.ntn + x.npt)
                + x.npt * x.nnk;
        x.nsteps = (x.h1 - x.h0) * x.sph;
    } else if (x.kind == K_ROW) {
        // the narrow schedule: N, P <= 64, one output tile (tile 0)
        x.by_row = fast_div(x.npk + 1);
        x.sph = x.npk + (x.band + 1) * (x.npk + 1);
        x.nsteps = (x.h1 - x.h0) * x.sph;
    } else {
        // v, then per sub-tile dS', dS' C and W' dy, then B G
        const int per = x.npk + 2;
        x.by_col = fast_div(per);
        x.sph = x.npk + x.nnk + (x.nsl - x.band) * per;
        x.nsteps = (x.h1 - x.h0) * x.sph;
    }
    return true;
}

// a place in the block's schedule: step k, the head hk of the group and
// the step r of the head (k = hk sph + r), advanced without division
struct Cursor {
    int k, hk, r;
};

__device__ __forceinline__ Cursor cursor_at(const Ctx& x, int k)
{
    Cursor c;
    c.k = k;
    c.hk = k / x.sph;
    c.r = k - c.hk * x.sph;
    return c;
}

__device__ __forceinline__ void cursor_next(const Ctx& x, Cursor& c)
{
    ++c.k;
    if (++c.r == x.sph) {
        c.r = 0;
        ++c.hk;
    }
}

// the step at cursor c of the block's schedule (TILES: with its tiles)
template <bool TILES>
__device__ __forceinline__ void describe(const Params& p, const Ctx& x,
                                         const Cursor& c, Step& st)
{
    const int k = c.k;
    st.a.t = st.b.t = -1;
    st.sub = 0;
    st.tn = x.tile;
    if (x.kind == K_STATE) {
        // p tile c.hk, sub-tile c.r
        const int ln = x.grp * p.heads + x.h0, it = c.r;
        const int r0 = x.t0 + BT * it, vr = min(BT, x.len - BT * it);
        st.type = S_ST;
        st.h = x.h0;
        st.sub = it;
        st.tn = c.hk;
        st.first = it == 0;
        st.last = it == x.nsl - 1;
        st.head_first = k == 0;
        st.head_last = k == x.nsteps - 1;
        st.a = tile_of<TILES>(p, T_CM, x.grp, r0, vr, BT * x.tile,
                              TM_SCALED_T);
        st.b = tile_of<TILES>(p, T_DY, ln, r0, vr, BT * c.hk);
        return;
    }
    int r = c.r;
    st.h = x.h0 + c.hk;
    st.head_first = r == 0;
    st.head_last = r == x.sph - 1;
    const int ln = x.grp * p.heads + st.h;
    const int sl = ln * p.nc + x.c;             // a chunk state's lane
    const int cbl = x.grp * p.nc + x.c;         // the chunk's scores' lane
    if (x.wide) {
        const int b0 = BT * x.band, vb = min(BT, x.len - b0);
        const int nu = x.ntn * x.npk;
        if (r < nu) {                           // ROW u, COL v, tile tn
            const int tn = div_of(r, x.by_npk), kp = r - tn * x.npk;
            st.type = x.kind == K_ROW ? S_U : S_V;
            st.tn = tn;
            st.first = kp == 0;
            st.last = kp == x.npk - 1;
            st.a = tile_of<TILES>(p, x.kind == K_ROW ? T_DY : T_X, ln,
                                  x.t0 + b0, vb, BT * kp);
            const int vn = min(BT, p.n - BT * tn);
            st.b = x.kind == K_ROW
                ? tile_of<TILES>(p, T_ST, sl, BT * tn, vn, BT * kp)
                : tile_of<TILES>(p, T_GS, sl, BT * tn, vn, BT * kp);
            return;
        }
        r -= nu;
        if (x.kind == K_ROW) {
            const int per = x.npk + x.ntn;
            const int tj = div_of(r, x.by_row), r2 = r - tj * per;
            const int j0 = BT * tj, vj = min(BT, x.len - j0);
            st.sub = tj;
            if (r2 < x.npk) {                   // dS = dy x'
                st.type = S_S;
                st.first = r2 == 0;
                st.last = r2 == x.npk - 1;
                st.a = tile_of<TILES>(p, T_DY, ln, x.t0 + b0, vb, BT * r2);
                st.b = tile_of<TILES>(p, T_X, ln, x.t0 + j0, vj, BT * r2);
            } else {                            // dS B into tile tn
                const int tn = r2 - x.npk;
                st.type = S_SB;
                st.tn = tn;
                st.first = st.last = true;
                st.b = tile_of<TILES>(p, T_BM, x.grp, x.t0 + j0, vj, BT * tn);
                if (tn == 0)                    // the scores for g
                    st.a = tile_of<TILES>(p, T_CB, cbl, b0, BT, j0, TM_COPY);
            }
            return;
        }
        const int per = x.npk + x.ntn + x.npt;
        const int nsub = (x.nsl - x.band) * per;
        if (r >= nsub) {                        // B G into p tile tt
            r -= nsub;
            const int tt = div_of(r, x.by_nnk), kn = r - tt * x.nnk;
            st.type = S_BG;
            st.tn = tt;
            st.first = kn == 0;
            st.last = kn == x.nnk - 1;
            st.a = tile_of<TILES>(p, T_BM, x.grp, x.t0 + b0, vb, BT * kn);
            st.b = tile_of<TILES>(p, T_GS, sl, BT * kn, min(BT, p.n - BT * kn),
                                  BT * tt);
            return;
        }
        const int q = div_of(r, x.by_col), ti = x.band + q, r2 = r - q * per;
        const int i0 = BT * ti, vi = min(BT, x.len - i0);
        st.sub = ti;
        if (r2 < x.npk) {                       // dS' = x dy'
            st.type = S_SP;
            st.first = r2 == 0;
            st.last = r2 == x.npk - 1;
            st.a = tile_of<TILES>(p, T_X, ln, x.t0 + b0, vb, BT * r2);
            st.b = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, BT * r2);
        } else if (r2 < x.npk + x.ntn) {        // dS' C into n tile tt
            const int tt = r2 - x.npk;
            st.type = S_SPC;
            st.tn = tt;
            st.first = st.last = true;
            st.b = tile_of<TILES>(p, T_CM, x.grp, x.t0 + i0, vi, BT * tt);
            if (tt == 0)                        // the scores for g
                st.a = tile_of<TILES>(p, T_CB, cbl, i0, BT, b0, TM_COPY);
        } else {                                // W' dy into p tile tt
            const int tt = r2 - x.npk - x.ntn;
            st.type = S_WD;
            st.tn = tt;
            st.first = st.last = true;
            st.a = tile_of<TILES>(p, T_CB, cbl, i0, BT, b0, TM_W);
            st.b = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, BT * tt);
        }
        return;
    }
    // the narrow schedule: the band's single output tile (N, P <= 64)
    if (x.kind == K_ROW) {
        const int i0 = BT * x.band, vi = min(BT, x.len - i0);
        if (r < x.npk) {                        // u = dy S_in'
            st.type = S_U;
            st.first = r == 0;
            st.last = r == x.npk - 1;
            st.a = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, BT * r);
            st.b = tile_of<TILES>(p, T_ST, sl, 0, p.n, BT * r);
            return;
        }
        r -= x.npk;
        const int tj = div_of(r, x.by_row), r2 = r - tj * (x.npk + 1);
        const int j0 = BT * tj, vj = min(BT, x.len - j0);
        st.sub = tj;
        if (r2 < x.npk) {                       // dS = dy x'
            st.type = S_S;
            st.first = r2 == 0;
            st.last = r2 == x.npk - 1;
            st.a = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, BT * r2);
            st.b = tile_of<TILES>(p, T_X, ln, x.t0 + j0, vj, BT * r2);
        } else {                                // dC += dS B
            st.type = S_SB;
            st.first = tj == 0;
            st.last = tj == x.band;
            st.b = tile_of<TILES>(p, T_BM, x.grp, x.t0 + j0, vj, 0);
            // the scores for g
            st.a = tile_of<TILES>(p, T_CB, x.grp * p.nc + x.c, i0, BT, j0,
                                  TM_COPY);
        }
        return;
    }
    const int j0 = BT * x.band, vj = min(BT, x.len - j0);
    if (r < x.npk) {                            // v = x G'
        st.type = S_V;
        st.first = r == 0;
        st.last = r == x.npk - 1;
        st.a = tile_of<TILES>(p, T_X, ln, x.t0 + j0, vj, BT * r);
        st.b = tile_of<TILES>(p, T_GS, sl, 0, p.n, BT * r);
        return;
    }
    r -= x.npk;
    const int ns = x.npk;
    const int per = ns + 2;
    const int nsub = (x.nsl - x.band) * per;
    if (r >= nsub) {                            // B G, last
        r -= nsub;
        st.type = S_BG;
        st.first = r == 0;
        st.last = r == x.nnk - 1;
        st.a = tile_of<TILES>(p, T_BM, x.grp, x.t0 + j0, vj, BT * r);
        st.b = tile_of<TILES>(p, T_GS, sl, BT * r, min(BT, p.n - BT * r), 0);
        return;
    }
    const int q = div_of(r, x.by_col), ti = x.band + q, r2 = r - q * per;
    const int i0 = BT * ti, vi = min(BT, x.len - i0);
    st.sub = ti;
    if (r2 < ns) {                              // dS' = x dy'
        st.type = S_SP;
        st.first = r2 == 0;
        st.last = r2 == ns - 1;
        st.a = tile_of<TILES>(p, T_X, ln, x.t0 + j0, vj, BT * r2);
        st.b = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, BT * r2);
    } else if (r2 == ns) {                      // dB += dS' C
        st.type = S_SPC;
        st.first = ti == x.band;
        st.last = ti == x.nsl - 1;
        st.b = tile_of<TILES>(p, T_CM, x.grp, x.t0 + i0, vi, 0);
        // the scores for g
        st.a = tile_of<TILES>(p, T_CB, x.grp * p.nc + x.c, i0, BT, j0,
                              TM_COPY);
    } else {                                    // dx += W' dy
        st.type = S_WD;
        st.first = ti == x.band;
        st.last = ti == x.nsl - 1;
        st.a = tile_of<TILES>(p, T_CB, x.grp * p.nc + x.c, i0, BT, j0, TM_W);
        st.b = tile_of<TILES>(p, T_DY, ln, x.t0 + i0, vi, 0);
    }
}

// ---------------------------------------------------------------------------
// the producer: copies into the float32 ring, splits into the parts ring
// ---------------------------------------------------------------------------
// tile tl into the float32 slot dst, completing on bar: one TMA box by
// the warpgroup's first thread, or 4-byte copies by all its threads
// (then each arrives on bar when its copies land: cp_arrive)
__device__ __forceinline__ void fill_slot(const Tile& tl, unsigned char* dst,
                                          uint32_t bar, int pt,
                                          bool cp_arrive)
{
    if (tl.t >= 0 && tl.map == nullptr) {
        // a thread a column, every other row
        const int w = tl.width, cc = pt & (BT - 1), r0 = pt >> 6;
        const bool col_in = cc < w - tl.col0;
        const float* src = tl.base
            + ((long long)tl.lane * tl.rows + tl.row0 + r0) * w + tl.col0
            + cc;
        uint32_t d = smem_u32(dst) + 4 * (r0 * BT + cc);
#pragma unroll 8
        for (int r = r0; r < BT; r += 2, src += 2 * w, d += 2 * BT * 4) {
            const bool ok = col_in && r < tl.vr;
            cp_async4(d, ok ? src : tl.base, ok);
        }
    }
    if (pt == 0) {
        const bool tma = tl.t >= 0 && tl.map != nullptr;
        mbar_expect(bar, tma ? FTILE : 0);
        if (tma)
            tma_load3(smem_u32(dst), tl.map, tl.col0, tl.row0, tl.lane, bar);
    }
    if (cp_arrive) cp_async_arrive(bar);
}

// a float32 tile fl (64 x 64) into the parts tile pt by its mode: its
// three bf16 parts as 128-byte-swizzled rows (as a TMA box of a
// SWIZZLE_128B map would hold them), rows >= vr and columns >= vc zero;
// TM_SCALED_T transposed (the parts' row n holds the tile's column n),
// the tile's row i scaled by exp(cl) of chunk row 64 sub + i; TM_COPY the
// float32 tile as it is; TM_W the parts of W'[j, i] = scores[i, j] L[i,
// j] (i >= j, both in the chunk), the scores tile's rows i0 + i and
// columns j0 + j (i0, j0 its first row and column), transposed.  hv: the
// head's vectors (cl, exp(cl), tail)
__device__ __forceinline__ void split_tile(const float* fl, unsigned char* pt,
                                           const Tile& tl, int vc,
                                           const float* hv, int sub, int len,
                                           int id)
{
    if (tl.mode == TM_COPY) {
#pragma unroll
        for (int u = 0; u < BT * BT / 4 / WG; ++u) {
            const int e = id + WG * u;
            reinterpret_cast<float4*>(pt)[e] =
                reinterpret_cast<const float4*>(fl)[e];
        }
        return;
    }
#pragma unroll
    for (int u = 0; u < BT * BT / 8 / WG; ++u) {
        const int e = id + WG * u;
        int row, c8;
        float v[8];
        if (tl.mode == TM_PARTS) {
            row = e >> 3;
            c8 = e & 7;
            const float4 a = *reinterpret_cast<const float4*>(
                fl + row * BT + 8 * c8);
            const float4 b = *reinterpret_cast<const float4*>(
                fl + row * BT + 8 * c8 + 4);
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
            v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#pragma unroll
            for (int q = 0; q < 8; ++q)
                v[q] = keep(row < tl.vr && 8 * c8 + q < vc, v[q]);
        } else if (tl.mode == TM_SCALED_T) {
            row = e & 63;               // the tile's column
            c8 = e >> 6;                // 8 of its rows
            const float* ev = hv + MAXQ + BT * sub;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int i = 8 * c8 + q;
                v[q] = keep(i < tl.vr && row < vc, fl[i * BT + row] * ev[i]);
            }
        } else {                        // TM_W: row j, columns i
            row = e & 63;
            c8 = e >> 6;
            const int j = tl.col0 + row;
            const float clj = hv[j];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int i = tl.row0 + 8 * c8 + q;
                v[q] = keep(i >= j && i < len && j < len,
                            fl[(8 * c8 + q) * BT + row]
                                * decay_of(hv[i] - clj));
            }
        }
        uint32_t h[4], m[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t h0, m0, l0, h1, m1, l1;
            split3(v[2 * q], h0, m0, l0);
            split3(v[2 * q + 1], h1, m1, l1);
            h[q] = pack2(h0, h1);
            m[q] = pack2(m0, m1);
            l[q] = pack2(l0, l1);
        }
        const int off = row * ROW_B + ((c8 ^ (row & 7)) << 4);
        *reinterpret_cast<uint4*>(pt + off) = make_uint4(h[0], h[1], h[2],
                                                         h[3]);
        *reinterpret_cast<uint4*>(pt + PART_B + off) =
            make_uint4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<uint4*>(pt + 2 * PART_B + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
    }
}

// the head vectors of lane ln's chunk into hv: cl (the forward's cumsum,
// la taken as 0 past len), exp(cl) and exp(cl_last - cl) (0 past len).
// The producer warpgroup, synchronised on its named barrier
__device__ __forceinline__ void head_vectors(const Params& p, const Ctx& x,
                                             int ln, float* hv, int pt)
{
    if (pt < 32)
        chunk_cumsum(p.la + (long long)ln * p.s + x.t0, x.len, hv);
    bar_sync(1);
    const float last = hv[x.len - 1];
    for (int i = pt; i < MAXQ; i += WG) {
        const float c = hv[i];
        hv[MAXQ + i] = i < x.len ? expf(c) : 0.f;
        hv[2 * MAXQ + i] = i < x.len ? expf(last - c) : 0.f;
    }
    bar_sync(1);
}

__device__ __forceinline__ int cols_of(const Tile& tl)
{
    return min(BT, tl.width - tl.col0);
}

// the tile of step c for slot SLOT (0: the A tile, 1: the B tile)
template <int SLOT>
__device__ __forceinline__ Tile slot_tile(const Params& p, const Ctx& x,
                                          const Cursor& c, int& hk, int& sub,
                                          bool& head_first)
{
    Step st;
    describe<true>(p, x, c, st);
    hk = st.h - x.h0;
    sub = st.sub;
    head_first = st.head_first;
    return SLOT ? st.b : st.a;
}

// a producer warpgroup: SLOT 0 the steps' A tiles (and the head vectors,
// which only they and the consumer read), SLOT 1 their B tiles.  The
// tiles of the FS steps in flight are kept in registers, each step
// described once
template <int MODE, int SLOT>
__device__ __forceinline__ void producer(const Params& p, const Ctx& x,
                                         unsigned char* smem, uint32_t bars,
                                         bool cp_arrive)
{
    constexpr int FS = Ring<MODE>::FS, PS = Ring<MODE>::PS;
    const int pt = threadIdx.x - WG * (1 + SLOT);
    unsigned char* parts = smem + SLOT * PTILE;
    unsigned char* fring = smem + Ring<MODE>::FLOAT + SLOT * FTILE;
    float* hvs = reinterpret_cast<float*>(smem + Ring<MODE>::VEC);
    const uint32_t ffull = bars + 8 * SLOT, pfull = bars + 8 * 2 * FS;
    const uint32_t pempty = pfull + 8 * PS;
    const int nh = x.h1 - x.h0, lane0 = x.grp * p.heads + x.h0;
    // the head vectors one head ahead of the consumer: heads 0 and 1 now,
    // head h + 1 at head h's first step (HEAD_BUFS 4: the consumer is
    // then past head h - 3)
    if (SLOT == 0) {
        head_vectors(p, x, lane0, hvs, pt);
        if (nh > 1) head_vectors(p, x, lane0 + 1, hvs + HEAD_VEC, pt);
    }
    // the tile, head, sub-tile and head's-first-step flag of steps k ..
    // k + FS - 1, in registers (constant indices)
    Tile q[FS];
    int hq[FS], sq[FS];
    bool fq[FS];
    Cursor cf = cursor_at(x, 0);
#pragma unroll
    for (int i = 0; i < FS; ++i) {
        if (i > 0) cursor_next(x, cf);
        q[i] = slot_tile<SLOT>(p, x, cf, hq[i], sq[i], fq[i]);
        if (i < x.nsteps)
            fill_slot(q[i], fring + i * 2 * FTILE, ffull + 16 * i, pt,
                      cp_arrive);
    }
    for (int k = 0; k < x.nsteps; ++k) {
        const int f = k % FS, s = k % PS;
        mbar_wait(ffull + 16 * f, (k / FS) & 1);
        if (k >= PS) mbar_wait(pempty + 8 * s, (k / PS - 1) & 1);
        if (SLOT == 0 && fq[0] && hq[0] >= 1 && hq[0] + 1 < nh)
            head_vectors(p, x, lane0 + hq[0] + 1,
                         hvs + (hq[0] + 1) % HEAD_BUFS * HEAD_VEC, pt);
        if (q[0].t >= 0)
            split_tile(reinterpret_cast<const float*>(fring + f * 2 * FTILE),
                       parts + s * 2 * PTILE, q[0], cols_of(q[0]),
                       hvs + hq[0] % HEAD_BUFS * HEAD_VEC, sq[0], x.len, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(pfull + 8 * s);
        bar_sync(1 + SLOT);     // this warpgroup has read its slot of f
#pragma unroll
        for (int i = 0; i + 1 < FS; ++i) {
            q[i] = q[i + 1];
            hq[i] = hq[i + 1];
            sq[i] = sq[i + 1];
            fq[i] = fq[i + 1];
        }
        if (k + FS < x.nsteps) {
            cursor_next(x, cf);
            q[FS - 1] = slot_tile<SLOT>(p, x, cf, hq[FS - 1], sq[FS - 1],
                                        fq[FS - 1]);
            fill_slot(q[FS - 1], fring + f * 2 * FTILE, ffull + 16 * f, pt,
                      cp_arrive);
        }
    }
}

// ---------------------------------------------------------------------------
// the consumer warpgroup: products and epilogues
// ---------------------------------------------------------------------------
// the accumulator (row 16 w + g + 8 h: element 4 j + 2 h + e at column
// 8 j + 2 t + e) into out (row stride ld), rows < vr, columns < vc
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           long long ld, int vr, int vc,
                                           const float (&d)[32], int w,
                                           int g, int t)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * w + g + 8 * h;
        if (r >= vr) continue;
        float* row = out + r * ld;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                if (c < vc) row[c] = d[4 * j + 2 * h + e];
            }
    }
}

// the value dS[row, column] of fragment register (kk, r), half e, from
// its three bf16 parts (exact: the split is)
__device__ __forceinline__ float frag_value(const uint32_t (&a)[4][NPART][4],
                                            int kk, int r, int e)
{
    float v[NPART];
#pragma unroll
    for (int q = 0; q < NPART; ++q)
        v[q] = __uint_as_float(e ? a[kk][q][r] & 0xffff0000u
                                 : a[kk][q][r] << 16);
    return (v[0] + v[1]) + v[2];
}

// the g sums of one 64 x 64 dS tile, from its fragments a (exact dS)
// and the forward's scores sc (64 x 64 float32: rows i, columns j of the
// chunk from i0, j0): g = dS * scores below the diagonal where the clip
// does not bite, summed along the thread's rows.  ROW: the tile is dS[i,
// j], its rows the band's i (b0..), columns the sub-tile's j (s0..); COL:
// dS'[j, i], rows the band's j, columns the sub-tile's i.  Branch-free
template <bool ROW>
__device__ __forceinline__ void g_sums(const uint32_t (&a)[4][NPART][4],
                                       const float* sc, const float* cl,
                                       int b0, int s0, int r0, int t,
                                       int len, float (&rsum)[2])
{
    float clr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) clr[h] = cl[b0 + r0 + 8 * h];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int cc = 16 * kk + 8 * c2 + 2 * t + e;
                const float clc = cl[s0 + cc];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int rl = r0 + 8 * h;
                    const int i = ROW ? b0 + rl : s0 + cc;
                    const int j = ROW ? s0 + cc : b0 + rl;
                    const float d = ROW ? clr[h] - clc : clc - clr[h];
                    const bool ok = i < len && i > j && d >= -60.f
                        && d <= 0.f;
                    const float g = frag_value(a, kk, 2 * c2 + h, e)
                        * sc[ROW ? rl * BT + cc : cc * BT + rl];
                    rsum[h] += keep(ok, g);
                }
            }
}

// dS = d * L on and below the diagonal (0 elsewhere and past the chunk)
// from the product d (ROW [i, j]; COL dS' [j, i], as g_sums), as the A
// fragments of the next product.  Branch-free
template <bool ROW>
__device__ __forceinline__ void ds_frags(uint32_t (&a)[4][NPART][4],
                                         const float (&d)[32],
                                         const float* cl, int b0, int s0,
                                         int r0, int t, int len)
{
    float clr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) clr[h] = cl[b0 + r0 + 8 * h];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
            float clc[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
                clc[e] = cl[s0 + 16 * kk + 8 * c2 + 2 * t + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int rl = r0 + 8 * h, r = 2 * c2 + h;
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int cc = 16 * kk + 8 * c2 + 2 * t + e;
                    const int i = ROW ? b0 + rl : s0 + cc;
                    const int j = ROW ? s0 + cc : b0 + rl;
                    const float dd = ROW ? clr[h] - clc[e] : clc[e] - clr[h];
                    const bool ok = i < len && j < len && i >= j;
                    v[e] = keep(ok, d[8 * kk + 2 * r + e] * decay_of(dd));
                }
                frag_pair(a, kk, r, v[0], v[1]);
            }
        }
}

// the wide schedule's output tile of step st: dC (u, dS B), dB (v, dS' C)
// or dx (W' dy, tail B G), its row stride and rows, columns kept
__device__ __forceinline__ float* wide_target(const Params& p, const Ctx& x,
                                              const Step& st, int ln,
                                              long long& ld, int& vr,
                                              int& vc)
{
    const int b0 = BT * x.band, c0 = BT * st.tn;
    vr = min(BT, x.len - b0);
    if (st.type == S_WD || st.type == S_BG) {
        ld = p.p;
        vc = min(BT, p.p - c0);
        return p.dx + ((long long)ln * p.s + x.t0 + b0) * p.p + c0;
    }
    const long long row = p.ngrp > 1
        ? ((long long)x.grp * p.ngrp + x.hg) * p.s + x.t0 + b0
        : (long long)x.grp * p.s + x.t0 + b0;
    ld = p.n;
    vc = min(BT, p.n - c0);
    return (st.type == S_U || st.type == S_SB ? p.out_c : p.out_b)
        + row * p.n + c0;
}

// does the wide step st add into its output tile (else it writes it)
__device__ __forceinline__ bool wide_adds(const Ctx& x, const Step& st)
{
    if (st.type == S_U || st.type == S_V) return st.h != x.h0;
    return st.type != S_WD || st.sub != x.band;
}

// this thread's 32 values of a tile (row stride ld; rows < vr, columns
// < vc; 0 elsewhere), loaded together: pairs of columns as one 8-byte
// load where the tile's rows are 8-byte aligned
__device__ __forceinline__ void load_old(const float* __restrict__ out,
                                         long long ld, int vr, int vc,
                                         float (&old)[32])
{
    const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5 & 3)
        + (lane >> 2), t = lane & 3;
    const bool pairs = ((ld | (reinterpret_cast<uintptr_t>(out) >> 2)) & 1)
        == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int r = r0 + 8 * h, c = 8 * jj + 2 * t;
            const float* at = out + (long long)r * ld + c;
            float2 v = make_float2(0.f, 0.f);
            if (r < vr) {
                if (pairs && c + 1 < vc) {
                    v = *reinterpret_cast<const float2*>(at);
                } else {
                    if (c < vc) v.x = at[0];
                    if (c + 1 < vc) v.y = at[1];
                }
            }
            old[4 * jj + 2 * h] = v.x;
            old[4 * jj + 2 * h + 1] = v.y;
        }
}

// out = old + d * m[h] on the rows r0 + 8 h of this thread (8-byte
// stores as load_old's loads)
__device__ __forceinline__ void store_sum(float* __restrict__ out,
                                          long long ld, int vr, int vc,
                                          const float (&old)[32],
                                          const float (&d)[32],
                                          const float (&m)[2])
{
    const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5 & 3)
        + (lane >> 2), t = lane & 3;
    const bool pairs = ((ld | (reinterpret_cast<uintptr_t>(out) >> 2)) & 1)
        == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int r = r0 + 8 * h, c = 8 * jj + 2 * t;
            const int at = 4 * jj + 2 * h;
            const float2 v = make_float2(old[at] + d[at] * m[h],
                                         old[at + 1] + d[at + 1] * m[h]);
            float* dst = out + (long long)r * ld + c;
            if (r < vr) {
                if (pairs && c + 1 < vc) {
                    *reinterpret_cast<float2*>(dst) = v;
                } else {
                    if (c < vc) dst[0] = v.x;
                    if (c + 1 < vc) dst[1] = v.y;
                }
            }
        }
}

// the wide schedule's epilogue of a finished product: its output tile
// (wide_target) is written by the first contribution and added to by the
// rest, in schedule order (dC, dB across the group's heads); old: the
// tile's values, loaded while the product ran (0 where it writes).  u's
// and v's row sums go to the parts at once
__device__ __forceinline__ void wide_epilogue(const Params& p, const Ctx& x,
                                              const Step& st, int ln,
                                              const float (&acc)[32],
                                              const float (&sa)[32],
                                              const float (&xa)[32],
                                              const float* ev,
                                              const float* tv,
                                              const float (&old)[32])
{
    const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5 & 3)
        + (lane >> 2), t = lane & 3;
    const int b0 = BT * x.band;
    long long ld;
    int vr, vc;
    float* out = wide_target(p, x, st, ln, ld, vr, vc);
    float m[2] = {1.f, 1.f};
    if (st.type == S_U || st.type == S_V) {
        // u = exp(cl) (dy S_in') against C; v = x G' against B, times tail
        const bool u = st.type == S_U;
        const float* src = p.ptr[u ? T_CM : T_BM]
            + ((long long)x.grp * p.s + x.t0 + b0) * p.n + BT * st.tn;
        float* prow = p.parts + ((long long)ln * p.s + x.t0 + b0) * p.npart;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h, i = b0 + r;
            m[h] = u ? ev[i] : tv[i];
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int cc = 8 * jj + 2 * t + e;
                    if (i < x.len && cc < vc)
                        sum += src[(long long)r * p.n + cc]
                            * acc[4 * jj + 2 * h + e];
                }
            sum = quad_sum(sum) * m[h];
            if (!u && i == x.len - 1) sum = 0.f;    // the last row's tail
            if (t == 0 && r < vr)
                prow[(long long)r * p.npart + 2 + (u ? 0 : p.ntn) + st.tn] =
                    sum;
        }
        store_sum(out, ld, vr, vc, old, acc, m);
    } else if (st.type == S_SB || st.type == S_SPC) {
        store_sum(out, ld, vr, vc, old, acc, m);
    } else if (st.type == S_WD) {
        store_sum(out, ld, vr, vc, old, xa, m);
    } else {                                        // S_BG
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h] = tv[b0 + r0 + 8 * h];
        store_sum(out, ld, vr, vc, old, sa, m);
    }
}

template <int MODE>
__device__ __forceinline__ void consumer(const Params& p, const Ctx& x,
                                         unsigned char* smem, uint32_t bars)
{
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t pbase = smem_u32(smem);
    constexpr int FS = Ring<MODE>::FS, PS = Ring<MODE>::PS;
    const float* hvs = reinterpret_cast<const float*>(smem + Ring<MODE>::VEC);
    const uint32_t pfull = bars + 8 * 2 * FS, pempty = pfull + 8 * PS;
    const int r0 = 16 * w + g;          // this thread's rows r0, r0 + 8
    const int b0 = BT * x.band;         // the band's first chunk row

    // tot: the group's dC (ROW) or dB (COL), element i of this thread at
    // tot[WG i]; acc: a head's (and (a)'s state tile); sa: a dS tile,
    // then (COL) B G; xa: (COL) W' dy
    float* tot = reinterpret_cast<float*>(smem + Ring<MODE>::TOT) + tid;
    float acc[32], xa[32], sa[32];
    uint32_t fr[4][NPART][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = xa[i] = sa[i] = 0.f;
    if constexpr (MODE == M_BANDS) {    // only this mode keeps a total
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[WG * i] = 0.f;
    }
    float rsum[2] = {0.f, 0.f}, tsum[2] = {0.f, 0.f};
    Step st;
    Cursor cur = cursor_at(x, 0);
    for (int k = 0; k < x.nsteps; ++k, cursor_next(x, cur)) {
        describe<false>(p, x, cur, st);
        const int ln = x.grp * p.heads + st.h;
        // this head's vectors (the producer wrote them before it released
        // any step of the head)
        const float* cl = hvs + (st.h - x.h0) % HEAD_BUFS * HEAD_VEC;
        const float* ev = cl + MAXQ;
        const float* tv = cl + 2 * MAXQ;
        if (st.head_first) rsum[0] = rsum[1] = tsum[0] = tsum[1] = 0.f;
        const int s = k % PS;
        mbar_wait(pfull + 8 * s, (k / PS) & 1);
        const uint32_t pa = pbase + s * 2 * PTILE, pb = pa + PTILE;
        wg_fence();
        switch (st.type) {
        case S_U:
        case S_V:
            prod_ss<0>(acc, pa, pb, st.first);
            break;
        case S_ST:
            prod_ss<1>(acc, pa, pb, st.first);
            break;
        case S_S:
        case S_SP:
            prod_ss<0>(sa, pa, pb, st.first);
            break;
        case S_BG:
            prod_ss<1>(sa, pa, pb, st.first);
            break;
        case S_WD:
            prod_ss<1>(xa, pa, pb, st.first);
            break;
        default:                        // S_SB, S_SPC
            prod_rs(acc, fr, pb, st.first);
            break;
        }
        wg_commit();
        if ((st.type == S_SB || st.type == S_SPC) && st.tn == 0) {
            // while the product runs: g from the scores the producer
            // copied into the A slot
            const float* sc = reinterpret_cast<const float*>(
                smem + s * 2 * PTILE);
            if (st.type == S_SB)
                g_sums<true>(fr, sc, cl, b0, BT * st.sub, r0, t, x.len,
                             rsum);
            else
                g_sums<false>(fr, sc, cl, b0, BT * st.sub, r0, t, x.len,
                              rsum);
        }
        // wide: the old values of the tile the step adds into, loaded while
        // the product runs
        float old[32];
        if (x.wide && st.last && st.type != S_S && st.type != S_SP) {
            long long ld;
            int vr, vc;
            const float* out = wide_target(p, x, st, ln, ld, vr, vc);
            if (wide_adds(x, st))
                load_old(out, ld, vr, vc, old);
            else
#pragma unroll
                for (int i = 0; i < 32; ++i) old[i] = 0.f;
        }
        wg_wait<0>();
        wg_hold(acc);
        wg_hold(sa);
        wg_hold(xa);
        mbar_arrive(pempty + 8 * s);

        // epilogues: they read the accumulators, and write only tot,
        // the row sums, the fragments and (wide) the output tiles
        if (MODE == M_STATE) {
            if (st.last) {                      // (a)'s state tile
                const int ln = x.grp * p.heads + x.h0;
                const int n0 = BT * x.tile, p0 = BT * st.tn;
                store_tile(p.gst + (((long long)ln * p.nc + x.c) * p.n + n0)
                               * p.p + p0,
                           p.p, min(BT, p.n - n0), min(BT, p.p - p0), acc, w,
                           g, t);
            }
        } else if (x.wide && st.type != S_S && st.type != S_SP) {
            if (st.last) wide_epilogue(p, x, st, ln, acc, sa, xa, ev, tv, old);
        } else if (st.type == S_U && st.last) {
            // u = exp(cl) (dy S_in'); its row sums against C; into dC
            const float* cm = p.ptr[T_CM]
                + ((long long)x.grp * p.s + x.t0 + b0) * p.n;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 8 * h, i = b0 + r;
                const float e = ev[i];
                const float* crow = cm + (long long)r * p.n;
                float sum = 0.f;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int cc = 8 * jj + 2 * t + u;
                        const int at = 4 * jj + 2 * h + u;
                        const float a = acc[at] * e;
                        tot[WG * at] += a;
                        if (i < x.len && cc < p.n) sum += crow[cc] * a;
                    }
                tsum[h] = sum;
            }
        } else if (st.type == S_V && st.last) {
            // v = x G': r against B (rows before the last); tail v into dB
            const float* bm = p.ptr[T_BM]
                + ((long long)x.grp * p.s + x.t0 + b0) * p.n;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 8 * h, j = b0 + r;
                const float tl = tv[j];
                const float* brow = bm + (long long)r * p.n;
                float sum = 0.f;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int cc = 8 * jj + 2 * t + u;
                        const int at = 4 * jj + 2 * h + u;
                        if (j < x.len && cc < p.n) sum += brow[cc] * acc[at];
                        tot[WG * at] += acc[at] * tl;
                    }
                tsum[h] = j == x.len - 1 ? 0.f : tl * sum;
            }
        } else if (st.type == S_S && st.last) {
            ds_frags<true>(fr, sa, cl, b0, BT * st.sub, r0, t, x.len);
        } else if (st.type == S_SP && st.last) {
            ds_frags<false>(fr, sa, cl, b0, BT * st.sub, r0, t, x.len);
        }

        if (MODE != M_STATE && st.head_last) {
            // this head's dC (dB) into the group's total; its row parts;
            // COL: its dx = W' dy + tail (B G)
            const bool row = x.kind == K_ROW;
            if (!x.wide) {
#pragma unroll
                for (int i = 0; i < 32; ++i) tot[WG * i] += acc[i];
            }
            const int vb = min(BT, x.len - b0);
            float* prow = p.parts
                + ((long long)ln * p.s + x.t0 + b0) * p.npart;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float gs = quad_sum(rsum[h]);
                const float ts = quad_sum(tsum[h]);
                const int r = r0 + 8 * h;
                if (t == 0 && r < vb) {
                    float* pr = prow + (long long)r * p.npart;
                    pr[row ? 0 : 1] = gs;
                    if (!x.wide) pr[row ? 2 : 2 + p.ntn] = ts;
                }
            }
            if (!x.wide && !row) {
                float* out = p.dx + ((long long)ln * p.s + x.t0 + b0) * p.p;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 8 * h;
                    if (r >= vb) continue;
                    const float tl = tv[b0 + r];
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int c = 8 * jj + 2 * t + e;
                            const int at = 4 * jj + 2 * h + e;
                            if (c < p.p)
                                out[(long long)r * p.p + c] = xa[at]
                                    + tl * sa[at];
                        }
                }
            }
        }
    }

    // outputs: the group's dC (ROW) or dB (COL)
    if constexpr (MODE == M_STATE) return;
    if (x.wide) return;
    float* out = x.kind == K_ROW ? p.out_c : p.out_b;
    const long long row0 = p.ngrp > 1
        ? ((long long)x.grp * p.ngrp + x.hg) * p.s + x.t0 + b0
        : (long long)x.grp * p.s + x.t0 + b0;
    float sum[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = tot[WG * i];
    store_tile(out + row0 * p.n, p.n, min(BT, x.len - b0), p.n, sum, w, g,
               t);
}

// (a) and (c): one body, two kernels.  The role is read through a
// shuffle so that the compiler sees it warp-uniform (wgmma in a branch it
// takes for divergent is serialised)
template <int MODE>
__device__ __forceinline__ void tile_body(const Params& p)
{
    extern __shared__ __align__(1024) unsigned char raw[];
    // 1024-aligned for the swizzled tiles, by pointer arithmetic on raw
    // (so that the compiler keeps its address space: shared loads)
    unsigned char* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    Ctx x;
    if (!block_ctx<MODE>(p, x)) return;
    // mbarriers: each float32 slot's (one arrival, and one a producer
    // thread where a tensor takes 4-byte copies), each parts stage's full
    // (both producers' threads) and empty (the consumer's)
    constexpr int FS = Ring<MODE>::FS, PS = Ring<MODE>::PS;
    const uint32_t bars = smem_u32(smem + Ring<MODE>::BARS);
    const bool cp_arrive = p.tma != (1 << NT) - 1;
    if (threadIdx.x == 0) {
        for (int f = 0; f < 2 * FS; ++f)
            mbar_init(bars + 8 * f, cp_arrive ? WG + 1 : 1);
        for (int s = 0; s < PS; ++s) {
            mbar_init(bars + 8 * (2 * FS + s), 2 * WG);
            mbar_init(bars + 8 * (2 * FS + PS + s), WG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);
    if (role == 0) {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(CONSUMER_REGS));
        consumer<MODE>(p, x, smem, bars);
    } else {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(PRODUCER_REGS));
        if (role == 1)
            producer<MODE, 0>(p, x, smem, bars, cp_arrive);
        else
            producer<MODE, 1>(p, x, smem, bars, cp_arrive);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_state_kernel(const __grid_constant__ Params p)
{
    tile_body<M_STATE>(p);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_band_kernel(const __grid_constant__ Params p)
{
    tile_body<M_BANDS>(p);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_wide_kernel(const __grid_constant__ Params p)
{
    tile_body<M_WIDE>(p);
}

// (b) the gradient of the state leaving each chunk, in reverse chunk order
// in place over (a)'s terms; one thread per (lane, V state entries), V =
// 4 (float4) when N P % 4 == 0; blockIdx.x = lane
__device__ __forceinline__ float axpy(float a, float x, float y)
{
    return a * x + y;
}
__device__ __forceinline__ float4 axpy(float a, float4 x, float4 y)
{
    return make_float4(a * x.x + y.x, a * x.y + y.y, a * x.z + y.z,
                       a * x.w + y.w);
}

template <typename V>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(V* __restrict__ gst, const float* __restrict__ decay,
                    const V* __restrict__ dstate, int nv, int nc)
{
    const int idx = blockIdx.y * PASS_THREADS + threadIdx.x;
    if (idx >= nv) return;
    const long long ln = blockIdx.x;
    V* st = gst + ln * nc * nv + idx;
    const float* dl = decay + ln * nc;
    V run = dstate != nullptr ? dstate[ln * nv + idx] : V{};
    // eight chunks' terms loaded together, then passed in order
    for (int c0 = nc - 1; c0 >= 0; c0 -= 8) {
        V local[8];
        float d[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (c0 - u >= 0) {
                local[u] = st[(long long)(c0 - u) * nv];
                d[u] = dl[c0 - u];
            }
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (c0 - u >= 0) {
                st[(long long)(c0 - u) * nv] = run;
                run = axpy(d[u], run, local[u]);
            }
    }
}

// (d) blockIdx.x < items: dla of one (lane, chunk), a thread a chunk row:
// <S_in, G> (a tree in a fixed order), dcl from the parts in a fixed
// order, the chunk-end terms at the last row, then the reverse cumulative
// sum (one thread, in order).  Past items: dbm, dcm as the sums of the
// head groups' partials in group order (V = 4 entries a thread where N %
// 4 == 0)
template <typename V>
__device__ __forceinline__ void group_sum(const V* __restrict__ part,
                                          V* __restrict__ out,
                                          long long per_group,
                                          long long total, int ngrp,
                                          long long first, long long stride)
{
    for (long long idx = first; idx < total; idx += stride) {
        const long long grp = idx / per_group, off = idx - grp * per_group;
        const V* src = part + grp * ngrp * per_group + off;
        V sum = src[0];
        for (int k = 1; k < ngrp; ++k) {
            const V v = src[k * per_group];
            if constexpr (sizeof(V) == 16) {
                sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
            } else {
                sum += v;
            }
        }
        out[idx] = sum;
    }
}

__global__ void __launch_bounds__(ROW_THREADS)
ssd_bwd_tail_kernel(const float* __restrict__ states,
                    const float* __restrict__ gst,
                    const float* __restrict__ parts,
                    const float* __restrict__ decay, float* __restrict__ dla,
                    const float* __restrict__ part_b,
                    const float* __restrict__ part_c, float* __restrict__ dbm,
                    float* __restrict__ dcm, int s, int q, int nc, int ntn,
                    int npart, long long np, long long items,
                    long long per_group, long long total, int ngrp, int vec4)
{
    __shared__ float red[ROW_THREADS], dc[MAXQ];
    const int i = threadIdx.x;
    if ((long long)blockIdx.x >= items) {
        const long long blk = blockIdx.x - items;
        const long long first = blk * ROW_THREADS + i;
        const long long stride = (long long)(gridDim.x - items) * ROW_THREADS;
        if (vec4) {
            group_sum<float4>((const float4*)part_b, (float4*)dbm,
                              per_group / 4, total / 4, ngrp, first, stride);
            group_sum<float4>((const float4*)part_c, (float4*)dcm,
                              per_group / 4, total / 4, ngrp, first, stride);
        } else {
            group_sum<float>(part_b, dbm, per_group, total, ngrp, first,
                             stride);
            group_sum<float>(part_c, dcm, per_group, total, ngrp, first,
                             stride);
        }
        return;
    }
    const long long item = blockIdx.x, ln = item / nc;
    const int c = (int)(item - ln * nc);
    const int t0 = c * q, len = min(q, s - t0);
    // <S_in, G> (16-byte loads where both allow them)
    const float* a = states + item * np;
    const float* b = gst + item * np;
    float sum = 0.f;
    if (((np | (reinterpret_cast<uintptr_t>(a) >> 2)
          | (reinterpret_cast<uintptr_t>(b) >> 2)) & 3) == 0) {
        const float4* a4 = reinterpret_cast<const float4*>(a);
        const float4* b4 = reinterpret_cast<const float4*>(b);
        for (long long e = i; e < np / 4; e += ROW_THREADS) {
            const float4 u = a4[e], v = b4[e];
            sum += u.x * v.x;
            sum += u.y * v.y;
            sum += u.z * v.z;
            sum += u.w * v.w;
        }
    } else {
        for (long long e = i; e < np; e += ROW_THREADS) sum += a[e] * b[e];
    }
    red[i] = sum;
    __syncthreads();
    for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
        if (i < w) red[i] += red[i + w];
        __syncthreads();
    }
    const float sg = red[0];
    __syncthreads();
    float v = 0.f, tr = 0.f;
    if (i < len) {
        const float* pr = parts + (ln * s + t0 + i) * npart;
        v = pr[0] - pr[1];
        for (int u = 0; u < ntn; ++u) v += pr[2 + u];
        for (int u = 0; u < ntn; ++u) tr += pr[2 + ntn + u];
        v -= tr;
    }
    red[i] = tr;
    __syncthreads();
    for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
        if (i < w) red[i] += red[i + w];
        __syncthreads();
    }
    if (i == len - 1) v += red[0] + decay[item] * sg;
    dc[i] = v;
    __syncthreads();
    if (i == 0) {
        float run = 0.f;
        for (int k = len - 1; k >= 0; --k) {
            run += dc[k];
            dc[k] = run;
        }
    }
    __syncthreads();
    if (i < len) dla[ln * s + t0 + i] = dc[i];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// a (lanes, rows, width) float32 tensor as a 3-D map of 64 x 64 boxes of
// one lane, no swizzle, zeros past the edges; false where the tensor's
// rows or base are not 16-byte multiples (the maps' rule)
bool map3(EncodeTiled enc, CUtensorMap* m, const void* ptr, long long lanes,
          int rows, int width)
{
    if ((width * 4) % 16 != 0 || ((uintptr_t)ptr & 15) != 0) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                                (cuuint64_t)lanes};
    const cuuint64_t strides[2] = {(cuuint64_t)width * 4,
                                   (cuuint64_t)rows * width * 4};
    const cuuint32_t box[3] = {BT, BT, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The backward in the launches (a)-(d) above.  Inputs: the forward's
// operands xbar, la, bm, cm; its scores cb (BH / heads, nc, Qp, Qp) and
// chunk states (BH, nc, N, P: the state entering each chunk) and decays
// (BH, nc) as ssd_scan's pass (c) leaves them; dy; dstate (null: zero).
// Outputs dx, dla, dbm, dcm.  Scratch: gst (BH, nc, N, P), parts (BH, S,
// 2 + 2 ceil(N / 64)), and where heads > 1 the head groups' partials
// part_b, part_c (BH / heads, groups, S, N) (where heads is 1 they are not
// read: the blocks write dbm, dcm).  nc = ceil(S / Q), Qp = Q rounded up
// to 64, groups = ceil(heads / ceil(heads / 8)); Q <= 256, N P at most
// 65535 * 256 entries, and within the grids' limits as the wrapper's
// check_backward_shape states them (BH nc ceil(N / 64) ceil(P / 64) and
// BH nc + 2^20 under 2^31)
extern "C" int repro_ssd_scan_bwd(const void* xbar, const void* la,
                                  const void* bm, const void* cm,
                                  const void* cb, const void* states,
                                  const void* decay, const void* dy,
                                  const void* dstate, void* dx, void* dla,
                                  void* dbm, void* dcm, void* gst,
                                  void* parts, void* part_b, void* part_c,
                                  int bh, int s, int p, int n, int q,
                                  int heads, void* stream)
{
    if (n < 1 || p < 1 || s < 1 || q < 1 || q > MAXQ || heads < 1
        || bh % heads != 0)
        return (int)cudaErrorInvalidValue;
    const int nc = (s + q - 1) / q, qp = (q + BT - 1) / BT * BT;
    const int ntn = (n + BT - 1) / BT, npt = (p + BT - 1) / BT;
    const int hpg = (heads + HEAD_GROUPS - 1) / HEAD_GROUPS;
    const int ngrp = (heads + hpg - 1) / hpg;
    const int groups = bh / heads;
    const long long items = (long long)bh * nc;
    const long long state_blocks = items * ntn * npt;
    if (state_blocks >= (1LL << 31) || items + (1LL << 20) >= (1LL << 31)
        || (long long)n * p > 65535LL * PASS_THREADS
        || (ngrp > 1 && (part_b == nullptr || part_c == nullptr)))
        return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    static SmemGrant grant_state, grant_band, grant_wide;
    cudaError_t e = allow_smem(ssd_bwd_state_kernel, Ring<M_STATE>::SMEM,
                               &grant_state);
    if (e == cudaSuccess)
        e = allow_smem(ssd_bwd_band_kernel, Ring<M_BANDS>::SMEM,
                       &grant_band);
    if (e == cudaSuccess)
        e = allow_smem(ssd_bwd_wide_kernel, Ring<M_WIDE>::SMEM,
                       &grant_wide);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t st = (cudaStream_t)stream;

    Params prm;
    const void* ptrs[NT] = {xbar, dy, bm, cm, states, gst, cb};
    const long long lanes[NT] = {bh, bh, groups, groups, items, items,
                                 (long long)groups * nc};
    const int rows[NT] = {s, s, s, s, n, n, qp};
    const int widths[NT] = {p, p, n, n, p, p, qp};
    prm.tma = 0;
    for (int t = 0; t < NT; ++t) {
        prm.ptr[t] = (const float*)ptrs[t];
        prm.width[t] = widths[t];
        prm.rows[t] = rows[t];
        if (map3(enc, &prm.map[t], ptrs[t], lanes[t], rows[t], widths[t]))
            prm.tma |= 1 << t;
    }
    prm.la = (const float*)la;
    prm.dx = (float*)dx;
    prm.parts = (float*)parts;
    prm.out_b = ngrp > 1 ? (float*)part_b : (float*)dbm;
    prm.out_c = ngrp > 1 ? (float*)part_c : (float*)dcm;
    prm.gst = (float*)gst;
    prm.s = s;
    prm.p = p;
    prm.n = n;
    prm.q = q;
    prm.qp = qp;
    prm.nc = nc;
    prm.heads = heads;
    prm.groups = groups;
    prm.hpg = hpg;
    prm.ngrp = ngrp;
    prm.ntn = ntn;
    prm.npt = npt;
    prm.nsub = qp / BT;
    prm.npart = 2 + 2 * ntn;
    prm.wide = ntn > 1 || npt > 1;
    cudaError_t err;

    // (a)
    ssd_bwd_state_kernel<<<(unsigned)(items * ntn), THREADS,
                           Ring<M_STATE>::SMEM, st>>>(prm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // (b)
    const int np = n * p;
    if (np % 4 == 0 && (((uintptr_t)gst | (uintptr_t)dstate) & 15) == 0)
        ssd_bwd_pass_kernel<float4><<<dim3(bh, (np / 4 + PASS_THREADS - 1)
                                               / PASS_THREADS),
                                      PASS_THREADS, 0, st>>>(
            (float4*)gst, (const float*)decay, (const float4*)dstate, np / 4,
            nc);
    else
        ssd_bwd_pass_kernel<float><<<dim3(bh, (np + PASS_THREADS - 1)
                                              / PASS_THREADS),
                                     PASS_THREADS, 0, st>>>(
            (float*)gst, (const float*)decay, (const float*)dstate, np, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // (c): x the (batch row, head group, chunk) items of a band, y the
    // band slots
    const long long band_items = (long long)groups * ngrp * nc;
    const dim3 band_grid((unsigned)band_items, 2 * prm.nsub);
    if (prm.wide)
        ssd_bwd_wide_kernel<<<band_grid, THREADS, Ring<M_WIDE>::SMEM, st>>>(
            prm);
    else
        ssd_bwd_band_kernel<<<band_grid, THREADS, Ring<M_BANDS>::SMEM,
                              st>>>(prm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // (d)
    const long long per_group = (long long)s * n;
    const long long total = (long long)groups * per_group;
    const int vec4 = n % 4 == 0
        && (((uintptr_t)part_b | (uintptr_t)part_c | (uintptr_t)dbm
             | (uintptr_t)dcm) & 15) == 0;
    long long sum_blocks = 0;
    if (ngrp > 1) {
        sum_blocks = ((vec4 ? total / 4 : total) + ROW_THREADS - 1)
            / ROW_THREADS;
        if (sum_blocks > (1LL << 20)) sum_blocks = 1LL << 20;
    }
    ssd_bwd_tail_kernel<<<(unsigned)(items + sum_blocks), ROW_THREADS, 0,
                          st>>>(
        (const float*)states, (const float*)gst, (const float*)parts,
        (const float*)decay, (float*)dla, (const float*)part_b,
        (const float*)part_c, (float*)dbm, (float*)dcm, s, q, nc, ntn,
        prm.npart, (long long)np, items, per_group, total, ngrp, vec4);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
