// Hopper (sm_90a) kernels for the megabatch cross-fit programs.
//
// Built by kernels/build.py with nvcc into a shared library with a plain C
// interface and loaded with ctypes; no PyTorch header is included.  Every
// entry point launches on the stream it is given, allocates nothing, does
// not synchronise and returns cudaGetLastError().
//
//   repro_batched_gram     per-task masked normal equations
//                          G_b = X_b' diag(w_b) X_b,  b_b = X_b'(w_b * y_b);
//                          batched_gram_blocked's (B, C, Nc, P) is launched
//                          as its merged (B, C Nc, P) rows
//   repro_crossfit_gram    the same for T tasks over one shared X (N, P)
//                          G_t = X' diag(w_t) X,  b_t = X'(w_t * y_t)
//   repro_batched_predict  masked GEMV epilogue
//                          out_b = valid_b * (X_b beta_b)
//
// Inputs are contiguous float32 at their true (B, N, P) or (N, P) with
// (T, N): any N, the ragged edges are masked here.  Plain FMA in float32 —
// no TF32, no tensor cores — and one fixed accumulation order per output
// element, so a result does not depend on the launch's batch size, its
// launch plan or the other lanes.  The Gram kernels keep a ring of row
// blocks in flight with cp.async, their launch plans chosen in Python
// (kernels/megabatch.py, kernels/crossfit_gram.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// batched_gram (K1) and batched_gram_blocked (K3)
//
// Replace batched_gram_pallas and batched_gram_blocked_pallas
// (src/repro/kernels/megabatch.py, bodies _gram_kernel and
// _gram_blocked_kernel): per task b, G_b = X_b' diag(w_b) X_b and b_b =
// X_b'(w_b y_b) over xs (B, N, P).  K3's (B, C, Nc, P) is contiguous, so
// its rows already lie as the merged (B, C Nc, P): the wrapper launches
// this kernel on that view, and K3 is K1 on the merged rows, bit for bit.
//
// The order of summation.  Every output element is four chains, one per
// row group g in 0..3: group g takes rows [16 g, 16 g + 16) of every
// 64-row step, in order; a G term is fmaf(w x_i (rounded once), x_j, acc)
// for i <= j, a b term fmaf(w y (rounded once), x_j, acc).  Rows at or past
// N are zero (w 0, x 0) up to the end of the last 64-row step, as the
// kernel before this one staged them.  The four chains are added as
// ((g0 + g1) + g2) + g3.  crossfit_gram (K4) sums in the same order, so
// K4 is bitwise K1 on x broadcast to (T, N, P).  Each chain is whole in
// one thread of one block; what is split across blocks is the set of
// chains: the four row groups of a task run in four blocks, and a row
// group's elements may be split over `chunks` blocks.  The row groups meet
// in a second launch, which adds their partial tiles in the fixed order.
// Nothing is accumulated with atomics.
//
// Bound on an H100: P/2 float32 operations per byte of X.  At the paper's
// (32, 5104, 33) and the tall path's (32, 250016, 33) bound by bytes
// (0.00687 and 0.334 ms at 3.35 TB/s), at the wide P 257 by operations
// (1.92 ms at 67 TFLOP/s at (32, 60000, 257)).
//
// - Blocks.  Grid (4 chunks, B): block (4 c + g, b) walks only row group
//   g of task b, so each row of X is read once (once per chunk from L2).
//   At the paper's 32 tasks that is 128 blocks, at 8 tasks 4 chunks of
//   each row group; a launch of at most 132 blocks asks for more than half
//   an SM's shared memory, so that each runs on an SM of its own.
//   (Clusters of the four row groups, meeting in distributed shared
//   memory, were tried: at one block an SM the card holds 30 such
//   clusters, 120 SMs.)
// - Items.  A thread owns an SI x SJ sub-tile of the (P + 1) x P matrix M
//   whose rows 0..P-1 are w x_i and whose row P is w y: M[i][j] is G[i][j]
//   for i <= j < P, and b[j] for i = P.  The items are the sub-tiles that
//   meet the upper triangle, and every sub-tile of the last sub-row (the
//   one holding row P): 53 items of 4 x 4 at P 33, 848 FMAs a row where
//   the 32 x 32 tiles of the kernel before executed 3072.  The launch plan
//   (kernels/megabatch.py::gram_launch_plan) picks (SI, SJ), the chunks,
//   the ring and the layout from (B, N, P), and gives the kernel a table:
//   each chunk's items and the columns they read.
// - Windows.  A chunk reads columns [a0, a0 + na) of M's rows (w x, w y)
//   and [b0, b0 + nb) of x.  Up to about 2400 columns both are the whole
//   row; wider, the items are grouped by column panels (a pair of 128-
//   column panels a chunk, 8 x 8 items; the instance PANELS), so that a
//   block stages two panels of each row and its buffers do not grow with
//   P.
// - Warps.  The consumers (the first warps, one thread an item) multiply
//   out; four producer warps feed them: warp 0 keeps a ring of `ring`
//   slots of `srows` rows of the group full with 1-D bulk copies, warps
//   1..3 turn each slot into two padded row buffers, w x (with w y as
//   column P) and x, at strides that are multiples of 16 bytes, so that a
//   consumer's reads are float2 or float4 and w x_i is rounded once per
//   element, not once per thread.  With one or two consumer warps the
//   producers sit on the other schedulers.  mbarriers count a slot's bytes
//   in and its release; named barriers hand the two buffers over.
// - Copies.  A slot is pieces of min(srows, 16) rows, each contiguous in X
//   (4 P bytes a row): a piece's X, w and y are each one bulk copy of the
//   aligned 16-byte chunks around it (a task's base may start anywhere on
//   a float; a piece starts a multiple of 4 rows into the task, so its
//   shift is the task's), cut at the task's N; the rows past N are written
//   as zeros by the producers.  With panels each row's two windows are a
//   bulk copy each, every row at its own shift.
// - Only i <= j is stored, to both [i][j] and [j][i], so G is exactly
//   symmetric.  Rows with w == 0 add exact zeros.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/bench_gram.py,
// PERF.md's kernel table): 0.0345 ms at (32, 5104, 33) (the kernel
// before: 0.0903), 1.063 ms at K3's (32, 4, 62504, 33) (3.942), 6.63 ms
// at (32, 60000, 257) (8.35); on column panels 1.27 ms at (2, 1000, 2600),
// slower than the kernel before (0.709).
// ---------------------------------------------------------------------------
constexpr int TILE = 32;            // K4's output tile edge
constexpr int GRAM_ROWS = 64;       // rows of N a step
constexpr int GRAM_GROUPS = 4;      // row groups of a step: blocks a task
constexpr int GROUP_ROWS = GRAM_ROWS / GRAM_GROUPS;
constexpr int GRAM_MAX_CONSUMERS = 256;    // threads that own sub-tiles
constexpr int GRAM_PRODUCER_THREADS = 128; // a warp that copies, and
constexpr int GRAM_PREPARERS = 96;         // three that prepare the rows
constexpr int GRAM_MAX_THREADS = GRAM_MAX_CONSUMERS + GRAM_PRODUCER_THREADS;
// warps of a block with wc consumer warps: with one or two, the producer
// warps sit on the other schedulers, past one or two idle warps
__host__ __device__ inline int gram_warps(int wc)
{
    return wc + 4 + (wc <= 2 ? wc : 0);
}
constexpr int GRAM_MAX_RING = 8;
constexpr int GRAM_MAX_SROWS = 128; // rows of the group a ring slot
constexpr int GRAM_SMEM_MAX = 232448;
// the ring's mbarriers: per ring slot one that its copies complete, one
// that the preparers are done with it (8 bytes each)
constexpr int GRAM_BAR_FLOATS = 4 * GRAM_MAX_RING;

// A block's shared memory and its share of the items, as the launch plan
// lays them out (kernels/megabatch.py::gram_layout owns every number; the
// C entry only checks that the pieces fit and do not overlap).  From float
// 0 a ring of `ring` slots, each srows / pr staged pieces of blk floats: a
// piece is pr rows of the group, their X (whole rows, or with column
// panels, seg floats a row for its A then its B window) followed by w at
// wa and y at wa + pr + 8.  From pad_at two padded buffers of srows rows:
// w x at stride ws, then x at stride xs.  From bar_at the mbarriers.
struct GramLayout {
    int per_cta, ring, srows, pr, ws, xs, blk, wa, seg, pad_at, bar_at;
};
constexpr int GRAM_LAYOUT_INTS = 11;
static_assert(sizeof(GramLayout) == GRAM_LAYOUT_INTS * sizeof(int), "");

template <int S>
__device__ __forceinline__ void gram_load(const float* s, float (&v)[S])
{
    if constexpr (S == 2) {
        const float2 t = *reinterpret_cast<const float2*>(s);
        v[0] = t.x; v[1] = t.y;
    } else {
#pragma unroll
        for (int k = 0; k < S; k += 4) {
            const float4 t = *reinterpret_cast<const float4*>(s + k);
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
    }
}

__device__ __forceinline__ uint32_t gram_smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers and 1-D bulk copies (the TMA's plain form): a copy of `bytes`
// (a multiple of 16, both addresses 16-byte aligned) completes on an
// mbarrier that was told to expect that many bytes
__device__ __forceinline__ void gram_mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void gram_mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
                 : "memory");
}
__device__ __forceinline__ void gram_mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void gram_mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void gram_bulk_copy(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One column c of a staged piece of PR whole rows -> the padded buffers:
// x (column P: none) and w x (column P: w y); rows at or past N (rr >= nr)
// are zero, as the kernel before this one staged them
template <int PR>
__device__ __forceinline__ void gram_prepare_col(
    const float* px, const float* pw, const float* py, int p, int c, int nr,
    float* dwx, float* dx, int ws, int xs)
{
    float v[PR], wv[PR];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
        wv[r] = pw[r];
        v[r] = c < p ? px[r * p] : py[r];
    }
#pragma unroll
    for (int r = 0; r < PR; ++r) {
        const float xv = r < nr ? v[r] : 0.f;
        const float wr = r < nr ? wv[r] : 0.f;
        if (c < p) dx[r * xs] = xv;
        dwx[r * ws] = wr * xv;
    }
}

// The same with column panels: column c of one window of a piece, whose
// rows are segments `seg` floats apart, row r's first value sh0 + r P
// floats (mod 4) into its segment; ycol: the column is P (w y); with
// pw the column is multiplied by w (the A window), without it is x (B)
template <int PR>
__device__ __forceinline__ void gram_prepare_panel(
    const float* px, int seg, int sh0, int p, int c, bool ycol,
    const float* pw, const float* py, int nr, float* d, int stride)
{
    float v[PR];
#pragma unroll
    for (int r = 0; r < PR; ++r)
        v[r] = ycol ? py[r] : px[r * seg + ((sh0 + r * (p & 3)) & 3) + c];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
        const float xv = r < nr ? v[r] : 0.f;
        if (pw) d[r * stride] = (r < nr ? pw[r] : 0.f) * xv;
        else d[r * stride] = xv;
    }
}

// D rows of the group, loaded (a: the thread's w x columns of the first
// row, b: its x columns) and multiplied out in order
template <int SI, int SJ, int D>
__device__ __forceinline__ void gram_load_rows(const float* a, const float* b,
                                               int ws, int xs,
                                               float (&av)[D][SI],
                                               float (&bv)[D][SJ])
{
#pragma unroll
    for (int r = 0; r < D; ++r) {
        gram_load<SI>(a + r * ws, av[r]);
        gram_load<SJ>(b + r * xs, bv[r]);
    }
}
template <int SI, int SJ, int D>
__device__ __forceinline__ void gram_fma_rows(const float (&av)[D][SI],
                                              const float (&bv)[D][SJ],
                                              float (&acc)[SI][SJ])
{
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
            for (int j = 0; j < SJ; ++j)
                acc[i][j] = fmaf(av[r][i], bv[r][j], acc[i][j]);
}

// named barriers: bar.sync waits for `n` threads (itself included) at
// barrier `id`, bar.arrive counts itself and goes on; both order the
// shared-memory accesses before them for the threads that wait
__device__ __forceinline__ void gram_bar_sync(int id, int n)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void gram_bar_arrive(int id, int n)
{
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
constexpr int GRAM_BAR_PROD = 1;            // the producers, once
constexpr int GRAM_BAR_FULL = 2;            // + buffer: ready to multiply
constexpr int GRAM_BAR_EMPTY = 4;           // + buffer: multiplied out

template <int SI, int SJ, bool PANELS>
__global__ void __launch_bounds__(GRAM_MAX_THREADS, 1)
batched_gram_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ y, float* __restrict__ part,
                    const int* __restrict__ table, int n, int p,
                    const GramLayout L)
{
    extern __shared__ __align__(16) float gm_smem[];
    // rows a consumer loads ahead: fewer for wider sub-tiles (registers)
    constexpr int D = SI * SJ <= 16 ? 4 : 1;
    const int grp = blockIdx.x & (GRAM_GROUPS - 1);    // row group
    const int chunk = blockIdx.x / GRAM_GROUPS;
    const int chunks = gridDim.x / GRAM_GROUPS;
    const int task = blockIdx.y;
    const int tid = threadIdx.x;
    const int ncons = (L.per_cta + 31) / 32 * 32;
    // warp roles: the consumers first; the four producer warps (pw 0: the
    // copies, 1..3: the rows) on schedulers (warp % 4) the consumers leave
    // free while there are at most two consumer warps (gram_warps)
    const int warp = tid >> 5, wc = ncons >> 5;
    int pw = -1;
    if (warp >= wc) {
        pw = warp - wc;
        if (wc <= 2) {
            pw = 0;
            for (int v = wc; v < warp; ++v) pw += (v & 3) >= wc;
            if ((warp & 3) < wc) pw = -1;
        }
    }
    // the chunk's windows: columns [a0, a0 + na) of the (P + 1)-column
    // rows w x (column P: w y) and [b0, b0 + nb) of x; whole rows, or one
    // column panel each
    const int4 win = reinterpret_cast<const int4*>(table)[chunk];
    const int pr = L.pr, slot_f = (L.srows / pr) * L.blk;
    const int pad_f = L.srows * (L.ws + L.xs);
    float* raw = gm_smem;
    float* pad = gm_smem + L.pad_at;            // two buffers of pad_f
    // the group's rows: 16 of every 64-row step, up to the last step's end
    const int qn = (n + GRAM_ROWS - 1) / GRAM_ROWS * GROUP_ROWS;
    const int n_slots = (qn + L.srows - 1) / L.srows;

    // each operand's first float mod 4, and where a task's staged pieces
    // start within their first chunk (a piece starts 4 k P floats into
    // the task, a multiple of 16 bytes, so the shift is the task's)
    const long long row_base = (long long)task * n;
    const int xsh = (int)(((uintptr_t)xs >> 2) & 3);
    const int wsh = (int)(((uintptr_t)w >> 2) & 3);
    const int ysh = (int)(((uintptr_t)y >> 2) & 3);
    const int shx = (int)((row_base * p + xsh) & 3);
    const int shw = (int)((row_base + wsh) & 3);
    const int shy = (int)((row_base + ysh) & 3);

    float acc[SI][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) acc[i][j] = 0.f;
    // the thread's item: sub-tile (it, jt) of the (P + 1) x P matrix, or
    // none (it < 0)
    int2 item = make_int2(-1, 0);
    if (tid < L.per_cta)
        item = reinterpret_cast<const int2*>(table + 4 * chunks)[
            (size_t)chunk * L.per_cta + tid];
    const bool active = item.x >= 0;

    if (pw >= 0) {
        // ---- producers: warp 0 copies slots into the ring with bulk
        // copies; warps 1..3 turn each slot into the padded w x and x rows
        // of buffer s & 1
        const int pt = 32 * pw + (tid & 31);
        const uint32_t bar0 = gram_smem_addr(gm_smem + L.bar_at);
        // piece k of slot s: group row q0 is task row 64 (q0 / 16) + 16 grp
        // + q0 % 16; nr of its pr rows lie before N
        auto piece_rows = [&](int s, int k, long long& r0) {
            const int q0 = s * L.srows + k * pr;
            r0 = (long long)(q0 >> 4) * GRAM_ROWS + grp * GROUP_ROWS
                + (q0 & (GROUP_ROWS - 1));
            return q0 >= qn || n - r0 <= 0 ? 0
                : (n - r0 < pr ? (int)(n - r0) : pr);
        };
        // [first, end) floats of an operand whose first float is `sh0` mod
        // 4, widened to whole aligned 16-byte chunks
        auto span = [](long long first, long long end, int sh0,
                       long long& at, uint32_t& bytes) {
            at = first - ((first + sh0) & 3);
            const long long e = end + ((4 - ((end + sh0) & 3)) & 3);
            bytes = (uint32_t)(4 * (e - at));
        };
        // copy ci of slot s into ring slot q (its bytes, 0 for none): per
        // piece, whole rows: its X, w, y; panels: each row's A segment,
        // each row's B segment, then w, y
        const int per_piece = PANELS ? 2 * pr + 2 : 3;
        const int n_copies = (L.srows / pr) * per_piece;
        auto copy_of = [&](int s, int q, int ci, const float*& src,
                           uint32_t& dst) -> uint32_t {
            const int k = ci / per_piece, o = ci - k * per_piece;
            if (k >= L.srows / pr) return 0;
            long long r0;
            const int nr = piece_rows(s, k, r0);
            float* d = raw + q * slot_f + k * L.blk;
            const float* op = xs;
            long long first, end;
            int sh0 = xsh;
            if (o >= per_piece - 2) {                    // w, then y
                const int v = o - (per_piece - 2);
                if (!nr) return 0;
                first = row_base + r0;
                end = first + nr;
                sh0 = v ? ysh : wsh;
                op = v ? y : w;
                d += L.wa + v * (pr + 8);
            } else if constexpr (!PANELS) {              // the piece's X
                if (!nr) return 0;
                first = (row_base + r0) * p;
                end = (row_base + r0 + nr) * p;
            } else {                                     // a row's window
                const int r = o < pr ? o : o - pr;
                const int c0 = o < pr ? win.x : win.z;
                const int cn = o < pr ? min(win.y, p - win.x) : win.w;
                if (r >= nr || cn <= 0) return 0;
                first = (row_base + r0 + r) * p + c0;
                end = first + cn;
                d += o * L.seg;
            }
            long long at;
            uint32_t bytes;
            span(first, end, sh0, at, bytes);
            src = op + at;
            dst = gram_smem_addr(d);
            return bytes;
        };
        // (warp 0) copy slot s into ring slot q: lane 0 tells the slot's
        // mbarrier how many bytes to expect, then the lanes issue the
        // copies (whole rows: at most 8 pieces, one copy a lane)
        auto issue = [&](int s, int q) {
            const uint32_t bar = bar0 + 8 * q;
            const float* src = xs;
            uint32_t dst = 0, mine = 0;
            if constexpr (!PANELS) {
                mine = copy_of(s, q, pt, src, dst);
            } else {
                for (int ci = pt; ci < n_copies; ci += 32)
                    mine += copy_of(s, q, ci, src, dst);
            }
            const uint32_t total = __reduce_add_sync(0xffffffffu, mine);
            if (pt == 0) gram_mbar_expect(bar, total);
            __syncwarp();
            if constexpr (!PANELS) {
                if (mine) gram_bulk_copy(dst, src, mine, bar);
            } else {
                for (int ci = pt; ci < n_copies; ci += 32) {
                    const uint32_t bytes = copy_of(s, q, ci, src, dst);
                    if (bytes) gram_bulk_copy(dst, src, bytes, bar);
                }
            }
        };
        // slot s (ring slot q) -> buffer `buf`: a task is one column c of
        // one piece k, its rows unrolled; whole rows: x and w x of column c
        // at once, panels: the A window's columns, then the B window's
        const int cols = PANELS ? win.y + win.w : p + 1;
        auto prepare = [&](int s, int q, int buf) {
            float* dwx = pad + buf * pad_f;
            float* dx = dwx + L.srows * L.ws;
            const int pieces = (min(L.srows, qn - s * L.srows) + pr - 1) / pr;
            for (int t = pt - 32; t < pieces * cols; t += GRAM_PREPARERS) {
                const int k = t / cols, c = t - k * cols;
                long long r0;
                const int nr = piece_rows(s, k, r0);
                const float* src = raw + q * slot_f + k * L.blk;
                const float* sw = src + L.wa + shw;
                const float* sy = src + L.wa + pr + 8 + shy;
                if constexpr (!PANELS) {
                    const float* sx = src + shx + c;
                    float* a = dwx + k * pr * L.ws + c;
                    float* b = dx + k * pr * L.xs + c;
                    if (pr == GROUP_ROWS)
                        gram_prepare_col<GROUP_ROWS>(sx, sw, sy, p, c, nr, a,
                                                     b, L.ws, L.xs);
                    else if (pr == 8)
                        gram_prepare_col<8>(sx, sw, sy, p, c, nr, a, b, L.ws,
                                            L.xs);
                    else
                        gram_prepare_col<4>(sx, sw, sy, p, c, nr, a, b, L.ws,
                                            L.xs);
                    continue;
                }
                const bool in_a = c < win.y;
                const int cc = in_a ? c : c - win.y;
                const int c0 = in_a ? win.x : win.z;
                const float* sx = src + (in_a ? 0 : pr * L.seg);
                const int sh0 = (int)(((row_base + r0) * p + c0 + xsh) & 3);
                const bool ycol = in_a && c0 + cc == p;
                float* d = in_a ? dwx + k * pr * L.ws + cc
                                : dx + k * pr * L.xs + cc;
                const int stride = in_a ? L.ws : L.xs;
                const float* pwv = in_a ? sw : nullptr;
                if (pr == GROUP_ROWS)
                    gram_prepare_panel<GROUP_ROWS>(sx, L.seg, sh0, p, cc, ycol,
                                                   pwv, sy, nr, d, stride);
                else if (pr == 8)
                    gram_prepare_panel<8>(sx, L.seg, sh0, p, cc, ycol, pwv,
                                          sy, nr, d, stride);
                else
                    gram_prepare_panel<4>(sx, L.seg, sh0, p, cc, ycol, pwv,
                                          sy, nr, d, stride);
            }
        };

        const uint32_t free0 = bar0 + 8 * GRAM_MAX_RING;
        if (pt == 0) {
            for (int q = 0; q < L.ring; ++q) {
                gram_mbar_init(bar0 + 8 * q, 1);
                gram_mbar_init(free0 + 8 * q, GRAM_PREPARERS);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        gram_bar_sync(GRAM_BAR_PROD, GRAM_PRODUCER_THREADS);
        const int ring = L.ring;
        if (pt < 32) {
            // warp 0 keeps the ring full: slot s + ring goes into ring
            // slot s % ring once every preparer is done with slot s
            for (int s = 0; s < ring && s < n_slots; ++s) issue(s, s);
            for (int s = 0; s + ring < n_slots; ++s) {
                gram_mbar_wait(free0 + 8 * (s % ring), (s / ring) & 1);
                issue(s + ring, s % ring);
            }
        } else {
            const int nbar = ncons + GRAM_PREPARERS;
            for (int s = 0; s < n_slots; ++s) {
                gram_mbar_wait(bar0 + 8 * (s % ring), (s / ring) & 1);
                if (s >= 2)                     // slot s - 2 multiplied out
                    gram_bar_sync(GRAM_BAR_EMPTY + (s & 1), nbar);
                prepare(s, s % ring, s & 1);
                gram_bar_arrive(GRAM_BAR_FULL + (s & 1), nbar);
                if (s + ring < n_slots)         // ring slot s % ring is free
                    gram_mbar_arrive(free0 + 8 * (s % ring));
            }
        }
    } else if (warp < wc) {
        // ---- consumers: the thread's item, D rows loaded ahead; its
        // columns counted from the windows' first
        const int ai = SI * item.x - win.x, bj = SJ * item.y - win.z;
        const int ws = L.ws, xst = L.xs;
        for (int s = 0; s < n_slots; ++s) {
            gram_bar_sync(GRAM_BAR_FULL + (s & 1), ncons + GRAM_PREPARERS);
            if (active) {
                const float* a = pad + (s & 1) * pad_f + ai;
                const float* b = pad + (s & 1) * pad_f + L.srows * ws + bj;
                const int rows = min(L.srows, qn - s * L.srows);
                float a0[D][SI], b0[D][SJ], a1[D][SI], b1[D][SJ];
                // rows is a multiple of 2 D, or is D (4-row slots)
                gram_load_rows<SI, SJ, D>(a, b, ws, xst, a0, b0);
                int r = 0;
                for (; r + 2 * D < rows; r += 2 * D) {
                    gram_load_rows<SI, SJ, D>(a + (r + D) * ws,
                                              b + (r + D) * xst, ws, xst,
                                              a1, b1);
                    gram_fma_rows<SI, SJ, D>(a0, b0, acc);
                    gram_load_rows<SI, SJ, D>(a + (r + 2 * D) * ws,
                                              b + (r + 2 * D) * xst, ws, xst,
                                              a0, b0);
                    gram_fma_rows<SI, SJ, D>(a1, b1, acc);
                }
                if (r + D < rows)
                    gram_load_rows<SI, SJ, D>(a + (r + D) * ws,
                                              b + (r + D) * xst, ws, xst,
                                              a1, b1);
                gram_fma_rows<SI, SJ, D>(a0, b0, acc);
                if (r + D < rows) gram_fma_rows<SI, SJ, D>(a1, b1, acc);
            }
            if (s + 2 < n_slots)                // the preparers wait for it
                gram_bar_arrive(GRAM_BAR_EMPTY + (s & 1),
                                ncons + GRAM_PREPARERS);
        }
    }
    // the partial tile of this row group: element e of consumer t at
    // part[(((task chunks + chunk) 4 + grp) SI SJ + e) ncons + t]
    if (warp < wc) {
        float* dst = part + ((((size_t)task * chunks + chunk) * GRAM_GROUPS
                              + grp) * (SI * SJ)) * ncons + tid;
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
            for (int j = 0; j < SJ; ++j)
                dst[(size_t)(i * SJ + j) * ncons] = acc[i][j];
    }
}

// The four row groups' partial tiles added in the fixed order ((g0 + g1) +
// g2) + g3 and stored: G[i][j] and G[j][i] for i <= j < P, b[j] for i = P.
// Block (chunk, task, e), a thread an item: element e of its sub-tile.
template <int SI, int SJ>
__global__ void __launch_bounds__(GRAM_MAX_CONSUMERS)
batched_gram_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ table,
                            float* __restrict__ g, float* __restrict__ bv,
                            int p, int per_cta)
{
    const int chunk = blockIdx.x, task = blockIdx.y, e = blockIdx.z;
    const int chunks = gridDim.x;
    const int tid = threadIdx.x, ncons = blockDim.x;
    if (tid >= per_cta) return;
    const int2 item = reinterpret_cast<const int2*>(table + 4 * chunks)[
        (size_t)chunk * per_cta + tid];
    if (item.x < 0) return;
    const int gi = SI * item.x + e / SJ, gj = SJ * item.y + e % SJ;
    if (gj >= p || gi > p || (gi < p && gi > gj)) return;
    const size_t grp_f = (size_t)SI * SJ * ncons;  // one group's tile
    const float* src = part + ((size_t)task * chunks + chunk)
        * GRAM_GROUPS * grp_f + (size_t)e * ncons + tid;
    float v = src[0] + src[grp_f];
    v += src[2 * grp_f];
    v += src[3 * grp_f];
    if (gi < p) {
        g[((size_t)task * p + gi) * p + gj] = v;
        g[((size_t)task * p + gj) * p + gi] = v;
    } else {
        bv[(size_t)task * p + gj] = v;
    }
}

// ---------------------------------------------------------------------------
// crossfit_gram
//
// Replaces crossfit_gram_pallas (src/repro/kernels/crossfit_gram.py, body
// _kernel).  The shared-X form: T tasks over ONE feature matrix x (N, P),
// per-task weights and targets w, y (T, N):
// G_t = X' diag(w_t) X,  b_t = X'(w_t y_t).
//
// Per task, every element is summed in batched_gram's order: 64-row steps
// in order, four groups of 16 rows each summed in order as
// fmaf(w x_i (rounded once), x_j, acc), the groups added ((g0 + g1) + g2)
// + g3.  So crossfit_gram(x, w, y) is bitwise batched_gram on x broadcast
// to (T, N, P).  The order fixes one chain per (task, element, group) over
// all of N: N is never split across blocks, and nothing is accumulated
// with atomics.  What the design chooses is which thread owns which
// chains, and how a step reaches shared memory.
//
// - Items.  A thread owns one SUB x SUB sub-tile of a 32x32 tile pair (ti
//   <= tj) of G for TT tasks and one row group: (SUB, TT) is (4, 2), (4, 4),
//   (2, 2) or (2, 1).
//   Only the sub-tiles that meet [0, P)^2 and, on a diagonal pair, the
//   upper triangle are items (15 of 64 at the paper's P 18 with SUB 4).  A
//   block is 4 groups of `slots` threads (32 or 64); a group's slots hold
//   (item, task pack) pairs densely: `packs` packs of TT tasks each when a
//   pair's items fit the slots, else `chunks` blocks share the pair's
//   items.  The launch plan (SUB, TT, slots, packs, chunks, ring, m) comes
//   from kernels/crossfit_gram.py::launch_plan, which picks it from T, N
//   and P with a model of the card checked against every plan's time
//   (scripts/bench_crossfit_plans.py).
// - A ring of `ring` slots (2 to 8) of m (2 or 4) 64-row steps each in
//   shared memory, filled by cp.async, so a slot costs its FMAs and one barrier,
//   not a load latency: slot i + ring - 1 is in flight while slot i is
//   multiplied out.  At P <= 32 (a SPAN instance) a row's P floats go to a
//   row of 32, in the widest copies (16, 8 or 4 bytes) that x's address
//   and 4 P allow.  Above, each row's 32 columns of a tile are copied as
//   the 9 aligned 16-byte chunks around them (row r at 36 r plus its
//   shift, (r P + x's first float) mod 4).  A task's w and y of a slot are
//   the aligned 16-byte chunks around its 64 m values.  The chunks are
//   aligned to the operands' addresses (a view may start anywhere on a
//   float; the aligned chunk around its first values lies in its storage)
//   and zero-fill what lies past a row, past N or past T, so any N, P and
//   alignment is taken.  Copies of 4 bytes, one a value, cost about a
//   microsecond a step (PERF.md).
// - The row stride is a constant of the instance and a tile's shift has
//   four phases taken once, so every offset in the 16-row loop is an
//   immediate; reads are float4 (a span; a tile at shift 0), float2 (a
//   tile at even shifts) or one float at a time.  The b products (the
//   diagonal pairs' sub-tiles of row 0) are a second pass over the rows,
//   so the main loop has no branch.
// - Registers: at most 16 accumulators of G a thread under
//   __launch_bounds__(256, 2), so that two 256-thread blocks fit an SM;
//   the instances with 32 or 64 (SUB 4, TT 2 or 4: the paper's T 1000
//   and wide P, where a block's slab from L2 has to serve more tasks) run
//   one block an SM.
//
// Bound on an H100: at the paper's (T 1000, N 5099, P 18) the function
// moves 42.5 MB and does 2.0 GFLOP: 0.030 ms at the 67 TFLOP/s plain
// float32 rate.  Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// 0.133 ms there (the earlier kernel, one-step register prefetch and four
// tasks a thread at 186 registers: 0.245; the einsum pair 0.156), 0.062
// ms at the opaque drain's T = 1 (0.0868; einsum 0.027: a lane's 367 KB
// of X passes through one SM's copies, and the same warps compute), 1.10
// ms at (32, 65536, 33) (2.97; K1 on the broadcast tensor 1.08), 6.2 ms at
// (40, 60000, 201) (7.31).
//
// Only the upper triangle is computed; every stored G[i][j], i <= j, is
// written to both [i][j] and [j][i], so G is exactly symmetric.
// ---------------------------------------------------------------------------
constexpr int XF_MAX_THREADS = 256;
constexpr int XF_XR = 36;                   // a staged tile row: 9 chunks
constexpr int XF_MAX_RING = 8;
constexpr int XF_MAX_M = 8;                 // 64-row steps a ring slot
constexpr int XF_SMEM_MAX = 232448;         // an H100 block's shared memory

__device__ __forceinline__ uint32_t xf_smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// `size` (4, 8 or 16) bytes global -> shared, of which the first `bytes`
// are read and the rest zero-filled
__device__ __forceinline__ void xf_cp_async(uint32_t dst, const void* src,
                                            int size, int bytes)
{
    if (size == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(bytes));
    else if (size == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(dst), "l"(src), "r"(bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void xf_cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void xf_cp_async_wait(int pending)
{
    switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
    }
}

// bytes of a 16-byte chunk at float index `at` that lie before `end`
__device__ __forceinline__ int xf_chunk_bytes(long long at, long long end)
{
    const long long left = end - at;
    return left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0);
}

// The items of tile pair (ti, tj) at sub-tile edge `sub`: sub-rows sy <
// sy_n and sub-columns sx < sx_n that meet [0, P), and sx >= sy on a
// diagonal pair (kernels/crossfit_gram.py::subtiles is the same count).
__host__ __device__ inline int xfit_subtiles(int ti, int tj, int p, int sub,
                                             int& sy_n, int& sx_n)
{
    const int edge = TILE / sub;
    const int rows = (p - ti * TILE + sub - 1) / sub;
    const int cols = (p - tj * TILE + sub - 1) / sub;
    sy_n = rows < edge ? rows : edge;
    sx_n = cols < edge ? cols : edge;
    return ti == tj ? sy_n * (sy_n + 1) / 2 : sy_n * sx_n;
}

// A ring slot holds m steps of 64 rows: the X slab (P <= 32: the rows at a
// stride of 32; above: two tiles of rows of XF_XR), then w and y of the
// block's tasks (64 m values and a chunk for the shift)
__host__ __device__ inline int xfit_x_floats(int p, int m)
{
    return (p <= TILE ? TILE : 2 * XF_XR) * GRAM_ROWS * m;
}
__host__ __device__ inline int xfit_w_stride(int m)
{
    return GRAM_ROWS * m + 4;
}
__host__ __device__ inline int xfit_stage_floats(int p, int tasks, int m)
{
    return xfit_x_floats(p, m) + 2 * tasks * xfit_w_stride(m);
}

template <int SUB, int VEC>
__device__ __forceinline__ void xfit_load(const float* s, float (&v)[SUB])
{
    if constexpr (VEC == 4 && SUB == 4) {
        const float4 t = *reinterpret_cast<const float4*>(s);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (VEC >= 2) {
#pragma unroll
        for (int i = 0; i < SUB; i += 2) {
            const float2 t = *reinterpret_cast<const float2*>(s + i);
            v[i] = t.x; v[i + 1] = t.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < SUB; ++i) v[i] = s[i];
    }
}

// Multiplies out 16 rows, in order, of a ring slot: rows r0 .. r0 + 15
// (one row group of one 64-row step) into the SUB x SUB tiles of the
// thread's TT tasks.  Row r of the A (B) tile is read at sA + xoff(r)
// (sB + xoff(r)), already offset by the thread's sub-tile: xoff(r) = 32 r
// in a span (SPAN), else 36 r + ((r P + xsh) & 3), whose four phases are
// taken once.  Task t's w is at sw[w_off[t] + r], its y at sw[y_off[t] +
// r].  Every offset within the 16 rows is then a constant.
template <int SUB, int TT, int VEC, bool SPAN>
__device__ __forceinline__ void xfit_rows(
    const float* sA, const float* sB, const float* sw, const int (&w_off)[TT],
    const int (&y_off)[TT], int r0, int p, int xsh, bool does_b,
    float (&acc)[TT][SUB][SUB], float (&bacc)[TT][SUB])
{
    constexpr int XS = SPAN ? TILE : XF_XR;
    int sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        sh[j] = SPAN ? 0 : (((r0 + j) * p + xsh) & 3);
    const float* a0 = sA + r0 * XS;
    const float* b0 = sB + r0 * XS;
    const float* w0 = sw + r0;
    // the rows' operands are loaded AHEAD rows at a time before they are
    // multiplied out, so that one warp has many loads in flight (the
    // opaque drain's T = 1 lanes run one warp a scheduler)
    constexpr int AHEAD = (2 * SUB + TT) * GROUP_ROWS <= 96 ? GROUP_ROWS : 4;
#pragma unroll
    for (int k0 = 0; k0 < GROUP_ROWS; k0 += AHEAD) {
        float a[AHEAD][SUB], b[AHEAD][SUB], wk[AHEAD][TT];
#pragma unroll
        for (int kk = 0; kk < AHEAD; ++kk) {
            const int off = (k0 + kk) * XS + sh[(k0 + kk) & 3];
            xfit_load<SUB, VEC>(a0 + off, a[kk]);
            xfit_load<SUB, VEC>(b0 + off, b[kk]);
#pragma unroll
            for (int t = 0; t < TT; ++t) wk[kk][t] = w0[w_off[t] + k0 + kk];
        }
#pragma unroll
        for (int kk = 0; kk < AHEAD; ++kk)
#pragma unroll
            for (int t = 0; t < TT; ++t)
#pragma unroll
                for (int i = 0; i < SUB; ++i) {
                    const float ai = wk[kk][t] * a[kk][i];
#pragma unroll
                    for (int j = 0; j < SUB; ++j)
                        acc[t][i][j] = fmaf(ai, b[kk][j], acc[t][i][j]);
                }
    }
    if (does_b) {
#pragma unroll
        for (int kk = 0; kk < GROUP_ROWS; ++kk) {
            float b[SUB];
            xfit_load<SUB, VEC>(b0 + kk * XS + sh[kk & 3], b);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
                const float wy = w0[w_off[t] + kk] * w0[y_off[t] + kk];
#pragma unroll
                for (int j = 0; j < SUB; ++j)
                    bacc[t][j] = fmaf(b[j], wy, bacc[t][j]);
            }
        }
    }
}

template <int SUB, int TT, bool SPAN>
__global__ void __launch_bounds__(XF_MAX_THREADS, SUB * SUB * TT >= 32 ? 1 : 2)
crossfit_gram_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ y, float* __restrict__ g,
                     float* __restrict__ bv, int t_total, int n, int p,
                     int n_tiles, int slots, int packs, int chunks, int ring,
                     int m)
{
    constexpr int SUB2 = SUB * SUB;
    extern __shared__ __align__(16) float xf_smem[];
    const int tasks = packs * TT;               // tasks a block
    constexpr bool span = SPAN;                 // P <= 32
    constexpr int xs = SPAN ? TILE : XF_XR;     // row stride of the slab
    const int x_floats = xfit_x_floats(p, m);
    const int ws = xfit_w_stride(m);
    const int stage_floats = xfit_stage_floats(p, tasks, m);
    const int rows = GRAM_ROWS * m;             // rows a ring slot

    // blockIdx.y walks the upper triangle of tile pairs row by row
    int tp = blockIdx.y, ti = 0;
    for (int len = n_tiles; tp >= len; --len) { tp -= len; ++ti; }
    const int tj = ti + tp;
    const bool diag = ti == tj;
    int sy_n, sx_n;
    const int n_sub = xfit_subtiles(ti, tj, p, SUB, sy_n, sx_n);
    const int per_block = slots / packs;        // items a block
    const int chunk = blockIdx.x % chunks;
    const int task0 = (blockIdx.x / chunks) * tasks;
    if (chunk * per_block >= n_sub) return;     // a chunk past this pair's

    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int n_slots = (n + rows - 1) / rows;
    // Chunks are aligned to the operands' addresses: an operand that is a
    // view may start anywhere on a float, and the aligned chunk around its
    // first values lies in its storage (which starts 16-byte aligned).
    // xsh, wsh, ysh: each operand's first float mod 4
    const int xsh = (int)(((uintptr_t)x >> 2) & 3);
    const int wsh = (int)(((uintptr_t)w >> 2) & 3);
    const int ysh = (int)(((uintptr_t)y >> 2) & 3);
    // copy size of a span row: the largest of 16, 8, 4 bytes that divides
    // both x's address and a row's 4 P bytes
    const int align = (int)((uintptr_t)x & 15) | (4 * p & 15);
    const int gran = (align & 7) ? 4 : ((align & 15) ? 8 : 16);
    const int cpr = 4 * p / gran;               // copies a span row
    const int wpr = ws / 4;                     // chunks a task's w row

    auto issue = [&](int slot_i, int stage) {
        float* st = xf_smem + stage * stage_floats;
        const int n0 = slot_i * rows;
        if (span) {
            // row r: cpr copies of gran bytes to st + r xs; (r, c) walked
            // without a division
            int r = tid / cpr, c = tid - r * cpr;
            const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
            for (; r < rows;) {
                const int row = n0 + r;
                const bool ok = row < n;
                const int f = c * (gran / 4);
                xf_cp_async(xf_smem_addr(st + r * xs + f),
                            x + (ok ? (long long)row * p + f : 0), gran,
                            ok ? gran : 0);
                r += dr;
                c += dc;
                if (c >= cpr) { c -= cpr; ++r; }
            }
        } else {
            // each row's tile columns as the 9 aligned chunks around them
            for (int half = 0; half < (diag ? 1 : 2); ++half) {
                const int tile = half ? tj : ti;
                float* dst = st + half * rows * XF_XR;
                for (int idx = tid; idx < rows * 9; idx += nthreads) {
                    const int r = idx / 9, c = idx - r * 9;
                    const int row = n0 + r;
                    const long long seg = (long long)row * p + tile * TILE;
                    const long long end = (long long)row * p
                        + min(p, tile * TILE + TILE);
                    const long long at = ((seg + xsh) & ~3LL) - xsh + 4 * c;
                    const int bytes = row < n ? xf_chunk_bytes(at, end) : 0;
                    xf_cp_async(xf_smem_addr(dst + r * XF_XR + 4 * c),
                                x + (bytes ? at : 0), 16, bytes);
                }
            }
        }
        // w and y: the aligned chunks around each task's values
        float* dw = st + x_floats;
        int tl = tid / wpr, c = tid - tl * wpr;
        const int dt = nthreads / wpr, dc = nthreads - dt * wpr;
        for (; tl < tasks;) {
            const int task = task0 + tl;
            const long long row0 = (long long)task * n;
            const long long aw = ((row0 + n0 + wsh) & ~3LL) - wsh + 4 * c;
            const long long ay = ((row0 + n0 + ysh) & ~3LL) - ysh + 4 * c;
            const bool live = task < t_total;
            const int bw = live ? xf_chunk_bytes(aw, row0 + n) : 0;
            const int by = live ? xf_chunk_bytes(ay, row0 + n) : 0;
            float* d = dw + tl * ws + 4 * c;
            xf_cp_async(xf_smem_addr(d), w + (bw ? aw : 0), 16, bw);
            xf_cp_async(xf_smem_addr(d + tasks * ws), y + (by ? ay : 0), 16,
                        by);
            tl += dt;
            c += dc;
            if (c >= wpr) { c -= wpr; ++tl; }
        }
    };

    // compute role: group grp, slot = (item li, task pack q)
    const int grp = tid / slots;
    const int slot = tid - grp * slots;
    const int li = slot / packs, q = slot - li * packs;
    int u = chunk * per_block + li;
    const int tq = task0 + q * TT;              // the pack's first task
    const bool active = li < per_block && u < n_sub && tq < t_total;
    int sy = 0;
    if (diag) {
        for (int len = sy_n; u >= len && len > 0; --len) { u -= len; ++sy; }
    } else {
        sy = u / sx_n;
        u -= sy * sx_n;
    }
    const int sx = diag ? sy + u : u;
    const bool does_b = active && diag && sy == 0;
    // where this thread reads a ring slot: X row r at r xs (+ (r P + xsh)
    // mod 4 in a tile, whose rows start at an aligned chunk) and column
    // SUB sy (SUB sx) of its tiles; task t's w and y at their shifts within
    // the chunks (slots start at multiples of 64 rows, so a shift is
    // (task N + the operand's own shift) mod 4)
    const int a_off = SUB * sy;
    const int b_off = SUB * sx + (diag || span ? 0 : rows * XF_XR);
    int w_off[TT], y_off[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
        const long long row0 = (long long)(tq + t) * n;
        w_off[t] = (q * TT + t) * ws + (int)((row0 + wsh) & 3);
        y_off[t] = (tasks + q * TT + t) * ws + (int)((row0 + ysh) & 3);
    }
    // reads of a row: a span's rows are 16-byte aligned; a tile's are when
    // its shift is always 0 (P % 4 == 0 and x aligned), even when P and x's
    // shift are even
    const int vec = SPAN || ((p | xsh) & 3) == 0 ? 4
        : (((p | xsh) & 1) == 0 ? 2 : 1);

    float acc[TT][SUB][SUB];
    float bacc[TT][SUB];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
            bacc[t][i] = 0.f;
#pragma unroll
            for (int j = 0; j < SUB; ++j) acc[t][i][j] = 0.f;
        }

    for (int s = 0; s < ring - 1; ++s) {
        if (s < n_slots) issue(s, s);
        xf_cp_async_commit();                   // possibly empty: uniform
    }
    for (int i = 0; i < n_slots; ++i) {
        xf_cp_async_wait(ring - 2);             // slot i has landed here
        __syncthreads();                        // ... everywhere; slot i-1
                                                // is multiplied out
        const int next = i + ring - 1;
        if (next < n_slots) issue(next, next % ring);
        xf_cp_async_commit();
        if (active) {
            const float* st = xf_smem + (i % ring) * stage_floats;
            const float* sw = st + x_floats;
            const int steps = min(m, (n - i * rows + GRAM_ROWS - 1)
                                     / GRAM_ROWS);
            for (int s = 0; s < steps; ++s) {
                const int r0 = s * GRAM_ROWS + grp * GROUP_ROWS;
                if (SPAN || vec == 4)
                    xfit_rows<SUB, TT, 4, SPAN>(st + a_off, st + b_off, sw,
                                                w_off, y_off, r0, p, xsh,
                                                does_b, acc, bacc);
                else if (vec == 2)
                    xfit_rows<SUB, TT, (SPAN ? 4 : 2), SPAN>(st + a_off, st + b_off, sw,
                                                w_off, y_off, r0, p, xsh,
                                                does_b, acc, bacc);
                else
                    xfit_rows<SUB, TT, (SPAN ? 4 : 1), SPAN>(st + a_off, st + b_off, sw,
                                                w_off, y_off, r0, p, xsh,
                                                does_b, acc, bacc);
            }
        }
    }
    xf_cp_async_wait(0);
    __syncthreads();

    // per task: add the four groups' partial tiles in batched_gram's order
    // (the same slot holds the same item in every group), through the ring
    float* red = xf_smem;                           // [3][slots][SUB2]
    float* bred = red + 3 * slots * SUB2;           // [3][slots][SUB]
#pragma unroll
    for (int t = 0; t < TT; ++t) {
        if (active && grp > 0) {
            float* r = red + ((grp - 1) * slots + slot) * SUB2;
#pragma unroll
            for (int i = 0; i < SUB; ++i)
#pragma unroll
                for (int j = 0; j < SUB; ++j) r[i * SUB + j] = acc[t][i][j];
            if (does_b) {
#pragma unroll
                for (int j = 0; j < SUB; ++j)
                    bred[((grp - 1) * slots + slot) * SUB + j] = bacc[t][j];
            }
        }
        __syncthreads();
        const int task = tq + t;
        if (active && grp == 0 && task < t_total) {
            float* gb = g + (size_t)task * p * p;
#pragma unroll
            for (int i = 0; i < SUB; ++i) {
#pragma unroll
                for (int j = 0; j < SUB; ++j) {
                    float v = acc[t][i][j];
#pragma unroll
                    for (int r = 0; r < GRAM_GROUPS - 1; ++r)
                        v += red[(r * slots + slot) * SUB2 + i * SUB + j];
                    const int gi = ti * TILE + SUB * sy + i;
                    const int gj = tj * TILE + SUB * sx + j;
                    if (gi < p && gj < p && (!diag || gi <= gj)) {
                        gb[(size_t)gi * p + gj] = v;
                        gb[(size_t)gj * p + gi] = v;
                    }
                }
            }
            if (does_b) {
                float* bb = bv + (size_t)task * p;
#pragma unroll
                for (int j = 0; j < SUB; ++j) {
                    float v = bacc[t][j];
#pragma unroll
                    for (int r = 0; r < GRAM_GROUPS - 1; ++r)
                        v += bred[(r * slots + slot) * SUB + j];
                    const int gj = tj * TILE + SUB * sx + j;
                    if (gj < p) bb[gj] = v;
                }
            }
        }
        __syncthreads();
    }
}

// launch one instance; dynamic shared memory above 48 KB is opted in once
template <int SUB, int TT, bool SPAN>
cudaError_t launch_xfit(const void* x, const void* w, const void* y, void* g,
                        void* bv, int t, int n, int p, int n_tiles,
                        int slots, int packs, int chunks, int ring, int m,
                        size_t smem, cudaStream_t stream)
{
    static size_t granted = 0;
    if (smem > 48 * 1024 && smem > granted) {
        const cudaError_t err = cudaFuncSetAttribute(
            crossfit_gram_kernel<SUB, TT, SPAN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        granted = smem;
    }
    const int tasks = packs * TT;
    const dim3 grid(chunks * ((t + tasks - 1) / tasks),
                    n_tiles * (n_tiles + 1) / 2);
    crossfit_gram_kernel<SUB, TT, SPAN><<<grid, 4 * slots, smem, stream>>>(
        (const float*)x, (const float*)w, (const float*)y, (float*)g,
        (float*)bv, t, n, p, n_tiles, slots, packs, chunks, ring, m);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// batched_predict
//
// Replaces batched_predict_pallas (src/repro/kernels/megabatch.py, body
// _predict_kernel): out_b = valid_b * (X_b beta_b).
//
// Bound on an H100: it reads B N P floats of X once and does 2 operations
// per 4 bytes, so it is bound by bytes: 0.00683 ms at the paper path's
// (32, 5104, 33) (21.6 MB at 3.35 TB/s).  The version it replaces (one
// warp per row reading X from device memory, one row's load in flight per
// warp) took 0.0317 ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: the rows a block takes of one task are one contiguous span of X,
// about PRED_SPAN floats.  The block stages the span into shared memory
// with 16-byte loads, PRED_UNROLL in flight per thread, after a scalar head
// that brings the address to a 16-byte boundary and before a scalar tail
// (P is odd on the paper path, and any B, N, P is taken).  Each row then
// gets a group of G consecutive threads, G chosen from P alone
// (pred_layout: 4 at P 33, 32 at P 257): thread j of a group sums columns
// j, j + G, ... in order, and the group adds its G partial sums with a
// fixed xor-shuffle tree.  So every output element has one accumulation
// order that depends on P alone, and no sequential chain is longer than
// 16 terms while P <= 512 (8 threads a row, 33 terms each, came out
// 1.5e-5 off the plain version at (8, 60000, 257) on the card, over its
// 1e-5 tolerance; at G = 32 the order is the one-warp-a-row version's).
// Rows sit in shared memory at a stride of G times an odd number, so the
// rows a warp reads fall in distinct banks.  The product with `valid`
// comes last, as in the reference kernel, so a zero padding row of a page
// yields an exact 0.
// ---------------------------------------------------------------------------
constexpr int PRED_THREADS = 256;
constexpr int PRED_UNROLL = 4;
constexpr int PRED_COLS = 16;               // most columns a thread sums
constexpr int PRED_SPAN = 8192;             // floats of X a block stages
constexpr int PRED_SMEM_MAX = 232448;       // an H100 block's shared memory

struct PredLayout {
    int g;          // threads a row, a power of two <= 32
    int rows;       // rows a block
    int stride;     // row stride in shared memory: g times an odd number
    int threads;    // threads a block
};

inline size_t pred_smem_bytes(int rows, int stride, int p)
{
    return sizeof(float) * ((size_t)rows * stride + p);
}

// G: the least power of two (at most 32) that leaves each thread at most
// PRED_COLS columns.  Rows: a whole number of passes of PRED_THREADS / G
// rows, as many as bring the staged span near `span` floats; fewer while
// the block's shared memory would pass PRED_SMEM_MAX, down to one row of
// one warp (the wrapper bounds P)
inline PredLayout pred_layout(int p, int span)
{
    PredLayout lay;
    lay.g = 1;
    while (lay.g < 32 && (long long)lay.g * PRED_COLS < p) lay.g *= 2;
    lay.stride = ((p + lay.g - 1) / lay.g) * lay.g;
    if ((lay.stride / lay.g) % 2 == 0) lay.stride += lay.g;
    const int pass = PRED_THREADS / lay.g;
    const long long reps = (long long)span / ((long long)pass * lay.stride);
    lay.rows = pass * (int)(reps > 1 ? reps : 1);
    while (lay.rows * lay.g > 32
           && pred_smem_bytes(lay.rows, lay.stride, p) > PRED_SMEM_MAX)
        lay.rows = lay.rows > pass ? lay.rows - pass : lay.rows / 2;
    lay.threads = lay.rows < pass ? lay.rows * lay.g : PRED_THREADS;
    return lay;
}

__global__ void __launch_bounds__(PRED_THREADS)
batched_predict_kernel(const float* __restrict__ xs,
                       const float* __restrict__ beta,
                       const float* __restrict__ valid,
                       float* __restrict__ out, int n, int p, int g,
                       int rows, int stride)
{
    extern __shared__ float pred_smem[];
    float* sx = pred_smem;                  // rows x stride
    float* sb = sx + rows * stride;         // beta_b
    const int task = blockIdx.y;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int row0 = blockIdx.x * rows;
    const int nr = min(rows, n - row0);
    const long long lin0 = (long long)task * n + row0;
    const float* src = xs + lin0 * p;
    const int len = nr * p;
    const float inv_p = 1.f / (float)p;

    for (int c = tid; c < p; c += nthreads)
        sb[c] = beta[(long long)task * p + c];

    // span element e -> sx[row * stride + col], row = e / p (a float
    // estimate, corrected by one step: e < 2^24)
    auto row_col = [&](int e, int& r, int& c) {
        r = __float2int_rz((float)e * inv_p);
        c = e - r * p;
        if (c < 0) { --r; c += p; }
        else if (c >= p) { ++r; c -= p; }
    };
    const int head = min(len, (int)((16 - ((uintptr_t)src & 15)) & 15) >> 2);
    const int n4 = (len - head) >> 2;
    const int tail = head + 4 * n4;
    for (int e = tid; e < head; e += nthreads) {
        int r, c;
        row_col(e, r, c);
        sx[r * stride + c] = src[e];
    }
    for (int e = tail + tid; e < len; e += nthreads) {
        int r, c;
        row_col(e, r, c);
        sx[r * stride + c] = src[e];
    }
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    for (int i0 = tid; i0 < n4; i0 += PRED_UNROLL * nthreads) {
        float4 val[PRED_UNROLL];
#pragma unroll
        for (int u = 0; u < PRED_UNROLL; ++u) {
            const int i = i0 + u * nthreads;
            if (i < n4) val[u] = __ldg(src4 + i);
        }
#pragma unroll
        for (int u = 0; u < PRED_UNROLL; ++u) {
            const int i = i0 + u * nthreads;
            if (i >= n4) break;
            int r, c;
            row_col(head + 4 * i, r, c);
            const float f[4] = {val[u].x, val[u].y, val[u].z, val[u].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                sx[r * stride + c] = f[t];
                if (++c == p) { c = 0; ++r; }
            }
        }
    }
    __syncthreads();

    // rows is a whole number of passes of nthreads / g, so every thread
    // of a warp takes the loop (and its shuffles) equally often
    const int j = tid % g;
    for (int rr = tid / g; rr < rows; rr += nthreads / g) {
        float s = 0.f;
        if (rr < nr) {
            const float* xr = sx + rr * stride;
            for (int c = j; c < p; c += g) s = fmaf(xr[c], sb[c], s);
        }
        for (int off = g >> 1; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (j == 0 && rr < nr)
            out[lin0 + rr] = s * valid[lin0 + rr];
    }
}

// launch one instance and its combine; dynamic shared memory above 48 KB
// is opted in once
template <int SI, int SJ, bool PANELS>
cudaError_t launch_gram(const void* xs, const void* w, const void* y, void* g,
                        void* bv, void* part, const int* table, int b, int n,
                        int p, int chunks, const GramLayout& lay, size_t smem,
                        cudaStream_t stream)
{
    static size_t granted = 0;
    if (smem > 48 * 1024 && smem > granted) {
        const cudaError_t err = cudaFuncSetAttribute(
            batched_gram_kernel<SI, SJ, PANELS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        granted = smem;
    }
    const int wc = (lay.per_cta + 31) / 32;
    batched_gram_kernel<SI, SJ, PANELS><<<dim3(GRAM_GROUPS * chunks, b),
                                  32 * gram_warps(wc), smem, stream>>>(
        (const float*)xs, (const float*)w, (const float*)y, (float*)part,
        table, n, p, lay);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    batched_gram_combine_kernel<SI, SJ><<<dim3(chunks, b, SI * SJ), 32 * wc,
                                          0, stream>>>(
        (const float*)part, table, (float*)g, (float*)bv, p, lay.per_cta);
    return cudaGetLastError();
}

}  // namespace

// The launch plan comes from kernels/megabatch.py::gram_launch_plan: the
// (si, sj) instance, `chunks` blocks a row group, the block's shared
// memory and `layout`, GRAM_LAYOUT_INTS ints in GramLayout's order.
// `table` (on the card) holds per chunk its windows (a0, na, b0, nb), then
// per chunk per_cta items (it, jt), it < 0 for none.  `part` is the
// wrapper's scratch of B chunks 4 SI SJ 32 ceil(per_cta / 32) floats: the
// row groups' partial tiles, added by the second launch.  A plan this file
// has no instance of, or whose buffers overlap or do not fit a block's
// shared memory, is refused.  batched_gram_blocked launches this on its
// merged (B, C Nc, P) rows.
extern "C" int repro_batched_gram(const void* xs, const void* w,
                                  const void* y, void* g, void* bv,
                                  void* part, const void* table, int b, int n,
                                  int p, int si, int sj, int chunks,
                                  int smem_bytes, const void* layout,
                                  void* stream)
{
    const int* l = (const int*)layout;
    const GramLayout L{l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7], l[8],
                       l[9], l[10]};
    // the instances: (4, 2), (4, 4), (8, 8) on whole rows, (8, 8) on panels
    const bool tile = (si == 4 && sj == 2 && !L.seg)
        || (si == 4 && sj == 4 && !L.seg) || (si == 8 && sj == 8);
    const bool piece = (L.pr == 4 || L.pr == 8 || L.pr == GROUP_ROWS)
        && L.srows % L.pr == 0 && L.srows <= GRAM_MAX_SROWS;
    // 16-byte aligned pieces, rows and copies
    const bool aligned = L.ws % (si > 4 ? si : 4) == 0
        && L.xs % (sj > 4 ? sj : 4) == 0 && L.blk % 4 == 0 && L.wa % 4 == 0
        && L.seg % 4 == 0 && L.pad_at % 4 == 0 && L.bar_at % 4 == 0;
    const long long ring_f = (long long)L.ring * (L.srows / L.pr) * L.blk;
    const long long pad_f = 2LL * L.srows * (L.ws + L.xs);
    const bool fits = L.wa + 2LL * L.pr + 16 <= L.blk && ring_f <= L.pad_at
        && L.pad_at + pad_f <= L.bar_at
        && 4LL * (L.bar_at + GRAM_BAR_FLOATS) <= smem_bytes
        && smem_bytes <= GRAM_SMEM_MAX;
    if (!tile || !piece || !aligned || !fits || L.per_cta < 1
        || L.per_cta > GRAM_MAX_CONSUMERS || chunks < 1 || L.ring < 2
        || L.ring > GRAM_MAX_RING || L.seg < 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)smem_bytes;
    const cudaStream_t st = (cudaStream_t)stream;
    const int* tab = (const int*)table;
#define GRAM_CASE(a, c, panels)                                           \
    if (si == a && sj == c && (L.seg > 0) == panels)                      \
        return (int)launch_gram<a, c, panels>(xs, w, y, g, bv, part, tab, \
                                              b, n, p, chunks, L, smem, st)
    GRAM_CASE(4, 2, false); GRAM_CASE(4, 4, false); GRAM_CASE(8, 8, false);
    GRAM_CASE(8, 8, true);
#undef GRAM_CASE
    return (int)cudaErrorInvalidValue;
}

// The launch plan (sub, tt, slots, packs, chunks, ring, m) comes from
// kernels/crossfit_gram.py::launch_plan; a plan this file has no instance
// of, or whose ring does not fit a block's shared memory, is refused
extern "C" int repro_crossfit_gram(const void* x, const void* w,
                                   const void* y, void* g, void* bv,
                                   int t, int n, int p, int sub, int tt,
                                   int slots, int packs, int chunks,
                                   int ring, int m, void* stream)
{
    if ((slots != 32 && slots != 64) || packs < 1 || packs > slots
        || chunks < 1 || ring < 2 || ring > XF_MAX_RING || m < 1
        || m > XF_MAX_M)
        return (int)cudaErrorInvalidValue;
    const int n_tiles = (p + TILE - 1) / TILE;
    const size_t smem = sizeof(float) * (size_t)ring
        * xfit_stage_floats(p, packs * tt, m);
    // the ring also holds the partial tiles of groups 1..3 at the end
    const size_t red = sizeof(float) * 3 * (size_t)slots * (sub * sub + sub);
    if (smem > (size_t)XF_SMEM_MAX || smem < red)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define XF_CASE(s, k)                                                     \
    if (sub == s && tt == k)                                              \
        return (int)(p <= TILE                                            \
            ? launch_xfit<s, k, true>(x, w, y, g, bv, t, n, p, n_tiles,   \
                                      slots, packs, chunks, ring, m,      \
                                      smem, st)                           \
            : launch_xfit<s, k, false>(x, w, y, g, bv, t, n, p, n_tiles,  \
                                       slots, packs, chunks, ring, m,     \
                                       smem, st))
    XF_CASE(4, 2); XF_CASE(4, 4); XF_CASE(2, 1); XF_CASE(2, 2);
#undef XF_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" int repro_batched_predict(const void* xs, const void* beta,
                                     const void* valid, void* out,
                                     int b, int n, int p, void* stream)
{
    static size_t granted = 0;
    const PredLayout lay = pred_layout(p, PRED_SPAN);
    const size_t smem = pred_smem_bytes(lay.rows, lay.stride, p);
    if (smem > (size_t)PRED_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024 && smem > granted) {
        const cudaError_t err = cudaFuncSetAttribute(
            batched_predict_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        granted = smem;
    }
    const dim3 grid((n + lay.rows - 1) / lay.rows, b);
    batched_predict_kernel<<<grid, lay.threads, smem,
                             (cudaStream_t)stream>>>(
        (const float*)xs, (const float*)beta, (const float*)valid,
        (float*)out, n, p, lay.g, lay.rows, lay.stride);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
