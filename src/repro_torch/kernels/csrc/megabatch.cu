// Hopper (sm_90a) kernels for the megabatch cross-fit programs.
//
// Built by kernels/build.py with nvcc into a shared library with a plain C
// interface and loaded with ctypes; no PyTorch header is included.  Every
// entry point launches on the stream it is given, allocates nothing, does
// not synchronise and returns cudaGetLastError().
//
//   repro_batched_gram     per-task masked normal equations
//                          G_b = X_b' diag(w_b) X_b,  b_b = X_b'(w_b * y_b)
//   repro_batched_gram_blocked
//                          the same over N streamed as C chunks of Nc rows
//   repro_crossfit_gram    the same for T tasks over one shared X (N, P)
//                          G_t = X' diag(w_t) X,  b_t = X'(w_t * y_t)
//   repro_batched_predict  masked GEMV epilogue
//                          out_b = valid_b * (X_b beta_b)
//
// Inputs are contiguous float32 at their true (B, N, P), (B, C, Nc, P) or
// (N, P) with (T, N):
// any P, any N or Nc, the ragged edges are masked here.  Plain FMA in
// float32 — no TF32, no tensor cores — and one fixed accumulation order per
// output element, so a result does not depend on the launch's batch size or
// on the other lanes.  batched_gram and batched_gram_blocked stage a step
// through registers; crossfit_gram keeps a ring of steps in flight with
// cp.async, its launch plan chosen in Python (kernels/crossfit_gram.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// batched_gram
//
// One thread block per (task b, 32x32 output tile (ti, tj) with ti <= tj).
// The block walks N in steps of GRAM_ROWS rows staged through shared memory
// as  sA = x[:, ti-tile],  sB = x[:, tj-tile],  sW = w,  sWY = w * y.  On a
// diagonal tile the two slabs are the same columns and only sA is staged.
// The N loop lives inside the block: N is never split across blocks and
// nothing is accumulated with atomics.
//
// The 256 threads form four groups of 64.  Group g multiplies out rows
// [16 g, 16 g + 16) of every step; each of its 8x8 threads keeps a 4x4
// register tile of the float32 sum, fed per row by two 16-byte
// shared-memory loads and the row's weight: 4 multiplies (w * x_i, rounded
// once) and 16 FMAs.  After the last step the four partial tiles are added
// in the fixed order ((g0 + g1) + g2) + g3.  So every output element has
// one fixed accumulation order, whatever the launch's batch size.
//
// The block is bound by its load/store pipe, so the design issues few
// loads and stores: w and y of a step are loaded once (by 64 threads),
// not once per thread, and nothing is loaded twice.  The next step's rows
// are fetched into registers while the current step is multiplied out of
// shared memory; the fetch reads from clamped addresses, without a branch
// and without using a loaded value, so all its loads are in flight
// together, and the ragged edges are masked at the store into shared
// memory.
//
// Only the upper triangle of tiles is computed; every element G[i][j] with
// i <= j is computed once and stored to both [i][j] and [j][i], so G comes
// out exactly symmetric.  The diagonal tiles also produce b[ti-tile].
// ---------------------------------------------------------------------------
constexpr int TILE = 32;            // output tile edge
constexpr int GRAM_ROWS = 64;       // rows of N staged per step
constexpr int GRAM_THREADS = 256;
constexpr int GRAM_GROUPS = 4;      // thread groups splitting a step's rows
constexpr int GROUP_ROWS = GRAM_ROWS / GRAM_GROUPS;
constexpr int STAGE = GRAM_ROWS * TILE / GRAM_THREADS;   // values per thread
constexpr int STAGE_STRIDE = GRAM_THREADS / TILE;        // 8 rows apart

struct GramStage {
    float xa[STAGE], xb[STAGE];
    float w, y;                     // threads 0..GRAM_ROWS-1: one row each
};

__device__ __forceinline__ void gram_fetch(
    const float* __restrict__ xb, const float* __restrict__ wb,
    const float* __restrict__ yb, int n, int p, int n0, int lr,
    int ca, int cb, bool diag, int tid, GramStage& st)
{
    const int ca_c = min(ca, p - 1), cb_c = min(cb, p - 1);
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
        const int row = min(n0 + lr + i * STAGE_STRIDE, n - 1);
        const float* xr = xb + (size_t)row * p;
        st.xa[i] = xr[ca_c];
        if (!diag) st.xb[i] = xr[cb_c];
    }
    if (tid < GRAM_ROWS) {
        const int row = min(n0 + tid, n - 1);
        st.w = wb[row];
        st.y = yb[row];
    }
}

// Stores the step just fetched (rows n0.. of the current chunk) into shared
// memory, zeroing rows at or past the chunk's end nc and columns past p.
__device__ __forceinline__ void gram_stage(
    const GramStage& st, int n0, int nc, int lr, int lc, bool ca_ok,
    bool cb_ok, bool diag, int tid, float* smem, float* sW, float* sWY)
{
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
        const int r = lr + i * STAGE_STRIDE;
        const bool row_ok = n0 + r < nc;
        smem[r * TILE + lc] = (row_ok && ca_ok) ? st.xa[i] : 0.f;
        if (!diag)
            smem[(GRAM_ROWS + r) * TILE + lc] =
                (row_ok && cb_ok) ? st.xb[i] : 0.f;
    }
    if (tid < GRAM_ROWS) {
        const bool row_ok = n0 + tid < nc;
        sW[tid] = row_ok ? st.w : 0.f;
        sWY[tid] = row_ok ? st.w * st.y : 0.f;
    }
}

// Multiplies out the step in shared memory: group grp's 16 rows, in order,
// into this thread's 4x4 tile of G (and, on a diagonal tile's first row of
// threads, 4 entries of b).
__device__ __forceinline__ void gram_step(
    const float* sA, const float* sB, const float* sW, const float* sWY,
    int grp, int ty, int tx, bool does_b, float (&acc)[4][4],
    float (&bacc)[4])
{
#pragma unroll
    for (int kk = 0; kk < GROUP_ROWS; ++kk) {
        const int k = grp * GROUP_ROWS + kk;
        const float wk = sW[k];
        const float4 a4 =
            *reinterpret_cast<const float4*>(sA + k * TILE + 4 * ty);
        const float4 b4 =
            *reinterpret_cast<const float4*>(sB + k * TILE + 4 * tx);
        const float a[4] = {wk * a4.x, wk * a4.y, wk * a4.z, wk * a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        if (does_b) {
            const float wy = sWY[k];
#pragma unroll
            for (int j = 0; j < 4; ++j) bacc[j] = fmaf(b[j], wy, bacc[j]);
        }
    }
}

// The body both Gram kernels share.  Task b's rows arrive as `n_chunks`
// chunks of `nc` rows each, laid out one after the other ((B, C, Nc, P)
// contiguous is (B, C*Nc, P) contiguous).  The block walks the chunks in
// order and each chunk in steps of GRAM_ROWS rows; a chunk's last step is
// masked at row nc, exactly as batched_gram masks its edge at row n.  The
// prefetch of the next step crosses chunk boundaries, so the pipeline
// never drains between chunks.  CHUNKED = false is batched_gram: one
// chunk of n rows.  Each instance has its own walk (measured: one nested
// walk for both cost K3 7%), but both stage and multiply out a step with
// the same two functions, so when nc is a multiple of GRAM_ROWS the steps
// of the chunked walk are those of the plain walk over the merged rows
// and the two give the same bits.
template <bool CHUNKED>
__device__ __forceinline__ void gram_body(
    const float* __restrict__ xs, const float* __restrict__ w,
    const float* __restrict__ y, float* __restrict__ g,
    float* __restrict__ bv, int n_chunks, int nc, int p, int n_tiles)
{
    // sA, then sB; reused for the partial tiles of groups 1..3 at the end
    __shared__ __align__(16) float smem[2 * GRAM_ROWS * TILE];
    __shared__ float sW[GRAM_ROWS];
    __shared__ float sWY[GRAM_ROWS];
    __shared__ float sBred[GRAM_GROUPS - 1][TILE];

    // blockIdx.x walks the upper triangle of tile pairs row by row
    int t = blockIdx.x;
    int ti = 0;
    for (int len = n_tiles; t >= len; --len) { t -= len; ++ti; }
    const int tj = ti + t;
    const bool diag = (ti == tj);
    const float* sA = smem;
    const float* sB = diag ? smem : smem + GRAM_ROWS * TILE;

    const int tid = threadIdx.x;
    const int task = blockIdx.y;
    const int chunks = CHUNKED ? n_chunks : 1;
    const size_t rows = (size_t)chunks * nc;     // rows of one task
    const float* xb = xs + (size_t)task * rows * p;
    const float* wb = w + (size_t)task * rows;
    const float* yb = y + (size_t)task * rows;

    // staging role: one tile column, STAGE rows STAGE_STRIDE apart
    const int lc = tid & (TILE - 1);
    const int lr = tid / TILE;
    const int ca = ti * TILE + lc;
    const int cb = tj * TILE + lc;
    const bool ca_ok = ca < p, cb_ok = cb < p;

    // compute role: group grp, 4x4 outputs at rows 4 ty.., columns 4 tx..
    const int grp = tid >> 6;
    const int ty = (tid & 63) >> 3, tx = tid & 7;
    const bool does_b = diag && ty == 0;

    float acc[4][4];
    float bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    GramStage st;
    st.w = st.y = 0.f;
    gram_fetch(xb, wb, yb, nc, p, 0, lr, ca, cb, diag, tid, st);
    if constexpr (CHUNKED) {
        // one flat walk over (chunk c, step n0); rows are task-relative,
        // chunk c holds [c nc, c nc + nc), and the prefetch of the next
        // step may be the next chunk's first (the wrapper keeps C * Nc
        // below 2^31 - 64: int rows suffice)
        int c = 0, n0 = 0;
        for (;;) {
            gram_stage(st, n0, nc, lr, lc, ca_ok, cb_ok, diag, tid, smem, sW,
                       sWY);
            __syncthreads();
            int c1 = c, n1 = n0 + GRAM_ROWS;
            if (n1 >= nc) { c1 = c + 1; n1 = 0; }
            const bool more = c1 < n_chunks;
            if (more) {
                const int base = c1 * nc;
                gram_fetch(xb, wb, yb, base + nc, p, base + n1, lr, ca, cb,
                           diag, tid, st);
            }
            gram_step(sA, sB, sW, sWY, grp, ty, tx, does_b, acc, bacc);
            __syncthreads();
            if (!more) break;
            c = c1;
            n0 = n1;
        }
    } else {
        for (int n0 = 0; n0 < nc; n0 += GRAM_ROWS) {
            gram_stage(st, n0, nc, lr, lc, ca_ok, cb_ok, diag, tid, smem, sW,
                       sWY);
            __syncthreads();
            if (n0 + GRAM_ROWS < nc)
                gram_fetch(xb, wb, yb, nc, p, n0 + GRAM_ROWS, lr, ca, cb,
                           diag, tid, st);
            gram_step(sA, sB, sW, sWY, grp, ty, tx, does_b, acc, bacc);
            __syncthreads();
        }
    }

    // add the four groups' partial tiles in a fixed order
    if (grp > 0) {
        float* red = smem + (grp - 1) * TILE * TILE;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                red[(4 * ty + i) * TILE + 4 * tx + j] = acc[i][j];
        if (does_b) {
#pragma unroll
            for (int j = 0; j < 4; ++j) sBred[grp - 1][4 * tx + j] = bacc[j];
        }
    }
    __syncthreads();
    if (grp > 0) return;

    float* gb = g + (size_t)task * p * p;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int lo = (4 * ty + i) * TILE + 4 * tx + j;
            float v = acc[i][j];
#pragma unroll
            for (int q = 0; q < GRAM_GROUPS - 1; ++q)
                v += smem[q * TILE * TILE + lo];
            const int gi = ti * TILE + 4 * ty + i;
            const int gj = tj * TILE + 4 * tx + j;
            // store (i, j) and its mirror; a diagonal tile keeps i <= j
            if (gi < p && gj < p && (!diag || gi <= gj)) {
                gb[(size_t)gi * p + gj] = v;
                gb[(size_t)gj * p + gi] = v;
            }
        }
    }
    if (does_b) {
        float* bb = bv + (size_t)task * p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float v = bacc[j];
#pragma unroll
            for (int q = 0; q < GRAM_GROUPS - 1; ++q) v += sBred[q][4 * tx + j];
            const int gj = tj * TILE + 4 * tx + j;
            if (gj < p) bb[gj] = v;
        }
    }
}

__global__ void __launch_bounds__(GRAM_THREADS)
batched_gram_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ y, float* __restrict__ g,
                    float* __restrict__ bv, int n, int p, int n_tiles)
{
    gram_body<false>(xs, w, y, g, bv, 1, n, p, n_tiles);
}

// ---------------------------------------------------------------------------
// batched_gram_blocked
//
// The streaming form: N arrives pre-chunked as (B, C, Nc, P) and one block
// per (task, tile) walks all C chunks, so its accumulator persists across
// (c, step) as the TPU kernel's output block persisted across its (c, j)
// grid.  Same tiles, steps, register tiles and group order as
// batched_gram (gram_body), hence the same arithmetic.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GRAM_THREADS)
batched_gram_blocked_kernel(const float* __restrict__ xc,
                            const float* __restrict__ w,
                            const float* __restrict__ y, float* __restrict__ g,
                            float* __restrict__ bv, int n_chunks, int nc,
                            int p, int n_tiles)
{
    gram_body<true>(xc, w, y, g, bv, n_chunks, nc, p, n_tiles);
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

}  // namespace

extern "C" int repro_batched_gram(const void* xs, const void* w,
                                  const void* y, void* g, void* bv,
                                  int b, int n, int p, void* stream)
{
    const int n_tiles = (p + TILE - 1) / TILE;
    const dim3 grid(n_tiles * (n_tiles + 1) / 2, b);
    batched_gram_kernel<<<grid, GRAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xs, (const float*)w, (const float*)y, (float*)g,
        (float*)bv, n, p, n_tiles);
    return (int)cudaGetLastError();
}

extern "C" int repro_batched_gram_blocked(const void* xc, const void* w,
                                          const void* y, void* g, void* bv,
                                          int b, int c, int nc, int p,
                                          void* stream)
{
    const int n_tiles = (p + TILE - 1) / TILE;
    const dim3 grid(n_tiles * (n_tiles + 1) / 2, b);
    batched_gram_blocked_kernel<<<grid, GRAM_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)xc, (const float*)w, (const float*)y, (float*)g,
        (float*)bv, c, nc, p, n_tiles);
    return (int)cudaGetLastError();
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
