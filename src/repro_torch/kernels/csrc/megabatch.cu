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
// on the other lanes.

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
// The shared-X form: T tasks over ONE feature matrix x (N, P), per-task
// weights and targets w, y (T, N):  G_t = X' diag(w_t) X,  b_t = X'(w_t y_t).
// The TPU kernel kept an X tile in VMEM and accumulated a block of 8 tasks
// over it, so one read of X served the block.  Here one thread block per
// (block of 4 nq tasks, 32x32 tile pair ti <= tj) walks N in batched_gram's
// 64-row steps: a step's X columns are staged in shared memory once, beside
// the block's w and w * y rows.  Each thread keeps batched_gram's 4x4
// register tile for four tasks: per row, two 16-byte loads of X and four
// 4-byte loads of w feed 4 x 16 FMAs (batched_gram: three loads for 16).
// At small P most of a 32x32 tile's products fall outside G, so only the
// useful 4x4 sub-tiles of the pair get threads: those that meet [0, P)^2
// and, on a diagonal tile, the upper triangle (at the paper's P 18: 15
// sub-tiles of 64).  There the block runs one warp per scheduler and is
// bound by instruction latency, at 8x its operations bound (PERF.md).  Each of the four row groups gives every (sub-tile, task quad) item
// one thread; nq (1 to 4 quads a block) is chosen at launch so that a
// group's items fill its 64 threads without leaving the card short of
// blocks.  A block whose tasks end at T = 1 multiplies out one task.
//
// Per task, every element is summed over the same rows, in the same four
// groups and the same order as batched_gram, and the groups are added in
// its order ((g0 + g1) + g2) + g3: crossfit_gram(x, w, y) is bitwise
// batched_gram on x broadcast to (T, N, P).  Lanes past T load task T-1's
// rows and store nothing.  The partial tiles are added one task at a time
// through the X slab, so shared memory stays under 28 KB.
// ---------------------------------------------------------------------------
constexpr int XF_TASKS = 4;             // tasks a thread accumulates
constexpr int XF_MAX_QUADS = 4;         // quads of tasks a block takes
constexpr int XF_SLOTS = GRAM_THREADS / GRAM_GROUPS;   // threads a group
constexpr int XF_SUB = TILE / 4;        // 4x4 sub-tiles along a tile edge
constexpr int XF_WSTRIDE = GRAM_ROWS + 1;   // a task's staged row, padded
constexpr int XF_MIN_BLOCKS = 100;      // fewer quads below this many blocks
static_assert(XF_SLOTS == GRAM_ROWS && XF_SLOTS * 16 * (GRAM_GROUPS - 1)
              <= 2 * GRAM_ROWS * TILE, "partial tiles fit the X slab");

struct XfitStage {
    float xa[STAGE], xb[STAGE];
    // row (tid & 63) of the block's tasks (tid >> 6) + 4 i, i < nq
    float w[XF_MAX_QUADS], y[XF_MAX_QUADS];
};

// The useful 4x4 sub-tiles of tile pair (ti, tj): sub-rows sy < sy_n and
// sub-columns sx < sx_n that meet [0, P), and sx >= sy on a diagonal tile.
__host__ __device__ inline int xfit_subtiles(int ti, int tj, int p,
                                             int& sy_n, int& sx_n)
{
    const int rows = (p - ti * TILE + 3) / 4, cols = (p - tj * TILE + 3) / 4;
    sy_n = rows < XF_SUB ? rows : XF_SUB;
    sx_n = cols < XF_SUB ? cols : XF_SUB;
    return ti == tj ? sy_n * (sy_n + 1) / 2 : sy_n * sx_n;
}

__device__ __forceinline__ void xfit_fetch(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ y, int t_total, int task0, int nq, int n,
    int p, int n0, int lr, int ca, int cb, bool diag, int tid,
    XfitStage& st)
{
    const int ca_c = min(ca, p - 1), cb_c = min(cb, p - 1);
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
        const int row = min(n0 + lr + i * STAGE_STRIDE, n - 1);
        const float* xr = x + (size_t)row * p;
        st.xa[i] = xr[ca_c];
        if (!diag) st.xb[i] = xr[cb_c];
    }
    const int row = min(n0 + (tid & (GRAM_ROWS - 1)), n - 1);
#pragma unroll
    for (int i = 0; i < XF_MAX_QUADS; ++i) {
        if (i < nq) {
            const size_t task = (size_t)min(task0 + (tid >> 6) + 4 * i,
                                            t_total - 1);
            st.w[i] = w[task * n + row];
            st.y[i] = y[task * n + row];
        }
    }
}

__device__ __forceinline__ void xfit_stage(
    const XfitStage& st, int n0, int n, int nq, int lr, int lc, bool ca_ok,
    bool cb_ok, bool diag, int tid, float* smem, float* sW, float* sWY)
{
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
        const int r = lr + i * STAGE_STRIDE;
        const bool row_ok = n0 + r < n;
        smem[r * TILE + lc] = (row_ok && ca_ok) ? st.xa[i] : 0.f;
        if (!diag)
            smem[(GRAM_ROWS + r) * TILE + lc] =
                (row_ok && cb_ok) ? st.xb[i] : 0.f;
    }
    const int r = tid & (GRAM_ROWS - 1);
    const bool row_ok = n0 + r < n;
#pragma unroll
    for (int i = 0; i < XF_MAX_QUADS; ++i) {
        if (i < nq) {
            const int s = ((tid >> 6) + 4 * i) * XF_WSTRIDE + r;
            sW[s] = row_ok ? st.w[i] : 0.f;
            sWY[s] = row_ok ? st.w[i] * st.y[i] : 0.f;
        }
    }
}

// Multiplies out the step: group grp's 16 rows, in order, into the 4x4
// tiles at sub-tile (sy, sx) of the first NT tasks of the thread's quad,
// whose staged rows start at sWq / sWYq.
template <int NT>
__device__ __forceinline__ void xfit_step(
    const float* sA, const float* sB, const float* sWq, const float* sWYq,
    int grp, int sy, int sx, bool does_b, float (&acc)[XF_TASKS][4][4],
    float (&bacc)[XF_TASKS][4])
{
#pragma unroll
    for (int kk = 0; kk < GROUP_ROWS; ++kk) {
        const int k = grp * GROUP_ROWS + kk;
        const float4 a4 =
            *reinterpret_cast<const float4*>(sA + k * TILE + 4 * sy);
        const float4 b4 =
            *reinterpret_cast<const float4*>(sB + k * TILE + 4 * sx);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const float wk = sWq[t * XF_WSTRIDE + k];
            const float a[4] = {wk * a4.x, wk * a4.y, wk * a4.z, wk * a4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[t][i][j] = fmaf(a[i], b[j], acc[t][i][j]);
        }
        if (does_b) {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                const float wy = sWYq[t * XF_WSTRIDE + k];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    bacc[t][j] = fmaf(b[j], wy, bacc[t][j]);
            }
        }
    }
}

__global__ void __launch_bounds__(GRAM_THREADS)
crossfit_gram_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ y, float* __restrict__ g,
                     float* __restrict__ bv, int t_total, int n, int p,
                     int n_tiles, int nq)
{
    // sA, then sB; reused for one task's partial tiles of groups 1..3
    __shared__ __align__(16) float smem[2 * GRAM_ROWS * TILE];
    __shared__ float sW[XF_TASKS * XF_MAX_QUADS * XF_WSTRIDE];
    __shared__ float sWY[XF_TASKS * XF_MAX_QUADS * XF_WSTRIDE];
    __shared__ float sBred[GRAM_GROUPS - 1][XF_SLOTS * 4];

    // blockIdx.y walks the upper triangle of tile pairs row by row
    int tp = blockIdx.y;
    int ti = 0;
    for (int len = n_tiles; tp >= len; --len) { tp -= len; ++ti; }
    const int tj = ti + tp;
    const bool diag = (ti == tj);
    const float* sA = smem;
    const float* sB = diag ? smem : smem + GRAM_ROWS * TILE;

    const int tid = threadIdx.x;
    const int task0 = blockIdx.x * XF_TASKS * nq;

    // staging role: one X tile column, STAGE rows STAGE_STRIDE apart, and
    // one row of w and y for each task quad
    const int lc = tid & (TILE - 1);
    const int lr = tid / TILE;
    const int ca = ti * TILE + lc;
    const int cb = tj * TILE + lc;
    const bool ca_ok = ca < p, cb_ok = cb < p;

    // compute role: group grp, item slot = (useful sub-tile u, quad q)
    const int grp = tid >> 6;
    const int slot = tid & (XF_SLOTS - 1);
    int sy_n, sx_n;
    const int n_sub = xfit_subtiles(ti, tj, p, sy_n, sx_n);
    const int q = slot % nq;
    const int tq = task0 + XF_TASKS * q;          // first task of the quad
    const int nt = min(XF_TASKS, t_total - tq);   // its tasks below T
    const bool active = slot < n_sub * nq && nt > 0;
    int u = slot / nq, sy = 0;
    if (diag) {
        for (int len = sy_n; u >= len && len > 0; --len) { u -= len; ++sy; }
    } else {
        sy = u / sx_n;
        u -= sy * sx_n;
    }
    const int sx = diag ? sy + u : u;
    const bool does_b = active && diag && sy == 0;
    const float* sWq = sW + XF_TASKS * q * XF_WSTRIDE;
    const float* sWYq = sWY + XF_TASKS * q * XF_WSTRIDE;

    float acc[XF_TASKS][4][4];
    float bacc[XF_TASKS][4];
#pragma unroll
    for (int t = 0; t < XF_TASKS; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            bacc[t][i] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
        }

    XfitStage st;
    xfit_fetch(x, w, y, t_total, task0, nq, n, p, 0, lr, ca, cb, diag, tid,
               st);
    for (int n0 = 0; n0 < n; n0 += GRAM_ROWS) {
        xfit_stage(st, n0, n, nq, lr, lc, ca_ok, cb_ok, diag, tid, smem, sW,
                   sWY);
        __syncthreads();
        if (n0 + GRAM_ROWS < n)
            xfit_fetch(x, w, y, t_total, task0, nq, n, p, n0 + GRAM_ROWS, lr,
                       ca, cb, diag, tid, st);
        if (active) {
            if (nt == 1)
                xfit_step<1>(sA, sB, sWq, sWYq, grp, sy, sx, does_b, acc,
                             bacc);
            else
                xfit_step<XF_TASKS>(sA, sB, sWq, sWYq, grp, sy, sx, does_b,
                                    acc, bacc);
        }
        __syncthreads();
    }

    // per task: add the four groups' partial tiles in batched_gram's order
    // (the same slot holds the same item in every group)
#pragma unroll
    for (int t = 0; t < XF_TASKS; ++t) {
        if (active && grp > 0) {
            float* red = smem + ((grp - 1) * XF_SLOTS + slot) * 16;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) red[4 * i + j] = acc[t][i][j];
            if (does_b) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    sBred[grp - 1][4 * slot + j] = bacc[t][j];
            }
        }
        __syncthreads();
        const int task = tq + t;
        if (active && grp == 0 && task < t_total) {
            float* gb = g + (size_t)task * p * p;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float v = acc[t][i][j];
#pragma unroll
                    for (int r = 0; r < GRAM_GROUPS - 1; ++r)
                        v += smem[(r * XF_SLOTS + slot) * 16 + 4 * i + j];
                    const int gi = ti * TILE + 4 * sy + i;
                    const int gj = tj * TILE + 4 * sx + j;
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
                    float v = bacc[t][j];
#pragma unroll
                    for (int r = 0; r < GRAM_GROUPS - 1; ++r)
                        v += sBred[r][4 * slot + j];
                    const int gj = tj * TILE + 4 * sx + j;
                    if (gj < p) bb[gj] = v;
                }
            }
        }
        __syncthreads();
    }
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

extern "C" int repro_crossfit_gram(const void* x, const void* w,
                                   const void* y, void* g, void* bv,
                                   int t, int n, int p, void* stream)
{
    const int n_tiles = (p + TILE - 1) / TILE;
    const int pairs = n_tiles * (n_tiles + 1) / 2;
    // task quads a block takes: as many as the pair with the most useful
    // sub-tiles leaves threads for, fewer while the card is short of blocks
    int most = 1;
    for (int ti = 0; ti < n_tiles; ++ti)
        for (int tj = ti; tj < n_tiles; ++tj) {
            int sy_n, sx_n;
            const int n_sub = xfit_subtiles(ti, tj, p, sy_n, sx_n);
            most = n_sub > most ? n_sub : most;
        }
    int nq = XF_SLOTS / most < XF_MAX_QUADS ? XF_SLOTS / most : XF_MAX_QUADS;
    while (nq > 1 && (long long)((t + XF_TASKS * nq - 1) / (XF_TASKS * nq))
                         * pairs < XF_MIN_BLOCKS)
        --nq;
    const dim3 grid((t + XF_TASKS * nq - 1) / (XF_TASKS * nq), pairs);
    crossfit_gram_kernel<<<grid, GRAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const float*)y, (float*)g,
        (float*)bv, t, n, p, n_tiles, nq);
    return (int)cudaGetLastError();
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
