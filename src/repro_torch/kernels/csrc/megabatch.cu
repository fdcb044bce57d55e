// Hopper (sm_90a) kernels for the megabatch cross-fit programs.
//
// Built by kernels/build.py with nvcc into a shared library with a plain C
// interface and loaded with ctypes; no PyTorch header is included.  Every
// entry point launches on the stream it is given, allocates nothing, does
// not synchronise and returns cudaGetLastError().
//
//   repro_batched_gram     per-task masked normal equations
//                          G_b = X_b' diag(w_b) X_b,  b_b = X_b'(w_b * y_b)
//   repro_batched_predict  masked GEMV epilogue
//                          out_b = valid_b * (X_b beta_b)
//
// Inputs are contiguous float32 at their true (B, N, P): any P, any N, the
// ragged edges are masked here.  Plain FMA in float32 — no TF32, no tensor
// cores — and one fixed accumulation order per output element, so a result
// does not depend on the launch's batch size or on the other lanes.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(GRAM_THREADS)
batched_gram_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ y, float* __restrict__ g,
                    float* __restrict__ bv, int n, int p, int n_tiles)
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
    const float* xb = xs + (size_t)task * n * p;
    const float* wb = w + (size_t)task * n;
    const float* yb = y + (size_t)task * n;

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
    gram_fetch(xb, wb, yb, n, p, 0, lr, ca, cb, diag, tid, st);
    for (int n0 = 0; n0 < n; n0 += GRAM_ROWS) {
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
            const int r = lr + i * STAGE_STRIDE;
            const bool row_ok = n0 + r < n;
            smem[r * TILE + lc] = (row_ok && ca_ok) ? st.xa[i] : 0.f;
            if (!diag)
                smem[(GRAM_ROWS + r) * TILE + lc] =
                    (row_ok && cb_ok) ? st.xb[i] : 0.f;
        }
        if (tid < GRAM_ROWS) {
            const bool row_ok = n0 + tid < n;
            sW[tid] = row_ok ? st.w : 0.f;
            sWY[tid] = row_ok ? st.w * st.y : 0.f;
        }
        __syncthreads();

        if (n0 + GRAM_ROWS < n)
            gram_fetch(xb, wb, yb, n, p, n0 + GRAM_ROWS, lr, ca, cb, diag,
                       tid, st);

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
        __syncthreads();
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

// ---------------------------------------------------------------------------
// batched_predict
//
// One thread block per (task b, PRED_ROWS consecutive rows), beta_b staged
// in shared memory; one warp per output row at a time, lanes striding over
// P so the row is read coalesced, then a warp-shuffle tree.  The product
// with `valid` comes last, as in the reference kernel, so a zero padding
// row of a page yields an exact 0.
// ---------------------------------------------------------------------------
constexpr int PRED_THREADS = 256;
constexpr int PRED_WARPS = PRED_THREADS / 32;
constexpr int PRED_ROWS = 64;

__global__ void __launch_bounds__(PRED_THREADS)
batched_predict_kernel(const float* __restrict__ xs,
                       const float* __restrict__ beta,
                       const float* __restrict__ valid,
                       float* __restrict__ out, int n, int p)
{
    extern __shared__ float sbeta[];
    const int task = blockIdx.y;
    const int tid = threadIdx.x;
    for (int c = tid; c < p; c += PRED_THREADS)
        sbeta[c] = beta[(size_t)task * p + c];
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * PRED_ROWS;
    for (int r = warp; r < PRED_ROWS; r += PRED_WARPS) {
        const int row = row0 + r;
        if (row >= n) break;                       // uniform across the warp
        const size_t lin = (size_t)task * n + row;
        const float* xr = xs + lin * p;
        float s = 0.f;
        for (int c = lane; c < p; c += 32) s = fmaf(xr[c], sbeta[c], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) out[lin] = s * valid[lin];
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

extern "C" int repro_batched_predict(const void* xs, const void* beta,
                                     const void* valid, void* out,
                                     int b, int n, int p, void* stream)
{
    const dim3 grid((n + PRED_ROWS - 1) / PRED_ROWS, b);
    batched_predict_kernel<<<grid, PRED_THREADS, (size_t)p * sizeof(float),
                             (cudaStream_t)stream>>>(
        (const float*)xs, (const float*)beta, (const float*)valid,
        (float*)out, n, p);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
