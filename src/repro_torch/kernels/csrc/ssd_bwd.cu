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
// 0.19 ms).
//
// Design: simple and right first (making it fast is later work).  Nine
// launches a call (eight where heads is 1), each a grid of independent
// blocks, every product on the tensor cores as mma.sync m16n8k8 TF32
// with each float32 operand split into a TF32 hi and lo part, three
// passes lo*hi + hi*lo + hi*hi into float32 (the forward's split-TF32
// tier; TF32 mode stays off); cumsums, decays and the reverse pass are
// float32 FMA:
//   (a) ssd_bwd_states_kernel, per (lane, chunk, 64 x 64 tile of the
//       state): (C * exp(cl))' dy, the chunk's own term of (1), into the
//       scratch gst (BH, S / Q, N, P);
//   (b) ssd_bwd_pass_kernel, per lane and state entry, the chunks in
//       reverse order: G_c over (a)'s term in place;
//   (c) ssd_bwd_sg_kernel, per (lane, chunk): <S_in, G>;
//   (d) ssd_bwd_ds_kernel, per (lane, chunk, 64 x 64 sub-tile on or below
//       the diagonal): dS into the scratch ds (BH, S / Q, Qp, Qp), Qp = Q
//       rounded up to 64, and the row and column sums of g;
//   (e) ssd_bwd_dx_kernel, per (lane, chunk, 64 rows, 64 columns of P):
//       W' dy (W formed from the forward's scores as the forward forms
//       it) + (B * tail) G;
//   (f) ssd_bwd_dc_kernel, per (lane, chunk, 64 rows, 64 columns of N):
//       exp(cl) * (dy S_in') (and its row sums against C) + dS B;
//   (g) ssd_bwd_db_kernel, the same for tail * (x G') (and r) + dS' C;
//   (h) ssd_bwd_dla_kernel, per (lane, chunk): dcl from the parts the
//       blocks wrote, then its reverse cumulative sum;
//   (i) ssd_bwd_heads_kernel (heads > 1): dbm, dcm as the sums over each
//       batch row's lanes of (f)'s and (g)'s per-lane terms, in head order.
// A block of (a) and (d)-(g) is 4 warps over a 64 x 64 output tile, each
// warp 16 rows; operands come in 32-deep steps, loaded synchronously into
// shared memory (each thread walks the source's contiguous index, so the
// loads coalesce whichever way an operand is transposed), any transform
// (W, the decays) applied as they are stored.  No float atomics: every
// output and every partial sum is written by one block and summed in a
// fixed order, so a repeated call gives the same bits.  The price of the
// simple design is traffic: dS makes a round trip through device memory
// (a 940 MB scratch at zamba2's call, of which the 587 MB of sub-tiles on
// and below the diagonal are written and read twice), and with heads > 1
// so do the per-lane dB and dC (235 MB each); PERF.md has the times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;                  // a block's output tile, and the
                                        // chunk's 64-row sub-tiles
constexpr int BK = 32;                  // depth of a product step
constexpr int THREADS = 128;            // 4 warps, 16 output rows each
constexpr int MAXQ = 256;               // longest chunk
constexpr int RA = BK + 4;              // A steps [row][k], read along rows
constexpr int RB = BT + 8;              // B steps [k][col], read down columns
constexpr int PASS_THREADS = 256;
constexpr int ROW_THREADS = 256;        // (c), (h): a thread a chunk row

// x -> hi, lo: the TF32 parts of x (round to nearest, ties away from zero,
// each part), as the forward's split_tf32_int (csrc/lm.cu)
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi,
                                               uint32_t& lo)
{
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cl[0, MAXQ) = inclusive prefix sums of la[0, len), la taken as 0 past
// len: the forward's ssd_cumsum, so both see the same bits of cl.  Warp 0
// alone, 8 rows a lane; the caller synchronises
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

// the chunk's cl, then e[i] = exp(cl_i) (tail false) or exp(cl_last -
// cl_i) (tail true) for i < len, 0 past it; synchronises
__device__ __forceinline__ void chunk_decays(const float* __restrict__ la,
                                             int len, float* cl, float* e,
                                             bool tail)
{
    if (threadIdx.x < 32) chunk_cumsum(la, len, cl);
    __syncthreads();
    const float last = cl[len - 1];
    for (int i = threadIdx.x; i < MAXQ; i += blockDim.x)
        e[i] = i >= len ? 0.f : tail ? expf(last - cl[i]) : expf(cl[i]);
    __syncthreads();
}

struct Ident {
    __device__ float operator()(int, int, float v) const { return v; }
};

// a ROWS x COLS step into dst (row stride ds): element (r, c) of the
// source at src[r * sr + c * sc] where r < vr and c < vc (else 0), passed
// through f(r, c, v).  Consecutive threads walk the source's unit-stride
// index, so the loads coalesce either way round
template <int ROWS, int COLS, class F>
__device__ __forceinline__ void load_step(float* dst, int ds,
                                          const float* __restrict__ src,
                                          long long sr, long long sc,
                                          int vr, int vc, F f)
{
    if (sc == 1) {
        for (int idx = threadIdx.x; idx < ROWS * COLS; idx += THREADS) {
            const int r = idx / COLS, c = idx % COLS;
            const float v = (r < vr && c < vc) ? src[r * sr + c] : 0.f;
            dst[r * ds + c] = f(r, c, v);
        }
    } else {
        for (int idx = threadIdx.x; idx < ROWS * COLS; idx += THREADS) {
            const int c = idx / ROWS, r = idx % ROWS;
            const float v = (r < vr && c < vc) ? src[r * sr + c * sc] : 0.f;
            dst[r * ds + c] = f(r, c, v);
        }
    }
}

// acc (the warp's 16 rows x 64 columns) += A B over one BK-deep step, A
// stored [row][k] (row stride RA), B [k][col] (RB); three passes, each
// over four independent column tiles, as the forward's ssd_mma_row
__device__ __forceinline__ void mma_step(float (&acc)[8][4],
                                         const float* as, const float* bs,
                                         int warp, int g, int t)
{
    const float* a0 = as + (16 * warp + g) * RA + t;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32_int(a0[8 * kk], ah[0], al[0]);
        split_tf32_int(a0[8 * RA + 8 * kk], ah[1], al[1]);
        split_tf32_int(a0[8 * kk + 4], ah[2], al[2]);
        split_tf32_int(a0[8 * RA + 8 * kk + 4], ah[3], al[3]);
        const float* r0 = bs + (8 * kk + t) * RB + g;
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 4) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                split_tf32_int(r0[8 * (j0 + u)], bh[u][0], bl[u][0]);
                split_tf32_int(r0[4 * RB + 8 * (j0 + u)], bh[u][1], bl[u][1]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[j0 + u], al, bh[u][0], bh[u][1]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[j0 + u], ah, bl[u][0], bl[u][1]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[j0 + u], ah, bh[u][0], bh[u][1]);
        }
    }
}

// acc += A B over the depth [k0, k1) in BK-deep steps: fa(as, k) stores
// A's columns [k, k + BK), fb(bs, k) B's rows [k, k + BK)
template <class FA, class FB>
__device__ __forceinline__ void product(float (&acc)[8][4], float* as,
                                        float* bs, int k0, int k1, FA fa,
                                        FB fb, int warp, int g, int t)
{
    for (int k = k0; k < k1; k += BK) {
        fa(as, k);
        fb(bs, k);
        __syncthreads();
        mma_step(acc, as, bs, warp, g, t);
        __syncthreads();
    }
}

// the warp's accumulators (row 16 warp + g + 8 h: e 2h, 2h + 1 at columns
// 8 j + 2 t, + 1) into out (row stride ld), rows < vr, columns < vc
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           long long ld, int vr, int vc,
                                           const float (&acc)[8][4],
                                           int warp, int g, int t)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        if (r >= vr) continue;
        float* row = out + r * ld;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;
            if (c < vc) row[c] = acc[j][2 * h];
            if (c + 1 < vc) row[c + 1] = acc[j][2 * h + 1];
        }
    }
}

// the sum of v over the four lanes of a quad (the t of one row), the same
// bits on each
__device__ __forceinline__ float quad_sum(float v)
{
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// (a) (C * exp(cl))' dy of one (lane, chunk): blockIdx.x = lane * nc +
// chunk, blockIdx.y = the 64 x 64 tile of the (N, P) state
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states_kernel(const float* __restrict__ dy,
                      const float* __restrict__ la,
                      const float* __restrict__ cm, float* __restrict__ gst,
                      int s, int p, int n, int q, int nc, int heads)
{
    __shared__ __align__(16) float as[BT * RA];
    __shared__ __align__(16) float bs[BK * RB];
    __shared__ float cl[MAXQ], ecl[MAXQ];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long ln = blockIdx.x / nc;
    const int c = (int)(blockIdx.x - ln * nc);
    const int t0 = c * q, len = min(q, s - t0);
    const int npt = (p + BT - 1) / BT;
    const int n0 = BT * (blockIdx.y / npt), p0 = BT * (blockIdx.y % npt);
    const int wn = min(BT, n - n0), wp = min(BT, p - p0);
    chunk_decays(la + ln * s + t0, len, cl, ecl, false);
    const float* cml = cm + ((ln / heads) * s + t0) * n + n0;
    const float* dyl = dy + (ln * s + t0) * p + p0;
    float acc[8][4] = {};
    product(acc, as, bs, 0, len,
            [&](float* a, int k) {      // A[state row, row] = C' exp(cl)
                load_step<BT, BK>(a, RA, cml + (long long)k * n, 1, n, wn,
                                  len - k, [&](int, int cc, float v) {
                                      return v * ecl[k + cc]; });
            },
            [&](float* b, int k) {      // B[row, column] = dy
                load_step<BK, BT>(b, RB, dyl + (long long)k * p, p, 1,
                                  len - k, wp, Ident());
            }, warp, g, t);
    store_tile(gst + ((ln * nc + c) * n + n0) * p + p0, p, wn, wp, acc, warp,
               g, t);
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
    for (int c = nc - 1; c >= 0; --c) {
        const V local = st[(long long)c * nv];
        st[(long long)c * nv] = run;
        run = axpy(dl[c], run, local);
    }
}

// (c) <S_in, G> of one (lane, chunk) (blockIdx.x = lane * nc + chunk), a
// tree over the block's threads in a fixed order
__global__ void __launch_bounds__(ROW_THREADS)
ssd_bwd_sg_kernel(const float* __restrict__ states,
                  const float* __restrict__ gst, float* __restrict__ sg,
                  long long np)
{
    __shared__ float red[ROW_THREADS];
    const int tid = threadIdx.x;
    const float* a = states + blockIdx.x * np;
    const float* b = gst + blockIdx.x * np;
    float sum = 0.f;
    for (long long i = tid; i < np; i += ROW_THREADS) sum += a[i] * b[i];
    red[tid] = sum;
    __syncthreads();
    for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
        if (tid < w) red[tid] += red[tid + w];
        __syncthreads();
    }
    if (tid == 0) sg[blockIdx.x] = red[0];
}

// (d) dS = tril(dy x') * L of one (lane, chunk), sub-tile (ti, tj), tj <=
// ti (blockIdx.x = lane * nc + chunk, blockIdx.y walks the lower triangle
// row by row), into ds (zero outside the chunk and above the diagonal);
// g = dS * C B' below the diagonal (0 where the clip at -60 bites) summed
// along the tile's rows into parts' column tj and along its columns into
// column nsub + ti
__global__ void __launch_bounds__(THREADS)
ssd_bwd_ds_kernel(const float* __restrict__ xbar, const float* __restrict__ dy,
                  const float* __restrict__ la, const float* __restrict__ cb,
                  float* __restrict__ ds, float* __restrict__ parts, int s,
                  int p, int q, int qp, int nc, int heads, int npart)
{
    __shared__ __align__(16) float as[BT * RA];
    __shared__ __align__(16) float bs[BK * RB];
    __shared__ float cl[MAXQ];
    __shared__ float colsum[THREADS / 32][BT];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long ln = blockIdx.x / nc;
    const int c = (int)(blockIdx.x - ln * nc);
    const int t0 = c * q, len = min(q, s - t0);
    int ti = 0, tj = blockIdx.y;
    while (tj > ti) { tj -= ti + 1; ++ti; }
    const int i0 = BT * ti, j0 = BT * tj, nsub = qp / BT;
    if (i0 >= len) return;                  // past a ragged chunk's end
    if (warp == 0) chunk_cumsum(la + ln * s + t0, len, cl);
    __syncthreads();
    const float* dyl = dy + (ln * s + t0 + i0) * p;
    const float* xl = xbar + (ln * s + t0 + j0) * p;
    float acc[8][4] = {};
    product(acc, as, bs, 0, p,
            [&](float* a, int k) {      // A[i, k] = dy
                load_step<BT, BK>(a, RA, dyl + k, p, 1, len - i0, p - k,
                                  Ident());
            },
            [&](float* b, int k) {      // B[k, j] = x[j, k]
                load_step<BK, BT>(b, RB, xl + k, 1, p, p - k, len - j0,
                                  Ident());
            }, warp, g, t);
    const float* cbl = cb + (((ln / heads) * nc + c) * qp + i0) * qp + j0;
    float rsum[2] = {0.f, 0.f}, csum[8][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, i = i0 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int cc = 8 * j + 2 * t + e, jj = j0 + cc;
                float dsv = 0.f, gv = 0.f;
                if (i < len && jj < len && i >= jj) {
                    const float d = cl[i] - cl[jj];
                    dsv = acc[j][2 * h + e]
                        * expf(fminf(fmaxf(d, -60.f), 0.f));
                    if (i > jj && d >= -60.f && d <= 0.f)
                        gv = dsv * cbl[r * qp + cc];
                }
                acc[j][2 * h + e] = dsv;
                rsum[h] += gv;
                csum[j][e] += gv;
            }
    }
    store_tile(ds + ((ln * nc + c) * qp + i0) * qp + j0, qp, BT, BT, acc,
               warp, g, t);
    float* prow = parts + (ln * s + t0) * npart;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(rsum[h]);
        const int i = i0 + 16 * warp + g + 8 * h;
        if (t == 0 && i < len) prow[(long long)i * npart + tj] = v;
    }
    // column sums: the warp's 16 rows over the lanes' g, then the warps
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float v = csum[j][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) colsum[warp][8 * j + 2 * t + e] = v;
        }
    __syncthreads();
    if (tid < BT && j0 + tid < len) {
        float v = colsum[0][tid];
#pragma unroll
        for (int w = 1; w < THREADS / 32; ++w) v += colsum[w][tid];
        prow[(long long)(j0 + tid) * npart + nsub + ti] = v;
    }
}

// the (lane, chunk, 64-row sub-tile) of blockIdx.x = (lane * nc + chunk)
// * nsub + sub-tile
struct SubTile {
    long long ln;
    int c, t0, len, r0;
};

__device__ __forceinline__ SubTile sub_tile(int s, int q, int qp, int nc)
{
    const int nsub = qp / BT;
    const long long item = blockIdx.x / nsub;
    SubTile st;
    st.ln = item / nc;
    st.c = (int)(item - st.ln * nc);
    st.t0 = st.c * q;
    st.len = min(q, s - st.t0);
    st.r0 = BT * (int)(blockIdx.x - item * nsub);
    return st;
}

// (e) dxbar of one (lane, chunk), rows [j0, + 64), columns [p0, + 64) (p0
// = 64 blockIdx.y): W' dy over the chunk rows i >= j0, W formed from the
// forward's scores, then (B * tail) G over N
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx_kernel(const float* __restrict__ dy, const float* __restrict__ la,
                  const float* __restrict__ bm, const float* __restrict__ cb,
                  const float* __restrict__ gst, float* __restrict__ dx,
                  int s, int p, int n, int q, int qp, int nc, int heads)
{
    __shared__ __align__(16) float as[BT * RA];
    __shared__ __align__(16) float bs[BK * RB];
    __shared__ float cl[MAXQ], tail[MAXQ];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const SubTile st = sub_tile(s, q, qp, nc);
    const long long ln = st.ln;
    const int c = st.c, t0 = st.t0, len = st.len, j0 = st.r0;
    if (j0 >= len) return;
    const int p0 = BT * blockIdx.y, wp = min(BT, p - p0);
    const long long grp = ln / heads;
    chunk_decays(la + ln * s + t0, len, cl, tail, true);
    const float* cbl = cb + (grp * nc + c) * qp * qp + j0;
    const float* dyl = dy + (ln * s + t0) * p + p0;
    const float* bml = bm + (grp * s + t0 + j0) * n;
    const float* gl = gst + (ln * nc + c) * n * p + p0;
    float acc[8][4] = {};
    product(acc, as, bs, j0, len,
            [&](float* a, int k) {      // A[j, i] = W_ij
                load_step<BT, BK>(a, RA, cbl + (long long)k * qp, 1, qp,
                                  len - j0, len - k,
                                  [&](int r, int cc, float v) {
                                      const int i = k + cc, j = j0 + r;
                                      return i >= j ? v * expf(fminf(fmaxf(
                                          cl[i] - cl[j], -60.f), 0.f)) : 0.f;
                                  });
            },
            [&](float* b, int k) {      // B[i, column] = dy
                load_step<BK, BT>(b, RB, dyl + (long long)k * p, p, 1,
                                  len - k, wp, Ident());
            }, warp, g, t);
    product(acc, as, bs, 0, n,
            [&](float* a, int k) {      // A[j, state row] = B tail
                load_step<BT, BK>(a, RA, bml + k, n, 1, len - j0, n - k,
                                  [&](int r, int, float v) {
                                      return v * tail[j0 + r]; });
            },
            [&](float* b, int k) {      // B[state row, column] = G
                load_step<BK, BT>(b, RB, gl + (long long)k * p, p, 1, n - k,
                                  wp, Ident());
            }, warp, g, t);
    store_tile(dx + (ln * s + t0 + j0) * p + p0, p, len - j0, wp, acc, warp,
               g, t);
}

// (f) one lane's dC, rows [i0, + 64) of one chunk, columns [n0, + 64) of N
// (n0 = 64 blockIdx.y): exp(cl) * (dy S_in') over P, whose row sums
// against C go to parts' column 2 nsub + blockIdx.y, then dS B over the
// chunk rows j < i0 + 64; into out (row of lane ln)
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dc_kernel(const float* __restrict__ dy, const float* __restrict__ la,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ states,
                  const float* __restrict__ ds, float* __restrict__ parts,
                  float* __restrict__ out, int s, int p, int n, int q,
                  int qp, int nc, int heads, int npart)
{
    __shared__ __align__(16) float as[BT * RA];
    __shared__ __align__(16) float bs[BK * RB];
    __shared__ float cl[MAXQ], ecl[MAXQ];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const SubTile st = sub_tile(s, q, qp, nc);
    const long long ln = st.ln;
    const int c = st.c, t0 = st.t0, len = st.len, i0 = st.r0;
    if (i0 >= len) return;
    const int n0 = BT * blockIdx.y, wn = min(BT, n - n0);
    const long long grp = ln / heads;
    chunk_decays(la + ln * s + t0, len, cl, ecl, false);
    const float* dyl = dy + (ln * s + t0 + i0) * p;
    const float* stl = states + (ln * nc + c) * n * p + (long long)n0 * p;
    float acc[8][4] = {};
    product(acc, as, bs, 0, p,
            [&](float* a, int k) {      // A[i, k] = dy
                load_step<BT, BK>(a, RA, dyl + k, p, 1, len - i0, p - k,
                                  Ident());
            },
            [&](float* b, int k) {      // B[k, state row] = S_in[row, k]
                load_step<BK, BT>(b, RB, stl + k, 1, p, p - k, wn, Ident());
            }, warp, g, t);
    const float* cml = cm + (grp * s + t0 + i0) * n + n0;
    const int nsub = qp / BT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, i = i0 + r;
        const float e = ecl[i];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int cc = 8 * j + 2 * t + u;
                acc[j][2 * h + u] *= e;
                if (i < len && cc < wn)
                    sum += cml[(long long)r * n + cc] * acc[j][2 * h + u];
            }
        sum = quad_sum(sum);
        if (t == 0 && i < len)
            parts[(ln * s + t0 + i) * npart + 2 * nsub + blockIdx.y] = sum;
    }
    const float* dsl = ds + ((ln * nc + c) * qp + i0) * qp;
    const float* bml = bm + (grp * s + t0) * n + n0;
    const int kend = min(i0 + BT, len);
    product(acc, as, bs, 0, kend,
            [&](float* a, int k) {      // A[i, j] = dS
                load_step<BT, BK>(a, RA, dsl + k, qp, 1, len - i0, kend - k,
                                  Ident());
            },
            [&](float* b, int k) {      // B[j, column] = B
                load_step<BK, BT>(b, RB, bml + (long long)k * n, n, 1,
                                  len - k, wn, Ident());
            }, warp, g, t);
    store_tile(out + (ln * s + t0 + i0) * n + n0, n, len - i0, wn, acc, warp,
               g, t);
}

// (g) one lane's dB, rows [j0, + 64) of one chunk, columns [n0, + 64) of N:
// tail * (x G') over P, whose row sums against B times the tail (rows
// before the chunk's last) go to parts' column 2 nsub + ntn + blockIdx.y,
// then dS' C over the chunk rows i >= j0; into out (row of lane ln)
__global__ void __launch_bounds__(THREADS)
ssd_bwd_db_kernel(const float* __restrict__ xbar,
                  const float* __restrict__ la, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ gst,
                  const float* __restrict__ ds, float* __restrict__ parts,
                  float* __restrict__ out, int s, int p, int n, int q,
                  int qp, int nc, int heads, int npart)
{
    __shared__ __align__(16) float as[BT * RA];
    __shared__ __align__(16) float bs[BK * RB];
    __shared__ float cl[MAXQ], tail[MAXQ];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const SubTile st = sub_tile(s, q, qp, nc);
    const long long ln = st.ln;
    const int c = st.c, t0 = st.t0, len = st.len, j0 = st.r0;
    if (j0 >= len) return;
    const int n0 = BT * blockIdx.y, wn = min(BT, n - n0);
    const long long grp = ln / heads;
    chunk_decays(la + ln * s + t0, len, cl, tail, true);
    const float* xl = xbar + (ln * s + t0 + j0) * p;
    const float* gl = gst + (ln * nc + c) * n * p + (long long)n0 * p;
    float acc[8][4] = {};
    product(acc, as, bs, 0, p,
            [&](float* a, int k) {      // A[j, k] = x
                load_step<BT, BK>(a, RA, xl + k, p, 1, len - j0, p - k,
                                  Ident());
            },
            [&](float* b, int k) {      // B[k, state row] = G[row, k]
                load_step<BK, BT>(b, RB, gl + k, 1, p, p - k, wn, Ident());
            }, warp, g, t);
    const float* bmr = bm + (grp * s + t0 + j0) * n + n0;
    const int nsub = qp / BT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, j = j0 + r;
        const float tl = tail[j];
        float sum = 0.f;
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int cc = 8 * jt + 2 * t + u;
                if (j < len && cc < wn)
                    sum += bmr[(long long)r * n + cc] * acc[jt][2 * h + u];
                acc[jt][2 * h + u] *= tl;
            }
        sum = quad_sum(sum);
        if (t == 0 && j < len)              // the last row's tail is 1
            parts[(ln * s + t0 + j) * npart + 2 * nsub + gridDim.y
                  + blockIdx.y] = j == len - 1 ? 0.f : tl * sum;
    }
    const float* dsl = ds + (ln * nc + c) * qp * qp + j0;
    const float* cml = cm + (grp * s + t0) * n + n0;
    product(acc, as, bs, j0, len,
            [&](float* a, int k) {      // A[j, i] = dS_ij
                load_step<BT, BK>(a, RA, dsl + (long long)k * qp, 1, qp,
                                  len - j0, len - k, Ident());
            },
            [&](float* b, int k) {      // B[i, column] = C
                load_step<BK, BT>(b, RB, cml + (long long)k * n, n, 1,
                                  len - k, wn, Ident());
            }, warp, g, t);
    store_tile(out + (ln * s + t0 + j0) * n + n0, n, len - j0, wn, acc, warp,
               g, t);
}

// (h) dla of one (lane, chunk) (blockIdx.x = lane * nc + chunk), a thread
// a chunk row: dcl from the parts in a fixed order, the chunk-end terms at
// the last row, then the reverse cumulative sum (one thread, in order)
__global__ void __launch_bounds__(ROW_THREADS)
ssd_bwd_dla_kernel(const float* __restrict__ parts,
                   const float* __restrict__ sg,
                   const float* __restrict__ decay, float* __restrict__ dla,
                   int s, int q, int qp, int nc, int ntn, int npart)
{
    __shared__ float red[ROW_THREADS], dc[MAXQ];
    const int i = threadIdx.x;
    const long long item = blockIdx.x, ln = item / nc;
    const int c = (int)(item - ln * nc);
    const int t0 = c * q, len = min(q, s - t0);
    const int nsub = qp / BT, nti = (len + BT - 1) / BT;
    float v = 0.f, tr = 0.f;
    if (i < len) {
        const float* pr = parts + (ln * s + t0 + i) * npart;
        const int ti = i / BT;
        for (int u = 0; u <= ti; ++u) v += pr[u];
        for (int u = ti; u < nti; ++u) v -= pr[nsub + u];
        for (int u = 0; u < ntn; ++u) v += pr[2 * nsub + u];
        for (int u = 0; u < ntn; ++u) tr += pr[2 * nsub + ntn + u];
        v -= tr;
    }
    red[i] = tr;
    __syncthreads();
    for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
        if (i < w) red[i] += red[i + w];
        __syncthreads();
    }
    if (i == len - 1) v += red[0] + decay[item] * sg[item];
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

// (i) dbm, dcm: per (batch row, row, state entry) the sum of the row's
// lanes' terms in head order
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_heads_kernel(const float* __restrict__ lane_b,
                     const float* __restrict__ lane_c,
                     float* __restrict__ dbm, float* __restrict__ dcm,
                     long long per_lane, long long total, int heads)
{
    for (long long idx = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
         idx < total; idx += (long long)gridDim.x * PASS_THREADS) {
        const long long grp = idx / per_lane, off = idx - grp * per_lane;
        const float* b = lane_b + grp * heads * per_lane + off;
        const float* c = lane_c + grp * heads * per_lane + off;
        float sb = 0.f, sc = 0.f;
        for (int h = 0; h < heads; ++h) {
            sb += b[h * per_lane];
            sc += c[h * per_lane];
        }
        dbm[idx] = sb;
        dcm[idx] = sc;
    }
}

}  // namespace

// The backward in the launches (a)-(i) above.  Inputs: the forward's
// operands xbar, la, bm, cm; its scores cb (BH / heads, nc, Qp, Qp) and
// chunk states (BH, nc, N, P: the state entering each chunk) and decays
// (BH, nc) as ssd_scan's pass (c) leaves them; dy; dstate (null: zero).
// Outputs dx, dla, dbm, dcm.  Scratch: gst (BH, nc, N, P), ds (BH, nc, Qp,
// Qp), parts (BH, S, 2 ceil(Qp / 64) + 2 ceil(N / 64)), sg (BH, nc), and
// where heads > 1 lane_b and lane_c (BH, S, N) (where heads is 1 they are
// not read: (f) and (g) write dcm and dbm).  nc = ceil(S / Q), Qp = Q
// rounded up to 64; Q <= 256, the tiles of N P at most 65535, N P at most
// 65535 * 256 entries, and BH nc Qp / 64 blocks under 2^31
extern "C" int repro_ssd_scan_bwd(const void* xbar, const void* la,
                                  const void* bm, const void* cm,
                                  const void* cb, const void* states,
                                  const void* decay, const void* dy,
                                  const void* dstate, void* dx, void* dla,
                                  void* dbm, void* dcm, void* gst, void* ds,
                                  void* parts, void* sg, void* lane_b,
                                  void* lane_c, int bh, int s, int p, int n,
                                  int q, int heads, void* stream)
{
    if (n < 1 || p < 1 || s < 1 || q < 1 || q > MAXQ || heads < 1
        || bh % heads != 0
        || (heads > 1 && (lane_b == nullptr || lane_c == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int nc = (s + q - 1) / q, qp = (q + BT - 1) / BT * BT;
    const int nsub = qp / BT;
    const int ntn = (n + BT - 1) / BT, npt = (p + BT - 1) / BT;
    const int npart = 2 * nsub + 2 * ntn;
    const long long items = (long long)bh * nc;
    if (items * nsub >= (1LL << 31) || (long long)ntn * npt > 65535
        || (long long)n * p > 65535LL * PASS_THREADS)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)xbar;
    const float* laf = (const float*)la;
    const float* bf = (const float*)bm;
    const float* cf = (const float*)cm;
    const float* dyf = (const float*)dy;
    float* gf = (float*)gst;
    float* dsf = (float*)ds;
    float* pf = (float*)parts;
    float* sgf = (float*)sg;
    float* out_b = heads > 1 ? (float*)lane_b : (float*)dbm;
    float* out_c = heads > 1 ? (float*)lane_c : (float*)dcm;
    cudaError_t err;

    ssd_bwd_states_kernel<<<dim3((unsigned)items, ntn * npt), THREADS, 0,
                            st>>>(dyf, laf, cf, gf, s, p, n, q, nc, heads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
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
            gf, (const float*)decay, (const float*)dstate, np, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_sg_kernel<<<(unsigned)items, ROW_THREADS, 0, st>>>(
        (const float*)states, gf, sgf, (long long)np);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_ds_kernel<<<dim3((unsigned)items, nsub * (nsub + 1) / 2),
                        THREADS, 0, st>>>(
        xf, dyf, laf, (const float*)cb, dsf, pf, s, p, q, qp, nc, heads,
        npart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const unsigned sub_items = (unsigned)(items * nsub);
    ssd_bwd_dx_kernel<<<dim3(sub_items, npt), THREADS, 0, st>>>(
        dyf, laf, bf, (const float*)cb, gf, (float*)dx, s, p, n, q, qp, nc,
        heads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dc_kernel<<<dim3(sub_items, ntn), THREADS, 0, st>>>(
        dyf, laf, bf, cf, (const float*)states, dsf, pf, out_c, s, p, n, q,
        qp, nc, heads, npart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_db_kernel<<<dim3(sub_items, ntn), THREADS, 0, st>>>(
        xf, laf, bf, cf, gf, dsf, pf, out_b, s, p, n, q, qp, nc, heads,
        npart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dla_kernel<<<(unsigned)items, ROW_THREADS, 0, st>>>(
        pf, sgf, (const float*)decay, (float*)dla, s, q, qp, nc, ntn, npart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (heads > 1) {
        const long long per_lane = (long long)s * n;
        const long long total = (long long)(bh / heads) * per_lane;
        long long blocks = (total + PASS_THREADS - 1) / PASS_THREADS;
        if (blocks > (1LL << 20)) blocks = 1LL << 20;
        ssd_bwd_heads_kernel<<<(unsigned)blocks, PASS_THREADS, 0, st>>>(
            (const float*)lane_b, (const float*)lane_c, (float*)dbm,
            (float*)dcm, per_lane, total, heads);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
