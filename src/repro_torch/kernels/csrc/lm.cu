// Hopper (sm_90a) kernels for the language-model serving path.
//
// Built by kernels/build.py with nvcc into a shared library with a plain C
// interface and loaded with ctypes; no PyTorch header is included.  Every
// entry point launches on the stream it is given, allocates nothing, does
// not synchronise and returns cudaGetLastError().
//
//   repro_flash_attention  forward online-softmax attention over folded
//                          heads: q (BH, Sq, D), k/v (BH, Skv, D), float32
//                          or bfloat16; queries aligned to the keys'
//                          suffix (query i sits at position Skv - Sq + i),
//                          causal and sliding-window masks
//   repro_ssd_scan         the Mamba-2 SSD chunked scan over BH lanes:
//                          xbar (BH, S, P), la (BH, S), bm/cm (BH/heads,
//                          S, N) float32 -> y (BH, S, P) and the final
//                          state (BH, N, P)
//
// bfloat16 attention runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 accumulators) from K/V tiles staged by cp.async;
// float32 attention and the scan are plain float32 FMA from shared memory
// (the port keeps TF32 off).  No TMA yet.  Any Sq, Skv, S: ragged edges are
// masked here, with no padding in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// sum (or max) over the 16 lanes of a half-warp that share a tile row
__device__ __forceinline__ float half_warp_sum(float v)
{
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}
__device__ __forceinline__ float half_warp_max(float v)
{
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// ---------------------------------------------------------------------------
// flash_attention, float32
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel) for float32 operands; bfloat16 ones take
// flash_attention_tc_kernel below.  One block of 256 threads per (lane,
// 64-query tile) stages
// the tile's queries once (scaled by 1/sqrt(D), float32) and walks the
// 64-key tiles that the causal mask and the window leave visible to any of
// its queries, so the windowed case costs O(S*W) as the TPU kernel's
// pl.when skip does.  Thread (ti, tj) = (tid / 16, tid % 16) owns query
// rows ti + 16r (r < 4): the 4 x 4 scores of keys tj + 16c, and the output
// columns tj + 16c (c < D/16).  A row's 16 threads are one half-warp, so
// the running max and sum are half-warp shuffles; the probabilities go
// through shared memory to the P V product.  Running (m, l, acc) in
// float32, masked scores are -inf (a row that has seen no key yet keeps
// m = -inf and adds nothing), the output is acc / l.
//
// Bound on an H100: at the serve path's (BH 128, S 2048, D 112) causal it
// does 4 D operations per visible (query, key) pair, 120 GFLOP, and moves
// 470 MB in float32: operations bound, 1.80 ms at the 67 TFLOP/s float32
// FMA rate (TF32 stays off).  It runs on the FMA pipes fed from shared
// memory (two loads per four FMAs in the score loop): 8.02 ms there on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// ---------------------------------------------------------------------------
constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;
constexpr int FA_MAX_D = 128;
constexpr int FA_DSLOTS = FA_MAX_D / 16;
constexpr int FA_PS = FA_BK + 1;            // row stride of the P tile

inline int fa_row_stride(int d) { return d | 1; }   // odd: no bank conflict

inline size_t fa_smem_bytes(int d)
{
    const int dp = fa_row_stride(d);
    return sizeof(float) * ((size_t)(FA_BQ + 2 * FA_BK) * dp + FA_BQ * FA_PS);
}

__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int sq, int skv, int d, int causal, int window,
                       float scale)
{
    extern __shared__ float fa_smem[];
    const int dp = d | 1;
    float* qs = fa_smem;                    // FA_BQ x dp, pre-scaled
    float* ks = qs + FA_BQ * dp;            // FA_BK x dp
    float* vs = ks + FA_BK * dp;            // FA_BK x dp
    float* ps = vs + FA_BK * dp;            // FA_BQ x FA_PS

    const int tid = threadIdx.x;
    const int ti = tid >> 4, tj = tid & 15;
    const int q0 = blockIdx.x * FA_BQ;
    const long long lane = blockIdx.y;
    const float* ql = q + lane * sq * d;
    const float* kl = k + lane * skv * d;
    const float* vl = v + lane * skv * d;
    float* ol = o + lane * sq * d;
    const int offset = skv - sq;
    const int nq = min(FA_BQ, sq - q0);

    for (int idx = tid; idx < FA_BQ * d; idx += FA_THREADS) {
        const int r = idx / d, c = idx - r * d;
        qs[r * dp + c] = r < nq ? ql[(long long)(q0 + r) * d + c] * scale
                                : 0.f;
    }
    // keys visible to some query of the tile: [k_lo, k_hi)
    const int qa_lo = q0 + offset, qa_hi = q0 + nq - 1 + offset;
    int k_lo = 0, k_hi = skv;
    if (window > 0) k_lo = max(0, qa_lo - window + 1);
    if (causal) k_hi = min(skv, qa_hi + 1);
    k_lo = (k_lo / FA_BK) * FA_BK;

    float m[4], l[4], acc[4][FA_DSLOTS];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < FA_DSLOTS; ++c) acc[r][c] = 0.f;
    }

    for (int k0 = k_lo; k0 < k_hi; k0 += FA_BK) {
        const int nk = min(FA_BK, skv - k0);
        __syncthreads();            // the last tile's K, V and P are read
        for (int idx = tid; idx < FA_BK * d; idx += FA_THREADS) {
            const int r = idx / d, c = idx - r * d;
            const long long g = (long long)(k0 + r) * d + c;
            ks[r * dp + c] = r < nk ? kl[g] : 0.f;
            vs[r * dp + c] = r < nk ? vl[g] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        for (int e = 0; e < d; ++e) {
            float qv[4], kv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) qv[r] = qs[(ti + 16 * r) * dp + e];
#pragma unroll
            for (int c = 0; c < 4; ++c) kv[c] = ks[(tj + 16 * c) * dp + e];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        }

#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = ti + 16 * r;
            const int qa = q0 + i + offset;
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = tj + 16 * c;
                const int ka = k0 + j;
                bool ok = j < nk;
                if (causal) ok = ok && ka <= qa;
                if (window > 0) ok = ok && ka > qa - window;
                s[r][c] = ok ? s[r][c] : -INFINITY;
                mx = fmaxf(mx, s[r][c]);
            }
            mx = half_warp_max(mx);
            const float m_new = fmaxf(m[r], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float corr = expf(m[r] - m_use);
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float pv = expf(s[r][c] - m_use);
                ps[i * FA_PS + tj + 16 * c] = pv;
                rs += pv;
            }
            rs = half_warp_sum(rs);
            l[r] = l[r] * corr + rs;
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < FA_DSLOTS; ++c) acc[r][c] *= corr;
        }
        __syncthreads();

        for (int j = 0; j < nk; ++j) {
            float pv[4], vv[FA_DSLOTS];
#pragma unroll
            for (int r = 0; r < 4; ++r) pv[r] = ps[(ti + 16 * r) * FA_PS + j];
#pragma unroll
            for (int c = 0; c < FA_DSLOTS; ++c) {
                const int col = tj + 16 * c;
                vv[c] = col < d ? vs[j * dp + col] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < FA_DSLOTS; ++c)
                    acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= nq) continue;
        const float inv = 1.f / l[r];
#pragma unroll
        for (int c = 0; c < FA_DSLOTS; ++c) {
            const int col = tj + 16 * c;
            if (col < d)
                ol[(long long)(q0 + i) * d + col] = acc[r][c] * inv;
        }
    }
}

// ---------------------------------------------------------------------------
// flash_attention, bfloat16: flash_attention_tc_kernel
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel) for bfloat16 operands, which is what the serve path passes.
//
// Bound on an H100: at the serve path's (BH 128, S 2048, D 112) causal the
// function does 4 D operations per visible (query, key) pair, 120 GFLOP,
// and moves 235 MB: operations bound, 0.122 ms at the 989 TFLOP/s bf16
// tensor-core rate.  With P split in two (below) the tensor cores do 6 D
// operations a pair, 180 GFLOP: 0.18 ms.  The float32-FMA version it
// replaces took 8.00 ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design, in the FlashAttention-2 form with mma.sync.m16n8k16 (bf16 in,
// float32 accumulators):
// - one block of 8 warps per (lane, 128-query tile), each warp owning 16
//   query rows; blockIdx.x is the lane and blockIdx.y is walked backwards,
//   so the heaviest causal tiles of every lane start first;
// - the Q tile is copied once, K and V tiles of 64 keys are copied by
//   cp.async (16-byte chunks) into a two-stage ring, stored as bf16 with a
//   row stride of DK + 8 elements (conflict-free ldmatrix reads); tile k+1
//   is in flight while tile k is multiplied.  Rows past Sq or Skv are
//   zero-filled by the copy and depth columns [D, DK) are zeroed once, so
//   D only needs to be a multiple of 8 (DK rounds it up to 16);
// - S = Q K' from ldmatrix fragments into float32, then scaled by
//   log2(e)/sqrt(D) in float32 (no bf16 rounding of a scaled q), masked to
//   -inf (causal, window, ragged Skv) on the tiles that need it; the block
//   skips the tiles none of its queries can see, a warp those none of its
//   rows can see;
// - the online softmax keeps (m, l) per row in float32 with quad
//   shuffles; a row that has seen no key yet subtracts 0 (no NaN); l sums
//   the float32 P;
// - P V: the S accumulators become A fragments in registers.  P is split
//   into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two mma.sync into the
//   same float32 accumulator: one bf16 rounding of P puts outputs near 0
//   thousands of bf16 steps off the float32 softmax, the split keeps them
//   within one;
// - O / l is written in bf16, masked at Sq and D.
// ---------------------------------------------------------------------------
constexpr int TC_BQ = 128;
constexpr int TC_BK = 64;
constexpr int TC_WARPS = TC_BQ / 16;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr float TC_LOG2E = 1.4426950408889634f;

inline size_t tc_smem_bytes(int dk)
{
    // the Q tile and a two-stage ring of K and V tiles, row stride dk + 8
    return sizeof(__nv_bfloat16) * (size_t)(TC_BQ + 4 * TC_BK) * (dk + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool full)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1()
{
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DK>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int sq, int skv,
                          int d, int causal, int window, float scale_log2)
{
    constexpr int RS = DK + 8;              // row stride in elements
    constexpr int KSTEPS = DK / 16;         // depth steps of Q K'
    constexpr int DTILES = DK / 8;          // 8-column tiles of O
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
    __nv_bfloat16* ks = qs + TC_BQ * RS;    // 2 stages x TC_BK x RS
    __nv_bfloat16* vs = ks + 2 * TC_BK * RS;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const long long bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
    const __nv_bfloat16* ql = q + bh * sq * d;
    const __nv_bfloat16* kl = k + bh * skv * d;
    const __nv_bfloat16* vl = v + bh * skv * d;
    __nv_bfloat16* ol = o + bh * sq * d;
    const int offset = skv - sq;
    const int nq = min(TC_BQ, sq - q0);
    const int chunks = d >> 3;              // 16-byte chunks of a row

    if (d < DK) {       // depth padding: never written by the copies
        const int pad = (DK - d) >> 3;
        for (int idx = tid; idx < (TC_BQ + 4 * TC_BK) * pad;
             idx += TC_THREADS) {
            const int r = idx / pad, c = idx - r * pad;
            *reinterpret_cast<uint4*>(qs + r * RS + d + 8 * c) =
                make_uint4(0u, 0u, 0u, 0u);
        }
    }
    for (int idx = tid; idx < TC_BQ * chunks; idx += TC_THREADS) {
        const int r = idx / chunks, c = idx - r * chunks;
        const bool in = r < nq;
        cp_async_16(smem_addr(qs + r * RS + 8 * c),
                    ql + (long long)(in ? q0 + r : 0) * d + 8 * c, in);
    }
    auto load_kv = [&](int k0, int stage) {
        __nv_bfloat16* kd = ks + stage * TC_BK * RS;
        __nv_bfloat16* vd = vs + stage * TC_BK * RS;
        for (int idx = tid; idx < TC_BK * chunks; idx += TC_THREADS) {
            const int r = idx / chunks, c = idx - r * chunks;
            const bool in = k0 + r < skv;
            const long long off = (long long)(in ? k0 + r : 0) * d + 8 * c;
            cp_async_16(smem_addr(kd + r * RS + 8 * c), kl + off, in);
            cp_async_16(smem_addr(vd + r * RS + 8 * c), vl + off, in);
        }
    };

    // keys visible to some query of the block: [k_lo, k_hi)
    const int qa_lo = q0 + offset, qa_hi = q0 + nq - 1 + offset;
    int k_lo = 0, k_hi = skv;
    if (window > 0) k_lo = max(0, qa_lo - window + 1);
    if (causal) k_hi = min(skv, qa_hi + 1);
    k_lo = (k_lo / TC_BK) * TC_BK;
    // this warp's rows, as positions among the keys
    const int wr0 = q0 + 16 * warp;
    const bool w_rows = wr0 < sq;
    const int w_lo = wr0 + offset, w_hi = min(wr0 + 15, sq - 1) + offset;

    float acc[DTILES][4];
#pragma unroll
    for (int j = 0; j < DTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    load_kv(k_lo, 0);
    cp_async_commit();                      // Q and the first tile
    int stage = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += TC_BK, stage ^= 1) {
        if (k0 + TC_BK < k_hi) load_kv(k0 + TC_BK, stage ^ 1);
        cp_async_commit();                  // possibly empty: uniform wait
        cp_async_wait_1();                  // this tile has landed
        __syncthreads();

        bool sees = w_rows;
        if (causal) sees = sees && k0 <= w_hi;
        if (window > 0) sees = sees && k0 + TC_BK - 1 > w_lo - window;
        if (sees) {
            const __nv_bfloat16* kt = ks + stage * TC_BK * RS;
            const __nv_bfloat16* vt = vs + stage * TC_BK * RS;
            float s[TC_BK / 8][4];
#pragma unroll
            for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                uint32_t a[4];
                ldsm_x4(a, smem_addr(qs + (16 * warp + (lane & 15)) * RS
                                     + 16 * kk + 8 * (lane >> 4)));
#pragma unroll
                for (int jp = 0; jp < TC_BK / 16; ++jp) {
                    uint32_t b[4];
                    ldsm_x4(b, smem_addr(
                        kt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * RS
                        + 16 * kk + 8 * ((lane >> 3) & 1)));
                    mma_bf16(s[2 * jp], a, b[0], b[1]);
                    mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
                }
            }

            // scale in float32, mask, online softmax (rows g and g + 8)
            const bool edge = k0 + TC_BK > skv
                || (causal && k0 + TC_BK - 1 > w_lo)
                || (window > 0 && k0 <= w_hi - window);
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[j][e] * scale_log2;
                    if (edge) {
                        const int qa = w_lo + g + 8 * (e >> 1);
                        const int ka = k0 + 8 * j + 2 * t4 + (e & 1);
                        bool ok = ka < skv;
                        if (causal) ok = ok && ka <= qa;
                        if (window > 0) ok = ok && ka > qa - window;
                        x = ok ? x : -INFINITY;
                    }
                    s[j][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            float mu[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r]);
                mu[r] = m_new == -INFINITY ? 0.f : m_new;
                corr[r] = exp2f(m[r] - mu[r]);
                m[r] = m_new;
            }
#pragma unroll
            for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = exp2f(s[j][e] - mu[e >> 1]);
                    s[j][e] = p;
                    rs[e >> 1] += p;
                }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
            for (int j = 0; j < DTILES; ++j) {
                acc[j][0] *= corr[0];
                acc[j][1] *= corr[0];
                acc[j][2] *= corr[1];
                acc[j][3] *= corr[1];
            }

            // O += P_hi V + P_lo V, 16 keys a step
#pragma unroll
            for (int kk = 0; kk < TC_BK / 16; ++kk) {
                uint32_t ah[4], al[4];
                split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
                split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
                split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
                split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
                for (int dp = 0; dp < KSTEPS; ++dp) {
                    uint32_t b[4];
                    ldsm_x4_trans(b, smem_addr(
                        vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1))
                        * RS + 16 * dp + 8 * (lane >> 4)));
                    mma_bf16(acc[2 * dp], ah, b[0], b[1]);
                    mma_bf16(acc[2 * dp], al, b[0], b[1]);
                    mma_bf16(acc[2 * dp + 1], ah, b[2], b[3]);
                    mma_bf16(acc[2 * dp + 1], al, b[2], b[3]);
                }
            }
        }
        __syncthreads();                    // the stage is free to refill
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = wr0 + g + 8 * r;
        if (row >= sq) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
        __nv_bfloat16* orow = ol + (long long)row * d;
#pragma unroll
        for (int j = 0; j < DTILES; ++j) {
            const int col = 8 * j + 2 * t4;
            if (col < d)
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(acc[j][2 * r] * inv,
                                          acc[j][2 * r + 1] * inv);
        }
    }
}

// ---------------------------------------------------------------------------
// ssd_scan
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py, body _kernel),
// and also returns the final state, which the reference wrapper recomputed
// with its sequential oracle.  One block of 256 threads per lane walks the
// chunks of Q rows in order with the lane's (N, P) state in shared memory
// (the TPU kernel's VMEM scratch across its sequential chunk grid).  Per
// chunk: a block scan gives cl = cumsum(la); the chunk's output rows are
// taken 64 at a time: y_i = exp(cl_i) C_i S (the state entering the chunk)
// plus, for each 64-row key sub-tile j <= i, the masked decayed scores
// W = tril(C B^T * exp(clip(cl_i - cl_j, -60, 0))) through shared memory
// and W x; then S <- exp(cl_last) S + (B * exp(cl_last - cl))^T x, each
// thread holding 16 entries of S in registers.  Thread (ti, tj) owns rows
// ti + 16r and columns tj + 16c (r, c < 4) of every 64 x 64 tile, so N and
// P are at most 64.  bm and cm are shared by the `heads` consecutive lanes
// of one batch row: lane b reads row b / heads.
//
// Bound on an H100: at the serve path's (BH 448, S 2048, P 64, N 64, Q 256)
// the function needs 5 N P operations a row and lane (decay the state, add
// b x', read c'S), 18.8 GFLOP, and moves 485 MB: operations bound (0.28 ms
// at 67 TFLOP/s plain float32; TF32 stays off).  The chunked schedule does
// more (the square-in-chunk products) to expose parallelism.  This version runs on the FMA pipes fed from shared
// memory and reloads the B, x sub-tiles of a chunk from L2 for each row
// sub-tile.
// ---------------------------------------------------------------------------
constexpr int SSD_THREADS = 256;
constexpr int SSD_T = 64;                   // rows of a sub-tile; N, P <= 64
constexpr int SSD_WS = SSD_T + 1;           // row stride of the W tile

inline size_t ssd_smem_bytes(int n, int p, int q)
{
    const int ns = n | 1;
    return sizeof(float) * ((size_t)2 * SSD_T * ns + (size_t)SSD_T * SSD_WS
                            + (size_t)SSD_T * p + (size_t)n * p
                            + 2 * (size_t)q + 8);
}

// inclusive prefix sum of la[0..len) into out[0..len), one row a thread:
// len <= SSD_THREADS, the largest chunk the wrapper passes
__device__ void block_cumsum(const float* __restrict__ la, int len,
                             float* out, float* wsum)
{
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    float v = tid < len ? la[tid] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
    }
    if (lane == 31) wsum[w] = v;
    __syncthreads();
    if (w == 0) {
        float ws = lane < SSD_THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
        for (int off = 1; off < SSD_THREADS / 32; off <<= 1) {
            const float t = __shfl_up_sync(0xffffffffu, ws, off);
            if (lane >= off) ws += t;
        }
        if (lane < SSD_THREADS / 32) wsum[lane] = ws;
    }
    __syncthreads();
    if (w > 0) v += wsum[w - 1];
    if (tid < len) out[tid] = v;
    __syncthreads();
}

__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const float* __restrict__ xbar, const float* __restrict__ la,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, float* __restrict__ state_out,
                int s, int p, int n, int q, int heads)
{
    extern __shared__ float ssd_smem[];
    const int ns = n | 1;
    float* cs = ssd_smem;                   // SSD_T x ns   C rows
    float* bs = cs + SSD_T * ns;            // SSD_T x ns   B rows
    float* ws = bs + SSD_T * ns;            // SSD_T x SSD_WS
    float* xs = ws + SSD_T * SSD_WS;        // SSD_T x p
    float* st = xs + SSD_T * p;             // n x p        the state
    float* cl = st + n * p;                 // q            cumsum of la
    float* tl = cl + q;                     // q            decay to chunk end
    float* wsum = tl + q;                   // 8

    const int tid = threadIdx.x;
    const int ti = tid >> 4, tj = tid & 15;
    const long long lane = blockIdx.x;
    const long long grp = lane / heads;
    const float* xl = xbar + lane * s * p;
    const float* lal = la + lane * s;
    const float* bl = bm + grp * s * n;
    const float* cml = cm + grp * s * n;
    float* yl = y + lane * s * p;

    for (int idx = tid; idx < n * p; idx += SSD_THREADS) st[idx] = 0.f;

    for (int t0 = 0; t0 < s; t0 += q) {
        const int len = min(q, s - t0);
        block_cumsum(lal + t0, len, cl, wsum);     // ends with a barrier
        const float cl_last = cl[len - 1];
        for (int j = tid; j < len; j += SSD_THREADS)
            tl[j] = expf(cl_last - cl[j]);

        for (int ib = 0; ib < len; ib += SSD_T) {
            const int ni = min(SSD_T, len - ib);
            __syncthreads();        // cs of the last sub-tile is read
            for (int idx = tid; idx < SSD_T * n; idx += SSD_THREADS) {
                const int r = idx / n, c = idx - r * n;
                cs[r * ns + c] = r < ni
                    ? cml[(long long)(t0 + ib + r) * n + c] : 0.f;
            }
            __syncthreads();

            // the state entering the chunk: exp(cl_i) C_i S
            float acc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
            for (int e = 0; e < n; ++e) {
                float cv[4], sv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * ns + e];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int col = tj + 16 * c;
                    sv[c] = col < p ? st[e * p + col] : 0.f;
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti + 16 * r;
                const float dec = i < ni ? expf(cl[ib + i]) : 0.f;
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] *= dec;
            }

            // within the chunk: W x over the key sub-tiles up to this one
            for (int jb = 0; jb <= ib; jb += SSD_T) {
                const int nj = min(SSD_T, len - jb);
                __syncthreads();    // bs, xs, ws of the last sub-tile read
                for (int idx = tid; idx < SSD_T * n; idx += SSD_THREADS) {
                    const int r = idx / n, c = idx - r * n;
                    bs[r * ns + c] = r < nj
                        ? bl[(long long)(t0 + jb + r) * n + c] : 0.f;
                }
                for (int idx = tid; idx < SSD_T * p; idx += SSD_THREADS) {
                    const int r = idx / p;
                    xs[idx] = r < nj
                        ? xl[(long long)(t0 + jb) * p + idx] : 0.f;
                }
                __syncthreads();
                float sc[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
                for (int e = 0; e < n; ++e) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        cv[r] = cs[(ti + 16 * r) * ns + e];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        bv[c] = bs[(tj + 16 * c) * ns + e];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
                }
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = ti + 16 * r;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int j = tj + 16 * c;
                        float wv = 0.f;
                        if (i < ni && j < nj && ib + i >= jb + j) {
                            const float diff = fminf(fmaxf(
                                cl[ib + i] - cl[jb + j], -60.f), 0.f);
                            wv = sc[r][c] * expf(diff);
                        }
                        ws[i * SSD_WS + j] = wv;
                    }
                }
                __syncthreads();
                for (int j = 0; j < nj; ++j) {
                    float wv[4], xv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        wv[r] = ws[(ti + 16 * r) * SSD_WS + j];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int col = tj + 16 * c;
                        xv[c] = col < p ? xs[j * p + col] : 0.f;
                    }
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti + 16 * r;
                if (i >= ni) continue;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int col = tj + 16 * c;
                    if (col < p)
                        yl[(long long)(t0 + ib + i) * p + col] = acc[r][c];
                }
            }
        }

        // the state leaving the chunk
        const float dec_all = expf(cl_last);
        float sr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = ti + 16 * r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = tj + 16 * c;
                sr[r][c] = row < n && col < p ? st[row * p + col] * dec_all
                                              : 0.f;
            }
        }
        for (int jb = 0; jb < len; jb += SSD_T) {
            const int nj = min(SSD_T, len - jb);
            __syncthreads();        // bs, xs (and st above) are read
            for (int idx = tid; idx < SSD_T * n; idx += SSD_THREADS) {
                const int r = idx / n, c = idx - r * n;
                bs[r * ns + c] = r < nj
                    ? bl[(long long)(t0 + jb + r) * n + c] * tl[jb + r] : 0.f;
            }
            for (int idx = tid; idx < SSD_T * p; idx += SSD_THREADS) {
                const int r = idx / p;
                xs[idx] = r < nj ? xl[(long long)(t0 + jb) * p + idx] : 0.f;
            }
            __syncthreads();
            for (int j = 0; j < nj; ++j) {
                float bv[4], xv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int row = ti + 16 * r;
                    bv[r] = row < n ? bs[j * ns + row] : 0.f;
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int col = tj + 16 * c;
                    xv[c] = col < p ? xs[j * p + col] : 0.f;
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        sr[r][c] = fmaf(bv[r], xv[c], sr[r][c]);
            }
        }
        __syncthreads();            // every read of the old state is done
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = ti + 16 * r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = tj + 16 * c;
                if (row < n && col < p) st[row * p + col] = sr[r][c];
            }
        }
        __syncthreads();
    }

    float* so = state_out + lane * n * p;
    for (int idx = tid; idx < n * p; idx += SSD_THREADS) so[idx] = st[idx];
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

// launch the bfloat16 kernel at depth DK (D rounded up to 16)
template <int DK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int bh, int sq, int skv, int d, int causal, int window,
                      float scale, cudaStream_t stream)
{
    static size_t granted = 0;
    const size_t smem = tc_smem_bytes(DK);
    const cudaError_t err = allow_smem(flash_attention_tc_kernel<DK>, smem,
                                       &granted);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (sq + TC_BQ - 1) / TC_BQ);
    flash_attention_tc_kernel<DK><<<grid, TC_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq, skv, d, causal,
        window, scale * TC_LOG2E);
    return cudaGetLastError();
}

}  // namespace

// float32 operands take the FMA kernel; bfloat16 ones the tensor-core
// kernel, which needs D % 8 == 0, D <= 128 and Sq <= Skv (the wrapper
// checks; anything else is refused here too)
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq,
                                     int skv, int d, int causal, int window,
                                     float scale, int is_bf16, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16) {
        if (d % 8 != 0 || d > 128 || sq > skv)
            return (int)cudaErrorInvalidValue;
#define TC_CASE(n)                                                      \
    case n / 16:                                                        \
        return (int)launch_tc<n>(q, k, v, o, bh, sq, skv, d, causal,    \
                                 window, scale, st)
        switch ((d + 15) / 16) {
            TC_CASE(16); TC_CASE(32); TC_CASE(48); TC_CASE(64);
            TC_CASE(80); TC_CASE(96); TC_CASE(112); TC_CASE(128);
        }
#undef TC_CASE
        return (int)cudaErrorInvalidValue;
    }
    static size_t granted = 0;
    const size_t smem = fa_smem_bytes(d);
    const cudaError_t err = allow_smem(flash_attention_kernel, smem,
                                       &granted);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sq + FA_BQ - 1) / FA_BQ, bh);
    flash_attention_kernel<<<grid, FA_THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, sq,
        skv, d, causal, window, scale);
    return (int)cudaGetLastError();
}

extern "C" int repro_ssd_scan(const void* xbar, const void* la,
                              const void* bm, const void* cm, void* y,
                              void* state, int bh, int s, int p, int n,
                              int q, int heads, void* stream)
{
    static size_t granted = 0;
    const size_t smem = ssd_smem_bytes(n, p, q);
    const cudaError_t err = allow_smem(ssd_scan_kernel, smem, &granted);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_kernel<<<bh, SSD_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)xbar, (const float*)la, (const float*)bm,
        (const float*)cm, (float*)y, (float*)state, s, p, n, q, heads);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
