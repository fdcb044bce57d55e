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
// Attention runs on the tensor cores from K/V tiles staged by cp.async:
// bfloat16 operands through mma.sync m16n8k16 (float32 accumulators),
// float32 ones through mma.sync m16n8k8 TF32 with every operand split
// into a TF32 hi and lo part, three products each, which keeps float32
// grade (no TF32 mode: the port keeps TF32 off).  The scan is plain
// float32 FMA from shared memory.  No TMA yet.  Any Sq, Skv, S: ragged
// edges are masked here, with no padding in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// flash_attention, float32: flash_attention_tf32_kernel
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel) for float32 operands; bfloat16 ones take
// flash_attention_tc_kernel below.
//
// Bound on an H100: at the serve path's (BH 128, S 2048, D 112) causal the
// function does 4 D operations per visible (query, key) pair, 120 GFLOP,
// and moves 470 MB in float32.  On the FMA pipes (67 TFLOP/s) that is
// 1.80 ms; the tensor cores' float32-grade route below does each product
// in three TF32 passes, so its least time is 120 GFLOP at 495 / 3 TFLOP/s,
// 0.73 ms.  Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 2.77 ms
// there, against 8.03 for the FMA kernel it replaces and 3.22 for
// scaled_dot_product_attention.  It is bound by the rate of mma.sync's
// TF32 products (one pass instead of three runs much faster; the split
// itself costs little), and wgmma is the way past that rate.
//
// Design: the bf16 kernel's structure with TF32 products split three ways.
// - Each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
//   (cvt.rna), and each product is formed as A_lo B_hi + A_hi B_lo +
//   A_hi B_hi: three mma.sync.m16n8k8 tf32 -> float32 into one float32
//   accumulator, each pass laid over independent output tiles so that the
//   three do not wait on one another.  The dropped A_lo B_lo and the rounding of the lo parts
//   keep a product within about 2^-21 of float32 (a single TF32 rounding
//   is 2^-11 off).  This is not a TF32 mode: the port keeps TF32 off, and
//   chip_smoke.py holds every float32 row within 2e-5 of the plain version.
// - One block of 8 warps per (lane, 128-query tile), each warp owning 16
//   query rows; blockIdx.x is the lane, and the query tiles are walked
//   from the last (the heaviest under a causal mask), several a block when
//   they pass the grid's 65535.  The block skips the key tiles none of its
//   queries can see, a warp those none of its rows can see.
// - Q, K and V tiles are float32 in shared memory at a row stride of DK + 4
//   floats (DK: D rounded up to 16), which makes both reads conflict-free:
//   ldmatrix (8 rows of 16 bytes) for the A fragments of Q and the B
//   fragments of K (a b16 8x8 matrix is an 8x4 float matrix), and 32-bit
//   loads for V.  K and V tiles of 64 keys come by cp.async (16-byte
//   chunks when D % 4 == 0 and the operands are 16-byte aligned, else 4
//   bytes) into a two-stage ring, rows past Sq or Skv zero-filled by the
//   copy, depth columns [D, DK) zeroed once.
// - S = Q K' into float32, scaled by log2(e)/sqrt(D) in float32, masked
//   to -inf (causal, window, ragged Skv); online softmax with quad
//   shuffles, (m, l) in float32, a row that has seen no key subtracts 0.
// - P V with P from the S accumulators in registers: an m16n8k8 A
//   fragment wants columns t and t + 4 of a thread's row, the accumulator
//   holds columns 2t and 2t + 1, so the k index of step j maps to key
//   8 j + 2t (and t + 4 to 8 j + 2t + 1), and V's fragments are read at
//   those rows.  Since P V sums over keys, the order of keys within a step
//   changes nothing.
// - O / l is written in float32, masked at Sq and D (a row that sees no
//   key gives 0 / 0, as the plain version's softmax does).
// ---------------------------------------------------------------------------
constexpr int TF_BQ = 128;
constexpr int TF_BK = 64;
constexpr int TF_WARPS = TF_BQ / 16;
constexpr int TF_THREADS = 32 * TF_WARPS;
constexpr float TF_LOG2E = 1.4426950408889634f;

inline size_t tf_smem_bytes(int dk)
{
    // the Q tile and a two-stage ring of K and V tiles, row stride dk + 4
    return sizeof(float) * (size_t)(TF_BQ + 4 * TF_BK) * (dk + 4);
}

// global -> shared, 16 or 4 bytes, zero-filled when !full
__device__ __forceinline__ void tf_cp_async(uint32_t dst, const void* src,
                                            bool vec4, bool full)
{
    if (vec4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(full ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_0()
{
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// x -> hi = tf32(x), lo = tf32(x - hi), both as float32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col).  Not volatile:
// the compiler may interleave independent products (three passes into one
// accumulator are a chain)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DK>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int sq, int skv, int d,
                            int causal, int window, float scale_log2,
                            int vec4)
{
    constexpr int RS = DK + 4;              // row stride in floats
    constexpr int KSTEPS = DK / 8;          // depth steps of Q K'
    constexpr int DTILES = DK / 8;          // 8-column tiles of O
    extern __shared__ __align__(16) float tf_smem[];
    float* qs = tf_smem;                    // TF_BQ x RS
    float* ks = qs + TF_BQ * RS;            // 2 stages x TF_BK x RS
    float* vs = ks + 2 * TF_BK * RS;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const long long head = blockIdx.x;
    const float* ql = q + head * sq * d;
    const float* kl = k + head * skv * d;
    const float* vl = v + head * skv * d;
    float* ol = o + head * sq * d;
    const int offset = skv - sq;
    const int n_qt = (sq + TF_BQ - 1) / TF_BQ;
    const int cw = vec4 ? 4 : 1;            // floats a copy moves
    const int per_row = d / cw;

    if (d < DK) {       // depth padding: never written by the copies
        const int pad = DK - d;
        for (int idx = tid; idx < (TF_BQ + 4 * TF_BK) * pad;
             idx += TF_THREADS) {
            const int r = idx / pad;
            qs[r * RS + d + idx - r * pad] = 0.f;
        }
    }
    // rows [row0, row0 + n_rows) of a (len, d) operand into dst, rows at or
    // past len zero-filled
    auto copy_rows = [&](float* dst, const float* src, int row0, int n_rows,
                         int len) {
        int r = tid / per_row, c = tid - r * per_row;
        const int dr = TF_THREADS / per_row, dc = TF_THREADS - dr * per_row;
        for (; r < n_rows;) {
            const bool in = row0 + r < len;
            tf_cp_async(smem_addr(dst + r * RS + c * cw),
                        src + (long long)(in ? row0 + r : 0) * d + c * cw,
                        vec4, in);
            r += dr;
            c += dc;
            if (c >= per_row) { c -= per_row; ++r; }
        }
    };

    for (int qt = blockIdx.y; qt < n_qt; qt += gridDim.y) {
        const int q0 = (n_qt - 1 - qt) * TF_BQ;
        const int nq = min(TF_BQ, sq - q0);
        // keys visible to some query of the block: [k_lo, k_hi)
        const int qa_lo = q0 + offset, qa_hi = q0 + nq - 1 + offset;
        int k_lo = 0, k_hi = skv;
        if (window > 0) k_lo = max(0, qa_lo - window + 1);
        if (causal) k_hi = min(skv, qa_hi + 1);
        k_lo = (k_lo / TF_BK) * TF_BK;
        // this warp's rows, as positions among the keys
        const int wr0 = q0 + 16 * warp;
        const bool w_rows = wr0 < sq;
        const int w_lo = wr0 + offset, w_hi = min(wr0 + 15, sq - 1) + offset;

        __syncthreads();                    // the last tile's Q is read
        copy_rows(qs, ql, q0, TF_BQ, sq);
        if (k_lo < k_hi) {
            copy_rows(ks, kl, k_lo, TF_BK, skv);
            copy_rows(vs, vl, k_lo, TF_BK, skv);
        }
        cp_async_commit();                  // Q and the first tile

        float acc[DTILES][4];
#pragma unroll
        for (int j = 0; j < DTILES; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

        int stage = 0;
        for (int k0 = k_lo; k0 < k_hi; k0 += TF_BK, stage ^= 1) {
            if (k0 + TF_BK < k_hi) {
                copy_rows(ks + (stage ^ 1) * TF_BK * RS, kl, k0 + TF_BK,
                          TF_BK, skv);
                copy_rows(vs + (stage ^ 1) * TF_BK * RS, vl, k0 + TF_BK,
                          TF_BK, skv);
            }
            cp_async_commit();              // possibly empty: uniform wait
            cp_async_wait_1();              // this tile has landed
            __syncthreads();

            bool sees = w_rows;
            if (causal) sees = sees && k0 <= w_hi;
            if (window > 0) sees = sees && k0 + TF_BK - 1 > w_lo - window;
            if (sees) {
                const float* kt = ks + stage * TF_BK * RS;
                const float* vt = vs + stage * TF_BK * RS;
                float s[TF_BK / 8][4];
#pragma unroll
                for (int j = 0; j < TF_BK / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk) {
                    // A: rows 0-7 / 8-15 at depth 0-3, then at depth 4-7
                    uint32_t a[4], ah[4], al[4];
                    ldsm_x4(a, smem_addr(
                        qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1))
                        * RS + 8 * kk + 4 * (lane >> 4)));
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
                    // B of the 8 key tiles: keys 16 jp + 0-7 at depth 0-3
                    // and 4-7, then keys 16 jp + 8-15
                    uint32_t bh[TF_BK / 16][4], bl[TF_BK / 16][4];
#pragma unroll
                    for (int jp = 0; jp < TF_BK / 16; ++jp) {
                        uint32_t b[4];
                        ldsm_x4(b, smem_addr(
                            kt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * RS
                            + 8 * kk + 4 * ((lane >> 3) & 1)));
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            split_tf32(__uint_as_float(b[e]), bh[jp][e],
                                       bl[jp][e]);
                    }
                    // the three passes, each over the 8 independent tiles
#pragma unroll
                    for (int jp = 0; jp < TF_BK / 16; ++jp) {
                        mma_tf32(s[2 * jp], al, bh[jp][0], bh[jp][1]);
                        mma_tf32(s[2 * jp + 1], al, bh[jp][2], bh[jp][3]);
                    }
#pragma unroll
                    for (int jp = 0; jp < TF_BK / 16; ++jp) {
                        mma_tf32(s[2 * jp], ah, bl[jp][0], bl[jp][1]);
                        mma_tf32(s[2 * jp + 1], ah, bl[jp][2], bl[jp][3]);
                    }
#pragma unroll
                    for (int jp = 0; jp < TF_BK / 16; ++jp) {
                        mma_tf32(s[2 * jp], ah, bh[jp][0], bh[jp][1]);
                        mma_tf32(s[2 * jp + 1], ah, bh[jp][2], bh[jp][3]);
                    }
                }

                // scale in float32, mask, online softmax (rows g and g + 8)
                const bool edge = k0 + TF_BK > skv
                    || (causal && k0 + TF_BK - 1 > w_lo)
                    || (window > 0 && k0 <= w_hi - window);
                float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
                for (int j = 0; j < TF_BK / 8; ++j)
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
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 1));
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 2));
                    const float m_new = fmaxf(m[r], mx[r]);
                    mu[r] = m_new == -INFINITY ? 0.f : m_new;
                    corr[r] = exp2f(m[r] - mu[r]);
                    m[r] = m_new;
                }
#pragma unroll
                for (int j = 0; j < TF_BK / 8; ++j)
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

                // O += P V, 8 keys a step: the k index t is key 8 j + 2t,
                // t + 4 is key 8 j + 2t + 1
#pragma unroll
                for (int j = 0; j < TF_BK / 8; ++j) {
                    uint32_t ph[4], pl[4];
                    split_tf32(s[j][0], ph[0], pl[0]);
                    split_tf32(s[j][2], ph[1], pl[1]);
                    split_tf32(s[j][1], ph[2], pl[2]);
                    split_tf32(s[j][3], ph[3], pl[3]);
                    const float* v0 = vt + (8 * j + 2 * t4) * RS + g;
                    // O's tiles four at a time: the three passes over four
                    // independent accumulators
#pragma unroll
                    for (int d0 = 0; d0 < DTILES; d0 += 4) {
                        uint32_t vh[4][2], vl[4][2];
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (d0 + u < DTILES) {
                                split_tf32(v0[8 * (d0 + u)], vh[u][0],
                                           vl[u][0]);
                                split_tf32(v0[RS + 8 * (d0 + u)], vh[u][1],
                                           vl[u][1]);
                            }
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (d0 + u < DTILES)
                                mma_tf32(acc[d0 + u], pl, vh[u][0], vh[u][1]);
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (d0 + u < DTILES)
                                mma_tf32(acc[d0 + u], ph, vl[u][0], vl[u][1]);
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (d0 + u < DTILES)
                                mma_tf32(acc[d0 + u], ph, vh[u][0], vh[u][1]);
                    }
                }
            }
            __syncthreads();                // the stage is free to refill
        }
        cp_async_wait_0();                  // nothing left in flight

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            const int row = wr0 + g + 8 * r;
            if (row >= sq) continue;
            const float inv = 1.f / l[r];
            float* orow = ol + (long long)row * d;
#pragma unroll
            for (int j = 0; j < DTILES; ++j) {
                const int col = 8 * j + 2 * t4;
                if (col < d) orow[col] = acc[j][2 * r] * inv;
                if (col + 1 < d) orow[col + 1] = acc[j][2 * r + 1] * inv;
            }
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

// launch the float32 kernel at depth DK (D rounded up to 16); query tiles
// past the grid's 65535 are walked by the blocks in turn
template <int DK>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int skv, int d, int causal,
                        int window, float scale, bool vec4,
                        cudaStream_t stream)
{
    static size_t granted = 0;
    const size_t smem = tf_smem_bytes(DK);
    const cudaError_t err = allow_smem(flash_attention_tf32_kernel<DK>, smem,
                                       &granted);
    if (err != cudaSuccess) return err;
    const int n_qt = (sq + TF_BQ - 1) / TF_BQ;
    const dim3 grid(bh, n_qt < 65535 ? n_qt : 65535);
    flash_attention_tf32_kernel<DK><<<grid, TF_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, sq,
        skv, d, causal, window, scale * TF_LOG2E, (int)vec4);
    return cudaGetLastError();
}

}  // namespace

// float32 operands take the split-TF32 kernel (any D <= 128, any Sq and
// Skv); bfloat16 ones the bf16 tensor-core kernel, which needs D % 8 == 0,
// D <= 128 and Sq <= Skv (the wrapper checks; anything else is refused
// here too)
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
    const bool vec4 = d % 4 == 0
        && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
#define TF_CASE(n)                                                      \
    case n / 16:                                                        \
        return (int)launch_tf32<n>(q, k, v, o, bh, sq, skv, d, causal,  \
                                   window, scale, vec4, st)
    switch ((d + 15) / 16) {
        TF_CASE(16); TF_CASE(32); TF_CASE(48); TF_CASE(64);
        TF_CASE(80); TF_CASE(96); TF_CASE(112); TF_CASE(128);
    }
#undef TF_CASE
    return (int)cudaErrorInvalidValue;
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
