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
//                          state (BH, N, P), through scratch the caller
//                          allocates
//
// Attention runs on the tensor cores from K/V tiles staged by cp.async:
// bfloat16 operands through mma.sync m16n8k16 (float32 accumulators),
// float32 ones through mma.sync m16n8k8 TF32 with every operand split
// into a TF32 hi and lo part, three products each, which keeps float32
// grade (no TF32 mode: the port keeps TF32 off).  The scan runs in four
// launches parallel over chunks (scores once per batch row, the chunks'
// own states, the state passing, the outputs), its products through the
// same split-TF32 mma.sync from tiles staged by cp.async; its decays,
// cumsum and state passing are float32 FMA.  No TMA or wgmma yet.  Any
// Sq, Skv, S: ragged edges are masked here, with no padding in the
// wrapper (the scan's scratch is allocated by its wrapper).

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
// ssd_scan: four kernels, parallel over chunks
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py, body _kernel),
// and also returns the final state, which the reference wrapper recomputed
// with its sequential oracle.  The TPU kernel walks a lane's chunks in
// order with the (N, P) state in VMEM; here the chunks run in parallel by
// Dao & Gu's state passing (arXiv:2405.21060, section 7), chunks of Q rows,
// cl = cumsum(la) within a chunk:
//   (a) ssd_scores_kernel, per (batch row, chunk, 64 x 64 sub-tile on or
//       below the diagonal): the scores C B^T into an L2-resident scratch
//       (BH / heads, S / Q, Qp, Qp), Qp = Q rounded up to 64.  bm and cm
//       are shared by the `heads` lanes of a batch row (n_groups 1), so the
//       scores are computed once for all of them;
//   (b) ssd_states_kernel, per (lane, chunk): the chunk's own state
//       (B * exp(cl_Q - cl))^T x (N x P) into a scratch (BH, S / Q, N, P),
//       and the chunk's decay exp(cl_Q) into (BH, S / Q);
//   (c) ssd_pass_kernel, per lane and state entry, in chunk order:
//       S_c = exp(cl_Q,c-1) S_c-1 + local_c-1, written over the scratch as
//       the state entering each chunk; the last one is the final state;
//   (d) ssd_out_kernel, per (lane, chunk, 128-row tile, the heaviest
//       first): y = exp(cl_i) C_i S_c + tril(C B^T * exp(clip(cl_i - cl_j,
//       -60, 0))) x, the scores read back from (a).
// Every product (C B^T, C S, W x, (B * tail)^T x) runs on the tensor cores
// as mma.sync m16n8k8 TF32 with each float32 operand split into a TF32 hi
// and lo part (cvt.rna's rounding, split_tf32_int), three passes lo*hi +
// hi*lo + hi*hi into float32: float32 grade without a TF32 mode.  W is
// formed and decayed in float32 and then split; the cumsum, the decays and
// the state passing are float32 FMA.  In (b) and (d) a warp owns 32 output
// rows (two m-tiles) and all 64 columns, so each B fragment loaded and
// split from shared memory feeds two m-tiles, which halves the loads and
// splits per product.  N, P are at most 64.  Operands come in slices
// 32 deep by cp.async (16-byte chunks when N, P % 4 == 0 and the operands
// are 16-byte aligned, else 4 bytes) into a two-stage ring: the next
// slice's copy overlaps the current product.  Row strides of 4 mod 32
// floats (fragments read along rows) and 8 mod 32 (read down columns) keep
// the fragment loads free of bank conflicts.  Rows past a ragged chunk's
// end are zero-filled by the copies and masked; columns past N or P are
// zeroed once.
//
// Bound on an H100: at the serve path's (BH 448, S 2048, P 64, N 64, Q 256,
// heads 112) the function needs 5 N P operations a row and lane, 18.8
// GFLOP, and moves 485 MB: bound by bytes (0.145 ms at 3.35 TB/s; the
// operations take 0.114 ms at the TF32 rate over the split's three
// passes, 0.28 ms at the plain float32 FMA rate).  The chunked schedule
// does about 34 GFLOP (the square-in-chunk products) and moves the chunks'
// states through device memory four times besides (written, passed in
// place, read back: about 235 MB).
// ---------------------------------------------------------------------------
// x -> hi, lo as split_tf32 (round to nearest, ties away from zero, each
// part), the rounding done as an integer add and mask: the same bits for
// finite x, in two instructions where the compiler spends three on each
// cvt.rna.tf32.f32 (a test for infinity, an add, a mask)
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi,
                                               uint32_t& lo)
{
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

constexpr int SSD_T = 64;                   // N, P and (a)'s sub-tile
constexpr int SSD_THREADS = 128;            // 4 warps
constexpr int SSD_MAXQ = 256;               // longest chunk: 8 rows a lane
constexpr int SSD_RT = 128;                 // rows of (d)'s output tile
constexpr int SSD_KT = 32;                  // depth of a slice in (b), (d)
constexpr int SSD_RA = SSD_T + 4;           // (a)'s tiles, read along rows
constexpr int SSD_RK = SSD_KT + 4;          // (d)'s A slices, along rows
constexpr int SSD_RB = SSD_T + 8;           // slices read down columns
constexpr int SSD_PASS_THREADS = 256;

// the two-stage rings of (b) and (d), and the chunk's cumsum: 37 KB and
// 55 KB, so with at most 128 registers a thread four blocks of (d) share
// an SM (a third stage costs one of them, and ran slower)
constexpr size_t SSD_STATES_SMEM =
    sizeof(float) * (2 * 2 * SSD_KT * SSD_RB + SSD_MAXQ);
constexpr size_t SSD_OUT_SMEM =
    sizeof(float) * (2 * (SSD_RT * SSD_RK + SSD_KT * SSD_RB) + SSD_MAXQ);

// rows [0, rows) of a tile whose row r starts at src + r * ld, w floats
// wide, into dst (row stride rs) by cp.async; rows at or past `valid`
// (>= 1) are zero-filled.  Columns [w, rs) of dst are not written
__device__ __forceinline__ void ssd_copy(float* dst, int rs, const float* src,
                                         long long ld, int rows, int valid,
                                         int w, bool vec4)
{
    const int cw = vec4 ? 4 : 1;
    const int per_row = w / cw;
    // one division a thread, then steps of SSD_THREADS chunks
    int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
    const int dr = SSD_THREADS / per_row, dc = SSD_THREADS - dr * per_row;
    while (r < rows) {
        const bool in = r < valid;
        tf_cp_async(smem_addr(dst + r * rs + c * cw),
                    src + (in ? r : 0) * ld + c * cw, vec4, in);
        r += dr;
        c += dc;
        if (c >= per_row) { c -= per_row; ++r; }
    }
}

// zero columns [w, width) of rows [0, rows) (never written by the copies)
__device__ __forceinline__ void ssd_zero_cols(float* dst, int rs, int rows,
                                              int w, int width)
{
    const int pad = width - w;
    if (pad <= 0) return;
    for (int idx = threadIdx.x; idx < rows * pad; idx += SSD_THREADS) {
        const int r = idx / pad;
        dst[r * rs + w + idx - r * pad] = 0.f;
    }
}

// cl[0, SSD_MAXQ) = inclusive prefix sums of la[0, len), la taken as 0 past
// len.  Warp 0 alone, 8 rows a lane; the caller synchronises.  (b) and (d)
// both call it, so they see the same bits of cl
__device__ __forceinline__ void ssd_cumsum(const float* __restrict__ la,
                                           int len, float* cl)
{
    const int lane = threadIdx.x & 31;
    float v[SSD_MAXQ / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < SSD_MAXQ / 32; ++e) {
        const int i = (SSD_MAXQ / 32) * lane + e;
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
    for (int e = 0; e < SSD_MAXQ / 32; ++e)
        cl[(SSD_MAXQ / 32) * lane + e] = excl + v[e];
}

// acc[m][j] (16 x 8) += A_m (16 x 8) B_j (8 x 8) for M m-tiles and the 64
// columns of one depth step, B read from a slice stored [k][n] (row stride
// SSD_RB: b0 = (k t, n g), b1 = (k t + 4, n g)) and split four n-tiles at
// a time; three passes, each over the independent tiles
template <int M>
__device__ __forceinline__ void ssd_mma_row(float (&acc)[M][8][4],
                                            const uint32_t (&ah)[M][4],
                                            const uint32_t (&al)[M][4],
                                            const float* bslice, int kk,
                                            int g, int t)
{
    const float* r0 = bslice + (8 * kk + t) * SSD_RB + g;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            split_tf32_int(r0[8 * (j0 + u)], bh[u][0], bl[u][0]);
            split_tf32_int(r0[4 * SSD_RB + 8 * (j0 + u)], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[m][j0 + u], al[m], bh[u][0], bh[u][1]);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[m][j0 + u], ah[m], bl[u][0], bl[u][1]);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mma_tf32(acc[m][j0 + u], ah[m], bh[u][0], bh[u][1]);
    }
}

// one m-tile's accumulators (row g: e 0, 1; row g + 8: e 2, 3; columns
// 8 j + 2 t, + 1) into out (row stride ld), rows < rows, columns < cols
__device__ __forceinline__ void ssd_store(float* out, long long ld,
                                          int rows, int cols,
                                          const float (&acc)[8][4], int g,
                                          int t, bool pairs)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= rows) continue;
        float* row = out + r * ld;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;
            if (pairs && c + 1 < cols) {
                *reinterpret_cast<float2*>(row + c) =
                    make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
                if (c < cols) row[c] = acc[j][2 * h];
                if (c + 1 < cols) row[c + 1] = acc[j][2 * h + 1];
            }
        }
    }
}

// (a) the scores C B^T of one (batch row, chunk), sub-tile (ti, tj), tj <=
// ti; blockIdx.x = batch row * nc + chunk, blockIdx.y walks the lower
// triangle of sub-tiles row by row.  A warp owns 16 rows of the sub-tile
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int s, int n, int q, int qp,
                  int nc, int vec4)
{
    __shared__ __align__(16) float cs[SSD_T * SSD_RA];
    __shared__ __align__(16) float bs[SSD_T * SSD_RA];
    const int grp = blockIdx.x / nc, c = blockIdx.x - grp * nc;
    int ti = 0, tj = blockIdx.y;
    while (tj > ti) { tj -= ti + 1; ++ti; }
    const int t0 = c * q, len = min(q, s - t0);
    if (SSD_T * ti >= len) return;          // past a ragged chunk's end

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* cml = cm + ((long long)grp * s + t0) * n;
    const float* bml = bm + ((long long)grp * s + t0) * n;
    ssd_zero_cols(cs, SSD_RA, SSD_T, n, SSD_T);
    ssd_zero_cols(bs, SSD_RA, SSD_T, n, SSD_T);
    ssd_copy(cs, SSD_RA, cml + (long long)SSD_T * ti * n, n, SSD_T,
             len - SSD_T * ti, n, vec4);
    ssd_copy(bs, SSD_RA, bml + (long long)SSD_T * tj * n, n, SSD_T,
             len - SSD_T * tj, n, vec4);
    cp_async_commit();
    cp_async_wait_0();
    __syncthreads();

    float acc[8][4] = {};
    const float* a0 = cs + (16 * warp + g) * SSD_RA + t;
    for (int kk = 0; kk < (n + 7) / 8; ++kk) {
        uint32_t ah[4], al[4], bh[8][2], bl[8][2];
        split_tf32_int(a0[8 * kk], ah[0], al[0]);
        split_tf32_int(a0[8 * SSD_RA + 8 * kk], ah[1], al[1]);
        split_tf32_int(a0[8 * kk + 4], ah[2], al[2]);
        split_tf32_int(a0[8 * SSD_RA + 8 * kk + 4], ah[3], al[3]);
        // B stored [key][state]: b0 = (k t, key g)
        const float* b0 = bs + g * SSD_RA + 8 * kk + t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            split_tf32_int(b0[8 * j * SSD_RA], bh[j][0], bl[j][0]);
            split_tf32_int(b0[8 * j * SSD_RA + 4], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
    }
    float* out = cb + (((long long)grp * nc + c) * qp + SSD_T * ti
                       + 16 * warp) * qp + SSD_T * tj;
    ssd_store(out, qp, 16, SSD_T, acc, g, t, true);
}

// (b) the state of one (lane, chunk) alone, (B * exp(cl_Q - cl))^T x, and
// the chunk's decay exp(cl_Q); blockIdx.x = lane * nc + chunk.  Warp
// w owns state rows [32 (w & 1), + 32) and depth steps 2 (w >> 1), + 1 of
// each 32-key slice; the two halves of the sum meet in shared memory
__global__ void __launch_bounds__(SSD_THREADS)
ssd_states_kernel(const float* __restrict__ xbar, const float* __restrict__ la,
                  const float* __restrict__ bm, float* __restrict__ states,
                  float* __restrict__ decay, int s, int p, int n, int q,
                  int nc, int heads, int vec4)
{
    extern __shared__ __align__(16) float ssd_smem[];
    float* bs = ssd_smem;                   // 2 stages x SSD_KT x SSD_RB
    float* xs = bs + 2 * SSD_KT * SSD_RB;   // 2 stages x SSD_KT x SSD_RB
    float* tl = xs + 2 * SSD_KT * SSD_RB;   // SSD_MAXQ: cl, then the tail

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long ln = blockIdx.x / nc;
    const int c = (int)(blockIdx.x - ln * nc);
    const int t0 = c * q, len = min(q, s - t0);
    const float* xl = xbar + (ln * s + t0) * p;
    const float* bl = bm + ((ln / heads) * s + t0) * n;
    const int n_ks = (len + SSD_KT - 1) / SSD_KT;
    const int r0 = 32 * (warp & 1), kh = warp >> 1;

    for (int st = 0; st < 2; ++st) {
        ssd_zero_cols(bs + st * SSD_KT * SSD_RB, SSD_RB, SSD_KT, n, SSD_T);
        ssd_zero_cols(xs + st * SSD_KT * SSD_RB, SSD_RB, SSD_KT, p, SSD_T);
    }
    ssd_copy(bs, SSD_RB, bl, n, SSD_KT, len, n, vec4);
    ssd_copy(xs, SSD_RB, xl, p, SSD_KT, len, p, vec4);
    cp_async_commit();
    if (warp == 0) ssd_cumsum(la + ln * s + t0, len, tl);
    __syncthreads();
    const float cl_last = tl[len - 1];
    __syncthreads();                        // every thread has cl_last
    for (int i = tid; i < SSD_MAXQ; i += SSD_THREADS)
        tl[i] = i < len ? expf(cl_last - tl[i]) : 0.f;
    if (tid == 0) decay[ln * nc + c] = expf(cl_last);

    float acc[2][8][4] = {};
    const bool rows = r0 < n;               // this warp's state rows exist
    for (int ks = 0; ks < n_ks; ++ks) {
        const int stage = ks & 1;
        if (ks + 1 < n_ks) {
            const int k1 = SSD_KT * (ks + 1);
            ssd_copy(bs + (stage ^ 1) * SSD_KT * SSD_RB, SSD_RB,
                     bl + (long long)k1 * n, n, SSD_KT, len - k1, n, vec4);
            ssd_copy(xs + (stage ^ 1) * SSD_KT * SSD_RB, SSD_RB,
                     xl + (long long)k1 * p, p, SSD_KT, len - k1, p, vec4);
        }
        cp_async_commit();                  // possibly empty: uniform wait
        cp_async_wait_1();
        __syncthreads();                    // the slice (and the tail) landed
        if (rows) {
            const float* bt = bs + stage * SSD_KT * SSD_RB;
            const float* xt = xs + stage * SSD_KT * SSD_RB;
            const float* tk = tl + SSD_KT * ks;
#pragma unroll
            for (int kq = 0; kq < 2; ++kq) {
                const int kk = 2 * kh + kq;
                if (SSD_KT * ks + 8 * kk >= len) break;
                // A = (B * tail)^T, stored [key][state]: a0 = (state g,
                // key t)
                const float* a0 = bt + (8 * kk + t) * SSD_RB + r0 + g;
                const float tk0 = tk[8 * kk + t], tk1 = tk[8 * kk + t + 4];
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    split_tf32_int(a0[16 * m] * tk0, ah[m][0], al[m][0]);
                    split_tf32_int(a0[16 * m + 8] * tk0, ah[m][1], al[m][1]);
                    split_tf32_int(a0[4 * SSD_RB + 16 * m] * tk1, ah[m][2],
                               al[m][2]);
                    split_tf32_int(a0[4 * SSD_RB + 16 * m + 8] * tk1, ah[m][3],
                               al[m][3]);
                }
                ssd_mma_row<2>(acc, ah, al, xt, kk, g, t);
            }
        }
        __syncthreads();                    // the stage is free to refill
    }
    cp_async_wait_0();
    // the depth halves meet: warps 2, 3 hand theirs to warps 0, 1 through
    // the ring, lane-minor (conflict-free), and those add and store
    float* red = ssd_smem + (warp & 1) * 64 * 32 + lane;
    if (kh == 1 && rows) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    red[((m * 8 + j) * 4 + e) * 32] = acc[m][j][e];
    }
    __syncthreads();
    if (kh == 0 && rows) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[m][j][e] += red[((m * 8 + j) * 4 + e) * 32];
            if (r0 + 16 * m < n)
                ssd_store(states + ((ln * nc + c) * n + r0 + 16 * m) * p, p,
                          n - r0 - 16 * m, p, acc[m], g, t, (p & 1) == 0);
        }
    }
}

// (c) the state entering each chunk, in place over the chunks' own states,
// and the final state; one thread per (lane, V state entries), V = 4
// (float4) when N P % 4 == 0; blockIdx.x = lane, blockIdx.y = block of
// entries.  Eight chunks' loads are in flight at once
__device__ __forceinline__ float ssd_axpy(float a, float x, float y)
{
    return a * x + y;
}
__device__ __forceinline__ float4 ssd_axpy(float a, float4 x, float4 y)
{
    return make_float4(a * x.x + y.x, a * x.y + y.y, a * x.z + y.z,
                       a * x.w + y.w);
}

template <typename V>
__global__ void __launch_bounds__(SSD_PASS_THREADS)
ssd_pass_kernel(V* __restrict__ states, const float* __restrict__ decay,
                V* __restrict__ state_out, int nv, int nc)
{
    constexpr int PF = 8;
    const int idx = blockIdx.y * SSD_PASS_THREADS + threadIdx.x;
    if (idx >= nv) return;
    const long long ln = blockIdx.x;
    V* st = states + ln * nc * nv + idx;
    const float* dl = decay + ln * nc;
    V run = {};
    for (int c0 = 0; c0 < nc; c0 += PF) {
        V local[PF];
        float d[PF];
#pragma unroll
        for (int u = 0; u < PF; ++u)
            if (c0 + u < nc) {
                local[u] = st[(long long)(c0 + u) * nv];
                d[u] = dl[c0 + u];
            }
#pragma unroll
        for (int u = 0; u < PF; ++u)
            if (c0 + u < nc) {
                st[(long long)(c0 + u) * nv] = run;
                run = ssd_axpy(d[u], run, local[u]);
            }
    }
    state_out[ln * nv + idx] = run;
}

// (d) the outputs of one (lane, chunk, 128-row tile): first exp(cl_i) C_i
// S_c from the state entering the chunk (slices of 32 state rows), then
// W x over the 32-key slices up to the tile's last row, W = C B^T from (a)
// decayed and masked in float32.  Warp w owns rows [32 w, + 32) of the
// tile.  One 1-D grid, the tiles with the most key slices first
__global__ void __launch_bounds__(SSD_THREADS)
ssd_out_kernel(const float* __restrict__ xbar, const float* __restrict__ la,
               const float* __restrict__ cm, const float* __restrict__ cb,
               const float* __restrict__ states, float* __restrict__ y,
               int bh, int s, int p, int n, int q, int qp, int nc, int heads,
               int vec4)
{
    extern __shared__ __align__(16) float ssd_smem[];
    float* as = ssd_smem;                   // 2 stages x SSD_RT x SSD_RK
    float* bs = as + 2 * SSD_RT * SSD_RK;   // 2 stages x SSD_KT x SSD_RB
    float* cl = bs + 2 * SSD_KT * SSD_RB;   // SSD_MAXQ

    const int nsub = (qp + SSD_RT - 1) / SSD_RT;
    const long long items = (long long)bh * nc;
    const int sub = nsub - 1 - (int)(blockIdx.x / items);
    const long long item = blockIdx.x - (long long)(nsub - 1 - sub) * items;
    const long long ln = item / nc;
    const int c = (int)(item - ln * nc);
    const int t0 = c * q, len = min(q, s - t0), ib = SSD_RT * sub;
    if (ib >= len) return;                  // past a ragged chunk's end

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long grp = ln / heads;
    const int n_rows = min(SSD_RT, len - ib);
    const float* xl = xbar + (ln * s + t0) * p;
    const float* cml = cm + (grp * s + t0 + ib) * n;
    const float* stl = states + (ln * nc + c) * n * p;
    const float* cbl = cb + ((grp * nc + c) * qp + ib) * qp;
    const int n_cs = (n + SSD_KT - 1) / SSD_KT;         // C S slices
    const int n_items = n_cs + (ib + n_rows + SSD_KT - 1) / SSD_KT;

    auto fetch = [&](int it, int stage) {
        float* a = as + stage * SSD_RT * SSD_RK;
        float* b = bs + stage * SSD_KT * SSD_RB;
        if (it < n_cs) {
            const int k0 = SSD_KT * it;
            ssd_copy(a, SSD_RK, cml + k0, n, SSD_RT, n_rows,
                     min(SSD_KT, n - k0), vec4);
            ssd_copy(b, SSD_RB, stl + (long long)k0 * p, p, SSD_KT, n - k0,
                     p, vec4);
        } else {
            const int kb = SSD_KT * (it - n_cs);
            ssd_copy(a, SSD_RK, cbl + kb, qp, SSD_RT, n_rows, SSD_KT, true);
            ssd_copy(b, SSD_RB, xl + (long long)kb * p, p, SSD_KT, len - kb,
                     p, vec4);
        }
    };
    // C's columns past N in the stages its slices take first; x's and S's
    // columns past P in both
    for (int st = 0; st < 2; ++st) {
        if (st < n_cs)
            ssd_zero_cols(as + st * SSD_RT * SSD_RK, SSD_RK, SSD_RT,
                          min(SSD_KT, n - SSD_KT * st), SSD_KT);
        ssd_zero_cols(bs + st * SSD_KT * SSD_RB, SSD_RB, SSD_KT, p, SSD_T);
    }
    fetch(0, 0);
    cp_async_commit();
    if (warp == 0) ssd_cumsum(la + ln * s + t0, len, cl);

    const int r0 = 32 * warp;               // this warp's rows in the tile
    const int row_lo = ib + r0, row_hi = ib + r0 + 31;  // chunk positions
    const bool rows = row_lo < len;
    float acc[2][8][4] = {};
    float cli[2][2] = {};
    for (int it = 0; it < n_items; ++it) {
        const int stage = it & 1;
        if (it + 1 < n_items) fetch(it + 1, stage ^ 1);
        cp_async_commit();                  // possibly empty: uniform wait
        cp_async_wait_1();
        __syncthreads();                    // the slice (and cl) landed
        const float* at = as + stage * SSD_RT * SSD_RK;
        const float* bt = bs + stage * SSD_KT * SSD_RB;
        const float* a0 = at + (r0 + g) * SSD_RK + t;
        if (rows && it < n_cs) {
            // C S: A = C's columns [32 it, + 32), B = S's rows
#pragma unroll
            for (int kk = 0; kk < SSD_KT / 8; ++kk) {
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split_tf32_int(a0[(16 * m + 8 * (e & 1)) * SSD_RK
                                      + 8 * kk + 4 * (e >> 1)],
                                   ah[m][e], al[m][e]);
                ssd_mma_row<2>(acc, ah, al, bt, kk, g, t);
            }
            if (it == n_cs - 1) {           // times exp(cl_i)
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        cli[m][h] = cl[row_lo + 16 * m + g + 8 * h];
                        const float e = expf(cli[m][h]);
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            acc[m][j][2 * h] *= e;
                            acc[m][j][2 * h + 1] *= e;
                        }
                    }
            }
        } else if (rows) {
            const int kb = SSD_KT * (it - n_cs);
            // depth steps holding a key at or before this warp's last row,
            // and whether some key of the slice lies past some row
            const int ksteps = kb > row_hi ? 0
                : min(SSD_KT / 8, (row_hi - kb) / 8 + 1);
            const bool mask = kb + SSD_KT - 1 > row_lo;
            for (int kk = 0; kk < ksteps; ++kk) {
                const int kj = kb + 8 * kk + t;
                const float clj[2] = {cl[kj], cl[kj + 4]};
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        // a0..a3: (g, t), (g + 8, t), (g, t + 4), (g + 8,
                        // t + 4)
                        const int dr = 16 * m + 8 * (e & 1);
                        const int dk = 4 * (e >> 1);
                        const float sc = a0[dr * SSD_RK + 8 * kk + dk];
                        const float d = fminf(fmaxf(
                            cli[m][e & 1] - clj[e >> 1], -60.f), 0.f);
                        const float wv = (!mask || kj + dk <= row_lo + g + dr)
                            ? sc * expf(d) : 0.f;
                        split_tf32_int(wv, ah[m][e], al[m][e]);
                    }
                ssd_mma_row<2>(acc, ah, al, bt, kk, g, t);
            }
        }
        __syncthreads();                    // the stage is free to refill
    }
    cp_async_wait_0();
    if (rows) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
            if (row_lo + 16 * m < len)
                ssd_store(y + (ln * s + t0 + row_lo + 16 * m) * p, p,
                          len - row_lo - 16 * m, p, acc[m], g, t,
                          (p & 1) == 0);
    }
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

// the SSD scan in four launches, (a)-(d) above, on the scratch the wrapper
// allocates: cb (BH / heads, nc, Qp, Qp), states (BH, nc, N, P) and decay
// (BH, nc), nc = ceil(S / Q), Qp = Q rounded up to 64.  N, P <= 64, Q <= 256,
// and the largest grid, (d)'s BH nc ceil(Qp / 128) blocks on x, under 2^31
extern "C" int repro_ssd_scan(const void* xbar, const void* la,
                              const void* bm, const void* cm, void* y,
                              void* state, void* cb, void* states,
                              void* decay, int bh, int s, int p, int n,
                              int q, int heads, void* stream)
{
    if (n < 1 || n > SSD_T || p < 1 || p > SSD_T || q < 1 || q > SSD_MAXQ
        || heads < 1 || bh % heads != 0)
        return (int)cudaErrorInvalidValue;
    const int nc = (s + q - 1) / q, qp = (q + SSD_T - 1) / SSD_T * SSD_T;
    const int nsub = qp / SSD_T, n_rt = (qp + SSD_RT - 1) / SSD_RT;
    if ((long long)bh * nc * n_rt >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    static size_t granted_states = 0, granted_out = 0;
    cudaError_t err = allow_smem(ssd_states_kernel, SSD_STATES_SMEM,
                                 &granted_states);
    if (err == cudaSuccess)
        err = allow_smem(ssd_out_kernel, SSD_OUT_SMEM, &granted_out);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec4 = n % 4 == 0 && p % 4 == 0
        && (((uintptr_t)xbar | (uintptr_t)bm | (uintptr_t)cm
             | (uintptr_t)states) & 15) == 0;
    const float* xf = (const float*)xbar;
    const float* laf = (const float*)la;
    ssd_scores_kernel<<<dim3((bh / heads) * nc, nsub * (nsub + 1) / 2),
                        SSD_THREADS, 0, st>>>(
        (const float*)bm, (const float*)cm, (float*)cb, s, n, q, qp, nc,
        (int)vec4);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_states_kernel<<<(unsigned)((long long)bh * nc), SSD_THREADS,
                        SSD_STATES_SMEM, st>>>(
        xf, laf, (const float*)bm, (float*)states, (float*)decay, s, p, n, q,
        nc, heads, (int)vec4);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int np = n * p;
    if (np % 4 == 0 && (((uintptr_t)states | (uintptr_t)state) & 15) == 0)
        ssd_pass_kernel<float4><<<dim3(bh, (np / 4 + SSD_PASS_THREADS - 1)
                                           / SSD_PASS_THREADS),
                                  SSD_PASS_THREADS, 0, st>>>(
            (float4*)states, (const float*)decay, (float4*)state, np / 4,
            nc);
    else
        ssd_pass_kernel<float><<<dim3(bh, (np + SSD_PASS_THREADS - 1)
                                          / SSD_PASS_THREADS),
                                 SSD_PASS_THREADS, 0, st>>>(
            (float*)states, (const float*)decay, (float*)state, np, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_out_kernel<<<(unsigned)((long long)bh * nc * n_rt), SSD_THREADS,
                     SSD_OUT_SMEM, st>>>(
        xf, laf, (const float*)cm, (const float*)cb, (const float*)states,
        (float*)y, bh, s, p, n, q, qp, nc, heads, (int)vec4);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
