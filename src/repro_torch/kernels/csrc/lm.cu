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
// Both are the simple first versions: plain float32 FMA from shared
// memory, no tensor cores, no TMA.  Any Sq, Skv, S: ragged edges are masked
// here, with no padding in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v)
{
    *p = __float2bfloat16(v);
}

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
// flash_attention
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel).  One block of 256 threads per (lane, 64-query tile) stages
// the tile's queries once (scaled by 1/sqrt(D), float32) and walks the
// 64-key tiles that the causal mask and the window leave visible to any of
// its queries, so the windowed case costs O(S*W) as the TPU kernel's
// pl.when skip does.  Thread (ti, tj) = (tid / 16, tid % 16) owns query
// rows ti + 16r (r < 4): the 4 x 4 scores of keys tj + 16c, and the output
// columns tj + 16c (c < D/16).  A row's 16 threads are one half-warp, so
// the running max and sum are half-warp shuffles; the probabilities go
// through shared memory to the P V product.  Running (m, l, acc) in
// float32, masked scores are -inf (a row that has seen no key yet keeps
// m = -inf and adds nothing), the output is acc / l in q's type.
//
// Bound on an H100: at the serve path's (BH 128, S 2048, D 112) bf16
// causal it does 4 D operations per visible (query, key) pair, 120 GFLOP,
// and moves 235 MB: operations bound (0.12 ms at the 989 TFLOP/s bf16
// tensor-core rate).  This version runs on the float32 FMA pipes fed from
// shared memory (two loads per four FMAs in the score loop); tensor cores
// and TMA are a later version's.
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

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
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
    const T* ql = q + lane * sq * d;
    const T* kl = k + lane * skv * d;
    const T* vl = v + lane * skv * d;
    T* ol = o + lane * sq * d;
    const int offset = skv - sq;
    const int nq = min(FA_BQ, sq - q0);

    for (int idx = tid; idx < FA_BQ * d; idx += FA_THREADS) {
        const int r = idx / d, c = idx - r * d;
        qs[r * dp + c] = r < nq ? to_f32(ql[(long long)(q0 + r) * d + c])
                                      * scale
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
            ks[r * dp + c] = r < nk ? to_f32(kl[g]) : 0.f;
            vs[r * dp + c] = r < nk ? to_f32(vl[g]) : 0.f;
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
                store_as(&ol[(long long)(q0 + i) * d + col], acc[r][c] * inv);
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

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq,
                                     int skv, int d, int causal, int window,
                                     float scale, int is_bf16, void* stream)
{
    static size_t granted_f32 = 0, granted_bf16 = 0;
    const size_t smem = fa_smem_bytes(d);
    const dim3 grid((sq + FA_BQ - 1) / FA_BQ, bh);
    cudaError_t err;
    if (is_bf16) {
        err = allow_smem(flash_attention_kernel<__nv_bfloat16>, smem,
                         &granted_bf16);
        if (err != cudaSuccess) return (int)err;
        flash_attention_kernel<__nv_bfloat16>
            <<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
                (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq, skv, d,
                causal, window, scale);
    } else {
        err = allow_smem(flash_attention_kernel<float>, smem, &granted_f32);
        if (err != cudaSuccess) return (int)err;
        flash_attention_kernel<float>
            <<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
                (const float*)q, (const float*)k, (const float*)v, (float*)o,
                sq, skv, d, causal, window, scale);
    }
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
