// Hopper (sm_90a) device helpers shared by attn_bwd.cu and ssd_bwd.cu:
// mbarriers, TMA box loads, wgmma's fences and shared-memory descriptors,
// the six-pass order of a product over three-part operands, and
// cuTensorMapEncodeTiled reached through the runtime.  Each library
// includes this header and still builds on its own (kernels/build.py; the
// library store's key hashes the headers beside each source).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// an mbarrier wait that has spun this many cycles (about 10 s) traps: a
// fault in the pipeline ends the launch with an error instead of hanging
constexpr long long SPIN_CYCLES = 20000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr)
{
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    long long t0 = 0;
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                     "%2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == 0)
            t0 = clock64();
        else if ((spins & 1023) == 0 && clock64() - t0 > SPIN_CYCLES)
            __trap();
    }
}

// a box of the 3-D map (columns c0.., rows c1.., lane c2) into shared
// memory at dst, completing on the mbarrier bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t bar)
{
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global"
                 ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
                 "[%5];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
// that completes it
template <int R>
__device__ __forceinline__ void wg_hold(float (&d)[R])
{
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// a wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
        | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the parts (of A, of B) of pass n of a product over three-part operands,
// smallest first: (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)
__host__ __device__ constexpr int pass_a(int n)
{
    return n == 0 ? 2 : (n == 1 || n == 3) ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int n)
{
    return (n == 1 || n == 4) ? 1 : n == 2 ? 2 : 0;
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
EncodeTiled encoder()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                    cudaEnableDefault, &found)
                == cudaSuccess
            && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

}  // namespace
