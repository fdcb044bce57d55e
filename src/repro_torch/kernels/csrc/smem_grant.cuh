// The dynamic shared memory a kernel may use beyond the 48 KB default,
// granted per device: cudaFuncSetAttribute acts on the current device
// only, so a grant remembered once for the process would let the first
// launch on a second card skip its own grant and fail.  Each library
// includes this header (kernels/build.py; the library store's key hashes
// the headers beside each source).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// device ordinals a grant is remembered for
constexpr int SMEM_GRANT_DEVICES = 64;

// the bytes one kernel has been granted, by device ordinal
struct SmemGrant {
    size_t bytes[SMEM_GRANT_DEVICES] = {};
};

// opt ``kernel`` into ``bytes`` of dynamic shared memory on the current
// device, once per device and size
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, SmemGrant* grant)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= SMEM_GRANT_DEVICES) return cudaErrorInvalidDevice;
    if (bytes <= grant->bytes[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) grant->bytes[dev] = bytes;
    return err;
}

}  // namespace
