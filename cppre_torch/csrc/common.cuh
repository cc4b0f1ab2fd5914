// Shared helpers of the cppre_torch CUDA kernels.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (see cppre_torch/ops/kernels/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o lib<name>.so <name>.cu
// Each exported function launches its kernels on the stream it is given and
// returns cudaGetLastError() as an int; the Python wrapper raises on a
// non-zero value. No kernel allocates: the wrapper passes every output and
// scratch buffer in.
#pragma once

#include <cuda_runtime.h>

#define CPPRE_EXPORT extern "C" __attribute__((visibility("default")))

// Message for a code returned by one of the exported functions.
CPPRE_EXPORT const char* cppre_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Exact gelu (approximate=False), as torch.nn.functional.gelu computes it.
__device__ __forceinline__ float gelu_exact(float u) {
    return 0.5f * u * (1.0f + erff(u * 0.70710678118654752440f));
}

// Its derivative, Phi(u) + u * phi(u), as torch's gelu backward computes it.
__device__ __forceinline__ float gelu_grad_exact(float u) {
    const float cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752440f));
    return cdf + u * (0.39894228040143267794f * expf(-0.5f * u * u));
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// ---- cp.async, 4 bytes at a time (rows need not be 16-byte aligned) -------
// A copy with valid == false writes 0 and reads nothing.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
#else
    *dst = valid ? *src : 0.0f;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}
