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

// ---- the projection head's gelu (K5, K7) -----------------------------------
// The TPU kernel's own exact gelu (cppre/ops/pallas/fno_block.py,
// _erf32, _gelu, _dgelu): XLA's float32 rational erf, two short
// polynomials in z^2 over |z| clamped to 4, with no branch, the quotient
// clamped to [-1, 1]. The clamp saturates the tails: erf is exactly +-1 from
// |z| ~ 3.9 on, so gelu = u * Phi(u) is u, or a zero, there, as the TPU
// kernel's selects make it. Within 2.9e-6 absolute of torch's exact gelu.
__device__ __forceinline__ float proj_cdf(float u) {
    const float z = u * 0.70710678118654752440f;
    const float zc = fminf(fmaxf(z, -4.0f), 4.0f), z2 = zc * zc;
    float p = 0.00022905065861350646f, q = -1.1791602954361697e-7f;
    p = fmaf(p, z2, 0.0034082910107109506f);
    p = fmaf(p, z2, 0.050955695062380861f);
    p = fmaf(p, z2, 0.18520832239976145f);
    p = fmaf(p, z2, 1.128379143519084f);
    q = fmaf(q, z2, 2.3547966471313185e-5f);
    q = fmaf(q, z2, 0.0010179625278914885f);
    q = fmaf(q, z2, 0.014070470171167667f);
    q = fmaf(q, z2, 0.11098505178285362f);
    q = fmaf(q, z2, 0.49746925110067538f);
    q = fmaf(q, z2, 1.0f);
    return 0.5f * (1.0f + fminf(fmaxf(__fdividef(zc * p, q), -1.0f), 1.0f));
}

// gelu(u) = u * Phi(u): 0.5 is exact, so this is 0.5 * u * (1 + erf)'s bits.
__device__ __forceinline__ float proj_gelu(float u) { return u * proj_cdf(u); }

// gelu(u) and gelu'(u) = Phi(u) + u * phi(u) from one erf and one exp.
__device__ __forceinline__ void proj_gelu_and_grad(float u, float& h, float& d) {
    const float cdf = proj_cdf(u);
    h = u * cdf;
    d = cdf + u * (0.39894228040143267794f * __expf(-0.5f * u * u));
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

// The same, 16 bytes (dst and src 16-byte aligned).
__device__ __forceinline__ void copy_async16(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
#else
    for (int i = 0; i < 4; ++i) dst[i] = valid ? src[i] : 0.0f;
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
