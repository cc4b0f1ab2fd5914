// Truncated-DFT stages of the FNO Fourier block, shared by its forward (K4,
// fno_block.cu) and its backward (K6, fno_block_bwd.cu). Each source that
// includes this header compiles its own copy.
//
// Layouts: an activation is [B, W, V, nx, ny]; a spectrum is
// [B, V, W, m2, K] with K = 2*m1 kept x-frequencies (low then high); the
// spectral weights are [W_in, W_out, V, m2, K]. All float32 with FMA.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---- forward truncated DFT of one plane -------------------------------------
// One CUDA block per (b, channel, v) plane of `in`: the plane (40 KB at
// 100x100) is staged in shared memory, transformed along y against the
// [ny, m2] tables (ty_c, ty_s), then along x against the [nx, K] tables
// (tx_c, tx_s):
//   yr = plane @ ty_c,  yi = plane @ ty_s                       [nx, m2]
//   zr = yr^T tx_c - yi^T tx_s,  zi = yr^T tx_s + yi^T tx_c     [m2, K]
// K4 runs it with (cy, sy, cx, sx); K6 runs the adjoint of the inverse
// transform through it with (iyc^T, iys^T, cx, sx). Grid B*W*V, dynamic
// shared memory (nx*ny + 2*nx*m2) floats.
__global__ void dft_fwd_kernel(const float* __restrict__ in, const float* __restrict__ ty_c,
                               const float* __restrict__ ty_s, const float* __restrict__ tx_c,
                               const float* __restrict__ tx_s, float* __restrict__ zr,
                               float* __restrict__ zi, int W, int V, int nx, int ny, int m2,
                               int K) {
    extern __shared__ float smem[];
    float* plane = smem;             // [nx, ny]
    float* yr = plane + nx * ny;     // [nx, m2]
    float* yi = yr + nx * m2;

    const int p = blockIdx.x;        // (b*W + c)*V + v, the plane's index in `in`
    const float* xp = in + (long long)p * nx * ny;
    for (int i = threadIdx.x; i < nx * ny; i += blockDim.x) plane[i] = xp[i];
    __syncthreads();

    for (int i = threadIdx.x; i < nx * m2; i += blockDim.x) {
        const int row = i / m2, m = i % m2;
        const float* r = plane + row * ny;
        float ar = 0.0f, ai = 0.0f;
        for (int y = 0; y < ny; ++y) {
            const float val = r[y];
            ar += val * __ldg(ty_c + y * m2 + m);
            ai += val * __ldg(ty_s + y * m2 + m);
        }
        yr[i] = ar;
        yi[i] = ai;
    }
    __syncthreads();

    const int v = p % V, c = (p / V) % W, b = p / (V * W);
    const long long base = (((long long)b * V + v) * W + c) * m2 * K;
    for (int i = threadIdx.x; i < m2 * K; i += blockDim.x) {
        const int m = i / K, k = i % K;
        float ar = 0.0f, ai = 0.0f;
        for (int row = 0; row < nx; ++row) {
            const float re = yr[row * m2 + m], im = yi[row * m2 + m];
            const float cv = __ldg(tx_c + row * K + k), sv = __ldg(tx_s + row * K + k);
            ar += re * cv - im * sv;
            ai += re * sv + im * cv;
        }
        zr[base + i] = ar;
        zi[base + i] = ai;
    }
}

inline cudaError_t launch_dft_fwd(const float* in, const float* ty_c, const float* ty_s,
                                  const float* tx_c, const float* tx_s, float* zr, float* zi,
                                  int B, int W, int V, int nx, int ny, int m2, int K,
                                  cudaStream_t s) {
    const size_t smem = sizeof(float) * ((size_t)nx * ny + 2 * (size_t)nx * m2);
    cudaError_t err = allow_smem(dft_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    dft_fwd_kernel<<<(unsigned)B * W * V, kThreads, smem, s>>>(in, ty_c, ty_s, tx_c, tx_s, zr, zi,
                                                               W, V, nx, ny, m2, K);
    return cudaGetLastError();
}

// ---- per-mode complex channel mix -------------------------------------------
// m[b,v,o,j] = sum_i z[b,v,i,j] * w[i,o,v,j] (complex), j = (m, k) of m2*K.
__global__ void spectral_mix_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                                    const float* __restrict__ wr, const float* __restrict__ wi,
                                    float* __restrict__ mr, float* __restrict__ mi, int B,
                                    int W, int V, int mk) {
    const long long total = (long long)B * V * W * mk;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int j = (int)(idx % mk);
        const int o = (int)((idx / mk) % W);
        const long long bv = idx / ((long long)mk * W);   // b*V + v
        const int v = (int)(bv % V);
        const float* zr_bv = zr + bv * W * mk + j;
        const float* zi_bv = zi + bv * W * mk + j;
        float ar = 0.0f, ai = 0.0f;
        for (int i = 0; i < W; ++i) {
            const float a = zr_bv[(long long)i * mk], b = zi_bv[(long long)i * mk];
            const long long w = (((long long)i * W + o) * V + v) * mk + j;
            const float c = __ldg(wr + w), d = __ldg(wi + w);
            ar = ar + a * c - b * d;
            ai = ai + a * d + b * c;
        }
        mr[idx] = ar;
        mi[idx] = ai;
    }
}

// Blocks of kThreads for a grid-stride loop over `total` items.
inline unsigned grid_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    return (unsigned)(blocks > 65535 ? 65535 : (blocks < 1 ? 1 : blocks));
}

inline cudaError_t launch_spectral_mix(const float* zr, const float* zi, const float* wr,
                                       const float* wi, float* mr, float* mi, int B, int W, int V,
                                       int mk, cudaStream_t s) {
    spectral_mix_kernel<<<grid_for((long long)B * V * W * mk), kThreads, 0, s>>>(
        zr, zi, wr, wi, mr, mi, B, W, V, mk);
    return cudaGetLastError();
}

// ---- inverse x transform of one row ------------------------------------------
// For grid row `row`, the [W, m2] inverse-x values of a [W, m2, K] spectrum
// (sr, si), written to shared memory (vr, vi):
//   vr[c, m] = sum_k sr[c,m,k] cxT[k,row] + si[c,m,k] sxT[k,row]
//   vi[c, m] = sum_k si[c,m,k] cxT[k,row] - sr[c,m,k] sxT[k,row]
// Every thread of the block takes part; the caller synchronises after.
__device__ __forceinline__ void inverse_x_row(const float* __restrict__ sr,
                                              const float* __restrict__ si,
                                              const float* __restrict__ cxT,
                                              const float* __restrict__ sxT, float* vr, float* vi,
                                              int W, int m2, int K, int nx, int row) {
    for (int i = threadIdx.x; i < W * m2; i += blockDim.x) {   // i = c*m2 + m
        float ar = 0.0f, ai = 0.0f;
        for (int k = 0; k < K; ++k) {
            const float re = sr[i * K + k], im = si[i * K + k];
            const float c = __ldg(cxT + k * nx + row), s = __ldg(sxT + k * nx + row);
            ar += re * c + im * s;
            ai += im * c - re * s;
        }
        vr[i] = ar;
        vi[i] = ai;
    }
}

}  // namespace
