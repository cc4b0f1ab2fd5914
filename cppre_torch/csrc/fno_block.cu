// FNO2d inference kernels for Hopper (sm_90a): the Fourier block (K4) and
// the projection head (K5).
//
// Replaces the Pallas kernels of cppre/ops/pallas/fno_block.py:
//   K4  fno_block2d_fused: gelu(mlp(spectral(x)) + w(x) + b(grid)) for one
//       block, x [B, W, V, Nx, Ny] -> same shape.
//   K5  projection2d_fused: fc1 -> exact gelu -> fc2 per pixel,
//       z [B, V, Nx, Ny, W] -> [B, V, Nx, Ny, step].
//
// K4. The TPU kernel keeps one (sample, variable) plane of all W channels in
// VMEM, [W, Nx, Ny] (~640 KB at W=16 on a 100x100 grid). A Hopper block has
// at most 227 KB of shared memory, so the block is cut into three launches
// that each fit, all in float32 with FMA (no TF32, no tensor cores: the
// JAX package pins Precision.HIGHEST on this path):
//   1. dft_fwd_kernel, one CUDA block per (b, channel, v) plane: the plane
//      (40 KB at 100x100) is staged in shared memory, transformed along y
//      against the [Ny, m2] cos/sin tables, then along x against the
//      [Nx, K] tables for the K = 2*m1 kept frequencies (low then high).
//   2. spectral_mix_kernel: the per-mode complex channel mix over W inputs,
//      on [B, V, W, m2, K] (tiny).
//   (Stages 1 and 2 live in fno_dft.cuh: the backward, K6, runs them too.)
//   3. fno_block_out_kernel, one CUDA block per (b, v, x) row: the inverse x
//      transform of that row's modes into shared memory, then one thread
//      per pixel does the inverse y transform (Hermitian weights folded into
//      the tables), the channel MLP with exact gelu, the 1x1 bypass, the
//      precomputed bias branch x3 and the final gelu, and writes the output.
// The tables are built in float64 and stored in float32, as the JAX
// package's _dft_tables builds them. Bounded by memory (x read twice,
// out written once) and by the ~1.3k FMAs per pixel of stage 3.
//
// K5. One thread per pixel: the W inputs sit in registers, fc1 [256, W] and
// fc2 [step, 256] in shared memory (~17 KB), and the 256-wide hidden vector
// is consumed one unit at a time, so the [B, V, Nx, Ny, 256] activation that
// the plain version materialises (~3 GB at the NS flagship) never exists.
// Bounded by the 256 erf evaluations and ~4.4k flops per pixel.
//
// Every pixel's result depends only on its own sample, in a fixed order of
// operations, so the output of a sample does not depend on the batch size.

#include "fno_dft.cuh"

namespace {

// ---- K4 stage 3: inverse DFT + channel MLP + bypass + bias + gelu ----------
// One block per (b, v, x) row; threads along y. a1 [W, W] (mlp1, out x in),
// a2 [W, W] (mlp2), aw [W, W] (bypass); x3 [1, W, V, Nx, Ny].
template <int W>
__global__ void fno_block_out_kernel(const float* __restrict__ x, const float* __restrict__ x3,
                                     const float* __restrict__ mr, const float* __restrict__ mi,
                                     const float* __restrict__ cxT, const float* __restrict__ sxT,
                                     const float* __restrict__ iyc, const float* __restrict__ iys,
                                     const float* __restrict__ a1, const float* __restrict__ b1,
                                     const float* __restrict__ a2, const float* __restrict__ b2,
                                     const float* __restrict__ aw, const float* __restrict__ bw,
                                     float* __restrict__ out, int V, int nx, int ny, int m2,
                                     int K, float inv_scale) {
    extern __shared__ float smem[];
    float* s_vr = smem;              // [W, m2] inverse-x modes of this row
    float* s_vi = s_vr + W * m2;
    float* s_a1 = s_vi + W * m2;     // [W, W]
    float* s_a2 = s_a1 + W * W;
    float* s_aw = s_a2 + W * W;
    float* s_b1 = s_aw + W * W;      // [W]
    float* s_b2 = s_b1 + W;
    float* s_bw = s_b2 + W;
    float* s_iyc = s_bw + W;         // [m2, ny]
    float* s_iys = s_iyc + m2 * ny;

    const int row = blockIdx.x % nx;
    const int bv = blockIdx.x / nx;  // b*V + v
    const int v = bv % V, b = bv / V;

    for (int i = threadIdx.x; i < W * W; i += blockDim.x) {
        s_a1[i] = a1[i];
        s_a2[i] = a2[i];
        s_aw[i] = aw[i];
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        s_b1[i] = b1[i];
        s_b2[i] = b2[i];
        s_bw[i] = bw[i];
    }
    for (int i = threadIdx.x; i < m2 * ny; i += blockDim.x) {
        s_iyc[i] = iyc[i];
        s_iys[i] = iys[i];
    }
    inverse_x_row(mr + (long long)bv * W * m2 * K, mi + (long long)bv * W * m2 * K, cxT, sxT,
                  s_vr, s_vi, W, m2, K, nx, row);
    __syncthreads();

    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;               // channel stride
    const long long pix0 = (long long)v * plane + (long long)row * ny;
    const float* xb = x + (long long)b * W * chan + pix0;
    const float* x3b = x3 + pix0;
    float* ob = out + (long long)b * W * chan + pix0;

    for (int y = threadIdx.x; y < ny; y += blockDim.x) {
        float spec[W], xin[W], h[W];
#pragma unroll
        for (int o = 0; o < W; ++o) {
            float acc = 0.0f;
            for (int m = 0; m < m2; ++m)
                acc += s_vr[o * m2 + m] * s_iyc[m * ny + y] + s_vi[o * m2 + m] * s_iys[m * ny + y];
            spec[o] = acc * inv_scale;
        }
#pragma unroll
        for (int i = 0; i < W; ++i) xin[i] = xb[i * chan + y];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            float acc = s_b1[j];
#pragma unroll
            for (int o = 0; o < W; ++o) acc += s_a1[j * W + o] * spec[o];
            h[j] = gelu_exact(acc);
        }
#pragma unroll
        for (int c = 0; c < W; ++c) {
            float x1 = s_b2[c];
#pragma unroll
            for (int j = 0; j < W; ++j) x1 += s_a2[c * W + j] * h[j];
            float x2 = s_bw[c];
#pragma unroll
            for (int i = 0; i < W; ++i) x2 += s_aw[c * W + i] * xin[i];
            ob[c * chan + y] = gelu_exact(x1 + x2 + x3b[c * chan + y]);
        }
    }
}

// ---- K5: projection head -----------------------------------------------------
// z [npix, W]; a1 [wp, W]; b1 [wp]; a2 [step, wp]; b2 [step]; out [npix, step].
constexpr int kMaxStep = 8;

template <int W>
__global__ void projection_kernel(const float* __restrict__ z, const float* __restrict__ a1,
                                  const float* __restrict__ b1, const float* __restrict__ a2,
                                  const float* __restrict__ b2, float* __restrict__ out,
                                  long long npix, int wp, int step) {
    extern __shared__ float smem[];
    float* s_a1 = smem;              // [wp, W]
    float* s_b1 = s_a1 + wp * W;     // [wp]
    float* s_a2 = s_b1 + wp;         // [step, wp]
    float* s_b2 = s_a2 + step * wp;  // [step]
    for (int i = threadIdx.x; i < wp * W; i += blockDim.x) s_a1[i] = a1[i];
    for (int i = threadIdx.x; i < wp; i += blockDim.x) s_b1[i] = b1[i];
    for (int i = threadIdx.x; i < step * wp; i += blockDim.x) s_a2[i] = a2[i];
    for (int i = threadIdx.x; i < step; i += blockDim.x) s_b2[i] = b2[i];
    __syncthreads();

    for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x; pix < npix;
         pix += (long long)gridDim.x * blockDim.x) {
        float zin[W];
        const float* zp = z + pix * W;
#pragma unroll
        for (int i = 0; i < W; ++i) zin[i] = __ldg(zp + i);
        float acc[kMaxStep];
#pragma unroll
        for (int s = 0; s < kMaxStep; ++s) acc[s] = 0.0f;
        for (int j = 0; j < wp; ++j) {
            float pre = s_b1[j];
#pragma unroll
            for (int i = 0; i < W; ++i) pre += s_a1[j * W + i] * zin[i];
            const float h = gelu_exact(pre);
#pragma unroll
            for (int s = 0; s < kMaxStep; ++s)
                if (s < step) acc[s] += h * s_a2[s * wp + j];
        }
        float* op = out + pix * step;
#pragma unroll
        for (int s = 0; s < kMaxStep; ++s)
            if (s < step) op[s] = acc[s] + s_b2[s];
    }
}

template <int W>
cudaError_t launch_block_out(const float* x, const float* x3, const float* mr, const float* mi,
                             const float* cxT, const float* sxT, const float* iyc,
                             const float* iys, const float* a1, const float* b1,
                             const float* a2, const float* b2, const float* aw,
                             const float* bw, float* out, int B, int V, int nx, int ny, int m2,
                             int K, float inv_scale, cudaStream_t s) {
    const size_t smem = sizeof(float) * (2 * W * m2 + 3 * W * W + 3 * W + 2 * m2 * ny);
    cudaError_t err = allow_smem(fno_block_out_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    const int threads = ny < 128 ? ((ny + 31) / 32) * 32 : 128;
    fno_block_out_kernel<W><<<(unsigned)B * V * nx, threads, smem, s>>>(
        x, x3, mr, mi, cxT, sxT, iyc, iys, a1, b1, a2, b2, aw, bw, out, V, nx, ny, m2, K,
        inv_scale);
    return cudaGetLastError();
}

template <int W>
cudaError_t launch_projection(const float* z, const float* a1, const float* b1, const float* a2,
                              const float* b2, float* out, long long npix, int wp, int step,
                              int n_sm, cudaStream_t s) {
    const size_t smem = sizeof(float) * (wp * W + wp + step * wp + step);
    cudaError_t err = allow_smem(projection_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    long long blocks = (npix + kThreads - 1) / kThreads;
    const long long cap = 4LL * n_sm;   // grid-stride: load the weights fewer times
    if (blocks > cap) blocks = cap;
    projection_kernel<W><<<(unsigned)blocks, kThreads, smem, s>>>(z, a1, b1, a2, b2, out, npix,
                                                                 wp, step);
    return cudaGetLastError();
}

int sm_count() {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
}

}  // namespace

// One Fourier block forward; W must be a width the register-resident stage
// is compiled for (4, 8, 16, 32: KERNEL_WIDTHS in ops/kernels/fno_block.py). zr/zi/mr/mi are [B, V, W, m2, K] scratch.
CPPRE_EXPORT int cppre_fno_block2d_fwd(const void* x, const void* x3, const void* wr,
                                       const void* wi, const void* a1, const void* b1,
                                       const void* a2, const void* b2, const void* aw,
                                       const void* bw, const void* cy, const void* sy,
                                       const void* cx, const void* sx, const void* cxT,
                                       const void* sxT, const void* iyc, const void* iys,
                                       void* zr, void* zi, void* mr, void* mi, void* out, int B,
                                       int W, int V, int nx, int ny, int m2, int K,
                                       float inv_scale, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = launch_dft_fwd((const float*)x, (const float*)cy, (const float*)sy,
                                     (const float*)cx, (const float*)sx, (float*)zr, (float*)zi,
                                     B, W, V, nx, ny, m2, K, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_spectral_mix((const float*)zr, (const float*)zi, (const float*)wr,
                              (const float*)wi, (float*)mr, (float*)mi, B, W, V, m2 * K, s);
    if (err != cudaSuccess) return (int)err;

#define CPPRE_BLOCK_OUT(WW)                                                                      \
    launch_block_out<WW>((const float*)x, (const float*)x3, (const float*)mr, (const float*)mi, \
                         (const float*)cxT, (const float*)sxT, (const float*)iyc,               \
                         (const float*)iys, (const float*)a1, (const float*)b1,                 \
                         (const float*)a2, (const float*)b2, (const float*)aw,                  \
                         (const float*)bw, (float*)out, B, V, nx, ny, m2, K, inv_scale, s)
    switch (W) {
        case 4: return (int)CPPRE_BLOCK_OUT(4);
        case 8: return (int)CPPRE_BLOCK_OUT(8);
        case 16: return (int)CPPRE_BLOCK_OUT(16);
        case 32: return (int)CPPRE_BLOCK_OUT(32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CPPRE_BLOCK_OUT
}

// Projection head; npix = B*V*Nx*Ny.
CPPRE_EXPORT int cppre_projection2d_fwd(const void* z, const void* a1, const void* b1,
                                        const void* a2, const void* b2, void* out,
                                        long long npix, int W, int wp, int step, void* stream) {
    if (step < 1 || step > kMaxStep) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_sm = sm_count();
#define CPPRE_PROJ(WW)                                                                          \
    launch_projection<WW>((const float*)z, (const float*)a1, (const float*)b1,                 \
                          (const float*)a2, (const float*)b2, (float*)out, npix, wp, step,    \
                          n_sm, s)
    switch (W) {
        case 4: return (int)CPPRE_PROJ(4);
        case 8: return (int)CPPRE_PROJ(8);
        case 16: return (int)CPPRE_PROJ(16);
        case 32: return (int)CPPRE_PROJ(32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CPPRE_PROJ
}
