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
// at most 227 KB of shared memory, so the block is four launches that each
// fit, all in float32 with FMA (no TF32, no tensor cores: the JAX package
// pins Precision.HIGHEST on this path, and Hopper's tensor cores have no
// IEEE float32 mode):
//   1. dft_fwd_kernel (fno_dft.cuh): the truncated DFT along y then x, as
//      two register-tiled products over a group of planes in shared memory;
//   2. spectral_mix_kernel: the per-mode complex channel mix over W inputs,
//      on [B, V, W, m2, K] (tiny);
//   3. inverse_x_kernel (fno_tile.cuh): the inverse x transform of the
//      mixed spectrum for every grid row, [B, V, Nx, 2*m2, W];
//   4. block_out_tile_kernel: per tile of up to 128 pixels of one plane,
//      the inverse y transform (a W x 2*m2 product), the channel MLP with
//      exact gelu, the 1x1 bypass, the precomputed bias branch x3 and the
//      final gelu, written once (fno_tile.cuh's 4 x 4 micro-tile products).
// (Stages 1, 3 and 4's building block are shared with the backward, K6.)
// What bounds it on this card: the FP32 pipe. At width 32 a pixel costs
// ~4k multiply-adds in stage 4 against 256 B of x read and out written, so
// the operations take ~3x the time of the bytes; the work is W x W (or
// W x 2*m2) matrices applied at every pixel. One thread per pixel would
// hold W-long arrays (spilling at width 32) and pay a shared load per FMA;
// the tiles keep 16 accumulators a thread and issue two float4 shared loads
// per 16 FMAs, at every width without a spill. The tables are built in
// float64 and stored in float32, as the JAX package's _dft_tables builds
// them.
//
// K5. One thread per pixel: the W inputs sit in registers, fc1 [256, W] and
// fc2 [step, 256] in shared memory (~17 KB), and the 256-wide hidden vector
// is consumed one unit at a time, so the [B, V, Nx, Ny, 256] activation that
// the plain version materialises (~3 GB at the NS flagship) never exists.
// Bounded by the 256 erf evaluations and ~4.4k flops per pixel.
//
// Every pixel's result depends only on its own sample, in a fixed order of
// operations (the tile and plane-group geometry depend on the grid alone),
// so the output of a sample does not depend on the batch size.

#include "fno_dft.cuh"
#include "fno_tile.cuh"

namespace {

// ---- K4 stage 3: inverse y + channel MLP + bypass + bias + gelu ------------
// One tile of one (b, v) plane at a time (fno_tile.cuh), 8*W threads, from
// the rows' inverse-x values vx [B, V, nx, 2*m2, W] (inverse_x_kernel):
//   spec = inverse-y of the tile rows' vx                     [W, P]
//   h    = gelu(a1 spec + b1)                                 [W, P]
//   out  = gelu(a2 h + aw x + b2 + bw + x3), written once.
// a1 [W, W] (mlp1, out x in), a2 [W, W] (mlp2), aw [W, W] (bypass), staged
// transposed (in, out) so a micro-tile reads 4 outputs as one float4;
// x3 [1, W, V, Nx, Ny].
template <int W>
__global__ void __launch_bounds__(8 * W, 1)
    block_out_tile_kernel(const float* __restrict__ x, const float* __restrict__ x3,
                          const float* __restrict__ vx, const float* __restrict__ iyc,
                          const float* __restrict__ iys, const float* __restrict__ a1,
                          const float* __restrict__ b1, const float* __restrict__ a2,
                          const float* __restrict__ b2, const float* __restrict__ aw,
                          const float* __restrict__ bw, float* __restrict__ out, int V, int nx,
                          int ny, int m2, float inv_scale, long long n_tiles) {
    constexpr int TL = W * kTileLd;
    extern __shared__ float4 smem4[];
    const TileGeom g = tile_geom(nx, ny);
    const int VL = g.rt * 2 * m2 * W;               // floats of one tile's vx rows
    float* sX = reinterpret_cast<float*>(smem4);   // [2][W, kTileLd]
    float* sS = sX + 2 * TL;                        // [W, kTileLd]
    float* sH = sS + TL;
    float* sA1T = sH + TL;                          // [W, W] (in, out)
    float* sA2T = sA1T + W * W;
    float* sAwT = sA2T + W * W;
    float* sB1 = sAwT + W * W;                      // [W]
    float* sB2 = sB1 + W;
    float* sBw = sB2 + W;
    float* sV = sBw + W;                            // [2][rt, 2*m2, W]
    float* sT = sV + 2 * VL;                        // [2*m2, ty]

    for (int i = threadIdx.x; i < W * W; i += blockDim.x) {
        const int o = i / W, k = i % W;             // a[o, k] -> sA[k, o]
        sA1T[k * W + o] = a1[i];
        sA2T[k * W + o] = a2[i];
        sAwT[k * W + o] = aw[i];
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        sB1[i] = b1[i];
        sB2[i] = b2[i];
        sBw[i] = bw[i];
    }

    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;   // channel stride
    const int c0 = 4 * (threadIdx.x >> 5), p0 = 4 * (threadIdx.x & 31);
    const bool active = p0 < g.used;
    long long t0, t1;
    tile_range(n_tiles, &t0, &t1);
    if (t0 < t1) {
        const Tile t = tile_at(t0, g);
        tile_load_async<W>(x + (t.bv / V) * W * chan + (t.bv % V) * plane, chan, nx, ny, g, t,
                           sX);
        tile_load_vx_async<W>(vx, nx, m2, g, t, sV);
    }
    copy_async_commit();
    int staged_y0 = -1;
    for (long long ti = t0; ti < t1; ++ti) {
        const int buf = (int)((ti - t0) & 1);
        const Tile t = tile_at(ti, g);
        if (ti + 1 < t1) {
            const Tile nt = tile_at(ti + 1, g);
            tile_load_async<W>(x + (nt.bv / V) * W * chan + (nt.bv % V) * plane, chan, nx, ny,
                               g, nt, sX + (buf ^ 1) * TL);
            tile_load_vx_async<W>(vx, nx, m2, g, nt, sV + (buf ^ 1) * VL);
        }
        copy_async_commit();
        if (t.y0 != staged_y0) {                    // the same for every thread of the block
            tile_y_tables(iyc, iys, ny, m2, g, t.y0, sT);
            staged_y0 = t.y0;
        }
        copy_async_wait<1>();
        __syncthreads();

        float acc[4][4];
        if (active) {                               // spec
            tile_zero(acc);
            tile_inverse_y<W>(acc, sV + buf * VL, sT, g, m2, c0, p0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(sS + (c0 + i) * kTileLd + p0) =
                    make_float4(acc[i][0] * inv_scale, acc[i][1] * inv_scale,
                                acc[i][2] * inv_scale, acc[i][3] * inv_scale);
        }
        __syncthreads();
        if (active) {                               // h
            tile_zero(acc);
            tile_mma(acc, sA1T + c0, W, sS + p0, kTileLd, W);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float b = sB1[c0 + i];
                *reinterpret_cast<float4*>(sH + (c0 + i) * kTileLd + p0) =
                    make_float4(gelu_exact(acc[i][0] + b), gelu_exact(acc[i][1] + b),
                                gelu_exact(acc[i][2] + b), gelu_exact(acc[i][3] + b));
            }
        }
        __syncthreads();
        if (active) {                               // out
            tile_zero(acc);
            tile_mma(acc, sA2T + c0, W, sH + p0, kTileLd, W);
            tile_mma(acc, sAwT + c0, W, sX + buf * TL + p0, kTileLd, W);
            const int r = p0 / g.ty, row = t.r0 + r, y = t.y0 + p0 - r * g.ty;
            if (row < nx) {
                const long long pix = (long long)row * ny + y;
                float* ob = out + (t.bv / V) * W * chan + (t.bv % V) * plane + pix;
                const float* x3b = x3 + (t.bv % V) * plane + pix;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int c = c0 + i;
                    const float b = sB2[c] + sBw[c];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (y + j < ny)
                            ob[c * chan + j] = gelu_exact(acc[i][j] + b + x3b[c * chan + j]);
                }
            }
        }
        __syncthreads();                            // the tile's buffers are free again
    }
    copy_async_wait<0>();
}

// ---- K5: projection head -----------------------------------------------------
// z [npix, W]; a1 [wp, W]; b1 [wp]; a2 [step, wp]; b2 [step]; out [npix, step].
constexpr int kMaxStep = 10;   // every FNO2d configuration of the JAX package (JOREK: 10)

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

// Blocks of K4's output stage: a function of the shape alone (at most two
// per SM of an H100 at width 32, four below, one wave).
inline long long block_out_blocks(int W, long long n_tiles) {
    const long long cap = W >= 32 ? 264 : 528;
    return n_tiles < cap ? n_tiles : cap;
}

template <int W>
cudaError_t launch_block_out(const float* x, const float* x3, const float* vx, const float* iyc,
                             const float* iys, const float* a1, const float* b1,
                             const float* a2, const float* b2, const float* aw,
                             const float* bw, float* out, int B, int V, int nx, int ny, int m2,
                             float inv_scale, cudaStream_t s) {
    const TileGeom g = tile_geom(nx, ny);
    const size_t smem = sizeof(float) * ((size_t)4 * W * kTileLd + 3 * W * W + 3 * W +
                                         tile_spec_floats(W, m2, g));
    cudaError_t err = allow_smem(block_out_tile_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    const long long n_tiles = (long long)B * V * g.per_plane;
    block_out_tile_kernel<W><<<(unsigned)block_out_blocks(W, n_tiles), 8 * W, smem, s>>>(
        x, x3, vx, iyc, iys, a1, b1, a2, b2, aw, bw, out, V, nx, ny, m2, inv_scale, n_tiles);
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

// One Fourier block forward; W must be a width the tile stage is compiled
// for (4, 8, 16, 32: KERNEL_WIDTHS in ops/kernels/fno_block.py). ty is
// [cy | sy] packed [ny, 2*m2p] (dft_fwd_kernel); zr/zi/mr/mi are
// [B, V, W, m2, K] scratch, vx [B, V, nx, 2*m2, W].
CPPRE_EXPORT int cppre_fno_block2d_fwd(const void* x, const void* x3, const void* wr,
                                       const void* wi, const void* a1, const void* b1,
                                       const void* a2, const void* b2, const void* aw,
                                       const void* bw, const void* ty, const void* cx,
                                       const void* sx, const void* cxT,
                                       const void* sxT, const void* iyc, const void* iys,
                                       void* zr, void* zi, void* mr, void* mi, void* vx,
                                       void* out, int B, int W, int V, int nx, int ny, int m2,
                                       int K, float inv_scale, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = launch_dft_fwd((const float*)x, (const float*)ty, (const float*)cx,
                                     (const float*)sx, (float*)zr, (float*)zi, B, W, V, nx, ny,
                                     m2, K, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_spectral_mix((const float*)zr, (const float*)zi, (const float*)wr,
                              (const float*)wi, (float*)mr, (float*)mi, B, W, V, m2 * K, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_inverse_x((const float*)mr, (const float*)mi, (const float*)cxT,
                           (const float*)sxT, (float*)vx, B, V, W, nx, m2, K, s);
    if (err != cudaSuccess) return (int)err;

#define CPPRE_BLOCK_OUT(WW)                                                                      \
    launch_block_out<WW>((const float*)x, (const float*)x3, (const float*)vx, (const float*)iyc, \
                         (const float*)iys, (const float*)a1, (const float*)b1,                 \
                         (const float*)a2, (const float*)b2, (const float*)aw,                  \
                         (const float*)bw, (float*)out, B, V, nx, ny, m2, inv_scale, s)
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
