// Truncated-DFT stages of the FNO Fourier block, shared by its forward (K4,
// fno_block.cu) and its backward (K6, fno_block_bwd.cu): the forward DFT
// of K4's stage 1 and K6's stages 1 and 3 (K6's stage 3 runs the adjoint
// of the inverse y transform through it), and the per-mode channel mix.
// Each source that includes this header compiles its own copy.
//
// The Pallas kernels (cppre/ops/pallas/fno_block.py) do these transforms
// as MXU matmuls against the same float32 tables, inside one kernel per
// plane. Here they are products of their own: per plane the y transform
// is [Nx, Ny] x [Ny, 2*m2] and the x transform [m2, Nx] x [Nx, 2K]
// (complex), both bounded by the FP32 pipe (a 64x64 plane at 16 modes:
// ~260k multiply-adds for 16 KB read). A thread per output would make two
// table loads per two FMAs; the tiled kernel keeps 4 x 4 micro-tiles in
// registers (4 float4 loads per 64 FMAs in the x product), groups planes
// so a block has up to 128 rows of work, and brings its inputs in with
// cp.async so their latency overlaps.
//
// Layouts: an activation is [B, W, V, nx, ny]; a spectrum is
// [B, V, W, m2, K] with K = 2*m1 kept x-frequencies (low then high); the
// spectral weights are [W_in, W_out, V, m2, K]. All float32 with FMA.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---- forward truncated DFT of a group of planes -----------------------------
// One CUDA block per group of G consecutive (b, channel, v) planes of `in`
// (G = dft_geom's: up to 128 grid rows, 8 planes and 64 KB of planes a
// block, fewer where that leaves under 264 blocks, at least one plane),
// 128 threads, two
// register-tiled products over shared memory:
//   1. y: Y[r, q] = sum_y P[r, y] ty[y, q] for the group's R = G*nx rows r,
//      with ty = [ty_c | ty_s] packed [ny, 2*m2p] (m2p = m2 rounded up to
//      4, zero columns between): each thread a 4-row x 4-column micro-tile,
//      the plane staged transposed [y, r] so one float4 holds 4 rows.
//   2. x: zr[m, k] = sum_row Yr tx_c - Yi tx_s,  zi[m, k] = sum_row Yr tx_s +
//      Yi tx_c per plane, against the [nx, K] tables staged [nx, 2*Kp]: each
//      thread a 4-mode x 4-frequency micro-tile of both parts (4 float4
//      loads per 64 FMAs). Where a plane has fewer than 128 such 4 x 4
//      tiles, its rows are cut into S slices (S from the plane's shape
//      alone) whose partial sums are added in slice order: the same order
//      on every run and at every batch size.
// K4 runs it with ty = [cy | sy]; K6 runs the adjoint of the inverse
// transform through it with ty = [iyc^T | iys^T]. Output [B, V, W, m2, K].
constexpr int kDftThreads = 128;
constexpr int kDftMinBlocks = 264;    // two blocks per SM of an H100

struct DftGeom {
    int G;           // planes of a block
    int R, Rr, Rp;   // rows of the group, rounded up to 4, stride of the transposed plane
    int m2p, Kp;     // m2 and K rounded up to 4
    int n2;          // 4 x 4 micro-tiles of stage 2
    int S;           // row slices of stage 2
};

__host__ __device__ inline DftGeom dft_geom(int nx, int ny, int m2, int K, long long n_planes) {
    DftGeom d;
    d.G = 128 / nx;                       // up to 128 rows,
    d.G = d.G > 8 ? 8 : d.G;              // 8 planes
    const int fit = 16384 / (nx * ny);    // and 64 KB of planes a block,
    d.G = d.G > fit ? fit : d.G;
    const long long spread = (n_planes + kDftMinBlocks - 1) / kDftMinBlocks;
    d.G = d.G > spread ? (int)spread : d.G;   // and kDftMinBlocks blocks where there are planes
    d.G = d.G < 1 ? 1 : d.G;
    d.R = d.G * nx;
    d.Rr = (d.R + 3) / 4 * 4;
    d.Rp = d.Rr + 4;
    d.m2p = (m2 + 3) / 4 * 4;
    d.Kp = (K + 3) / 4 * 4;
    const int per_plane = (d.m2p / 4) * (d.Kp / 4);
    d.n2 = d.G * per_plane;
    d.S = kDftThreads / per_plane;        // per plane: G never changes a plane's sums
    d.S = d.S < 1 ? 1 : (d.S > 8 ? 8 : d.S);
    return d;
}

// Shared memory (floats): the transposed planes [ny, Rp] (whose room the
// slices' partial sums [S, n2, 32] take over in stage 2), the x tables
// [nx, 2*Kp] and Y [Rr, 2*m2p].
__host__ __device__ inline int dft_part_floats(const DftGeom& d) {
    return d.S > 1 ? d.S * d.n2 * 32 : 0;
}

__host__ __device__ inline int dft_floats(int nx, int ny, int m2, int K, long long n_planes) {
    const DftGeom d = dft_geom(nx, ny, m2, K, n_planes);
    const int planes = ny * d.Rp, part = dft_part_floats(d);
    return (planes > part ? planes : part) + nx * 2 * d.Kp + d.Rr * 2 * d.m2p;
}

__global__ void __launch_bounds__(kDftThreads, 1)
    dft_fwd_kernel(const float* __restrict__ in, const float* __restrict__ ty,
                   const float* __restrict__ tx_c, const float* __restrict__ tx_s,
                   float* __restrict__ zr, float* __restrict__ zi, long long n_planes, int W,
                   int V, int nx, int ny, int m2, int K) {
    extern __shared__ float4 smem4[];
    const DftGeom d = dft_geom(nx, ny, m2, K, n_planes);
    const int planes_f = ny * d.Rp, part_f = dft_part_floats(d);
    float* sP = reinterpret_cast<float*>(smem4);   // [ny, Rp]
    float* sPart = sP;                              // [S, n2, 32], once sP is consumed
    float* sX = sP + (planes_f > part_f ? planes_f : part_f);   // [nx, 2*Kp]: tx_c, tx_s
    float* sY = sX + nx * 2 * d.Kp;                 // [Rr, 2*m2p]: re then im
    const long long p0 = (long long)blockIdx.x * d.G;
    const int plane = nx * ny;

    // every copy in flight at once (cp.async), a warp per grid row, the
    // planes transposed: the group's rows r = g*nx + row are consecutive
    // in `in`, so row r of the group starts at in + (p0*nx + r)*ny
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const long long left = n_planes - p0;
    const int rows_in = (left < d.G ? (int)left : d.G) * nx;
    const float* src = in + p0 * plane;
    for (int r = warp; r < d.R; r += n_warps)
        for (int y = lane; y < ny; y += 32)
            copy_async4(sP + y * d.Rp + r, r < rows_in ? src + (long long)r * ny + y : in,
                        r < rows_in);
    for (int row = warp; row < nx; row += n_warps)
        for (int q = lane; q < 2 * d.Kp; q += 32) {
            const int k = q < d.Kp ? q : q - d.Kp;
            copy_async4(sX + row * 2 * d.Kp + q, (q < d.Kp ? tx_c : tx_s) + row * K + (k < K ? k : 0),
                        k < K);
        }
    copy_async_commit();
    for (int i = threadIdx.x; i < ny * (d.Rr - d.R); i += blockDim.x) {
        const int y = i / (d.Rr - d.R);
        sP[y * d.Rp + d.R + i % (d.Rr - d.R)] = 0.0f;
    }
    copy_async_wait<0>();
    __syncthreads();

    // 1. y: thread micro-tiles of Y, rows fastest so a warp shares its table loads
    const int rg_n = d.Rr / 4, n1 = rg_n * (2 * d.m2p / 4);
    const float4* ty4 = reinterpret_cast<const float4*>(ty);
    for (int mt = threadIdx.x; mt < n1; mt += blockDim.x) {
        const int r0 = 4 * (mt % rg_n), q0 = 4 * (mt / rg_n);
        float acc[4][4] = {};
#pragma unroll 4
        for (int y = 0; y < ny; ++y) {
            const float4 a = *reinterpret_cast<const float4*>(sP + y * d.Rp + r0);
            const float4 b = __ldg(ty4 + (y * 2 * d.m2p + q0) / 4);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(sY + (r0 + i) * 2 * d.m2p + q0) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();

    // 2. x: per plane g, modes m0.., frequencies k0.., rows of slice s
    const int mg_n = d.m2p / 4, kg_n = d.Kp / 4, rs = (nx + d.S - 1) / d.S;
    for (int mt = threadIdx.x; mt < d.n2 * d.S; mt += blockDim.x) {
        const int s = mt / d.n2, u = mt % d.n2;
        const int g = u / (mg_n * kg_n), m0 = 4 * ((u / kg_n) % mg_n), k0 = 4 * (u % kg_n);
        float re[4][4] = {}, im[4][4] = {};
        const int row_end = min((s + 1) * rs, nx);
        for (int row = s * rs; row < row_end; ++row) {
            const float* yrow = sY + (g * nx + row) * 2 * d.m2p;
            const float4 a = *reinterpret_cast<const float4*>(yrow + m0);
            const float4 b = *reinterpret_cast<const float4*>(yrow + d.m2p + m0);
            const float4 c = *reinterpret_cast<const float4*>(sX + row * 2 * d.Kp + k0);
            const float4 e = *reinterpret_cast<const float4*>(sX + row * 2 * d.Kp + d.Kp + k0);
            const float yr[4] = {a.x, a.y, a.z, a.w}, yi[4] = {b.x, b.y, b.z, b.w};
            const float cv[4] = {c.x, c.y, c.z, c.w}, sv[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    re[i][j] += yr[i] * cv[j] - yi[i] * sv[j];
                    im[i][j] += yr[i] * sv[j] + yi[i] * cv[j];
                }
        }
        if (d.S > 1) {
            float* part = sPart + (s * d.n2 + u) * 32;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    part[i * 4 + j] = re[i][j];
                    part[16 + i * 4 + j] = im[i][j];
                }
            continue;
        }
        const long long p = p0 + g;
        if (p >= n_planes) continue;
        const long long v = p % V, c_ = (p / V) % W, b_ = p / ((long long)V * W);
        const long long base = ((b_ * V + v) * W + c_) * m2 * K;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (m0 + i < m2 && k0 + j < K) {
                    zr[base + (m0 + i) * K + k0 + j] = re[i][j];
                    zi[base + (m0 + i) * K + k0 + j] = im[i][j];
                }
    }
    if (d.S == 1) return;
    __syncthreads();
    for (int u = threadIdx.x; u < d.n2; u += blockDim.x) {
        const int g = u / (mg_n * kg_n), m0 = 4 * ((u / kg_n) % mg_n), k0 = 4 * (u % kg_n);
        const long long p = p0 + g;
        if (p >= n_planes) continue;
        const long long v = p % V, c_ = (p / V) % W, b_ = p / ((long long)V * W);
        const long long base = ((b_ * V + v) * W + c_) * m2 * K;
        for (int e = 0; e < 32; ++e) {
            const int i = (e % 16) / 4, j = e % 4;
            if (m0 + i >= m2 || k0 + j >= K) continue;
            float acc = 0.0f;
            for (int s = 0; s < d.S; ++s) acc += sPart[(s * d.n2 + u) * 32 + e];
            (e < 16 ? zr : zi)[base + (m0 + i) * K + k0 + j] = acc;
        }
    }
}

inline cudaError_t launch_dft_fwd(const float* in, const float* ty, const float* tx_c,
                                  const float* tx_s, float* zr, float* zi, int B, int W, int V,
                                  int nx, int ny, int m2, int K, cudaStream_t s) {
    const long long n_planes = (long long)B * W * V;
    const size_t smem = sizeof(float) * dft_floats(nx, ny, m2, K, n_planes);
    cudaError_t err = allow_smem(dft_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    const int G = dft_geom(nx, ny, m2, K, n_planes).G;
    dft_fwd_kernel<<<(unsigned)((n_planes + G - 1) / G), kDftThreads, smem, s>>>(
        in, ty, tx_c, tx_s, zr, zi, n_planes, W, V, nx, ny, m2, K);
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

}  // namespace
