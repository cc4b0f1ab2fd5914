// The device building block of the FNO block's pixel stages: K4's output
// stage (fno_block.cu) and K6's recompute/backward and adjoint stages
// (fno_block_bwd.cu) all apply W x W (or W x 2*m2) matrices at every pixel
// of a tile of one (b, v) plane, held channel-major in shared memory.
//
// A tile is up to kTileP pixels: `rt` rows of `ty` consecutive y positions
// (ty a multiple of 4; a row wider than kTileP is cut into `nseg` segments,
// a narrow grid stacks up to kTileRows rows). A [C, P] tile lives at
// stride kTileLd, so that the weight-gradient loads of 16 different
// channels at one pixel fall in distinct banks.
//
// Products. A block has 8*W threads; thread t owns the micro-tile of
// channels c0 = 4*(t/32) .. c0+3 and pixels p0 = 4*(t%32) .. p0+3 of a
// [W, P] output, so a warp shares its weight loads (broadcast) and reads 32
// consecutive float4 of the tile. Each step of the inner index is two
// float4 shared loads for 16 FMAs. The inner sum runs in one thread, in
// index order, so a pixel's arithmetic never depends on the block, the
// thread or the batch. Nothing is a W-long array per thread: no width
// spills.
//
// The x transform comes first, for every row of a plane at once
// (inverse_x_kernel, a tiled product of its own), so a tile needs only its
// rows' [rt, 2*m2, W] inverse-x values and the y tables' slice.
//
// Walking. A stage launches a fixed grid (a function of the shape alone);
// block b takes the contiguous tiles [n*b/G, n*(b+1)/G) in order, copies
// the next tile's activations and inverse-x rows with cp.async while the
// current one computes (double buffer), and restages the y tables' slice
// only when the tile's y segment changes.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTileP = 128;            // pixels of a tile
constexpr int kTileLd = kTileP + 4;    // row stride of a [C, kTileP] tile in shared memory
constexpr int kTileRows = 4;           // rows a tile stacks at most (narrow grids)

struct TileGeom {
    int ty;          // y positions of a tile (a multiple of 4)
    int rt;          // rows of a tile
    int nseg;        // tiles across a row
    int per_plane;   // tiles of one (b, v) plane
    int used;        // rt * ty pixels in use
};

__host__ __device__ inline TileGeom tile_geom(int nx, int ny) {
    TileGeom g;
    g.nseg = (ny + kTileP - 1) / kTileP;
    g.ty = ((ny + g.nseg - 1) / g.nseg + 3) / 4 * 4;
    int rt = kTileP / g.ty;
    rt = rt > kTileRows ? kTileRows : rt;
    g.rt = rt > nx ? nx : rt;
    g.per_plane = (nx + g.rt - 1) / g.rt * g.nseg;
    g.used = g.rt * g.ty;
    return g;
}

// Floats of a stage's two buffers of inverse-x rows ([rt, 2*m2, W] each)
// and its y-table slice ([2*m2, ty]) in shared memory.
__host__ __device__ inline int tile_spec_floats(int W, int m2, const TileGeom& g) {
    return 2 * g.rt * 2 * m2 * W + 2 * m2 * g.ty;
}

struct Tile {
    long long bv;    // b*V + v
    int r0, y0;      // first row and y of the tile
};

__device__ __forceinline__ Tile tile_at(long long t, const TileGeom& g) {
    Tile out;
    out.bv = t / g.per_plane;
    const int tt = (int)(t - out.bv * g.per_plane);
    out.r0 = (tt / g.nseg) * g.rt;
    out.y0 = (tt % g.nseg) * g.ty;
    return out;
}

// Start copying the [W, used] tile of a [W, ...] activation into dst
// (stride kTileLd); pixels off the grid read as 0. `base` points at the
// (b, channel 0, v) plane, `chan` is the channel stride.
template <int W>
__device__ __forceinline__ void tile_load_async(const float* base, long long chan, int nx, int ny,
                                                const TileGeom& g, const Tile& t, float* dst) {
    const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
    for (int cr = threadIdx.x >> 5; cr < W * g.rt; cr += n_warps) {   // a warp per (c, row)
        const int c = cr / g.rt, r = cr - c * g.rt, row = t.r0 + r;
        const float* src = base + c * chan + (long long)row * ny + t.y0;
        float* out = dst + c * kTileLd + r * g.ty;
        for (int j = lane; j < g.ty; j += 32) {
            const bool ok = row < nx && t.y0 + j < ny;
            copy_async4(out + j, ok ? src + j : base, ok);
        }
    }
}

// ---- the micro-tile product ------------------------------------------------
// acc[i][j] += sum_{k < n} A[k*lda + i] * B[k*ldb + j], i, j < 4, k in order.
// A and B are 16-byte aligned shared-memory pointers.
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* A, int lda,
                                         const float* B, int ldb, int n) {
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(A + k * lda);
        const float4 b = *reinterpret_cast<const float4*>(B + k * ldb);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

__device__ __forceinline__ void tile_zero(float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// acc[a][b] += sum_{p < n} U[i0+a][p] * V[j0+b][p] for a, b < 2: the 2x2
// micro-tile of one weight-gradient matrix over a tile's pixels, in pixel
// order (n a multiple of 4). u and v point at rows i0 and j0.
__device__ __forceinline__ void tile_outer2x2(float (&acc)[4], const float* u, const float* v,
                                              int n) {
    for (int p = 0; p < n; p += 4) {
        const float4 u0 = *reinterpret_cast<const float4*>(u + p);
        const float4 u1 = *reinterpret_cast<const float4*>(u + kTileLd + p);
        const float4 v0 = *reinterpret_cast<const float4*>(v + p);
        const float4 v1 = *reinterpret_cast<const float4*>(v + kTileLd + p);
        const float a0[4] = {u0.x, u0.y, u0.z, u0.w}, a1[4] = {u1.x, u1.y, u1.z, u1.w};
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w}, b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            acc[0] = fmaf(a0[q], b0[q], acc[0]);
            acc[1] = fmaf(a0[q], b1[q], acc[1]);
            acc[2] = fmaf(a1[q], b0[q], acc[2]);
            acc[3] = fmaf(a1[q], b1[q], acc[3]);
        }
    }
}

// ---- inverse x transform of a spectrum, every row --------------------------
// For each (b, v) plane of a [B, V, W, m2, K] spectrum (sr, si), the
// inverse-x values of every grid row, written [B, V, nx, 2*m2, W]:
//   vx[row, m, c]      = sum_k sr[c,m,k] cxT[k,row] + si[c,m,k] sxT[k,row]
//   vx[row, m2 + m, c] = sum_k si[c,m,k] cxT[k,row] - sr[c,m,k] sxT[k,row]
// the layout a tile stage copies its rows from. One block per (plane,
// chunk of kInvCols columns n = m*W + c): the [2K, nx] tables and the
// chunk's [2K, kInvCols] spectrum are staged in shared memory, and each
// thread computes 4 rows x 4 columns of both parts, k in order (4 float4
// loads per 64 FMAs). Dynamic shared memory inverse_x_floats(nx, K).
constexpr int kInvCols = 128;
constexpr int kInvLd = kInvCols + 4;
constexpr int kInvThreads = 256;

__host__ __device__ inline int inverse_x_floats(int nx, int K) {
    return 2 * K * ((nx + 3) / 4 * 4) + 2 * K * kInvLd;
}

__global__ void __launch_bounds__(kInvThreads, 1)
    inverse_x_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                     const float* __restrict__ cxT, const float* __restrict__ sxT,
                     float* __restrict__ vx, int W, int nx, int m2, int K) {
    extern __shared__ float4 smem4[];
    const int nxp = (nx + 3) / 4 * 4, ncol = W * m2;
    float* sA = reinterpret_cast<float*>(smem4);   // [2K, nxp]: cxT then sxT
    float* sM = sA + 2 * K * nxp;                   // [2K, kInvLd]: sr then si
    const int n_chunks = (ncol + kInvCols - 1) / kInvCols;
    const long long bv = blockIdx.x / n_chunks;
    const int n0 = (blockIdx.x % n_chunks) * kInvCols;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    for (int k = warp; k < 2 * K; k += n_warps) {                    // a warp per table row
        const float* t = k < K ? cxT + k * nx : sxT + (k - K) * nx;
        for (int row = lane; row < nxp; row += 32)
            copy_async4(sA + k * nxp + row, row < nx ? t + row : cxT, row < nx);
    }
    const long long off = bv * ncol * K;
    for (int j = warp; j < kInvCols; j += n_warps) {                 // a warp per column,
        const int n = n0 + j;                                        // k across the lanes
        const bool ok = n < ncol;
        const long long src = ok ? off + (long long)((n % W) * m2 + n / W) * K : 0;
        for (int k = lane; k < K; k += 32) {
            copy_async4(sM + k * kInvLd + j, sr + src + (ok ? k : 0), ok);
            copy_async4(sM + (K + k) * kInvLd + j, si + src + (ok ? k : 0), ok);
        }
    }
    copy_async_commit();
    copy_async_wait<0>();
    __syncthreads();

    const int j0 = 4 * (threadIdx.x & 31);
    const int n = n0 + j0;
    if (n >= ncol) return;
    const int m = n / W, c = n % W;                 // 4 consecutive c of one m
    float* vb = vx + bv * nx * 2 * m2 * W;
    for (int i0 = 4 * (threadIdx.x >> 5); i0 < nxp; i0 += 4 * (kInvThreads / 32)) {
        float re[4][4], im[4][4];
        tile_zero(re);
        tile_zero(im);
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            const float4 c4 = *reinterpret_cast<const float4*>(sA + k * nxp + i0);
            const float4 s4 = *reinterpret_cast<const float4*>(sA + (K + k) * nxp + i0);
            const float4 r4 = *reinterpret_cast<const float4*>(sM + k * kInvLd + j0);
            const float4 q4 = *reinterpret_cast<const float4*>(sM + (K + k) * kInvLd + j0);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float rv[4] = {r4.x, r4.y, r4.z, r4.w}, qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    re[a][b] += rv[b] * cv[a] + qv[b] * sv[a];
                    im[a][b] += qv[b] * cv[a] - rv[b] * sv[a];
                }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            if (i0 + a >= nx) break;
            float* o = vb + (long long)(i0 + a) * 2 * m2 * W;
            *reinterpret_cast<float4*>(o + m * W + c) =
                make_float4(re[a][0], re[a][1], re[a][2], re[a][3]);
            *reinterpret_cast<float4*>(o + (m2 + m) * W + c) =
                make_float4(im[a][0], im[a][1], im[a][2], im[a][3]);
        }
    }
}

inline cudaError_t launch_inverse_x(const float* sr, const float* si, const float* cxT,
                                    const float* sxT, float* vx, int B, int V, int W, int nx,
                                    int m2, int K, cudaStream_t s) {
    const size_t smem = sizeof(float) * inverse_x_floats(nx, K);
    cudaError_t err = allow_smem(inverse_x_kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * V * ((W * m2 + kInvCols - 1) / kInvCols);
    inverse_x_kernel<<<(unsigned)blocks, kInvThreads, smem, s>>>(sr, si, cxT, sxT, vx, W, nx,
                                                                 m2, K);
    return cudaGetLastError();
}

// ---- the tile's y transform ----------------------------------------------------
// Start copying the tile rows' inverse-x values ([rt, 2*m2, W] of vx
// [B, V, nx, 2*m2, W]) into sV, 16 bytes at a time; rows past the grid are 0.
template <int W>
__device__ __forceinline__ void tile_load_vx_async(const float* vx, int nx, int m2,
                                                   const TileGeom& g, const Tile& t, float* sV) {
    const int per_row = 2 * m2 * W / 4;             // float4 of one row
    const float4* src = reinterpret_cast<const float4*>(vx) + (t.bv * nx + t.r0) * per_row;
    for (int i = threadIdx.x; i < g.rt * per_row; i += blockDim.x) {
        const bool ok = t.r0 + i / per_row < nx;
#if defined(__CUDA_ARCH__)
        const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(sV + 4 * i));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                     "l"(ok ? src + i : src), "r"(ok ? 16 : 0));
#else
        reinterpret_cast<float4*>(sV)[i] = ok ? src[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#endif
    }
}

// The tile segment's slice of the y tables (tyc, tys) [m2, ny] into sT
// [2*m2, ty]: rows q < m2 from tyc, the rest from tys; y past the grid is 0.
__device__ __forceinline__ void tile_y_tables(const float* tyc, const float* tys, int ny, int m2,
                                              const TileGeom& g, int y0, float* sT) {
    for (int i = threadIdx.x; i < 2 * m2 * g.ty; i += blockDim.x) {
        const int q = i / g.ty, y = y0 + i % g.ty;
        sT[i] = y >= ny ? 0.0f : (q < m2 ? tyc[q * ny + y] : tys[(q - m2) * ny + y]);
    }
}

// acc += the inverse-y product of this thread's micro-tile: output channel
// c0+i at tile pixel p0+j, sum over q < 2*m2 of sV[r, q, c] sT[q, y'].
template <int W>
__device__ __forceinline__ void tile_inverse_y(float (&acc)[4][4], const float* sV,
                                               const float* sT, const TileGeom& g, int m2, int c0,
                                               int p0) {
    const int r = p0 / g.ty, j0 = p0 - r * g.ty;
    tile_mma(acc, sV + r * 2 * m2 * W + c0, W, sT + j0, g.ty, 2 * m2);
}

// This block's share of the n_tiles tiles: [*t0, *t1), in order.
__device__ __forceinline__ void tile_range(long long n_tiles, long long* t0, long long* t1) {
    *t0 = n_tiles * blockIdx.x / gridDim.x;
    *t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
}

}  // namespace
