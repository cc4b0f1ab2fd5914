// PRE stencil kernels for Hopper (sm_90a): the residual alone (K2, and K8
// for a constant tap table), the paired joint-CP diff plus cross-batch
// moments (K1), and the joint-CP scores in one launch with no staged diff
// (K9). Every kernel body is a template over a *cell*: the function that
// evaluates one residual at one output cell of one sample. K1, K2 and K9
// call the very same cell, so the diff K9 scores is the diff K1 stores.
//
// Replaces the Pallas kernels of cppre/ops/pallas/stencil_kernels.py:
//   K2  _batched_residual_fused: per sample, the interior residual,
//       [BS, Nvar, Nt, Nx, Ny] -> [BS, Nt-2, Nx-2, Ny-2]. Cells: NS momentum
//       (_ns_momentum_math) and the five ideal-MHD equations (_mhd_math).
//   K8  fused_stencil_residual: a constant k^3 stencil (the wave composite
//       D_tt - (c dt/dx)^2 D_xxyy) on the valid interior, optional |.|,
//       [BS, Nt, Nx, Ny] -> [BS, Nt-k+1, Nx-k+1, Ny-k+1]. Cell: the tap table.
//   K1  _joint_cp_diff_stats: diff = PRE(truth) - PRE(pred) per sample, plus
//       per-cell sum and sum of squares over the batch, and on request the
//       centred sum of squares (see below). Cells: NS momentum, MHD
//       induction (and any other MHD equation), the tap table.
//   K9  _joint_cp_scores_single_pass: scores[b] = max over cells of
//       |diff| / (std(diff over the batch) + eps), no diff tensor in HBM.
//
// What bounds them on an H100: memory. A cell reads at most 25 field taps
// (six MHD fields) and does well under 100 flops, far below the ~20
// flops/byte at which the card stops being bandwidth-bound. The TPU kernels
// held one whole trajectory in VMEM; here neighbouring threads read
// neighbouring y addresses (coalesced) and a tap's reuse by adjacent cells
// is served by L1/L2.
//
// Cross-batch moments (K1, K9): the TPU kernel carries sum/sumsq from one
// grid step to the next, relying on the TPU running its grid in order. CUDA
// blocks run in no order, so each thread owns one interior cell and loops
// over the batch b = 0..BS-1 itself, accumulating in f32 registers in that
// fixed order: no atomics, bit-stable, independent of the launch shape.
//
// The modulation std is taken from the centred sum of squares,
// sum_b (d_b - mean)^2 with mean = sum / n, in a second pass over the batch:
// the one-pass sumsq / n - mean^2 of the JAX package cancels when a cell's
// diff barely varies over the batch (std / |mean| below ~1e-3 in float32),
// and those cells are where the sup-norm score peaks. K1 forms it on
// request by re-reading the diff it staged (recomputing it from the inputs
// when the staged diff is bfloat16).
//
// K9: the TPU kernel stashes every diff in VMEM between its two phases. At
// the MHD configuration's 128^2 grid that stash is ~114 MB, against 228 KB
// of shared memory per SM and 50 MB of L2, so here nothing is stashed:
// since a thread already holds every batch moment of its cell, pass 1 over
// the batch forms the mean, pass 2 the centred sum of squares and the
// modulation, pass 3 recomputes each diff with the same cell and folds
// |diff| / mod into a per-sample maximum (warp shuffle, then the block,
// then atomicMax on the bits of the non-negative float: a maximum is exact
// and order-free, so the scores are bit-stable). K9 reads the inputs three
// times and writes no diff; its arithmetic is K1's plus the epilogue's,
// operation for operation, so its scores are the two-pass route's.
//
// Term order follows the JAX math so the plain-PyTorch parity is tight; the
// tap table accumulates with explicit round-to-nearest multiplies and adds
// (no FMA contraction), the arithmetic of `stencil_shift_add`.

#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

// Extents and strides of one sample [Nvar, Nt, Nx, Ny] and of the output.
struct Geom {
    int nt, nx, ny;      // input extents
    int ot, ox, oy;      // output extents: N - k + 1 on each axis
    long long plane;     // nx * ny
    long long field;     // nt * nx * ny: one variable
    long long sample;    // nvar * field
};

// Index of the centre of a 3-wide stencil at output cell (t, x, y).
__device__ __forceinline__ long long centre(const Geom& g, int t, int x, int y) {
    return (long long)(t + 1) * g.plane + (long long)(x + 1) * g.ny + (y + 1);
}

// The centre value and the three centred differences of one field.
struct D3 {
    float c, t, x, y;
};

__device__ __forceinline__ D3 d3(const float* __restrict__ a, long long i0, const Geom& g) {
    D3 r;
    r.c = __ldg(a + i0);
    r.t = __ldg(a + i0 + g.plane) - __ldg(a + i0 - g.plane);
    r.x = __ldg(a + i0 + g.ny) - __ldg(a + i0 - g.ny);
    r.y = __ldg(a + i0 + 1) - __ldg(a + i0 - 1);
    return r;
}

// NS momentum residual of (u, v, p), _ns_momentum_math.
struct NsMomentum {
    float cxy;  // dx * dy
    float cty;  // dt * dy
    float ctx;  // dt * dx
    float nu;
    float dt;

    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y) const {
        const float* __restrict__ u = f;
        const float* __restrict__ v = f + g.field;
        const float* __restrict__ p = f + 2 * g.field;
        const long long i0 = centre(g, t, x, y);
        const long long st = g.plane, sx = g.ny;

        const float uc = __ldg(u + i0), vc = __ldg(v + i0);
        const float u_t = __ldg(u + i0 + st) - __ldg(u + i0 - st);
        const float u_xp = __ldg(u + i0 + sx), u_xm = __ldg(u + i0 - sx);
        const float u_yp = __ldg(u + i0 + 1), u_ym = __ldg(u + i0 - 1);
        const float v_t = __ldg(v + i0 + st) - __ldg(v + i0 - st);
        const float v_xp = __ldg(v + i0 + sx), v_xm = __ldg(v + i0 - sx);
        const float v_yp = __ldg(v + i0 + 1), v_ym = __ldg(v + i0 - 1);
        const float p_x = __ldg(p + i0 + sx) - __ldg(p + i0 - sx);
        const float p_y = __ldg(p + i0 + 1) - __ldg(p + i0 - 1);

        const float u_x = u_xp - u_xm, u_y = u_yp - u_ym;
        const float v_x = v_xp - v_xm, v_y = v_yp - v_ym;
        const float u_lap = u_xp + u_xm + u_yp + u_ym - 4.0f * uc;
        const float v_lap = v_xp + v_xm + v_yp + v_ym - 4.0f * vc;

        const float res_x = u_t * cxy + uc * u_x * cty + vc * u_y * ctx - nu * u_lap * dt
                            + p_x * cty;
        const float res_y = v_t * cxy + uc * v_x * ctx + vc * v_y * cty - nu * v_lap * dt
                            + p_y * ctx;
        return res_x + res_y;
    }
};

// The selectable ideal-MHD residuals (_mhd_math) over the six fields
// (rho, u, v, p, Bx, By); each reads only the fields its equation uses.
enum Kind { kNsMomentum = 0, kContinuity, kMomentum, kEnergy, kInduction, kGauss, kTaps };

constexpr float kGamma = (float)(5.0 / 3.0);
constexpr float kGammaMinus2 = (float)(5.0 / 3.0 - 2.0);

template <int EQ>
struct Mhd {
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y) const {
        const long long i0 = centre(g, t, x, y);
        auto F = [&](int var) { return d3(f + var * g.field, i0, g); };
        if constexpr (EQ == kContinuity) {
            const D3 rho = F(0), u = F(1), v = F(2);
            return rho.t + u.c * rho.x + rho.c * u.x + v.c * rho.y + rho.c * v.y;
        } else if constexpr (EQ == kMomentum) {
            const D3 rho = F(0), u = F(1), v = F(2), p = F(3), bx = F(4), by = F(5);
            const float inv_rho = 1.0f / rho.c;
            const float res_x = u.t + u.c * u.x + inv_rho * p.x - 2.0f * (bx.c * inv_rho) * bx.x
                                + v.c * u.y - (by.c * inv_rho) * bx.y - (bx.c * inv_rho) * by.y;
            const float res_y = v.t + u.c * v.x + inv_rho * p.y - 2.0f * (by.c * inv_rho) * by.y
                                + v.c * v.y - (by.c * inv_rho) * bx.x - (bx.c * inv_rho) * by.x;
            return res_x + res_y;
        } else if constexpr (EQ == kEnergy) {
            const D3 rho = F(0), u = F(1), v = F(2), p = F(3), bx = F(4), by = F(5);
            const float p_gas = p.c - 0.5f * (bx.c * bx.c + by.c * by.c);
            return rho.t + u.c * p.x + v.c * p.y
                   + kGammaMinus2 * (u.c * bx.c + v.c * by.c) * (bx.x + by.y)
                   + (kGamma * p_gas + by.c * by.c) * u.x
                   + (kGamma * p_gas + bx.c * bx.c) * v.y
                   - bx.c * by.c * (u.y + v.x);
        } else if constexpr (EQ == kInduction) {
            const D3 u = F(1), v = F(2), bx = F(4), by = F(5);
            const float res_x = bx.t - by.c * u.y + bx.c * v.y - v.c * bx.y + u.c * by.y;
            const float res_y = by.t + by.c * u.x - bx.c * v.x - v.c * bx.x + u.c * by.x;
            return res_x + res_y;
        } else {  // kGauss
            const D3 bx = F(4), by = F(5);
            return bx.x + by.y;
        }
    }
};

// A constant stencil as a table of its non-zero taps, in the order of
// `_taps` (itertools.product, zeros dropped): off[i] is the tap's linear
// offset from the cell's (0, 0, 0) corner, w[i] its float32 weight.
struct Taps {
    const int* __restrict__ off;
    const float* __restrict__ w;
    int n;

    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y) const {
        const float* __restrict__ base = f + (long long)t * g.plane + (long long)x * g.ny + y;
        float acc = 0.0f;
        for (int i = 0; i < n; ++i) {
            const float term = __fmul_rn(__ldg(base + __ldg(off + i)), __ldg(w + i));
            acc = i == 0 ? term : __fadd_rn(acc, term);
        }
        return acc;
    }
};

// ---- K2 / K8: the residual ---------------------------------------------------
// grid (BS * ot, ceil(ox / blockDim.y)); threads along y.
template <class Cell>
__global__ void residual_kernel(const float* __restrict__ fields, float* __restrict__ out,
                                Geom g, Cell cell, int take_abs) {
    const int bt = blockIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= g.ox) return;
    const int b = bt / g.ot, t = bt % g.ot;
    const float* f = fields + (long long)b * g.sample;
    float* o = out + ((long long)bt * g.ox + x) * g.oy;
    for (int y = threadIdx.x; y < g.oy; y += blockDim.x) {
        const float r = cell(f, g, t, x, y);
        o[y] = take_abs ? fabsf(r) : r;
    }
}

// ---- K1: diff and moments ------------------------------------------------------
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The mean of n values from their sum, as the score epilogue forms it on
// the card (PyTorch divides a float tensor by a scalar as a multiply by the
// float reciprocal), and one step of a centred sum of squares, rounded
// term by term (no contraction into an FMA), so K1 and K9 agree bit for bit.
__device__ __forceinline__ float batch_mean(float s, int n) {
    return __fmul_rn(s, 1.0f / (float)n);
}
__device__ __forceinline__ float centred_step(float acc, float d, float mean) {
    const float c = __fsub_rn(d, mean);
    return __fadd_rn(acc, __fmul_rn(c, c));
}

// grid (ot, ceil(ox / blockDim.y)); one thread per interior cell, looping
// over the batch. m2 (may be null) receives the centred sum of squares.
template <class Cell, typename DiffT>
__global__ void diff_stats_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                                  DiffT* diff, float* __restrict__ sum,
                                  float* __restrict__ sumsq, float* __restrict__ m2, int bs,
                                  Geom g, Cell cell) {
    const long long ncell = (long long)g.ot * g.ox * g.oy;
    const int t = blockIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= g.ox) return;
    for (int y = threadIdx.x; y < g.oy; y += blockDim.x) {
        const long long id = ((long long)t * g.ox + x) * g.oy + y;
        auto diff_of = [&](int b) {
            const long long off = (long long)b * g.sample;
            return cell(truth + off, g, t, x, y) - cell(pred + off, g, t, x, y);
        };
        float s = 0.0f, q = 0.0f;
        for (int b = 0; b < bs; ++b) {
            const float d = diff_of(b);
            store(diff + (long long)b * ncell + id, d);
            s += d;
            q += d * d;
        }
        sum[id] = s;
        sumsq[id] = q;
        if (m2 != nullptr) {
            const float mean = batch_mean(s, bs);
            float acc = 0.0f;
            for (int b = 0; b < bs; ++b) {
                // this thread's own float32 store, read back (a plain load:
                // the read-only path may not see writes of this kernel)
                float d;
                if constexpr (std::is_same<DiffT, float>::value) {
                    d = diff[(long long)b * ncell + id];
                } else {
                    d = diff_of(b);
                }
                acc = centred_step(acc, d, mean);
            }
            m2[id] = acc;
        }
    }
}

// ---- K9: single-pass scores ----------------------------------------------------
// A maximum that keeps a NaN, as torch.amax does.
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

constexpr int kScoreThreads = 256;

// 1-D grid over the interior cells, one cell per thread. scores holds the
// bits of BS non-negative floats, zeroed by the caller.
template <class Cell>
__global__ void __launch_bounds__(kScoreThreads)
scores_single_pass_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                          unsigned int* __restrict__ scores, int bs, Geom g, Cell cell,
                          float eps) {
    __shared__ float part[2][kScoreThreads / 32];
    const long long ncell = (long long)g.ot * g.ox * g.oy;
    const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = id < ncell;
    int t = 0, x = 0, y = 0;
    if (live) {
        y = (int)(id % g.oy);
        const long long r = id / g.oy;
        x = (int)(r % g.ox);
        t = (int)(r / g.ox);
    }
    auto diff = [&](int b) {
        const long long off = (long long)b * g.sample;
        return cell(truth + off, g, t, x, y) - cell(pred + off, g, t, x, y);
    };

    // pass 1: the sum in batch order, as K1 forms it; pass 2: the centred
    // sum of squares, as K1 forms it; then the modulation as the score
    // epilogue forms it: sqrt(m2 / n) + eps
    float mod = 1.0f;
    if (live) {
        float s = 0.0f;
        for (int b = 0; b < bs; ++b) s += diff(b);
        const float mean = batch_mean(s, bs);
        float acc = 0.0f;
        for (int b = 0; b < bs; ++b) acc = centred_step(acc, diff(b), mean);
        mod = __fadd_rn(sqrtf(__fmul_rn(acc, 1.0f / (float)bs)), eps);
    }

    // pass 3: |diff| / mod, maximised per sample over the block, then over
    // the grid through atomicMax on the float's bits
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int b = 0; b < bs; ++b) {
        float r = live ? fabsf(diff(b)) / mod : 0.0f;
        for (int o = 16; o > 0; o >>= 1) r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
        if (lane == 0) part[b & 1][warp] = r;
        __syncthreads();
        if (threadIdx.x == 0) {
            float m = part[b & 1][0];
            for (int w = 1; w < nwarps; ++w) m = nan_max(m, part[b & 1][w]);
            atomicMax(scores + b, __float_as_uint(m));
        }
    }
}

// ---- host side ---------------------------------------------------------------
Geom make_geom(int nvar, int nt, int nx, int ny, int k) {
    Geom g;
    g.nt = nt;
    g.nx = nx;
    g.ny = ny;
    g.ot = nt - k + 1;
    g.ox = nx - k + 1;
    g.oy = ny - k + 1;
    g.plane = (long long)nx * ny;
    g.field = (long long)nt * g.plane;
    g.sample = (long long)nvar * g.field;
    return g;
}

// Threads along y: the output row rounded up to a warp, at most 128; rows
// of x fill a block of 256 threads.
dim3 row_block(int oy) {
    const int ty = oy >= 128 ? 128 : ((oy + 31) / 32) * 32;
    return dim3(ty, 256 / ty);
}

struct CellArgs {
    int kind;
    float cxy, cty, ctx, nu, dt;
    const void* tap_off;
    const void* tap_w;
    int ntaps;
};

// Call launch(cell) with the cell that `a.kind` names.
template <class Launch>
int with_cell(const CellArgs& a, const Launch& launch) {
    switch (a.kind) {
        case kNsMomentum: return launch(NsMomentum{a.cxy, a.cty, a.ctx, a.nu, a.dt});
        case kContinuity: return launch(Mhd<kContinuity>{});
        case kMomentum: return launch(Mhd<kMomentum>{});
        case kEnergy: return launch(Mhd<kEnergy>{});
        case kInduction: return launch(Mhd<kInduction>{});
        case kGauss: return launch(Mhd<kGauss>{});
        case kTaps:
            return launch(Taps{(const int*)a.tap_off, (const float*)a.tap_w, a.ntaps});
        default: return (int)cudaErrorInvalidValue;
    }
}

struct ResidualLaunch {
    const float* fields;
    float* out;
    int bs;
    Geom g;
    int take_abs;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const dim3 block = row_block(g.oy);
        const dim3 grid((unsigned)bs * g.ot, (g.ox + block.y - 1) / block.y);
        residual_kernel<Cell><<<grid, block, 0, stream>>>(fields, out, g, cell, take_abs);
        return (int)cudaGetLastError();
    }
};

struct DiffStatsLaunch {
    const float* truth;
    const float* pred;
    void* diff;
    int diff_bf16;
    float* sum;
    float* sumsq;
    float* m2;
    int bs;
    Geom g;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const dim3 block = row_block(g.oy);
        const dim3 grid(g.ot, (g.ox + block.y - 1) / block.y);
        if (diff_bf16) {
            diff_stats_kernel<Cell, __nv_bfloat16><<<grid, block, 0, stream>>>(
                truth, pred, (__nv_bfloat16*)diff, sum, sumsq, m2, bs, g, cell);
        } else {
            diff_stats_kernel<Cell, float><<<grid, block, 0, stream>>>(
                truth, pred, (float*)diff, sum, sumsq, m2, bs, g, cell);
        }
        return (int)cudaGetLastError();
    }
};

struct ScoresLaunch {
    const float* truth;
    const float* pred;
    unsigned int* scores;
    int bs;
    Geom g;
    float eps;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const long long ncell = (long long)g.ot * g.ox * g.oy;
        const unsigned blocks = (unsigned)((ncell + kScoreThreads - 1) / kScoreThreads);
        scores_single_pass_kernel<Cell><<<blocks, kScoreThreads, 0, stream>>>(
            truth, pred, scores, bs, g, cell, eps);
        return (int)cudaGetLastError();
    }
};

}  // namespace

// kind: 0 NS momentum (cxy..dt its constants), 1-5 the MHD continuity,
// momentum, energy, induction and gauss residuals, 6 a tap table
// (tap_off int32 [ntaps], tap_w float32 [ntaps], on the device). k is the
// stencil's extent (3 for kinds 0-5).

CPPRE_EXPORT int cppre_stencil_residual(int kind, const void* fields, void* out, int bs,
                                        int nvar, int nt, int nx, int ny, int k, float cxy,
                                        float cty, float ctx, float nu, float dt,
                                        const void* tap_off, const void* tap_w, int ntaps,
                                        int take_abs, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps};
    return with_cell(a, ResidualLaunch{(const float*)fields, (float*)out, bs,
                                       make_geom(nvar, nt, nx, ny, k), take_abs,
                                       (cudaStream_t)stream});
}

// m2 may be null: then the centred second pass is skipped.
CPPRE_EXPORT int cppre_joint_cp_diff_stats(int kind, const void* truth, const void* pred,
                                           void* diff, int diff_bf16, void* sum, void* sumsq,
                                           void* m2, int bs, int nvar, int nt, int nx, int ny,
                                           int k, float cxy, float cty, float ctx, float nu,
                                           float dt, const void* tap_off, const void* tap_w,
                                           int ntaps, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps};
    return with_cell(a, DiffStatsLaunch{(const float*)truth, (const float*)pred, diff,
                                        diff_bf16, (float*)sum, (float*)sumsq, (float*)m2, bs,
                                        make_geom(nvar, nt, nx, ny, k), (cudaStream_t)stream});
}

CPPRE_EXPORT int cppre_joint_cp_scores_single_pass(int kind, const void* truth,
                                                   const void* pred, void* scores, int bs,
                                                   int nvar, int nt, int nx, int ny, int k,
                                                   float cxy, float cty, float ctx, float nu,
                                                   float dt, const void* tap_off,
                                                   const void* tap_w, int ntaps, float eps,
                                                   void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps};
    return with_cell(a, ScoresLaunch{(const float*)truth, (const float*)pred,
                                     (unsigned int*)scores, bs, make_geom(nvar, nt, nx, ny, k),
                                     eps, (cudaStream_t)stream});
}
