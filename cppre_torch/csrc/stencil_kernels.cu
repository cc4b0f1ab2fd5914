// PRE stencil kernels for Hopper (sm_90a): the residual alone (K2, and K8
// for a constant tap table), the paired joint-CP diff plus cross-batch
// moments (K1) and its time-chunked, shared-memory-staged twin (K3), and the
// joint-CP scores in one launch with no staged diff (K9). Every kernel body
// is a template over a *cell* (stencil_cells.cuh): the function that
// evaluates one residual at one output cell of one sample. K1, K2, K3 and K9
// call the very same cell, so the diff K9 scores is the diff K1 stores, and
// K3's diff, sum and sum of squares are K1's.
//
// Replaces the Pallas kernels of cppre/ops/pallas/stencil_kernels.py:
//   K2  _batched_residual_fused: per sample, the interior residual,
//       [BS, Nvar, Nt, Nx, Ny] -> [BS, Nt-2, Nx-2, Ny-2]. Cells: NS momentum
//       (_ns_momentum_math), the five ideal-MHD equations (_mhd_math) and
//       the two JOREK equations (_jorek_math, R from a table).
//   K8  fused_stencil_residual: a constant k^3 stencil (the wave composite
//       D_tt - (c dt/dx)^2 D_xxyy) on the valid interior, optional |.|,
//       [BS, Nt, Nx, Ny] -> [BS, Nt-k+1, Nx-k+1, Ny-k+1]. Cell: the tap table.
//   K1  _joint_cp_diff_stats: diff = PRE(truth) - PRE(pred) per sample, plus
//       per-cell sum and sum of squares over the batch, and on request the
//       centred sum of squares (see below). Cells: NS momentum, MHD
//       induction (and any other MHD equation), JOREK, the tap table.
//   K3  _joint_cp_diff_stats_chunked: K1's outputs for 3-wide cells, with
//       each block's window of the inputs staged in shared memory (below).
//   K9  _joint_cp_scores_single_pass: scores[b] = max over cells of
//       |diff| / (std(diff over the batch) + eps), no diff tensor in HBM.
//
// What bounds them on an H100: memory. A cell reads at most 25 field taps
// (six MHD fields) and does well under 100 flops, far below the ~20
// flops/byte at which the card stops being bandwidth-bound. The TPU kernels
// held one whole trajectory in VMEM; here K1, K2, K8 and K9 let neighbouring
// threads read neighbouring y addresses (coalesced) and leave a tap's reuse
// by adjacent cells to L1/L2.
//
// Cross-batch moments (K1, K3, K9): the TPU kernel carries sum/sumsq from
// one grid step to the next, relying on the TPU running its grid in order.
// CUDA blocks run in no order, so each thread owns its interior cells and
// loops over the batch b = 0..BS-1 itself, accumulating in f32 registers in
// that fixed order: no atomics, bit-stable, independent of the launch shape.
//
// The modulation std is taken from the centred sum of squares,
// sum_b (d_b - mean)^2 with mean = sum / n, in a second pass over the batch:
// the one-pass sumsq / n - mean^2 of the JAX package cancels when a cell's
// diff barely varies over the batch (std / |mean| below ~1e-3 in float32),
// and those cells are where the sup-norm score peaks. K1 and K3 form it on
// request by re-reading the diff they staged (K1 recomputes it from the
// inputs when the staged diff is bfloat16).
//
// K3: the TPU kernel keeps each trajectory in HBM and DMAs overlapping time
// chunks (t_block interior frames plus a one-frame halo each side) into
// VMEM, double-buffered, because a whole trajectory at 512^2 does not fit
// VMEM. Here a block owns t_block interior frames of an 8 x 32 tile of the
// interior, and walks the batch in sample order: for each sample it stages
// the halo'd (t_block + 2) x 10 x 34 window of the variables its cell reads,
// truth and prediction, in dynamic shared memory with cp.async, sample b + 1
// loading while sample b computes (the TPU's two DMA slots). Each thread
// owns one (x, y) column of the tile, t_block cells, and keeps their sums in
// registers across the batch. The window costs (t_block + 2) / t_block x
// 1.25 x 1.06 re-reads of each input from L2; t_block is what the caller
// asks for, cut to what fits 227 KB of shared memory (the wrapper's
// `_chunk_t_block`), as the TPU's is cut to fit VMEM.
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

#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "stencil_cells.cuh"

namespace {

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

// ---- K3: diff and moments, time-chunked through shared memory --------------
constexpr int kChunkTX = 8;                          // interior rows (x) of a tile
constexpr int kChunkTY = 32;                         // interior columns (y) of a tile
constexpr int kChunkThreads = kChunkTX * kChunkTY;   // one (x, y) column per thread
constexpr int kChunkMaxTb = 8;                       // frames a thread keeps sums for
constexpr int kWinX = kChunkTX + 2, kWinY = kChunkTY + 2, kWinPlane = kWinX * kWinY;
constexpr size_t kMaxSmem = 232448;                  // 227 KB, a block's most on sm_90

// Dynamic shared memory of K3: 2 slots (double buffer) x 2 tensors (truth,
// prediction) x nvar variables x (tb + 2) frames of the window.
size_t chunk_smem_bytes(int nvar, int tb) {
    return sizeof(float) * 4 * (size_t)nvar * (size_t)(tb + 2) * kWinPlane;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of one sample's window: the variables in `vars`, frames
// t0 .. t0 + nf - 1, rows x0 .. x0 + kWinX - 1 and columns y0 .. y0 + kWinY - 1
// of the [nvar, nt, nx, ny] sample at src, into the window at w (variable v
// at v * wfield). Positions past the grid's edge stay unset: only cells
// outside the interior, whose results are dropped, read them.
__device__ __forceinline__ void stage_window(float* w, long long wfield, const float* src,
                                             const Geom& g, unsigned vars, int nvar, int t0,
                                             int nf, int x0, int y0) {
    const int n = nf * kWinPlane;
    for (int v = 0; v < nvar; ++v) {
        if (!((vars >> v) & 1u)) continue;
        const float* s = src + v * g.field + (long long)t0 * g.plane;
        float* d = w + v * wfield;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int f = i / kWinPlane, r = i - f * kWinPlane;
            const int wx = r / kWinY, wy = r - wx * kWinY;
            const int gx = x0 + wx, gy = y0 + wy;
            if (gx < g.nx && gy < g.ny) {
                cp_async4(d + i, s + (long long)f * g.plane + (long long)gx * g.ny + gy);
            }
        }
    }
}

// grid (ceil(oy / kChunkTY), ceil(ox / kChunkTX), ceil(ot / tb)) of
// kChunkThreads threads. Block (by, bx, bz) owns the interior cells
// (t0 + k, x0 + lx, y0 + ly), t0 = bz * tb, k < tb_c; thread (lx, ly) owns
// one column of them. Sample b + 1's window loads while sample b computes.
// m2 (may be null) receives the centred sum of squares.
template <class Cell>
__global__ void __launch_bounds__(kChunkThreads)
diff_stats_chunked_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                          float* diff, float* __restrict__ sum, float* __restrict__ sumsq,
                          float* __restrict__ m2, int bs, Geom g, Cell cell, int tb,
                          unsigned vars, int nvar) {
    extern __shared__ float smem[];
    const int y0 = blockIdx.x * kChunkTY, x0 = blockIdx.y * kChunkTX, t0 = blockIdx.z * tb;
    const int tb_c = min(tb, g.ot - t0);
    const int lx = threadIdx.x / kChunkTY, ly = threadIdx.x % kChunkTY;
    const int x = x0 + lx, y = y0 + ly;
    const bool live = x < g.ox && y < g.oy;
    const long long ncell = (long long)g.ot * g.ox * g.oy;
    // window row lx is input row x0 + lx (JOREK's R table moves with it)
    const Cell wcell = at_rows(cell, x0);

    // the window's strides, as the cell reads them: one slot of tb + 2
    // frames per variable; (slot s, tensor k) at smem + (2 s + k) w.sample
    Geom w = g;
    w.ny = kWinY;
    w.plane = kWinPlane;
    w.field = (long long)(tb + 2) * kWinPlane;
    w.sample = (long long)nvar * w.field;

    auto stage = [&](int b, int slot) {
        const long long off = (long long)b * g.sample;
        float* base = smem + 2 * slot * w.sample;
        stage_window(base, w.field, truth + off, g, vars, nvar, t0, tb_c + 2, x0, y0);
        stage_window(base + w.sample, w.field, pred + off, g, vars, nvar, t0, tb_c + 2, x0, y0);
        cp_async_commit();
    };

    float s[kChunkMaxTb], q[kChunkMaxTb];
#pragma unroll
    for (int k = 0; k < kChunkMaxTb; ++k) s[k] = q[k] = 0.0f;

    stage(0, 0);
    for (int b = 0; b < bs; ++b) {
        const int slot = b & 1;
        if (b + 1 < bs) {
            stage(b + 1, slot ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (live) {
            const float* wt = smem + 2 * slot * w.sample;
            const float* wp = wt + w.sample;
#pragma unroll
            for (int k = 0; k < kChunkMaxTb; ++k) {
                if (k < tb_c) {
                    const float d = wcell(wt, w, k, lx, ly, FromShared())
                                    - wcell(wp, w, k, lx, ly, FromShared());
                    diff[(long long)b * ncell + ((long long)(t0 + k) * g.ox + x) * g.oy + y] = d;
                    s[k] += d;
                    q[k] += d * d;
                }
            }
        }
        __syncthreads();  // every read of this slot is done before it is refilled
    }
    if (!live) return;
#pragma unroll
    for (int k = 0; k < kChunkMaxTb; ++k) {
        if (k < tb_c) {
            const long long id = ((long long)(t0 + k) * g.ox + x) * g.oy + y;
            sum[id] = s[k];
            sumsq[id] = q[k];
            if (m2 != nullptr) {
                // this thread's own stores, read back (plain loads), as K1 does
                const float mean = batch_mean(s[k], bs);
                float acc = 0.0f;
                for (int b = 0; b < bs; ++b) acc = centred_step(acc, diff[(long long)b * ncell + id], mean);
                m2[id] = acc;
            }
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
// Threads along y: the output row rounded up to a warp, at most 128; rows
// of x fill a block of 256 threads.
dim3 row_block(int oy) {
    const int ty = oy >= 128 ? 128 : ((oy + 31) / 32) * 32;
    return dim3(ty, 256 / ty);
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

struct ChunkedLaunch {
    const float* truth;
    const float* pred;
    float* diff;
    float* sum;
    float* sumsq;
    float* m2;
    int bs;
    Geom g;
    int tb;
    unsigned vars;
    int nvar;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const size_t bytes = chunk_smem_bytes(nvar, tb);
        if (tb < 1 || tb > kChunkMaxTb || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
        const cudaError_t e = allow_smem(diff_stats_chunked_kernel<Cell>, bytes);
        if (e != cudaSuccess) return (int)e;
        const dim3 grid((g.oy + kChunkTY - 1) / kChunkTY, (g.ox + kChunkTX - 1) / kChunkTX,
                        (g.ot + tb - 1) / tb);
        diff_stats_chunked_kernel<Cell><<<grid, kChunkThreads, bytes, stream>>>(
            truth, pred, diff, sum, sumsq, m2, bs, g, cell, tb, vars, nvar);
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
// (tap_off int32 [ntaps], tap_w float32 [ntaps], on the device), 7-8 the
// JOREK continuity and temperature residuals (rows float32 [nx], the major
// radius of each input row, on the device; dc and kc JOREK's D and K; K1,
// K2 and K3 only, kinds 7-8 are refused by K9). k is the stencil's extent
// (3 for kinds 0-5 and 7-8).

CPPRE_EXPORT int cppre_stencil_residual(int kind, const void* fields, void* out, int bs,
                                        int nvar, int nt, int nx, int ny, int k, float cxy,
                                        float cty, float ctx, float nu, float dt,
                                        const void* tap_off, const void* tap_w, int ntaps,
                                        const void* rows, float dc, float kc, int take_abs,
                                        void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    return with_cell<true>(a, ResidualLaunch{(const float*)fields, (float*)out, bs,
                                       make_geom(nvar, nt, nx, ny, k), take_abs,
                                       (cudaStream_t)stream});
}

// m2 may be null: then the centred second pass is skipped.
CPPRE_EXPORT int cppre_joint_cp_diff_stats(int kind, const void* truth, const void* pred,
                                           void* diff, int diff_bf16, void* sum, void* sumsq,
                                           void* m2, int bs, int nvar, int nt, int nx, int ny,
                                           int k, float cxy, float cty, float ctx, float nu,
                                           float dt, const void* tap_off, const void* tap_w,
                                           int ntaps, const void* rows, float dc, float kc,
                                           void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    return with_cell<true>(a, DiffStatsLaunch{(const float*)truth, (const float*)pred, diff,
                                        diff_bf16, (float*)sum, (float*)sumsq, (float*)m2, bs,
                                        make_geom(nvar, nt, nx, ny, k), (cudaStream_t)stream});
}

// K3 for 3-wide cells (kinds 0-8; a tap table built for the window's
// strides, frames of 10 x 34; JOREK's rows table for the input grid).
// t_block: interior frames per chunk, 1..8, such that the window fits
// shared memory. m2 may be null.
CPPRE_EXPORT int cppre_joint_cp_diff_stats_chunked(int kind, const void* truth, const void* pred,
                                                   void* diff, void* sum, void* sumsq, void* m2,
                                                   int bs, int nvar, int nt, int nx, int ny,
                                                   int t_block, float cxy, float cty, float ctx,
                                                   float nu, float dt, const void* tap_off,
                                                   const void* tap_w, int ntaps, const void* rows,
                                                   float dc, float kc, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    const unsigned vars = nvar >= 32 ? cell_vars(kind) : cell_vars(kind) & ((1u << nvar) - 1u);
    return with_cell<true>(a, ChunkedLaunch{(const float*)truth, (const float*)pred, (float*)diff,
                                      (float*)sum, (float*)sumsq, (float*)m2, bs,
                                      make_geom(nvar, nt, nx, ny, 3), t_block, vars, nvar,
                                      (cudaStream_t)stream});
}

CPPRE_EXPORT int cppre_joint_cp_scores_single_pass(int kind, const void* truth,
                                                   const void* pred, void* scores, int bs,
                                                   int nvar, int nt, int nx, int ny, int k,
                                                   float cxy, float cty, float ctx, float nu,
                                                   float dt, const void* tap_off,
                                                   const void* tap_w, int ntaps,
                                                   const void* rows, float dc, float kc,
                                                   float eps, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    return with_cell(a, ScoresLaunch{(const float*)truth, (const float*)pred,
                                     (unsigned int*)scores, bs, make_geom(nvar, nt, nx, ny, k),
                                     eps, (cudaStream_t)stream});
}
