// PRE stencil kernels for Hopper (sm_90a): the residual alone (K2), a
// constant tap table's residual marching through shared memory (K8), the
// paired joint-CP diff plus cross-batch moments (K1) and its time-chunked,
// shared-memory-staged twin (K3), and the joint-CP scores in one launch
// with no staged diff (K9). Every kernel body is a template over a *cell*
// (stencil_cells.cuh): the function that evaluates one residual at one
// output cell of one sample. K1, K2, K3 and K9 call the very same cell, so
// the diff K9 scores is the diff K1 stores, and K3's diff, sum and sum of
// squares are K1's. K1 and K8 take a tap table by value where its count has
// an instance (`TapsByValue`), with the same arithmetic tap for tap.
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
// held one whole trajectory in VMEM; here K1, K2 and K9 let neighbouring
// threads read neighbouring y addresses (coalesced) and leave a tap's reuse
// by adjacent cells to L1/L2, and K8 copies each input frame of a tile into
// shared memory once and reads its taps there.
//
// Cross-batch moments (K1, K3, K9): the TPU kernel carries sum/sumsq from
// one grid step to the next, relying on the TPU running its grid in order.
// CUDA blocks run in no order, so each thread owns its interior cells and
// loops over the batch b = 0..BS-1 itself, accumulating in f32 registers in
// that fixed order: no atomics, bit-stable, independent of the launch shape.
// So K1's parallelism is its cells: it keeps several samples' loads in
// flight per thread (`SamplesInFlight`) and, where the cells are few,
// several threads per cell (lanes), and folds each group in sample order.
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
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "stencil_cells.cuh"

namespace {

// ---- K2: the residual ---------------------------------------------------------
// grid (BS * ot, ceil(ox / blockDim.y)); threads along y.
template <class Cell>
__global__ void residual_kernel(const float* __restrict__ fields, float* __restrict__ out,
                                Geom g, Cell cell) {
    const int bt = blockIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= g.ox) return;
    const int b = bt / g.ot, t = bt % g.ot;
    const float* f = fields + (long long)b * g.sample;
    float* o = out + ((long long)bt * g.ox + x) * g.oy;
    for (int y = threadIdx.x; y < g.oy; y += blockDim.x) o[y] = cell(f, g, t, x, y);
}

// ---- K8: a constant stencil, one tile of one sample marching in t ----------
// A block owns an output tile of kMarchTX rows x kMarchTY columns of one
// sample and a run of tc output frames (all of them unless the grid would
// be too small; `march_geom`). It keeps the k input frames the current
// output frame reads, plus kMarchAhead frames in flight, in a ring of
// k + kMarchAhead slots of shared memory; each slot holds the tile and its
// halo, (kMarchTX + k - 1) rows of rw >= kMarchTY + k - 1 columns (rw a
// multiple of 4, so a row's 16-byte copies stay aligned). A frame is copied
// once, with 16-byte cp.async where the rows allow (ny % 4 == 0 and an
// aligned field), else 4 bytes at a time. Each thread owns one column and
// kMarchRows rows of the tile, and adds the taps in table order from the
// ring with `Taps`'s arithmetic, so each output is K8's first design's (the
// K2 body on a `Taps` cell) to the bit.
//
// The tap table is built for the slot's strides, which the host asks for
// (`cppre_fused_stencil_residual_geom`): off = it * plane + ix * rw + iy,
// plane = rows * rw. Frame t + it lies in slot (t + it) % slots, so a
// tap's address in the ring is off + (t % slots) * plane, less the ring's
// size where that passes its end.
constexpr int kMarchTX = 16;
constexpr int kMarchTY = 64;
constexpr int kMarchThreads = 128;
constexpr int kMarchRows = kMarchTX * kMarchTY / kMarchThreads;   // 8 rows a thread
constexpr int kMarchAhead = 3;

struct MarchGeom {
    int rows, rw, plane, slots;  // a ring slot: rows x rw floats; slots of them
    int tiles_x, tiles_y;        // tiles of the output plane
    int tc, chunks;              // output frames a block marches, chunks of ot
    long long blocks;
};

// The card's SM count in *n, which sizes the grids of K1 and K8.
cudaError_t sm_count(int* n) {
    static int cached = 0;
    if (cached == 0) {
        int dev = 0, v = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        cached = v;
    }
    *n = cached;
    return cudaSuccess;
}

// The ring and the grid of K8 for bs samples of g with a k-wide stencil on
// a card of `sms` SMs. The output frames are cut into chunks only where
// bs x tiles gives fewer than 4 blocks an SM; a chunk re-reads the k - 1
// frames before it.
MarchGeom march_geom(int bs, const Geom& g, int k, int sms) {
    MarchGeom m;
    m.rows = kMarchTX + k - 1;
    m.rw = (kMarchTY + k - 1 + 3) / 4 * 4;
    m.plane = m.rows * m.rw;
    m.slots = k + kMarchAhead;
    m.tiles_x = (g.ox + kMarchTX - 1) / kMarchTX;
    m.tiles_y = (g.oy + kMarchTY - 1) / kMarchTY;
    const long long per_chunk = (long long)bs * m.tiles_x * m.tiles_y;
    const long long want = 4LL * sms;
    const int chunks =
        (int)std::min<long long>(g.ot, std::max<long long>(1, (want + per_chunk - 1) / per_chunk));
    m.tc = (g.ot + chunks - 1) / chunks;
    m.chunks = (g.ot + m.tc - 1) / m.tc;
    m.blocks = per_chunk * m.chunks;
    return m;
}

size_t march_smem_bytes(const MarchGeom& m) {
    return sizeof(float) * (size_t)m.slots * (size_t)m.plane;
}

// The tap loop of K8 unrolls 8 taps at a time for a by-value table (whose
// taps are then read in place from the constant bank) and not at all for
// the device table (unrolling it spilled).
template <class Cell>
struct MarchUnroll {
    static constexpr int value = 1;
};
template <int N>
struct MarchUnroll<TapsByValue<N>> {
    static constexpr int value = 8;
};

// 1-D grid of m.blocks: block i is tile i % tiles, then chunk, then sample.
template <class Cell>
__global__ void __launch_bounds__(kMarchThreads)
stencil_march_kernel(const float* __restrict__ field, float* __restrict__ out, Geom g,
                     MarchGeom m, int k, int vec, int take_abs, const __grid_constant__ Cell cell) {
    extern __shared__ __align__(16) float ring[];
    const int tiles = m.tiles_x * m.tiles_y;
    const int tile = (int)(blockIdx.x % tiles);
    const int rest = (int)(blockIdx.x / tiles);
    const int chunk = rest % m.chunks, b = rest / m.chunks;
    const int x0 = (tile / m.tiles_y) * kMarchTX, y0 = (tile % m.tiles_y) * kMarchTY;
    const int t0 = chunk * m.tc;
    const int nt_out = min(m.tc, g.ot - t0), nf = nt_out + k - 1;
    const float* __restrict__ src = field + (long long)b * g.sample + (long long)t0 * g.plane
                                    + (long long)x0 * g.ny + y0;
    // the part of the window inside the grid; the rest of a slot stays unset
    // and feeds only outputs past the grid's edge, which are not written
    const int wrows = min(m.rows, g.nx - x0), wcols = min(kMarchTY + k - 1, g.ny - y0);

    auto load_frame = [&](int f) {
        float* dst = ring + (f % m.slots) * m.plane;
        const float* s = src + (long long)f * g.plane;
        if (vec) {
            const int n4 = (wcols + 3) / 4;   // within the row: ny and y0 are multiples of 4
            for (int i = threadIdx.x; i < wrows * n4; i += kMarchThreads) {
                const int r = i / n4, c = 4 * (i - r * n4);
                copy_async16(dst + r * m.rw + c, s + (long long)r * g.ny + c, true);
            }
        } else {
            for (int i = threadIdx.x; i < wrows * wcols; i += kMarchThreads) {
                const int r = i / wcols, c = i - r * wcols;
                copy_async4(dst + r * m.rw + c, s + (long long)r * g.ny + c, true);
            }
        }
    };

    // frames 0 .. k - 2 + kMarchAhead, one commit group each (empty past nf)
    for (int f = 0; f < k - 1 + kMarchAhead; ++f) {
        if (f < nf) load_frame(f);
        copy_async_commit();
    }
    const int ring_size = m.slots * m.plane;
    const int ly = threadIdx.x % kMarchTY, r0 = (threadIdx.x / kMarchTY) * kMarchRows;
    const int y = y0 + ly;
    const float* base = ring + r0 * m.rw + ly;
    for (int t = 0; t < nt_out; ++t) {
        // frames t .. t + k - 1 have landed; every thread is done with t - 1
        copy_async_wait<kMarchAhead - 1>();
        __syncthreads();
        // frame t + k - 1 + kMarchAhead into the slot frame t - 1 held
        const int f = t + k - 1 + kMarchAhead;
        if (f < nf) load_frame(f);
        copy_async_commit();

        const int slot0 = (t % m.slots) * m.plane;
        float acc[kMarchRows] = {};   // each output starts from its first term
#pragma unroll (MarchUnroll<Cell>::value)
        for (int i = 0; i < cell.count(); ++i) {
            int a = cell.tap_off(i) + slot0;
            if (a >= ring_size) a -= ring_size;
            const float w = cell.tap_w(i);
#pragma unroll
            for (int j = 0; j < kMarchRows; ++j) {
                const float term = __fmul_rn(base[a + j * m.rw], w);
                acc[j] = i == 0 ? term : __fadd_rn(acc[j], term);
            }
        }
        float* o = out + (((long long)b * g.ot + t0 + t) * g.ox + x0 + r0) * g.oy + y;
#pragma unroll
        for (int j = 0; j < kMarchRows; ++j) {
            if (x0 + r0 + j < g.ox && y < g.oy) {
                o[(long long)j * g.oy] = take_abs ? fabsf(acc[j]) : acc[j];
            }
        }
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

// One sample's step of the moments: s += d, then q += d * d as one fused
// multiply-add, the rounding nvcc gave `q += d * d` in K1's first design
// (an FFMA in its SASS) and still gives it in K3.
__device__ __forceinline__ void fold(float& s, float& q, float d) {
    s = __fadd_rn(s, d);
    q = __fmaf_rn(d, d, q);
}

// A K1 block: kDiffCells consecutive cells of the (x, y) plane of one
// output frame, each walked by `lanes` threads (1 to kDiffMaxLanes): lane l
// of a cell takes samples b0 + l U .. b0 + l U + U - 1 of each group of
// lanes x U samples, stores their diffs, and leaves them in shared memory,
// where lane 0 folds the group into the cell's sums in sample order. So the
// sums are the one-lane walk's to the bit, and a grid with few cells (wave,
// JOREK) still fills the card. The host gives a launch as many lanes as
// keep all its blocks resident at once (`diff_stats_lanes`): a block walks
// the whole batch, so a second wave of blocks would double the time.
constexpr int kDiffCells = 64;
constexpr int kDiffMaxLanes = 4;

// Samples a K1 thread has in flight (U), as timed on the card at the four
// families' shapes and the grid-scaling shapes (PERF.md): 4 for the MHD
// cells, JOREK continuity and the by-value table (7 taps); 2 for NS
// momentum (4 held more registers and slowed it) and JOREK temperature (4
// spilled); 1 for the device table. ptxas spreads a group's loads among its arithmetic as its
// register budget allows, so a larger U is not more loads in flight.
template <class Cell>
struct SamplesInFlight {
    static constexpr int value = 2;
};
template <int EQ>
struct SamplesInFlight<Mhd<EQ>> {
    static constexpr int value = 4;
};
template <>
struct SamplesInFlight<Jorek<kJorekContinuity>> {
    static constexpr int value = 4;
};
template <>
struct SamplesInFlight<Taps> {
    static constexpr int value = 1;
};
template <int N>
struct SamplesInFlight<TapsByValue<N>> {
    static constexpr int value = 4;
};

// Shared memory of a K1 block: two groups of lanes x U diffs per cell.
size_t diff_stats_smem_bytes(int lanes, int u) {
    return lanes > 1 ? sizeof(float) * 2 * (size_t)lanes * u * kDiffCells : 0;
}

// 1-D grid of ot x ceil(ox * oy / kDiffCells) blocks of kDiffCells x lanes
// threads; block i holds frame i % ot, so blocks of neighbouring frames,
// which read each other's frames, run together. A thread issues the loads
// of its U samples' diffs, then stores them; with one lane it folds them
// into its sums itself, in sample order. m2 (may be null) receives the
// centred sum of squares, from a second walk in the same groups: each
// thread's own float32 stores read back, or for a bfloat16 diff the diffs
// recomputed from the inputs.
template <class Cell, typename DiffT, int U>
__global__ void __launch_bounds__(kDiffCells * kDiffMaxLanes)
diff_stats_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                  DiffT* __restrict__ diff, float* __restrict__ sum, float* __restrict__ sumsq,
                  float* __restrict__ m2, int bs, int lanes, Geom g,
                  const __grid_constant__ Cell cell) {
    extern __shared__ float group[];   // [2][lanes * U][kDiffCells]
    const int t = (int)(blockIdx.x % g.ot);
    const int lc = threadIdx.x % kDiffCells, lane = threadIdx.x / kDiffCells;
    const int i = (int)(blockIdx.x / g.ot) * kDiffCells + lc;
    const int nplane = g.ox * g.oy;
    // A thread past the plane's end (no early return: the lanes meet at
    // barriers) computes the last cell and writes nothing, so no load of a
    // group waits on a branch and the group's loads issue together.
    const bool live = i < nplane;
    const int ic = live ? i : nplane - 1;
    const int x = ic / g.oy, y = ic - x * g.oy;
    const long long ncell = (long long)g.ot * nplane;
    const long long id = (long long)t * nplane + ic;
    DiffT* __restrict__ dp = diff + id;
    const auto& rc = at_row(cell, x);   // JOREK's R and 1/R of this row, once
    auto diff_of = [&](int b) {
        const long long off = (long long)b * g.sample;
        return rc(truth + off, g, t, x, y) - rc(pred + off, g, t, x, y);
    };
    auto again = [&](int b) {
        if constexpr (std::is_same<DiffT, float>::value) {
            return (float)dp[(long long)b * ncell];   // a plain load of this thread's store
        } else {
            return diff_of(b);
        }
    };
    // One group of samples b0 .. b0 + lanes U - 1 (those below bs): this
    // thread gets its U through get(b) and hands each to keep(b, d); then
    // the group goes to take(d) in sample order, from registers with one
    // lane, else through shared memory to lane 0 alone. `full`: the whole
    // group lies below bs.
    const int gsize = lanes * U;
    auto group_step = [&](int b0, int buf, auto full, auto get, auto keep, auto take) {
        constexpr bool kFull = decltype(full)::value;
        const int first = b0 + lane * U;
        float d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) d[u] = kFull || first + u < bs ? get(first + u) : 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (kFull || first + u < bs) {
                if (live) keep(first + u, d[u]);
                if (lanes == 1) take(d[u]);
            }
        }
        if (lanes == 1) return;
        float* mine = group + (buf * gsize + lane * U) * kDiffCells + lc;
#pragma unroll
        for (int u = 0; u < U; ++u) mine[u * kDiffCells] = d[u];
        __syncthreads();
        if (lane == 0) {
            const float* all = group + buf * gsize * kDiffCells + lc;
            const int n = min(gsize, bs - b0);
            for (int j = 0; j < n; ++j) take(all[j * kDiffCells]);
        }
    };
    auto walk = [&](auto get, auto keep, auto take) {
        int b0 = 0, buf = 0;
        for (; b0 + gsize <= bs; b0 += gsize, buf ^= 1) {
            group_step(b0, buf, std::true_type{}, get, keep, take);
        }
        if (b0 < bs) group_step(b0, buf, std::false_type{}, get, keep, take);
    };

    float s = 0.0f, q = 0.0f;
    walk(diff_of, [&](int b, float d) { store(dp + (long long)b * ncell, d); },
         [&](float d) { fold(s, q, d); });
    if (lane == 0 && live) {
        sum[id] = s;
        sumsq[id] = q;
    }
    if (m2 == nullptr) return;   // uniform: every lane leaves

    // the mean to every lane, through the first group slot (its last reader,
    // lane 0's fold, finished before the barrier below)
    float mean = batch_mean(s, bs);
    if (lanes > 1) {
        __syncthreads();
        if (lane == 0) group[lc] = mean;
        __syncthreads();
        mean = group[lc];
        __syncthreads();
    }
    float acc = 0.0f;
    walk(again, [](int, float) {}, [&](float d) { acc = centred_step(acc, d, mean); });
    if (lane == 0 && live) m2[id] = acc;
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
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const dim3 block = row_block(g.oy);
        const dim3 grid((unsigned)bs * g.ot, (g.ox + block.y - 1) / block.y);
        residual_kernel<Cell><<<grid, block, 0, stream>>>(fields, out, g, cell);
        return (int)cudaGetLastError();
    }
};

// K1's grid: ot x ceil(ox * oy / kDiffCells) blocks.
long long diff_stats_blocks(const Geom& g) {
    return (long long)g.ot * (((long long)g.ox * g.oy + kDiffCells - 1) / kDiffCells);
}

// The most lanes (kDiffMaxLanes down to 2) at which every one of `blocks`
// blocks of `kernel` is resident at once on a card of `sms` SMs, else 1.
template <int U, class Kernel>
int diff_stats_lanes(Kernel kernel, long long blocks, int sms) {
    static int per_sm[kDiffMaxLanes + 1] = {};   // blocks an SM holds, by lanes
    for (int lanes = kDiffMaxLanes; lanes > 1; --lanes) {
        if (per_sm[lanes] == 0
            && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm[lanes], kernel, kDiffCells * lanes,
                   diff_stats_smem_bytes(lanes, U)) != cudaSuccess) {
            per_sm[lanes] = -1;
        }
        if (blocks <= (long long)per_sm[lanes] * sms) return lanes;
    }
    return 1;
}

// The kernel, blocks and lanes K1 launches for a cell; `launch` false only
// reports them (grid[0] blocks, grid[1] threads a block).
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
    long long* grid = nullptr;

    template <class Cell, typename DiffT>
    int run(const Cell& cell) const {
        constexpr int U = SamplesInFlight<Cell>::value;
        const auto kernel = diff_stats_kernel<Cell, DiffT, U>;
        const long long blocks = diff_stats_blocks(g);
        if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        int sms = 0;
        const cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const int lanes = diff_stats_lanes<U>(kernel, blocks, sms);
        if (grid != nullptr) {
            grid[0] = blocks;
            grid[1] = (long long)kDiffCells * lanes;
            return (int)cudaSuccess;
        }
        kernel<<<(unsigned)blocks, kDiffCells * lanes, diff_stats_smem_bytes(lanes, U), stream>>>(
            truth, pred, (DiffT*)diff, sum, sumsq, m2, bs, lanes, g, cell);
        return (int)cudaGetLastError();
    }

    template <class Cell>
    int operator()(const Cell& cell) const {
        return diff_bf16 ? run<Cell, __nv_bfloat16>(cell) : run<Cell, float>(cell);
    }
};

struct MarchLaunch {
    const float* field;
    float* out;
    int bs;
    Geom g;
    int k;
    int take_abs;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        int sms = 0;
        cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const MarchGeom m = march_geom(bs, g, k, sms);
        const size_t bytes = march_smem_bytes(m);
        if (bytes > kMaxSmem || m.blocks < 1 || m.blocks > 0x7fffffffLL) {
            return (int)cudaErrorInvalidValue;
        }
        e = allow_smem(stencil_march_kernel<Cell>, bytes);
        if (e != cudaSuccess) return (int)e;
        const int vec = g.ny % 4 == 0 && reinterpret_cast<uintptr_t>(field) % 16 == 0;
        stencil_march_kernel<Cell><<<(unsigned)m.blocks, kMarchThreads, bytes, stream>>>(
            field, out, g, m, k, vec, take_abs, cell);
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

// K2: kinds 0-5 and 7-8 (a tap table, kind 6, is K8's and K1's and is refused).
CPPRE_EXPORT int cppre_stencil_residual(int kind, const void* fields, void* out, int bs,
                                        int nvar, int nt, int nx, int ny, float cxy, float cty,
                                        float ctx, float nu, float dt, const void* rows, float dc,
                                        float kc, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, nullptr, nullptr, 0, rows, dc, kc};
    return with_cell<true, false>(a, ResidualLaunch{(const float*)fields, (float*)out, bs,
                                                   make_geom(nvar, nt, nx, ny, 3),
                                                   (cudaStream_t)stream});
}

// K8: a tap table built for the strides of K8's ring slot, which
// cppre_fused_stencil_residual_geom gives; a count with a by-value instance
// goes by value from host_off / host_w, any other from the device table
// tap_off / tap_w.
CPPRE_EXPORT int cppre_fused_stencil_residual(const void* field, void* out, int bs, int nt,
                                              int nx, int ny, int k, const void* tap_off,
                                              const void* tap_w, int ntaps,
                                              const void* host_off, const void* host_w,
                                              int take_abs, void* stream) {
    CellArgs a{kTaps, 0.f, 0.f, 0.f, 0.f, 0.f, tap_off, tap_w, ntaps, nullptr, 0.f, 0.f};
    a.host_off = (const int*)host_off;
    a.host_w = (const float*)host_w;
    return with_taps(a, MarchLaunch{(const float*)field, (float*)out, bs,
                                    make_geom(1, nt, nx, ny, k), k, take_abs,
                                    (cudaStream_t)stream});
}

// K8's geometry for bs samples of [nt, nx, ny] and a k-wide stencil: geom[0]
// and geom[1] the rows and row length of a ring slot (the strides its tap
// table is built for), geom[2] the blocks it launches on this card.
CPPRE_EXPORT int cppre_fused_stencil_residual_geom(int bs, int nt, int nx, int ny, int k,
                                                   long long* geom) {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    const MarchGeom m = march_geom(bs, make_geom(1, nt, nx, ny, k), k, sms);
    geom[0] = m.rows;
    geom[1] = m.rw;
    geom[2] = m.blocks;
    return (int)cudaSuccess;
}

// 1 if a tap table of n taps goes by value (K1, K8), else 0.
CPPRE_EXPORT int cppre_taps_by_value(int n) { return n == kByValueTaps ? 1 : 0; }

// m2 may be null: then the centred second pass is skipped. A tap table
// (kind 6) goes by value from host_off / host_w where its count has an
// instance, else from the device table tap_off / tap_w.
CPPRE_EXPORT int cppre_joint_cp_diff_stats(int kind, const void* truth, const void* pred,
                                           void* diff, int diff_bf16, void* sum, void* sumsq,
                                           void* m2, int bs, int nvar, int nt, int nx, int ny,
                                           int k, float cxy, float cty, float ctx, float nu,
                                           float dt, const void* tap_off, const void* tap_w,
                                           int ntaps, const void* rows, float dc, float kc,
                                           const void* host_off, const void* host_w,
                                           void* stream) {
    CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    a.host_off = (const int*)host_off;
    a.host_w = (const float*)host_w;
    return with_cell_by_value<true>(a, DiffStatsLaunch{(const float*)truth, (const float*)pred,
                                                       diff, diff_bf16, (float*)sum,
                                                       (float*)sumsq, (float*)m2, bs,
                                                       make_geom(nvar, nt, nx, ny, k),
                                                       (cudaStream_t)stream});
}

// The blocks K1 launches and the threads of each (grid[0], grid[1]) for
// the arguments of cppre_joint_cp_diff_stats (no data pointers are read).
CPPRE_EXPORT int cppre_joint_cp_diff_stats_grid(int kind, int diff_bf16, int nvar, int nt, int nx,
                                                int ny, int k, int ntaps, int by_value,
                                                long long* grid) {
    static const int table[kByValueTaps] = {};   // only the instance is chosen from it
    CellArgs a{kind, 0.f, 0.f, 0.f, 0.f, 0.f, table, table, ntaps, table, 0.f, 0.f};
    if (by_value) {
        a.host_off = table;
        a.host_w = (const float*)table;
    }
    DiffStatsLaunch launch{nullptr, nullptr, nullptr, diff_bf16, nullptr, nullptr, nullptr, 1,
                           make_geom(nvar, nt, nx, ny, k), nullptr};
    launch.grid = grid;
    return with_cell_by_value<true>(a, launch);
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
