// PRE stencil kernels for Hopper (sm_90a): the residual alone (K2), a
// constant tap table's residual marching through shared memory (K8), the
// paired joint-CP diff plus cross-batch moments (K1) and its time-chunked,
// shared-memory-staged twin (K3), and the joint-CP scores in one launch
// with no diff in HBM (K9). Every kernel body is a template over a *cell*
// (stencil_cells.cuh): the function that evaluates one residual at one
// output cell of one sample. K1, K2, K3 and K9 call the very same cell, so
// the diff K9 scores is the diff K1 stores, and K3's diff, sum and sum of
// squares are K1's. K1, K3 and K8 take a tap table by value where its count
// has an instance (`TapsByValue`), with the same arithmetic tap for tap.
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
// held one whole trajectory in VMEM; here K1 and K9 let neighbouring
// threads read neighbouring y addresses (coalesced) and leave a tap's reuse
// by adjacent cells to L1/L2, and K2, K3 and K8 copy each input frame of a
// tile into shared memory once and read its taps there.
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
// VMEM. Here a block owns a chunk of at most t_block output frames of an
// 8 x 32 tile and walks the batch in sample order, streaming the frames of
// each sample's window, truth and prediction together, through a ring of
// shared memory, one frame of the read variables at a time (see its
// section). Its moments are K1's fold in K1's order, so its bits are K1's.
//
// K9: the TPU kernel stashes every diff in VMEM between its two phases. At
// the MHD configuration's 128^2 grid the whole stash is ~114 MB, against
// 228 KB of shared memory per SM and 50 MB of L2; but a block of K1's shape
// (64 cells of one frame, walking the batch) needs only its own cells'
// diffs, 64 x BS floats (25.6 KB at BS = 100). So each K9 block walks the
// batch once as K1 does, keeps its diffs in shared memory, forms the sum
// and the centred sum of squares from there in K1's order, and takes the
// per-sample maximum of |diff| / mod over its cells from there; the grid's
// maximum is an atomicMax on the bits of the non-negative float, exact and
// order-free, so the scores are bit-stable. The inputs are read once and no
// diff is written. For a batch whose stash does not fit (BS above ~1 800)
// K9 keeps a recompute body that reads the inputs three times. Either way
// its arithmetic is K1's plus the epilogue's, operation for operation, so
// its scores are the two-pass route's.

#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "diff_stats.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;   // 227 KB, a block's most on sm_90

// ---- K2: the residual, each tile's frames staged in shared memory once -----
// A block owns an output tile of one sample, S.tx rows of up to S.ty
// columns, and a run of tc output frames (`residual_geom`). It stages the
// window that run reads, tc + 2 input frames of the tile and its halo, of
// each variable from the first to the last one the cell reads, in shared
// memory: each frame a slot of S.rows x S.rw floats (rw a multiple of 4,
// so a row's 16-byte copies stay aligned), copied once with cp.async,
// kResAhead frames ahead of the one computed. The window's frames lie one
// after another and do not wrap, so a cell finds its time neighbours at
// +-plane from its centre as it does in the fields, and each cell runs as
// it is on the window (`FromShared`): the same arithmetic, so the same
// bits, as the cell that reads the fields from HBM. The window's strides
// are compile-time constants (`res_shape`, `ResWindow`), so every tap of a
// cell is an immediate offset from one shared-memory address. A run of
// frames re-reads the two frames before it (from L2, as its neighbour
// run's block runs beside it); a ring of slots would save that only by
// copying the two frames its wrap needs twice, for the same shared memory.
// Each thread owns one column of the tile and up to S.rows_a_thread of its
// rows, g rows of threads apart.
//
// The tile follows the plane and the cell: an output row wider than 32
// takes tiles of up to 64 columns, a narrower one of 32, and the tile's
// width splits the row into near-equal parts (NS 98 -> 2 x 52, MHD 126 ->
// 2 x 64, JOREK 30 -> 32). A tile has 16 rows of up to 64 columns or 32 of
// up to 32, 4 rows a thread, or half as many rows where the cell reads
// more than 3 variables (MHD induction, momentum, energy), so that a
// window still holds a few frames. A window holds as many frames as fit
// `res_smem_budget`; the frames are cut into more runs where bs x tiles
// gives fewer than 4 blocks an SM.
constexpr int kResThreads = 256;
constexpr int kResAhead = 5;
// Shared memory a block's windows may take: a third of the SM's 228 KB, less
// the 1 KB a block reserves, for a cell of at most 3 variables, so that 3
// blocks an SM hide each other's copies; half for a cell of more (MHD
// induction, momentum, energy), whose windows would hold too few frames.
__host__ __device__ constexpr size_t res_smem_budget(int windows) {
    return windows <= 3 ? 233472 / 3 - 1024 : 233472 / 2 - 1024;
}

__host__ __device__ constexpr int lowest_var(unsigned vars) {
    int v = 0;
    while (!((vars >> v) & 1u)) ++v;
    return v;
}
__host__ __device__ constexpr int res_windows(unsigned vars) {
    int hi = 31;
    while (!((vars >> hi) & 1u)) --hi;
    return hi - lowest_var(vars) + 1;
}

// A window's frame for a cell reading `vars`, narrow or wide: rows x rw
// floats of a tile of tx rows and up to ty columns, each thread taking up
// to rows_a_thread of them; and the frames a window holds.
struct ResShape {
    int ty, tx, rows_a_thread, rw, rows, slot, frames;
};
__host__ __device__ constexpr ResShape res_shape(bool narrow, unsigned vars) {
    const int ty = narrow ? 32 : 64;
    const int per_thread = res_windows(vars) <= 3 ? 4 : 2;
    const int tx = kResThreads / ty * per_thread;
    const int slot = (tx + 2) * (ty + 4);
    const int frames =
        (int)(res_smem_budget(res_windows(vars)) / (sizeof(float) * res_windows(vars) * slot));
    return ResShape{ty, tx, per_thread, ty + 4, tx + 2, slot, frames};
}

// The kind of a cell type (K2's and K3's cells).
template <class Cell>
struct KindOf;
template <>
struct KindOf<NsMomentum> {
    static constexpr int value = kNsMomentum;
};
template <int EQ>
struct KindOf<Mhd<EQ>> {
    static constexpr int value = EQ;
};
template <int EQ>
struct KindOf<Jorek<EQ>> {
    static constexpr int value = EQ;
};
template <>
struct KindOf<Taps> {
    static constexpr int value = kTaps;
};
template <int N>
struct KindOf<TapsByValue<N>> {
    static constexpr int value = kTaps;
};

// The windows of a cell, narrow or wide, at compile time: variables vlo ..
// vlo + nwin - 1, each res_shape(...).frames frames, variable v's at
// (v - vlo) * field floats; so every stride a cell reads in them is a
// constant.
template <class Cell, bool Narrow>
struct ResWindow {
    static constexpr unsigned vars = cell_vars(KindOf<Cell>::value);
    static constexpr int vlo = lowest_var(vars);
    static constexpr int nwin = res_windows(vars);
    static constexpr int field = res_shape(Narrow, vars).frames * res_shape(Narrow, vars).slot;
    static_assert(res_shape(Narrow, vars).frames >= 3,
                  "a window holds at least one output frame's three");
};

struct ResidualGeom {
    int narrow;                // tiles of up to 32 columns, else 64 (`res_shape`)
    int tx, ty, g;             // output tile; g rows of ty threads
    int tiles_x, tiles_y;      // tiles of the output plane
    int tc, chunks;            // output frames a block runs, runs of ot
    int nwin;                  // variables with a window
    long long blocks;
    size_t smem;
};

// K2's geometry for bs samples of g whose cell reads the variables of the
// bit mask `vars`, on a card of `sms` SMs (blocks = 0: none fits).
ResidualGeom residual_geom(int bs, const Geom& g, unsigned vars, int sms) {
    ResidualGeom m{};
    if (vars == 0u || bs < 1 || g.ot < 1 || g.ox < 1 || g.oy < 1) return m;
    m.narrow = g.oy <= res_shape(true, vars).ty;
    const ResShape S = res_shape(m.narrow, vars);
    m.tx = S.tx;
    m.tiles_y = (g.oy + S.ty - 1) / S.ty;
    m.ty = ((g.oy + m.tiles_y - 1) / m.tiles_y + 3) / 4 * 4;
    m.g = kResThreads / m.ty;
    m.tiles_x = (g.ox + m.tx - 1) / m.tx;
    m.nwin = res_windows(vars);
    const long long per_chunk = (long long)bs * m.tiles_x * m.tiles_y;
    const long long tc_max = std::min<long long>(S.frames - 2, g.ot);
    const long long want = 4LL * sms;
    long long chunks = std::max((g.ot + tc_max - 1) / tc_max,
                                std::min<long long>(g.ot, (want + per_chunk - 1) / per_chunk));
    m.tc = (int)((g.ot + chunks - 1) / chunks);
    m.chunks = (g.ot + m.tc - 1) / m.tc;
    m.blocks = per_chunk * m.chunks;
    m.smem = sizeof(float) * m.nwin * (size_t)S.frames * S.slot;
    return m;
}

// 1-D grid of m.blocks: block i is tile i % tiles, then run, then sample;
// m.g * m.ty threads. vec: 16-byte copies (ny % 4 == 0, an aligned field).
template <class Cell, bool Narrow>
__global__ void __launch_bounds__(kResThreads, 2)
residual_window_kernel(const float* __restrict__ fields, float* __restrict__ out, Geom g,
                       ResidualGeom m, int vec, const __grid_constant__ Cell cell) {
    using W = ResWindow<Cell, Narrow>;
    constexpr ResShape S = res_shape(Narrow, W::vars);
    extern __shared__ __align__(16) float win[];
    const int tiles = m.tiles_x * m.tiles_y;
    const int tile = (int)(blockIdx.x % tiles);
    const int rest = (int)(blockIdx.x / tiles);
    const int chunk = rest % m.chunks, b = rest / m.chunks;
    const int x0 = (tile / m.tiles_y) * S.tx, y0 = (tile % m.tiles_y) * m.ty;
    const int t0 = chunk * m.tc;
    const int nt_out = min(m.tc, g.ot - t0), nf = nt_out + 2;
    const float* __restrict__ src = fields + (long long)b * g.sample + (long long)t0 * g.plane
                                    + (long long)x0 * g.ny + y0;
    // the part of the window inside the grid; the rest of a slot stays unset
    // and feeds only outputs past the grid's edge, which are not computed
    const int wrows = min(S.rows, g.nx - x0), wcols = min(m.ty + 2, g.ny - y0);
    // copies: a thread takes one 16-byte (or 4-byte) column of every
    // `step`-th row of each variable's frame
    const int ncol = vec ? (wcols + 3) / 4 : wcols;
    const int crow = threadIdx.x / ncol, ccol = threadIdx.x - crow * ncol;
    const int step = blockDim.x / ncol;
    const bool copier = crow < step;

    auto load_frame = [&](int f) {
        if (!copier) return;
#pragma unroll
        for (int v = W::vlo; v < W::vlo + W::nwin; ++v) {
            if (!((W::vars >> v) & 1u)) continue;
            float* dst = win + (v - W::vlo) * W::field + f * S.slot;
            const float* s = src + v * g.field + (long long)f * g.plane;
            for (int r = crow; r < wrows; r += step) {
                if (vec) {
                    copy_async16(dst + r * S.rw + 4 * ccol, s + (long long)r * g.ny + 4 * ccol, true);
                } else {
                    copy_async4(dst + r * S.rw + ccol, s + (long long)r * g.ny + ccol, true);
                }
            }
        }
    };
    // frames 0 .. kResAhead - 1, one commit group each (empty past nf)
    for (int f = 0; f < kResAhead; ++f) {
        if (f < nf) load_frame(f);
        copy_async_commit();
    }

    // the window's strides, as the cell reads them; variable v's window
    // starts at wbase + v * w.field
    Geom w = g;
    w.nt = S.frames;
    w.nx = S.rows;
    w.ny = S.rw;
    w.plane = S.slot;
    w.field = W::field;
    const float* wbase = win - W::vlo * W::field;
    // this thread's rows: whether each is in the output, and its cell (JOREK's
    // with its row's R and 1/R, read and divided once; the R table moves
    // with the window)
    const int ly = threadIdx.x % m.ty, lg = threadIdx.x / m.ty;
    const bool col = y0 + ly < g.oy && lg < m.g;
    using RowCell = std::decay_t<decltype(at_row(cell, 0))>;
    RowCell rc[S.rows_a_thread];
    bool live[S.rows_a_thread];
#pragma unroll
    for (int i = 0; i < S.rows_a_thread; ++i) {
        const int r = lg + i * m.g;
        live[i] = col && r < S.tx && x0 + r < g.ox;
        rc[i] = at_row(at_rows(cell, x0), live[i] ? r : 0);
    }
    for (int j = 0; j < nt_out; ++j) {
        // frames .. j + 2 have landed, everyone's
        copy_async_wait<kResAhead - 3>();
        __syncthreads();
        const int f = j + kResAhead;   // no slot is reused: nothing waits for the readers
        if (f < nf) load_frame(f);
        copy_async_commit();
        float* o = out + (((long long)b * g.ot + t0 + j) * g.ox + x0) * g.oy + y0 + ly;
#pragma unroll
        for (int i = 0; i < S.rows_a_thread; ++i) {
            const int r = lg + i * m.g;
            if (live[i]) o[(long long)r * g.oy] = rc[i](wbase, w, j, r, ly, FromShared());
        }
    }
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

// ---- K3: diff and moments, time-chunked through shared memory --------------
// A block owns an output tile of kChunkTX x kChunkTY cells and a chunk of tc
// output frames (at most the caller's t_block), and walks the whole batch in
// sample order, as K1's threads do: each thread owns one column of the tile
// and one row, so one cell of each of the tc frames, and keeps its tc sums
// and sums of squares in registers, folded in sample order (`fold`, K1's
// rounding). Each sample's window, tc + 2 frames of the tile and its halo,
// streams through shared memory one frame at a time, kChunkAhead frames
// ahead of the one computed; a frame slot holds the truth's and the
// prediction's frame of every variable from the first to the last one the
// cell reads (`ChunkWindow`), copied once with cp.async. Each step (one
// barrier) computes the output frame whose last input frame just landed,
// truth and prediction together, d = cell(truth) - cell(pred) as K1 forms
// it: the cell, its arithmetic and the batch order are K1's, so are the
// bits.
//
// The ring holds m windows of tc + 2 slots (m = 1, or 2 where a window is
// too short to keep kChunkAhead frames in flight, `chunk_windows`; each
// block counts its own, the last chunk's window may be shorter): sample b's
// window takes slots (b % m)(tc + 2) onwards, so it never wraps and every
// cell finds its time neighbours at +-slot from its centre; its strides are
// compile-time constants (as K2's are), so every tap is an immediate offset.
// A slot is refilled only after its frame's last reader (the output frame
// two steps on) has passed the barrier before the refill.
//
// Why this shape (H100; PERF.md): a first design streamed the truth's
// window, then the prediction's, each through half the shared memory (2.8
// steps an output cell-sample at tc = 5, 0.98 ms at the grid-scaling NS
// shape); a ring of frames 3 ahead, with the two frames its wrap reads
// copied twice, took 1.19 ms there. A ring of whole sample windows of both
// tensors (the TPU kernel's double buffer) would hold 2 x 3 x 7 frames of
// the NS cell, 121 KB at tc = 5, one block an SM. One window of both
// tensors is 60 KB at tc = 5: three blocks an SM, 1.4 steps an output
// cell-sample.
//
// Per input value, shared memory takes (tc + 2) / tc x 10 / 8 x 36 / 32
// copies (16-byte copies; 34 / 32 with 4-byte ones): 1.97x at tc = 5,
// against the ~4.3 row reads a K1 block's taps make of each value through
// L1 and L2. The frames a block takes are chosen in C (`chunk_geom`) for
// the fewest frame steps on the card's SMs, so a small plane (JOREK's 32 x
// 32) takes one output frame a block and 38 chunks of its 4 tiles.
constexpr int kChunkTX = 8;                          // output rows of a tile
constexpr int kChunkTY = 32;                         // output columns of a tile
constexpr int kChunkThreads = kChunkTX * kChunkTY;   // one cell of each frame a thread
constexpr int kChunkRows = kChunkTX + 2;             // a window frame: rows ...
constexpr int kChunkRW = kChunkTY + 4;               // ... of rw floats, a multiple of 4
constexpr int kChunkFrame = kChunkRows * kChunkRW;   // one variable's frame, floats
constexpr int kChunkMaxTb = 8;                       // output frames a block may take
constexpr int kChunkAhead = 2;                       // frames in flight ahead of the computed one

// Windows of tc + 2 frames a ring holds: enough that kChunkAhead frames
// load while the three an output frame reads stay put.
__host__ __device__ constexpr int chunk_windows(int tc) {
    return (kChunkAhead + 3 + tc + 1) / (tc + 2);
}
// Frame slots of the ring of a block taking tc output frames.
__host__ __device__ constexpr int chunk_slots(int tc) { return chunk_windows(tc) * (tc + 2); }

// A cell's window at compile time: variables vlo .. vlo + nwin - 1, each a
// kChunkFrame, the truth's then the prediction's, so a slot (one frame of
// both) is the time stride; and the blocks an SM holds by registers (three,
// two for the cells whose two residuals in flight outgrow a third of the
// SM's registers: ptxas spilled them at three).
template <class Cell>
struct ChunkWindow {
    static constexpr unsigned vars = cell_vars(KindOf<Cell>::value);
    static constexpr int vlo = lowest_var(vars);
    static constexpr int nwin = res_windows(vars);
    static constexpr int tensor = nwin * kChunkFrame;   // one tensor's frame
    static constexpr int slot = 2 * tensor;
    static constexpr int per_sm = KindOf<Cell>::value == kContinuity
                                  || KindOf<Cell>::value == kEnergy ? 2 : 3;
};

struct ChunkGeom {
    int tiles_x, tiles_y;   // tiles of the output plane
    int tc, chunks;         // output frames a block takes, chunks of ot
    int slots;              // the largest ring a block of the launch keeps
    int per_sm;             // blocks an SM holds (shared memory, registers)
    long long blocks;
    size_t smem;
};

// K3's geometry for g, a cell with nwin windows of which an SM holds at
// most `per_sm` blocks by registers, the caller's t_block, on a card of
// `sms` SMs (blocks = 0: nothing to run). tc in 1 .. min(t_block,
// kChunkMaxTb, ot) takes the fewest steps on the card: its blocks' frames,
// (tc + 2) a sample, times the waves of blocks the SMs hold at once (by
// registers and by the shared memory of the larger of its chunks' rings,
// the full ones' and the last one's); ties go to the larger tc, which reads
// fewer halo frames.
ChunkGeom chunk_geom(int t_block, const Geom& g, int nwin, int per_sm, int sms) {
    ChunkGeom best{};
    if (t_block < 1 || g.ot < 1 || g.ox < 1 || g.oy < 1 || nwin < 1) return best;
    const int tiles_x = (g.ox + kChunkTX - 1) / kChunkTX;
    const int tiles_y = (g.oy + kChunkTY - 1) / kChunkTY;
    const long long tiles = (long long)tiles_x * tiles_y;
    long long fewest = -1;
    for (int tc = std::min(std::min(t_block, kChunkMaxTb), g.ot); tc >= 1; --tc) {
        const int chunks = (g.ot + tc - 1) / tc, last = g.ot - (chunks - 1) * tc;
        const int slots = std::max(chunk_slots(tc), chunk_slots(last));
        const size_t smem = sizeof(float) * 2 * (size_t)nwin * kChunkFrame * slots;
        const int on_sm = std::min<int>(per_sm, (int)(233472 / (smem + 1024)));
        if (smem > kMaxSmem || on_sm < 1) continue;
        const long long blocks = tiles * chunks, wave = (long long)on_sm * sms;
        const long long steps = (tc + 2LL) * ((blocks + wave - 1) / wave);
        if (fewest < 0 || steps < fewest) {
            fewest = steps;
            best = ChunkGeom{tiles_x, tiles_y, tc, chunks, slots, on_sm, blocks, smem};
        }
    }
    return best;
}

// The cell a thread of a window that starts at input row x0 calls for its
// row lx: JOREK's bound to that row's R and 1/R, read and divided once (the
// R table moves with the window); any other the kernel's own parameter.
template <class Cell>
__device__ __forceinline__ const Cell& window_row_cell(const Cell& c, int, int) {
    return c;
}
template <int EQ>
__device__ __forceinline__ JorekRow<EQ> window_row_cell(const Jorek<EQ>& c, int x0, int lx) {
    return at_row(at_rows(c, x0), lx);
}

// 1-D grid of m.blocks of kChunkThreads: block i is chunk i % chunks of
// tile i / chunks, so the chunks of a tile, which read each other's halo
// frames, run together. vec: 16-byte copies (ny % 4 == 0, aligned fields).
// m2 (may be null) receives the centred sum of squares, from each thread's
// own diff stores read back, as K1 forms it.
template <class Cell>
__global__ void __launch_bounds__(kChunkThreads, ChunkWindow<Cell>::per_sm)
diff_stats_chunked_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                          float* __restrict__ diff, float* __restrict__ sum,
                          float* __restrict__ sumsq, float* __restrict__ m2, int bs, Geom g,
                          ChunkGeom m, int vec, const __grid_constant__ Cell cell) {
    using W = ChunkWindow<Cell>;
    extern __shared__ __align__(16) float ring[];
    const int chunk = (int)(blockIdx.x % m.chunks), tile = (int)(blockIdx.x / m.chunks);
    const int x0 = (tile / m.tiles_y) * kChunkTX, y0 = (tile % m.tiles_y) * kChunkTY;
    const int t0 = chunk * m.tc;
    const int tc = min(m.tc, g.ot - t0), nf = tc + 2;   // output frames, frames a window
    const int windows = chunk_windows(tc);                // this block's ring
    // the part of a frame inside the grid; the rest of a slot stays unset and
    // feeds only cells past the grid's edge, which store nothing
    const int wrows = min(kChunkRows, g.nx - x0), wcols = min(kChunkTY + 2, g.ny - y0);
    // copies: threads 0-127 the truth's, 128-255 the prediction's; a thread
    // takes one 16-byte (or 4-byte) column of every `step`-th row of each
    // variable's frame
    const int half = threadIdx.x / (kChunkThreads / 2), ct = threadIdx.x % (kChunkThreads / 2);
    const int ncol = vec ? (wcols + 3) / 4 : wcols;
    const int crow = ct / ncol, ccol = ct - crow * ncol;
    const int step = (kChunkThreads / 2) / ncol;
    const int width = vec ? 4 : 1;
    const float* __restrict__ src0 = (half ? pred : truth) + (long long)t0 * g.plane
                                     + (long long)(x0 + crow) * g.ny + y0 + width * ccol;
    float* const dst0 = ring + half * W::tensor + crow * kChunkRW + width * ccol;

    // frame f of sample b into its slot
    auto load = [&](int b, int f) {
        if (b >= bs || crow >= step) return;
        const float* s = src0 + (long long)b * g.sample + (long long)f * g.plane;
        float* d = dst0 + ((b % windows) * nf + f) * W::slot;
#pragma unroll
        for (int v = W::vlo; v < W::vlo + W::nwin; ++v) {
            if (!((W::vars >> v) & 1u)) continue;
            const float* sv = s + v * g.field;
            float* dv = d + (v - W::vlo) * kChunkFrame;
            for (int r = 0; crow + r < wrows; r += step) {
                if (vec) {
                    copy_async16(dv + r * kChunkRW, sv + (long long)r * g.ny, true);
                } else {
                    copy_async4(dv + r * kChunkRW, sv + (long long)r * g.ny, true);
                }
            }
        }
    };
    // the stream's next frame to load: frame lf of sample lb
    int lb = 0, lf = 0;
    auto load_next = [&]() {
        load(lb, lf);
        copy_async_commit();
        if (++lf == nf) {
            lf = 0;
            ++lb;
        }
    };
    for (int a = 0; a < kChunkAhead; ++a) load_next();

    // the window's strides, as the cell reads them: a slot a frame, a
    // kChunkFrame a variable, kChunkRW a row; all compile-time constants
    Geom w = g;
    w.nx = kChunkRows;
    w.ny = kChunkRW;
    w.plane = W::slot;
    w.field = kChunkFrame;
    const int ly = threadIdx.x % kChunkTY, lx = threadIdx.x / kChunkTY;
    const int x = x0 + lx, y = y0 + ly;
    const bool live = x < g.ox && y < g.oy;
    const auto& rc = window_row_cell(cell, x0, live ? lx : 0);
    const long long ncell = (long long)g.ot * g.ox * g.oy;
    const long long id0 = ((long long)t0 * g.ox + x) * g.oy + y;   // cell of output frame t0
    const long long fstride = (long long)g.ox * g.oy;

    float s[kChunkMaxTb], q[kChunkMaxTb];
#pragma unroll
    for (int k = 0; k < kChunkMaxTb; ++k) s[k] = q[k] = 0.0f;
    for (int b = 0; b < bs; ++b) {
        const float* base = ring + (b % windows) * nf * W::slot - W::vlo * kChunkFrame;
#pragma unroll
        for (int f = 0; f < kChunkMaxTb + 2; ++f) {
            if (f >= nf) break;
            // frame f has landed, everyone's; every thread is done with the
            // frame the next load replaces
            copy_async_wait<kChunkAhead - 1>();
            __syncthreads();
            load_next();
            if (f < 2) continue;
            const int j = f - 2;   // the output frame whose last frame is f
            const float d = rc(base, w, j, lx, ly, FromShared())
                            - rc(base + W::tensor, w, j, lx, ly, FromShared());
            if (live) diff[(long long)b * ncell + id0 + j * fstride] = d;
            fold(s[j], q[j], d);
        }
    }
    if (!live) return;
#pragma unroll
    for (int j = 0; j < kChunkMaxTb; ++j) {
        if (j >= tc) break;
        const long long id = id0 + j * fstride;
        sum[id] = s[j];
        sumsq[id] = q[j];
        if (m2 != nullptr) {
            // this thread's own stores, read back (plain loads), as K1 does
            const float mean = batch_mean(s[j], bs);
            float acc = 0.0f;
            for (int b = 0; b < bs; ++b) acc = centred_step(acc, diff[(long long)b * ncell + id], mean);
            m2[id] = acc;
        }
    }
}

// ---- K9: single-pass scores ----------------------------------------------------
// A maximum that keeps a NaN, as torch.amax does.
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// A K9 block with a stash: kStashCells (or half as many, for a larger
// batch) consecutive cells of the (x, y) plane of one output frame, each
// walked by `lanes` threads, as K1's blocks are. Pass 1: lane l of a cell
// takes samples l U .. l U + U - 1 of each group of lanes x U samples, U in
// flight (`SamplesInFlight`, K1's), and stores each diff in the stash
// [bs][cells] in shared memory, never in HBM. Then lane 0 of each cell
// folds the stash in sample order into the sum (K1's fold), the mean, the
// centred sum of squares (`centred_step`) and the modulation sqrt(m2 / n) +
// eps. Pass 3: warp w takes samples w, w + warps, ..., reads one sample's
// stashed diffs a row at a time (consecutive words: no bank conflict) and
// takes the maximum of |diff| / mod over the block's cells; atomicMax on
// the bits of the non-negative float (a NaN's bits exceed every number's)
// takes it to the grid. The inputs are read once, and the arithmetic is
// the recompute body's to the bit.
constexpr int kStashCells = 64;
// Pass 1 reads a cell's taps through L1, where the neighbouring cells'
// loads hit. With the SM's 256 KB of L1 and shared memory all free for
// stashes, 8 stashes of 64 cells at BS = 100 leave L1 ~50 KB; K9 asks for
// half of it as shared memory (4 stashes) and leaves the rest to L1, and
// takes 2 threads a cell where its blocks do not all fit at once: of the
// settings timed on the H100, the fastest (PERF.md, tools/stencil_variants.py).
constexpr int kStashCarveout = 50;
constexpr int kStashLanes = 2;

// Shared memory of a K9 block with a stash: the stash, then the modulation.
size_t stash_smem_bytes(int bs, int cells) {
    return sizeof(float) * ((size_t)bs + 1) * (size_t)cells;
}

// 1-D grid of ot x ceil(ox * oy / cells) blocks of cells x lanes threads;
// block i holds frame i % ot. scores holds the bits of BS non-negative
// floats, `stride` words apart, zeroed by the caller.
template <class Cell, int U>
__global__ void __launch_bounds__(kStashCells * kDiffMaxLanes)
scores_stash_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                    unsigned int* __restrict__ scores, int stride, int bs, int cells, int lanes,
                    Geom g, const __grid_constant__ Cell cell, float eps) {
    extern __shared__ float stash[];   // [bs][cells], then mod [cells]
    float* modv = stash + (size_t)bs * cells;
    const int t = (int)(blockIdx.x % g.ot);
    const int lc = threadIdx.x % cells, lane = threadIdx.x / cells;
    const int first = (int)(blockIdx.x / g.ot) * cells;
    const int nplane = g.ox * g.oy;
    // a thread past the plane's end computes the last cell; pass 3 leaves
    // its column out
    const int ic = min(first + lc, nplane - 1);
    const int x = ic / g.oy, y = ic - x * g.oy;
    auto diff_of = [&](int b) {
        const long long off = (long long)b * g.sample;
        return cell(truth + off, g, t, x, y) - cell(pred + off, g, t, x, y);
    };

    // pass 1: every diff into the stash, U samples in flight
    const int gsize = lanes * U;
    int b0 = lane * U;
    for (; b0 + U <= bs; b0 += gsize) {
        float d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) d[u] = diff_of(b0 + u);
#pragma unroll
        for (int u = 0; u < U; ++u) stash[(size_t)(b0 + u) * cells + lc] = d[u];
    }
    for (int b = b0; b < bs; ++b) stash[(size_t)b * cells + lc] = diff_of(b);
    __syncthreads();

    // the sum in sample order as K1 forms it, then the centred sum of
    // squares as K1 forms it, then the modulation as the score epilogue
    // forms it: sqrt(m2 / n) + eps
    if (lane == 0) {
        float s = 0.0f;
        for (int b = 0; b < bs; ++b) s = __fadd_rn(s, stash[(size_t)b * cells + lc]);
        const float mean = batch_mean(s, bs);
        float acc = 0.0f;
        for (int b = 0; b < bs; ++b) acc = centred_step(acc, stash[(size_t)b * cells + lc], mean);
        modv[lc] = __fadd_rn(sqrtf(__fmul_rn(acc, 1.0f / (float)bs)), eps);
    }
    __syncthreads();

    // pass 3: |diff| / mod, maximised per sample over the block's cells
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int nlive = min(cells, nplane - first);
    for (int b = warp; b < bs; b += nwarps) {
        const float* row = stash + (size_t)b * cells;
        float r = 0.0f;
        for (int c = wl; c < nlive; c += 32) r = nan_max(r, fabsf(row[c]) / modv[c]);
        for (int o = 16; o > 0; o >>= 1) r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
        if (wl == 0) atomicMax(scores + (size_t)b * stride, __float_as_uint(r));
    }
}

// The recompute body: K9's route where even a stash of kStashCells / 2
// cells does not fit a block's shared memory (bs above ~1 800). One cell a
// thread, three passes over the batch, each diff recomputed from the inputs
// with the same cell, so the scores are the stash body's to the bit.
constexpr int kScoreThreads = 256;

// 1-D grid over the interior cells, one cell per thread. scores holds the
// bits of BS non-negative floats, `stride` words apart, zeroed by the caller.
template <class Cell>
__global__ void __launch_bounds__(kScoreThreads)
scores_single_pass_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                          unsigned int* __restrict__ scores, int stride, int bs, Geom g, Cell cell,
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
            atomicMax(scores + (size_t)b * stride, __float_as_uint(m));
        }
    }
}

// ---- host side ---------------------------------------------------------------
// The variables (bit v for variable v) K2's cell of `kind` reads, 0 where
// the kind is not K2's or the fields have fewer variables.
unsigned residual_vars(int kind, int nvar) {
    if (kind < kNsMomentum || kind > kJorekTemperature || kind == kTaps) return 0u;
    const unsigned vars = cell_vars(kind);
    return nvar < 32 && (vars >> nvar) != 0u ? 0u : vars;
}

// K2's geometry on this card, for bs samples of g and a cell reading `vars`.
cudaError_t residual_geom_here(int bs, const Geom& g, unsigned vars, ResidualGeom* m) {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    *m = residual_geom(bs, g, vars, sms);
    if (m->blocks < 1 || m->blocks > 0x7fffffffLL || m->smem > kMaxSmem) {
        return cudaErrorInvalidValue;
    }
    return cudaSuccess;
}

struct ResidualLaunch {
    const float* fields;
    float* out;
    int bs;
    Geom g;
    unsigned vars;
    cudaStream_t stream;

    template <class Cell, bool Narrow>
    int run(const Cell& cell, const ResidualGeom& m) const {
        const auto kernel = residual_window_kernel<Cell, Narrow>;
        const cudaError_t e = allow_smem(kernel, m.smem);
        if (e != cudaSuccess) return (int)e;
        const int vec = g.ny % 4 == 0 && reinterpret_cast<uintptr_t>(fields) % 16 == 0;
        kernel<<<(unsigned)m.blocks, m.g * m.ty, m.smem, stream>>>(fields, out, g, m, vec, cell);
        return (int)cudaGetLastError();
    }

    template <class Cell>
    int operator()(const Cell& cell) const {
        ResidualGeom m;
        const cudaError_t e = residual_geom_here(bs, g, vars, &m);
        if (e != cudaSuccess) return (int)e;
        return m.narrow ? run<Cell, true>(cell, m) : run<Cell, false>(cell, m);
    }
};

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

// K3's launch for a cell; with `geom` set it only reports it: blocks,
// threads a block, shared bytes, the tile's rows and columns, the output
// frames a block takes, the chunks of ot, the variables with a window, a
// ring slot's rows (both tensors' frames of each windowed variable) and row
// length (the strides its tap table is built for), the largest ring's slots
// and the blocks an SM holds.
struct ChunkedLaunch {
    const float* truth;
    const float* pred;
    float* diff;
    float* sum;
    float* sumsq;
    float* m2;
    int bs;
    Geom g;
    int t_block;
    cudaStream_t stream;
    long long* geom = nullptr;

    template <class Cell>
    int operator()(const Cell& cell) const {
        using W = ChunkWindow<Cell>;
        int sms = 0;
        cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const ChunkGeom m = chunk_geom(t_block, g, W::nwin, W::per_sm, sms);
        if (bs < 1 || m.blocks < 1 || m.blocks > 0x7fffffffLL || m.smem > kMaxSmem) {
            return (int)cudaErrorInvalidValue;
        }
        if (geom != nullptr) {
            const long long r[12] = {m.blocks,  kChunkThreads, (long long)m.smem, kChunkTX,
                                     kChunkTY,  m.tc,          m.chunks,          W::nwin,
                                     W::slot / kChunkRW, kChunkRW, m.slots,       m.per_sm};
            std::copy(r, r + 12, geom);
            return (int)cudaSuccess;
        }
        const auto kernel = diff_stats_chunked_kernel<Cell>;
        e = allow_smem(kernel, m.smem);
        if (e != cudaSuccess) return (int)e;
        const int vec = g.ny % 4 == 0 && reinterpret_cast<uintptr_t>(truth) % 16 == 0
                        && reinterpret_cast<uintptr_t>(pred) % 16 == 0;
        kernel<<<(unsigned)m.blocks, kChunkThreads, m.smem, stream>>>(
            truth, pred, diff, sum, sumsq, m2, bs, g, m, vec, cell);
        return (int)cudaGetLastError();
    }
};

// The most lanes (kDiffMaxLanes down to 2) at which every one of `blocks`
// K9 stash blocks of `cells` cells and `smem` bytes is resident at once on a
// card of `sms` SMs (as `diff_stats_lanes` chooses K1's), else
// kStashLanes.
template <class Kernel>
int stash_lanes(Kernel kernel, int cells, size_t smem, long long blocks, int sms) {
    for (int lanes = kDiffMaxLanes; lanes > kStashLanes; --lanes) {
        int per_sm = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, cells * lanes, smem)
                == cudaSuccess
            && blocks <= (long long)per_sm * sms) {
            return lanes;
        }
    }
    return kStashLanes;
}

// K9's route by shape: a stash of kStashCells cells where it fits a block's
// shared memory, else of half as many, else (cells = 0) the recompute body.
int stash_cells(int bs) {
    for (int cells = kStashCells; cells >= kStashCells / 2; cells /= 2) {
        if (stash_smem_bytes(bs, cells) <= kMaxSmem) return cells;
    }
    return 0;
}

// K9: the stash body or, for a batch too large for its stash, the
// recompute body. With `geom` set it only reports the launch: geom[0] the
// stash's cells (0: the recompute body), then blocks, threads a block,
// shared bytes and lanes.
struct ScoresLaunch {
    const float* truth;
    const float* pred;
    unsigned int* scores;
    int stride;
    int bs;
    Geom g;
    float eps;
    cudaStream_t stream;
    long long* geom = nullptr;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const int cells = stash_cells(bs);
        const long long ncell = (long long)g.ot * g.ox * g.oy;
        if (bs < 1 || ncell < 1) return (int)cudaErrorInvalidValue;
        if (cells == 0) {
            const long long blocks = (ncell + kScoreThreads - 1) / kScoreThreads;
            if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
            if (geom != nullptr) {
                const long long r[5] = {0, blocks, kScoreThreads, 0, 1};
                std::copy(r, r + 5, geom);
                return (int)cudaSuccess;
            }
            scores_single_pass_kernel<Cell><<<(unsigned)blocks, kScoreThreads, 0, stream>>>(
                truth, pred, scores, stride, bs, g, cell, eps);
            return (int)cudaGetLastError();
        }
        constexpr int U = SamplesInFlight<Cell>::value;
        const auto kernel = scores_stash_kernel<Cell, U>;
        const long long blocks = (long long)g.ot * (((long long)g.ox * g.oy + cells - 1) / cells);
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        const size_t smem = stash_smem_bytes(bs, cells);
        cudaError_t e = allow_smem(kernel, smem);
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     kStashCarveout);
        }
        if (e != cudaSuccess) return (int)e;
        int sms = 0;
        e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const int lanes = stash_lanes(kernel, cells, smem, blocks, sms);
        if (geom != nullptr) {
            const long long r[5] = {cells, blocks, (long long)cells * lanes, (long long)smem, lanes};
            std::copy(r, r + 5, geom);
            return (int)cudaSuccess;
        }
        kernel<<<(unsigned)blocks, cells * lanes, smem, stream>>>(truth, pred, scores, stride, bs,
                                                                  cells, lanes, g, cell, eps);
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
                                                   residual_vars(kind, nvar),
                                                   (cudaStream_t)stream});
}

// K2's launch for the arguments of cppre_stencil_residual (kinds 0-5, 7-8)
// on this card: geom[0..7] = blocks, threads a block, shared bytes, the
// tile's rows and columns, the output frames a block runs, the runs, and
// the variables with a window.
CPPRE_EXPORT int cppre_stencil_residual_geom(int kind, int bs, int nvar, int nt, int nx, int ny,
                                             long long* geom) {
    ResidualGeom m;
    const cudaError_t e =
        residual_geom_here(bs, make_geom(nvar, nt, nx, ny, 3), residual_vars(kind, nvar), &m);
    if (e != cudaSuccess) return (int)e;
    const long long r[8] = {m.blocks, (long long)m.g * m.ty, (long long)m.smem, m.tx, m.ty,
                            m.tc, m.chunks, m.nwin};
    std::copy(r, r + 8, geom);
    return (int)cudaSuccess;
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

// K3 for 3-wide cells (kinds 0-8; a tap table built for the strides of a
// ring slot, which cppre_joint_cp_diff_stats_chunked_geom gives, by value
// from host_off / host_w where its count has an instance; JOREK's rows
// table for the input grid). t_block >= 1 bounds the output frames a block
// takes. m2 may be null.
CPPRE_EXPORT int cppre_joint_cp_diff_stats_chunked(int kind, const void* truth, const void* pred,
                                                   void* diff, void* sum, void* sumsq, void* m2,
                                                   int bs, int nvar, int nt, int nx, int ny,
                                                   int t_block, float cxy, float cty, float ctx,
                                                   float nu, float dt, const void* tap_off,
                                                   const void* tap_w, int ntaps, const void* rows,
                                                   float dc, float kc, const void* host_off,
                                                   const void* host_w, void* stream) {
    if (nt < 3 || nx < 3 || ny < 3 || (nvar < 32 && (cell_vars(kind) >> nvar) != 0u)) {
        return (int)cudaErrorInvalidValue;
    }
    CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    a.host_off = (const int*)host_off;
    a.host_w = (const float*)host_w;
    return with_cell_by_value<true>(a, ChunkedLaunch{(const float*)truth, (const float*)pred,
                                                     (float*)diff, (float*)sum, (float*)sumsq,
                                                     (float*)m2, bs, make_geom(nvar, nt, nx, ny, 3),
                                                     t_block, (cudaStream_t)stream});
}

// K3's launch for the arguments of cppre_joint_cp_diff_stats_chunked on this
// card (no data pointers are read): geom[0..11] as `ChunkedLaunch` reports it.
CPPRE_EXPORT int cppre_joint_cp_diff_stats_chunked_geom(int kind, int bs, int nvar, int nt, int nx,
                                                        int ny, int t_block, long long* geom) {
    if (nt < 3 || nx < 3 || ny < 3 || (nvar < 32 && (cell_vars(kind) >> nvar) != 0u)) {
        return (int)cudaErrorInvalidValue;
    }
    static const int table[kByValueTaps] = {};   // only the instance is chosen from it
    CellArgs a{kind, 0.f, 0.f, 0.f, 0.f, 0.f, table, table, 1, table, 0.f, 0.f};
    ChunkedLaunch launch{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, bs,
                         make_geom(nvar, nt, nx, ny, 3), t_block, nullptr};
    launch.geom = geom;
    return with_cell_by_value<true>(a, launch);
}

// scores: the bits of sample b's score at scores[b * score_stride], zeroed
// by the caller.
CPPRE_EXPORT int cppre_joint_cp_scores_single_pass(int kind, const void* truth,
                                                   const void* pred, void* scores,
                                                   int score_stride, int bs,
                                                   int nvar, int nt, int nx, int ny, int k,
                                                   float cxy, float cty, float ctx, float nu,
                                                   float dt, const void* tap_off,
                                                   const void* tap_w, int ntaps,
                                                   const void* rows, float dc, float kc,
                                                   float eps, void* stream) {
    const CellArgs a{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    return with_cell(a, ScoresLaunch{(const float*)truth, (const float*)pred,
                                     (unsigned int*)scores, score_stride, bs,
                                     make_geom(nvar, nt, nx, ny, k), eps, (cudaStream_t)stream});
}

// K9's launch for the arguments of cppre_joint_cp_scores_single_pass on
// this card (no data pointers are read): geom[0] the stash's cells (0: the
// recompute body), geom[1..4] blocks, threads a block, shared bytes, lanes.
CPPRE_EXPORT int cppre_joint_cp_scores_single_pass_geom(int kind, int bs, int nvar, int nt,
                                                        int nx, int ny, int k,
                                                        long long* geom) {
    static const int table[1] = {};   // only the instance is chosen from it
    const CellArgs a{kind, 0.f, 0.f, 0.f, 0.f, 0.f, table, table, 1, nullptr, 0.f, 0.f};
    ScoresLaunch launch{nullptr, nullptr, nullptr, 1, bs, make_geom(nvar, nt, nx, ny, k), 0.f,
                        nullptr};
    launch.geom = geom;
    return with_cell(a, launch);
}
