// The walk of K1 over the batch, shared by stencil_kernels.cu (K1, and the
// helpers K9 takes from it) and flat_kernels.cu (K10, K12).
//
// K1 (_joint_cp_diff_stats) and K10 (_flat_paired_absdiff_stats) compute
// the same thing on two index maps: the diff d = PRE(truth) - PRE(pred) of
// every output cell of every sample, and its sum and sum of squares over the
// batch in sample order. K1's cells are the (x, y) plane of each output
// frame; K10's are the flat window j in [0, Lo) of the x-interior, the cell
// whose centre is the flat index off + j. K10 launches K1's kernel on a
// geometry that makes one map the other (`flat_geom` in flat_kernels.cu):
// an output plane of 1 x Lo cells, so cell j sits at (x, y) = (0, j), and
// input pointers moved by off - Ny - 1 floats, so the cell there reads the
// taps of flat centre off + j with the sample's own strides. Where K1's
// runs would straddle rows, K10's blocks take their cells two rows deep
// (`FlatBandCells`). What differs is the store: K1 stores d (float32 or
// bfloat16), K10 |d| (`AbsDiff`); and only K1 asks for the centred second
// pass. K10 passes no m2, so that pass never runs in K10; its instances
// keep the float32 form of it (read the stores back), so they compile as
// K1's float32 instances do, but for the cells that compile it out
// (`SkipsCentred`, flat_kernels.cu), where that was faster on the H100.
// With the pass compiled out, or in its recompute form, for every cell,
// ptxas gave K10's cells other register counts: 12 B spilled at MHD energy
// with 4 samples in flight, 101 registers at NS (PERF.md). One body, so
// K10's moments are K1's walk and fold to the bit.
//
// K12 (_flat_absdiff_stats_from_res) is K10 with the truth's side read, not
// computed: its diff element (`AbsDiffFromRes`, `ReadsResidual`) makes the
// walk load the truth's residual [BS, ot, Lo] (K11's output) at the
// sample's (t, j), which the walk's id and ncell already index, in place of
// the truth's cell. The prediction's cell, the walk, its groups and the
// fold are K10's, so K11 then K12 gives K10's bits; it never runs the
// centred pass. The choice is made at compile time, so K1's and K10's
// instances compile as they did.
#pragma once

#include <cuda_bf16.h>
#include <type_traits>

#include "stencil_cells.cuh"

namespace {

// The card's SM count in *n, which sizes the grids of K1, K2, K3, K8, K9
// and K10.
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

// ---- K1: diff and moments ------------------------------------------------------
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// K10's diff element: the kernel stores |d| through it (four bytes, a float's
// layout, so the output is a float32 tensor).
struct AbsDiff {
    float v;
};
__device__ __forceinline__ void store(AbsDiff* p, float v) { p->v = fabsf(v); }
// K12's diff element: |d| as K10 stores it, d = the truth's residual read
// from memory - the prediction's cell.
struct AbsDiffFromRes {
    float v;
};
__device__ __forceinline__ void store(AbsDiffFromRes* p, float v) { p->v = fabsf(v); }
template <typename DiffT>
struct ReadsResidual : std::false_type {};
template <>
struct ReadsResidual<AbsDiffFromRes> : std::true_type {};
// A float32 store read back (K1's centred pass).
__device__ __forceinline__ float stored(const float* p) { return *p; }
__device__ __forceinline__ float stored(const AbsDiff* p) { return p->v; }
__device__ __forceinline__ float stored(const AbsDiffFromRes* p) { return p->v; }

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

// The index maps of the walk: block k of an output frame, thread lc of its
// kDiffCells -> its cell of the frame's ox * oy (a value past the end is no
// cell; the thread computes the last one and stores nothing).
// K1: kDiffCells consecutive cells of the (x, y) plane; the kernel keeps
// this map's index line as K1's first design wrote it, so K1's instances
// compile as they did (a map call in its place moved three of their
// register counts and K1 NS's time on the H100; PERF.md).
struct PlaneCells {
    static __host__ __device__ __forceinline__ long long blocks(const Geom& g) {
        return ((long long)g.ox * g.oy + kDiffCells - 1) / kDiffCells;
    }
};
// K10 (ox = 1, oy = Lo, the flat window; ny the input's row): the window in
// bands of two rows of Ny cells, a block taking 32 cells of the bands' first
// rows, counted on across bands, and the 32 directly below them (+Ny), so
// the x-neighbour taps of one warp are the centre taps of the other and hit
// in L1.
struct FlatBandCells {
    static constexpr int kHalf = kDiffCells / 2;
    static __host__ __device__ __forceinline__ long long blocks(const Geom& g) {
        const long long top = (g.oy + 2LL * g.ny - 1) / (2LL * g.ny) * g.ny;
        return (top + kHalf - 1) / kHalf;
    }
    static __device__ __forceinline__ int cell(int k, int lc, int ny) {
        const int top = k * kHalf + lc % kHalf;   // a position in the bands' first rows
        const int band = top / ny;
        return (2 * band + lc / kHalf) * ny + (top - band * ny);
    }
};

// Shared memory of a K1 block: two groups of lanes x U diffs per cell.
size_t diff_stats_smem_bytes(int lanes, int u) {
    return lanes > 1 ? sizeof(float) * 2 * (size_t)lanes * u * kDiffCells : 0;
}

// Whether an instance compiles the centred pass out: no K1 instance does,
// every K12 instance does; flat_kernels.cu names the K10 cells that do.
template <class Cell, typename DiffT>
struct SkipsCentred : std::false_type {};
template <class Cell>
struct SkipsCentred<Cell, AbsDiffFromRes> : std::true_type {};

// 1-D grid of ot x Map::blocks(g) blocks of kDiffCells x lanes threads
// (K10: ox = 1, oy = Lo, `FlatBandCells`); block i holds frame i % ot, so
// blocks of neighbouring frames, which read each other's frames, run
// together. A thread issues the loads of its U samples' diffs, then stores
// them; with one lane it folds them into its sums itself, in sample order.
// m2 (may be null) receives the centred sum of squares, from a second walk
// in the same groups: each thread's own float32 stores read back, or for a
// bfloat16 diff the diffs recomputed from the inputs (K10 and K12 never
// ask for it). K12's `truth` is the truth's residual [BS, ot, Lo].
template <class Cell, typename DiffT, int U, class Map = PlaneCells>
__global__ void __launch_bounds__(kDiffCells * kDiffMaxLanes)
diff_stats_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                  DiffT* __restrict__ diff, float* __restrict__ sum, float* __restrict__ sumsq,
                  float* __restrict__ m2, int bs, int lanes, Geom g,
                  const __grid_constant__ Cell cell) {
    extern __shared__ float group[];   // [2][lanes * U][kDiffCells]
    const int t = (int)(blockIdx.x % g.ot);
    const int lc = threadIdx.x % kDiffCells, lane = threadIdx.x / kDiffCells;
    int i = (int)(blockIdx.x / g.ot) * kDiffCells + lc;
    if constexpr (!std::is_same<Map, PlaneCells>::value) {
        i = Map::cell((int)(blockIdx.x / g.ot), lc, g.ny);   // K10's map
    }
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
        if constexpr (ReadsResidual<DiffT>::value) {
            return __ldg(truth + (long long)b * ncell + id) - rc(pred + off, g, t, x, y);
        } else {
            return rc(truth + off, g, t, x, y) - rc(pred + off, g, t, x, y);
        }
    };
    auto again = [&](int b) {
        if constexpr (std::is_same<DiffT, __nv_bfloat16>::value) {
            return diff_of(b);
        } else {
            return stored(dp + (long long)b * ncell);   // a plain load of this thread's store
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
    if constexpr (SkipsCentred<Cell, DiffT>::value) return;
    if (m2 == nullptr) return;   // uniform: every lane leaves (K10 always)

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

// K1's grid (K10's, with its map): ot x the blocks of a frame.
template <class Map = PlaneCells>
long long diff_stats_blocks(const Geom& g) {
    return (long long)g.ot * Map::blocks(g);
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

}  // namespace
