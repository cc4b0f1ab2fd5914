// Flat-layout joint-CP kernels for Hopper (sm_90a): K10, K11 and K12.
//
// Replace the Pallas kernels of cppre/ops/pallas/flat_kernels.py, which merge
// the two spatial axes into one, L = Nx * Ny, and evaluate the residual over
// the flat window j in [0, Lo), Lo = L - 2 off, of the x-interior (off = Ny,
// or Ny + 1 for a 3x3x3 tap table with a corner tap):
//   K10 _flat_paired_absdiff_stats: truth, prediction [BS, Nvar, Nt, L] ->
//       |d| [BS, Nt-2, Lo], d = PRE(truth) - PRE(pred), and the sum and sum
//       of squares of d over the batch [Nt-2, Lo].
//   K11 _flat_residual_kernel: fields [BS, Nvar, Nt, L] -> PRE [BS, Nt-2, Lo].
//   K12 _flat_absdiff_stats_from_res: prediction and the truth's residual
//       (K11's output) -> K10's outputs.
//
// On the TPU the layout exists to avoid padding Ny to 128 lanes; Hopper has
// no such padding, so these kernels keep only the layout's contract. The
// flat output j is the cell whose centre is the flat index F = off + j, at
// (x, y) = divmod(F, Ny); its +-1 and +-Ny neighbours are the ones the cells
// of stencil_cells.cuh read with row stride Ny, so each kernel calls the
// shared cell at (t, x = 0, y = F - Ny - 1) with the sample's own strides.
// The columns where y wraps (y = 0 or Ny - 1) read into the neighbouring
// rows, as the TPU's lane shifts do: deterministic garbage, which the scores
// mask. Since K10, K11 and K12 call one cell, K11 then K12 gives K10's bits.
//
// Bound by memory, like K1: a cell's taps are served by L1/L2. K10 is K1's
// kernel (diff_stats.cuh) on the flat index map: its cells are 1 x Lo
// planes of output frames, its input pointers moved by off - Ny - 1 floats
// (`flat_geom`), so K1's walk, with U samples in flight, lanes where the
// cells are few and the fold in sample order, forms its moments, and the
// store is |d|. Where Ny is not a multiple of 64 a block takes 32 cells of
// a row and the 32 below them (`FlatBandCells`), else K1's 64 in a run;
// lane 0 folds groups of at most 8 samples, and the MHD continuity cell
// keeps 2 samples in flight. A 7-tap table goes by value, as
// K1's does. K11 and K12 keep their first design: one thread per output
// (K11) or per (t, j) looping over b = 0..BS-1 in order (K12), in f32
// registers.

#include <algorithm>

#include "common.cuh"
#include "diff_stats.cuh"

namespace {

constexpr int kFlatThreads = 128;

// K11: grid ceil(BS * ot * Lo / kFlatThreads), one thread per (b, t, j).
template <class Cell>
__global__ void __launch_bounds__(kFlatThreads)
flat_residual_kernel(const float* __restrict__ fields, float* __restrict__ out, int bs, Geom g,
                     int off, int lo, Cell cell) {
    const long long ncell = (long long)g.ot * lo;
    const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (id >= bs * ncell) return;
    const int b = (int)(id / ncell);
    const long long r = id - b * ncell;
    const int t = (int)(r / lo), j = (int)(r % lo);
    out[id] = cell(fields + (long long)b * g.sample, g, t, 0, off + j - g.ny - 1);
}

// K12: the truth's residual read from res [BS, ot, Lo]; one thread per (t, j).
template <class Cell>
__global__ void __launch_bounds__(kFlatThreads)
flat_from_res_kernel(const float* __restrict__ pred, const float* __restrict__ res,
                     float* __restrict__ absdiff, float* __restrict__ sum,
                     float* __restrict__ sumsq, int bs, Geom g, int off, int lo, Cell cell) {
    const long long ncell = (long long)g.ot * lo;
    const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (id >= ncell) return;
    const int t = (int)(id / lo), j = (int)(id % lo);
    const int yc = off + j - g.ny - 1;
    float s = 0.0f, q = 0.0f;
    for (int b = 0; b < bs; ++b) {
        const long long at = (long long)b * ncell + id;
        const float d = __ldg(res + at) - cell(pred + (long long)b * g.sample, g, t, 0, yc);
        absdiff[at] = fabsf(d);
        s += d;
        q += d * d;
    }
    sum[id] = s;
    sumsq[id] = q;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kFlatThreads - 1) / kFlatThreads); }

// K11 and K12: `which` 11 or 12.
struct FlatLaunch {
    int which;
    const float* a;   // fields (K11), prediction (K12)
    const float* b;   // the truth's residual (K12)
    float* out;       // the residual (K11), |d| (K12)
    float* sum;
    float* sumsq;
    int bs;
    Geom g;
    int off, lo;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const long long ncell = (long long)g.ot * lo;
        if (which == 11) {
            flat_residual_kernel<Cell><<<blocks_for(bs * ncell), kFlatThreads, 0, stream>>>(
                a, out, bs, g, off, lo, cell);
        } else if (which == 12) {
            flat_from_res_kernel<Cell><<<blocks_for(ncell), kFlatThreads, 0, stream>>>(
                a, b, out, sum, sumsq, bs, g, off, lo, cell);
        } else {
            return (int)cudaErrorInvalidValue;
        }
        return (int)cudaGetLastError();
    }
};

// K10's geometry: K1's for an output plane of 1 x Lo cells of each output
// frame, with the input's row Ny. Flat cell j is K1's cell (t, 0, j), whose
// centre lies Ny + j + 1 floats into frame t + 1; the inputs are moved by
// off - Ny - 1 floats so that it is flat index off + j (`flat_shift`).
Geom flat_geom(int nvar, int nt, int nx, int ny, int lo) {
    Geom g = make_geom(nvar, nt, nx, ny, 3);
    g.ox = 1;
    g.oy = lo;
    return g;
}
long long flat_shift(int ny, int off) { return (long long)off - ny - 1; }

// K10's samples in flight: K1's (`SamplesInFlight`), but 2 for the MHD
// continuity and energy cells, and for those two the centred pass, which
// K10 never runs, compiled out (`SkipsCentred`). Device ms on the H100 at
// [100, 6, 20, 128, 128] (PERF.md): continuity 0.40 at K1's 4, 0.392 so;
// energy 0.81 at 4 and at 2 with the pass kept, 0.690 so (K11 then K12
// 0.732). Momentum stays at 4 with the pass kept (0.780; 0.86 at 2, 0.79
// with the pass out; K11 then K12 0.775), as do gauss (0.222; 0.262 at 2)
// and induction.
template <class Cell>
struct FlatSamplesInFlight {
    static constexpr int value = SamplesInFlight<Cell>::value;
};
template <int EQ>
struct FlatSamplesInFlight<Mhd<EQ>> {
    static constexpr int value = EQ == kContinuity || EQ == kEnergy ? 2 : 4;
};
template <int EQ>
struct SkipsCentred<Mhd<EQ>, AbsDiff>
    : std::integral_constant<bool, EQ == kContinuity || EQ == kEnergy> {};

// K10's lanes: K1's rule (every block resident at once), with a group of
// at most 8 samples (lanes x U) for lane 0 to fold: at wave [1000, 20, 64,
// 64] the 7-tap cell (U = 4) took 0.81-0.86 ms at 3 lanes against 0.51-0.56
// at 2, the 9-tap one (U = 1) 1.33-1.40 at 3 against 1.88-1.96 at 2
// (H100; PERF.md).
constexpr int kFlatMaxGroup = 8;

// K10: K1's kernel with |d| stored; with `grid` set it only reports the
// launch (grid[0] blocks, grid[1] threads a block). Its blocks take K1's
// runs of 64 flat cells where a row of Ny is a whole number of runs, and
// two rows of 32 (`FlatBandCells`) where K1's runs would straddle rows: at
// NS (Ny 100) the bands took 0.317 ms against 0.335 for the runs, at wave
// (Ny 64) 1.0-1.13 against 0.51-0.56 (H100; PERF.md).
struct FlatPairedLaunch {
    const float* truth;
    const float* pred;
    float* absdiff;
    float* sum;
    float* sumsq;
    int bs;
    Geom g;
    long long shift;
    cudaStream_t stream;
    long long* grid = nullptr;

    template <class Cell>
    int operator()(const Cell& cell) const {
        return g.ny % kDiffCells == 0 ? run<Cell, PlaneCells>(cell) : run<Cell, FlatBandCells>(cell);
    }

    template <class Cell, class Map>
    int run(const Cell& cell) const {
        constexpr int U = FlatSamplesInFlight<Cell>::value;
        const auto kernel = diff_stats_kernel<Cell, AbsDiff, U, Map>;
        const long long blocks = diff_stats_blocks<Map>(g);
        if (bs < 1 || blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        int sms = 0;
        const cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const int lanes = std::min(kFlatMaxGroup / U, diff_stats_lanes<U>(kernel, blocks, sms));
        if (grid != nullptr) {
            grid[0] = blocks;
            grid[1] = (long long)kDiffCells * lanes;
            return (int)cudaSuccess;
        }
        kernel<<<(unsigned)blocks, kDiffCells * lanes, diff_stats_smem_bytes(lanes, U), stream>>>(
            truth + shift, pred + shift, (AbsDiff*)absdiff, sum, sumsq, nullptr, bs, lanes, g,
            cell);
        return (int)cudaGetLastError();
    }
};

bool flat_window_ok(int nx, int ny, int off) {
    return nx * ny - 2 * off > 0 && off >= ny && off <= ny + 1;
}

}  // namespace

// K11 and K12. which: 11 (a fields -> out residual; b, sum, sumsq unused) or
// 12 (a prediction, b the truth's residual -> out |d|, sum, sumsq). kind and
// the cell arguments as in stencil_kernels.cu (3-wide cells only; a tap
// table built for [Nt, Nx, Ny]; the JOREK kinds, which the JAX package has no
// flat instance of, are refused). off: the flat window's margin, Ny or Ny +
// 1; Lo = Nx * Ny - 2 off.
CPPRE_EXPORT int cppre_flat_kernel(int which, int kind, const void* a, const void* b, void* out,
                                   void* sum, void* sumsq, int bs, int nvar, int nt, int nx,
                                   int ny, int off, float cxy, float cty, float ctx, float nu,
                                   float dt, const void* tap_off, const void* tap_w, int ntaps,
                                   const void* rows, float dc, float kc, void* stream) {
    const CellArgs c{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    const int lo = nx * ny - 2 * off;
    return with_cell(c, FlatLaunch{which, (const float*)a, (const float*)b, (float*)out,
                                   (float*)sum, (float*)sumsq, bs, make_geom(nvar, nt, nx, ny, 3),
                                   off, lo, (cudaStream_t)stream});
}

// K10: truth and prediction [BS, nvar, Nt, Nx * Ny] -> |d| [BS, Nt-2, Lo],
// sum and sumsq [Nt-2, Lo]. Cells as cppre_flat_kernel's; a tap table goes
// by value from host_off / host_w where its count has an instance, else from
// the device table tap_off / tap_w.
CPPRE_EXPORT int cppre_flat_paired(int kind, const void* truth, const void* pred, void* absdiff,
                                   void* sum, void* sumsq, int bs, int nvar, int nt, int nx,
                                   int ny, int off, float cxy, float cty, float ctx, float nu,
                                   float dt, const void* tap_off, const void* tap_w, int ntaps,
                                   const void* rows, float dc, float kc, const void* host_off,
                                   const void* host_w, void* stream) {
    CellArgs c{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    c.host_off = (const int*)host_off;
    c.host_w = (const float*)host_w;
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    return with_cell_by_value(c, FlatPairedLaunch{(const float*)truth, (const float*)pred,
                                                  (float*)absdiff, (float*)sum, (float*)sumsq, bs,
                                                  flat_geom(nvar, nt, nx, ny, nx * ny - 2 * off),
                                                  flat_shift(ny, off), (cudaStream_t)stream});
}

// The blocks K10 launches and the threads of each (grid[0], grid[1]) for the
// arguments of cppre_flat_paired (no data pointers are read); by_value: the
// tap table goes by value.
CPPRE_EXPORT int cppre_flat_paired_grid(int kind, int bs, int nvar, int nt, int nx, int ny,
                                        int off, int ntaps, int by_value, long long* grid) {
    static const int table[kByValueTaps] = {};   // only the instance is chosen from it
    CellArgs c{kind, 0.f, 0.f, 0.f, 0.f, 0.f, table, table, ntaps, nullptr, 0.f, 0.f};
    if (by_value) {
        c.host_off = table;
        c.host_w = (const float*)table;
    }
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    FlatPairedLaunch launch{nullptr, nullptr, nullptr, nullptr, nullptr, bs,
                            flat_geom(nvar, nt, nx, ny, nx * ny - 2 * off), flat_shift(ny, off),
                            nullptr};
    launch.grid = grid;
    return with_cell_by_value(c, launch);
}
