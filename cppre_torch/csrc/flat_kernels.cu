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
// Bound by memory, like K1. K10 is K1's kernel (diff_stats.cuh) on the
// flat index map: its cells are 1 x Lo planes of output frames, its input
// pointers moved by off - Ny - 1 floats (`flat_geom`), so K1's walk, with U
// samples in flight, lanes where the cells are few and the fold in sample
// order, forms its moments, and the store is |d|. Where Ny is not a
// multiple of 64 a block takes 32 cells of a row and the 32 below them
// (`FlatBandCells`), else K1's 64 in a run; lane 0 folds groups of at most
// 8 samples, and the MHD continuity and energy cells keep 2 samples in
// flight. A 7-tap table goes by value, as K1's does. K12 is the same walk with the
// truth's residual read in place of the truth's cell (`AbsDiffFromRes`),
// with its own samples in flight (`FromResSamplesInFlight`).
//
// K11 (`flat_span_kernel`): a block owns one sample and a span of S
// consecutive flat outputs, and marches the output frames. The inputs of a
// span's frame are one contiguous flat range, off + j0 - Ny - 1 to off + j0
// + S + Ny + 1; copied whole, it gives the y-wrap columns the values the
// flat layout reads, with no special case. A ring in shared memory holds
// 3 + kSpanAhead frames of that range for each variable the cell reads,
// each copied once with cp.async (16 bytes where the frames are 16-byte
// aligned, else 4), and the cells read it through `FromShared` with the
// slot's strides (frames a slot apart, rows Ny). For the six-variable MHD
// cells, which were faster so on the H100, and where the ring would not
// fit a block's shared memory (rows of some thousand floats), K11 keeps
// its first design, one thread an output reading through L1/L2
// (`flat_residual_kernel`).

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "diff_stats.cuh"

namespace {

constexpr int kFlatThreads = 128;

// K11's first design, kept for the six-variable cells and where K11's ring
// does not fit shared memory:
// grid ceil(BS * ot * Lo / kFlatThreads), one thread per (b, t, j); the tap
// table at the fields' strides.
template <class Cell>
__global__ void __launch_bounds__(kFlatThreads)
flat_residual_kernel(const float* __restrict__ fields, float* __restrict__ out, int bs, Geom g,
                     int off, int lo, const __grid_constant__ Cell cell) {
    const long long ncell = (long long)g.ot * lo;
    const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (id >= bs * ncell) return;
    const int b = (int)(id / ncell);
    const long long r = id - b * ncell;
    const int t = (int)(r / lo), j = (int)(r % lo);
    out[id] = cell(fields + (long long)b * g.sample, g, t, 0, off + j - g.ny - 1);
}

// ---- K11: a flat span of one sample marching in t ----------------------------
// Output frame t reads input frames t, t + 1 and t + 2, which a cell finds a
// slot apart: frame f lies in slot f % kSpanRing, and a frame in slot 0 or 1
// is copied, from the ring, into slot kSpanRing or kSpanRing + 1 before the
// first output frame that reads it there, so the three frames of every
// output frame lie in consecutive slots, wherever the ring wraps. A slot
// holds the span's range of one frame of one variable, from a 16-byte
// boundary at or below its start; the ring of each variable from the first
// to the last one the cell reads (`cell_vars`) follows the one before it
// (an unread variable between them, MHD induction's p, keeps its ring
// unfilled).
//
// Why this shape (H100, device ms at chip_smoke's flat shapes; PERF.md):
// the wrap's copies taken from memory, 2 of every 5 frames read twice,
// took NS 0.146 against 0.138 so, wave 0.254 against 0.232, MHD induction
// 0.372 against 0.349; 1, 3 or 4 frames ahead, 128 or 512 threads, three
// blocks an SM, one block of 512 an SM, spans of whole rounds of threads
// were slower or level. The six-variable cells (MHD momentum, energy)
// keep the first design: on spans of 404 outputs, their halo 65 % of the
// span, they took 0.560 and 0.541 against its 0.340 and 0.313.
constexpr int kSpanThreads = 256;
constexpr int kSpanAhead = 2;                     // frames in flight ahead of the three read
constexpr int kSpanRing = 3 + kSpanAhead;         // slots a frame can take
constexpr int kSpanSlots = kSpanRing + 2;         // and the two copies at the wrap
constexpr int kSpanMax = 2048;                    // outputs a span, at most
constexpr int kSpanMin = 64;                      // and at least
constexpr long long kSpanBudget = 110 * 1024;     // shared memory a block, for two an SM
constexpr long long kSpanSmemMax = 227 * 1024;    // a block's most
constexpr int kSpanMaxRings = 5;                  // cells with more rings run the first design

struct SpanGeom {
    int span, spans;        // outputs of a frame a block takes (the last span of a frame
                            // fewer), spans of the window
    int slot;               // floats of a ring slot
    int first, rings;       // variables first .. first + rings - 1 have a ring
    unsigned vars;          // the variables copied (bit v for variable v)
    int tc, chunks;         // output frames a block marches, chunks of ot
    long long blocks;
    long long smem;         // bytes; above kSpanSmemMax the first design runs
};

// K11's spans and grid for bs samples of g, window Lo, a cell reading
// `vars`, on a card of `sms` SMs: the longest span whose ring keeps two
// blocks on an SM (kSpanBudget), then spans of equal length; the output
// frames are cut into chunks only where bs x spans gives fewer than two
// blocks an SM (a chunk re-reads the two frames before it).
SpanGeom span_geom(unsigned vars, int bs, const Geom& g, int lo, int sms) {
    SpanGeom m{};
    int first = 0, last = 31;
    while (!(vars >> first & 1u)) ++first;
    while (!(vars >> last & 1u)) --last;
    m.first = first;
    m.rings = last - first + 1;
    m.vars = vars;
    const long long fit = kSpanBudget / ((long long)sizeof(float) * kSpanSlots * m.rings);
    const long long longest =
        std::min<long long>(kSpanMax,
                            std::max<long long>(kSpanMin, (fit - 2LL * g.ny - 8) / 4 * 4));
    m.spans = (int)((lo + longest - 1) / longest);
    m.span = ((lo + m.spans - 1) / m.spans + 3) / 4 * 4;
    m.slot = (m.span + 2 * g.ny + 8 + 3) / 4 * 4;
    m.smem = (long long)sizeof(float) * kSpanSlots * m.rings * m.slot;
    const long long per_chunk = (long long)bs * m.spans;
    const long long want = 2LL * sms;
    const int chunks =
        (int)std::min<long long>(g.ot, std::max<long long>(1, (want + per_chunk - 1) / per_chunk));
    m.tc = (g.ot + chunks - 1) / chunks;
    m.chunks = (g.ot + m.tc - 1) / m.tc;
    m.blocks = per_chunk * m.chunks;
    return m;
}

// 1-D grid of m.blocks: block i is span i % spans, then chunk, then sample.
// Each thread takes the outputs k = threadIdx.x + i kSpanThreads of the
// span in every frame; the cell reads the ring with the strides of `ring`
// (plane = a slot, field = a variable's ring, rows Ny) at (0, 0, y0 + k),
// where y0 is the span's offset in its slot, and the tap table is built for
// those strides. vec: the frames are 16-byte aligned (Nx Ny % 4 == 0 and
// an aligned tensor).
template <class Cell>
__global__ void __launch_bounds__(kSpanThreads)
flat_span_kernel(const float* __restrict__ fields, float* __restrict__ out, Geom g, SpanGeom m,
                 int off, int lo, int vec, const __grid_constant__ Cell cell) {
    extern __shared__ __align__(16) float ring[];
    const int span = (int)(blockIdx.x % m.spans);
    const int rest = (int)(blockIdx.x / m.spans);
    const int chunk = rest % m.chunks, b = rest / m.chunks;
    const int j0 = span * m.span, len = min(m.span, lo - j0);
    const int t0 = chunk * m.tc;
    const int nt_out = min(m.tc, g.ot - t0), nf = nt_out + 2;
    // the span's inputs in a frame: [ws, ws + len + 2 Ny + 2), of which the
    // part inside the frame is copied, [from, to), to slot position i - a0
    const int plane = (int)g.plane;
    const int ws = off + j0 - g.ny - 1;
    const int a0 = vec ? (ws & ~3) : ws;
    const int from = max(a0, 0);
    int to = min(ws + len + 2 * g.ny + 2, plane);
    if (vec) to = min((to + 3) & ~3, plane);
    const int n = vec ? (to - from) / 4 : to - from;
    const int var_ring = kSpanSlots * m.slot;
    const float* __restrict__ src = fields + (long long)b * g.sample + (long long)t0 * plane + from;

    auto load_frame = [&](int f) {
        const int s = f % kSpanRing;
        for (int v = m.first; v < m.first + m.rings; ++v) {
            if (!(m.vars >> v & 1u)) continue;
            const float* a = src + (long long)v * g.field + (long long)f * plane;
            float* d = ring + (v - m.first) * var_ring + s * m.slot + (from - a0);
            if (vec) {
                for (int i = threadIdx.x; i < n; i += kSpanThreads) {
                    copy_async16(d + 4 * i, a + 4 * i, true);
                }
            } else {
                for (int i = threadIdx.x; i < n; i += kSpanThreads) copy_async4(d + i, a + i, true);
            }
        }
    };

    Geom gr = g;   // the ring's strides
    gr.plane = m.slot;
    gr.field = var_ring;
    const int y0 = ws - a0;
    // frames 0 .. 1 + kSpanAhead, one commit group each (empty past nf)
    for (int f = 0; f < 2 + kSpanAhead; ++f) {
        if (f < nf) load_frame(f);
        copy_async_commit();
    }
    for (int t = 0; t < nt_out; ++t) {
        // frames t .. t + 2 have landed; every thread is done with t - 1
        copy_async_wait<kSpanAhead - 1>();
        __syncthreads();
        // frame t + 2 + kSpanAhead into the slots frame t - 1 held
        const int f = t + 2 + kSpanAhead;
        if (f < nf) load_frame(f);
        copy_async_commit();
        if ((t + 2) % kSpanRing < 2) {
            // frame t + 2, first read now, copied into its slot past the ring's end
            const int s = (t + 2) % kSpanRing;
            for (int v = m.first; v < m.first + m.rings; ++v) {
                if (!(m.vars >> v & 1u)) continue;
                const float4* a = reinterpret_cast<const float4*>(ring + (v - m.first) * var_ring
                                                                  + s * m.slot);
                float4* d = const_cast<float4*>(a) + kSpanRing * m.slot / 4;
                for (int i = threadIdx.x; i < m.slot / 4; i += kSpanThreads) d[i] = a[i];
            }
            __syncthreads();
        }

        const float* base = ring + (t % kSpanRing) * m.slot - (long long)m.first * var_ring;
        float* o = out + ((long long)b * g.ot + t0 + t) * lo + j0;
        for (int k = threadIdx.x; k < len; k += kSpanThreads) {
            o[k] = cell(base, gr, 0, 0, y0 + k, FromShared());
        }
    }
}

unsigned blocks_for(long long n) { return (unsigned)((n + kFlatThreads - 1) / kFlatThreads); }

// K11: the span route where its ring fits and the cell reads at most
// kSpanMaxRings rings, else the first design. With `geom` set it only
// reports the launch (`cppre_flat_residual_geom`).
struct FlatResidualLaunch {
    const float* fields;
    float* out;
    int bs;
    Geom g;
    int off, lo;
    unsigned vars;
    cudaStream_t stream;
    long long* geom = nullptr;

    template <class Cell>
    int operator()(const Cell& cell) const {
        int sms = 0;
        const cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const SpanGeom m = span_geom(vars, bs, g, lo, sms);
        const bool spans = m.smem <= kSpanSmemMax && m.rings <= kSpanMaxRings;
        const long long blocks =
            spans ? m.blocks : (long long)blocks_for(bs * (long long)g.ot * lo);
        if (bs < 1 || blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        if (geom != nullptr) {
            const long long v[] = {spans, blocks, spans ? kSpanThreads : kFlatThreads, m.span,
                                   m.spans, m.slot, kSpanSlots, m.rings, m.smem, m.tc, m.chunks};
            std::copy(v, v + sizeof(v) / sizeof(v[0]), geom);
            return (int)cudaSuccess;
        }
        if (!spans) {
            const auto kernel = flat_residual_kernel<Cell>;
            kernel<<<(unsigned)blocks, kFlatThreads, 0, stream>>>(fields, out, bs, g, off, lo,
                                                                  cell);
            return (int)cudaGetLastError();
        }
        const auto kernel = flat_span_kernel<Cell>;
        const cudaError_t a = allow_smem(kernel, (size_t)m.smem);
        if (a != cudaSuccess) return (int)a;
        const int vec = g.plane % 4 == 0 && reinterpret_cast<uintptr_t>(fields) % 16 == 0;
        kernel<<<(unsigned)blocks, kSpanThreads, (size_t)m.smem, stream>>>(fields, out, g, m, off,
                                                                           lo, vec, cell);
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

// K12's samples in flight: a sample loads one residual value and the
// prediction's taps, half of K10's loads, so it is timed on its own.
// Device ms on the H100 at chip_smoke's flat shapes (PERF.md), U = 1 / 2 /
// 4: wave 0.439 / 0.444 / 0.619 (7 taps by value), NS - / 0.240 / 0.311,
// MHD induction 0.380 / 0.359 / 0.409, momentum 0.437 / 0.475 / 0.477,
// energy 0.471 / 0.48 / spills, continuity 0.339 / 0.295 / 0.253, gauss
// 0.202 / 0.203 / 0.174; the 9-tap device table 0.844 / 0.819 / 0.881.
template <class Cell>
struct FromResSamplesInFlight {
    static constexpr int value = 2;
};
template <int EQ>
struct FromResSamplesInFlight<Mhd<EQ>> {
    static constexpr int value = EQ == kContinuity || EQ == kGauss ? 4 : EQ == kInduction ? 2 : 1;
};

// K10's lanes: K1's rule (every block resident at once), with a group of
// at most 8 samples (lanes x U) for lane 0 to fold: at wave [1000, 20, 64,
// 64] the 7-tap cell (U = 4) took 0.81-0.86 ms at 3 lanes against 0.51-0.56
// at 2, the 9-tap one (U = 1) 1.33-1.40 at 3 against 1.88-1.96 at 2
// (H100; PERF.md). K12 takes its own cap.
constexpr int kFlatMaxGroup = 8;
constexpr int kFromResMaxGroup = 8;

// K10 (K12 with `from_res`: truth is the truth's residual): K1's kernel
// with |d| stored; with `grid` set it only reports the launch (grid[0]
// blocks, grid[1] threads a block). Its blocks take K1's runs of 64 flat
// cells where a row of Ny is a whole number of runs, and two rows of 32
// (`FlatBandCells`) where K1's runs would straddle rows: at NS (Ny 100) the
// bands took 0.317 ms against 0.335 for the runs, at wave (Ny 64) 1.0-1.13
// against 0.51-0.56 (H100; PERF.md).
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
    bool from_res = false;
    long long* grid = nullptr;

    template <class Cell>
    int operator()(const Cell& cell) const {
        return from_res ? by_map<Cell, AbsDiffFromRes>(cell) : by_map<Cell, AbsDiff>(cell);
    }

    template <class Cell, class DiffT>
    int by_map(const Cell& cell) const {
        return g.ny % kDiffCells == 0 ? run<Cell, DiffT, PlaneCells>(cell)
                                      : run<Cell, DiffT, FlatBandCells>(cell);
    }

    template <class Cell, class DiffT, class Map>
    int run(const Cell& cell) const {
        constexpr bool k12 = ReadsResidual<DiffT>::value;
        constexpr int U =
            k12 ? FromResSamplesInFlight<Cell>::value : FlatSamplesInFlight<Cell>::value;
        constexpr int group = k12 ? kFromResMaxGroup : kFlatMaxGroup;
        const auto kernel = diff_stats_kernel<Cell, DiffT, U, Map>;
        const long long blocks = diff_stats_blocks<Map>(g);
        if (bs < 1 || blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        int sms = 0;
        const cudaError_t e = sm_count(&sms);
        if (e != cudaSuccess) return (int)e;
        const int lanes =
            std::max(1, std::min(group / U, diff_stats_lanes<U>(kernel, blocks, sms)));
        if (grid != nullptr) {
            grid[0] = blocks;
            grid[1] = (long long)kDiffCells * lanes;
            return (int)cudaSuccess;
        }
        kernel<<<(unsigned)blocks, kDiffCells * lanes, diff_stats_smem_bytes(lanes, U), stream>>>(
            k12 ? truth : truth + shift, pred + shift, (DiffT*)absdiff, sum, sumsq, nullptr, bs,
            lanes, g, cell);
        return (int)cudaGetLastError();
    }
};

bool flat_window_ok(int nx, int ny, int off) {
    return nx * ny - 2 * off > 0 && off >= ny && off <= ny + 1;
}

CellArgs flat_cell_args(int kind, float cxy, float cty, float ctx, float nu, float dt,
                        const void* tap_off, const void* tap_w, int ntaps, const void* rows,
                        float dc, float kc, const void* host_off, const void* host_w) {
    CellArgs c{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    c.host_off = (const int*)host_off;
    c.host_w = (const float*)host_w;
    return c;
}

}  // namespace

// K11 and K12. which: 11 (a fields -> out residual; b, sum, sumsq unused) or
// 12 (a prediction, b the truth's residual [BS, Nt-2, Lo] -> out |d|, sum,
// sumsq). kind and the cell arguments as in stencil_kernels.cu (3-wide
// cells only; the JOREK kinds, which the JAX package has no flat instance
// of, are refused); a tap table goes by value from host_off / host_w where
// its count has an instance, else from the device table tap_off / tap_w.
// K12's table is built for [Nt, Nx, Ny]; K11's for the strides its route
// reads (`cppre_flat_residual_geom`: frames a ring slot apart, rows Ny, on
// the span route). off: the flat window's margin, Ny or Ny + 1; Lo = Nx *
// Ny - 2 off.
CPPRE_EXPORT int cppre_flat_kernel(int which, int kind, const void* a, const void* b, void* out,
                                   void* sum, void* sumsq, int bs, int nvar, int nt, int nx,
                                   int ny, int off, float cxy, float cty, float ctx, float nu,
                                   float dt, const void* tap_off, const void* tap_w, int ntaps,
                                   const void* rows, float dc, float kc, const void* host_off,
                                   const void* host_w, void* stream) {
    const CellArgs c = flat_cell_args(kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows,
                                      dc, kc, host_off, host_w);
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    const int lo = nx * ny - 2 * off;
    if (which == 11) {
        return with_cell_by_value(c, FlatResidualLaunch{(const float*)a, (float*)out, bs,
                                                        make_geom(nvar, nt, nx, ny, 3), off, lo,
                                                        cell_vars(kind), (cudaStream_t)stream});
    }
    if (which != 12) return (int)cudaErrorInvalidValue;
    FlatPairedLaunch launch{(const float*)b, (const float*)a, (float*)out, (float*)sum,
                            (float*)sumsq, bs, flat_geom(nvar, nt, nx, ny, lo),
                            flat_shift(ny, off), (cudaStream_t)stream};
    launch.from_res = true;
    return with_cell_by_value(c, launch);
}

// K11's launch for the arguments of cppre_flat_kernel (no data pointers are
// read): geom[0..10] = span route (1) or first design (0), blocks, threads
// a block, span, spans, ring slot (floats), slots a ring, rings, shared
// memory bytes, output frames a block, chunks.
CPPRE_EXPORT int cppre_flat_residual_geom(int kind, int bs, int nvar, int nt, int nx, int ny,
                                          int off, long long* geom) {
    static const int table[kByValueTaps] = {};   // only the instance is chosen from it
    CellArgs c{kind, 0.f, 0.f, 0.f, 0.f, 0.f, table, table, kByValueTaps, nullptr, 0.f, 0.f};
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    FlatResidualLaunch launch{nullptr, nullptr, bs, make_geom(nvar, nt, nx, ny, 3), off,
                              nx * ny - 2 * off, cell_vars(kind), nullptr};
    launch.geom = geom;
    return with_cell(c, launch);
}

// K10: truth and prediction [BS, nvar, Nt, Nx * Ny] -> |d| [BS, Nt-2, Lo],
// sum and sumsq [Nt-2, Lo]. Cells and tap table as cppre_flat_kernel's K12.
CPPRE_EXPORT int cppre_flat_paired(int kind, const void* truth, const void* pred, void* absdiff,
                                   void* sum, void* sumsq, int bs, int nvar, int nt, int nx,
                                   int ny, int off, float cxy, float cty, float ctx, float nu,
                                   float dt, const void* tap_off, const void* tap_w, int ntaps,
                                   const void* rows, float dc, float kc, const void* host_off,
                                   const void* host_w, void* stream) {
    const CellArgs c = flat_cell_args(kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows,
                                      dc, kc, host_off, host_w);
    if (!flat_window_ok(nx, ny, off)) return (int)cudaErrorInvalidValue;
    return with_cell_by_value(c, FlatPairedLaunch{(const float*)truth, (const float*)pred,
                                                  (float*)absdiff, (float*)sum, (float*)sumsq, bs,
                                                  flat_geom(nvar, nt, nx, ny, nx * ny - 2 * off),
                                                  flat_shift(ny, off), (cudaStream_t)stream});
}

// The blocks K10 (from_res 0) or K12 (1) launches and the threads of each
// (grid[0], grid[1]) for the arguments of cppre_flat_paired (no data
// pointers are read); by_value: the tap table goes by value.
CPPRE_EXPORT int cppre_flat_paired_grid(int kind, int bs, int nvar, int nt, int nx, int ny,
                                        int off, int ntaps, int by_value, int from_res,
                                        long long* grid) {
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
    launch.from_res = from_res != 0;
    launch.grid = grid;
    return with_cell_by_value(c, launch);
}
