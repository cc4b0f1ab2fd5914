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
// Bound by memory, like K1: a cell's taps are served by L1/L2. The moments
// over the batch: each thread owns one (t, j) and loops over b = 0..BS-1 in
// order, in f32 registers (no atomics, bit-stable).

#include "common.cuh"
#include "stencil_cells.cuh"

namespace {

constexpr int kFlatThreads = 128;

// K10: grid ceil(ot * Lo / kFlatThreads), one thread per (t, j).
template <class Cell>
__global__ void __launch_bounds__(kFlatThreads)
flat_paired_kernel(const float* __restrict__ truth, const float* __restrict__ pred,
                   float* __restrict__ absdiff, float* __restrict__ sum,
                   float* __restrict__ sumsq, int bs, Geom g, int off, int lo, Cell cell) {
    const long long ncell = (long long)g.ot * lo;
    const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (id >= ncell) return;
    const int t = (int)(id / lo), j = (int)(id % lo);
    const int yc = off + j - g.ny - 1;
    float s = 0.0f, q = 0.0f;
    for (int b = 0; b < bs; ++b) {
        const long long o = (long long)b * g.sample;
        const float d = cell(truth + o, g, t, 0, yc) - cell(pred + o, g, t, 0, yc);
        absdiff[(long long)b * ncell + id] = fabsf(d);
        s += d;
        q += d * d;
    }
    sum[id] = s;
    sumsq[id] = q;
}

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

// K12: as K10, with the truth's residual read from res [BS, ot, Lo].
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

// One launcher for the three kernels: `which` 10, 11 or 12.
struct FlatLaunch {
    int which;
    const float* a;   // truth (K10), fields (K11), prediction (K12)
    const float* b;   // prediction (K10), the truth's residual (K12)
    float* out;       // |d| (K10, K12), the residual (K11)
    float* sum;
    float* sumsq;
    int bs;
    Geom g;
    int off, lo;
    cudaStream_t stream;

    template <class Cell>
    int operator()(const Cell& cell) const {
        const long long ncell = (long long)g.ot * lo;
        if (which == 10) {
            flat_paired_kernel<Cell><<<blocks_for(ncell), kFlatThreads, 0, stream>>>(
                a, b, out, sum, sumsq, bs, g, off, lo, cell);
        } else if (which == 11) {
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

}  // namespace

// which: 10 (a truth, b prediction -> out |d|, sum, sumsq), 11 (a fields ->
// out residual; b, sum, sumsq unused), 12 (a prediction, b the truth's
// residual -> out |d|, sum, sumsq). kind and the cell arguments as in
// stencil_kernels.cu (3-wide cells only; a tap table built for [Nt, Nx, Ny];
// the JOREK kinds, which the JAX package has no flat instance of, are refused).
// off: the flat window's margin, Ny or Ny + 1; Lo = Nx * Ny - 2 off.
CPPRE_EXPORT int cppre_flat_kernel(int which, int kind, const void* a, const void* b, void* out,
                                   void* sum, void* sumsq, int bs, int nvar, int nt, int nx,
                                   int ny, int off, float cxy, float cty, float ctx, float nu,
                                   float dt, const void* tap_off, const void* tap_w, int ntaps,
                                   const void* rows, float dc, float kc, void* stream) {
    const CellArgs c{kind, cxy, cty, ctx, nu, dt, tap_off, tap_w, ntaps, rows, dc, kc};
    const int lo = nx * ny - 2 * off;
    if (lo <= 0 || off < ny || off > ny + 1) return (int)cudaErrorInvalidValue;
    return with_cell(c, FlatLaunch{which, (const float*)a, (const float*)b, (float*)out,
                                   (float*)sum, (float*)sumsq, bs, make_geom(nvar, nt, nx, ny, 3),
                                   off, lo, (cudaStream_t)stream});
}
