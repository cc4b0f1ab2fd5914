// The residual cells of the PRE stencil kernels, shared by
// stencil_kernels.cu (K1, K2, K3, K8, K9) and flat_kernels.cu (K10-K12).
// The JOREK cells run in K1, K2 and K3 only (`with_cell<true>`).
//
// A cell evaluates one residual at one output cell of one sample:
// cell(f, g, t, x, y) reads the fields of a sample at base f with the
// strides of g, around the centre (t + 1, x + 1, y + 1). Every kernel that
// calls the same cell gets the same arithmetic, so their results agree bit
// for bit: K9's diff is K1's, K3's is K1's, and the flat kernels' values are
// K1's at the cells both compute.
//
// A cell reads its fields through a source policy, the optional last
// argument: FromGlobal (the default) through the read-only data cache, or
// FromShared, a plain load, for a window that K2 or K3 staged in shared memory.
// The policy changes how a value is fetched, never the arithmetic.
//
// Term order follows the JAX math (cppre/ops/pallas/stencil_kernels.py
// _ns_momentum_math, _mhd_math, _jorek_math, _taps); the tap table accumulates with
// explicit round-to-nearest multiplies and adds (no FMA contraction), the
// arithmetic of `stencil_shift_add`.
#pragma once

#include <cuda_runtime.h>

namespace {

// Extents and strides of one sample [Nvar, Nt, Nx, Ny] and of the output.
struct Geom {
    int nt, nx, ny;      // input extents
    int ot, ox, oy;      // output extents: N - k + 1 on each axis
    long long plane;     // nx * ny
    long long field;     // nt * nx * ny: one variable
    long long sample;    // nvar * field
};

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

struct FromGlobal {
    static __device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
};
struct FromShared {
    static __device__ __forceinline__ float ld(const float* p) { return *p; }
};

// Index of the centre of a 3-wide stencil at output cell (t, x, y).
__device__ __forceinline__ long long centre(const Geom& g, int t, int x, int y) {
    return (long long)(t + 1) * g.plane + (long long)(x + 1) * g.ny + (y + 1);
}

// The centre value and the three centred differences of one field.
struct D3 {
    float c, t, x, y;
};

template <class Src>
__device__ __forceinline__ D3 d3(const float* __restrict__ a, long long i0, const Geom& g) {
    D3 r;
    r.c = Src::ld(a + i0);
    r.t = Src::ld(a + i0 + g.plane) - Src::ld(a + i0 - g.plane);
    r.x = Src::ld(a + i0 + g.ny) - Src::ld(a + i0 - g.ny);
    r.y = Src::ld(a + i0 + 1) - Src::ld(a + i0 - 1);
    return r;
}

// NS momentum residual of (u, v, p), _ns_momentum_math.
struct NsMomentum {
    float cxy;  // dx * dy
    float cty;  // dt * dy
    float ctx;  // dt * dx
    float nu;
    float dt;

    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src = Src()) const {
        const float* __restrict__ u = f;
        const float* __restrict__ v = f + g.field;
        const float* __restrict__ p = f + 2 * g.field;
        const long long i0 = centre(g, t, x, y);
        const long long st = g.plane, sx = g.ny;

        const float uc = Src::ld(u + i0), vc = Src::ld(v + i0);
        const float u_t = Src::ld(u + i0 + st) - Src::ld(u + i0 - st);
        const float u_xp = Src::ld(u + i0 + sx), u_xm = Src::ld(u + i0 - sx);
        const float u_yp = Src::ld(u + i0 + 1), u_ym = Src::ld(u + i0 - 1);
        const float v_t = Src::ld(v + i0 + st) - Src::ld(v + i0 - st);
        const float v_xp = Src::ld(v + i0 + sx), v_xm = Src::ld(v + i0 - sx);
        const float v_yp = Src::ld(v + i0 + 1), v_ym = Src::ld(v + i0 - 1);
        const float p_x = Src::ld(p + i0 + sx) - Src::ld(p + i0 - sx);
        const float p_y = Src::ld(p + i0 + 1) - Src::ld(p + i0 - 1);

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
enum Kind {
    kNsMomentum = 0, kContinuity, kMomentum, kEnergy, kInduction, kGauss, kTaps,
    kJorekContinuity, kJorekTemperature
};

constexpr float kGamma = (float)(5.0 / 3.0);
constexpr float kGammaMinus2 = (float)(5.0 / 3.0 - 2.0);
constexpr float kTwoGamma = (float)(2.0 * 5.0 / 3.0);

template <int EQ>
struct Mhd {
    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src = Src()) const {
        const long long i0 = centre(g, t, x, y);
        auto F = [&](int var) { return d3<Src>(f + var * g.field, i0, g); };
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

// The JOREK reduced-MHD residuals (_jorek_math) over (rho, Phi, T) in
// cylindrical geometry: the R-weighted Poisson bracket [a, b] = a_x b_y -
// b_x a_y, 1/R terms and gamma = 5/3. R comes from a device table of the
// input grid's Nx major radii, r[x + 1] for interior row x, so any grid
// works, affine or not (cppre rebuilds an affine R from iota in its kernel,
// since Pallas cannot capture an array). The table is read through __ldg
// whatever the source policy: it is not part of a staged window. A window
// that starts at input row x0 takes the table from r + x0 (`at_rows`).
template <int EQ>
struct Jorek {
    const float* __restrict__ r;
    float dc;  // continuity: the diffusion coefficient D
    float kc;  // temperature: the conductivity K

    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src src = Src()) const {
        const float rr = __ldg(r + x + 1);
        return eval(f, g, t, x, y, rr, 1.0f / rr, src);
    }

    // The residual with the row's R and 1/R given (`JorekRow`).
    template <class Src>
    __device__ __forceinline__ float eval(const float* __restrict__ f, const Geom& g, int t,
                                          int x, int y, float rr, float inv_r, Src) const {
        const long long i0 = centre(g, t, x, y);
        auto F = [&](int var) { return d3<Src>(f + var * g.field, i0, g); };
        auto d_xx = [&](int var) {
            const float* a = f + var * g.field + i0;
            return Src::ld(a + g.ny) - 2.0f * Src::ld(a) + Src::ld(a - g.ny);
        };
        auto d_yy = [&](int var) {
            const float* a = f + var * g.field + i0;
            return Src::ld(a + 1) - 2.0f * Src::ld(a) + Src::ld(a - 1);
        };
        if constexpr (EQ == kJorekContinuity) {
            const D3 rho = F(0), phi = F(1);
            const float br = rho.x * phi.y - phi.x * rho.y;
            return rho.t - rr * br - 2.0f * rho.c * phi.y
                   - dc * (d_xx(0) + inv_r * rho.x + d_yy(0));
        } else {  // kJorekTemperature
            const D3 rho = F(0), phi = F(1), T = F(2);
            const float br_t = T.x * phi.y - phi.x * T.y;
            const float br_rho = rho.x * phi.y - phi.x * rho.y;
            return T.c * rho.t + rho.c * T.t - rho.c * rr * br_t + T.c * rr * br_rho
                   + kTwoGamma * rho.c * T.c * phi.y + kc * (d_xx(2) + inv_r * T.x + d_yy(2));
        }
    }
};

// A cell for a window whose row 0 is input row x0: the same cell, except
// JOREK's, whose R table moves with the window.
template <class Cell>
__device__ __forceinline__ Cell at_rows(const Cell& c, int) {
    return c;
}
template <int EQ>
__device__ __forceinline__ Jorek<EQ> at_rows(const Jorek<EQ>& c, int x0) {
    return Jorek<EQ>{c.r + x0, c.dc, c.kc};
}

// JOREK's cell for the cells of one output row x, with that row's R and
// 1/R read and divided once (K1, whose thread walks the batch in one row).
// The same arithmetic as `Jorek`'s, so the same bits.
template <int EQ>
struct JorekRow {
    Jorek<EQ> cell;
    float rr, inv_r;

    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src src = Src()) const {
        return cell.eval(f, g, t, x, y, rr, inv_r, src);
    }
};

// A cell bound to output row x: JOREK's as a `JorekRow`, any other as is.
template <class Cell>
__device__ __forceinline__ const Cell& at_row(const Cell& c, int) {
    return c;
}
template <int EQ>
__device__ __forceinline__ JorekRow<EQ> at_row(const Jorek<EQ>& c, int x) {
    const float rr = __ldg(c.r + x + 1);
    return JorekRow<EQ>{c, rr, 1.0f / rr};
}

// A constant stencil as a table of its non-zero taps, in the order of
// `_taps` (itertools.product, zeros dropped): off[i] is the tap's linear
// offset from the cell's (0, 0, 0) corner, w[i] its float32 weight. The
// table is built on the host for the strides of the fields the cell reads.
// This form reads the table from device memory and takes any count; each
// tap's field load waits on its table loads.
struct Taps {
    const int* __restrict__ off;
    const float* __restrict__ w;
    int n;

    __device__ __forceinline__ int count() const { return n; }
    __device__ __forceinline__ int tap_off(int i) const { return __ldg(off + i); }
    __device__ __forceinline__ float tap_w(int i) const { return __ldg(w + i); }

    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src = Src()) const {
        const float* __restrict__ base = f + (long long)t * g.plane + (long long)x * g.ny + y;
        float acc = 0.0f;
        for (int i = 0; i < n; ++i) {
            const float term = __fmul_rn(Src::ld(base + __ldg(off + i)), __ldg(w + i));
            acc = i == 0 ? term : __fadd_rn(acc, term);
        }
        return acc;
    }
};

// The same table held by value (K1, K8): N taps, N known at compile time.
// A kernel takes the cell as a __grid_constant__ parameter, so the table
// lives in the constant bank, the tap loop unrolls, every offset and weight
// is an operand of the instruction that uses it, and the N field loads are
// independent of each other. The arithmetic is `Taps`'s, tap for tap.
template <int N>
struct TapsByValue {
    int off[N];
    float w[N];

    static constexpr __device__ int count() { return N; }
    __device__ __forceinline__ int tap_off(int i) const { return off[i]; }
    __device__ __forceinline__ float tap_w(int i) const { return w[i]; }

    template <class Src = FromGlobal>
    __device__ __forceinline__ float operator()(const float* __restrict__ f, const Geom& g,
                                                int t, int x, int y, Src = Src()) const {
        const float* __restrict__ base = f + (long long)t * g.plane + (long long)x * g.ny + y;
        float acc = __fmul_rn(Src::ld(base + off[0]), w[0]);
#pragma unroll
        for (int i = 1; i < N; ++i) acc = __fadd_rn(acc, __fmul_rn(Src::ld(base + off[i]), w[i]));
        return acc;
    }
};

// The tap count with a by-value instance: the wave composite's 7 taps at
// k = 3, the one table the port's configurations run. Any other count runs
// the same kernel bodies with `Taps`.
constexpr int kByValueTaps = 7;

// The variables (bit v for variable v) a cell of `kind` reads.
__host__ __device__ constexpr unsigned cell_vars(int kind) {
    switch (kind) {
        case kNsMomentum: return 0x7u;                // u, v, p
        case kContinuity: return 0x7u;                // rho, u, v
        case kMomentum: case kEnergy: return 0x3fu;   // all six
        case kInduction: return 0x36u;                // u, v, Bx, By
        case kGauss: return 0x30u;                    // Bx, By
        case kJorekContinuity: return 0x3u;           // rho, Phi
        case kJorekTemperature: return 0x7u;          // rho, Phi, T
        default: return 0x1u;                         // the tap table's one field
    }
}

struct CellArgs {
    int kind;
    float cxy, cty, ctx, nu, dt;
    const void* tap_off;  // the tap table on the device (`Taps`)
    const void* tap_w;
    int ntaps;
    const void* rows;  // JOREK: the float32 table of the input grid's Nx major radii
    float dc, kc;      // JOREK: D and K
    const int* host_off = nullptr;  // the tap table in host memory (`TapsByValue`)
    const float* host_w = nullptr;
};

// Call launch(cell) with the cell that `a.kind` names. The JOREK cells are
// instantiated only where kJorek is true (K1, K2, K3, the kernels the JAX
// package has JOREK instances of), the device tap table only where kTable
// is (all but K2, whose path runs no tap table); elsewhere their kinds are
// refused.
template <bool kJorek = false, bool kTable = true, class Launch>
int with_cell(const CellArgs& a, const Launch& launch) {
    switch (a.kind) {
        case kNsMomentum: return launch(NsMomentum{a.cxy, a.cty, a.ctx, a.nu, a.dt});
        case kContinuity: return launch(Mhd<kContinuity>{});
        case kMomentum: return launch(Mhd<kMomentum>{});
        case kEnergy: return launch(Mhd<kEnergy>{});
        case kInduction: return launch(Mhd<kInduction>{});
        case kGauss: return launch(Mhd<kGauss>{});
        case kTaps:
            if constexpr (kTable) {
                return launch(Taps{(const int*)a.tap_off, (const float*)a.tap_w, a.ntaps});
            } else {
                return (int)cudaErrorInvalidValue;
            }
        case kJorekContinuity:
        case kJorekTemperature:
            if constexpr (kJorek) {
                const float* r = (const float*)a.rows;
                if (r == nullptr) return (int)cudaErrorInvalidValue;
                if (a.kind == kJorekContinuity) {
                    return launch(Jorek<kJorekContinuity>{r, a.dc, a.kc});
                }
                return launch(Jorek<kJorekTemperature>{r, a.dc, a.kc});
            } else {
                return (int)cudaErrorInvalidValue;
            }
        default: return (int)cudaErrorInvalidValue;
    }
}

// Call launch(cell) with a tap table's cell: `TapsByValue` where the count
// has its instance and the host copy was given, else `Taps` on the device
// table (K1, K8).
template <class Launch>
int with_taps(const CellArgs& a, const Launch& launch) {
    if (a.kind != kTaps || a.ntaps < 1) return (int)cudaErrorInvalidValue;
    if (a.ntaps == kByValueTaps && a.host_off != nullptr && a.host_w != nullptr) {
        TapsByValue<kByValueTaps> c;
        for (int i = 0; i < kByValueTaps; ++i) {
            c.off[i] = a.host_off[i];
            c.w[i] = a.host_w[i];
        }
        return launch(c);
    }
    if (a.tap_off == nullptr || a.tap_w == nullptr) return (int)cudaErrorInvalidValue;
    return launch(Taps{(const int*)a.tap_off, (const float*)a.tap_w, a.ntaps});
}

// `with_cell`, with a tap table as `with_taps` passes it.
template <bool kJorek = false, class Launch>
int with_cell_by_value(const CellArgs& a, const Launch& launch) {
    return a.kind == kTaps ? with_taps(a, launch) : with_cell<kJorek, false>(a, launch);
}

}  // namespace
