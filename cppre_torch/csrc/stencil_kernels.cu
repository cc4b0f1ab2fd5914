// NS momentum PRE kernels for Hopper (sm_90a): the residual alone (K2) and
// the paired joint-CP diff plus cross-batch moments (K1).
//
// Replaces the Pallas kernels of cppre/ops/pallas/stencil_kernels.py:
//   K2  _batched_residual_fused (NS instance ns_momentum_residual_fused):
//       per sample, the 10-term momentum residual (_ns_momentum_math) on the
//       interior crop, [BS, 3, Nt, Nx, Ny] -> [BS, Nt-2, Nx-2, Ny-2].
//   K1  _joint_cp_diff_stats (NS instances ns_joint_cp_diff_stats and
//       ns_joint_cp_scores_fused): diff = PRE(truth) - PRE(pred) per sample,
//       plus per-cell sum and sum of squares over the batch.
//
// What bounds them on an H100: memory. Each output cell needs 13 field
// taps and ~40 flops, far below the ~20 flops/byte at which the card stops
// being bandwidth-bound. The TPU kernels held one whole trajectory in VMEM;
// here neighbouring threads read neighbouring y addresses (coalesced), and
// the stencil's reuse of a tap by adjacent cells is served by L1/L2.
//
// K1's cross-batch moments: the TPU kernel carries sum/sumsq from one grid
// step to the next, relying on the TPU running its grid in order. CUDA
// blocks run in no order, so each thread owns one interior cell and loops
// over the batch b = 0..BS-1 itself, accumulating in f32 registers in that
// fixed order. No atomics, no second pass, and the result is bit-stable
// from run to run and independent of the launch configuration.
//
// Term order follows _ns_momentum_math so the plain-PyTorch parity is tight.

#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

struct NsCoef {
    float cxy;  // dx * dy
    float cty;  // dt * dy
    float ctx;  // dt * dx
    float nu;
    float dt;
};

struct Geom {
    int nt, nx, ny;
    long long sample;  // elements of one sample: nvar * nt * nx * ny
};

// Momentum residual at output cell (t, x, y), centre (t+1, x+1, y+1), of the
// sample whose (u, v, p) fields start at f.
__device__ __forceinline__ float ns_momentum_cell(const float* __restrict__ f, const Geom& g,
                                                  int t, int x, int y, const NsCoef& c) {
    const long long plane = (long long)g.nx * g.ny;
    const long long field = (long long)g.nt * plane;
    const float* __restrict__ u = f;
    const float* __restrict__ v = f + field;
    const float* __restrict__ p = f + 2 * field;
    const long long i0 = (long long)(t + 1) * plane + (long long)(x + 1) * g.ny + (y + 1);
    const long long st = plane, sx = g.ny;

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

    const float res_x = u_t * c.cxy + uc * u_x * c.cty + vc * u_y * c.ctx
                        - c.nu * u_lap * c.dt + p_x * c.cty;
    const float res_y = v_t * c.cxy + uc * v_x * c.ctx + vc * v_y * c.cty
                        - c.nu * v_lap * c.dt + p_y * c.ctx;
    return res_x + res_y;
}

// grid (BS * (Nt-2), ceil((Nx-2) / blockDim.y)); threads along y.
__global__ void ns_momentum_residual_kernel(const float* __restrict__ fields,
                                            float* __restrict__ out, Geom g, NsCoef c) {
    const int ot = g.nt - 2, ox = g.nx - 2, oy = g.ny - 2;
    const int bt = blockIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= ox) return;
    const int b = bt / ot, t = bt % ot;
    const float* f = fields + (long long)b * g.sample;
    float* o = out + ((long long)bt * ox + x) * oy;
    for (int y = threadIdx.x; y < oy; y += blockDim.x) o[y] = ns_momentum_cell(f, g, t, x, y, c);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid (Nt-2, ceil((Nx-2) / blockDim.y)); one thread per interior cell,
// looping over the batch.
template <typename DiffT>
__global__ void ns_joint_cp_diff_stats_kernel(const float* __restrict__ truth,
                                              const float* __restrict__ pred,
                                              DiffT* __restrict__ diff, float* __restrict__ sum,
                                              float* __restrict__ sumsq, int bs, Geom g, NsCoef c) {
    const int ox = g.nx - 2, oy = g.ny - 2;
    const long long ncell = (long long)(g.nt - 2) * ox * oy;
    const int t = blockIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= ox) return;
    for (int y = threadIdx.x; y < oy; y += blockDim.x) {
        const long long cell = ((long long)t * ox + x) * oy + y;
        float s = 0.0f, q = 0.0f;
        for (int b = 0; b < bs; ++b) {
            const long long off = (long long)b * g.sample;
            const float d = ns_momentum_cell(truth + off, g, t, x, y, c)
                            - ns_momentum_cell(pred + off, g, t, x, y, c);
            store(diff + (long long)b * ncell + cell, d);
            s += d;
            q += d * d;
        }
        sum[cell] = s;
        sumsq[cell] = q;
    }
}

constexpr int kThreadsY = 128;  // threads along y (the contiguous axis)
constexpr int kRowsX = 2;       // rows of x per block

}  // namespace

CPPRE_EXPORT int cppre_ns_momentum_residual(const void* fields, void* out, int bs, int nvar,
                                            int nt, int nx, int ny, float cxy, float cty,
                                            float ctx, float nu, float dt, void* stream) {
    const Geom g{nt, nx, ny, (long long)nvar * nt * nx * ny};
    const NsCoef c{cxy, cty, ctx, nu, dt};
    const dim3 block(kThreadsY, kRowsX);
    const dim3 grid((unsigned)bs * (nt - 2), (nx - 2 + kRowsX - 1) / kRowsX);
    ns_momentum_residual_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)fields, (float*)out, g, c);
    return (int)cudaGetLastError();
}

CPPRE_EXPORT int cppre_ns_joint_cp_diff_stats(const void* truth, const void* pred, void* diff,
                                              int diff_bf16, void* sum, void* sumsq, int bs,
                                              int nvar, int nt, int nx, int ny, float cxy,
                                              float cty, float ctx, float nu, float dt,
                                              void* stream) {
    const Geom g{nt, nx, ny, (long long)nvar * nt * nx * ny};
    const NsCoef c{cxy, cty, ctx, nu, dt};
    const dim3 block(kThreadsY, kRowsX);
    const dim3 grid(nt - 2, (nx - 2 + kRowsX - 1) / kRowsX);
    cudaStream_t s = (cudaStream_t)stream;
    if (diff_bf16) {
        ns_joint_cp_diff_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
            (const float*)truth, (const float*)pred, (__nv_bfloat16*)diff, (float*)sum,
            (float*)sumsq, bs, g, c);
    } else {
        ns_joint_cp_diff_stats_kernel<float><<<grid, block, 0, s>>>(
            (const float*)truth, (const float*)pred, (float*)diff, (float*)sum, (float*)sumsq,
            bs, g, c);
    }
    return (int)cudaGetLastError();
}
