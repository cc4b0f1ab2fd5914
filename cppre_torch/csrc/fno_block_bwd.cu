// FNO2d training kernels for Hopper (sm_90a): the backward of the Fourier
// block (K6) and of the projection head (K7).
//
// Replaces the Pallas kernels of cppre/ops/pallas/fno_block.py:
//   K6  fno_block2d_bwd_fused: recompute one block, then dx, the spectral
//       weight grads (re/im), da1 db1 da2 db2 daw dbw and dx3, the weight
//       grads summed over batch and variables.
//   K7  projection2d_bwd_fused: recompute pre/h of fc1 -> gelu -> fc2, then
//       dz and da1 db1 da2 db2 summed over every pixel.
//
// What is hard on this card. Both are reductions across the whole grid:
// the TPU kernels keep the weight-gradient blocks resident in VMEM while
// an in-order grid adds into them (init at the first grid step). CUDA
// blocks run in no order, and float atomics would add in an order that
// changes from run to run. Here every sum has one fixed order: a block
// writes its partial sums to a [n_blocks, n] scratch, and a second launch
// (reduce_rows_kernel) adds the rows in block order; a per-cell sum over
// the batch (dx3, the spectral grads) is one thread per cell looping over
// b. So the gradients are bit-stable from run to run.
//
// K6 cannot take the TPU's working set either: about 14 full [W, Nx, Ny]
// planes per (b, v), ~9 MB at the NS flagship, against 227 KB of shared
// memory a block. It is split like K4 (fno_block.cu), nine launches:
//   1. dft_fwd_kernel + spectral_mix_kernel (fno_dft.cuh) recompute the
//      spectrum z of x and its mix m, kept for the spectral grads;
//   2. block_bwd_row_kernel, one block per (b, v, x) row: the inverse DFT
//      of m to `spec`, the MLP forward, bypass and bias, gs = g*gelu'(s),
//      then dh, dpre1, dspec and the bypass part of dx, per pixel; the
//      row's sums of the channel-map grads go to its partial row;
//   3. dft_fwd_kernel on dspec with the transposed weighted tables
//      (iyc^T, iys^T, cx, sx): the adjoint of the inverse DFT, dm;
//   4. spectral_mix_adj_kernel: dz from the transposed spectral weights;
//      spectral_wgrad_kernel: sum_b z (x) dm per (in, out, v, mode);
//   5. idft_add_kernel: the adjoint of the forward DFT of dz, added to dx;
//   6. reduce_rows_kernel twice: the partial rows, and dx3 = sum_b gs.
// Bounded by memory: x and g are read twice, dx written once, and gs and
// dspec go through HBM once each (5 extra activation planes of traffic);
// the ~3k FMAs per pixel of stage 2 come next.
//
// K7. One block of wp threads (one per hidden unit, 256 in FNO2d) walks a
// fixed share of 32-pixel tiles: the tile's z and g are staged in shared
// memory, each thread recomputes pre_j and gelu'(pre_j) for every pixel of
// the tile and keeps its rows of da1 [wp, W], db1 and da2 [step, wp] in
// registers across all its tiles; dpre goes through shared memory to form
// dz = dpre a1. The grid is a constant (kProjBwdBlocks), so the split of
// pixels over blocks, and the order of every sum, is the same on every
// run. Bounded by the ~2.5k FMAs and one erff per (pixel, hidden unit).

#include "fno_dft.cuh"

namespace {

// ---- K6 stage 2: one (b, v, x) row, recompute + pointwise backward ----------
// x, g, dx, gs, dspec [B, W, V, nx, ny]; x3 [1, W, V, nx, ny]; m{r,i} the
// mixed spectrum [B, V, W, m2, K]; a1, a2, aw [W, W] as (out, in). Per pixel:
//   spec = inverse DFT of m;  pre1 = a1 spec + b1;  h = gelu(pre1)
//   s = a2 h + b2 + aw x + bw + x3;  gs = g * gelu'(s)
//   dpre1 = (a2^T gs) * gelu'(pre1);  dspec = a1^T dpre1;  dx = aw^T gs
// and dspec * inv_scale is written as the adjoint DFT's input. The row's
// sums go to partial[blockIdx.x, :] as
//   [da1 (j, o) | da2 (c, j) | daw (c, i) | db1 (j) | db2 (c)].
// Each tile of y is stashed in shared memory (stride T+1: no bank
// conflicts), then one thread per output sums the tile's pixels in y order.
template <int W>
__global__ void block_bwd_row_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ x3,
    const float* __restrict__ mr, const float* __restrict__ mi, const float* __restrict__ cxT,
    const float* __restrict__ sxT, const float* __restrict__ iyc, const float* __restrict__ iys,
    const float* __restrict__ a1, const float* __restrict__ b1, const float* __restrict__ a2,
    const float* __restrict__ b2, const float* __restrict__ aw, const float* __restrict__ bw,
    float* __restrict__ dx, float* __restrict__ gs_out, float* __restrict__ dspec_out,
    float* __restrict__ partial, int V, int nx, int ny, int m2, int K, float inv_scale) {
    constexpr int NP = 3 * W * W + 2 * W;
    const int T = blockDim.x, TS = blockDim.x + 1;
    extern __shared__ float smem[];
    float* s_vr = smem;              // [W, m2]
    float* s_vi = s_vr + W * m2;
    float* s_a1 = s_vi + W * m2;     // [W, W]
    float* s_a2 = s_a1 + W * W;
    float* s_aw = s_a2 + W * W;
    float* s_b1 = s_aw + W * W;      // [W]
    float* s_b2 = s_b1 + W;
    float* s_bw = s_b2 + W;
    float* s_iyc = s_bw + W;         // [m2, ny]
    float* s_iys = s_iyc + m2 * ny;
    float* s_acc = s_iys + m2 * ny;  // [NP], entry k owned by thread k % T
    float* st_spec = s_acc + NP;     // [W, TS] per tile: spec, x, h, gs, dpre1
    float* st_x = st_spec + W * TS;
    float* st_h = st_x + W * TS;
    float* st_gs = st_h + W * TS;
    float* st_dp = st_gs + W * TS;

    const int row = blockIdx.x % nx;
    const int bv = blockIdx.x / nx;  // b*V + v
    const int v = bv % V, b = bv / V;

    for (int i = threadIdx.x; i < W * W; i += T) {
        s_a1[i] = a1[i];
        s_a2[i] = a2[i];
        s_aw[i] = aw[i];
    }
    for (int i = threadIdx.x; i < W; i += T) {
        s_b1[i] = b1[i];
        s_b2[i] = b2[i];
        s_bw[i] = bw[i];
    }
    for (int i = threadIdx.x; i < m2 * ny; i += T) {
        s_iyc[i] = iyc[i];
        s_iys[i] = iys[i];
    }
    for (int k = threadIdx.x; k < NP; k += T) s_acc[k] = 0.0f;
    inverse_x_row(mr + (long long)bv * W * m2 * K, mi + (long long)bv * W * m2 * K, cxT, sxT,
                  s_vr, s_vi, W, m2, K, nx, row);
    __syncthreads();

    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;   // channel stride
    const long long pix0 = (long long)v * plane + (long long)row * ny;
    const long long off = (long long)b * W * chan + pix0;

    for (int y0 = 0; y0 < ny; y0 += T) {
        const int t = threadIdx.x, y = y0 + t;
        if (y < ny) {
            float spec[W], xin[W], pre[W], h[W], gs[W];
#pragma unroll
            for (int o = 0; o < W; ++o) {
                float acc = 0.0f;
                for (int m = 0; m < m2; ++m)
                    acc += s_vr[o * m2 + m] * s_iyc[m * ny + y] +
                           s_vi[o * m2 + m] * s_iys[m * ny + y];
                spec[o] = acc * inv_scale;
            }
#pragma unroll
            for (int i = 0; i < W; ++i) xin[i] = x[off + i * chan + y];
#pragma unroll
            for (int j = 0; j < W; ++j) {
                float acc = s_b1[j];
#pragma unroll
                for (int o = 0; o < W; ++o) acc += s_a1[j * W + o] * spec[o];
                pre[j] = acc;
                h[j] = gelu_exact(acc);
            }
#pragma unroll
            for (int c = 0; c < W; ++c) {
                float x1 = s_b2[c];
#pragma unroll
                for (int j = 0; j < W; ++j) x1 += s_a2[c * W + j] * h[j];
                float x2 = s_bw[c];
#pragma unroll
                for (int i = 0; i < W; ++i) x2 += s_aw[c * W + i] * xin[i];
                const float sv = x1 + x2 + x3[pix0 + c * chan + y];
                gs[c] = g[off + c * chan + y] * gelu_grad_exact(sv);
                gs_out[off + c * chan + y] = gs[c];
            }
#pragma unroll
            for (int j = 0; j < W; ++j) {          // pre becomes dpre1
                float dh = 0.0f;
#pragma unroll
                for (int c = 0; c < W; ++c) dh += s_a2[c * W + j] * gs[c];
                pre[j] = dh * gelu_grad_exact(pre[j]);
            }
#pragma unroll
            for (int o = 0; o < W; ++o) {
                float ds = 0.0f;
#pragma unroll
                for (int j = 0; j < W; ++j) ds += s_a1[j * W + o] * pre[j];
                dspec_out[off + o * chan + y] = ds * inv_scale;
                float dxb = 0.0f;
#pragma unroll
                for (int c = 0; c < W; ++c) dxb += s_aw[c * W + o] * gs[c];
                dx[off + o * chan + y] = dxb;
            }
#pragma unroll
            for (int c = 0; c < W; ++c) {
                st_spec[c * TS + t] = spec[c];
                st_x[c * TS + t] = xin[c];
                st_h[c * TS + t] = h[c];
                st_gs[c * TS + t] = gs[c];
                st_dp[c * TS + t] = pre[c];
            }
        }
        __syncthreads();
        const int n = min(T, ny - y0);
        for (int k = threadIdx.x; k < NP; k += T) {
            const float* u;
            const float* w = nullptr;   // output k += sum_p u[p] * (w ? w[p] : 1)
            if (k < W * W) {
                u = st_dp + (k / W) * TS;                 // da1[j][o] = dpre1_j spec_o
                w = st_spec + (k % W) * TS;
            } else if (k < 2 * W * W) {
                const int q = k - W * W;                  // da2[c][j] = gs_c h_j
                u = st_gs + (q / W) * TS;
                w = st_h + (q % W) * TS;
            } else if (k < 3 * W * W) {
                const int q = k - 2 * W * W;              // daw[c][i] = gs_c x_i
                u = st_gs + (q / W) * TS;
                w = st_x + (q % W) * TS;
            } else if (k < 3 * W * W + W) {
                u = st_dp + (k - 3 * W * W) * TS;         // db1[j]
            } else {
                u = st_gs + (k - 3 * W * W - W) * TS;     // db2[c] (= dbw[c])
            }
            float acc = 0.0f;
            if (w != nullptr) {
                for (int p = 0; p < n; ++p) acc += u[p] * w[p];
            } else {
                for (int p = 0; p < n; ++p) acc += u[p];
            }
            s_acc[k] += acc;
        }
        __syncthreads();
    }
    for (int k = threadIdx.x; k < NP; k += T) partial[(long long)blockIdx.x * NP + k] = s_acc[k];
}

// ---- K6 stage 4: adjoint mix and spectral weight grads -----------------------
// dz[b,v,i,j] = sum_o dm[b,v,o,j] * conj-transposed w[i,o,v,j]:
//   dzr = sum_o dmr wr + dmi wi,   dzi = sum_o dmi wr - dmr wi.
__global__ void spectral_mix_adj_kernel(const float* __restrict__ dmr,
                                        const float* __restrict__ dmi,
                                        const float* __restrict__ wr, const float* __restrict__ wi,
                                        float* __restrict__ dzr, float* __restrict__ dzi, int B,
                                        int W, int V, int mk) {
    const long long total = (long long)B * V * W * mk;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int j = (int)(idx % mk);
        const int i = (int)((idx / mk) % W);
        const long long bv = idx / ((long long)mk * W);
        const int v = (int)(bv % V);
        const float* dr = dmr + bv * W * mk + j;
        const float* di = dmi + bv * W * mk + j;
        float ar = 0.0f, ai = 0.0f;
        for (int o = 0; o < W; ++o) {
            const float a = dr[(long long)o * mk], b = di[(long long)o * mk];
            const long long w = (((long long)i * W + o) * V + v) * mk + j;
            const float c = __ldg(wr + w), d = __ldg(wi + w);
            ar += a * c + b * d;
            ai += b * c - a * d;
        }
        dzr[idx] = ar;
        dzi[idx] = ai;
    }
}

// dw[i,o,v,j] = sum_b z[b,v,i,j] (x) dm[b,v,o,j]:
//   dwr = sum_b zr dmr + zi dmi,   dwi = sum_b zr dmi - zi dmr,
// one thread per weight, the batch in order.
__global__ void spectral_wgrad_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                                      const float* __restrict__ dmr,
                                      const float* __restrict__ dmi, float* __restrict__ dwr,
                                      float* __restrict__ dwi, int B, int W, int V, int mk) {
    const long long total = (long long)W * W * V * mk;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const int j = (int)(idx % mk);
        const int v = (int)((idx / mk) % V);
        const int o = (int)((idx / ((long long)mk * V)) % W);
        const int i = (int)(idx / ((long long)mk * V * W));
        float ar = 0.0f, ai = 0.0f;
        for (int b = 0; b < B; ++b) {
            const long long bv = (long long)b * V + v;
            const float a = zr[(bv * W + i) * mk + j], c = zi[(bv * W + i) * mk + j];
            const float dr = dmr[(bv * W + o) * mk + j], di = dmi[(bv * W + o) * mk + j];
            ar += a * dr + c * di;
            ai += a * di - c * dr;
        }
        dwr[idx] = ar;
        dwi[idx] = ai;
    }
}

// ---- K6 stage 5: adjoint of the forward DFT, added to dx ---------------------
// One block per (b, v, x) row: the inverse x transform of that row's
// [W, m2, K] spectrum (sr, si), then per pixel
//   out[b, c, v, row, y] += sum_m vr[c, m] ty_c[m, y] + vi[c, m] ty_s[m, y]
// with ty_c = cy^T, ty_s = sy^T [m2, ny].
__global__ void idft_add_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                                const float* __restrict__ cxT, const float* __restrict__ sxT,
                                const float* __restrict__ ty_c, const float* __restrict__ ty_s,
                                float* __restrict__ out, int W, int V, int nx, int ny, int m2,
                                int K) {
    extern __shared__ float smem[];
    float* s_vr = smem;              // [W, m2]
    float* s_vi = s_vr + W * m2;
    float* s_tc = s_vi + W * m2;     // [m2, ny]
    float* s_ts = s_tc + m2 * ny;
    const int row = blockIdx.x % nx;
    const int bv = blockIdx.x / nx;
    const int v = bv % V, b = bv / V;
    for (int i = threadIdx.x; i < m2 * ny; i += blockDim.x) {
        s_tc[i] = ty_c[i];
        s_ts[i] = ty_s[i];
    }
    inverse_x_row(sr + (long long)bv * W * m2 * K, si + (long long)bv * W * m2 * K, cxT, sxT,
                  s_vr, s_vi, W, m2, K, nx, row);
    __syncthreads();
    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;
    float* ob = out + (long long)b * W * chan + (long long)v * plane + (long long)row * ny;
    for (int y = threadIdx.x; y < ny; y += blockDim.x) {
        for (int c = 0; c < W; ++c) {
            float acc = 0.0f;
            for (int m = 0; m < m2; ++m)
                acc += s_vr[c * m2 + m] * s_tc[m * ny + y] + s_vi[c * m2 + m] * s_ts[m * ny + y];
            ob[c * chan + y] += acc;
        }
    }
}

// ---- the ordered second pass ------------------------------------------------
// out[k] = sum_r in[r, k] for r = 0 .. n_rows-1 in order.
__global__ void reduce_rows_kernel(const float* __restrict__ in, long long n_rows, long long n,
                                   float* __restrict__ out) {
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
         k += (long long)gridDim.x * blockDim.x) {
        float acc = 0.0f;
        for (long long r = 0; r < n_rows; ++r) acc += in[r * n + k];
        out[k] = acc;
    }
}

inline cudaError_t launch_reduce_rows(const float* in, long long n_rows, long long n, float* out,
                                      cudaStream_t s) {
    reduce_rows_kernel<<<grid_for(n), kThreads, 0, s>>>(in, n_rows, n, out);
    return cudaGetLastError();
}

// Threads of a row kernel: the row's width rounded up to warps, at most 128.
inline int row_threads(int ny) { return ny < 128 ? ((ny + 31) / 32) * 32 : 128; }

template <int W>
cudaError_t launch_bwd_row(const float* x, const float* g, const float* x3, const float* mr,
                           const float* mi, const float* cxT, const float* sxT, const float* iyc,
                           const float* iys, const float* a1, const float* b1, const float* a2,
                           const float* b2, const float* aw, const float* bw, float* dx,
                           float* gs, float* dspec, float* partial, int B, int V, int nx, int ny,
                           int m2, int K, float inv_scale, cudaStream_t s) {
    const int threads = row_threads(ny);
    const size_t smem = sizeof(float) * (2 * W * m2 + 3 * W * W + 3 * W + 2 * (size_t)m2 * ny +
                                         (3 * W * W + 2 * W) + 5 * W * (threads + 1));
    cudaError_t err = allow_smem(block_bwd_row_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    block_bwd_row_kernel<W><<<(unsigned)B * V * nx, threads, smem, s>>>(
        x, g, x3, mr, mi, cxT, sxT, iyc, iys, a1, b1, a2, b2, aw, bw, dx, gs, dspec, partial, V,
        nx, ny, m2, K, inv_scale);
    return cudaGetLastError();
}

// ---- K7: projection head backward --------------------------------------------
constexpr int kMaxStep = 10;
constexpr int kProjTile = 32;
constexpr int kProjBwdBlocks = 528;   // fixed: 4 per SM of an H100, one wave

// z [npix, W]; g [npix, step]; a1 [wp, W]; b1 [wp]; a2 [step, wp]; dz [npix, W];
// partial [kProjBwdBlocks, wp*W + wp + step*wp + step] as
// [da1 (j, i) | db1 (j) | da2 (s, j) | db2 (s)]. blockDim.x == wp.
template <int W>
__global__ void projection_bwd_kernel(const float* __restrict__ z, const float* __restrict__ g,
                                      const float* __restrict__ a1, const float* __restrict__ b1,
                                      const float* __restrict__ a2, float* __restrict__ dz,
                                      float* __restrict__ partial, long long npix, int wp,
                                      int step) {
    extern __shared__ float smem[];
    float* s_a1 = smem;                          // [wp, W]
    float* s_z = s_a1 + wp * W;                  // [kProjTile, W]
    float* s_g = s_z + kProjTile * W;            // [kProjTile, step]
    float* s_dp = s_g + kProjTile * kMaxStep;    // [kProjTile, wp]
    const int j = threadIdx.x;                   // this thread's hidden unit
    for (int i = threadIdx.x; i < wp * W; i += blockDim.x) s_a1[i] = a1[i];

    float a1r[W], da1[W], a2r[kMaxStep], da2[kMaxStep];
#pragma unroll
    for (int i = 0; i < W; ++i) {
        a1r[i] = a1[j * W + i];
        da1[i] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kMaxStep; ++s) {
        a2r[s] = s < step ? a2[s * wp + j] : 0.0f;
        da2[s] = 0.0f;
    }
    const float b1j = b1[j];
    float db1 = 0.0f, db2 = 0.0f;

    const long long n_tiles = (npix + kProjTile - 1) / kProjTile;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long long p0 = t * kProjTile;
        const int n = (int)(npix - p0 < kProjTile ? npix - p0 : kProjTile);
        __syncthreads();                         // the previous tile is consumed
        for (int q = threadIdx.x; q < n * W; q += blockDim.x) s_z[q] = z[p0 * W + q];
        for (int q = threadIdx.x; q < n * step; q += blockDim.x) s_g[q] = g[p0 * step + q];
        __syncthreads();
        for (int p = 0; p < n; ++p) {
            float pre = b1j;
#pragma unroll
            for (int i = 0; i < W; ++i) pre += a1r[i] * s_z[p * W + i];
            const float h = gelu_exact(pre);
            float dh = 0.0f;
#pragma unroll
            for (int s = 0; s < kMaxStep; ++s) {
                if (s < step) {
                    const float gv = s_g[p * step + s];
                    dh += gv * a2r[s];
                    da2[s] += gv * h;
                }
            }
            const float dp = dh * gelu_grad_exact(pre);
            s_dp[p * wp + j] = dp;
            db1 += dp;
#pragma unroll
            for (int i = 0; i < W; ++i) da1[i] += dp * s_z[p * W + i];
        }
        __syncthreads();
        for (int q = threadIdx.x; q < n * W; q += blockDim.x) {
            const int p = q / W, i = q % W;
            float acc = 0.0f;
            for (int k = 0; k < wp; ++k) acc += s_dp[p * wp + k] * s_a1[k * W + i];
            dz[p0 * W + q] = acc;
        }
        if (j < step)
            for (int p = 0; p < n; ++p) db2 += s_g[p * step + j];
    }

    const long long np = (long long)wp * W + wp + (long long)step * wp + step;
    float* out = partial + blockIdx.x * np;
#pragma unroll
    for (int i = 0; i < W; ++i) out[j * W + i] = da1[i];
    out[wp * W + j] = db1;
#pragma unroll
    for (int s = 0; s < kMaxStep; ++s)
        if (s < step) out[wp * W + wp + s * wp + j] = da2[s];
    if (j < step) out[wp * W + wp + step * wp + j] = db2;
}

template <int W>
cudaError_t launch_projection_bwd(const float* z, const float* g, const float* a1,
                                  const float* b1, const float* a2, float* dz, float* partial,
                                  float* red, long long npix, int wp, int step, cudaStream_t s) {
    const size_t smem = sizeof(float) * ((size_t)wp * W + kProjTile * W + kProjTile * kMaxStep +
                                         (size_t)kProjTile * wp);
    cudaError_t err = allow_smem(projection_bwd_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    projection_bwd_kernel<W><<<kProjBwdBlocks, wp, smem, s>>>(z, g, a1, b1, a2, dz, partial, npix,
                                                              wp, step);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long np = (long long)wp * W + wp + (long long)step * wp + step;
    return launch_reduce_rows(partial, kProjBwdBlocks, np, red, s);
}

}  // namespace

// Rows of the partial-sum scratch K7 takes (`partial` is [rows, np]).
CPPRE_EXPORT int cppre_projection2d_bwd_blocks() { return kProjBwdBlocks; }

// One Fourier block backward. `work` is 8 spectral scratch planes of
// [B, V, W, m2, K] (z, m, dm, dz, each re and im); gs and dspec are like x;
// partial is [B*V*nx, 3W^2 + 2W]; red gets the reduced channel-map grads
// [da1 | da2 | daw | db1 | db2] (port layout, (out, in)); dwr/dwi are
// [W, W, V, m2, K]; dx3 is [1, W, V, nx, ny].
CPPRE_EXPORT int cppre_fno_block2d_bwd(
    const void* x, const void* g, const void* x3, const void* wr, const void* wi, const void* a1,
    const void* b1, const void* a2, const void* b2, const void* aw, const void* bw,
    const void* cy, const void* sy, const void* cx, const void* sx, const void* cxT,
    const void* sxT, const void* iyc, const void* iys, const void* iycT, const void* iysT,
    const void* cyT, const void* syT, void* work, void* gs, void* dspec, void* partial, void* dx,
    void* dwr, void* dwi, void* red, void* dx3, int B, int W, int V, int nx, int ny, int m2,
    int K, float inv_scale, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long S = (long long)B * V * W * m2 * K;
    float* zr = (float*)work;
    float *zi = zr + S, *mr = zi + S, *mi = mr + S, *dmr = mi + S, *dmi = dmr + S;
    float *dzr = dmi + S, *dzi = dzr + S;
    const int mk = m2 * K;

    cudaError_t err = launch_dft_fwd((const float*)x, (const float*)cy, (const float*)sy,
                                     (const float*)cx, (const float*)sx, zr, zi, B, W, V, nx, ny,
                                     m2, K, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_spectral_mix(zr, zi, (const float*)wr, (const float*)wi, mr, mi, B, W, V, mk, s);
    if (err != cudaSuccess) return (int)err;

#define CPPRE_BWD_ROW(WW)                                                                        \
    launch_bwd_row<WW>((const float*)x, (const float*)g, (const float*)x3, mr, mi,              \
                       (const float*)cxT, (const float*)sxT, (const float*)iyc,                 \
                       (const float*)iys, (const float*)a1, (const float*)b1, (const float*)a2, \
                       (const float*)b2, (const float*)aw, (const float*)bw, (float*)dx,        \
                       (float*)gs, (float*)dspec, (float*)partial, B, V, nx, ny, m2, K,         \
                       inv_scale, s)
    switch (W) {
        case 4: err = CPPRE_BWD_ROW(4); break;
        case 8: err = CPPRE_BWD_ROW(8); break;
        case 16: err = CPPRE_BWD_ROW(16); break;
        case 32: err = CPPRE_BWD_ROW(32); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef CPPRE_BWD_ROW
    if (err != cudaSuccess) return (int)err;

    err = launch_dft_fwd((const float*)dspec, (const float*)iycT, (const float*)iysT,
                         (const float*)cx, (const float*)sx, dmr, dmi, B, W, V, nx, ny, m2, K, s);
    if (err != cudaSuccess) return (int)err;
    spectral_mix_adj_kernel<<<grid_for(S), kThreads, 0, s>>>(dmr, dmi, (const float*)wr,
                                                             (const float*)wi, dzr, dzi, B, W, V,
                                                             mk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    spectral_wgrad_kernel<<<grid_for((long long)W * W * V * mk), kThreads, 0, s>>>(
        zr, zi, dmr, dmi, (float*)dwr, (float*)dwi, B, W, V, mk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    const size_t smem5 = sizeof(float) * (2 * (size_t)W * m2 + 2 * (size_t)m2 * ny);
    if ((err = allow_smem(idft_add_kernel, smem5)) != cudaSuccess) return (int)err;
    idft_add_kernel<<<(unsigned)B * V * nx, row_threads(ny), smem5, s>>>(
        dzr, dzi, (const float*)cxT, (const float*)sxT, (const float*)cyT, (const float*)syT,
        (float*)dx, W, V, nx, ny, m2, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    err = launch_reduce_rows((const float*)partial, (long long)B * V * nx, 3LL * W * W + 2 * W,
                             (float*)red, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_reduce_rows((const float*)gs, B, (long long)W * V * nx * ny, (float*)dx3,
                                   s);
}

// Projection head backward; npix = B*V*Nx*Ny, 1 <= step <= 10, wp <= 1024.
CPPRE_EXPORT int cppre_projection2d_bwd(const void* z, const void* g, const void* a1,
                                        const void* b1, const void* a2, void* dz, void* partial,
                                        void* red, long long npix, int W, int wp, int step,
                                        void* stream) {
    if (step < 1 || step > kMaxStep || wp < 1 || wp > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define CPPRE_PROJ_BWD(WW)                                                                      \
    launch_projection_bwd<WW>((const float*)z, (const float*)g, (const float*)a1,              \
                              (const float*)b1, (const float*)a2, (float*)dz, (float*)partial, \
                              (float*)red, npix, wp, step, s)
    switch (W) {
        case 4: return (int)CPPRE_PROJ_BWD(4);
        case 8: return (int)CPPRE_PROJ_BWD(8);
        case 16: return (int)CPPRE_PROJ_BWD(16);
        case 32: return (int)CPPRE_PROJ_BWD(32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CPPRE_PROJ_BWD
}
