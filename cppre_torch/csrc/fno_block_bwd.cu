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
// changes from run to run. Here every sum has one fixed order: a fixed grid
// (a function of the shape alone) splits the work the same way on every
// run, a block writes its partial sums to a [n_blocks, n] scratch, and a
// second launch (reduce_rows_kernel) adds the rows in block order; a
// per-cell sum over the batch (dx3, the spectral grads) is one thread per
// cell looping over b. So the gradients are bit-stable from run to run.
//
// K6 cannot take the TPU's working set either: about 14 full [W, Nx, Ny]
// planes per (b, v), ~9 MB at the NS flagship, against 227 KB of shared
// memory a block. It is split like K4 (fno_block.cu), nine launches:
//   1. dft_fwd_kernel + spectral_mix_kernel (fno_dft.cuh) recompute the
//      spectrum z of x and its mix m, kept for the spectral grads, and
//      inverse_x_kernel (fno_tile.cuh) m's inverse-x rows;
//   2. block_bwd_tile_kernel, per tile of up to 128 pixels of one plane:
//      the inverse y transform to `spec`, the MLP forward, bypass and bias,
//      gs = g*gelu'(s), then dh, dpre1 and dspec, all as fno_tile.cuh's
//      4 x 4 micro-tile products; the channel-map grads are products over
//      the pixel index that each thread adds into its registers;
//   3. dft_fwd_kernel on dspec with the transposed weighted tables
//      [iyc^T | iys^T]: the adjoint of the inverse DFT, dm;
//   4. spectral_adjoint_kernel: dz from the transposed spectral weights,
//      and sum_b z (x) dm per (in, out, v, mode), the spectral grads;
//   5. inverse_x_kernel on dz, then idft_dx_tile_kernel: dx = aw^T gs plus
//      the adjoint of the forward DFT of dz, written once;
//   6. reduce_rows_kernel: the partial rows, and dx3 = sum_b gs.
// What bounds it on this card: the FP32 pipe, ~10k multiply-adds a pixel
// at width 32 (the forward recomputed, three transposed maps, three
// gradient sums) against x and g read twice, gs and dspec written and read
// once and dx written. A thread per pixel would hold five W-long arrays
// (spilling at width 32), and a partial row per grid row would be 40 MB of
// scratch at the wave shape; here stage 2 runs a fixed grid of 132 (width
// 32) or 264 blocks, each walking its tiles in order with its share of the
// three W x W gradients in registers, so the partial scratch is one row
// per block and no width spills.
//
// K7. Per (pixel, hidden unit) 3W + 2*step multiply-adds (fc1 recomputed,
// da1, dz; dh, da2) and one gelu with its derivative, against z and g read
// and dz written once: bounded by the FP32 pipe and the shared-memory
// loads that feed it. The tile walk and fc1 micro-tiles are K5's
// (fno_tile.cuh's projection tiles), with two 4 x 4 micro-tiles a thread
// for one float4 shared load per 8 FMAs; one erf a
// (pixel, hidden unit) gives both h and gelu' (proj_gelu_and_grad,
// common.cuh); dz is a micro-tile product over the hidden index split in
// 128/W parts added in order, so every thread has 4 x 4 outputs; and each
// thread keeps fixed micro-tiles of da1 and its column of da2, db1 in
// registers across its block's tiles. A fixed grid (proj_blocks, a
// function of npix alone) writes one partial row a block.

#include "fno_dft.cuh"
#include "fno_tile.cuh"

namespace {

// ---- K6 stage 2: recompute + pointwise backward, one tile at a time -------
// x, g, gs, dspec [B, W, V, nx, ny]; x3 [1, W, V, nx, ny]; vx the inverse-x
// rows of the mixed spectrum [B, V, nx, 2*m2, W] (inverse_x_kernel); a1,
// a2, aw [W, W] as (out, in). Per pixel:
//   spec = inverse-y of vx;  pre1 = a1 spec + b1;  h = gelu(pre1)
//   s = a2 h + aw x + b2 + bw + x3;  gs = g * gelu'(s)
//   dpre1 = (a2^T gs) * gelu'(pre1);  dspec = a1^T dpre1
// gs and dspec * inv_scale (the adjoint DFT's input) go to device memory;
// stage 5 forms dx from gs. Each thread owns fixed 2x2 micro-tiles of the
// three weight-gradient matrices in registers and adds every tile the block
// walks into them, in tile then pixel order:
//   da1 += dpre1 spec^T,  da2 += gs h^T,  daw += gs x^T,  db1, db2 the sums;
// at the end the block writes its one partial row
//   partial[blockIdx.x, :] = [da1 (j, o) | da2 (c, j) | daw (c, i) | db1 | db2].
// Pixels off the grid have gs = 0, so they add nothing.
template <int W>
__global__ void __launch_bounds__(8 * W, 1)
    block_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ x3, const float* __restrict__ vx,
                          const float* __restrict__ iyc, const float* __restrict__ iys,
                          const float* __restrict__ a1, const float* __restrict__ b1,
                          const float* __restrict__ a2, const float* __restrict__ b2,
                          const float* __restrict__ aw, const float* __restrict__ bw,
                          float* __restrict__ gs_out, float* __restrict__ dspec_out,
                          float* __restrict__ partial, int V, int nx, int ny, int m2,
                          float inv_scale, long long n_tiles) {
    constexpr int TL = W * kTileLd, T = 8 * W;
    constexpr int NT2 = (W / 2) * (W / 2);          // 2x2 micro-tiles of one W x W matrix
    constexpr int NQ = 3 * NT2, QMAX = (NQ + T - 1) / T;
    constexpr int NP = 3 * W * W + 2 * W;
    extern __shared__ float4 smem4[];
    const TileGeom geo = tile_geom(nx, ny);
    const int VL = geo.rt * 2 * m2 * W;             // floats of one tile's vx rows
    float* sX = reinterpret_cast<float*>(smem4);   // [2][W, kTileLd]
    float* sG = sX + 2 * TL;                        // [2][W, kTileLd]
    float* sS = sG + 2 * TL;                        // spec
    float* sH = sS + TL;                            // h
    float* sD = sH + TL;                            // gelu'(pre1), then dpre1
    float* sGS = sD + TL;                           // gs
    float* sA1T = sGS + TL;                         // [W, W] (in, out)
    float* sA1 = sA1T + W * W;                      // [W, W] (out, in)
    float* sA2T = sA1 + W * W;
    float* sA2 = sA2T + W * W;
    float* sAwT = sA2 + W * W;
    float* sB1 = sAwT + W * W;                      // [W]
    float* sB2 = sB1 + W;
    float* sBw = sB2 + W;
    float* sV = sBw + W;                            // [2][rt, 2*m2, W]
    float* sT = sV + 2 * VL;                        // [2*m2, ty]

    for (int i = threadIdx.x; i < W * W; i += blockDim.x) {
        const int o = i / W, k = i % W;             // a[o, k]
        sA1T[k * W + o] = a1[i];
        sA1[i] = a1[i];
        sA2T[k * W + o] = a2[i];
        sA2[i] = a2[i];
        sAwT[k * W + o] = aw[i];
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        sB1[i] = b1[i];
        sB2[i] = b2[i];
        sBw[i] = bw[i];
    }

    float gacc[QMAX][4], bacc = 0.0f;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) gacc[q][0] = gacc[q][1] = gacc[q][2] = gacc[q][3] = 0.0f;

    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;   // channel stride
    const int c0 = 4 * (threadIdx.x >> 5), p0 = 4 * (threadIdx.x & 31);
    const bool active = p0 < geo.used;
    long long t0, t1;
    tile_range(n_tiles, &t0, &t1);
    if (t0 < t1) {
        const Tile t = tile_at(t0, geo);
        const long long off = (t.bv / V) * W * chan + (t.bv % V) * plane;
        tile_load_async<W>(x + off, chan, nx, ny, geo, t, sX);
        tile_load_async<W>(g + off, chan, nx, ny, geo, t, sG);
        tile_load_vx_async<W>(vx, nx, m2, geo, t, sV);
    }
    copy_async_commit();
    int staged_y0 = -1;
    for (long long ti = t0; ti < t1; ++ti) {
        const int buf = (int)((ti - t0) & 1);
        const Tile t = tile_at(ti, geo);
        if (ti + 1 < t1) {
            const Tile nt = tile_at(ti + 1, geo);
            const long long off = (nt.bv / V) * W * chan + (nt.bv % V) * plane;
            tile_load_async<W>(x + off, chan, nx, ny, geo, nt, sX + (buf ^ 1) * TL);
            tile_load_async<W>(g + off, chan, nx, ny, geo, nt, sG + (buf ^ 1) * TL);
            tile_load_vx_async<W>(vx, nx, m2, geo, nt, sV + (buf ^ 1) * VL);
        }
        copy_async_commit();
        if (t.y0 != staged_y0) {                    // the same for every thread of the block
            tile_y_tables(iyc, iys, ny, m2, geo, t.y0, sT);
            staged_y0 = t.y0;
        }
        copy_async_wait<1>();
        __syncthreads();

        const float* tX = sX + buf * TL;
        const float* tG = sG + buf * TL;
        const int r = p0 / geo.ty, row = t.r0 + r, y = t.y0 + p0 - r * geo.ty;
        const long long pix = (long long)row * ny + y;
        const long long off = (t.bv / V) * W * chan + (t.bv % V) * plane + pix;
        float acc[4][4];
        if (active) {                               // spec
            tile_zero(acc);
            tile_inverse_y<W>(acc, sV + buf * VL, sT, geo, m2, c0, p0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(sS + (c0 + i) * kTileLd + p0) =
                    make_float4(acc[i][0] * inv_scale, acc[i][1] * inv_scale,
                                acc[i][2] * inv_scale, acc[i][3] * inv_scale);
        }
        __syncthreads();
        if (active) {                               // h and gelu'(pre1)
            tile_zero(acc);
            tile_mma(acc, sA1T + c0, W, sS + p0, kTileLd, W);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float b = sB1[c0 + i];
                float h[4], d[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    h[j] = gelu_exact(acc[i][j] + b);
                    d[j] = gelu_grad_exact(acc[i][j] + b);
                }
                *reinterpret_cast<float4*>(sH + (c0 + i) * kTileLd + p0) =
                    make_float4(h[0], h[1], h[2], h[3]);
                *reinterpret_cast<float4*>(sD + (c0 + i) * kTileLd + p0) =
                    make_float4(d[0], d[1], d[2], d[3]);
            }
        }
        __syncthreads();
        if (active) {                               // gs
            tile_zero(acc);
            tile_mma(acc, sA2T + c0, W, sH + p0, kTileLd, W);
            tile_mma(acc, sAwT + c0, W, tX + p0, kTileLd, W);
            const float* x3b = x3 + (t.bv % V) * plane + pix;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = c0 + i;
                const float b = sB2[c] + sBw[c];
                float gv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool ok = row < nx && y + j < ny;
                    gv[j] = ok ? tG[c * kTileLd + p0 + j] *
                                     gelu_grad_exact(acc[i][j] + b + x3b[c * chan + j])
                               : 0.0f;
                    if (ok) gs_out[off + c * chan + j] = gv[j];
                }
                *reinterpret_cast<float4*>(sGS + c * kTileLd + p0) =
                    make_float4(gv[0], gv[1], gv[2], gv[3]);
            }
        }
        __syncthreads();
        if (active) {                               // dpre1, in place of gelu'(pre1)
            tile_zero(acc);
            tile_mma(acc, sA2 + c0, W, sGS + p0, kTileLd, W);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float4* d = reinterpret_cast<float4*>(sD + (c0 + i) * kTileLd + p0);
                const float4 gp = *d;
                *d = make_float4(acc[i][0] * gp.x, acc[i][1] * gp.y, acc[i][2] * gp.z,
                                 acc[i][3] * gp.w);
            }
        }
        __syncthreads();
        if (active) {                               // dspec
            tile_zero(acc);
            tile_mma(acc, sA1 + c0, W, sD + p0, kTileLd, W);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (row < nx && y + j < ny)
                        dspec_out[off + (c0 + i) * chan + j] = acc[i][j] * inv_scale;
        }
        // the weight-gradient sums over this tile's pixels
#pragma unroll
        for (int qi = 0; qi < QMAX; ++qi) {
            const int q = threadIdx.x + qi * T;
            if (q < NQ) {
                const int mtx = q / NT2, rem = q % NT2;
                const int i0 = 2 * (rem / (W / 2)), j0 = 2 * (rem % (W / 2));
                const float* u = mtx == 0 ? sD : sGS;
                const float* v = mtx == 0 ? sS : (mtx == 1 ? sH : tX);
                tile_outer2x2(gacc[qi], u + i0 * kTileLd, v + j0 * kTileLd, geo.used);
            }
        }
        if (threadIdx.x < 2 * W) {
            const float* u = threadIdx.x < W ? sD + threadIdx.x * kTileLd
                                             : sGS + (threadIdx.x - W) * kTileLd;
            for (int p = 0; p < geo.used; ++p) bacc += u[p];
        }
        __syncthreads();                            // the tile's buffers are free again
    }
    copy_async_wait<0>();

    float* out = partial + (long long)blockIdx.x * NP;
#pragma unroll
    for (int qi = 0; qi < QMAX; ++qi) {
        const int q = threadIdx.x + qi * T;
        if (q < NQ) {
            const int mtx = q / NT2, rem = q % NT2;
            const int i0 = 2 * (rem / (W / 2)), j0 = 2 * (rem % (W / 2));
            float* o = out + mtx * W * W + i0 * W + j0;
            o[0] = gacc[qi][0];
            o[1] = gacc[qi][1];
            o[W] = gacc[qi][2];
            o[W + 1] = gacc[qi][3];
        }
    }
    if (threadIdx.x < 2 * W) out[3 * W * W + threadIdx.x] = bacc;
}

// ---- K6 stage 4: adjoint mix and spectral weight grads -----------------------
// dz[b,v,i,j] = sum_o dm[b,v,o,j] * conj-transposed w[i,o,v,j]:
//   dzr = sum_o dmr wr + dmi wi,   dzi = sum_o dmi wr - dmr wi.
__device__ __forceinline__ void spectral_mix_adj_at(long long idx, const float* __restrict__ dmr,
                                                    const float* __restrict__ dmi,
                                                    const float* __restrict__ wr,
                                                    const float* __restrict__ wi,
                                                    float* __restrict__ dzr,
                                                    float* __restrict__ dzi, int W, int V,
                                                    int mk) {
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

// dw[i,o,v,j] = sum_b z[b,v,i,j] (x) dm[b,v,o,j]:
//   dwr = sum_b zr dmr + zi dmi,   dwi = sum_b zr dmi - zi dmr,
// one thread per weight, the batch in order.
__device__ __forceinline__ void spectral_wgrad_at(long long idx, const float* __restrict__ zr,
                                                  const float* __restrict__ zi,
                                                  const float* __restrict__ dmr,
                                                  const float* __restrict__ dmi,
                                                  float* __restrict__ dwr,
                                                  float* __restrict__ dwi, int B, int W, int V,
                                                  int mk) {
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

// Both in one launch: items [0, B*V*W*mk) of dz, then the W*W*V*mk weights.
__global__ void spectral_adjoint_kernel(const float* __restrict__ zr,
                                        const float* __restrict__ zi,
                                        const float* __restrict__ dmr,
                                        const float* __restrict__ dmi,
                                        const float* __restrict__ wr, const float* __restrict__ wi,
                                        float* __restrict__ dzr, float* __restrict__ dzi,
                                        float* __restrict__ dwr, float* __restrict__ dwi, int B,
                                        int W, int V, int mk) {
    const long long n_dz = (long long)B * V * W * mk, total = n_dz + (long long)W * W * V * mk;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        if (idx < n_dz)
            spectral_mix_adj_at(idx, dmr, dmi, wr, wi, dzr, dzi, W, V, mk);
        else
            spectral_wgrad_at(idx - n_dz, zr, zi, dmr, dmi, dwr, dwi, B, W, V, mk);
    }
}

// ---- K6 stage 5: dx = the bypass part plus the adjoint of the forward DFT --
// Per tile of a (b, v) plane, from gs and the inverse-x rows vx [B, V, nx,
// 2*m2, W] of the spectrum dz (inverse_x_kernel):
//   dx[b, c, v, row, y] = sum_k aw[k, c] gs[k] + sum_m vr[c, m] ty_c[m, y] + vi[c, m] ty_s[m, y]
// with ty_c = cy^T, ty_s = sy^T [m2, ny].
template <int W>
__global__ void __launch_bounds__(8 * W, 1)
    idft_dx_tile_kernel(const float* __restrict__ vx, const float* __restrict__ ty_c,
                        const float* __restrict__ ty_s, const float* __restrict__ aw,
                        const float* __restrict__ gs, float* __restrict__ dx, int V, int nx,
                        int ny, int m2, long long n_tiles) {
    constexpr int TL = W * kTileLd;
    extern __shared__ float4 smem4[];
    const TileGeom geo = tile_geom(nx, ny);
    const int VL = geo.rt * 2 * m2 * W;
    float* sGS = reinterpret_cast<float*>(smem4);  // [2][W, kTileLd]
    float* sAw = sGS + 2 * TL;                      // [W, W] (out, in): aw^T's (in, out)
    float* sV = sAw + W * W;                        // [2][rt, 2*m2, W]
    float* sT = sV + 2 * VL;                        // [2*m2, ty]
    for (int i = threadIdx.x; i < W * W; i += blockDim.x) sAw[i] = aw[i];

    const long long plane = (long long)nx * ny;
    const long long chan = (long long)V * plane;
    const int c0 = 4 * (threadIdx.x >> 5), p0 = 4 * (threadIdx.x & 31);
    const bool active = p0 < geo.used;
    long long t0, t1;
    tile_range(n_tiles, &t0, &t1);
    if (t0 < t1) {
        const Tile t = tile_at(t0, geo);
        tile_load_async<W>(gs + (t.bv / V) * W * chan + (t.bv % V) * plane, chan, nx, ny, geo, t,
                           sGS);
        tile_load_vx_async<W>(vx, nx, m2, geo, t, sV);
    }
    copy_async_commit();
    int staged_y0 = -1;
    for (long long ti = t0; ti < t1; ++ti) {
        const int buf = (int)((ti - t0) & 1);
        const Tile t = tile_at(ti, geo);
        if (ti + 1 < t1) {
            const Tile nt = tile_at(ti + 1, geo);
            tile_load_async<W>(gs + (nt.bv / V) * W * chan + (nt.bv % V) * plane, chan, nx, ny,
                               geo, nt, sGS + (buf ^ 1) * TL);
            tile_load_vx_async<W>(vx, nx, m2, geo, nt, sV + (buf ^ 1) * VL);
        }
        copy_async_commit();
        if (t.y0 != staged_y0) {
            tile_y_tables(ty_c, ty_s, ny, m2, geo, t.y0, sT);
            staged_y0 = t.y0;
        }
        copy_async_wait<1>();
        __syncthreads();
        const int r = p0 / geo.ty, row = t.r0 + r, y = t.y0 + p0 - r * geo.ty;
        if (active && row < nx) {
            float acc[4][4];
            tile_zero(acc);
            tile_mma(acc, sAw + c0, W, sGS + buf * TL + p0, kTileLd, W);
            tile_inverse_y<W>(acc, sV + buf * VL, sT, geo, m2, c0, p0);
            float* ob = dx + (t.bv / V) * W * chan + (t.bv % V) * plane + (long long)row * ny + y;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (y + j < ny) ob[(c0 + i) * chan + j] = acc[i][j];
        }
        __syncthreads();
    }
    copy_async_wait<0>();
}

// ---- the ordered second pass ------------------------------------------------
// out[k] = sum_r in[r, k] for r = 0 .. n_rows-1 in order, for two such sums
// in one launch (items [0, n) of the first, then [0, n2) of the second;
// n2 = 0 for one).
__global__ void reduce_rows_kernel(const float* __restrict__ in, long long n_rows, long long n,
                                   float* __restrict__ out, const float* __restrict__ in2,
                                   long long n_rows2, long long n2, float* __restrict__ out2) {
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n + n2;
         k += (long long)gridDim.x * blockDim.x) {
        const bool first = k < n;
        const float* src = first ? in : in2;
        const long long rows = first ? n_rows : n_rows2, cols = first ? n : n2;
        const long long c = first ? k : k - n;
        float acc = 0.0f;
#pragma unroll 8
        for (long long r = 0; r < rows; ++r) acc += src[r * cols + c];
        (first ? out : out2)[c] = acc;
    }
}

inline cudaError_t launch_reduce_rows(const float* in, long long n_rows, long long n, float* out,
                                      const float* in2, long long n_rows2, long long n2,
                                      float* out2, cudaStream_t s) {
    reduce_rows_kernel<<<grid_for(n + n2), kThreads, 0, s>>>(in, n_rows, n, out, in2, n_rows2,
                                                             n2, out2);
    return cudaGetLastError();
}

// Blocks of K6's stage 2: a function of the shape alone (one per SM of an
// H100 at width 32, two below: one wave), so the split of tiles over blocks,
// and the order of every weight-gradient sum, is the same on every run.
inline long long bwd_tile_blocks(int W, long long n_tiles) {
    const long long cap = W >= 32 ? 132 : 264;
    return n_tiles < cap ? n_tiles : cap;
}

// Blocks of K6's stage 5 (no cross-block sum).
inline long long idft_dx_blocks(long long n_tiles) { return n_tiles < 528 ? n_tiles : 528; }

template <int W>
cudaError_t launch_bwd_tiles(const float* x, const float* g, const float* x3, const float* vx,
                             const float* iyc, const float* iys, const float* cyT,
                             const float* syT, const float* a1, const float* b1, const float* a2,
                             const float* b2, const float* aw, const float* bw, float* gs,
                             float* dspec, float* partial, float* dx, int B, int V, int nx,
                             int ny, int m2, float inv_scale, bool stage5, cudaStream_t s) {
    const TileGeom geo = tile_geom(nx, ny);
    const long long n_tiles = (long long)B * V * geo.per_plane;
    const size_t spec = tile_spec_floats(W, m2, geo);
    cudaError_t err;
    if (!stage5) {
        const size_t smem =
            sizeof(float) * ((size_t)8 * W * kTileLd + 5 * W * W + 3 * W + spec);
        if ((err = allow_smem(block_bwd_tile_kernel<W>, smem)) != cudaSuccess) return err;
        block_bwd_tile_kernel<W><<<(unsigned)bwd_tile_blocks(W, n_tiles), 8 * W, smem, s>>>(
            x, g, x3, vx, iyc, iys, a1, b1, a2, b2, aw, bw, gs, dspec, partial, V, nx, ny, m2,
            inv_scale, n_tiles);
        return cudaGetLastError();
    }
    const size_t smem = sizeof(float) * ((size_t)2 * W * kTileLd + W * W + spec);
    if ((err = allow_smem(idft_dx_tile_kernel<W>, smem)) != cudaSuccess) return err;
    idft_dx_tile_kernel<W><<<(unsigned)idft_dx_blocks(n_tiles), 8 * W, smem, s>>>(
        vx, cyT, syT, aw, gs, dx, V, nx, ny, m2, n_tiles);
    return cudaGetLastError();
}

// ---- K7: projection head backward --------------------------------------------
// z [npix, W]; g [npix, step]; a1 [256, W]; b1 [256]; a2 [step, 256];
// dz [npix, W]; partial [proj_blocks(npix), 256*W + 256 + step*256 + step]
// as [da1 (j, i) | db1 (j) | da2 (s, j) | db2 (s)]. One tile of kProjP
// pixels at a time (fno_tile.cuh's projection tiles), z and g of the next
// tile copied with cp.async while the current one computes:
//   1. per thread two 4 x 4 micro-tiles of pre = a1 z^T + b1 (as K5), one
//      erf per (pixel, hidden unit) giving h and gelu'(pre)
//      (proj_gelu_and_grad), dh = a2^T g (s in order), dpre = dh gelu';
//      h and dpre go to shared memory [kProjP, kProjLdA];
//   2. the weight-gradient sums over the tile's pixels, in pixel order,
//      into registers each thread keeps across all its block's tiles:
//      da2[:, t] and db1[t] for hidden unit t, da1 as 4 x 4 micro-tiles
//      (dpre^T z), db2 for t < step; and dz's micro-tile (4 pixels x 4
//      channels) over one of 128/W parts of the hidden index;
//   3. the parts of dz, added in part order, written once, coalesced.
// The block writes its partial row at the end; reduce_rows_kernel adds the
// rows in block order.
constexpr int kMaxStep = 10;
template <int W, int S>
__host__ __device__ constexpr int proj_bwd_floats() {
    return W * kProjLdA + kProjHidden * S + kProjHidden + 2 * kProjP * proj_ldz(W) +
           2 * kProjP * S + 2 * kProjP * kProjLdA;
}

template <int W, int S>
__global__ void __launch_bounds__(kProjThreads, 2)
    projection_bwd_tile_kernel(const float* __restrict__ z, const float* __restrict__ g,
                               const float* __restrict__ a1, const float* __restrict__ b1,
                               const float* __restrict__ a2, float* __restrict__ dz,
                               float* __restrict__ partial, long long npix, int step,
                               long long n_tiles) {
    constexpr int LDZ = proj_ldz(W), ZT = kProjP * LDZ, GT = kProjP * S;
    constexpr int NA = 16 * W, QA = (NA + kProjThreads - 1) / kProjThreads;  // da1 micro-tiles
    constexpr int NMT = 2 * W, HP = 2 * W, KS = kProjHidden / HP;  // dz micro-tiles, parts
    extern __shared__ float4 smem4[];
    float* sA1T = reinterpret_cast<float*>(smem4);   // [W, kProjLdA]
    float* sA2T = sA1T + W * kProjLdA;                // [256, S]
    float* sB1 = sA2T + kProjHidden * S;               // [256]
    float* sZ = sB1 + kProjHidden;                     // [2][kProjP, LDZ]
    float* sG = sZ + 2 * ZT;                           // [2][kProjP, S]
    float* sH = sG + 2 * GT;                           // [kProjP, kProjLdA]: h, then dz parts
    float* sD = sH + kProjP * kProjLdA;                // [kProjP, kProjLdA]: dpre
    proj_stage_weights<W, S>(a1, b1, a2, step, sA1T, sB1, sA2T);

    const int t = threadIdx.x, pg = t & 7, hs = t >> 3;
    const int part = t / NMT, dz_i0 = 4 * ((t % NMT) >> 3);
    float gacc[QA][4][4], acc2[S], db1 = 0.0f, db2 = 0.0f;
#pragma unroll
    for (int q = 0; q < QA; ++q) tile_zero(gacc[q]);
#pragma unroll
    for (int s = 0; s < S; ++s) acc2[s] = 0.0f;

    long long t0, t1;
    tile_range(n_tiles, &t0, &t1);
    if (t0 < t1) {
        proj_load_z_async<W>(z, t0 * kProjP, npix, sZ);
        proj_load_g_async<S>(g, t0 * kProjP, npix, step, sG);
    }
    copy_async_commit();
    for (long long ti = t0; ti < t1; ++ti) {
        const int buf = (int)((ti - t0) & 1);
        if (ti + 1 < t1) {
            proj_load_z_async<W>(z, (ti + 1) * kProjP, npix, sZ + (buf ^ 1) * ZT);
            proj_load_g_async<S>(g, (ti + 1) * kProjP, npix, step, sG + (buf ^ 1) * GT);
        }
        copy_async_commit();
        copy_async_wait<1>();
        __syncthreads();
        const float* zt = sZ + buf * ZT;
        const float* gt = sG + buf * GT;

        // 1. recompute, gelu and gelu', dpre (pixels past npix have g = 0)
#pragma unroll 1
        for (int ch = 0; ch < 2; ++ch) {
            const int c0 = 8 * hs + 4 * ch;
            float pre[4][4], dh[4][4];
            proj_fc1<W>(pre, sA1T, c0, zt + pg * LDZ);
            tile_zero(dh);
#pragma unroll 2
            for (int s = 0; s < S; ++s) {
                float gv[4], wv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) gv[j] = gt[(pg + 8 * j) * S + s];
#pragma unroll
                for (int a = 0; a < 4; ++a) wv[a] = sA2T[(c0 + a) * S + s];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int j = 0; j < 4; ++j) dh[a][j] = fmaf(wv[a], gv[j], dh[a][j]);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float b = sB1[c0 + a];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float d;
                    proj_gelu_and_grad(pre[a][j] + b, pre[a][j], d);
                    dh[a][j] *= d;
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int row = (pg + 8 * j) * kProjLdA + c0;
                store4(sH + row, pre[0][j], pre[1][j], pre[2][j], pre[3][j]);
                store4(sD + row, dh[0][j], dh[1][j], dh[2][j], dh[3][j]);
            }
        }
        __syncthreads();

        // 2. the tile's share of the weight-gradient sums, in pixel order
#pragma unroll 2
        for (int p = 0; p < kProjP; ++p) {                 // da2, db1 at hidden unit t
            const float hv = sH[p * kProjLdA + t];
            db1 += sD[p * kProjLdA + t];
#pragma unroll
            for (int s = 0; s < S; ++s) acc2[s] = fmaf(gt[p * S + s], hv, acc2[s]);
        }
        if (t < step)
            for (int p = 0; p < kProjP; ++p) db2 += gt[p * S + t];
#pragma unroll
        for (int q = 0; q < QA; ++q) {                     // da1 += dpre^T z
            const int m = t + q * kProjThreads;
            if (m < NA) {
                const int rest = m >> 3, ig = rest % (W / 4);
                const int cg = (rest / (W / 4)) * 8 + (m & 7);
#pragma unroll 4
                for (int p = 0; p < kProjP; ++p) {
                    float dv[4], zv[4];
                    load4(dv, sD + p * kProjLdA + 4 * cg);
                    load4(zv, zt + p * LDZ + 4 * ig);
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b)
                            gacc[q][a][b] = fmaf(dv[a], zv[b], gacc[q][a][b]);
                }
            }
        }
        float acc[4][4];                                   // dz: pixel j, channel dz_i0 + i
        tile_zero(acc);
#pragma unroll 2
        for (int c = part * HP; c < (part + 1) * HP; c += 4) {
            float dv[4][4], av[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) load4(dv[j], sD + (pg + 8 * j) * kProjLdA + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) load4(av[i], sA1T + (dz_i0 + i) * kProjLdA + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(dv[j][cc], av[i][cc], acc[j][i]);
        }
        __syncthreads();                                   // h is read: its room takes dz's parts
#pragma unroll
        for (int j = 0; j < 4; ++j)
            store4(sH + (part * kProjP + pg + 8 * j) * W + dz_i0, acc[j][0], acc[j][1], acc[j][2],
                   acc[j][3]);
        __syncthreads();

        // 3. dz, the parts in order
        const long long pb = ti * kProjP;
#pragma unroll
        for (int n = 0; n < (kProjP * W + kProjThreads - 1) / kProjThreads; ++n) {
            const int k = t + n * kProjThreads;
            if (k < kProjP * W && pb + k / W < npix) {
                float v = sH[k];
#pragma unroll
                for (int r = 1; r < KS; ++r) v += sH[r * kProjP * W + k];
                dz[pb * W + k] = v;
            }
        }   // the next tile's first __syncthreads frees this one's buffers
    }
    copy_async_wait<0>();

    const long long np = (long long)kProjHidden * W + kProjHidden + (long long)step * kProjHidden +
                         step;
    float* out = partial + (long long)blockIdx.x * np;
#pragma unroll
    for (int q = 0; q < QA; ++q) {
        const int m = t + q * kProjThreads;
        if (m < NA) {
            const int rest = m >> 3, ig = rest % (W / 4);
            const int cg = (rest / (W / 4)) * 8 + (m & 7);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) out[(4 * cg + a) * W + 4 * ig + b] = gacc[q][a][b];
        }
    }
    out[kProjHidden * W + t] = db1;
#pragma unroll
    for (int s = 0; s < S; ++s)
        if (s < step) out[kProjHidden * W + kProjHidden + s * kProjHidden + t] = acc2[s];
    if (t < step) out[kProjHidden * W + kProjHidden + step * kProjHidden + t] = db2;
}

template <int W, int S>
cudaError_t launch_projection_bwd(const float* z, const float* g, const float* a1,
                                  const float* b1, const float* a2, float* dz, float* partial,
                                  float* red, long long npix, int step, cudaStream_t s) {
    const size_t smem = sizeof(float) * proj_bwd_floats<W, S>();
    cudaError_t err = allow_smem(projection_bwd_tile_kernel<W, S>, smem);
    if (err != cudaSuccess) return err;
    const long long n_blocks = proj_blocks(npix);
    projection_bwd_tile_kernel<W, S><<<(unsigned)n_blocks, kProjThreads, smem, s>>>(
        z, g, a1, b1, a2, dz, partial, npix, step, (npix + kProjP - 1) / kProjP);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long np = (long long)kProjHidden * W + kProjHidden + (long long)step * kProjHidden +
                         step;
    return launch_reduce_rows(partial, n_blocks, np, red, nullptr, 0, 0, nullptr, s);
}

}  // namespace

// Rows of the partial-sum scratch K7 takes for npix pixels (`partial` is
// [rows, 256*W + 256 + step*256 + step]).
CPPRE_EXPORT long long cppre_projection2d_bwd_blocks(long long npix) {
    return proj_blocks(npix);
}

// Rows of the partial-sum scratch K6 takes at this shape (`partial` is
// [rows, 3W^2 + 2W]): the blocks of its stage 2.
CPPRE_EXPORT long long cppre_fno_block2d_bwd_blocks(int B, int W, int V, int nx, int ny) {
    return bwd_tile_blocks(W, (long long)B * V * tile_geom(nx, ny).per_plane);
}

// One Fourier block backward. ty = [cy | sy] and ty_adj = [iyc^T | iys^T]
// are packed [ny, 2*m2p] (dft_fwd_kernel). `work` is 8 spectral scratch planes of
// [B, V, W, m2, K] (z, m, dm, dz, each re and im); vx is [B, V, nx, 2*m2, W]
// (the inverse-x rows of m, then of dz); gs and dspec are like x;
// partial is [cppre_fno_block2d_bwd_blocks(...), 3W^2 + 2W]; red gets the
// reduced channel-map grads [da1 | da2 | daw | db1 | db2] (port layout,
// (out, in)); dwr/dwi are [W, W, V, m2, K]; dx3 is [1, W, V, nx, ny].
CPPRE_EXPORT int cppre_fno_block2d_bwd(
    const void* x, const void* g, const void* x3, const void* wr, const void* wi, const void* a1,
    const void* b1, const void* a2, const void* b2, const void* aw, const void* bw,
    const void* ty, const void* cx, const void* sx, const void* cxT, const void* sxT,
    const void* iyc, const void* iys, const void* ty_adj, const void* cyT, const void* syT,
    void* work, void* vx, void* gs, void* dspec, void* partial,
    void* dx, void* dwr, void* dwi, void* red, void* dx3, int B, int W, int V, int nx, int ny,
    int m2, int K, float inv_scale, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long S = (long long)B * V * W * m2 * K;
    float* zr = (float*)work;
    float *zi = zr + S, *mr = zi + S, *mi = mr + S, *dmr = mi + S, *dmi = dmr + S;
    float *dzr = dmi + S, *dzi = dzr + S;
    const int mk = m2 * K;

    cudaError_t err = launch_dft_fwd((const float*)x, (const float*)ty, (const float*)cx,
                                     (const float*)sx, zr, zi, B, W, V, nx, ny, m2, K, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_spectral_mix(zr, zi, (const float*)wr, (const float*)wi, mr, mi, B, W, V, mk, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_inverse_x(mr, mi, (const float*)cxT, (const float*)sxT, (float*)vx, B, V, W, nx,
                           m2, K, s);
    if (err != cudaSuccess) return (int)err;

#define CPPRE_BWD_TILES(WW, STAGE5)                                                              \
    launch_bwd_tiles<WW>((const float*)x, (const float*)g, (const float*)x3, (const float*)vx,   \
                         (const float*)iyc, (const float*)iys, (const float*)cyT,               \
                         (const float*)syT, (const float*)a1, (const float*)b1,                 \
                         (const float*)a2, (const float*)b2, (const float*)aw,                  \
                         (const float*)bw, (float*)gs, (float*)dspec, (float*)partial,          \
                         (float*)dx, B, V, nx, ny, m2, inv_scale, STAGE5, s)
#define CPPRE_BWD_SWITCH(STAGE5)                                                                 \
    switch (W) {                                                                                 \
        case 4: err = CPPRE_BWD_TILES(4, STAGE5); break;                                         \
        case 8: err = CPPRE_BWD_TILES(8, STAGE5); break;                                         \
        case 16: err = CPPRE_BWD_TILES(16, STAGE5); break;                                       \
        case 32: err = CPPRE_BWD_TILES(32, STAGE5); break;                                       \
        default: return (int)cudaErrorInvalidValue;                                              \
    }
    CPPRE_BWD_SWITCH(false)
    if (err != cudaSuccess) return (int)err;

    err = launch_dft_fwd((const float*)dspec, (const float*)ty_adj, (const float*)cx,
                         (const float*)sx, dmr, dmi, B, W, V, nx, ny, m2, K, s);
    if (err != cudaSuccess) return (int)err;
    spectral_adjoint_kernel<<<grid_for(S + (long long)W * W * V * mk), kThreads, 0, s>>>(
        zr, zi, dmr, dmi, (const float*)wr, (const float*)wi, dzr, dzi, (float*)dwr, (float*)dwi,
        B, W, V, mk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_inverse_x(dzr, dzi, (const float*)cxT, (const float*)sxT, (float*)vx, B, V, W,
                           nx, m2, K, s);
    if (err != cudaSuccess) return (int)err;

    CPPRE_BWD_SWITCH(true)
    if (err != cudaSuccess) return (int)err;
#undef CPPRE_BWD_SWITCH
#undef CPPRE_BWD_TILES

    const long long n_blocks = cppre_fno_block2d_bwd_blocks(B, W, V, nx, ny);
    return (int)launch_reduce_rows((const float*)partial, n_blocks, 3LL * W * W + 2 * W,
                                   (float*)red, (const float*)gs, B,
                                   (long long)W * V * nx * ny, (float*)dx3, s);
}

// Projection head backward; npix = B*V*Nx*Ny >= 1, the hidden width 256,
// 1 <= step <= 10.
CPPRE_EXPORT int cppre_projection2d_bwd(const void* z, const void* g, const void* a1,
                                        const void* b1, const void* a2, void* dz, void* partial,
                                        void* red, long long npix, int W, int wp, int step,
                                        void* stream) {
    if (step < 1 || step > kMaxStep || wp != kProjHidden || npix < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define CPPRE_PROJ_BWD(WW, SS)                                                                  \
    launch_projection_bwd<WW, SS>((const float*)z, (const float*)g, (const float*)a1,          \
                                  (const float*)b1, (const float*)a2, (float*)dz,              \
                                  (float*)partial, (float*)red, npix, step, s)
#define CPPRE_PROJ_BWD_W(WW)                                                                    \
    (step == 1 ? CPPRE_PROJ_BWD(WW, 1)                                                          \
               : step <= 4 ? CPPRE_PROJ_BWD(WW, 4) : CPPRE_PROJ_BWD(WW, 12))
    switch (W) {
        case 4: return (int)CPPRE_PROJ_BWD_W(4);
        case 8: return (int)CPPRE_PROJ_BWD_W(8);
        case 16: return (int)CPPRE_PROJ_BWD_W(16);
        case 32: return (int)CPPRE_PROJ_BWD_W(32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CPPRE_PROJ_BWD_W
#undef CPPRE_PROJ_BWD
}
