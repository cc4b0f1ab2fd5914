"""The benchmark's yardstick: peaks, the work of each kernel, the kernel-name table.

Frozen here so that a change to the program cannot change how its work is
counted: the operations and bytes of a call follow from the algorithm's
shapes, whatever implements it. Copied from `chip_smoke.py` (`bound`,
`fno_block_macs`, the NS residual's flops per cell and the K4-K7 byte
counts of `fno_kernels`).
"""

from __future__ import annotations

import re

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# float32 outside the tensor cores (the configurations state float32 with
# TF32 off).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32 = 4                     # bytes of a float32
W_PROJ = 256                # FNO2d's projection width


def bound_s(n_bytes: float, flops: float) -> float:
    """The least seconds the chip could take: the larger of bytes over HBM
    bandwidth and flops over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def fno_block_macs(b, w, v, nx, ny, m, backward=False):
    """Multiply-adds of one Fourier block (K4) at modes m x m, K = 2m: the
    forward DFT y then x, the complex mix, the inverse x then y, the MLP
    and bypass. The backward (K6) recomputes all of it, runs each transform
    and the mix once more as its adjoint (plus the spectral weight grads),
    and adds 3 W x W maps (dh, dspec, dx) and 3 W x W grad sums per pixel."""
    k, planes, pix = 2 * m, b * w * v, b * v * nx * ny
    dft = planes * (nx * ny * m * 2 + m * k * nx * 4)
    mix = b * v * w * m * k * w * 4
    inv = b * v * nx * w * m * k * 2 + pix * w * m * 2
    pointwise = pix * 3 * w * w
    fwd = dft + mix + inv + pointwise
    return fwd + dft + 2 * mix + inv + pix * 6 * w * w if backward else fwd


def k4_cost(b, w, v, nx, ny, m):
    """(bytes, flops) of one K4 launch: x and the bias branch x3 in, the
    block's output out; 2 flops a multiply-add."""
    act = b * w * v * nx * ny
    return F32 * (2 * act + w * v * nx * ny), 2 * fno_block_macs(b, w, v, nx, ny, m)


def k5_cost(b, w, v, nx, ny, step):
    """(bytes, flops) of one K5 launch: z in, the step frames out; the two
    products of the head (gelu left out)."""
    pix = b * v * nx * ny
    return F32 * pix * (w + step), 2 * pix * W_PROJ * (w + step)


def k6_cost(b, w, v, nx, ny, m):
    """(bytes, flops) of one K6 launch: x, the cotangent g and x3 in, dx
    and dx3 out."""
    act = b * w * v * nx * ny
    return (F32 * (3 * act + 2 * w * v * nx * ny),
            2 * fno_block_macs(b, w, v, nx, ny, m, backward=True))


def k7_cost(b, w, v, nx, ny, step):
    """(bytes, flops) of one K7 launch: z and its cotangent in, dz out."""
    pix = b * v * nx * ny
    return F32 * pix * (2 * w + step), 2 * pix * W_PROJ * (3 * w + 2 * step)


def fno_forward_flops(b, w, v, nx, ny, m, t_in, step):
    """Model flops of one FNO2d forward at batch b: the lift, six blocks and
    the head (gelu left out)."""
    pix = b * v * nx * ny
    lift = 2 * pix * (t_in + 2) * w
    return lift + 6 * k4_cost(b, w, v, nx, ny, m)[1] + k5_cost(b, w, v, nx, ny, step)[1]


def fno_forward_bound_s(b, w, v, nx, ny, m, step):
    """Summed per-launch bounds of one fused forward: six K4 and one K5."""
    return 6 * bound_s(*k4_cost(b, w, v, nx, ny, m)) + bound_s(*k5_cost(b, w, v, nx, ny, step))


def fno_train_step_bound_s(b, w, v, nx, ny, m, step, n_steps):
    """Summed per-launch bounds of one checkpointed train step over
    n_steps rollout steps: each step's forward twice (once more in the
    recompute), six K6 and one K7."""
    fwd = fno_forward_bound_s(b, w, v, nx, ny, m, step)
    bwd = 6 * bound_s(*k6_cost(b, w, v, nx, ny, m)) + bound_s(*k7_cost(b, w, v, nx, ny, step))
    return n_steps * (2 * fwd + bwd)


# flops of the NS momentum residual per interior cell (two components of five
# terms each: 45 adds and multiplies), and the fields it reads (u, v, p)
NS_RES_FLOPS = 45
NS_FIELDS = 3


def k2_ns_cost(b, nt, nx, ny):
    """(bytes, flops) of one NS-momentum K2 launch on [b, 3, nt, nx, ny]:
    the three fields in, the interior residual out."""
    cells = b * (nt - 2) * (nx - 2) * (ny - 2)
    return F32 * (b * NS_FIELDS * nt * nx * ny + cells), NS_RES_FLOPS * cells


# The CUDA kernel functions of each kernel id (cppre_torch/csrc), as the
# profiler names them once the template arguments are stripped. K4 and K6
# share the forward DFT stage.
KERNEL_NAMES = {
    "K1": ("diff_stats_kernel",),
    "K2": ("residual_window_kernel",),
    "K4": ("dft_fwd_kernel", "spectral_mix_kernel", "inverse_x_kernel",
           "block_out_tile_kernel"),
    "K5": ("projection_tile_kernel",),
    "K6": ("dft_fwd_kernel", "spectral_mix_kernel", "spectral_adjoint_kernel",
           "inverse_x_kernel", "idft_dx_tile_kernel", "block_bwd_tile_kernel",
           "reduce_rows_kernel"),
    "K7": ("projection_bwd_tile_kernel", "reduce_rows_kernel"),
    "K8": ("stencil_march_kernel",),
}
ALL_KERNEL_NAMES = frozenset(n for names in KERNEL_NAMES.values() for n in names)


def names_of(*ids):
    return frozenset(n for k in ids for n in KERNEL_NAMES[k])


def base_name(name: str) -> str:
    """A profiler event's kernel name without 'void', namespaces, template
    arguments and parameters."""
    n = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", name)
    return re.split(r"[<(]", n, maxsplit=1)[0] or name[:60]
