"""PRE set propagation: residual bounds -> solution-space intervals (port
of `cppre.sets.pre_set_prop`).

For the SHO, the composite kernel m*[1,-2,1] + dt^2*k*[0,1,0] applied by
circular FFT convolution to the zero-padded neural solution gives the
residual. Per-cell intervals [-|res|, +|res|] (the wrap-around edge cells,
the first 4 and the last, kept exact) propagate through the interval FFT,
multiply by the regularised inverse kernel 1/(K_hat + eps) and come back
through the inverse interval FFT as bounds on the solution.

The cells stay in natural order, all N of them, as in `cppre`: the
reference drops index 0 and reorders the cells, which breaks the N-point
deconvolution (its bounds no longer contain the input trajectory). With
every cell in place containment is exact: |Re(M (res - centres))| <=
sum_j |Re(M_kj)| r_j cell-wise for the linear deconvolution map M.
"""

from __future__ import annotations

import numpy as np
import torch

from .interval_fft import propagate_through_deconvolution

__all__ = ["set_PRE", "set_pre_batched"]


def _sho_kernel(m, k, dt):
    D_tt = np.array([1.0, -2.0, 1.0])
    D_id = np.array([0.0, 1.0, 0.0])
    return m * D_tt + dt**2 * k * D_id


def set_PRE(neural_sol, m: float = 1.0, k: float = 1.0, dt: float = 0.1010101,
            eps: float = 1e-16, device="cuda"):
    """neural_sol: [Nt] or [Nt, 1] trajectory. Returns a list of (lower,
    upper) intervals, Nt + 2 of them (the zero-padded extent). The
    intervals are built in float64 numpy and propagated in float32 on
    `device`, as `cppre` casts them."""
    x = np.asarray(neural_sol, dtype=np.float64).reshape(-1)
    kernel = _sho_kernel(m, k, dt)

    signal = np.concatenate(([0.0], x, [0.0]))
    N = len(signal)
    kernel_pad = np.concatenate((kernel, np.zeros(N - len(kernel))))

    signal_fft = np.fft.fft(signal)
    kernel_fft = np.fft.fft(kernel_pad)
    convolved = np.fft.ifft(signal_fft * kernel_fft)
    inverse_kernel = 1.0 / (kernel_fft + eps)

    # the wrap-around edge cells (the first 4 and the last, which mix the
    # zero padding) stay exact; interior cells get [-|res|, +|res|]
    centers = np.where(np.abs(np.arange(N) - 0) <= 3, convolved.real, 0.0)
    centers[-1] = convolved[-1].real
    radii = np.where((np.arange(N) > 3) & (np.arange(N) < N - 1),
                     np.abs(convolved.real), 0.0)

    out_c, out_r = propagate_through_deconvolution(centers, radii, inverse_kernel,
                                                   device=device)
    out_c, out_r = out_c.cpu().numpy(), out_r.cpu().numpy()
    return list(zip(out_c - out_r, out_c + out_r))


def set_pre_batched(neural_sols, m: float = 1.0, k: float = 1.0,
                    dt: float = 0.1010101, eps: float = 1e-16, device="cuda"):
    """`set_PRE` for a whole prediction set at once, in float32 on `device`.

    neural_sols: [B, Nt] (or [Nt]) trajectories, numpy or a tensor.
    Returns (lower, upper), each a [B, N] tensor with N = Nt + 2 (the
    zero-padded extent; the cells of `set_PRE`, in natural order). The
    kernel's FFT is a host constant; the SHO kernel's FFT is bounded away
    from 0, so `eps` acts alike in float32.
    """
    x = torch.as_tensor(neural_sols).to(device=device, dtype=torch.float32)
    x = torch.atleast_2d(x)
    nt = x.shape[-1]
    N = nt + 2
    kernel = _sho_kernel(m, k, dt)
    kernel_pad = np.concatenate((kernel, np.zeros(N - len(kernel))))
    kernel_fft = np.fft.fft(kernel_pad)                              # host constant
    inverse_kernel = 1.0 / (kernel_fft + eps)

    signal = torch.nn.functional.pad(x, (1, 1))                       # [B, N]
    K_hat = torch.as_tensor(kernel_fft).to(device=x.device, dtype=torch.complex64)
    convolved = torch.real(torch.fft.ifft(torch.fft.fft(signal, dim=-1) * K_hat, dim=-1))

    # set_PRE's cell policy: the wrap-around edge cells (the first 4, the
    # last) exact, the interior symmetric [-|res|, +|res|]
    idx = torch.arange(N, device=x.device)
    edge = (idx <= 3) | (idx == N - 1)
    centers = torch.where(edge, convolved, torch.zeros((), device=x.device))
    radii = torch.where(edge, torch.zeros((), device=x.device), torch.abs(convolved))

    out_c, out_r = propagate_through_deconvolution(centers, radii, inverse_kernel)
    return out_c - out_r, out_c + out_r
