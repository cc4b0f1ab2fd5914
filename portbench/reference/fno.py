"""Plain FNO2d (`FNO_multi2d` of the CP-PRE reference code), float32, functional.

The forward of the published model, written from its description: lift
Linear(T_in + 2 -> W) over the input frames and the (x, y) grid, six
Fourier blocks gelu(mlp(spectral(z)) + w(z) + b(grid)) with skip adds after
blocks 2 and 5, then Linear(W -> 256), gelu, Linear(256 -> step). The
spectral convolution is rfft2, a per-mode complex channel mix on the low
and high kx corners of the kept modes, and irfft2. Parameters are a dict
keyed by the reference state_dict's names, so one set of tensors loads
into the program's module and serves here.

`lowp=True` computes every matrix product with its operands rounded to
TF32 (10 mantissa bits, float32 accumulation): the control of the
benchmark's comparisons, whose residuals take their fields rounded so too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import tf32

HEAD = 256


def param_specs(cfg):
    """[(name, shape, init)] of FNO2d at `cfg`: init ('sym', bound) draws
    U(-bound, bound) (the linear layers and 1x1 maps, bound 1/sqrt(fan_in));
    ('cplx', scale) draws real and imaginary parts from U[0, scale) (the
    spectral weights, scale 1/W)."""
    w, v, m = cfg["Width_time"], cfg["Variables"], cfg["Modes"]
    t_in, step = cfg["T_in"], cfg["Step"]
    specs = [("fc0_time.weight", (w, t_in + 2), ("sym", 1 / math.sqrt(t_in + 2))),
             ("fc0_time.bias", (w,), ("sym", 1 / math.sqrt(t_in + 2)))]
    for i in range(6):
        p = f"f{i}."
        specs += [(p + "conv.weights1", (w, w, v, m, m), ("cplx", 1 / w)),
                  (p + "conv.weights2", (w, w, v, m, m), ("cplx", 1 / w))]
        for name, fan_in in (("mlp.mlp1", w), ("mlp.mlp2", w), ("w", w), ("b", 2)):
            specs += [(p + name + ".weight", (w, fan_in, 1, 1, 1), ("sym", 1 / math.sqrt(fan_in))),
                      (p + name + ".bias", (w,), ("sym", 1 / math.sqrt(fan_in)))]
    specs += [("fc1_time.weight", (HEAD, w), ("sym", 1 / math.sqrt(w))),
              ("fc1_time.bias", (HEAD,), ("sym", 1 / math.sqrt(w))),
              ("fc2_time.weight", (step, HEAD), ("sym", 1 / math.sqrt(HEAD))),
              ("fc2_time.bias", (step,), ("sym", 1 / math.sqrt(HEAD)))]
    return specs


def _lin(x, weight, bias, lowp):
    """x @ weight.T + bias over the last axis."""
    return torch.matmul(tf32(x, lowp), tf32(weight, lowp).T) + bias


def _chan(x, weight, bias, lowp):
    """A 1x1 channel map on [B, C, V, Nx, Ny]."""
    w = weight.reshape(weight.shape[0], weight.shape[1])
    y = torch.einsum("bivxy,oi->bovxy", tf32(x, lowp), tf32(w, lowp))
    return y + bias[None, :, None, None, None]


def _mix(xr, xi, wc, lowp):
    """Complex channel mix sum_i x[b,i,v,kx,ky] w[i,o,v,kx,ky] as real products."""
    wr, wi = tf32(wc.real, lowp), tf32(wc.imag, lowp)
    xr, xi = tf32(xr, lowp), tf32(xi, lowp)
    eq = "bivxy,iovxy->bovxy"
    return (torch.einsum(eq, xr, wr) - torch.einsum(eq, xi, wi),
            torch.einsum(eq, xr, wi) + torch.einsum(eq, xi, wr))


def spectral(z, w1, w2, m, lowp):
    nx, ny = z.shape[-2], z.shape[-1]
    zf = torch.fft.rfft2(z, dim=(-2, -1))
    out_r = z.new_zeros(z.shape[:-2] + (nx, ny // 2 + 1))
    out_i = torch.zeros_like(out_r)
    lo = _mix(zf.real[..., :m, :m], zf.imag[..., :m, :m], w1, lowp)
    hi = _mix(zf.real[..., nx - m:, :m], zf.imag[..., nx - m:, :m], w2, lowp)
    out_r[..., :m, :m], out_i[..., :m, :m] = lo
    out_r[..., nx - m:, :m], out_i[..., nx - m:, :m] = hi
    return torch.fft.irfft2(torch.complex(out_r, out_i), s=(nx, ny), dim=(-2, -1))


def grid(b, v, nx, ny, device):
    """[b, v, nx, ny, 2]: x and y on [0, 1]."""
    gx = torch.linspace(0, 1, nx, device=device).reshape(1, 1, nx, 1, 1).expand(b, v, nx, ny, 1)
    gy = torch.linspace(0, 1, ny, device=device).reshape(1, 1, 1, ny, 1).expand(b, v, nx, ny, 1)
    return torch.cat((gx, gy), dim=-1)


def forward(p, x, cfg, lowp=False):
    """[B, V, Nx, Ny, T_in] -> [B, V, Nx, Ny, step]."""
    b, v, nx, ny, _ = x.shape
    m = cfg["Modes"]
    g = grid(b, v, nx, ny, x.device)
    h = _lin(torch.cat((x, g), dim=-1), p["fc0_time.weight"], p["fc0_time.bias"], lowp)
    h = h.permute(0, 4, 1, 2, 3)                                    # [B, W, V, Nx, Ny]
    gc = g.permute(0, 4, 1, 2, 3)

    def block(i, z):
        q = f"f{i}."
        s = spectral(z, p[q + "conv.weights1"], p[q + "conv.weights2"], m, lowp)
        s = _chan(F.gelu(_chan(s, p[q + "mlp.mlp1.weight"], p[q + "mlp.mlp1.bias"], lowp)),
                  p[q + "mlp.mlp2.weight"], p[q + "mlp.mlp2.bias"], lowp)
        return F.gelu(s + _chan(z, p[q + "w.weight"], p[q + "w.bias"], lowp)
                      + _chan(gc, p[q + "b.weight"], p[q + "b.bias"], lowp))

    x0 = block(0, h)
    z = block(2, block(1, x0)) + x0
    x1 = block(3, z)
    z = block(5, block(4, x1)) + x1
    z = z.permute(0, 2, 3, 4, 1)                                    # [B, V, Nx, Ny, W]
    z = F.gelu(_lin(z, p["fc1_time.weight"], p["fc1_time.bias"], lowp))
    return _lin(z, p["fc2_time.weight"], p["fc2_time.bias"], lowp)


def rollout(p, a, cfg, lowp=False):
    """Autoregressive rollout of the initial window a [B, V, Nx, Ny, T_in]
    to T_out frames, `step` at a time."""
    step, preds, xx = cfg["Step"], [], a
    for _ in range(cfg["T_out"] // step):
        im = forward(p, xx, cfg, lowp)
        preds.append(im)
        xx = torch.cat((xx[..., step:], im), dim=-1)
    return torch.cat(preds, dim=-1)


class MinMax:
    """The published min-max normaliser: the global [min, max] of x onto [0, 1]."""

    def __init__(self, x):
        mn, mx = torch.amin(x), torch.amax(x)
        self.a = 1.0 / (mx - mn)
        self.b = -self.a * mx + 1.0

    def encode(self, x):
        return self.a * x + self.b

    def decode(self, y):
        return (y - self.b) / self.a


def to_convops(field):
    """[B, V, Nx, Ny, Nt] -> [B, V, Nt, Nx, Ny]."""
    return field.permute(0, 1, 4, 2, 3).contiguous()
