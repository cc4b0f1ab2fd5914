"""The traffic's one generator of fields: smooth low-mode fields from a seed, on the device.

A field of shape [B, V, Nx, Ny, Nt] is a sum of `terms` products
sin(2 pi (kx x / L + phase)) cos(2 pi (ky y / L + phase')), kx and ky drawn
from 1..`max_wavenumber`, amplitudes N(0, 1) / (kx + ky), times a factor in t:
1 for a single frame, exp(-decay t) with `decay`, or cos(omega t + phase'')
with omega = 2 pi c |k| / L for `time: "standing"` (then each term solves the
wave equation u_tt = c^2 lap(u) exactly). Then `noise` N(0, 1) is added, or,
with `noise_lo`/`noise_hi`, a per-sample amplitude drawn log-uniformly
between them. Everything is drawn from one `torch.Generator` on the device,
in a few large calls, so a seed gives the same fields on every run.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, what: str) -> int:
    """An independent 63-bit seed for the stream `what` of run seed `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def smooth(gen, shape, spec, device, L=1.0, dt=1.0, c=1.0):
    """Fields [B, V, Nx, Ny, Nt] from `spec` (see the module docstring)."""
    b, v, nx, ny, nt = shape
    k = int(spec.get("terms", 6))
    kmax = int(spec.get("max_wavenumber", 3))
    kw = dict(generator=gen, device=device)
    kx = torch.randint(1, kmax + 1, (b, v, k, 1), **kw).float()
    ky = torch.randint(1, kmax + 1, (b, v, k, 1), **kw).float()
    ph = torch.rand((3, b, v, k, 1), **kw)
    amp = torch.randn((b, v, k, 1), **kw) / (kx + ky)
    xs = torch.arange(nx, device=device, dtype=torch.float32) * (L / nx)
    ys = torch.arange(ny, device=device, dtype=torch.float32) * (L / ny)
    sx = amp * torch.sin(2 * math.pi * (kx * xs / L + ph[0]))         # [b, v, k, nx]
    sy = torch.cos(2 * math.pi * (ky * ys / L + ph[1]))               # [b, v, k, ny]
    ts = torch.arange(nt, device=device, dtype=torch.float32) * dt
    time = spec.get("time")
    if time == "standing":
        omega = 2 * math.pi * c * torch.sqrt(kx ** 2 + ky ** 2) / L
        st = torch.cos(omega * ts + 2 * math.pi * ph[2])
    elif time == "decay":
        st = torch.exp(-float(spec["decay"]) * ts).expand(b, v, k, nt)
    else:
        st = torch.ones((b, v, k, nt), device=device)
    out = torch.einsum("bvkx,bvky,bvkt->bvxyt", sx, sy, st)
    if "noise_lo" in spec:
        lo, hi = math.log(spec["noise_lo"]), math.log(spec["noise_hi"])
        sigma = torch.exp(lo + (hi - lo) * torch.rand((b, 1, 1, 1, 1), **kw))
        out += sigma * torch.randn(shape, **kw)
    elif spec.get("noise", 0.0):
        out += float(spec["noise"]) * torch.randn(shape, **kw)
    return out.contiguous()


def weights(seed: int, specs, device, symmetric: bool = False):
    """The model's weights from `seed`: one uniform draw on the device for
    all of them, cut and scaled per tensor by its init ('sym': U(-b, b);
    'cplx': real and imaginary parts U[0, s)); with `symmetric`, the
    spectral weights' parts from U(-s, s)."""
    sizes = [math.prod(shape) * (2 if kind == "cplx" else 1) for _, shape, (kind, _) in specs]
    flat = torch.rand(sum(sizes), generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for (name, shape, (kind, scale)), n in zip(specs, sizes):
        u = flat[at:at + n]
        at += n
        if kind == "cplx":
            if symmetric:
                u = 2 * u - 1
            out[name] = torch.view_as_complex((scale * u).reshape(shape + (2,)).contiguous())
        else:
            out[name] = (scale * (2 * u - 1)).reshape(shape)
    return out
