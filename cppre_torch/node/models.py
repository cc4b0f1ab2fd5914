"""Neural-ODE model, integrator and training (port of `cppre.node.models`).

`ODEFunc` is the reference's state -> 50 -> 50 -> state tanh MLP (with
`time_dependent`, the input is [y, t]). `neural_odeint` integrates it with
adaptive Dormand-Prince 5(4), step for step the algorithm of
`jax.experimental.ode.odeint`, which `cppre` calls:
- the initial step from Hairer, Norsett and Wanner (Solving ODEs I, II.4),
  with order 4 as there;
- the 7-stage tableau with first-same-as-last: a step's last stage is the
  next step's first;
- the RMS error ratio over atol + rtol max(|y0|, |y1|); a step is accepted
  where it is <= 1, and either way the next step size is
  dt min(10, max(0.9 ratio^(-1/5), 1 if accepted else 0.2)), dt * 10 at a
  zero ratio;
- dense output: each requested time takes the 4th-order polynomial fitted
  to the accepted step that first reaches it (Horner), never a step to it.

A batch of initial states integrates as one: each sample keeps its own t,
step size and accept/reject decision, its updates masked, until every
sample has passed every output time. So each sample takes the steps it
would take alone, as `cppre`'s per-sample loop does; a shared step size
would not.

Gradients flow through the accepted steps by autograd; the step-size
controller (error ratios, step sizes, accept decisions, times) runs on
detached values, so no step size is differentiated. `cppre`
differentiates `odeint` by its adjoint ODE instead, so the two gradients
differ at the solver's tolerance.

`fit_node` trains on the full-trajectory MSE with Adam at lr 1e-2,
integrating at `jax.experimental.ode.odeint`'s default tolerances, rtol =
atol = 1.4e-8, which `cppre`'s `fit_node` uses: below float32's epsilon,
so it costs many more steps than `neural_odeint`'s 1e-6 / 1e-7.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ODEFunc", "neural_odeint", "fit_node", "odeint"]

# jax.experimental.ode.odeint's defaults, which cppre's fit_node uses
FIT_RTOL = FIT_ATOL = 1.4e-8

# Dormand-Prince 5(4): stage times, stage weights, the 5th-order solution,
# its error against the 4th-order one, and the midpoint of the dense output
_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_BETA = ((1 / 5,),
         (3 / 40, 9 / 40),
         (44 / 45, -56 / 15, 32 / 9),
         (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
         (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
         (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
_C_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_C_ERR = (35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
          -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1. / 60.)
_C_MID = (6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
          -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
          -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _f32(c):
    """A coefficient rounded to float32, as the tableau's float32 arrays
    hold it."""
    return float(torch.tensor(c, dtype=torch.float32))


_ALPHA, _C_SOL, _C_ERR, _C_MID = (tuple(_f32(c) for c in v)
                                  for v in (_ALPHA, _C_SOL, _C_ERR, _C_MID))
_BETA = tuple(tuple(_f32(c) for c in row) for row in _BETA)


def _lecun_normal_(w, generator):
    """flax's default Dense init: a normal truncated at +-2 standard
    deviations, scaled to variance 1 / fan_in (w is [out, in])."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    with torch.no_grad():
        u = torch.rand(w.shape, generator=generator) * (hi - lo) + lo
        w.copy_(torch.erfinv(2 * u - 1) * math.sqrt(2) * std)


class ODEFunc(nn.Module):
    """dy/dt = MLP(y), or MLP([y, t]) with `time_dependent` (the
    non-autonomous form the Bessel and Cauchy-Euler problems need): Linear
    -> tanh -> Linear -> tanh -> Linear. `forward(t, y)` takes y [..., state]
    and t a scalar or [...]. Weights are drawn from `generator` (a CPU
    `torch.Generator`) with flax's init, then moved to `device`.

    With `batch_invariant` (the default) each layer is a broadcast product
    summed over its inputs, so a sample's field, and with it every step
    decision, is the same in a batch as alone: a matrix product's blocking
    (and a batch of one's matrix-vector route) depends on the batch.
    `fit_node` switches it off while it trains on its one trajectory,
    where a matrix product is a third of the launches."""

    batch_invariant = True

    def __init__(self, hidden_dim: int = 50, state_dim: int = 2, time_dependent: bool = False,
                 *, device="cuda", generator=None):
        super().__init__()
        self.hidden_dim, self.state_dim = hidden_dim, state_dim
        self.time_dependent = time_dependent
        n_in = state_dim + (1 if time_dependent else 0)
        self.dense0 = nn.Linear(n_in, hidden_dim)
        self.dense1 = nn.Linear(hidden_dim, hidden_dim)
        self.dense2 = nn.Linear(hidden_dim, state_dim)
        self.reset_parameters(generator)
        self.to(device)

    def layers(self):
        return self.dense0, self.dense1, self.dense2

    def reset_parameters(self, generator=None):
        """flax's init: lecun-normal weights, zero biases."""
        for layer in self.layers():
            _lecun_normal_(layer.weight, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, t, y):
        if self.time_dependent:
            t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
            y = torch.cat((y, t.expand(y.shape[:-1])[..., None]), dim=-1)
        dense = _dense if self.batch_invariant else F.linear
        h = torch.tanh(dense(y, self.dense0.weight, self.dense0.bias))
        h = torch.tanh(dense(h, self.dense1.weight, self.dense1.bias))
        return dense(h, self.dense2.weight, self.dense2.bias)


def _dense(x, weight, bias):
    """x @ W^T + b with every output's sum in the same order whatever the
    batch."""
    return torch.sum(x[..., None, :] * weight, dim=-1) + bias


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


@torch.no_grad()
def _initial_step_size(func, t0, y0, f0, rtol, atol, order=4):
    """Hairer's starting step, per sample ([B] from y0 [B, S])."""
    scale = atol + torch.abs(y0) * rtol
    d0, d1 = _norm(y0 / scale), _norm(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    f1 = func(y0 + h0[:, None] * f0, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    tiny = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1 = torch.where(tiny, torch.clamp(h0 * 1e-3, min=1e-6),
                     torch.exp(torch.log(0.01 / torch.maximum(d1, d2)) * (1. / (order + 1.))))
    return torch.minimum(100. * h0, h1)


@functools.lru_cache(maxsize=16)
def _tableau(device):
    """The tableau's rows as float32 tensors on `device`: (beta rows,
    c_sol, c_err, c_mid), each summed against the stages as a broadcast
    product, in the same order for every sample (see `_dense`)."""
    f32 = lambda row: torch.tensor(row, dtype=torch.float32, device=device)
    return (tuple(f32(r) for r in _BETA), f32(_C_SOL), f32(_C_ERR), f32(_C_MID),
            f32(_ALPHA))


def _runge_kutta_step(func, y0, f0, t0, dt):
    """One Dormand-Prince step for every sample: (y1, f1, y1_error, k),
    k [B, S, 7] the stages."""
    beta, c_sol, c_err, _, alpha = _tableau(y0.device)
    k = [f0]
    h = dt[:, None]
    ti = torch.addcmul(t0[:, None], h, alpha)                           # [B, 6]
    for i in range(6):
        yi = torch.addcmul(y0, h, torch.sum(torch.stack(k, dim=-1) * beta[i], dim=-1))
        k.append(func(yi, ti[:, i]))
    k = torch.stack(k, dim=-1)
    return (torch.addcmul(y0, h, torch.sum(k * c_sol, dim=-1)), k[..., -1],
            h * torch.sum(k * c_err, dim=-1), k)


def _interp_fit(y0, y1, k, dt):
    """The dense output's 4th-order polynomial over steps, coefficients
    (a, b, c, d, e) highest power first: y0, y1 [..., S], the stages k
    [..., S, 7], dt [...]."""
    h = dt[..., None]
    y_mid = torch.addcmul(y0, h, torch.sum(k * _tableau(y0.device)[3], dim=-1))
    dy0, dy1 = k[..., 0], k[..., -1]
    a = -2. * h * dy0 + 2. * h * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid
    b = 5. * h * dy0 - 3. * h * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid
    c = -4. * h * dy0 + h * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid
    d = h * dy0
    return a, b, c, d, y0


def _polyval(coeffs, s):
    """Horner over (a, b, c, d, e) [..., S] at s [...] -> [..., S]."""
    s = s[..., None]
    out = coeffs[0]
    for c in coeffs[1:]:
        out = out * s + c
    return out


def _mean_error_ratio(err, rtol, atol, y0, y1):
    tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = err / tol
    return torch.sqrt(torch.mean(r * r, dim=-1))


def _optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0, dfactor=0.2, order=5.0):
    dfactor = torch.where(ratio < 1, 1.0, dfactor)
    # ratio^(-1/order) as exp(log(.)), here and in `_initial_step_size`: the
    # CPU's vectorised and scalar pow differ in the last bit, which would
    # tie a sample's steps to the size of its batch
    power = torch.exp(torch.log(ratio) * (-1.0 / order))
    factor = torch.clamp(torch.maximum(power * safety, dfactor), max=ifactor)
    return torch.where(ratio == 0, last_step * ifactor, last_step * factor)


def odeint(func, y0, t, rtol: float = FIT_RTOL, atol: float = FIT_ATOL, max_steps: int = 100_000,
           return_stats: bool = False, fixed_steps: int | None = None):
    """Integrate dy/dt = func(y, t) from y0 [B, S] at t[0] to every time in
    t [T] (strictly increasing, float32): returns [B, T, S], and with
    `return_stats` also {"accepted": [B], "rejected": [B], "unfinished": [B]}:
    step counts, and the samples still short of the last time. `func` takes
    y [B, S] and the samples' times [B]. Raises RuntimeError past
    `max_steps` steps (the JAX integrator has no limit). With `fixed_steps`
    the loop runs exactly that many steps and never reads the device, so a
    CUDA graph can hold it: a sample that needs more comes back
    "unfinished", its later outputs those of its last accepted step.

    Each sample carries the JAX loop's state (y, f, t, dt). It steps while
    an output time is left that it has not reached and its dt is positive;
    an output time takes the polynomial of the accepted step that reached
    it (all that are left, once dt is no longer positive, the last accepted
    one). The loop records every step; the polynomials are fitted and
    evaluated once, after it."""
    B = y0.shape[0]
    ts = torch.as_tensor(t, dtype=torch.float32).to(y0.device)
    if ts.shape[0] == 1:
        stats = {"accepted": 0, "rejected": 0, "unfinished": torch.zeros_like(y0[:, 0], dtype=bool)}
        return (y0[:, None], stats) if return_stats else y0[:, None]
    t_cur = ts[0].expand(B).clone()
    f = func(y0, t_cur)
    dt = _initial_step_size(func, t_cur, y0.detach(), f.detach(), rtol, atol)
    y, steps, t_seen = y0, [], [t_cur]
    active = torch.ones(B, dtype=torch.bool, device=y0.device)
    accepted = torch.zeros(B, dtype=torch.long, device=y0.device)
    rejected = torch.zeros_like(accepted)
    for n_step in range(max_steps + 1 if fixed_steps is None else fixed_steps):
        # one host sync every 4 steps; a step of a finished sample is masked
        if fixed_steps is None and n_step % 4 == 0 and not bool(active.any()):
            break
        if n_step == max_steps:
            raise RuntimeError(f"odeint: more than {max_steps} steps")
        y1, f1, y1_err, k = _runge_kutta_step(func, y, f, t_cur, dt)
        steps.append((y, y1, k, dt))
        with torch.no_grad():
            ratio = _mean_error_ratio(y1_err, rtol, atol, y, y1)
            accept = active & (ratio <= 1.)
            t_cur = torch.where(accept, t_cur + dt, t_cur)
            dt = torch.where(active, torch.clamp(_optimal_step_size(dt, ratio), min=0.), dt)
            accepted += accept
            rejected += active & ~accept
            # done past the last output time, or once dt is no longer
            # positive (the JAX loop's exit)
            active = (t_cur < ts[-1]) & (dt > 0)
            t_seen.append(t_cur)
        keep = accept[:, None]
        y, f = torch.where(keep, y1, y), torch.where(keep, f1, f)

    # the dense output of every step at once. An output time takes the
    # first step after which the sample's t has reached it (t moves only on
    # an accepted step), else, once the sample stopped, its last accepted
    # step; entry 0 of the coefficients stands for "none yet": y0. Each
    # step's polynomial is evaluated at every output time and the picked
    # one kept by a masked sum over the steps, which also differentiates
    # in a fixed order (a gather's backward adds with atomics on the card,
    # so the fit's rounding, and a chaotic fit's outcome, varied run to run).
    with torch.no_grad():
        seen = torch.stack(t_seen, dim=1)                              # [B, n + 1]
        last = torch.searchsorted(seen, seen[:, -1:].contiguous())     # [B, 1]
        at = torch.minimum(torch.searchsorted(seen, ts[1:].expand(B, -1).contiguous()), last)
        lo = torch.gather(seen, 1, torch.clamp(at - 1, min=0))
        rel = (ts[None, 1:] - lo) / (torch.gather(seen, 1, at) - lo)
        pick = torch.arange(len(steps) + 1, device=y0.device)[:, None, None] == at  # [n+1, B, T-1]
        rel = torch.where(pick, rel, 0.)
    fitted = _interp_fit(*(torch.stack(v) for v in zip(*steps)))
    ys = _polyval([torch.cat((y0[None], c))[:, :, None] for c in fitted], rel)
    ys = torch.sum(torch.where(pick[..., None], ys, 0.), dim=0)
    out = torch.cat((y0[:, None], ys), dim=1)
    if return_stats:
        return out, {"accepted": accepted, "rejected": rejected, "unfinished": active}
    return out


def neural_odeint(model: ODEFunc, y0, t, rtol: float = 1e-6, atol: float = 1e-7,
                  return_stats: bool = False):
    """Integrate the NODE from y0 over the times t: y0 [state] ->
    [len(t), state], or a family y0 [B, state] -> [B, len(t), state], each
    sample with its own steps (`odeint`). Runs on the model's device."""
    dev = next(model.parameters()).device
    y0 = torch.as_tensor(y0, dtype=torch.float32).to(dev)
    single = y0.ndim == 1
    ys = odeint(lambda y, tt: model(tt, y), y0[None] if single else y0, t, rtol=rtol,
                atol=atol, return_stats=return_stats)
    if return_stats:
        ys, stats = ys
        return (ys[0] if single else ys), stats
    return ys[0] if single else ys


def _fit_loss(model, y0, ts, target, fixed_steps=None):
    """The fit's full-trajectory MSE, backpropagated into the model's .grad:
    (the loss, the steps the trajectory took, whether it fell short)."""
    traj, stats = odeint(lambda y, tt: model(tt, y), y0[None], ts, rtol=FIT_RTOL, atol=FIT_ATOL,
                         return_stats=True, fixed_steps=fixed_steps)
    loss = torch.mean((traj[0] - target) ** 2)
    loss.backward()
    return loss.detach(), stats["accepted"] + stats["rejected"], stats["unfinished"]


class _GraphedFitLoss:
    """`_fit_loss` on the card as a CUDA graph of a fixed number of steps.

    An eager loop launches ~300 kernels a step from the host, ~3.3 ms; a
    replay of the same kernels takes ~0.39 ms a step (NVIDIA H100 80GB
    HBM3, 700 W; PERF.md). The first call runs eagerly on a side
    stream (warming cuBLAS and the tableau up) and counts the steps; the
    graph then holds that many and a quarter more, the steps past the end
    masked, so a replay gives the eager values. Training changes the
    count: a replay that falls short is captured again with half as many
    steps more and replayed; one that used less than half its steps is
    captured anew, smaller, at the next call. One host read a call. The
    gradients land in the .grad tensors the graph owns: do not set them to
    None between calls."""

    def __init__(self, model, y0, ts, target):
        self.args = (model, y0, ts, target)
        self.graph, self.n_steps = None, 0

    def _capture(self, n_steps):
        for p in self.args[0].parameters():
            p.grad = None
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _fit_loss(*self.args, fixed_steps=n_steps)
        self.n_steps = n_steps

    def __call__(self):
        if self.graph is None and self.n_steps == 0:
            for p in self.args[0].parameters():
                p.grad = None
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                loss, steps, _ = _fit_loss(*self.args)
            torch.cuda.current_stream().wait_stream(side)
            self.n_steps = int(steps) * 5 // 4 + 8
            return loss
        if self.graph is None:
            self._capture(self.n_steps)
        self.graph.replay()
        steps, short = torch.stack((self.out[1][0], self.out[2][0].long())).tolist()
        while short:
            self._capture(self.n_steps * 3 // 2)
            self.graph.replay()
            steps, short = torch.stack((self.out[1][0], self.out[2][0].long())).tolist()
        loss = self.out[0].clone()
        if 2 * steps < self.n_steps:
            self.graph, self.n_steps = None, steps * 5 // 4 + 8
        return loss


def fit_node(model: ODEFunc, y0, t, target, *, epochs: int = 300, lr: float = 1e-2,
             seed: int = 0, verbose: bool = False):
    """Train the NODE in place on a target trajectory [len(t), state] by
    full-trajectory MSE: weights drawn anew from
    `torch.Generator().manual_seed(seed)`, then Adam at `lr`, one step an
    epoch, integrating at rtol = atol = 1.4e-8 (`FIT_RTOL`, `FIT_ATOL`). On
    the card an epoch's loss and gradient replay a CUDA graph
    (`_GraphedFitLoss`). Returns (model.state_dict(), per-epoch losses)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    dev = next(model.parameters()).device
    y0 = torch.as_tensor(y0, dtype=torch.float32).to(dev)
    ts = torch.as_tensor(t, dtype=torch.float32).to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    graphed = _GraphedFitLoss(model, y0, ts, target) if dev.type == "cuda" else None
    losses = []
    invariant, model.batch_invariant = model.batch_invariant, False   # one trajectory
    try:
        for ep in range(epochs):
            if graphed is None:
                opt.zero_grad(set_to_none=True)
                loss = _fit_loss(model, y0, ts, target)[0]
            else:
                loss = graphed()
            opt.step()
            losses.append(loss)
            if verbose and ep % 50 == 0:
                print(f"NODE epoch {ep}: loss {float(loss):.3e}")
    finally:
        model.batch_invariant = invariant
    return model.state_dict(), [float(v) for v in losses]
