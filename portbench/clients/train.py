"""Training steps: `make_train_step` over `make_fused_train_apply`, back to back.

Set-up draws the configuration's `pool_key` training pairs (an initial
frame and the `T_out` frames after it) from the seed, min-max encodes them
as `run_2d_cp` does, builds the model, the optimizer and the step, and
drives that one step object through its first `check_steps` steps: those
are the steps the reference follows, and the window goes on with the same
object. Batches of the configuration's `batch_key` size follow a seeded
permutation per epoch, so the checked steps take rows that all differ.
Each step ends in a synchronize, as `fit`'s epoch loop reads each step's
loss on the host.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import fields
from portbench import yardstick as Y
from portbench.clients import surrogate
from portbench.reference import fno as ref_fno
from portbench.reference import train as ref_train


def _sizes(cell):
    c, t = cell.config, cell.traffic
    return int(c[t["batch_key"]]), int(c[t["pool_key"]])


def pool(cell, seed, device):
    """Raw training trajectories [n, V, Nx, Ny, T_in + T_out] of the seed."""
    c, r = cell.config, cell.config["residual"]
    _, n = _sizes(cell)
    return fields.smooth(fields.generator(seed, "train", device),
                         (n, c["Variables"], c["Nx"], c["Ny"], c["T_in"] + c["T_out"]),
                         cell.traffic["data"], device, L=c["Nx"] * r["dx"], dt=r["dt"],
                         c=r.get("c", 1.0))


def batch_rows(cell, seed, i):
    """The rows of step i: epoch i // steps_per_epoch's seeded permutation."""
    b, n = _sizes(cell)
    spe = n // b
    g = torch.Generator().manual_seed(fields.sub_seed(seed, f"epoch{i // spe}"))
    return torch.randperm(n, generator=g)[(i % spe) * b:(i % spe + 1) * b]


def _norm(t):
    return float(torch.linalg.vector_norm(torch.view_as_real(t) if t.is_complex() else t))


def setup(cell, seed, device):
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss
    from cppre_torch.train.normalizers import MinMaxNormalizer

    c = cell.config
    b, n = _sizes(cell)
    w = surrogate.weights(cell, seed, device, served=False)
    model = surrogate.port_model(cell, w, device).train()
    traj = pool(cell, seed, device)
    a_raw, u_raw = traj[..., :c["T_in"]], traj[..., c["T_in"]:]
    a = MinMaxNormalizer(a_raw).encode(a_raw)
    u = MinMaxNormalizer(u_raw).encode(u_raw)
    opt = make_optimizer(model.parameters(), c["Learning Rate"], c["Scheduler Step"],
                         c["Scheduler Gamma"], n // b, c["grad_clip"])
    step = make_train_step(make_fused_train_apply(model), opt, c["Step"], c["T_out"], lp_loss)
    state = {"step": step, "a": a, "u": u, "seed": seed, "cell": cell, "device": device,
             "at": 0}
    names = [k for k, _ in model.named_parameters()]
    losses, grads = [], None
    for i in range(int(cell.traffic["check_steps"])):
        losses.append(_step(state)[0])
        if i == 0:                       # the clipped gradient, from Adam's first moment
            beta1 = opt.adam.param_groups[0]["betas"][0]
            moments = [opt.adam.state[p].get("exp_avg") for p in opt.params]
            grads = {k: 0.0 if m is None else _norm(m) / (1 - beta1)
                     for k, m in zip(names, moments)}
    change = {k: _norm(p.detach() - w[k]) for k, p in zip(names, opt.params)}
    state["answers"] = {"losses": [float(x) for x in losses], "grads": grads,
                        "change": change}
    return state


def _step(state):
    i = state["at"]
    idx = batch_rows(state["cell"], state["seed"], i).to(state["device"])
    t0 = time.perf_counter()
    loss, _ = state["step"](state["a"][idx], state["u"][idx])
    enqueue = time.perf_counter() - t0
    if state["device"].type == "cuda":
        torch.cuda.synchronize(state["device"])
    state["at"] = i + 1
    return loss, enqueue


def item(state, i):
    _, enqueue = _step(state)
    return {"samples": _sizes(state["cell"])[0], "enqueue_s": enqueue}


def work(cell):
    c = cell.config
    b, _ = _sizes(cell)
    n = c["T_out"] // c["Step"]
    shape = (b, c["Width_time"], c["Variables"], c["Nx"], c["Ny"], c["Modes"])
    return {"samples": b,
            "fno_train_bound_s": Y.fno_train_step_bound_s(*shape, c["Step"], n),
            "model_flops": 3 * n * Y.fno_forward_flops(*shape, c["T_in"], c["Step"]),
            "launches": {"K4": 12 * n, "K5": 2 * n, "K6": 6 * n, "K7": n}}


def answers(state, kept):
    return state["answers"]


def reference_steps(cell, seed, device, lowp=False):
    """The reference's first `check_steps` steps from the same weights, data
    and rows: their losses, the first clipped gradient's norm per leaf and
    each leaf's change after the last."""
    c = cell.config
    w0 = surrogate.weights(cell, seed, device, served=False)
    p = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    traj = pool(cell, seed, device)
    a_raw, u_raw = traj[..., :c["T_in"]], traj[..., c["T_in"]:]
    a, u = ref_fno.MinMax(a_raw).encode(a_raw), ref_fno.MinMax(u_raw).encode(u_raw)
    del traj
    opt = ref_train.Adam(p, c["Learning Rate"], c["grad_clip"])
    losses, grads = [], None
    for i in range(int(cell.traffic["check_steps"])):
        idx = batch_rows(cell, seed, i).to(device)
        loss = ref_train.rollout_loss(p, a[idx], u[idx], c, lowp)
        g = torch.autograd.grad(loss, list(p.values()))
        clipped = opt.step(dict(zip(p, g)))
        losses.append(float(loss.detach()))
        if i == 0:
            grads = {k: float(torch.linalg.vector_norm(v)) for k, v in clipped.items()}
    change = {k: _norm(p[k].detach() - w0[k]) for k in p}
    return {"losses": losses, "grads": grads, "change": change}


def _worst(gaps):
    """The largest gap; inf where any is not finite."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _leaf_gap(got, ref, leaves):
    """max over `leaves` of |got - ref| / max(ref, the median leaf's ref)."""
    med = statistics.median(ref[k] for k in leaves)
    return _worst(abs(got[k] - ref[k]) / max(ref[k], med) for k in leaves)


def check(cell, seed, ans, device):
    ref = reference_steps(cell, seed, device)
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out of the change
    med = statistics.median(ref["grads"].values())
    moving = [k for k, v in ref["grads"].items() if v >= 1e-3 * med]
    return {"loss": _worst(abs(x - y) / abs(y) for x, y in zip(ans["losses"], ref["losses"])),
            "grad": _leaf_gap(ans["grads"], ref["grads"], list(ref["grads"])),
            "change": _leaf_gap(ans["change"], ref["change"], moving)}


def control(cell, seed, device):
    """The reference at TF32 in the program's place: answers for `check`."""
    return reference_steps(cell, seed, device, lowp=True)
