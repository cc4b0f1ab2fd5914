"""Burgers and wave active-learning experiments (port of
`cppre.experiments.al_more`).

Thin drivers over `al.active_learning_loop`: Burgers (the pseudospectral
solver, 3-mode sine initial conditions in [-3, 3]^3, an FNO1d; plain torch
on the card) and wave (the spectral solver, (amp, x0, y0) in
[10, 50] x [0.1, 0.5]^2, an FNO2d). On the card the wave model pretrains
and fine-tunes through K4-K7, rolls out through K4/K5, and its residual
is kernel K8 (`wave_residual_fused`, equal to `PRE_Wave(boundary=False)`).

Run on the card: ``python -m cppre_torch.experiments.al_more [burgers|wave] [CP|PRE|RAND]``.
"""

from __future__ import annotations

import torch

from ..al import active_learning_loop
from ..al.loop import _applies
from ..cp.inductive import modulation_func, ncf_metric_joint
from ..models import FNO1d, FNO2d
from ..ops.kernels import wave_residual_fused
from ..residuals.burgers import PRE_Burgers
from ..residuals.wave import PRE_Wave
from ..solvers.burgers1d import Burgers1D
from ..train.loops import fit
from ..train.losses import lp_loss
from ..train.rollout import validation_AR
from .common import sample_params

__all__ = ["loop_inputs", "run"]


def _setup_burgers(cfg, seed, device):
    from .burgers import CONFIG as BCFG, LB, UB

    cfg = {**BCFG, "n_iterations": 5, "alpha": 0.5, **(cfg or {})}
    sim = Burgers1D(cfg["Nx"], cfg["Nt"], cfg["x_min"], cfg["x_max"], cfg["t_end"], cfg["nu"],
                    device=device)
    pre = PRE_Burgers(sim.dt, sim.dx, nu=cfg["nu"])
    T_in, T_out = cfg["T_in"], cfg["T_out"]

    def gen(p):
        d = sim.solve_batch(p).permute(0, 2, 1)[:, None].contiguous()     # [n, 1, Nx, Nt]
        return d[..., :T_in], d[..., T_in:T_in + T_out]

    model = FNO1d(T_in, cfg["Step"], cfg["Modes"], 1, cfg["Width"], device=device,
                  generator=torch.Generator().manual_seed(seed))
    to_res = lambda pred: pre(pred.permute(0, 1, 3, 2)[:, 0])
    return cfg, LB, UB, gen, model, to_res


def _setup_wave(cfg, seed, device):
    from .wave import CONFIG as WCFG, LB, UB, _sim

    cfg = {**WCFG, "n_iterations": 5, "alpha": 0.5, **(cfg or {})}
    T_in, T_out = cfg["T_in"], cfg["T_out"]
    sim = _sim(cfg, device)
    pre = PRE_Wave(sim.dt * cfg["t_slice"], sim.dx, c=cfg["c"])

    def gen(p):
        u = sim.solve_batch(p)[:, ::cfg["t_slice"]]
        d = torch.movedim(u, 1, -1)[:, None].contiguous()                  # [n, 1, Nx, Ny, Nt]
        return d[..., :T_in], d[..., T_in:T_in + T_out]

    model = FNO2d(T_in, cfg["Step"], cfg["Modes"], cfg["Modes"], 1, cfg["Width_time"],
                  device=device, generator=torch.Generator().manual_seed(seed))
    # [BS, 1, Nx, Ny, T] -> K8 on [BS, T, Nx, Ny]: the interior PRE_Wave residual
    to_res = lambda pred: wave_residual_fused(pred[:, 0].permute(0, 3, 1, 2).contiguous(),
                                              pre.D.kernel)
    return cfg, LB, UB, gen, model, to_res


def loop_inputs(case: str = "burgers", acq: str = "PRE", config: dict | None = None,
                seed: int = 0, verbose: bool = True, device="cuda"):
    """What `run` does before its loop: the case's model pretrained on the
    initial design and joint-CP scores calibrated on its rollouts. Returns
    the keyword arguments of `al.active_learning_loop`, whose call is the
    rest of `run`."""
    setup = {"burgers": _setup_burgers, "wave": _setup_wave}[case]
    cfg, lb, ub, gen, model, to_res = setup(config, seed, device)
    roll_apply, train_apply = _applies(model)
    step, T_out = cfg["Step"], cfg["T_out"]

    train_a, train_u = gen(sample_params(lb, ub, cfg["n_train"], seed))
    test_a, test_u = gen(sample_params(lb, ub, cfg.get("n_test", 50), seed + 1))
    fit(train_apply, model, train_a, train_u, test_a[:5], test_u[:5], epochs=cfg["Epochs"],
        batch_size=min(cfg["Batch Size"], train_a.shape[0]), step=step, T_out=T_out,
        loss_func=lp_loss, lr=cfg["Learning Rate"], seed=seed)

    cal_a, cal_u = gen(sample_params(lb, ub, cfg["n_cal"], seed + 2))
    with torch.no_grad():
        pred_cal, _, _ = validation_AR(roll_apply, cal_a, cal_u, step, T_out)
        res_out, res_prd = to_res(cal_u), to_res(pred_cal)
        mod = modulation_func(res_out, res_prd) + 1e-6
        scores = ncf_metric_joint(res_out, res_prd, mod)

    return dict(acq_func=acq, model=model, gen_fields=gen, residual_of=to_res, lb=lb, ub=ub,
                train_a=train_a, train_u=train_u, test_a=test_a, test_u=test_u,
                cal_scores=scores, modulation=mod, n_iterations=cfg["n_iterations"],
                n_pred=cfg["n_pred"], alpha=cfg["alpha"], epochs=cfg["Epochs"],
                batch_size=min(cfg["Batch Size"], 10), step=step, T_out=T_out,
                loss_func=lp_loss, lr=1e-3, seed=seed, verbose=verbose)


def run(case: str = "burgers", acq: str = "PRE", config: dict | None = None, seed: int = 0,
        verbose: bool = True, device="cuda"):
    """Returns cppre's "test_mse" and "sims_sampled", and "model" (the
    fine-tuned module)."""
    kw = loop_inputs(case, acq, config, seed, verbose, device)
    _, mse_hist, sampled = active_learning_loop(**kw)
    return {"test_mse": mse_hist, "sims_sampled": sampled, "model": kw["model"]}


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "burgers",
        sys.argv[2] if len(sys.argv) > 2 else "PRE")
