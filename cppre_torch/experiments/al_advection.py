"""Advection active-learning experiment (port of
`cppre.experiments.al_advection`).

Pretrain an FNO1d on an initial LHS design, calibrate joint-CP scores on
its PRE, then run the CP / PRE / RAND acquisition loops (5 iterations,
alpha 0.5) and report the test-MSE and sims-sampled histories of each
acquisition function. Plain torch on the card: the 1-D path has no kernel.

`train_precision` wraps the pretraining and the loops' fine-tunes
(`models.with_train_precision`); rollouts and residuals stay at "highest".

cppre starts every acquisition function from the same pretrained params;
the port trains its module in place, so `run` loads the pretrained
`state_dict` back into the model before each function.

Run on the card: ``python -m cppre_torch.experiments.al_advection [CP|PRE|RAND|all]``.
"""

from __future__ import annotations

import copy

import torch

from ..al import active_learning_loop
from ..cp.inductive import modulation_func, ncf_metric_joint
from ..models import FNO1d, with_train_precision
from ..residuals.advection import PRE_Advection
from ..solvers.advection1d import Advection1D
from ..train.loops import fit
from ..train.losses import mse as mse_loss
from ..train.rollout import validation_AR
from .advection import CONFIG, LB, UB, _gen_fields, _to_convops
from .common import sample_params

__all__ = ["AL_CONFIG", "run"]

AL_CONFIG = dict(CONFIG, n_iterations=5, alpha=0.5, n_pred=100)


def run(acq: str = "all", config: dict | None = None, seed: int = 0, verbose: bool = True,
        train_precision: str = "highest", device="cuda"):
    """Returns {acquisition function: {"test_mse", "sims_sampled",
    "state_dict"}}: cppre's two histories and the weights that function's
    fine-tunes ended with."""
    cfg = dict(AL_CONFIG, **(config or {}))
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    sim = Advection1D(cfg["Nx"], cfg["Nt"], cfg["x_min"], cfg["x_max"], cfg["t_end"],
                      device=device)
    pre = PRE_Advection(sim.dt, sim.dx, v=cfg["v"])
    gen = lambda p: _gen_fields(sim, p, T_in, T_out)

    train_a, train_u = gen(sample_params(LB, UB, cfg["n_train"], seed))
    test_a, test_u = gen(sample_params(LB, UB, cfg["n_test"], seed + 1))

    model = FNO1d(T_in, step, cfg["Modes"], cfg["Variables"], cfg["Width"], device=device,
                  generator=torch.Generator().manual_seed(seed))
    # pretrain at the precision of the loops' fine-tunes
    fit(with_train_precision(model, train_precision), model, train_a, train_u, test_a[:10], test_u[:10], epochs=cfg["Epochs"],
        batch_size=cfg["Batch Size"], step=step, T_out=T_out, loss_func=mse_loss,
        lr=cfg["Learning Rate"], seed=seed)
    pretrained = copy.deepcopy(model.state_dict())

    # calibration scores for the CP acquisition
    cal_a, cal_u = gen(sample_params(LB, UB, cfg["n_cal"], seed + 2))
    with torch.no_grad():
        pred_cal, _, _ = validation_AR(model, cal_a, cal_u, step, T_out)
        res_out = pre(_to_convops(cal_u))
        res_prd = pre(_to_convops(pred_cal))
        mod = modulation_func(res_out, res_prd) + 1e-6
        scores = ncf_metric_joint(res_out, res_prd, mod)

    funcs = ["CP", "PRE", "RAND"] if acq == "all" else [acq]
    results = {}
    for f in funcs:
        model.load_state_dict(pretrained)
        state, mse_hist, sampled = active_learning_loop(
            acq_func=f, model=model, gen_fields=gen,
            residual_of=lambda pred: pre(_to_convops(pred)),
            lb=LB, ub=UB, train_a=train_a, train_u=train_u,
            test_a=test_a, test_u=test_u, cal_scores=scores, modulation=mod,
            n_iterations=cfg["n_iterations"], n_pred=cfg["n_pred"],
            alpha=cfg["alpha"], epochs=cfg["Epochs"],
            batch_size=cfg["Batch Size"], step=step, T_out=T_out,
            lr=1e-3, seed=seed, verbose=verbose, train_precision=train_precision)
        results[f] = {"test_mse": mse_hist, "sims_sampled": sampled,
                      "state_dict": copy.deepcopy(state)}
        if verbose:
            print(f"{f}: MSE {['%.4g' % m for m in mse_hist]}, sampled {sampled}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "all")
