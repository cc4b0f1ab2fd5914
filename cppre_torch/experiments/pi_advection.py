"""Physics-informed advection-FNO training (port of
`cppre.experiments.pi_advection`).

The 1-D composite advection kernel as a differentiable training loss on
the rollout (Config basic: train from scratch on the PI loss only;
finetune: pretrain on the data loss first). Plain torch on the card: the
1-D path has no kernel.

Run on the card: ``python -m cppre_torch.experiments.pi_advection [basic|finetune]``.
"""

from __future__ import annotations

import torch

from ..models import FNO1d
from ..pi import finetune_physics_informed, make_pi_loss
from ..residuals.advection import PRE_Advection
from ..solvers.advection1d import Advection1D
from ..train.loops import fit
from ..train.losses import mse as mse_loss
from ..train.rollout import validation_AR
from .advection import CONFIG, LB, UB, _gen_fields, _to_convops
from .common import sample_params

__all__ = ["run"]


def run(mode: str = "finetune", config: dict | None = None, seed: int = 0,
        verbose: bool = True, device="cuda"):
    """Returns cppre's keys ("mse_before", "mse_after", "pre_before",
    "pre_after"), "model" (the trained FNO1d) and "pi_losses" (the PI
    loss of each PI epoch, `finetune_physics_informed`'s)."""
    cfg = {**CONFIG, "PI_Epochs": 50, **(config or {})}
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    sim = Advection1D(cfg["Nx"], cfg["Nt"], cfg["x_min"], cfg["x_max"], cfg["t_end"],
                      device=device)
    pre = PRE_Advection(sim.dt, sim.dx, v=cfg["v"])

    train_a, train_u = _gen_fields(sim, sample_params(LB, UB, cfg["n_train"], seed), T_in,
                                   T_out)
    test_a, test_u = _gen_fields(sim, sample_params(LB, UB, cfg["n_test"], seed + 1), T_in,
                                 T_out)

    model = FNO1d(T_in, step, cfg["Modes"], cfg["Variables"], cfg["Width"], device=device,
                  generator=torch.Generator().manual_seed(seed))
    if mode == "finetune":
        fit(model, model, train_a, train_u, test_a[:5], test_u[:5], epochs=cfg["Epochs"],
            batch_size=cfg["Batch Size"], step=step, T_out=T_out, loss_func=mse_loss,
            lr=cfg["Learning Rate"], seed=seed)

    residual_fn = lambda pred: pre(_to_convops(pred))
    loss_fn = make_pi_loss(residual_fn)

    @torch.no_grad()
    def metrics():
        pred, mse, _ = validation_AR(model, test_a, test_u, step, T_out)
        return float(mse), float(torch.mean(torch.abs(residual_fn(pred))))

    mse0, pre0 = metrics()
    _, pi_losses = finetune_physics_informed(
        model, model, train_a, train_u, loss_fn=loss_fn, epochs=cfg["PI_Epochs"],
        batch_size=cfg["Batch Size"], step=step, T_out=T_out, lr=cfg["Learning Rate"],
        loss_on="full", seed=seed)
    mse1, pre1 = metrics()
    results = {"mse_before": mse0, "mse_after": mse1, "pre_before": pre0, "pre_after": pre1,
               "model": model, "pi_losses": pi_losses}
    if verbose:
        print(f"advection PI/{mode}: MSE {mse0:.3e} -> {mse1:.3e}, "
              f"|PRE| {pre0:.3e} -> {pre1:.3e}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "finetune")
