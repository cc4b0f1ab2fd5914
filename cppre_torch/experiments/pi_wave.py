"""Physics-informed wave-FNO training (port of `cppre.experiments.pi_wave`).

PRE as the training loss (Config basic|finetune) and the PISL and combined
losses, on spectral wave data; reports the test MSE and mean |PRE| before
and after physics-informed training. The PI residual has c = 0.5 while the
data's c is 1.0, the reference's choice.

On the card the residual operator is kernel K8 on the zero-padded field
(`pi.StencilOperator`), whose backward is K8 again; the model pretrains,
rolls out and PI-trains through K4-K7 (`make_fused_train_apply`,
`make_fused_apply`).

Run on the card: ``python -m cppre_torch.experiments.pi_wave [pi|pisl|combined] [basic|finetune]``.
"""

from __future__ import annotations

import torch

from ..models import FNO2d, make_fused_apply, make_fused_train_apply
from ..pi import (StencilOperator, finetune_physics_informed, make_combined_loss,
                  make_pi_loss, make_pisl_loss)
from ..pi.losses import fno_chunk_residual
from ..residuals.wave import PRE_Wave
from ..train.loops import fit
from ..train.losses import lp_loss
from ..train.normalizers import MinMaxNormalizer
from ..train.rollout import validation_AR
from .wave import CONFIG, gen_data

__all__ = ["PI_CONFIG", "run"]

PI_CONFIG = dict(CONFIG, Config="finetune", c_pi=0.5, PI_Epochs=100)


def run(loss_kind: str = "pi", mode: str = "finetune", config: dict | None = None,
        seed: int = 0, verbose: bool = True, device="cuda"):
    """Returns cppre's keys ("mse_before", "mse_after", "pre_before",
    "pre_after"), "model" (the trained FNO2d) in place of "params", and
    "pi_losses" (the loss of each PI epoch, `finetune_physics_informed`'s)."""
    cfg = {**PI_CONFIG, **(config or {}), "Config": mode}
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    data, dt_eff, dx = gen_data(cfg, cfg["n_train"] + cfg["n_test"], seed, device)
    a_all, u_all = data[..., :T_in], data[..., T_in:T_in + T_out]
    a_all, u_all = MinMaxNormalizer(a_all).encode(a_all), MinMaxNormalizer(u_all).encode(u_all)
    tr, te = slice(0, cfg["n_train"]), slice(cfg["n_train"], None)
    batch = min(cfg["Batch Size"], cfg["n_train"])

    model = FNO2d(T_in, step, cfg["Modes"], cfg["Modes"], cfg["Variables"], cfg["Width_time"],
                  device=device, generator=torch.Generator().manual_seed(seed))
    train_apply = make_fused_train_apply(model)
    if mode == "finetune":  # pretrain on the data loss first
        fit(train_apply, model, a_all[tr], u_all[tr], a_all[te][:5], u_all[te][:5],
            epochs=cfg["Epochs"], batch_size=batch, step=step, T_out=T_out,
            loss_func=lp_loss, lr=cfg["Learning Rate"], seed=seed)

    # the PI residual operator: c = 0.5, the reference's
    pre = PRE_Wave(dt_eff, dx, c=cfg["c_pi"])
    residual_fn = fno_chunk_residual(StencilOperator(pre.D.kernel))
    loss_fn = {"pi": make_pi_loss(residual_fn),
               "pisl": make_pisl_loss(residual_fn),
               "combined": make_combined_loss(residual_fn)}[loss_kind]

    @torch.no_grad()
    def metrics():
        pred, mse, _ = validation_AR(make_fused_apply(model), a_all[te], u_all[te], step, T_out)
        return float(mse), float(torch.mean(torch.abs(residual_fn(pred))))

    mse0, pre0 = metrics()
    _, pi_losses = finetune_physics_informed(
        train_apply, model, a_all[tr], u_all[tr], loss_fn=loss_fn, epochs=cfg["PI_Epochs"],
        batch_size=batch, step=step, T_out=T_out, lr=cfg["Learning Rate"], loss_on="full",
        seed=seed)
    mse1, pre1 = metrics()

    results = {"mse_before": mse0, "mse_after": mse1, "pre_before": pre0, "pre_after": pre1,
               "model": model, "pi_losses": pi_losses}
    if verbose:
        print(f"{loss_kind}/{mode}: MSE {mse0:.3e} -> {mse1:.3e}, "
              f"|PRE| {pre0:.3e} -> {pre1:.3e}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "pi",
        sys.argv[2] if len(sys.argv) > 2 else "finetune")
