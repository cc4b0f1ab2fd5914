"""Serving: a calibrated surrogate as a deployable artifact (port of `cppre.deploy`).

Packages a trained FNO, its normalizers, the residual operator and the
conformal calibration (qhat + modulation at a fixed alpha) into one object,
so calibrate-once / serve-many is one flow:

    srv = CalibratedSurrogate(model, residual_fn, step=1, T_out=20,
                              in_normalizer=in_n, out_normalizer=out_n,
                              fused=True)
    srv.calibrate(cal_a, cal_u, alpha=0.1)        # once
    out = srv.predict(new_a)                      # many
    out["prediction"], out["sets"], out["accept"]
    srv.save("deploy/ns_v1")
    CalibratedSurrogate.load("deploy/ns_v1", model, residual_fn)

The model (an `nn.Module`) holds its own weights, so unlike the JAX class
there is no separate `params` argument. Everything runs on the model's
device; inputs are moved there as float32. `fused=True` routes the rollouts
through the hand-written FNO kernels (`models.fused.make_fused_apply`).
Serving batches may differ in size from the calibration batch: the fused
forward of a sample does not depend on its batch, so the CP
exchangeability contract survives the shape change.

`mesh=` (a `parallel.make_mesh` mesh with a 'dp' axis; call on every rank)
splits every rollout's batch over 'dp': each rank rolls out and takes the
residual of its block, zero-padded to the block length, and the results
are cropped and gathered, so every rank holds the same state and
answers.

Under a `torch.profiler` or `utils.profiling.recording()`, `predict` records
the span `serve.predict` around the request, and in it `serve.rollout`
(encode, rollout, decode), then `serve.layout` (`_to_convops`),
`pre.residual` (the fused residual entries), `cp.sets` (`sets`) and
`cp.accept` (the filters), each where that work runs.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from .cp.inductive import (
    calibrate as cp_calibrate,
    filter_sims_joint,
    filter_sims_within_bounds,
    modulation_func,
    ncf_metric_joint,
)
from .train.rollout import autoregressive_rollout
from .utils.profiling import span

__all__ = ["CalibratedSurrogate"]


def _to_convops(field):
    """[BS, Nvar, Nx, Ny, Nt] -> contiguous [BS, Nvar, Nt, Nx, Ny] (the
    reference's permute(0, 1, 4, 2, 3)); the span `serve.layout`."""
    with span("serve.layout", field):
        return field.permute(0, 1, 4, 2, 3).contiguous()


class CalibratedSurrogate:
    """A trained surrogate + conformal calibration, ready to serve.

    Parameters
    ----------
    model : ``nn.Module`` mapping ``[B, Nvar, Nx, Ny, T_in] -> [B, Nvar, Nx, Ny, step]``
        (``FNO2d``), holding its trained weights.
    residual_fn : PRE operator over the ConvOps layout ``[B, Nvar, Nt, Nx, Ny]``
        (a ``cppre_torch.residuals`` class or a closure).
    step, T_out : AR rollout contract.
    in_normalizer / out_normalizer : encode/decode pair (default Identity).
    mode : 'joint' (per-sample sup-norm sets) or 'marginal' (per-cell).
    score : 'pre' (data-free, |residual(pred)|) or 'aer+pre'
        (|residual(truth) - residual(pred)|, needs truth at calibration).
    layout_fn : prediction -> residual-operator layout (default the 2-D permute).
    fused : route rollouts through the hand-written FNO kernels
        (`models.fused.make_fused_apply`; on the card a shape they do not
        take raises).
    mesh : optional `parallel.Mesh` with a 'dp' axis: rollouts and their
        residuals run on each rank's rows (with ``fused``, through
        `parallel.make_sharded_fused_apply`'s per-rank apply), gathered.
    """

    def __init__(self, model, residual_fn: Callable, *, step: int, T_out: int,
                 in_normalizer=None, out_normalizer=None, mode: str = "joint",
                 score: str = "pre", layout_fn: Callable = _to_convops, fused: bool = False,
                 mesh=None):
        if mode not in ("joint", "marginal"):
            raise ValueError(f"unknown mode {mode!r}")
        if score not in ("pre", "aer+pre"):
            raise ValueError(f"unknown score {score!r}")
        from .train.normalizers import Identity

        self.model = model
        self.device = next(model.parameters()).device
        self.residual_fn = residual_fn
        self.step, self.T_out = step, T_out
        # the normalizers move to the model's device (in place)
        self.in_norm = (Identity(device=self.device) if in_normalizer is None
                        else in_normalizer).to(self.device)
        self.out_norm = (Identity(device=self.device) if out_normalizer is None
                         else out_normalizer).to(self.device)
        self.mode, self.score = mode, score
        self.layout_fn = layout_fn
        self.fused = fused
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the model lives on {self.device}, the mesh's rank on "
                             f"{mesh.device}")
        # calibration state (set by calibrate()/load())
        self.alpha = None
        self.qhat = None        # 0-d (joint) or field (marginal)
        self.modulation = None  # field (joint) or None (marginal)
        self.scores = None      # calibration scores (recalibrate() source)
        self.threshold = 0.5    # marginal accept: fraction of cells in-bounds
        self.n_cal = None

    def _as_input(self, a):
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _apply_fn(self):
        if self.fused and self.mesh is not None:
            from .parallel import make_sharded_fused_apply

            return make_sharded_fused_apply(self.model, self.mesh).local
        if self.fused:
            from .models.fused import make_fused_apply

            return make_fused_apply(self.model)
        return self.model

    def _rollout_rows(self, a_raw, apply_fn):
        """The decoded rollout of rows `a_raw`, and their residual after it."""
        with span("serve.rollout", self.device):
            a = self.in_norm.encode(a_raw)
            pred = self.out_norm.decode(autoregressive_rollout(apply_fn, a, self.step,
                                                               self.T_out))
        return pred, self.residual_fn(self.layout_fn(pred))

    @torch.no_grad()
    def _rollout(self, a_raw):
        """(prediction [B, Nvar, Nx, Ny, T_out] decoded, its residual)."""
        apply_fn = self._apply_fn()
        if self.mesh is None:
            return self._rollout_rows(self._as_input(a_raw), apply_fn)
        from .parallel import map_batch

        return map_batch(lambda rows: self._rollout_rows(rows, apply_fn), self.mesh,
                         self._as_input(a_raw))

    # -- calibration -------------------------------------------------------

    @torch.no_grad()
    def calibrate(self, cal_a, cal_u=None, alpha: float = 0.1, eps: float = 0.0,
                  holdout_modulation: bool = False, threshold: float = 0.5):
        """Fit the conformal state on a calibration set.

        cal_a: [n_cal, Nvar, Nx, Ny, T_in] initial windows (raw units);
        cal_u: matching truth trajectories [n_cal, Nvar, Nx, Ny, T_out] —
        required for score='aer+pre', optional otherwise. Returns self.

        `holdout_modulation=True` (joint mode) estimates the modulation on
        the first half and scores on the second (see
        `experiments.pipeline.joint_cp`).
        """
        _, res_pred = self._rollout(cal_a)
        res_out = None
        if self.score == "aer+pre":
            if cal_u is None:
                raise ValueError("score='aer+pre' needs cal_u at calibration")
            res_out = self.residual_fn(self.layout_fn(self._as_input(cal_u)))

        if self.mode == "joint":
            if holdout_modulation:
                n_half = res_pred.shape[0] // 2
                mod_pred, score_pred = res_pred[:n_half], res_pred[n_half:]
                mod_out = res_out[:n_half] if res_out is not None else None
                score_out = res_out[n_half:] if res_out is not None else None
            else:
                mod_pred = score_pred = res_pred
                mod_out = score_out = res_out
            if self.score == "aer+pre":
                mod = modulation_func(mod_out, mod_pred) + eps
                scores = ncf_metric_joint(score_out, score_pred, mod)
            else:
                mod = modulation_func(mod_pred, None) + eps
                scores = ncf_metric_joint(score_pred, None, mod)
            self.modulation = mod
        else:
            scores = ((res_out - res_pred).abs() if self.score == "aer+pre"
                      else res_pred.abs())
            self.modulation = None
        self.scores = scores
        self.qhat = cp_calibrate(scores, scores.shape[0], alpha)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.n_cal = int(scores.shape[0])
        return self

    def recalibrate(self, alpha: float):
        """Move to a new alpha from the stored calibration scores: no
        rollout, no residuals, just a fresh split-CP quantile."""
        if self.scores is None:
            raise RuntimeError("no stored calibration scores; call calibrate() first "
                               "(or load a bundle that holds them)")
        self.qhat = cp_calibrate(self.scores, self.scores.shape[0], alpha)
        self.alpha = float(alpha)
        return self

    # -- serving -----------------------------------------------------------

    def _require_calibrated(self):
        if self.qhat is None:
            raise RuntimeError("call calibrate() (or load()) before serving")

    def _width(self):
        return self.qhat * self.modulation if self.mode == "joint" else self.qhat

    def sets(self, residual):
        """Residual-space prediction sets around `residual`: centred at 0 for
        the 'pre' score, at the predicted residual for 'aer+pre'."""
        self._require_calibrated()
        with span("cp.sets", residual):
            width = self._width()
            center = torch.zeros_like(residual) if self.score == "pre" else residual
            return center - width, center + width

    @torch.no_grad()
    def predict(self, a):
        """Serve: prediction + PRE + residual sets + accept decision.

        Returns a dict: 'prediction' [B, Nvar, Nx, Ny, T_out] (decoded),
        'residual' (PRE of the prediction), 'sets' (lo, hi) in residual
        space at the calibrated alpha, and 'accept' [B] bool — True where
        the prediction's own residual lies inside the zero-centred
        calibrated band (joint: every cell; marginal: a fraction of cells
        >= threshold), for both scores.
        """
        self._require_calibrated()
        with span("serve.predict", self.device):
            pred, res = self._rollout(a)
            lo, hi = self.sets(res)
            width = self._width()
            if self.mode == "joint":
                accept = filter_sims_joint((-width, width), res)
            else:
                accept = filter_sims_within_bounds(-width, width, res, self.threshold,
                                                   within=True)
        return {"prediction": pred, "residual": res, "sets": (lo, hi), "accept": accept}

    # -- persistence -------------------------------------------------------

    def save(self, prefix: str) -> str:
        """Write the deployment bundle: `<prefix>.pth` (model state_dict),
        `<prefix>_norms.npz` (reference norms contract), `<prefix>_cp.npz`
        (qhat/modulation/scores), `<prefix>_meta.json`."""
        from .utils.checkpoint import save_checkpoint, save_norms

        self._require_calibrated()
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        save_checkpoint(prefix, self.model)
        save_norms(prefix, self.in_norm, self.out_norm)
        arr = lambda t: t.detach().cpu().numpy()
        cp_state = {"qhat": arr(self.qhat)}
        if self.modulation is not None:
            cp_state["modulation"] = arr(self.modulation)
        if self.scores is not None:
            cp_state["scores"] = arr(self.scores)
        np.savez(prefix + "_cp.npz", **cp_state)
        meta = {"alpha": self.alpha, "mode": self.mode, "score": self.score,
                "step": self.step, "T_out": self.T_out, "threshold": self.threshold,
                "n_cal": self.n_cal}
        with open(prefix + "_meta.json", "w") as f:
            json.dump(meta, f, indent=1)
        return prefix

    @classmethod
    def load(cls, prefix: str, model, residual_fn: Callable, *,
             layout_fn: Callable = _to_convops, fused: bool = False, mesh=None):
        """Rebuild a serving object from :meth:`save`'s bundle; the weights
        are loaded into `model` (built with the same configuration)."""
        from .utils.checkpoint import load_checkpoint, load_norms

        with open(prefix + "_meta.json") as f:
            meta = json.load(f)
        load_checkpoint(prefix, model)
        in_norm, out_norm = load_norms(prefix, device=next(model.parameters()).device)
        srv = cls(model, residual_fn, step=meta["step"], T_out=meta["T_out"],
                  in_normalizer=in_norm, out_normalizer=out_norm, mode=meta["mode"],
                  score=meta["score"], layout_fn=layout_fn, fused=fused, mesh=mesh)
        cp_z = np.load(prefix + "_cp.npz")
        dev = srv.device
        srv.qhat = torch.as_tensor(cp_z["qhat"], device=dev)
        srv.modulation = (torch.as_tensor(cp_z["modulation"], device=dev)
                          if "modulation" in cp_z else None)
        srv.scores = (torch.as_tensor(cp_z["scores"], device=dev)
                      if "scores" in cp_z else None)
        srv.alpha = meta["alpha"]
        srv.threshold = meta.get("threshold", 0.5)
        srv.n_cal = meta.get("n_cal")
        return srv
