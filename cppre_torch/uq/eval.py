"""UQ-method comparison harness: bootstrap resamples, coverage, timing
(port of `cppre.uq.eval`).

For each UQ method, over `runs` bootstrap resamples of `n_eval` test sims:
run the method's validation rollout, build mean +- 2*std sets (or -/+ qhat
for AER/PRE), record marginal/joint empirical coverage, L2 and wall-clock,
and report mean +- std per method.

The resamples are numpy's `default_rng(seed).choice`, as in cppre, so both
packages draw the same subsets. A resample's stochastic methods draw from a
`torch.Generator` on the data's device seeded with seed * 1000 + resample
(cppre's key); every batch piece of a chunked run starts from that seed,
so weight-space draws (Bayesian, SWAG) are the same for every piece.
`eval_time` is host seconds around the method's call, ending in
`torch.cuda.synchronize()` on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..cp.inductive import calibrate, emp_cov, emp_cov_joint
from ..models.fused import make_fused_apply
from ..train.rollout import autoregressive_rollout
from . import validation as V

__all__ = ["evaluate_uq_methods"]


def _bootstrap_idx(rng, n_total, n_eval):
    return rng.choice(n_total, size=min(n_eval, n_total), replace=False)


def _validate(uq, model, aux, a, u, step, T_out, samples, generator):
    """(mean, std, mse, mae) of one batch piece for the per-element methods."""
    if uq == "Deterministic":
        mean, mse, mae = V.validation_deterministic(model, a, u, step, T_out)
        return mean, torch.zeros_like(mean), mse, mae
    if uq == "Dropout":
        return V.validation_dropout(model, a, u, step, T_out, samples, generator)
    if uq == "Bayesian":
        return V.validation_bayesian(model, a, u, step, T_out, samples, generator)
    if uq == "Ensemble":
        return V.validation_ensemble(aux, a, u, step, T_out)
    if uq == "SWAG":
        return V.validation_swag(model, aux, a, u, step, T_out, samples, generator)
    if uq == "MLE":
        mean, var, mse, mae = V.validation_mle(model, a, u, step, T_out)
        return mean, torch.sqrt(var), mse, mae
    raise ValueError(f"unknown UQ method {uq}")


def evaluate_uq_methods(
    *,
    methods: Sequence[str],
    model_factory: Callable[[str], tuple],  # uq_name -> (model, aux)
    test_a,
    test_u,
    step: int,
    T_out: int,
    alpha: float = 0.1,
    samples: int = 10,
    runs: int = 10,
    n_eval: int = 300,
    pre=None,
    seed: int = 0,
    verbose: bool = True,
    on_method_done: Callable[[str, dict], None] | None = None,
    batch_chunk: int | None = None,
    mesh=None,
) -> Dict[str, dict]:
    """Returns {method: {l2, coverage, joint_coverage, eval_time: (mean, std)}}.

    `model_factory(uq)` returns (model, aux): aux is None where the model
    holds the method's weights (Deterministic, Dropout, Bayesian, MLE, AER,
    PRE), the list of member models (Ensemble), or a `SWAG` (SWAG).

    `batch_chunk` evaluates in batch pieces of that size, concatenated on
    the host: identical statistics, bounded device memory. For AER/PRE the
    pieces carry per-sim scores and the conformal quantile is taken once
    over the concatenated scores. `on_method_done(uq, result)` fires after
    each method's resample loop.

    `mesh` (a `parallel.make_mesh` mesh with a 'dp' axis; call on every
    rank) splits each validation over 'dp': each rank runs the method on
    its rows of the resample, zero-padded to the block length, and the
    rollouts come back cropped and gathered; L2/MAE are taken on the
    gathered mean, and for AER/PRE the conformal quantile over the
    gathered rollout, so pad rows never enter calibration. Stochastic
    methods draw as a chunked run does: every rank's piece starts from the
    resample's seed. `mesh=` with `batch_chunk=` raises ValueError."""
    if mesh is not None and batch_chunk:
        raise ValueError("mesh= and batch_chunk= are exclusive: chunking is a single-device "
                         "memory knob; on a mesh the batch is already divided across ranks")
    rng = np.random.default_rng(seed)
    results = {}
    test_a = torch.as_tensor(test_a, dtype=torch.float32)
    test_u = torch.as_tensor(test_u, dtype=torch.float32, device=test_a.device)
    dev = test_a.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for uq in methods:
        model, aux = model_factory(uq)
        l2s, covs, jcovs, times = [], [], [], []
        for ii in range(runs):
            idx = torch.as_tensor(_bootstrap_idx(rng, test_a.shape[0], n_eval), device=dev)
            a, u = test_a[idx], test_u[idx]
            gen = lambda: torch.Generator(device=dev).manual_seed(seed * 1000 + ii)
            chunked = bool(batch_chunk) and a.shape[0] > batch_chunk
            pieces = [slice(lo, lo + batch_chunk) for lo in range(0, a.shape[0], batch_chunk)] \
                if chunked else [slice(None)]
            qhat = host_scores = None
            sync()
            t1 = time.perf_counter()
            if mesh is not None:
                from ..parallel import map_batch

                if uq in ("AER", "PRE"):
                    with torch.no_grad():
                        pred = map_batch(lambda a_p: autoregressive_rollout(
                            make_fused_apply(model), a_p, step, T_out), mesh, a)
                        mean, qhat, mse, mae = (
                            V._aer_from_rollout(pred, u, alpha) if uq == "AER"
                            else V._pre_from_rollout(pred, u, alpha, pre))
                else:
                    mean, std = map_batch(lambda a_p, u_p: _validate(
                        uq, model, aux, a_p, u_p, step, T_out, samples, gen())[:2], mesh, a, u)
                    mse = torch.mean((mean - u) ** 2)
                    mae = torch.mean(torch.abs(mean - u))
            elif uq in ("AER", "PRE"):
                if chunked:
                    # rollout + per-sim scores in pieces, then ONE conformal
                    # quantile over the concatenated scores
                    ms, scs, w_mse, w_mae = [], [], 0.0, 0.0
                    for sl in pieces:
                        m_p, s_p, mse_p, mae_p = (
                            V.validation_aer_scores(model, a[sl], u[sl], step, T_out)
                            if uq == "AER" else
                            V.validation_pre_scores(model, a[sl], u[sl], step, T_out, pre))
                        n_p = int(a[sl].shape[0])
                        ms.append(m_p.cpu().numpy())
                        scs.append(s_p.cpu().numpy())
                        w_mse += float(mse_p) * n_p
                        w_mae += float(mae_p) * n_p
                    mean = np.concatenate(ms)
                    host_scores = np.concatenate(scs)
                    qhat = calibrate(torch.from_numpy(host_scores), a.shape[0], alpha)
                    mse, mae = w_mse / a.shape[0], w_mae / a.shape[0]
                elif uq == "AER":
                    mean, qhat, mse, mae = V.validation_aer(model, a, u, step, T_out, alpha)
                else:
                    mean, qhat, mse, mae = V.validation_pre(model, a, u, step, T_out, alpha,
                                                            pre)
            elif chunked:
                ms, ss, w_mse, w_mae = [], [], 0.0, 0.0
                for sl in pieces:
                    m_p, s_p, mse_p, mae_p = _validate(uq, model, aux, a[sl], u[sl], step,
                                                       T_out, samples, gen())
                    n_p = int(a[sl].shape[0])
                    ms.append(m_p)
                    ss.append(s_p)
                    w_mse += float(mse_p) * n_p
                    w_mae += float(mae_p) * n_p
                mean, std = torch.cat(ms), torch.cat(ss)
                mse, mae = w_mse / a.shape[0], w_mae / a.shape[0]
            else:
                mean, std, mse, mae = _validate(uq, model, aux, a, u, step, T_out, samples,
                                                gen())
            sync()
            dt = time.perf_counter() - t1

            if host_scores is not None:
                q_np = qhat.numpy()
                if uq == "PRE":
                    # score = |residual|: score <= qhat is -qhat <= res <= qhat
                    inside = host_scores <= q_np
                else:
                    # AER keeps the set form: mean +- qhat rounds
                    u_np = u.cpu().numpy()
                    inside = (u_np >= mean - q_np) & (u_np <= mean + q_np)
                cov = float(inside.mean())
                jcov = float(inside.reshape(inside.shape[0], -1).all(axis=1).mean())
            elif uq == "PRE":
                with torch.no_grad():
                    res = pre.residual(mean.permute(0, 1, 4, 2, 3))
                cov = emp_cov((-qhat, qhat), res)
                jcov = emp_cov_joint((-qhat, qhat), res)
            elif uq == "AER":
                sets = (mean - qhat, mean + qhat)
                cov, jcov = emp_cov(sets, u), emp_cov_joint(sets, u)
            else:
                sets = (mean - 2 * std, mean + 2 * std)
                cov, jcov = emp_cov(sets, u), emp_cov_joint(sets, u)

            l2s.append(float(mse))
            covs.append(float(cov))
            jcovs.append(float(jcov))
            times.append(dt)

        results[uq] = {
            "l2": (float(np.mean(l2s)), float(np.std(l2s))),
            "coverage": (float(np.mean(covs)), float(np.std(covs))),
            "joint_coverage": (float(np.mean(jcovs)), float(np.std(jcovs))),
            "eval_time": (float(np.mean(times)), float(np.std(times))),
        }
        if verbose:
            r = results[uq]
            print(f"{uq:14s} L2 {r['l2'][0]:.3e}±{r['l2'][1]:.1e}  "
                  f"cov {r['coverage'][0]:.3f}±{r['coverage'][1]:.3f}  "
                  f"t {r['eval_time'][0]:.2f}s±{r['eval_time'][1]:.2f}")
        if on_method_done is not None:
            on_method_done(uq, results[uq])
    return results
