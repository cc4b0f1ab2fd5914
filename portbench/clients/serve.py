"""Served rollouts: `CalibratedSurrogate.predict` on batches of new initial conditions.

Set-up calibrates the program's surrogate once on `n_cal` initial
conditions, then each request serves a batch (the configuration's
`batch_key` size) from an on-device pool of distinct batches, through the
fused forward (K4 x 6 and K5 per step), the residual, the sets and the
accept mask, finished when the mask is on the host.
"""

from __future__ import annotations

from portbench import yardstick as Y
from portbench.clients import surrogate


def _batch(cell):
    return int(cell.config[cell.traffic["batch_key"]])


def _pool(cell, seed, n, device):
    b = _batch(cell)
    pool = surrogate.initial_conditions(cell, seed, "requests", n * b, device)
    return pool.reshape((n, b) + pool.shape[1:])


def setup(cell, seed, device):
    srv, calibration = surrogate.calibrated_surrogate(cell, seed, device)
    pool = _pool(cell, seed, int(cell.traffic["pool_batches"]), device)
    srv.predict(pool[0])["accept"].cpu()                 # warm the served shape
    return {"srv": srv, "calibration": calibration, "pool": pool}


def item(state, i):
    a = state["pool"][i % state["pool"].shape[0]]
    out = state["srv"].predict(a)
    lo, hi = out["sets"]
    req = {"inputs": a, "prediction": out["prediction"], "residual": out["residual"],
           "lo": lo, "hi": hi, "accept": out["accept"].cpu()}
    return {"samples": a.shape[0], "keep": req}


def work(cell):
    c, b = cell.config, _batch(cell)
    n = c["T_out"] // c["Step"]
    shape = (b, c["Width_time"], c["Variables"], c["Nx"], c["Ny"], c["Modes"])
    return {"samples": b,
            "fno_fwd_bound_s": n * Y.fno_forward_bound_s(*shape, c["Step"]),
            "model_flops": n * Y.fno_forward_flops(*shape, c["T_in"], c["Step"]),
            "launches": {"K4": 6 * n, "K5": n}}


def answers(state, kept):
    return dict(surrogate.calibration_answers(state["srv"], state["calibration"]),
                requests=[req for _, req in kept])


def check(cell, seed, ans, device):
    return surrogate.compare(cell, ans, lambda req: req["prediction"], device)


def control(cell, seed, device):
    """The reference at TF32 in the program's place, on the inputs of a run
    of `seed`: answers for `check`."""
    pool = _pool(cell, seed, int(cell.traffic["check"]["requests"]), device)
    return surrogate.control_answers(cell, seed, device, [(a, None) for a in pool])
