"""Judged predictions: the part of `CalibratedSurrogate.predict` that follows the rollout.

CP-PRE judges predictions from any surrogate or solver by the physics
residual alone. Set-up calibrates the program's surrogate as the serving
traffic does; each request then takes `batch` supplied predictions
[batch, V, Nx, Ny, T_out] from an on-device pool of distinct batches
through the surrogate's layout, residual (K2 for NS), sets and the joint
filter, finished when the mask is on the host. No FNO kernel runs.
"""

from __future__ import annotations

from portbench import fields
from portbench import yardstick as Y
from portbench.clients import surrogate


def _pool(cell, seed, n, device):
    """n batches of `batch` predictions [n, batch, V, Nx, Ny, T_out]."""
    c, b = cell.config, int(cell.traffic["batch"])
    pool = fields.smooth(fields.generator(seed, "predictions", device),
                         (n * b, c["Variables"], c["Nx"], c["Ny"], c["T_out"]),
                         cell.traffic["predictions"], device, dt=1.0 / c["T_out"])
    return pool.reshape((n, b) + pool.shape[1:])


def setup(cell, seed, device):
    from cppre_torch.cp.inductive import filter_sims_joint

    srv, calibration = surrogate.calibrated_surrogate(cell, seed, device)
    pool = _pool(cell, seed, int(cell.traffic["pool_batches"]), device)
    state = {"srv": srv, "calibration": calibration, "pool": pool, "filter": filter_sims_joint}
    item(state, 0)                                       # warm the judged shape
    return state


def item(state, i):
    srv = state["srv"]
    pred = state["pool"][i % state["pool"].shape[0]]
    res = srv.residual_fn(srv.layout_fn(pred))
    lo, hi = srv.sets(res)
    width = srv.qhat * srv.modulation
    accept = state["filter"]((-width, width), res).cpu()
    return {"samples": pred.shape[0],
            "keep": {"field": pred, "residual": res, "lo": lo, "hi": hi, "accept": accept}}


def work(cell):
    c, b = cell.config, int(cell.traffic["batch"])
    out = {"samples": b, "launches": {}}
    if c["residual"]["kind"] == "ns_momentum":
        out["k2_bound_s"] = Y.bound_s(*Y.k2_ns_cost(b, c["T_out"], c["Nx"], c["Ny"]))
        out["launches"]["K2"] = 1
    return out


def answers(state, kept):
    return dict(surrogate.calibration_answers(state["srv"], state["calibration"]),
                requests=[req for _, req in kept])


def check(cell, seed, ans, device):
    return surrogate.compare(cell, ans, lambda req: req["field"], device)


def control(cell, seed, device):
    """The reference at TF32 in the program's place, on the inputs of a run
    of `seed`: answers for `check`."""
    pool = _pool(cell, seed, int(cell.traffic["check"]["requests"]), device)
    return surrogate.control_answers(cell, seed, device, [(None, f) for f in pool])
