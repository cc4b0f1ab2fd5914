"""What the serving clients share: the calibrated surrogate both sides build
from the seed, and the comparison of served answers with the reference.

The program's side is `cppre_torch.deploy.CalibratedSurrogate` over the
port's `FNO2d` (fused kernels), calibrated on `n_cal` initial conditions
with min-max normalisers fitted to them. The residual operator handed to
the surrogate is the program's, wrapped so that the benchmark, as the
surrogate's user, sees the calibration rollout the surrogate passes to it.

The reference judges the program's rollouts step by step: each step of a
rollout is the reference's FNO2d applied to the program's frames before
it, the first step to the benchmark's own initial conditions. A whole
rollout is not compared: the seeded models are chaotic, and a rounding
difference of one step grows over twenty. From the calibration rollout the
reference works out the residuals, modulation, scores and qhat again, and
the sets and accept flags of every kept request follow from those.
"""

from __future__ import annotations

import math

import torch

from portbench import fields
from portbench.reference import cp as ref_cp
from portbench.reference import fno as ref_fno
from portbench.reference.precision import tf32


def weights(cell, seed, device, served=True):
    """The seeded weights: FNO2d's own init, or with `served` a surrogate
    that has learned persistence (`served_weights`)."""
    w = fields.weights(seed, ref_fno.param_specs(cell.config), device, symmetric=served)
    return served_weights(cell.config, w) if served else w


# The stand-in for trained weights (`served_weights`): the shift that centres
# the encoded fields, which lie in [0, 1], on 0, where gelu bends most; the
# spectral weights' scale against FNO2d's init; and the seeded noise, as a
# share of the init scale, on every other weight and bias.
SHIFT = -0.5
SPECTRAL_GAIN = 3.0
NOISE = 0.05


def served_weights(c, w):
    """A stand-in for trained weights that has learned persistence, from a
    seeded draw `w` at FNO2d's init scale. Channels come in pairs, c and
    c + W/2, that carry h and -h, with h the last input frame plus SHIFT:
    since gelu(h) - gelu(-h) = h, each bypass map takes a pair's
    difference and the head's gelu pairs do the same, so the path is exact
    while every gelu works in its curved range (|h| < 1 before the skip
    adds, < 2 after). On that path the spectral convolutions (their (0, 0)
    mode zeroed, times SPECTRAL_GAIN) and the channel MLPs add a smooth
    change that depends on the field, and every other weight and bias, the
    bias branch b(grid) and the lift's grid columns with them, carries
    NOISE of its init draw on top of the path. A rollout of it stays as
    varied as its inputs and bounded; at the init itself every rollout
    falls onto one trajectory within a few steps."""
    width, half = c["Width_time"], c["Width_time"] // 2
    out = {}
    for k, v in w.items():
        if "conv.weights" in k:
            v = SPECTRAL_GAIN * v
            v[..., 0, 0] = 0 if k.endswith("weights1") else v[..., 0, 0]
        elif not (".mlp." in k and k.endswith("weight")):
            v = NOISE * v
        out[k] = v
    dev = out["fc0_time.bias"].device
    sign = torch.cat((torch.ones(half, device=dev), -torch.ones(width - half, device=dev)))
    out["fc0_time.weight"][:, c["T_in"] - 1] += sign
    out["fc0_time.bias"] += SHIFT * sign
    eye = torch.eye(half, device=dev)
    pair = torch.cat((torch.cat((eye, -eye), 1), torch.cat((-eye, eye), 1)))  # z_c - z_c', its negative
    for i in range(6):
        m = torch.eye(width, device=dev) if i == 0 else pair    # block 0 takes h itself
        out[f"f{i}.w.weight"] += m.reshape(width, width, 1, 1, 1)
    # after the skip adds of blocks 2 and 5 a pair's difference is 4 h; the
    # head's hidden units pair up the same way
    hidden = out["fc1_time.weight"].shape[0]
    hs = torch.cat((torch.ones(hidden // 2, device=dev), -torch.ones(hidden // 2, device=dev)))
    out["fc1_time.weight"] += torch.outer(hs, sign) / (4 * half)
    out["fc2_time.weight"] += hs / (hidden // 2)
    out["fc2_time.bias"] -= SHIFT
    return out


def port_model(cell, w, device):
    """The program's FNO2d holding the benchmark's weights `w`."""
    from cppre_torch.models import FNO2d

    c = cell.config
    model = FNO2d(c["T_in"], c["Step"], c["Modes"], c["Modes"], c["Variables"], c["Width_time"],
                  device=device, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(w)
    return model


def initial_conditions(cell, seed, what, n, device):
    """n initial windows [n, V, Nx, Ny, T_in] of the stream `what`."""
    c = cell.config
    return fields.smooth(fields.generator(seed, what, device),
                         (n, c["Variables"], c["Nx"], c["Ny"], c["T_in"]),
                         cell.traffic["inputs"], device)


class Seen:
    """A residual operator that keeps the fields of its calls while `on`."""

    def __init__(self, fn):
        self.fn, self.on, self.fields = fn, False, None

    def __call__(self, f):
        if self.on:
            self.fields = f
        return self.fn(f)


def calibrated_surrogate(cell, seed, device):
    """The program's calibrated surrogate and what the check needs of its
    set-up: the weights, the calibration inputs and rollout."""
    from cppre_torch.deploy import CalibratedSurrogate
    from cppre_torch.train.normalizers import MinMaxNormalizer

    c, cp = cell.config, cell.config["cp"]
    w = weights(cell, seed, device)
    model = port_model(cell, w, device).eval()
    cal_a = initial_conditions(cell, seed, "calibration", c["n_cal"], device)
    seen = Seen(cell.port_residual())
    srv = CalibratedSurrogate(model, seen, step=c["Step"], T_out=c["T_out"],
                              in_normalizer=MinMaxNormalizer(cal_a),
                              out_normalizer=MinMaxNormalizer(cal_a), mode=cp["mode"],
                              score=cp["score"], fused=True)
    seen.on = True
    srv.calibrate(cal_a, alpha=cp["alpha"], eps=cp["eps"])
    seen.on = False
    return srv, {"weights": w, "cal_a": cal_a, "cal_rollout": seen.fields}


def calibration_answers(srv, setup):
    return dict(setup, qhat=srv.qhat, modulation=srv.modulation, scores=srv.scores)


def _rows(cell):
    return int(cell.traffic["check"]["rows"])


def to_fno(convops):
    """[B, V, Nt, Nx, Ny] -> [B, V, Nx, Ny, Nt]."""
    return convops.permute(0, 1, 3, 4, 2)


@torch.no_grad()
def stepwise_gap(cell, w, norm, a, pred):
    """Each step of the rollout `pred` [B, V, Nx, Ny, T_out] (decoded) of
    initial windows `a`, against the reference's step from the frames
    before it: max |gap| / max |frames|, in the encoded units the model
    sees, the worst of each step in each block of rows; inf where `pred`
    is not finite."""
    c, n = cell.config, _rows(cell)
    t_in, step = c["T_in"], c["Step"]
    if not bool(torch.isfinite(pred).all()):
        return math.inf
    worst = 0.0
    for i in range(0, a.shape[0], n):
        full = torch.cat((norm.encode(a[i:i + n]), norm.encode(pred[i:i + n])), dim=-1)
        for j in range(0, c["T_out"], step):
            ref = ref_fno.forward(w, full[..., j:j + t_in], c)
            worst = max(worst, _rel(full[..., t_in + j:t_in + j + step], ref))
    return worst


@torch.no_grad()
def reference_rollout(cell, w, norm, a, lowp=False):
    """The reference's decoded rollout of initial windows `a`, in blocks of rows."""
    n = _rows(cell)
    return torch.cat([norm.decode(ref_fno.rollout(w, norm.encode(a[i:i + n]), cell.config, lowp))
                      for i in range(0, a.shape[0], n)])


@torch.no_grad()
def reference_residual(cell, pred, lowp=False):
    """The reference residual of fields [B, V, Nx, Ny, Nt], in blocks of
    rows; with `lowp` (the control) of the fields rounded to TF32."""
    res, n = cell.reference_residual(), _rows(cell)
    return torch.cat([res(tf32(ref_fno.to_convops(pred[i:i + n]), lowp))
                      for i in range(0, pred.shape[0], n)])


def _worst(a, b):
    """The larger of two gaps; inf where either is not finite."""
    return max(a, b) if math.isfinite(a) and math.isfinite(b) else math.inf


def _rel(got, ref):
    """max |got - ref| / max |ref|, inf where got holds a non-finite value."""
    got = got.double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - ref.double()).abs().amax()) / float(ref.double().abs().amax())


@torch.no_grad()
def compare(cell, ans, field_of, device):
    """The served numbers. From the calibration: its rollout step by step,
    the modulation, scores and qhat worked out again from it. For each kept
    request: the rollout step by step where it rolled out, the residual of
    the field it judged (`field_of(req)`), the sets, and the accept flags
    (a flip counts where the reference's score lies outside `accept_band`
    of qhat). `ans` holds "weights", "cal_a", "cal_rollout", "qhat",
    "modulation", "scores" and "requests"."""
    c, band = cell.config, float(cell.limits["accept_band"])
    w, norm = ans["weights"], ref_fno.MinMax(ans["cal_a"])
    cal_pred = to_fno(ans["cal_rollout"])
    nums = {"calibration_rollout": stepwise_gap(cell, w, norm, ans["cal_a"], cal_pred)}
    res_cal = reference_residual(cell, cal_pred)
    qhat, mod = ref_cp.calibrate(res_cal, c["cp"]["alpha"])
    mod = mod + c["cp"]["eps"]
    gap = abs(float(ans["qhat"]) - float(qhat)) / float(qhat)
    nums.update(qhat=gap if math.isfinite(gap) else math.inf,
                modulation=_rel(ans["modulation"], mod),
                scores=_rel(ans["scores"], ref_cp.scores_of(res_cal, mod)))
    del res_cal, cal_pred
    width = (qhat * mod).float()
    for req in ans["requests"]:
        got = {}
        if "prediction" in req:
            got["prediction"] = stepwise_gap(cell, w, norm, req["inputs"], req["prediction"])
        res = reference_residual(cell, field_of(req))
        got["residual"] = _rel(req["residual"], res)
        got["sets"] = _worst(_rel(req["hi"], width.expand_as(req["hi"])),
                             _rel(req["lo"], -width.expand_as(req["lo"])))
        score = ref_cp.scores_of(res, mod) / qhat
        sure = (score - 1).abs() > band
        flips = (req["accept"].to(device) != (score <= 1)) & sure
        got["accept_flips"] = float(flips.sum())
        for k, v in got.items():
            nums[k] = _worst(nums.get(k, 0.0), v)
        del res
    return nums


@torch.no_grad()
def control_answers(cell, seed, device, judged):
    """The reference at TF32 in the program's place, on the inputs of a run
    of `seed`: its calibration and answers for [(inputs, judged field or
    None)] (None: it serves the inputs' rollout). Returns answers for
    `compare`."""
    c = cell.config
    w = weights(cell, seed, device)
    cal_a = initial_conditions(cell, seed, "calibration", c["n_cal"], device)
    norm = ref_fno.MinMax(cal_a)
    cal_pred = reference_rollout(cell, w, norm, cal_a, lowp=True)
    res_cal = reference_residual(cell, cal_pred, lowp=True)
    qhat, mod = ref_cp.calibrate(res_cal, c["cp"]["alpha"])
    mod = mod + c["cp"]["eps"]
    width = (qhat * mod).float()
    reqs = []
    for a, field in judged:
        req = {}
        if field is None:
            field = req["prediction"] = reference_rollout(cell, w, norm, a, lowp=True)
            req["inputs"] = a
        else:
            req["field"] = field
        res = reference_residual(cell, field, lowp=True)
        req.update(residual=res, lo=-width.expand_as(res), hi=width.expand_as(res),
                   accept=(ref_cp.scores_of(res, mod) <= qhat))
        reqs.append(req)
    return {"weights": w, "cal_a": cal_a, "cal_rollout": ref_fno.to_convops(cal_pred),
            "qhat": qhat, "modulation": mod, "scores": ref_cp.scores_of(res_cal, mod),
            "requests": reqs}
