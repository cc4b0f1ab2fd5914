"""Spawned gloo ranks for the port's parallel-layer tests.

`World(n, tmp_dir)` starts n processes (`python tests/torch_ranks.py rank
n store`), each a rank of one gloo group over a FileStore under `tmp_dir`
(no port, so concurrent test workers cannot clash), torch on one thread.
`world.call("case", *args)` runs `case_<case>(*args)` from this module on
every rank and returns the ranks' results in rank order; a rank's
exception is raised in the caller with its traceback. The ranks stay up
for many calls. They import only torch, numpy and `cppre_torch`: this
module imports nothing else at the top, and the cases import the port
inside.

Each case builds what it needs from seeds (numpy) and returns numpy
arrays, so the test process can hold them against `cppre` and against the
port's unsharded functions.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


class World:
    def __init__(self, n: int, tmp_dir: str):
        self.n = n
        store = os.path.join(tmp_dir, f"store_{n}")
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self.logs = [os.path.join(tmp_dir, f"rank_{n}_{r}.log") for r in range(n)]
        self._log_files = [open(log, "w") for log in self.logs]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                        str(n), store],
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                       stderr=self._log_files[r], env=env, cwd=ROOT)
                      for r in range(n)]

    def call(self, case: str, *args, **kwargs) -> list:
        for p in self.procs:
            pickle.dump((case, args, kwargs), p.stdin)
            p.stdin.flush()
        answers = []
        for r, p in enumerate(self.procs):
            try:
                answers.append(pickle.load(p.stdout))
            except EOFError:
                with open(self.logs[r]) as f:
                    raise RuntimeError(f"rank {r} of {self.n} died:\n{f.read()[-4000:]}")
        errors = [f"rank {r}:\n{a[1]}" for r, a in enumerate(answers) if a[0] != "ok"]
        if errors:
            raise RuntimeError(f"case {case!r} failed\n" + "\n".join(errors))
        return [a[1] for a in answers]

    def close(self):
        for p in self.procs:
            try:
                pickle.dump(None, p.stdin)
                p.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
        for f in self._log_files:
            f.close()


# ---- the rank side -----------------------------------------------------------

def mesh(dp, tp=1, names=("dp", "tp")):
    from cppre_torch.parallel import make_mesh

    return make_mesh(dp * tp, dp=dp, tp=tp, axis_names=names, device_type="cpu")


def _np(t):
    import torch

    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def case_calibrate(scores, alpha, dp):
    import torch

    from cppre_torch.parallel import shard_batch, sharded_calibrate

    m = mesh(dp)
    whole = sharded_calibrate(torch.from_numpy(scores), alpha, m)
    split = sharded_calibrate(shard_batch(torch.from_numpy(scores), m), alpha, m)
    return _np(whole), _np(split)


def _ns_fn(centred):
    from cppre_torch.ops.kernels import stencil_kernels as sk

    dt = dx = dy = 0.01
    if centred:
        return lambda t, p: sk._diff_stats_routed(t, p, sk._ns_cell(dt, dx, dy, 1e-3), 1, None,
                                                  "ns", centred=True)
    return lambda t, p: sk.ns_joint_cp_diff_stats(t, p, dt, dx, dy)


def case_cp_scores(truth, pred, dp, centred=False):
    """The sharded scores (gathered), this rank's block length, and the
    sharded qhat at alpha 0.1."""
    import torch

    from cppre_torch.parallel import sharded_calibrate, sharded_fused_cp_scores

    m = mesh(dp)
    scores = sharded_fused_cp_scores(_ns_fn(centred), torch.from_numpy(truth),
                                     torch.from_numpy(pred), m)
    return _np(scores), scores.local.shape[0], _np(sharded_calibrate(scores, 0.1, m))


def case_halo(field, kernel, n, spatial_axis=-2):
    import torch

    from cppre_torch.parallel import stencil_conv_sharded

    m = mesh(n, 1, ("sp", "_"))
    return _np(stencil_conv_sharded(torch.from_numpy(field), kernel, m, axis="sp",
                                    spatial_axis=spatial_axis))


def case_halo_2d(field, kernel, nx, ny):
    import torch

    from cppre_torch.parallel import stencil_conv_sharded_2d

    m = mesh(nx, ny, ("spx", "spy"))
    out = stencil_conv_sharded_2d(torch.from_numpy(field), kernel, m, axes=("spx", "spy"))
    return _np(out), tuple(out.local.shape)


def case_halo_too_wide(field, kernel, n):
    import torch

    from cppre_torch.parallel import stencil_conv_sharded_2d

    m = mesh(n, 1, ("spx", "_"))
    try:
        stencil_conv_sharded_2d(torch.from_numpy(field), kernel, m, axes=("spx", "_"))
    except ValueError as e:
        return str(e)
    return None


def case_fft(x, n):
    import torch

    from cppre_torch.parallel import fft2_sharded, ifft2_sharded

    m = mesh(n, 1, ("sp", "_"))
    X = fft2_sharded(torch.from_numpy(x), m, axis="sp")
    back = ifft2_sharded(X, m, axis="sp")
    return _np(X), _np(back), tuple(X.local.shape), tuple(back.local.shape)


def case_spectral_conv(field, kernel, n):
    import torch

    from cppre_torch.parallel import spectral_circular_conv_sharded

    m = mesh(n, 1, ("sp", "_"))
    return _np(spectral_circular_conv_sharded(torch.from_numpy(field), kernel, m, axis="sp"))


def _fno(state, cfg):
    import torch

    from cppre_torch.models import FNO2d

    model = FNO2d(*cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def case_pp(state, cfg, x, dp, pp, grad=False):
    """make_pp_fno_apply over a ('dp', 'pp') mesh: the output and, with
    grad, the input gradient of sum(out**2)."""
    import torch

    from cppre_torch.parallel import make_pp_fno_apply, pp_supported

    m = mesh(dp, pp, ("dp", "pp"))
    assert pp_supported(m)
    f = make_pp_fno_apply(_fno(state, cfg), m, dp_axis="dp" if dp > 1 else None)
    xt = torch.from_numpy(x).requires_grad_(grad)
    out = f(xt)
    if not grad:
        return _np(out), None
    (out ** 2).sum().backward()
    return _np(out), _np(xt.grad)


def case_param_report(cfg, dp, tp):
    from cppre_torch.models import FNO2d
    from cppre_torch.parallel import fno_param_shardings

    m = mesh(dp, tp)
    _, log = fno_param_shardings(FNO2d(*cfg, device="cpu"), m, report=True)
    return log


def case_train_step(state, cfg, xx, yy, dp, steps=1):
    """One sharded train step and one unsharded one from the same weights:
    (sharded loss, full loss, weights), (the same unsharded)."""
    import torch

    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.parallel import make_sharded_train_step
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss

    out = []
    for sharded in (True, False):
        model = _fno(state, cfg)
        opt = make_optimizer(model.parameters(), 1e-3)
        apply_fn = make_fused_train_apply(model)
        step_fn = (make_sharded_train_step(apply_fn, opt, 1, yy.shape[-1], lp_loss, mesh(dp))
                   if sharded else make_train_step(apply_fn, opt, 1, yy.shape[-1], lp_loss))
        for _ in range(steps):
            loss, full = step_fn(torch.from_numpy(xx), torch.from_numpy(yy))
        out.append((float(loss), float(full),
                    {k: _np(v) for k, v in model.state_dict().items()}))
    return out


_WAVE_CFG = {"Epochs": 2, "Nx": 24, "Modes": 4, "Width_time": 8, "Batch Size": 10,
             "n_train": 10, "n_cal": 26, "n_pred": 9, "T_out": 10}


def case_run_2d_cp(dp):
    """wave.run unsharded, then with mesh= on its trained weights."""
    from cppre_torch.experiments import wave

    r1 = wave.run("joint", config=dict(_WAVE_CFG), verbose=False, eps=1e-3, device="cpu")
    r2 = wave.run("joint", config=dict(_WAVE_CFG), verbose=False, eps=1e-3, device="cpu",
                  params=r1["model"].state_dict(), mesh=mesh(dp))
    keys = ("qhat", "coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout",
            "pred_cal", "pred_pred")
    return [{k: _np(r[k]) for k in keys} for r in (r1, r2)]


def _surrogate_inputs(seed=0, n=11, nvar=3, nx=16, t_in=1, t_out=4):
    import torch

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, nvar, nx, nx, t_in)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((n, nvar, nx, nx, t_out)).astype(np.float32))
    return a, u


def case_surrogate(state, cfg, dp, tmp_dir):
    """CalibratedSurrogate unsharded and with mesh= (and its save/load with
    mesh=): (qhat, prediction, residual, accept) of each."""
    from cppre_torch.deploy import CalibratedSurrogate
    from cppre_torch.residuals.ns import PRE_NS

    a, u = _surrogate_inputs()
    pre = PRE_NS(0.01, 0.01, 0.01, nu=1e-3)
    out = []
    for m in (None, mesh(dp)):
        srv = CalibratedSurrogate(_fno(state, cfg), pre.residual_momentum, step=1,
                                  T_out=u.shape[-1], score="aer+pre", fused=True, mesh=m)
        srv.calibrate(a[:7], u[:7], alpha=0.2, eps=1e-6)
        served = srv.predict(a[7:])
        out.append((_np(srv.qhat), _np(served["prediction"]), _np(served["residual"]),
                    _np(served["accept"])))
        if m is not None:
            import torch.distributed as dist

            prefix = os.path.join(tmp_dir, f"srv_rank{dist.get_rank()}")
            srv.save(prefix)
            back = CalibratedSurrogate.load(prefix, _fno(state, cfg), pre.residual_momentum,
                                            fused=True, mesh=m)
            served = back.predict(a[7:])
            out.append((_np(back.qhat), _np(served["prediction"]), _np(served["residual"]),
                        _np(served["accept"])))
    return out


def case_uq(state, cfg, dp, methods):
    """evaluate_uq_methods unsharded and with mesh= on one model."""
    from cppre_torch.residuals.ns import PRE_NS
    from cppre_torch.uq.eval import evaluate_uq_methods

    a, u = _surrogate_inputs(seed=1, n=9)
    pre = PRE_NS(0.01, 0.01, 0.01, nu=1e-3)

    class _Pre:
        def residual(self, fields):
            return pre.residual_momentum(fields)

    model = _fno(state, cfg)
    kw = dict(methods=methods, model_factory=lambda uq: (model, None), test_a=a, test_u=u,
              step=1, T_out=u.shape[-1], runs=2, n_eval=7, pre=_Pre(), verbose=False)
    return [evaluate_uq_methods(**kw), evaluate_uq_methods(**kw, mesh=mesh(dp))]


def case_mesh_shape(dp, tp):
    m = mesh(dp, tp)
    return dict(m.shape), m.index("dp"), m.index("tp"), str(m.device)


def _serve(rank: int, world: int, store: str):
    import datetime

    import torch
    import torch.distributed as dist

    proto = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)              # prints go to the log, not into the protocol
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    cases = {k[len("case_"):]: v for k, v in globals().items() if k.startswith("case_")}
    while True:
        try:
            msg = pickle.load(sys.stdin.buffer)
        except EOFError:
            break
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            answer = ("ok", cases[name](*args, **kwargs))
        except Exception:
            answer = ("err", traceback.format_exc())
        pickle.dump(answer, proto)
        proto.flush()
    dist.destroy_process_group()


if __name__ == "__main__":
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
