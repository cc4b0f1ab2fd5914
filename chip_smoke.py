#!/usr/bin/env python3
"""Drive the PyTorch port (`cppre_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Runs the NS joint-CP flagship's serving path at full width — FNO2d(T_in=1,
step=1, modes 8x8, 3 variables, width 16: 6 Fourier blocks and a 256-wide
head) on a 100x100 grid, T_out=20, n_cal = n_pred = 100, random weights
from a seed — through the four hand-written CUDA kernels, and holds every
kernel against its plain PyTorch version. Phases, one line each:

  build      compile the kernels from `cppre_torch/csrc` (nvcc, in parallel)
  device     the card, and its name and power limit from nvidia-smi
  kernels    K1, K2, K4, K5 against their plain versions at the flagship
             shapes: max abs / relative error and median times (CUDA events)
  serve      CalibratedSurrogate(fused=True, score='aer+pre', mode='joint'):
             calibrate on 100 samples, predict 100
  calibrate  the same calibration scores through K1 (ns_joint_cp_scores_fused)
             must give the surrogate's qhat within 1e-3
  invariance a sample's fused forward is bitwise the same at batch 7 and 100,
             and the fused rollout agrees with the plain model's
  pipeline   the joint-CP calibration pipeline at [100, 3, 21, 100, 100],
             kernel against plain

The launch counters are set to 0 before `serve` and read after `calibrate`:
every kernel must have launched in that window. Then one JSON line of
kernel results, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the script exits non-zero without that line; it
also refuses to run where CUDA is unavailable. Data is synthetic, made
with numpy from a seed; TF32 is switched off throughout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the NS flagship (cppre/experiments/ns.py), after slicing
T_IN, STEP, T_OUT, MODES, NVAR, WIDTH = 1, 1, 20, 8, 3, 16
NX = NY = 100
N_CAL = N_PRED = 100
N_ALL = 300
DT = DX = DY = 0.01
NU = 1e-3
ALPHA, EPS = 0.1, 1e-6
SEED = 0
REPS = 15

KERNEL_INFO = {
    "K1": ("ns_joint_cp_diff_stats", "cppre_torch/csrc/stencil_kernels.cu",
           "cppre/ops/pallas/stencil_kernels.py:460"),
    "K2": ("ns_momentum_residual_fused", "cppre_torch/csrc/stencil_kernels.cu",
           "cppre/ops/pallas/stencil_kernels.py:305"),
    "K4": ("fno_block2d_fused", "cppre_torch/csrc/fno_block.cu",
           "cppre/ops/pallas/fno_block.py:106"),
    "K5": ("projection2d_fused", "cppre_torch/csrc/fno_block.cu",
           "cppre/ops/pallas/fno_block.py:596"),
}


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smooth_fields(n, nt, nx, ny, seed, layout="convops"):
    """Smooth-plus-noise fields (the form bench.py times): sin(2 pi x)
    cos(2 pi y) exp(-t) + 0.05 N(0, 1), and a prediction 0.01 N(0, 1) away.
    layout 'convops' is [n, 3, nt, nx, ny]; 'fno' is [n, 3, nx, ny, nt]."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx, dtype=np.float32)
    y = np.linspace(0, 1, ny, dtype=np.float32)
    t = np.linspace(0, 1, nt, dtype=np.float32)
    base = (np.sin(2 * np.pi * x)[:, None, None] * np.cos(2 * np.pi * y)[None, :, None]
            * np.exp(-t)[None, None, :]).astype(np.float32)          # [nx, ny, nt]
    if layout == "convops":
        base = np.moveaxis(base, -1, 0)
    fields = np.broadcast_to(base, (n, NVAR) + base.shape).copy()
    fields += 0.05 * rng.standard_normal(fields.shape, dtype=np.float32)
    pred = fields + 0.01 * rng.standard_normal(fields.shape, dtype=np.float32)
    return fields, pred


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of `fn` over `reps` runs, CUDA events around each,
    after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, ref, rel_tol):
    """max |got - ref| and its ratio to max |ref|; raises above rel_tol."""
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, "
                             f"or non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / max(scale, 1e-30)
    if rel > rel_tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} = {rel:.3e} of max |plain| "
                             f"{scale:.3e}, above {rel_tol:g}")
    return err, rel


def build_model(device):
    import torch
    from cppre_torch.models import FNO2d

    gen = torch.Generator().manual_seed(SEED)
    return FNO2d(T_IN, STEP, MODES, MODES, NVAR, WIDTH, device=device, generator=gen).eval()


def phase_kernels(model, device):
    """Each kernel against its plain version at the flagship shapes."""
    import torch
    from cppre_torch.cp import calibrate
    from cppre_torch.models.fno import get_grid
    from cppre_torch.ops import kernels as K

    out = {}
    truth_np, pred_np = smooth_fields(N_CAL, T_OUT + 1, NX, NY, SEED + 1)
    truth = torch.from_numpy(truth_np).to(device)
    pred = torch.from_numpy(pred_np).to(device)
    del truth_np, pred_np
    args = (DT, DX, DY, NU)

    # K2 on the served layout [100, 3, 20, 100, 100]
    f20 = truth[:, :, :T_OUT].contiguous()
    got = K.ns_momentum_residual_fused(f20, *args)
    ref = K.ns_momentum_residual_plain(f20, *args)
    err, rel = compare("K2", got, ref, 1e-5)
    out["K2"] = dict(max_abs_err=err, rel_err=rel,
                     ms=cuda_ms(lambda: K.ns_momentum_residual_fused(f20, *args)),
                     plain_ms=cuda_ms(lambda: K.ns_momentum_residual_plain(f20, *args)))
    del f20, got, ref

    # K1 on the bench layout [100, 3, 21, 100, 100]
    d, s, q = K.ns_joint_cp_diff_stats(truth, pred, *args)
    d0, s0, q0 = K.ns_joint_cp_diff_stats_plain(truth, pred, *args)
    err, rel = compare("K1 diff", d, d0, 1e-5)
    compare("K1 sum", s, s0, 1e-5)
    compare("K1 sumsq", q, q0, 1e-5)
    sc = K.ns_joint_cp_scores_fused(truth, pred, *args, eps=EPS)
    sc0 = K.ns_joint_cp_scores_plain(truth, pred, *args, eps=EPS)
    compare("K1 scores", sc, sc0, 1e-5)
    qh, qh0 = calibrate(sc, N_CAL, ALPHA), calibrate(sc0, N_CAL, ALPHA)
    compare("K1 qhat", qh, qh0, 1e-5)
    bf = torch.bfloat16
    qb = calibrate(K.ns_joint_cp_scores_fused(truth, pred, *args, eps=EPS, diff_dtype=bf),
                   N_CAL, ALPHA)
    qb0 = calibrate(K.ns_joint_cp_scores_plain(truth, pred, *args, eps=EPS, diff_dtype=bf),
                    N_CAL, ALPHA)
    _, rel_bf = compare("K1 bf16 qhat", qb, qb0, 1e-3)
    out["K1"] = dict(max_abs_err=err, rel_err=rel, qhat=float(qh), qhat_bf16=float(qb),
                     bf16_vs_plain_bf16=rel_bf,
                     bf16_vs_f32=abs(float(qb) - float(qh)) / abs(float(qh)),
                     ms=cuda_ms(lambda: K.ns_joint_cp_diff_stats(truth, pred, *args)),
                     plain_ms=cuda_ms(lambda: K.ns_joint_cp_diff_stats_plain(truth, pred,
                                                                             *args)))
    del truth, pred, d, s, q, d0, s0, q0

    # K4 and K5 with the flagship model's weights, on random activations
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn((N_CAL, WIDTH, NVAR, NX, NY), generator=gen, device=device)
    blk = model.f0
    grid_c = get_grid((1, NVAR, NX, NY), device).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        x3 = blk.b(grid_c).contiguous()
        got = K.fno_block2d_fused(x, blk, x3, MODES, MODES)
        ref = K.fno_block2d_plain(x, blk, x3, MODES, MODES)
        err, rel = compare("K4", got, ref, 1e-4)
        out["K4"] = dict(max_abs_err=err, rel_err=rel,
                         ms=cuda_ms(lambda: K.fno_block2d_fused(x, blk, x3, MODES, MODES)),
                         plain_ms=cuda_ms(lambda: K.fno_block2d_plain(x, blk, x3, MODES,
                                                                       MODES)))
        del x, got, ref
        z = torch.randn((N_CAL, NVAR, NX, NY, WIDTH), generator=gen, device=device)
        fc1, fc2 = model.fc1_time, model.fc2_time
        got = K.projection2d_fused(z, fc1, fc2)
        ref = K.projection2d_plain(z, fc1, fc2)
        err, rel = compare("K5", got, ref, 1e-4)
        out["K5"] = dict(max_abs_err=err, rel_err=rel,
                         ms=cuda_ms(lambda: K.projection2d_fused(z, fc1, fc2)),
                         plain_ms=cuda_ms(lambda: K.projection2d_plain(z, fc1, fc2)))
        del z, got, ref
    torch.cuda.empty_cache()
    for k in ("K1", "K2", "K4", "K5"):
        r = out[k]
        say("kernels", kernel=k, max_abs_err=f"{r['max_abs_err']:.3e}",
            rel_err=f"{r['rel_err']:.3e}", ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            **({"qhat_bf16_vs_plain_bf16": f"{r['bf16_vs_plain_bf16']:.3e}",
                "qhat_bf16_vs_f32": f"{r['bf16_vs_f32']:.3e}"} if k == "K1" else {}))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cppre_torch.cp import calibrate
    from cppre_torch.deploy import CalibratedSurrogate
    from cppre_torch.models import fno2d_forward_fused
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import _build
    from cppre_torch.train import MinMaxNormalizer, autoregressive_rollout

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = _build.build()
    say("build", sources=len(_build.SOURCES), seconds=f"{secs:.1f}", dir=_build.BUILD_DIR)
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", kind=repr(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    model = build_model(device)
    results = phase_kernels(model, device)

    # ---- serve: the main path ------------------------------------------
    data_np, _ = smooth_fields(N_ALL, T_IN + T_OUT, NX, NY, SEED + 3, layout="fno")
    data = torch.from_numpy(data_np).to(device)
    del data_np
    in_n = MinMaxNormalizer(data[..., :T_IN])
    out_n = MinMaxNormalizer(data[..., T_IN:])
    cal_a, cal_u = data[N_CAL:2 * N_CAL, ..., :T_IN], data[N_CAL:2 * N_CAL, ..., T_IN:]
    new_a = data[2 * N_CAL:, ..., :T_IN]

    def residual_fn(fields):
        return K.ns_momentum_residual_fused(fields, DT, DX, DY, NU)

    srv = CalibratedSurrogate(model, residual_fn, step=STEP, T_out=T_OUT, in_normalizer=in_n,
                              out_normalizer=out_n, mode="joint", score="aer+pre", fused=True)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.calibrate(cal_a, cal_u, alpha=ALPHA, eps=EPS)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = srv.predict(new_a)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    pred, accept = served["prediction"], served["accept"]
    if pred.shape != (N_PRED, NVAR, NX, NY, T_OUT) or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"served prediction {tuple(pred.shape)} is not finite "
                             f"[{N_PRED}, {NVAR}, {NX}, {NY}, {T_OUT}]")
    qhat = float(srv.qhat)
    if not np.isfinite(qhat) or qhat <= 0:
        raise AssertionError(f"qhat {qhat} is not a positive finite score")
    counts = K.launch_counts()
    say("serve", qhat=f"{qhat:.6e}", accept_rate=f"{float(accept.float().mean()):.3f}",
        calibrate_s=f"{t_cal:.3f}", predict_s=f"{t_pred:.3f}",
        launches=json.dumps(counts, separators=(",", ":")))
    want = {"K2": 3, "K4": 6 * (T_OUT // STEP) * 2, "K5": (T_OUT // STEP) * 2}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"serve launches {counts}, expected {want}: the fused path "
                             f"was not taken")

    # ---- calibrate through K1: the same scores, one pass ---------------
    truth_c = srv.layout_fn(cal_u)
    pred_c = srv.layout_fn(srv.predict(cal_a)["prediction"])
    scores = K.ns_joint_cp_scores_fused(truth_c, pred_c, DT, DX, DY, NU, eps=EPS)
    q_k1 = float(calibrate(scores, N_CAL, ALPHA))
    rel = abs(q_k1 - qhat) / qhat
    counts = K.launch_counts()
    say("calibrate", qhat_k1=f"{q_k1:.6e}", qhat_surrogate=f"{qhat:.6e}", rel=f"{rel:.3e}",
        launches=json.dumps(counts, separators=(",", ":")))
    if rel > 1e-3:
        raise AssertionError(f"K1 qhat {q_k1} vs surrogate qhat {qhat}: {rel:.3e} > 1e-3")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the main path")
    del truth_c, pred_c

    # ---- invariance: batch 7 vs batch 100, and fused vs plain -----------
    x = in_n.encode(new_a).contiguous()
    y100 = fno2d_forward_fused(model, x)
    y7 = fno2d_forward_fused(model, x[:7].contiguous())
    same = bool(torch.equal(y7, y100[:7]))
    with torch.no_grad():
        plain = out_n.decode(autoregressive_rollout(model, in_n.encode(new_a[:4]), STEP, T_OUT))
    err, rel = compare("fused vs plain rollout", pred[:4], plain, 1e-4)
    say("invariance", bitwise_batch7_vs_100=same, rollout_fused_vs_plain_rel=f"{rel:.3e}")
    if not same:
        raise AssertionError("the fused forward of a sample depends on the batch size")
    del x, y100, y7, data

    # ---- the joint-CP calibration pipeline, kernel vs plain ------------
    truth_np, predb_np = smooth_fields(N_CAL, T_OUT + 1, NX, NY, SEED + 1)
    tb, pb = torch.from_numpy(truth_np).to(device), torch.from_numpy(predb_np).to(device)
    del truth_np, predb_np
    pipe_k = lambda: calibrate(K.ns_joint_cp_scores_fused(tb, pb, DT, DX, DY, NU, eps=EPS),
                               N_CAL, ALPHA)
    pipe_p = lambda: calibrate(K.ns_joint_cp_scores_plain(tb, pb, DT, DX, DY, NU, eps=EPS),
                               N_CAL, ALPHA)
    say("pipeline", shape=list(tb.shape), ms=f"{cuda_ms(pipe_k):.4f}",
        plain_ms=f"{cuda_ms(pipe_p):.4f}")

    kernels = []
    final_counts = counts
    for k, (name, src, rep) in KERNEL_INFO.items():
        r = results[k]
        kernels.append({"name": f"{name} ({k})", "route": "cuda", "source": src,
                        "replaces": rep, "launches": final_counts[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
