#!/usr/bin/env python3
"""Drive the PyTorch port (`cppre_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Runs the NS joint-CP flagship at full width — FNO2d(T_in=1, step=1, modes
8x8, 3 variables, width 16: 6 Fourier blocks and a 256-wide head) on a
100x100 grid, T_out=20 — through the six hand-written CUDA kernels, and
holds every kernel against its plain PyTorch version. Two main paths:
serving (random weights from a seed, synthetic fields, n_cal = n_pred =
100) and training (the flagship experiment `cppre_torch.experiments.ns.run`
itself: spectral-solver data, training, CP). Phases, one line each:

  build      compile the kernels from `cppre_torch/csrc` (nvcc, in parallel);
             then one `ptxas` line per kernel function: registers and spills
  device     the card, and its name and power limit from nvidia-smi
  kernels    K1, K2, K4, K5 at the serving shapes and K6, K7 at the training
             shapes against their plain versions: max abs / relative error,
             median times (CUDA events), the bound from bytes and operations
  serve      CalibratedSurrogate(fused=True, score='aer+pre', mode='joint'):
             calibrate on 100 samples, predict 100
  calibrate  the same calibration scores through K1 (ns_joint_cp_scores_fused)
             must give the surrogate's qhat within 1e-3
  invariance a sample's fused forward is bitwise the same at batch 7 and 100,
             and the fused rollout agrees with the plain model's
  pipeline   the joint-CP calibration pipeline at [100, 3, 21, 100, 100],
             kernel against plain
  train      ns.run("joint", Epochs=2): 300 solver runs at N=400 sliced to
             100x100x21, 2 epochs x 20 steps at batch 5 through K4-K7, CP;
             solver seconds, losses, qhat, coverage at alpha=0.1, then the
             launches and median ms of one train step
  profile    one train step under torch.profiler: device ms, the idle share
             against the unprofiled median step time, and the ten largest
             kernels
  parity     one train step through K4-K7 and through plain autograd from
             the same weights and batch: the loss and every gradient agree

The launch counters are set to 0 before each main path (serve + calibrate;
train) and read after it: every kernel of that path must have launched in
its window. Then one JSON line of kernel results, the card's name and power
limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the script exits non-zero without that line; it
also refuses to run where CUDA is unavailable. Data is made from seeds;
TF32 is switched off throughout.
"""

from __future__ import annotations

import json
import os
import re
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
TRAIN_BATCH, TRAIN_EPOCHS = 5, 2        # the flagship's batch; epochs cut to 2
W_PROJ = 256                            # FNO2d's projection width

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# float32 outside the tensor cores. A bound is the larger of bytes / HBM
# (each input read once, each output written once) and flops / F32.
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# flops of the NS momentum residual per interior cell (two components of
# five terms each: 45 adds and multiplies, cppre_torch/ops/kernels/
# stencil_kernels.py::_ns_momentum_math)
NS_RES_FLOPS = 45

KERNEL_INFO = {
    "K1": ("ns_joint_cp_diff_stats", "cppre_torch/csrc/stencil_kernels.cu",
           "cppre/ops/pallas/stencil_kernels.py:460"),
    "K2": ("ns_momentum_residual_fused", "cppre_torch/csrc/stencil_kernels.cu",
           "cppre/ops/pallas/stencil_kernels.py:305"),
    "K4": ("fno_block2d_fused", "cppre_torch/csrc/fno_block.cu",
           "cppre/ops/pallas/fno_block.py:106"),
    "K5": ("projection2d_fused", "cppre_torch/csrc/fno_block.cu",
           "cppre/ops/pallas/fno_block.py:596"),
    "K6": ("fno_block2d_bwd_fused", "cppre_torch/csrc/fno_block_bwd.cu",
           "cppre/ops/pallas/fno_block.py:322"),
    "K7": ("projection2d_bwd_fused", "cppre_torch/csrc/fno_block_bwd.cu",
           "cppre/ops/pallas/fno_block.py:650"),
}
SERVE_KERNELS = ("K1", "K2", "K4", "K5")
TRAIN_KERNELS = ("K2", "K4", "K5", "K6", "K7")


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


def _kernel_name(mangled):
    """A mangled kernel name as name<template ints>, its namespaces dropped:
    _ZN<ns>20block_bwd_row_kernelILi16EEEv... -> block_bwd_row_kernel<16>."""
    rest = mangled[2:] if mangled.startswith("_Z") else mangled
    nested = rest.startswith("N")
    rest, name = rest[1:] if nested else rest, None
    while (m := re.match(r"\d+", rest)):
        n = int(m.group())
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
        if not nested:
            break
    if name is None:
        return mangled[:60]
    t = re.match(r"I((?:Li-?\d+E)+)E", rest)
    return f"{name}<{','.join(re.findall(r'Li(-?\d+)E', t.group(1)))}>" if t else name


def ptxas_summary(report):
    """{kernel: {registers, spill_stores, spill_loads}} from a `ptxas -v`
    report: each figure belongs to the function named on the 'Function
    properties for' line before it."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if fn is not None and m:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if fn is not None and m:
            out[fn] = {"registers": int(m.group(1)), **out[fn]}
    return {k: v for k, v in out.items() if "registers" in v}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops):
    """(bound ms, what bounds it): the larger of bytes over HBM bandwidth
    and flops over the float32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fno_block_macs(b, w, v, nx, ny, m, backward=False):
    """Multiply-adds of one Fourier block (K4) at modes m x m, K = 2m: the
    forward DFT y then x, the complex mix, the inverse x then y, the MLP
    and bypass. The backward (K6) recomputes all of it, runs each transform
    and the mix once more as its adjoint (plus the spectral weight grads),
    and adds 3 W x W maps (dh, dspec, dx) and 3 W x W grad sums per pixel."""
    k, planes, pix = 2 * m, b * w * v, b * v * nx * ny
    dft = planes * (nx * ny * m * 2 + m * k * nx * 4)
    mix = b * v * w * m * k * w * 4
    inv = b * v * nx * w * m * k * 2 + pix * w * m * 2
    pointwise = pix * 3 * w * w
    fwd = dft + mix + inv + pointwise
    return fwd + dft + 2 * mix + inv + pix * 6 * w * w if backward else fwd


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
    cells = ref.numel()
    out["K2"] = dict(max_abs_err=err, rel_err=rel,
                     bound=bound(nbytes(f20, ref), NS_RES_FLOPS * cells),
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
    # two residuals, their difference, and the sum and sum of squares
    out["K1"] = dict(max_abs_err=err, rel_err=rel, qhat=float(qh), qhat_bf16=float(qb),
                     bound=bound(nbytes(truth, pred, d0, s0, q0),
                                 (2 * NS_RES_FLOPS + 4) * d0.numel()),
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
                         bound=bound(nbytes(x, x3, ref),
                                     2 * fno_block_macs(*x.shape[:4], NY, MODES)),
                         ms=cuda_ms(lambda: K.fno_block2d_fused(x, blk, x3, MODES, MODES)),
                         plain_ms=cuda_ms(lambda: K.fno_block2d_plain(x, blk, x3, MODES,
                                                                       MODES)))
        del x, got, ref
        z = torch.randn((N_CAL, NVAR, NX, NY, WIDTH), generator=gen, device=device)
        fc1, fc2 = model.fc1_time, model.fc2_time
        got = K.projection2d_fused(z, fc1, fc2)
        ref = K.projection2d_plain(z, fc1, fc2)
        err, rel = compare("K5", got, ref, 1e-4)
        n_pix = z.numel() // WIDTH
        out["K5"] = dict(max_abs_err=err, rel_err=rel,
                         bound=bound(nbytes(z, ref), 2 * n_pix * W_PROJ * (WIDTH + STEP)),
                         ms=cuda_ms(lambda: K.projection2d_fused(z, fc1, fc2)),
                         plain_ms=cuda_ms(lambda: K.projection2d_plain(z, fc1, fc2)))
        del z, got, ref
    out.update(backward_kernels(model, device, gen))
    torch.cuda.empty_cache()
    for k in KERNEL_INFO:
        r = out[k]
        extra = {}
        if k == "K1":
            extra = {"qhat_bf16_vs_plain_bf16": f"{r['bf16_vs_plain_bf16']:.3e}",
                     "qhat_bf16_vs_f32": f"{r['bf16_vs_f32']:.3e}"}
        elif k in ("K6", "K7"):
            extra = {"weight_grad_rel_err": f"{r['wgrad_rel']:.3e}", "bitwise_rerun": True}
        say("kernels", kernel=k, max_abs_err=f"{r['max_abs_err']:.3e}",
            rel_err=f"{r['rel_err']:.3e}", ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1], **extra)
    return out


def backward_kernels(model, device, gen):
    """K6 and K7 against their plain versions (autograd of the plain block
    and head) at the flagship's training shapes, batch 5. dx and dz must
    agree within 1e-4 of max|plain|; the weight grads within 1e-3, since
    they are sums over the 150 000 pixels of the batch taken in another
    order than autograd's. Two kernel calls must give equal bits."""
    import torch
    from cppre_torch.models.fno import get_grid
    from cppre_torch.ops import kernels as K

    out = {}
    shape = (TRAIN_BATCH, WIDTH, NVAR, NX, NY)
    x = torch.randn(shape, generator=gen, device=device)
    g = torch.randn(shape, generator=gen, device=device)
    blk = model.f0
    grid_c = get_grid((1, NVAR, NX, NY), device).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        x3 = blk.b(grid_c).contiguous()
    z = torch.randn((TRAIN_BATCH, NVAR, NX, NY, WIDTH), generator=gen, device=device)
    gz = torch.randn((TRAIN_BATCH, NVAR, NX, NY, STEP), generator=gen, device=device)
    fc1, fc2 = model.fc1_time, model.fc2_time
    cases = {
        "K6": (lambda: K.fno_block2d_bwd_fused(x, g, blk, x3, MODES, MODES),
               lambda: K.fno_block2d_bwd_plain(x, g, blk, x3, MODES, MODES),
               bound(nbytes(x, g, x3, x, x3), 2 * fno_block_macs(*shape[:4], NY, MODES, True))),
        "K7": (lambda: K.projection2d_bwd_fused(z, gz, fc1, fc2),
               lambda: K.projection2d_bwd_plain(z, gz, fc1, fc2),
               bound(nbytes(z, gz, z),
                     2 * (z.numel() // WIDTH) * W_PROJ * (3 * WIDTH + 2 * STEP))),
    }
    for k, (kern, plain, bnd) in cases.items():
        got, ref = kern(), plain()
        err, rel = compare(f"{k} d-input", got[0], ref[0], 1e-4)
        w_rel = max(compare(f"{k} grad {i}", a, b, 1e-3)[1]
                    for i, (a, b) in enumerate(zip(got[1:], ref[1:]), 1))
        if not all(torch.equal(a, b) for a, b in zip(got, kern())):
            raise AssertionError(f"{k}: two calls on the same inputs differ")
        out[k] = dict(max_abs_err=err, rel_err=rel, wgrad_rel=w_rel, bound=bnd,
                      ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
        del got, ref
    return out


def phase_train(device):
    """The flagship experiment on the card, Epochs cut to 2: returns the
    launch counts of its run."""
    import torch
    from cppre_torch.experiments import ns
    from cppre_torch.experiments.pipeline import joint_cp
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.ops import kernels as K
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss

    cfg = {"Epochs": TRAIN_EPOCHS}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ns.run("joint", config=cfg, seed=SEED, verbose=False, device=device,
                 return_residuals=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = K.launch_counts()
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the training path")
    c = dict(ns.CONFIG, **cfg)
    steps_per_epoch = c["n_train"] // c["Batch Size"]
    losses = out["train_losses"]
    first, last = losses[0][0], losses[-1][0]
    if not (np.isfinite([v for pair in losses for v in pair]).all() and last < first):
        raise AssertionError(f"training losses {losses}: not finite, or not falling")

    # coverage at alpha = 0.1 of the four estimators, from the run's residuals
    r = (out["res_out_cal"], out["res_pred_cal"], out["res_pred"], out["res_out_pred"])
    at = np.asarray([ALPHA])
    cov = {"aer_pre": joint_cp(*r, alphas=at)["coverage"][0],
           "pre": joint_cp(*r[:3], alphas=at, mode="pre")["coverage"][0],
           "aer_pre_holdout": joint_cp(*r, alphas=at, holdout_modulation=True)["coverage"][0],
           "pre_holdout": joint_cp(*r[:3], alphas=at, mode="pre",
                                   holdout_modulation=True)["coverage"][0]}
    if min(cov["aer_pre_holdout"], cov["pre_holdout"]) < 0.7:
        raise AssertionError(f"holdout coverage at alpha={ALPHA}: {cov}, below 0.7")
    n_sims = c["n_train"] + c["n_cal"] + c["n_pred"]
    say("train", sims=n_sims, solver_N=c["N"], rollout_shape=list(out["pred_cal"].shape[1:]),
        solver_s=f"{out['data_time']:.2f}", train_s=f"{out['train_time']:.2f}",
        run_s=f"{t_run:.2f}", epochs=len(losses), steps_per_epoch=steps_per_epoch,
        loss_first=f"{first:.6f}", loss_last=f"{last:.6f}",
        qhat=f"{float(out['qhat']):.6e}",
        coverage_alpha_0_1=json.dumps({k: round(float(v), 4) for k, v in cov.items()}),
        launches=json.dumps(counts, separators=(",", ":")))

    # one train step of the trained model at batch 5: launches and time
    model = out["model"].train()
    opt = make_optimizer(model.parameters(), c["Learning Rate"])
    step = make_train_step(make_fused_train_apply(model), opt, STEP, T_OUT, lp_loss)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    xx = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_IN), generator=gen, device=device)
    yy = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_OUT), generator=gen, device=device)
    step(xx, yy)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    step(xx, yy)
    torch.cuda.synchronize()
    per_step = K.launch_counts()
    n = T_OUT // STEP
    want = {"K4": 2 * 6 * n, "K5": 2 * n, "K6": 6 * n, "K7": n}
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(xx, yy)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    say("train", step_ms_median=f"{step_ms:.2f}",
        step_ms=json.dumps([round(t, 2) for t in times]),
        launches_per_step=json.dumps(per_step, separators=(",", ":")))
    if any(per_step[k] != v for k, v in want.items()):
        raise AssertionError(f"launches per train step {per_step}, expected {want}")
    profile_step(lambda: step(xx, yy), step_ms)
    del out, model, opt, step
    torch.cuda.empty_cache()
    return counts


def profile_step(fn, step_ms):
    """One call of `fn` under torch.profiler: its wall ms there, the device
    ms summed over kernels, and the ten largest kernels by device ms. The
    idle share is 1 - device ms / step_ms, the unprofiled median wall time
    of the same call, since the profiler's own overhead lengthens the wall
    time it sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name)
            name = re.split(r"[<(]", name, maxsplit=1)[0] or e.name[:40]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    say("profile", what="one train step", profiled_wall_ms=f"{wall:.2f}",
        unprofiled_ms=f"{step_ms:.2f}", device_ms=f"{device:.2f}" if device else "not measured",
        idle_share=f"{1 - device / step_ms:.3f}" if device else "not measured",
        top=json.dumps({k: round(v, 3) for k, v in top}))


def phase_parity(device):
    """One train step from the same weights and batch through K4-K7 and
    through plain `model` autograd: loss within 1e-4, every gradient within
    1e-3 of its max (sums over 150 000 pixels in another order)."""
    import torch
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    xx = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_IN), generator=gen, device=device)
    yy = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_OUT), generator=gen, device=device)
    losses, grads = [], []
    for fused in (True, False):
        model = build_model(device).train()
        fn = make_fused_train_apply(model) if fused else model
        step = make_train_step(fn, make_optimizer(model.parameters(), 5e-3), STEP, T_OUT,
                               lp_loss)
        loss, _ = step(xx, yy)
        losses.append(float(loss))
        grads.append([torch.view_as_real(p.grad) if p.grad.is_complex() else p.grad
                      for p in model.parameters()])
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(compare(f"grad {i}", a, b, 1e-3)[1] for i, (a, b) in enumerate(zip(*grads)))
    say("parity", loss_fused=f"{losses[0]:.7f}", loss_plain=f"{losses[1]:.7f}",
        loss_rel=f"{rel_loss:.3e}", worst_grad_rel=f"{worst:.3e}", n_grads=len(grads[0]))
    if rel_loss > 1e-4:
        raise AssertionError(f"train loss fused {losses[0]} vs plain {losses[1]}")


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
        for fn, info in ptxas_summary(_build.ptxas_report(name)).items():
            say("ptxas", lib=name, kernel=fn, **info)

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
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the serving path")
    serve_counts = counts
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

    del tb, pb
    torch.cuda.empty_cache()
    train_counts = phase_train(device)
    phase_parity(device)

    kernels = []
    for k, (name, src, rep) in KERNEL_INFO.items():
        r = results[k]
        kernels.append({"name": f"{name} ({k})", "route": "cuda", "source": src,
                        "replaces": rep, "launches": serve_counts[k] + train_counts[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": None})
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
