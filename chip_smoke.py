#!/usr/bin/env python3
"""Drive the PyTorch port (`cppre_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Runs four model families of the JAX package at full width through the
hand-written CUDA kernels, and holds every kernel against its plain PyTorch
version:
- NS, the flagship: FNO2d(T_in=1, step=1, modes 8x8, 3 variables, width
  16: 6 Fourier blocks and a 256-wide head) on a 100x100 grid, T_out=20.
  Two main paths: serving (random weights from a seed, synthetic fields,
  n_cal = n_pred = 100) and training (`cppre_torch.experiments.ns.run`
  itself: spectral-solver data, training, CP).
- wave: `experiments.wave.run` at its full CONFIG (1900 solver runs at 64^2,
  FNO width 32, modes 16, one variable, batch 50), then the trained model
  served and calibrated, with the K8 residual.
- MHD: `experiments.mhd.run` at its full CONFIG (300 solver runs at 128^2,
  5000 steps, FNO width 16, modes 8, six variables, batch 5), then the
  trained model served and calibrated, with K2's induction residual, and
  calibrated again through K1 and through K9.
- JOREK: `experiments.jorek.run` at its full CONFIG (300 synthetic-blob
  designs at 32 x 32 x 50, FNO T_in 10, step 10, T_out 40, width 16,
  modes 8, three variables, batch 5), then the trained model served and
  calibrated, with K2's JOREK continuity residual, and calibrated again
  through K1 and the explicit chunked K3.
Training is cut to 2 epochs in all four. Then the 1-D families (1 epoch) and the
offline pipelines, which have no kernel of their own (plain torch, as they
are XLA in the JAX package): `experiments.advection.run` (marginal) and
`experiments.burgers.run` (joint) at their full CONFIG (Nx 200, width 16,
modes 8, 100 samples a split; advection Nt 100, Burgers Nt 21), then
`run_initial("Advection")` at its `Expts_initial` configuration and
`run_offline` on the trained wave model, its normalizers and 200 of its
samples, saved to a temporary directory, through K4 and K5. Then
Grad-Shafranov (no kernel): `experiments.gs.run_freegsnke()` at its full
CONFIG (512 Solov'ev designs at 64^2, 200 epochs at batch 32) with the CAE
and with the INR, and `run_efit()`. Then the UQ comparison harness:
`uq.run_eval.run` at the shipped Wave config (Epochs cut from 500 to 2, all
8 methods), its `Dist: out` rerun for Deterministic and PRE, and NS and MHD
with `UQ: ["PRE"]`, through K4-K7, K8 (wave) and K2 (NS momentum, MHD
energy). Then active learning and physics-informed training at the wave
family's full width: `experiments.pi_wave.run("pi", "finetune")` (n_train
50, one batch; 1 pretrain and 5 PI epochs) with its loss through K8 and
K8's backward (K8 again, on the padded cotangent with the flipped
stencil), `experiments.al_more.run("wave", "CP")` over cppre's pool of 100
candidates (n_train 50, n_cal 100, 1 epoch, 1 iteration), the 1-D AL/PI
drivers at cut counts, and `EulerFVRHS`. Then set propagation and the
neural-ODE studies (no kernel: plain torch, as they are XLA in cppre) and
the training options through K4-K7. Then the joint-CP scores beyond
the flagships: the time-chunked K3 at cppre's grid-scaling shapes (NS and
JOREK [12,3,21,512,512], MHD induction [25,6,21,256,256], wave
[12,26,512,512]) and the flat-layout K10-K12 at the shapes where K1 is
timed. Phases, one line each:

  build      compile the kernels from `cppre_torch/csrc` (nvcc, in parallel);
             then one `ptxas` line per kernel function: registers and spills;
             a spill in any instance of the FNO kernels' stages (K4-K7:
             `FNO_BLOCK_STAGES`) or of K1's, K2's, K3's, K8's, K9's, K10's,
             K11's and K12's bodies fails the run
  device     the card, and its name and power limit from nvidia-smi
  kernels    every kernel against its plain version at the main paths'
             shapes (K1, K2, K4, K5 at the NS serving shapes, and K9 at K1's
             NS shape, K6, K7 at the
             NS training shapes; K8, K1 wave, K4-K7 at the wave shapes; K2
             (5 equations), K1 and K9 MHD, K4-K7 at the MHD shapes; K2
             (both equations, and a non-affine R against PRE_JOREK), K1, K3
             and K4-K7 (K5/K7 at step 10) at the JOREK shapes): max abs
             / relative error, median times (CUDA events), the bound from
             bytes and operations, and for K8 the time of the one PyTorch
             call (conv3d) that computes the same function; K1 also in the
             centred form the score routes launch (its time and bound), K9
             beside the two-pass route it replaces, K2's and K9's device ms
             (torch.profiler; the events around one call also hold the
             host's launch time), and the grids of K1, K2 (blocks, threads,
             shared bytes, tile, frames a block), K8 and K9 (route, stash
             cells, blocks, threads, shared bytes, lanes)
  serve      NS: CalibratedSurrogate(fused=True, score='aer+pre',
             mode='joint'): calibrate on 100 samples, predict 100
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
  profile    one train step under torch.profiler: device ms (kernels and
             memory operations), the idle share against the unprofiled
             median step time, the annotated ranges left out, and the ten
             largest kernels
  parity     one train step through K4-K7 and through plain autograd from
             the same weights and batch: the loss and every gradient agree
  wave, mhd, jorek
             the family's run (solver s, or JOREK's data s, train s, losses,
             qhat, coverage at alpha=0.1, launches), then `<family>-serve`
             (the surrogate on the trained model, its qhat against the K1
             route's, K9's for MHD, and for JOREK K3 against K1 bit for bit
             on the calibration set), `<family>-step` (one train step at the
             family's step: launches, ms) and its `profile` line
  advection  advection.run("marginal", Epochs=1): solver s, train s, losses,
             mse, coverage at alpha=0.1 (aer+pre), n_rejected, the inverted
             bounds' shape (finite, upper >= lower on average)
  burgers    burgers.run("joint", Epochs=1): the same, and the holdout
             coverage at alpha=0.1, which must reach 0.7
  card-vs-cpu
             the trained FNO1d models (1e-5 of max), PRE_Advection and
             PRE_Burgers (1e-6) and ConvOperator1d.integrate on the card
             against the same call on the CPU: at the default eps outside
             the advection stencil's null modes (1e-6; the raw difference is
             printed), and at eps 1e-2 over the whole field (1e-4)
  advection-step, burgers-step
             one train step at the family's batch (10): median ms of 5, host
             clock around synchronize(), then its `profile` line
  initial    run_initial("Advection") (T_in 20, single-shot step 30, width
             32): solver s, train s, mse, coverage at alpha=0.1, bounds
  initial-offline
             run_offline on the saved wave model and 200 samples: coverage
             sweep, the inverted bounds, and exactly K4 120 and K5 20
             launches (6 and 1 a step of one 20-step rollout), no others
  gs         the GS residual on the card against the CPU (1e-6 of max); per
             surrogate (CAE, INR) train s, run s, mse, marginal and joint
             coverage at alpha=0.1 and the marginal diagonal (mean
             |coverage - (1 - alpha)|, gate < 0.15), then `gs-step` (one
             train step at batch 32: median ms of 5) and its `profile`
             line; `gs-efit`: run_efit's diagonal (the same gate)
  uq         one line per method and run (Wave in and out, NS, MHD): l2,
             coverage, joint coverage, eval_time and the method's K2, K4-K8
             launches (its training included); AER and PRE coverage >= 0.7;
             `uq-run` lines (run s, the window's launches); `uq-dropout` and
             its `profile` line (one MC-dropout forward); the harness's PRE
             through K8 and K2 against the plain PRE classes on one rollout
             of its data (1e-5 of max), with times and bounds; `uq-bayes`:
             a Bayesian head draw through K4/K5 against the module's forward
             (1e-4 of max); K4-K7 at the wave UQ model's shapes
  al-pi      K8's backward at the PI shape (cotangent [50, 18, 62, 62],
             launched on [50, 20, 64, 64]) against autograd of its plain twin
             on the wave and an asymmetric 3x3x3 stencil (1e-5 of max;
             `[k8-adjoint]`), then `[kernels]` lines for K8 `family=pi` (the
             padded field, conv3d beside it) and K8-bwd `family=pi` (conv3d's
             input gradient beside it), each with its device ms; `[pi]`: MSE
             and |PRE| before and after, the PI loss of the first and last
             steps (the last must be lower), the window's launches (K4-K7,
             K8 and K8-bwd all launched); `[pi-step]` (exactly K4 240, K5 40,
             K6 120, K7 20, K8 1, K8-bwd 1 a step; median ms of 5) and its
             `[profile]`; `[al]`: test_mse, sims_sampled, the run's and its
             iteration's launches (K4, K5, K8 in acquisition, K6, K7 in the
             fine-tune), then the same iteration's `[profile]`; K8
             `family=al` at the pool's [100, 20, 64, 64]; one `[al-pi-1d]`
             line per 1-D driver (wall s, finite values); `[cns]`
             (`EulerFVRHS` at [8, 4, 128, 128] and its gradient, finite)
  sets-node  `[sets]`: `set_pre_batched` at [4096, 998] (N = 1000) against
             the same call on the CPU (2e-5 of max|bound|; each side's
             distance to the float64 bounds printed), every padded
             trajectory inside its bounds, ms and the radius product's
             share, `set_PRE` on one trajectory against the batched row
             (2e-4); `[node]`: `node.run` for sho (300 epochs), dho, bessel
             and cauchy_euler (10, cut) at cppre's defaults: mse, coverage
             (>= 0.7), qhat, the round trip, wall s, the rollouts' steps;
             `[node-family]`: a trained field's family of 16 against the
             per-sample loop (1e-6 of max|y|) and the
             steps of one trajectory at the fit's and neural_odeint's
             tolerances; `[train-opts]` at the NS flagship (batch 5): one
             step at "highest", "high", "default" through K4-K7 (exactly
             K4 240, K5 40, K6 120, K7 20) and "bf16" on the plain path
             (none), median ms of 5; remat None / "dots" / "dots_no_batch"
             (plain: the loss and gradients equal to None's, 1e-6 of max;
             ms, peak GB); the precision flags back at "highest" and off
             after every step; `run_2d_cp(fused_train=False,
             train_precision="bf16")` at 1 epoch (finite qhat, holdout
             coverage >= 0.7, no K6/K7)
  scaling    per scaling shape (one `[kernels] kernel=K3` line each): the
             explicit `*_joint_cp_diff_stats_chunked` entry, the routed
             scores and calibrate at alpha=0.1 (the main path); K3 against
             its plain version (1e-5 of max) and K1 (bit for bit, with its
             centred pass), t_block 1, 2 and 5 bit for bit, the routed qhat
             against the plain route's (1e-3), K3 / K1 / plain ms and K3's
             grid (blocks, threads, shared bytes, tile, frames a block,
             chunks; its ring slot that of the tap table); then one
             `[route]` line per flagship K1 shape, K1 ms beside K3 ms
  flat       per family (NS; wave with the composite kernel and a corner-tap
             kernel; MHD, five equations): the flat scores and calibrate by
             `flat_routing_decision` and through the other route (the main
             path); K10, K11 and K12 each against its plain version over
             the whole window (1e-5 of max), K11 then K12 against K10 (bit
             for bit), the flat qhat against the plain flat qhat (1e-3);
             K10, K11, K12, K11 then K12 and plain ms, by events and by
             device time; the grids of K10, K11 (route, span, shared bytes,
             frames a block) and K12; for the wave kernels the time of the
             one PyTorch call that computes K11 (conv2d over the flat field)

The launch counters are set to 0 before each main path (NS serve +
calibrate; NS train; wave; MHD; JOREK; `run_offline`, the window
`initial`; the UQ runs, windows `uq` (Wave), `uq-out`, `uq-ns` and
`uq-mhd`; `pi_wave.run`, window `pi`; `al_more.run("wave")`, window `al`;
the training options, window `train-opts`; each scaling shape; each flat
family) and read after it: every kernel of
that path must have launched in its window. K8's backward counts apart
from its forward, as `K8-bwd`.
Then one JSON line of kernel results, the card's name and power limit, and
as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the script exits non-zero without that line; it
also refuses to run where CUDA is unavailable. Data is made from seeds;
TF32 is switched off throughout.
"""

from __future__ import annotations

import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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

# the wave and MHD configurations (cppre/experiments/{wave,mhd}.py CONFIG):
# model width, modes, variables, grid, the CP rollout batch (n_cal + n_pred),
# the training batch, and the residual's input shape
WAVE = dict(width=32, modes=16, nvar=1, nx=64, ny=64, rollout=1100, batch=50,
            res_shape=(1000, 20, 64, 64))
MHD = dict(width=16, modes=8, nvar=6, nx=128, ny=128, rollout=200, batch=5,
           res_shape=(100, 6, 20, 128, 128))
# the JOREK configuration (cppre/experiments/jorek.py CONFIG; T_in 10,
# step 10, T_out 40) on the synthetic blobs' 32 x 32 x 50 grid
JOREK = dict(width=16, modes=8, nvar=3, nx=32, ny=32, rollout=200, batch=5,
             res_shape=(100, 3, 40, 32, 32))
# cppre's grid-scaling shapes (scripts/bench_scaling.py:37-42, :126, :152),
# for the chunked K3 beside K1; JOREK at the NS shape, R over [2.6, 3.4]
SCALING = {"ns": (12, 3, 21, 512, 512), "mhd": (25, 6, 21, 256, 256),
           "wave": (12, 26, 512, 512), "jorek": (12, 3, 21, 512, 512)}

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# float32 outside the tensor cores. A bound is the larger of bytes / HBM
# (each input read once, each output written once) and flops / F32.
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# flops of the NS momentum residual per interior cell (two components of
# five terms each: 45 adds and multiplies, cppre_torch/ops/kernels/
# stencil_kernels.py::_ns_momentum_math)
NS_RES_FLOPS = 45
NS_FIELDS = 3
# flops of each MHD residual per interior cell (the differences it takes,
# then its terms; cppre_torch/csrc/stencil_cells.cuh, struct Mhd), and the
# fields (of rho, u, v, p, Bx, By) it reads
MHD_RES_FLOPS = {"continuity": 13, "momentum": 46, "energy": 40, "induction": 27, "gauss": 3}
MHD_FIELDS = {"continuity": 3, "momentum": 6, "energy": 6, "induction": 4, "gauss": 2}
# the same for the JOREK residuals (struct Jorek: the differences each
# equation takes, d_xx and d_yy, 1/R, the brackets, then its terms), and
# the fields of (rho, Phi, T) each reads; both also read the R table
JOREK_RES_FLOPS = {"continuity": 25, "temperature": 39}
JOREK_FIELDS = {"continuity": 2, "temperature": 3}

KERNEL_INFO = {
    "K1": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:460"),
    "K2": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:305"),
    "K4": ("cppre_torch/csrc/fno_block.cu", "cppre/ops/pallas/fno_block.py:106"),
    "K5": ("cppre_torch/csrc/fno_block.cu", "cppre/ops/pallas/fno_block.py:596"),
    "K6": ("cppre_torch/csrc/fno_block_bwd.cu", "cppre/ops/pallas/fno_block.py:322"),
    "K7": ("cppre_torch/csrc/fno_block_bwd.cu", "cppre/ops/pallas/fno_block.py:650"),
    "K8": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:80"),
    # K8's kernel launched as its own adjoint (the PI loss's backward)
    "K8-bwd": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:80"),
    "K9": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:643"),
    "K3": ("cppre_torch/csrc/stencil_kernels.cu", "cppre/ops/pallas/stencil_kernels.py:844"),
    "K10": ("cppre_torch/csrc/flat_kernels.cu", "cppre/ops/pallas/flat_kernels.py:166"),
    "K11": ("cppre_torch/csrc/flat_kernels.cu", "cppre/ops/pallas/flat_kernels.py:220"),
    "K12": ("cppre_torch/csrc/flat_kernels.cu", "cppre/ops/pallas/flat_kernels.py:248"),
}
# the kernels each main path must launch
PATH_KERNELS = {
    "ns-serve": ("K1", "K2", "K4", "K5"),
    "ns-train": ("K2", "K4", "K5", "K6", "K7"),
    "wave": ("K1", "K4", "K5", "K6", "K7", "K8"),
    "mhd": ("K1", "K2", "K4", "K5", "K6", "K7", "K9"),
    "jorek": ("K1", "K2", "K3", "K4", "K5", "K6", "K7"),
    "scaling": ("K1", "K3"),
    "flat": ("K10", "K11", "K12"),
    "initial": ("K4", "K5"),
    "uq": ("K4", "K5", "K6", "K7", "K8"),
    "uq-out": ("K4", "K5", "K8"),
    "uq-ns": ("K2", "K4", "K5", "K6", "K7"),
    "uq-mhd": ("K2", "K4", "K5", "K6", "K7"),
    "uq-mle": ("K4", "K5", "K6", "K7"),
    "pi": ("K4", "K5", "K6", "K7", "K8", "K8-bwd"),
    "al": ("K4", "K5", "K6", "K7", "K8"),
    "train-opts": ("K2", "K4", "K5", "K6", "K7"),
}
# the kernels the UQ harness can launch, as its per-method lines print them
UQ_KERNELS = ("K2", "K4", "K5", "K6", "K7", "K8")


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


def device_fields(shape, seed, device, density=False):
    """Smooth-plus-noise fields of `shape` [..., Nt, Nx, Ny] made on the card
    from a seed, and a prediction 0.01 N(0, 1) away; with `density`, field 0
    of axis 1 is kept in [1.2, 1.8] (the MHD momentum residual divides by
    it)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    nt, nx, ny = shape[-3:]
    t = torch.linspace(0, 1, nt, device=device)[:, None, None]
    x = torch.linspace(0, 1, nx, device=device)[:, None]
    y = torch.linspace(0, 1, ny, device=device)
    base = torch.sin(2 * np.pi * x) * torch.cos(2 * np.pi * y) * torch.exp(-t)
    truth = base + 0.05 * torch.randn(shape, generator=gen, device=device)
    if density:
        truth[:, 0] = 1.5 + 0.3 * torch.tanh(truth[:, 0])
    pred = truth + 0.01 * torch.randn(shape, generator=gen, device=device)
    return truth, pred


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


def device_ms(fn, reps=20):
    """Device milliseconds of one call of `fn`: the kernels and memory
    operations of `reps` calls under torch.profiler (`device_activity`),
    over reps; None where the profiler cannot tell them apart or kept a
    number of records that is not a whole number of calls. `cuda_ms`'s
    events around one call also hold the host's time to launch it, tens of
    microseconds, most of the time of a kernel as short as JOREK's K2."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, records = 0.0, 0
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        activity = device_activity(e)
        if activity is None:
            return None
        if activity:
            total += e.time_range.elapsed_us() / 1e3
            records += 1
    # every call launches the same work, so a count of records that is not
    # a multiple of reps means the profiler lost some
    if records == 0 or records % reps:
        return None
    return total / reps


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


def same_bits(name, a, b):
    """Two runs of a kernel on the same inputs must give the same bits."""
    import torch

    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def _kernel_name(mangled):
    """A mangled kernel name as name<template args>, its namespaces dropped:
    _ZN<ns>21block_bwd_tile_kernelILi16EEEv... -> block_bwd_tile_kernel<16>;
    a class argument keeps its name: residual_kernelIN<ns>3MhdILi4EEEE ->
    residual_kernel<Mhd<4>>."""
    def name_at(s):
        """(name, rest) of one nested or plain source name at s."""
        nested = s.startswith("N")
        s, name = s[1:] if nested else s, None
        while True:
            if nested and (sub := re.match(r"S[0-9A-Z]*_", s)):   # a substitution
                s = s[sub.end():]
            if not (m := re.match(r"\d+", s)):
                break
            n = int(m.group())
            name, s = s[m.end():m.end() + n], s[m.end() + n:]
            if not nested:
                break
            if s.startswith("I"):
                args, s = args_at(s)
                name += args
        return name, s[1:] if nested and s.startswith("E") else s

    def args_at(s):
        """(<a,b>, rest) of a template argument list at s ('I...E')."""
        s, out = s[1:], []
        while s and not s.startswith("E"):
            if (m := re.match(r"L[bcijlmstxy](-?\d+)E", s)):
                out.append(m.group(1))
                s = s[m.end():]
            elif s[0] == "N" or s[0].isdigit():
                name, s = name_at(s)
                out.append(name or "?")
            else:
                out.append(s[0])
                s = s[1:]
        return f"<{','.join(out)}>", s[1:]

    rest = mangled[2:] if mangled.startswith("_Z") else mangled
    name, rest = name_at(rest)
    if name is None:
        return mangled[:60]
    if rest.startswith("I"):
        name += args_at(rest)[0]
    return name


# The kernel functions of K4-K7 (csrc/fno_block.cu, fno_block_bwd.cu and
# their headers), of K1, K2, K3, K8 and K9 (csrc/stencil_kernels.cu) and of
# K10, K11 and K12 (csrc/flat_kernels.cu: K1's body for K10 and K12, and
# K11's two bodies): built to keep every instance's working set in
# registers, so a spill in any of them is a fault of the build.
FNO_BLOCK_STAGES = ("dft_fwd_kernel", "spectral_mix_kernel", "inverse_x_kernel",
                    "block_out_tile_kernel", "block_bwd_tile_kernel", "idft_dx_tile_kernel",
                    "spectral_adjoint_kernel", "reduce_rows_kernel", "projection_tile_kernel",
                    "projection_bwd_tile_kernel")
NO_SPILL = {"fno_block": FNO_BLOCK_STAGES, "fno_block_bwd": FNO_BLOCK_STAGES,
            "stencil_kernels": ("diff_stats_kernel", "stencil_march_kernel",
                                "residual_window_kernel", "scores_stash_kernel",
                                "scores_single_pass_kernel", "diff_stats_chunked_kernel"),
            "flat_kernels": ("diff_stats_kernel", "flat_span_kernel", "flat_residual_kernel")}


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


def build_model(device, width=WIDTH, modes=MODES, nvar=NVAR, t_in=T_IN, step=STEP):
    import torch
    from cppre_torch.models import FNO2d

    gen = torch.Generator().manual_seed(SEED)
    return FNO2d(t_in, step, modes, modes, nvar, width, device=device, generator=gen).eval()


def report(results, kid, family, **extra):
    r = results[(kid, family)]
    say("kernels", kernel=kid, family=family, max_abs_err=f"{r['max_abs_err']:.3e}",
        rel_err=f"{r['rel_err']:.3e}", ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
        bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
        library_ms="none" if r.get("library_ms") is None else f"{r['library_ms']:.4f}",
        **extra)


def k1_centred(r, truth, pred, cell, n_bytes, flops):
    """K1 in the centred form every score route launches, beside the plain
    form already in `r`: m2 against the plain version (1e-5 of max), its
    time, and its bound, which adds m2's write and a second read of the diff
    to the plain form's n_bytes, and 3 flops a diff (deviation, square,
    add) to its flops; and K1's blocks and threads a block."""
    from cppre_torch.ops.kernels import stencil_kernels as sk

    run = lambda: sk._joint_cp_diff_stats(truth, pred, cell, centred=True)
    d, _, _, m2 = run()
    compare("K1 centred m2", m2, sk._diff_stats_plain(truth, pred, cell, centred=True)[3], 1e-5)
    r.update(centred_ms=cuda_ms(run), centred_bound=bound(n_bytes + nbytes(m2, d),
                                                          flops + 3 * d.numel()),
             grid=sk._k1_grid(tuple(truth.shape), cell))
    return dict(centred_ms=f"{r['centred_ms']:.4f}",
                centred_bound_ms=f"{r['centred_bound'][0]:.4f}", blocks=r["grid"][0],
                threads_a_block=r["grid"][1])


def k2_grid(fields, cell):
    """K2's launch for `fields` and `cell`, and its device ms, as its
    [kernels] line reports them."""
    from cppre_torch.ops.kernels import stencil_kernels as sk

    g = sk._residual_geom(tuple(fields.shape), cell)
    dev = device_ms(lambda: sk._batched_residual_fused(fields, cell))
    return dict(device_ms="not measured" if dev is None else f"{dev:.4f}", blocks=g["blocks"],
                threads_a_block=g["threads"], smem_bytes=g["smem"],
                tile=f"{g['tile'][0]}x{g['tile'][1]}", frames_a_block=g["frames"])


def k9_line(results, family, truth, pred, cell, scores, res_flops, in_bytes):
    """K9 (`scores`: its entry, called with single_pass) against its plain
    version (1e-5 of max) and against the two-pass route, K1 centred and
    the score epilogue (1e-6 of max), bit-stable on a rerun; its time beside
    the two-pass route's, its bound (the inputs its cell reads once, the
    scores written; per sample and cell the two residuals, their
    difference, and 8 flops of the moments and the score), and its grid."""
    from cppre_torch.ops.kernels import stencil_kernels as sk

    one, two = scores(truth, pred, True), scores(truth, pred, False)
    plain = sk._scores_plain(truth, pred, cell, EPS, None, f"K9 {family}")
    err, rel = compare(f"K9 {family} vs plain", one, plain, 1e-5)
    _, rel_two = compare(f"K9 {family} vs K1 two-pass", one, two, 1e-6)
    same_bits(f"K9 {family}", one, scores(truth, pred, True))
    cells = one.numel() * int(np.prod([n - cell.k + 1 for n in truth.shape[2:]]))
    r = results[("K9", family)] = dict(
        max_abs_err=err, rel_err=rel,
        bound=bound(in_bytes + nbytes(one), (2 * res_flops + 1 + 8) * cells),
        ms=cuda_ms(lambda: scores(truth, pred, True)),
        plain_ms=cuda_ms(lambda: sk._scores_plain(truth, pred, cell, EPS, None, "K9")),
        two_pass_ms=cuda_ms(lambda: scores(truth, pred, False)))
    g = sk._k9_grid(tuple(truth.shape), cell)
    dev = device_ms(lambda: scores(truth, pred, True))
    report(results, "K9", family, vs_two_pass_rel=f"{rel_two:.3e}", bitwise_rerun=True,
           two_pass_ms=f"{r['two_pass_ms']:.4f}",
           device_ms="not measured" if dev is None else f"{dev:.4f}", cells=cells, route=g["route"],
           stash_cells=g["cells"], blocks=g["blocks"], threads_a_block=g["threads"],
           smem_bytes=g["smem"], lanes=g["lanes"])


def fno_kernels(results, family, device, width, modes, nvar, nx, ny, b_fwd, b_bwd, seed,
                t_in=T_IN, step=STEP):
    """K4 and K5 at the rollout batch, K6 and K7 at the training batch, on
    random activations with the weights of a seeded model of the family's
    t_in and step (K5 and K7 take `step` outputs), against their plain
    versions. Outputs and dx/dz within 1e-4 of max|plain|; the weight grads
    of K6/K7 within 1e-3, since they are sums over every pixel of the batch
    taken in another order than autograd's. Two backward calls must give
    equal bits."""
    import torch
    from cppre_torch.models.fno import get_grid
    from cppre_torch.ops import kernels as K

    model = build_model(device, width, modes, nvar, t_in, step)
    gen = torch.Generator(device=device).manual_seed(seed)
    blk = model.f0
    grid_c = get_grid((1, nvar, nx, ny), device).permute(0, 4, 1, 2, 3)
    fc1, fc2 = model.fc1_time, model.fc2_time
    with torch.no_grad():
        x3 = blk.b(grid_c).contiguous()
        x = torch.randn((b_fwd, width, nvar, nx, ny), generator=gen, device=device)
        got = K.fno_block2d_fused(x, blk, x3, modes, modes)
        ref = K.fno_block2d_plain(x, blk, x3, modes, modes)
        err, rel = compare(f"K4 {family}", got, ref, 1e-4)
        results[("K4", family)] = dict(
            max_abs_err=err, rel_err=rel,
            bound=bound(nbytes(x, x3, ref), 2 * fno_block_macs(*x.shape[:4], ny, modes)),
            ms=cuda_ms(lambda: K.fno_block2d_fused(x, blk, x3, modes, modes)),
            plain_ms=cuda_ms(lambda: K.fno_block2d_plain(x, blk, x3, modes, modes)))
        del x, got, ref
        z = torch.randn((b_fwd, nvar, nx, ny, width), generator=gen, device=device)
        got = K.projection2d_fused(z, fc1, fc2)
        ref = K.projection2d_plain(z, fc1, fc2)
        err, rel = compare(f"K5 {family}", got, ref, 1e-4)
        n_pix = z.numel() // width
        results[("K5", family)] = dict(
            max_abs_err=err, rel_err=rel,
            bound=bound(nbytes(z, ref), 2 * n_pix * W_PROJ * (width + step)),
            ms=cuda_ms(lambda: K.projection2d_fused(z, fc1, fc2)),
            plain_ms=cuda_ms(lambda: K.projection2d_plain(z, fc1, fc2)))
        del z, got, ref

    shape = (b_bwd, width, nvar, nx, ny)
    x = torch.randn(shape, generator=gen, device=device)
    g = torch.randn(shape, generator=gen, device=device)
    z = torch.randn((b_bwd, nvar, nx, ny, width), generator=gen, device=device)
    gz = torch.randn((b_bwd, nvar, nx, ny, step), generator=gen, device=device)
    cases = {
        "K6": (lambda: K.fno_block2d_bwd_fused(x, g, blk, x3, modes, modes),
               lambda: K.fno_block2d_bwd_plain(x, g, blk, x3, modes, modes),
               bound(nbytes(x, g, x3, x, x3), 2 * fno_block_macs(*shape[:4], ny, modes, True))),
        "K7": (lambda: K.projection2d_bwd_fused(z, gz, fc1, fc2),
               lambda: K.projection2d_bwd_plain(z, gz, fc1, fc2),
               bound(nbytes(z, gz, z),
                     2 * (z.numel() // width) * W_PROJ * (3 * width + 2 * step))),
    }
    for k, (kern, plain, bnd) in cases.items():
        got, ref = kern(), plain()
        err, rel = compare(f"{k} {family} d-input", got[0], ref[0], 1e-4)
        w_rel = max(compare(f"{k} {family} grad {i}", a, b, 1e-3)[1]
                    for i, (a, b) in enumerate(zip(got[1:], ref[1:]), 1))
        same_bits(f"{k} {family}", got, kern())
        results[(k, family)] = dict(max_abs_err=err, rel_err=rel, wgrad_rel=w_rel, bound=bnd,
                                    ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
        del got, ref
    del model, x, g, z, gz, x3
    torch.cuda.empty_cache()
    for k in ("K4", "K5", "K6", "K7"):
        extra = {"step": step} if k in ("K5", "K7") else {}
        if k in ("K6", "K7"):
            extra.update(weight_grad_rel_err=f"{results[(k, family)]['wgrad_rel']:.3e}",
                         bitwise_rerun=True)
        report(results, k, family, **extra)


def phase_kernels(model, device):
    """Each kernel against its plain version at the NS flagship shapes."""
    import torch
    from cppre_torch.cp import calibrate
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk

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
    out[("K2", "ns")] = dict(max_abs_err=err, rel_err=rel,
                             bound=bound(nbytes(f20, ref), NS_RES_FLOPS * cells),
                             ms=cuda_ms(lambda: K.ns_momentum_residual_fused(f20, *args)),
                             plain_ms=cuda_ms(lambda: K.ns_momentum_residual_plain(f20, *args)),
                             grid=k2_grid(f20, sk._ns_cell(*args)))
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
    k1_bytes, k1_flops = nbytes(truth, pred, d0, s0, q0), (2 * NS_RES_FLOPS + 4) * d0.numel()
    out[("K1", "ns")] = dict(
        max_abs_err=err, rel_err=rel, bound=bound(k1_bytes, k1_flops),
        ms=cuda_ms(lambda: K.ns_joint_cp_diff_stats(truth, pred, *args)),
        plain_ms=cuda_ms(lambda: K.ns_joint_cp_diff_stats_plain(truth, pred, *args)))
    centred = k1_centred(out[("K1", "ns")], truth, pred, sk._ns_cell(*args), k1_bytes, k1_flops)
    del d, s, q, d0, s0, q0
    # K9 at the same shape, the NS entry's single pass
    k9_line(out, "ns", truth, pred, sk._ns_cell(*args),
            lambda a, b, sp: K.ns_joint_cp_scores_fused(a, b, *args, eps=EPS, single_pass=sp),
            NS_RES_FLOPS, nbytes(truth, pred))
    del truth, pred
    report(out, "K1", "ns", **centred, qhat=f"{float(qh):.6e}", qhat_bf16=f"{float(qb):.6e}",
           qhat_bf16_vs_plain_bf16=f"{rel_bf:.3e}",
           qhat_bf16_vs_f32=f"{abs(float(qb) - float(qh)) / abs(float(qh)):.3e}")
    report(out, "K2", "ns", **out[("K2", "ns")]["grid"])
    fno_kernels(out, "ns", device, WIDTH, MODES, NVAR, NX, NY, N_CAL, TRAIN_BATCH, SEED + 2)
    torch.cuda.empty_cache()
    return out


def phase_kernels_wave(results, device):
    """K8 and K1's wave instance at the wave experiment's residual shape
    [1000, 20, 64, 64] (the calibration set), with the wave composite kernel;
    K4-K7 at the wave model's shapes."""
    import torch
    import torch.nn.functional as F
    from cppre_torch.experiments import wave
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk
    from cppre_torch.residuals import PRE_Wave
    from cppre_torch.solvers import Wave2D

    c = wave.CONFIG
    sim = Wave2D(c["Nx"], c["x_min"], c["x_max"], c["tend"], c["c"], device=device)
    kern = PRE_Wave(sim.dt * c["t_slice"], sim.dx, c["c"]).D.kernel
    n_taps = int(np.count_nonzero(kern))
    truth, pred = device_fields(WAVE["res_shape"], SEED + 10, device)

    # K8, plain and |.|, and the library call computing the same function
    w = torch.as_tensor(kern, device=device)[None, None]
    conv = lambda: F.conv3d(truth[:, None], w)[:, 0]
    for take_abs in (False, True):
        got = K.fused_stencil_residual(truth, kern, take_abs=take_abs)
        ref = K.fused_stencil_residual_plain(truth, kern, take_abs=take_abs)
        err, rel = compare(f"K8 take_abs={take_abs}", got, ref, 1e-5)
        same_bits("K8", got, K.fused_stencil_residual(truth, kern, take_abs=take_abs))
        r = dict(max_abs_err=err, rel_err=rel,
                 bound=bound(nbytes(truth, ref), (2 * n_taps - 1 + take_abs) * ref.numel()),
                 ms=cuda_ms(lambda: K.fused_stencil_residual(truth, kern, take_abs=take_abs)),
                 plain_ms=cuda_ms(lambda: K.fused_stencil_residual_plain(truth, kern,
                                                                         take_abs=take_abs)))
        if not take_abs:
            lib_err = float((conv() - ref).abs().max())
            r["library_ms"] = cuda_ms(conv)
        fam = "wave" if not take_abs else "wave-abs"
        results[("K8", fam)] = r
        report(results, "K8", fam, taps=n_taps, blocks=sk._march_geom(tuple(truth.shape), 3)[2],
               by_value=sk._taps_by_value(n_taps),
               **({"library": "torch.nn.functional.conv3d",
                   "library_max_abs_err": f"{lib_err:.3e}"} if not take_abs else {}))
        del got, ref

    # K1's wave instance: diff, moments and the scores
    d, s, q = K.wave_joint_cp_diff_stats(truth, pred, kern)
    d0, s0, q0 = K.wave_joint_cp_diff_stats_plain(truth, pred, kern)
    err, rel = compare("K1 wave diff", d, d0, 1e-5)
    compare("K1 wave sum", s, s0, 1e-5)
    compare("K1 wave sumsq", q, q0, 1e-5)
    same_bits("K1 wave", (d, s, q), K.wave_joint_cp_diff_stats(truth, pred, kern))
    compare("K1 wave scores", K.wave_joint_cp_scores_fused(truth, pred, kern, eps=EPS),
            K.wave_joint_cp_scores_plain(truth, pred, kern, eps=EPS), 1e-5)
    k1_bytes = nbytes(truth, pred, d0, s0, q0)
    k1_flops = (2 * (2 * n_taps - 1) + 4) * d0.numel()
    results[("K1", "wave")] = dict(
        max_abs_err=err, rel_err=rel, bound=bound(k1_bytes, k1_flops),
        ms=cuda_ms(lambda: K.wave_joint_cp_diff_stats(truth, pred, kern)),
        plain_ms=cuda_ms(lambda: K.wave_joint_cp_diff_stats_plain(truth, pred, kern)))
    centred = k1_centred(results[("K1", "wave")], truth[:, None], pred[:, None],
                         sk._taps_cell(kern), k1_bytes, k1_flops)
    report(results, "K1", "wave", **centred, bitwise_rerun=True)
    del truth, pred, d, s, q, d0, s0, q0
    torch.cuda.empty_cache()
    fno_kernels(results, "wave", device, WAVE["width"], WAVE["modes"], WAVE["nvar"],
                WAVE["nx"], WAVE["ny"], WAVE["rollout"], WAVE["batch"], SEED + 11)


def phase_kernels_mhd(results, device):
    """K2 (all five equations), K1's and K9's MHD-induction instances at the
    MHD experiment's residual shape [100, 6, 20, 128, 128]; K4-K7 at the MHD
    model's shapes."""
    import torch
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk

    truth, pred = device_fields(MHD["res_shape"], SEED + 20, device, density=True)
    field_bytes = nbytes(truth) // 6
    worst = 0.0
    for eq in K.MHD_EQUATIONS:
        got = K.mhd_residual_fused(truth, eq)
        ref = K.mhd_residual_plain(truth, eq)
        err, rel = compare(f"K2 MHD {eq}", got, ref, 1e-5)
        worst = max(worst, rel)
        fam = f"mhd-{eq}"
        results[("K2", fam)] = dict(
            max_abs_err=err, rel_err=rel,
            bound=bound(MHD_FIELDS[eq] * field_bytes + nbytes(ref), MHD_RES_FLOPS[eq] * ref.numel()),
            ms=cuda_ms(lambda: K.mhd_residual_fused(truth, eq)),
            plain_ms=cuda_ms(lambda: K.mhd_residual_plain(truth, eq)))
        report(results, "K2", fam, **k2_grid(truth, sk._mhd_cell(eq)))
        del got, ref
    # the path's equation carries the worst error of the five
    results[("K2", "mhd")] = dict(results[("K2", "mhd-induction")])
    results[("K2", "mhd")].update(rel_err=worst, max_abs_err=max(
        results[("K2", f"mhd-{eq}")]["max_abs_err"] for eq in K.MHD_EQUATIONS))

    # K1's MHD-induction instance
    d, s, q = K.mhd_joint_cp_diff_stats(truth, pred)
    d0, s0, q0 = K.mhd_joint_cp_diff_stats_plain(truth, pred)
    err, rel = compare("K1 MHD diff", d, d0, 1e-5)
    compare("K1 MHD sum", s, s0, 1e-5)
    compare("K1 MHD sumsq", q, q0, 1e-5)
    same_bits("K1 MHD", (d, s, q), K.mhd_joint_cp_diff_stats(truth, pred))
    in_bytes = 2 * MHD_FIELDS["induction"] * field_bytes
    ind = MHD_RES_FLOPS["induction"]
    k1_bytes, k1_flops = in_bytes + nbytes(d0, s0, q0), (2 * ind + 1 + 4) * d0.numel()
    results[("K1", "mhd")] = dict(
        max_abs_err=err, rel_err=rel, bound=bound(k1_bytes, k1_flops),
        ms=cuda_ms(lambda: K.mhd_joint_cp_diff_stats(truth, pred)),
        plain_ms=cuda_ms(lambda: K.mhd_joint_cp_diff_stats_plain(truth, pred)))
    centred = k1_centred(results[("K1", "mhd")], truth, pred, sk._mhd_cell("induction"),
                         k1_bytes, k1_flops)
    report(results, "K1", "mhd", **centred, bitwise_rerun=True)
    del d, s, q, d0, s0, q0

    # K9 against K1 + the score epilogue and against its plain version
    k9_line(results, "mhd", truth, pred, sk._mhd_cell("induction"),
            lambda a, b, sp: K.mhd_induction_joint_cp_scores_fused(a, b, eps=EPS, single_pass=sp),
            ind, in_bytes)
    del truth, pred
    torch.cuda.empty_cache()
    fno_kernels(results, "mhd", device, MHD["width"], MHD["modes"], MHD["nvar"], MHD["nx"],
                MHD["ny"], MHD["rollout"], MHD["batch"], SEED + 21)


def jorek_r(nx, affine=True):
    """The JOREK experiment's major-radius grid, linspace(2.6, 3.4, nx)
    (cppre_torch.experiments.jorek.synthetic_blobs), or a non-affine one."""
    r = np.linspace(2.6, 3.4, nx).astype(np.float32)
    return r if affine else r ** 1.5


def phase_kernels_jorek(results, device):
    """K2 (both equations, and a non-affine R against `PRE_JOREK`), K1 and
    K3 (bit for bit K1's, the centred pass too) at the JOREK residual shape
    [100, 3, 40, 32, 32] (the calibration set), and K4-K7 at the JOREK
    model's shapes with its T_in 10 and step 10."""
    import torch
    from cppre_torch.experiments import jorek
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk
    from cppre_torch.residuals import PRE_JOREK

    c = jorek.CONFIG
    coef = dict(Dc=c["D"], K=c["K"])
    R = jorek_r(JOREK["nx"])
    truth, pred = device_fields(JOREK["res_shape"], SEED + 60, device)
    field_bytes = nbytes(truth) // 3
    for eq in K.JOREK_EQUATIONS:
        got = K.jorek_residual_fused(truth, R, equation=eq, **coef)
        ref = K.jorek_residual_plain(truth, R, equation=eq, **coef)
        err, rel = compare(f"K2 JOREK {eq}", got, ref, 1e-5)
        same_bits(f"K2 JOREK {eq}", got, K.jorek_residual_fused(truth, R, equation=eq, **coef))
        fam = "jorek" if eq == c["equation"] else f"jorek-{eq}"
        results[("K2", fam)] = dict(
            max_abs_err=err, rel_err=rel,
            bound=bound(JOREK_FIELDS[eq] * field_bytes + R.nbytes + nbytes(ref),
                        JOREK_RES_FLOPS[eq] * ref.numel()),
            ms=cuda_ms(lambda: K.jorek_residual_fused(truth, R, equation=eq, **coef)),
            plain_ms=cuda_ms(lambda: K.jorek_residual_plain(truth, R, equation=eq, **coef)))
        report(results, "K2", fam, equation=eq, bitwise_rerun=True,
               **k2_grid(truth, sk._jorek_cell(R, c["D"], c["K"], eq)))
        del got, ref
    # a non-affine grid runs the kernel too, against the PRE_JOREK class
    rn = jorek_r(JOREK["nx"], affine=False)
    pre = PRE_JOREK(rn, 1.0, 1.0, 1.0, D=c["D"], K=c["K"], device=device)
    for eq in K.JOREK_EQUATIONS:
        before = K.launch_counts()["K2"]
        got = K.jorek_residual_fused(truth, rn, equation=eq, **coef)
        if K.launch_counts()["K2"] != before + 1:
            raise AssertionError("K2 did not launch for a non-affine R")
        _, rel = compare(f"K2 JOREK {eq} non-affine R vs PRE_JOREK", got,
                         pre.residual(truth, eq), 1e-5)
        say("kernels", kernel="K2", family=f"jorek-{eq}-non-affine-R", vs="PRE_JOREK",
            rel_err=f"{rel:.3e}")
        del got

    # K1 (diff, sum, sumsq) and K3, the continuity instance
    cell = sk._jorek_cell(R, c["D"], c["K"], c["equation"])
    run_k1 = lambda: sk._joint_cp_diff_stats(truth, pred, cell)[:3]
    d, s, q = run_k1()
    d0, s0, q0 = K.jorek_joint_cp_diff_stats_chunked_plain(truth, pred, R, **coef)
    err, rel = compare("K1 JOREK diff", d, d0, 1e-5)
    compare("K1 JOREK sum", s, s0, 1e-5)
    compare("K1 JOREK sumsq", q, q0, 1e-5)
    same_bits("K1 JOREK", (d, s, q), run_k1())
    same_bits("K3 vs K1 JOREK (diff, sum, sumsq, centred)",
              sk._joint_cp_diff_stats(truth, pred, cell, centred=True),
              sk._joint_cp_diff_stats_chunked(truth, pred, cell, centred=True))
    eqf = JOREK_RES_FLOPS[c["equation"]]
    in_bytes = 2 * JOREK_FIELDS[c["equation"]] * field_bytes + R.nbytes
    k1_bytes, k1_flops = in_bytes + nbytes(d0, s0, q0), (2 * eqf + 1 + 4) * d0.numel()
    bnd = bound(k1_bytes, k1_flops)
    plain_ms = cuda_ms(lambda: K.jorek_joint_cp_diff_stats_chunked_plain(truth, pred, R, **coef))
    results[("K1", "jorek")] = dict(max_abs_err=err, rel_err=rel, bound=bnd, ms=cuda_ms(run_k1),
                                    plain_ms=plain_ms)
    centred = k1_centred(results[("K1", "jorek")], truth, pred, cell, k1_bytes, k1_flops)
    report(results, "K1", "jorek", **centred, bitwise_rerun=True)
    results[("K3", "jorek")] = dict(
        max_abs_err=err, rel_err=rel, bound=bnd, plain_ms=plain_ms,
        ms=cuda_ms(lambda: K.jorek_joint_cp_diff_stats_chunked(truth, pred, R, **coef)))
    geom = sk._chunk_geom(tuple(JOREK["res_shape"]), cell)
    report(results, "K3", "jorek", k3_vs_k1_bitwise=True, t_block_run=geom["frames"],
           blocks=geom["blocks"], smem_bytes=geom["smem"])
    del truth, pred, d, s, q, d0, s0, q0
    torch.cuda.empty_cache()
    fno_kernels(results, "jorek", device, JOREK["width"], JOREK["modes"], JOREK["nvar"],
                JOREK["nx"], JOREK["ny"], JOREK["rollout"], JOREK["batch"], SEED + 61,
                t_in=c["T_in"], step=c["Step"])


def coverage_at_alpha(out):
    """Coverage at alpha = 0.1 of the four joint estimators, from a run's
    residuals; the holdout ones (finite-sample valid) must reach 0.7."""
    from cppre_torch.experiments.pipeline import joint_cp

    r = (out["res_out_cal"], out["res_pred_cal"], out["res_pred"], out["res_out_pred"])
    eps = out.get("eps", 0.0)
    at = np.asarray([ALPHA])
    cov = {"aer_pre": joint_cp(*r, alphas=at, eps=eps)["coverage"][0],
           "pre": joint_cp(*r[:3], alphas=at, mode="pre", eps=eps)["coverage"][0],
           "aer_pre_holdout": joint_cp(*r, alphas=at, holdout_modulation=True,
                                       eps=eps)["coverage"][0],
           "pre_holdout": joint_cp(*r[:3], alphas=at, mode="pre", holdout_modulation=True,
                                   eps=eps)["coverage"][0]}
    if min(cov["aer_pre_holdout"], cov["pre_holdout"]) < 0.7:
        raise AssertionError(f"holdout coverage at alpha={ALPHA}: {cov}, below 0.7")
    return json.dumps({k: round(float(v), 4) for k, v in cov.items()})


def check_losses(losses, what):
    first, last = losses[0][0], losses[-1][0]
    if not (np.isfinite([v for pair in losses for v in pair]).all() and last < first):
        raise AssertionError(f"{what} training losses {losses}: not finite, or not falling")
    return first, last


def check_path(name, counts):
    missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the {name} path")


def time_train_step(what, model, batch, nvar, nx, ny, lr, device, seed, t_in=T_IN, step=STEP,
                    t_out=T_OUT):
    """One train step of `model` through K4-K7 at `batch`, a rollout of
    n = t_out // step steps: the launches of one step (must be K4 12 n, K5
    2 n, K6 6 n, K7 n: K4 240, K5 40, K6 120, K7 20 at step 1, T_out 20)
    and the median ms of 5. Returns the step function and its median ms."""
    import torch
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.ops import kernels as K
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss

    model = model.train()
    opt = make_optimizer(model.parameters(), lr)
    train_step = make_train_step(make_fused_train_apply(model), opt, step, t_out, lp_loss)
    gen = torch.Generator(device=device).manual_seed(seed)
    xx = torch.rand((batch, nvar, nx, ny, t_in), generator=gen, device=device)
    yy = torch.rand((batch, nvar, nx, ny, t_out), generator=gen, device=device)
    train_step(xx, yy)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    train_step(xx, yy)
    torch.cuda.synchronize()
    per_step = K.launch_counts()
    n = t_out // step
    want = {"K4": 2 * 6 * n, "K5": 2 * n, "K6": 6 * n, "K7": n}
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        train_step(xx, yy)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    say(what, batch=batch, step=step, rollout_steps=n, step_ms_median=f"{step_ms:.2f}",
        step_ms=json.dumps([round(t, 2) for t in times]),
        launches_per_step=json.dumps(per_step, separators=(",", ":")))
    if any(per_step[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches per train step {per_step}, expected {want}")
    return lambda: train_step(xx, yy), step_ms


def phase_train(device):
    """The flagship experiment on the card, Epochs cut to 2: returns the
    launch counts of its run."""
    import torch
    from cppre_torch.experiments import ns
    from cppre_torch.ops import kernels as K

    cfg = {"Epochs": TRAIN_EPOCHS}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ns.run("joint", config=cfg, seed=SEED, verbose=False, device=device,
                 return_residuals=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = K.launch_counts()
    check_path("ns-train", counts)
    c = dict(ns.CONFIG, **cfg)
    losses = out["train_losses"]
    first, last = check_losses(losses, "NS")
    cov = coverage_at_alpha(out)
    n_sims = c["n_train"] + c["n_cal"] + c["n_pred"]
    say("train", sims=n_sims, solver_N=c["N"], rollout_shape=list(out["pred_cal"].shape[1:]),
        solver_s=f"{out['data_time']:.2f}", train_s=f"{out['train_time']:.2f}",
        run_s=f"{t_run:.2f}", epochs=len(losses),
        steps_per_epoch=c["n_train"] // c["Batch Size"],
        loss_first=f"{first:.6f}", loss_last=f"{last:.6f}",
        qhat=f"{float(out['qhat']):.6e}", coverage_alpha_0_1=cov,
        launches=json.dumps(counts, separators=(",", ":")))

    # one train step of the trained model at batch 5: launches and time
    step, step_ms = time_train_step("train", out["model"], TRAIN_BATCH, NVAR, NX, NY,
                                    c["Learning Rate"], device, SEED + 5)
    profile_step(step, step_ms)
    del out, step
    torch.cuda.empty_cache()
    return counts


# What a profile's device ms sums: the kernels and memory operations on the
# card (kineto's activity types), never a range annotated around them, such
# as `Optimizer.step#Adam.step`, which spans its kernels and the gaps
# between them.
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(e):
    """Whether a CUDA-side profiler event is a kernel or a memory operation;
    None where the event tells neither its activity type nor whether it is
    an annotated range (a PyTorch without those attributes)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in DEVICE_ACTIVITIES
    if not hasattr(e, "is_user_annotation"):
        return None
    return not e.is_user_annotation


def profile_step(fn, step_ms, what="one train step"):
    """One call of `fn` under torch.profiler, tracing the card's activity
    alone (reading the host operators of a call of ~100 000 of them, an AL
    iteration, takes the profiler ~45 s and changes no device reading): its
    wall ms there, the device ms summed over its kernels and memory
    operations (`device_activity`), the annotated ranges left out of that
    sum ("not measured" where the trace holds none), and the ten largest
    kernels by device ms. The idle share is 1 - device ms / step_ms, the
    unprofiled median wall time of the same call, since the profiler's own
    overhead lengthens the wall time it sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, ranges, n_ranges, unknown = {}, 0.0, 0, False
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        activity = device_activity(e)
        unknown |= activity is None
        if not activity:
            ranges += e.time_range.elapsed_us() / 1e3
            n_ranges += 1
            continue
        name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name)
        name = re.split(r"[<(]", name, maxsplit=1)[0] or e.name[:40]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    # where the events cannot be told apart, no device sum is printed
    device = 0.0 if unknown else sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    say("profile", what=repr(what), profiled_wall_ms=f"{wall:.2f}",
        unprofiled_ms=f"{step_ms:.2f}", device_ms=f"{device:.2f}" if device else "not measured",
        idle_share=f"{1 - device / step_ms:.3f}" if device else "not measured",
        annotated_ranges_ms=f"{ranges:.2f}" if n_ranges and not unknown else "not measured",
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


def phase_family(family, device, keep_dir=None):
    """`<family>.run("joint", Epochs=2)` at the full CONFIG, then the trained
    model served: CalibratedSurrogate(fused=True, score='aer+pre',
    mode='joint', the family's step and T_out) calibrated on the run's
    calibration inputs and predicting its prediction inputs, the same
    calibration through K1 (and K9 for MHD) within 1e-3 of the surrogate's
    qhat, for JOREK the explicit chunked K3 on the same inputs (bit for bit
    K1's), and one train step. With `keep_dir`, the trained model, its
    normalizers and the run's last 200 samples are saved there (`wave.pth`,
    `wave_norms.npz`, `wave.npz` with `fields`, `dt` and `dx`) for
    `phase_1d`'s `run_offline`. Returns the launch counts of the whole
    phase."""
    import torch
    from cppre_torch.cp import calibrate
    from cppre_torch.deploy import CalibratedSurrogate
    from cppre_torch.experiments import jorek, mhd, wave
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk
    from cppre_torch.residuals import PRE_Wave

    mod = {"wave": wave, "mhd": mhd, "jorek": jorek}[family]
    spec = {"wave": WAVE, "mhd": MHD, "jorek": JOREK}[family]
    cfg = {"Epochs": TRAIN_EPOCHS}
    c = dict(mod.CONFIG, **cfg)
    t_in, step, t_out = c["T_in"], c["Step"], c["T_out"]
    captured = {}
    # the run's data, for the serving half: the solver's output, or JOREK's
    # synthetic blobs (R, Z, t, fields)
    maker = "synthetic_blobs" if family == "jorek" else "gen_data"
    make_data = getattr(mod, maker)

    def keep_data(*args, **kwargs):
        out = make_data(*args, **kwargs)
        captured["made"] = out
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    setattr(mod, maker, keep_data)
    try:
        t0 = time.perf_counter()
        out = mod.run("joint", config=cfg, seed=SEED, verbose=False, device=device,
                      return_residuals=True)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    finally:
        setattr(mod, maker, make_data)
    run_counts = K.launch_counts()
    peak_run = torch.cuda.max_memory_allocated(device)
    residual_kernel = "K8" if family == "wave" else "K2"
    if run_counts[residual_kernel] != 4:
        raise AssertionError(f"{family}.run launched {residual_kernel} "
                             f"{run_counts[residual_kernel]} times, expected 4")
    out["eps"] = 0.0 if family == "wave" else EPS
    first, last = check_losses(out["train_losses"], family)
    if family == "jorek":
        R = captured["made"][0]
        data = torch.as_tensor(captured["made"][3], device=device)
    else:
        data, dt, dx = captured["made"]
    say(family, sims=data.shape[0], data_shape=list(data.shape),
        rollout_shape=list(out["pred_cal"].shape[1:]), t_in=t_in, step=step, t_out=t_out,
        **{"data_s" if family == "jorek" else "solver_s": f"{out['data_time']:.2f}"},
        train_s=f"{out['train_time']:.2f}",
        run_s=f"{t_run:.2f}", epochs=len(out["train_losses"]),
        steps_per_epoch=c["n_train"] // c["Batch Size"], loss_first=f"{first:.6f}",
        loss_last=f"{last:.6f}", qhat=f"{float(out['qhat']):.6e}",
        coverage_alpha_0_1=coverage_at_alpha(out), peak_gb=f"{peak_run / 1e9:.2f}",
        launches=json.dumps(run_counts, separators=(",", ":")))

    # ---- the trained model served, then calibrated through K1 (and K9, K3) ----
    n_train, n_cal, n_pred = c["n_train"], c["n_cal"], c["n_pred"]
    cal = slice(n_train, n_train + n_cal)
    cal_a, cal_u = data[cal, ..., :t_in], data[cal, ..., t_in:t_in + t_out]
    new_a = data[n_train + n_cal:n_train + n_cal + n_pred, ..., :t_in]
    if family == "wave":
        kern = PRE_Wave(dt, dx, c["c"]).D.kernel
        residual_fn = lambda f: K.wave_residual_fused(f[:, 0], kern)
    elif family == "mhd":
        residual_fn = lambda f: K.mhd_residual_fused(f, c["equation"])
    else:
        coef = dict(Dc=c["D"], K=c["K"], equation=c["equation"])
        residual_fn = lambda f: K.jorek_residual_fused(f, R, **coef)
    in_n, out_n = out["normalizers"]
    srv = CalibratedSurrogate(out["model"].eval(), residual_fn, step=step, T_out=t_out,
                              in_normalizer=in_n, out_normalizer=out_n, mode="joint",
                              score="aer+pre", fused=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.calibrate(cal_a, cal_u, alpha=ALPHA, eps=EPS)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = srv.predict(new_a)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    pred = served["prediction"]
    want_shape = (n_pred, spec["nvar"], spec["nx"], spec["ny"], t_out)
    if tuple(pred.shape) != want_shape or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"{family}: served prediction {tuple(pred.shape)} is not "
                             f"finite {want_shape}")
    qhat = float(srv.qhat)
    if not np.isfinite(qhat) or qhat <= 0:
        raise AssertionError(f"{family}: qhat {qhat} is not a positive finite score")

    truth_c = srv.layout_fn(cal_u)
    pred_c = srv.layout_fn(srv.predict(cal_a)["prediction"])
    routes = {}
    if family == "wave":
        routes["k1"] = K.wave_joint_cp_scores_fused(truth_c[:, 0], pred_c[:, 0], kern, eps=EPS)
    elif family == "mhd":
        routes["k1"] = K.mhd_induction_joint_cp_scores_fused(truth_c, pred_c, eps=EPS)
        routes["k9"] = K.mhd_induction_joint_cp_scores_fused(truth_c, pred_c, eps=EPS,
                                                             single_pass=True)
    else:
        routes["k1"] = K.jorek_joint_cp_scores_fused(truth_c, pred_c, R, eps=EPS, **coef)
        chunked = K.jorek_joint_cp_diff_stats_chunked(truth_c, pred_c, R, **coef)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_path(family, counts)
    extra = {}
    if family == "jorek":
        # K3's explicit entry against K1 on the same inputs, bit for bit, the
        # centred pass too
        cell = sk._jorek_cell(R, c["D"], c["K"], c["equation"])
        k1 = sk._joint_cp_diff_stats(truth_c, pred_c, cell, centred=True)
        same_bits("K3 vs K1 JOREK calibration", chunked, k1[:3])
        same_bits("K3 vs K1 JOREK calibration, centred", k1,
                  sk._joint_cp_diff_stats_chunked(truth_c, pred_c, cell, centred=True))
        extra = {"k3_vs_k1_bitwise": True, "calibration_shape": json.dumps(list(truth_c.shape))}
        del chunked, k1
    qh = {k: float(calibrate(v, n_cal, ALPHA)) for k, v in routes.items()}
    rel = {k: abs(v - qhat) / qhat for k, v in qh.items()}
    say(f"{family}-serve", qhat_surrogate=f"{qhat:.6e}",
        **{f"qhat_{k}": f"{v:.6e}" for k, v in qh.items()},
        **{f"rel_{k}": f"{v:.3e}" for k, v in rel.items()},
        accept_rate=f"{float(served['accept'].float().mean()):.3f}",
        calibrate_s=f"{t_cal:.3f}", predict_s=f"{t_pred:.3f}",
        peak_gb=f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}", **extra,
        launches=json.dumps(counts, separators=(",", ":")))
    bad = {k: v for k, v in rel.items() if v > 1e-3}
    if bad:
        raise AssertionError(f"{family}: qhat routes {qh} vs surrogate {qhat}: {bad} > 1e-3")
    model = out["model"]
    if keep_dir is not None:
        from cppre_torch.utils import save_checkpoint, save_norms

        stem = os.path.join(keep_dir, family)
        save_checkpoint(stem, model)
        save_norms(stem, in_n, out_n)
        np.savez(stem + ".npz", fields=data[-200:].cpu().numpy(), dt=dt, dx=dx)
    del out, data, captured, srv, served, pred, truth_c, pred_c, routes, cal_a, cal_u, new_a
    torch.cuda.empty_cache()

    step_fn, step_ms = time_train_step(f"{family}-step", model, spec["batch"], spec["nvar"],
                                       spec["nx"], spec["ny"], c["Learning Rate"], device,
                                       SEED + 30, t_in, step, t_out)
    profile_step(step_fn, step_ms, f"one {family} train step")
    del model, step_fn
    torch.cuda.empty_cache()
    return counts


def null_free(z):
    """`z` [B, Nt, Nx] (numpy) less, per sample, its least-squares fit on
    1, (-1)^t, (-1)^x and (-1)^(t+x): the modes where the advection
    stencil's spectrum is 0, where `integrate` divides each FFT library's
    own rounding of that spectrum by eps."""
    z = np.asarray(z, dtype=np.float64)
    t, x = np.meshgrid(np.arange(z.shape[1]), np.arange(z.shape[2]), indexing="ij")
    basis = np.stack([np.ones_like(t), (-1.0) ** t, (-1.0) ** x, (-1.0) ** (t + x)], -1)
    basis = basis.reshape(-1, 4).astype(np.float64)
    flat = z.reshape(z.shape[0], -1).T
    coef = np.linalg.lstsq(basis, flat, rcond=None)[0]
    return (flat - basis @ coef).T.reshape(z.shape)


def time_train_step_1d(what, model, batch, nx, t_in, step, t_out, loss_func, lr, device, seed):
    """One train step of an FNO1d (plain torch: no kernel) at `batch`: the
    median ms of 5, host clock around `synchronize()`. Returns the step
    function and its median ms."""
    import torch
    from cppre_torch.train.loops import make_optimizer, make_train_step

    model = model.train()
    train_step = make_train_step(model, make_optimizer(model.parameters(), lr), step, t_out,
                                 loss_func)
    gen = torch.Generator(device=device).manual_seed(seed)
    xx = torch.rand((batch, 1, nx, t_in), generator=gen, device=device)
    yy = torch.rand((batch, 1, nx, t_out), generator=gen, device=device)
    train_step(xx, yy)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        train_step(xx, yy)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    say(what, batch=batch, nx=nx, rollout_steps=t_out // step, step_ms_median=f"{step_ms:.2f}",
        step_ms=json.dumps([round(t, 2) for t in times]))
    return lambda: train_step(xx, yy), step_ms


def card_vs_cpu(name, fn, args, rel_tol):
    """`fn` on the card's `args` against `fn` on their CPU copies: max abs
    error and its ratio to max |CPU|, raised above `rel_tol`."""
    import torch

    with torch.no_grad():
        got = fn(*args)
        ref = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    return compare(name, got.cpu(), ref, rel_tol)


def phase_1d(device, keep_dir):
    """The 1-D families and the offline pipelines: `advection.run`
    (marginal) and `burgers.run` (joint) at their full CONFIG with Epochs
    cut to 1, one train step of each, the card against the CPU (FNO1d,
    PRE_Advection, PRE_Burgers, ConvOperator1d.integrate),
    `run_initial("Advection")` at its INITIAL_CONFIGS entry, and
    `run_offline` on the wave phase's saved model, normalizers and 200
    samples (exactly 6 K4 and 1 K5 launches a step of one rollout).
    Returns {"initial": launch counts of run_offline}."""
    import torch
    from cppre_torch.experiments import advection, burgers, initial, wave
    from cppre_torch.experiments.pipeline import joint_cp, marginal_cp
    from cppre_torch.models import FNO1d
    from cppre_torch.ops import kernels as K
    from cppre_torch.residuals import PRE_Advection, PRE_Burgers, PRE_Wave
    from cppre_torch.solvers import Advection1D, Burgers1D
    from cppre_torch.train.losses import lp_loss, mse

    at = np.asarray([ALPHA])
    # one epoch: the 1-D steps are host bound (~0.8 s each), and the run's
    # time goes to the later phases
    cfg = {"Epochs": 1}
    torch.cuda.empty_cache()

    # ---- advection, marginal (disc 2), with the inverted bounds ----------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adv = advection.run("marginal", config=cfg, seed=SEED, verbose=False, device=device,
                        return_residuals=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    c = dict(advection.CONFIG, **cfg)
    r = [adv[k] for k in ("res_out_cal", "res_pred_cal", "res_pred_test", "res_out_test")]
    cov = marginal_cp(*r, alphas=at)["coverage"][0]
    lo, up = adv["inverted_bounds"]
    losses = np.asarray(adv["train_losses"])
    if not (np.isfinite(losses).all() and np.isfinite(lo).all() and np.isfinite(up).all()
            and lo.shape == up.shape and (up - lo).mean() > 0):
        raise AssertionError(f"advection: losses {losses.tolist()}, or bounds {lo.shape} not "
                             "finite with upper >= lower on average")
    say("advection", sims=c["n_train"] + c["n_test"] + c["n_cal"] + c["n_pred"],
        grid=[c["Nt"], c["Nx"] - 3], residual_shape=list(r[0].shape),
        solver_s=f"{adv['data_time']:.3f}", train_s=f"{adv['train_time']:.2f}",
        run_s=f"{t_run:.2f}", epochs=len(losses), loss_first=f"{losses[0][0]:.6f}",
        loss_last=f"{losses[-1][0]:.6f}", mse=f"{adv['mse']:.6e}",
        coverage_aer_pre_alpha_0_1=f"{float(cov):.4f}", n_rejected=adv["n_rejected"],
        bounds_shape=list(lo.shape), bounds_gap_mean=f"{float((up - lo).mean()):.6e}")

    # ---- burgers, joint, with the holdout estimator -----------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bur = burgers.run("joint", config=cfg, seed=SEED, verbose=False, device=device,
                      return_residuals=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    cb = dict(burgers.CONFIG, **cfg)
    rb = [bur[k] for k in ("res_out_cal", "res_pred_cal", "res_pred", "res_out_pred")]
    cov_b = {"aer_pre": joint_cp(*rb, alphas=at)["coverage"][0],
             "pre": joint_cp(*rb[:3], alphas=at, mode="pre")["coverage"][0],
             "aer_pre_holdout": joint_cp(*rb, alphas=at, holdout_modulation=True)["coverage"][0]}
    n_rej = int(joint_cp(*rb[:3], mode="pre")["filter_mask"].sum())
    losses_b = np.asarray(bur["train_losses"])
    if not np.isfinite(losses_b).all():
        raise AssertionError(f"burgers losses {losses_b.tolist()} are not finite")
    say("burgers", sims=cb["n_train"] + cb["n_cal"] + cb["n_pred"], grid=[cb["Nt"], cb["Nx"]],
        residual_shape=list(rb[0].shape), solver_s=f"{bur['data_time']:.3f}",
        train_s=f"{bur['train_time']:.2f}", run_s=f"{t_run:.2f}", epochs=len(losses_b),
        loss_first=f"{losses_b[0][0]:.6f}", loss_last=f"{losses_b[-1][0]:.6f}",
        mse=f"{bur['mse']:.6e}", qhat=f"{float(bur['qhat']):.6e}",
        coverage_alpha_0_1=json.dumps({k: round(float(v), 4) for k, v in cov_b.items()}),
        n_rejected=n_rej)
    if cov_b["aer_pre_holdout"] < 0.7:
        raise AssertionError(f"burgers holdout coverage at alpha={ALPHA}: {cov_b}, below 0.7")

    # ---- the card against the CPU: the 1-D path has no kernel -------------
    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    checks = {}
    for fam, out, nx, t_in in (("advection", adv, c["Nx"] - 3, c["T_in"]),
                               ("burgers", bur, cb["Nx"], cb["T_in"])):
        model = out["model"].eval()
        cpu = FNO1d(model.T_in, model.step, model.modes1, model.num_vars, model.width_time,
                    device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        x = torch.rand((100, 1, nx, t_in), generator=gen, device=device)
        with torch.no_grad():
            err = compare(f"{fam} FNO1d card vs CPU", model(x).cpu(), cpu(x.cpu()), 1e-5)
        checks[f"fno1d_{fam}"] = err[1]
    sim = Advection1D(c["Nx"], c["Nt"], c["x_min"], c["x_max"], c["t_end"], device=device)
    u = sim.solve_batch(np.random.default_rng(SEED).uniform(advection.LB, advection.UB,
                                                            (100, 2)), c["v"])[:, ::2]
    pre = PRE_Advection(sim.dt, sim.dx, v=c["v"], disc=2)
    checks["pre_advection"] = card_vs_cpu("PRE_Advection", pre, (u,), 1e-6)[1]
    bsim = Burgers1D(cb["Nx"], cb["Nt"], cb["x_min"], cb["x_max"], cb["t_end"], cb["nu"],
                     device=device)
    ub = bsim.solve_batch(np.random.default_rng(SEED).uniform(burgers.LB, burgers.UB, (100, 3)))
    checks["pre_burgers"] = card_vs_cpu("PRE_Burgers", PRE_Burgers(bsim.dt, bsim.dx, cb["nu"]),
                                        (ub,), 1e-6)[1]
    # integrate: the residual bounds of the run's kind (the uncropped
    # residual + 0.01); at the default eps the stencil's null modes divide
    # each FFT library's rounding by 1e-6, so those modes are taken out
    # before the check (1e-6 of max); at eps 1e-2 the whole field is held,
    # at 1e-4 of max, since 1 / (|K| + eps) scales the two FFT libraries'
    # rounding of the field up to 100-fold
    res = pre(u, boundary=True) + 0.01
    with torch.no_grad():
        got, ref = pre.D.integrate(res).cpu(), pre.D.integrate(res.cpu())
    raw = float((got - ref).abs().max() / ref.abs().max())
    nf = torch.from_numpy(null_free(got.numpy()) - null_free(ref.numpy())).abs().max()
    checks["integrate_raw"] = raw
    checks["integrate_null_free"] = float(nf / ref.abs().max())
    if checks["integrate_null_free"] > 1e-6:
        raise AssertionError(f"ConvOperator1d.integrate card vs CPU outside the null modes: "
                             f"{checks['integrate_null_free']:.3e} of max, above 1e-6")
    checks["integrate_eps_1e-2"] = card_vs_cpu(
        "ConvOperator1d.integrate(eps=1e-2)", lambda z: pre.D.integrate(z, eps=1e-2),
        (res,), 1e-4)[1]
    say("card-vs-cpu", **{k: f"{v:.3e}" for k, v in checks.items()},
        integrate_shape=list(got.shape))
    del u, ub, res, got, ref

    # ---- one train step of each family ----------------------------------
    for fam, out, nx, cc, loss in (("advection", adv, c["Nx"] - 3, c, mse),
                                   ("burgers", bur, cb["Nx"], cb, lp_loss)):
        fn, ms = time_train_step_1d(f"{fam}-step", out["model"], cc["Batch Size"], nx,
                                    cc["T_in"], cc["Step"], cc["T_out"], loss,
                                    cc["Learning Rate"], device, SEED + 71)
        profile_step(fn, ms, f"one {fam} train step")
    del adv, bur
    torch.cuda.empty_cache()

    # ---- Expts_initial: advection at its historical configuration ---------
    ci = dict(advection.CONFIG, **initial.INITIAL_CONFIGS["Advection"], **cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ini = initial.run_initial("Advection", config=cfg, seed=SEED, verbose=False, device=device,
                              return_residuals=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    ri = [ini[k] for k in ("res_out_cal", "res_pred_cal", "res_pred_test", "res_out_test")]
    lo, up = ini["inverted_bounds"]
    if not (np.isfinite(ini["train_losses"]).all() and np.isfinite(lo).all()
            and np.isfinite(up).all()):
        raise AssertionError("run_initial('Advection'): losses or bounds not finite")
    say("initial", case="Advection", t_in=ci["T_in"], t_out=ci["T_out"], step=ci["Step"],
        width=ci["Width"], batch=ci["Batch Size"], solver_s=f"{ini['data_time']:.3f}",
        train_s=f"{ini['train_time']:.2f}", run_s=f"{t_run:.2f}",
        loss_last=f"{ini['train_losses'][-1][0]:.6e}", mse=f"{ini['mse']:.6e}",
        coverage_aer_pre_alpha_0_1=f"{float(marginal_cp(*ri, alphas=at)['coverage'][0]):.4f}",
        n_rejected=ini["n_rejected"], bounds_shape=list(lo.shape))
    del ini, ri

    # ---- run_offline: the saved wave model through K4 and K5 -------------
    stem = os.path.join(keep_dir, "wave")
    z = np.load(stem + ".npz")
    dt, dx = float(z["dt"]), float(z["dx"])
    wc = wave.CONFIG
    ocfg = {"T_in": wc["T_in"], "T_out": wc["T_out"], "Step": wc["Step"], "Modes": wc["Modes"],
            "Variables": wc["Variables"], "Width_time": wc["Width_time"], "n_cal": 100}
    pre_w = PRE_Wave(dt, dx, c=wc["c"])
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = initial.run_offline(data=stem + ".npz", residual_fn=pre_w, cfg=ocfg,
                              ckpt=stem + ".pth", norms=stem + "_norms.npz",
                              invert_with=pre_w.D, verbose=False, device=device)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    counts = K.launch_counts()
    n_steps = ocfg["T_out"] // ocfg["Step"]
    want = {k: 0 for k in counts}
    want.update(K4=6 * n_steps, K5=n_steps)
    lo, up = off["inverted_bounds"]
    say("initial-offline", samples=int(z["fields"].shape[0]), shape=list(z["fields"].shape),
        run_s=f"{t_off:.3f}", mse=f"{off['mse']:.6e}",
        coverage=json.dumps([round(float(v), 4) for v in off["coverage"]]),
        bounds_shape=list(lo.shape), bounds_finite=bool(np.isfinite(lo).all()
                                                        and np.isfinite(up).all()),
        launches=json.dumps(counts, separators=(",", ":")))
    if counts != want:
        raise AssertionError(f"run_offline launches {counts}, expected {want}")
    if not (np.isfinite(lo).all() and np.isfinite(up).all()):
        raise AssertionError("run_offline: inverted bounds not finite")
    check_path("initial", counts)
    torch.cuda.empty_cache()
    return {"initial": counts}


def host_ms(fn, reps=5):
    """Median host milliseconds of `fn` over `reps` calls, each ending in a
    synchronize, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gs_step(model, name, device):
    """One train step of a trained GS surrogate at CONFIG's batch, as
    `run_freegsnke` trains it (`gs._surrogate_step`: after an eager first
    step, a CUDA graph replay), on random data of its shapes: the median
    host ms of 5, then its `[profile]` line."""
    import torch
    from cppre_torch.experiments import gs

    c = gs.CONFIG
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    n = c["n_train"]
    coords = torch.rand((n, 2, c["NR"], c["NZ"]), generator=gen, device=device)
    pf = torch.rand((n, model.n_params), generator=gen, device=device)
    psi = torch.rand((n, 1, c["NR"], c["NZ"]), generator=gen, device=device)
    idx, step = gs._surrogate_step(model, coords, pf, psi, c)
    idx.copy_(torch.arange(idx.numel(), device=device))
    step()          # eager; host_ms's warm-up call captures the graph
    ms = host_ms(step)
    say("gs-step", model=name, batch=idx.numel(), step_ms_median=f"{ms:.3f}")
    profile_step(step, ms, f"one GS {name} train step")


def phase_gs(device):
    """Grad-Shafranov, no kernel (plain torch on the card): the GS residual
    of 512 Solov'ev equilibria at 64^2 on the card against the CPU (1e-6 of
    max); `run_freegsnke()` at its full CONFIG (the CAE: 512 designs, 200
    epochs, batch 32) and with the INR, each: train seconds, MSE, marginal
    and joint coverage at alpha = 0.1, and the gate: the mean |coverage -
    (1 - alpha)| of the marginal diagonal below 0.15; then `run_efit()`."""
    import torch
    from cppre_torch.experiments import gs
    from cppre_torch.experiments.pipeline import joint_cp, marginal_cp
    from cppre_torch.models import ConvAutoencoder
    from cppre_torch.residuals import PRE_GradShafranov
    from cppre_torch.solvers import solovev_batch

    R, Z, _, psi = solovev_batch(gs.CONFIG["n_total"], gs.CONFIG["NR"], gs.CONFIG["NZ"],
                                 seed=SEED)
    pre = PRE_GradShafranov(R, float(R[1] - R[0]), float(Z[1] - Z[0]))
    cpu = pre(torch.from_numpy(psi))
    card = pre(torch.from_numpy(psi).to(device))
    _, rel = compare("GS residual card vs CPU", card.cpu(), cpu, 1e-6)
    say("card-vs-cpu", what="PRE_GradShafranov", shape=list(card.shape), rel=f"{rel:.3e}")
    # the process's first CAE training pays a one-time cost (cuDNN's engines
    # and the first capture of its convolutions, seconds): one epoch of a
    # throwaway CAE on random data of CONFIG's shapes, timed apart
    c = gs.CONFIG
    warm = ConvAutoencoder(grid=(c["NR"], c["NZ"]), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 51)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    n = c["n_train"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs._train_surrogate(warm, rand(n, 2, c["NR"], c["NZ"]), rand(n, 12),
                        rand(n, 1, c["NR"], c["NZ"]), dict(c, Epochs=1))
    torch.cuda.synchronize()
    say("gs-warm", what="one epoch of the first CAE training", s=f"{time.perf_counter() - t0:.3f}")
    del warm
    at = np.asarray([ALPHA])
    for model in ("CAE", "INR"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gs.run_freegsnke(config={"Model": model}, seed=SEED, verbose=False,
                               device=device)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        r = [out[k] for k in ("res_true_cal", "res_pred_cal", "res_pred", "res_true_pred")]
        diag = float(np.mean(np.abs(out["coverage_marginal"] - (1 - out["alphas"]))))
        say("gs", model=model, designs=gs.CONFIG["n_total"], grid=[gs.CONFIG["NR"],
                                                                  gs.CONFIG["NZ"]],
            epochs=gs.CONFIG["Epochs"], batch=gs.CONFIG["Batch Size"],
            train_s=f"{out['train_time']:.2f}", run_s=f"{t_run:.2f}", mse=f"{out['mse']:.6e}",
            coverage_marginal_alpha_0_1=f"{float(marginal_cp(*r, alphas=at)['coverage'][0]):.4f}",
            coverage_joint_alpha_0_1=f"{float(joint_cp(*r, alphas=at, eps=1e-6)['coverage'][0]):.4f}",
            marginal_diagonal=f"{diag:.4f}")
        if not (np.isfinite(out["mse"]) and diag < 0.15):
            raise AssertionError(f"run_freegsnke({model}): mse {out['mse']}, marginal "
                                 f"diagonal {diag:.4f} (gate < 0.15)")
        gs_step(out["model"], model, device)
        del out, r
    t0 = time.perf_counter()
    efit = gs.run_efit(seed=SEED, verbose=False, device=device)
    torch.cuda.synchronize()
    diag = float(np.mean(np.abs(efit["coverage"] - (1 - efit["alphas"]))))
    say("gs-efit", run_s=f"{time.perf_counter() - t0:.3f}", marginal_diagonal=f"{diag:.4f}",
        coverage=json.dumps([round(float(v), 4) for v in efit["coverage"]]))
    if diag >= 0.15:
        raise AssertionError(f"run_efit: marginal diagonal {diag:.4f} (gate < 0.15)")
    torch.cuda.empty_cache()


def _uq_pre_kernel(results, family, kid, pre, fields, plain_ms_fn, n_fields_read, flops_a_cell,
                   library_fn=None, **extra):
    """The UQ harness's PRE on `fields` (a rollout in the convops layout):
    its kernel (`pre`, a `uq.data_loaders.KernelPRE`) against the plain PRE
    class on the same tensor (1e-5 of max), bit-stable on a rerun; times,
    bound (the fields the cell reads, once, and the residual written), the
    time of `library_fn` (one PyTorch call computing the same function;
    its max abs error against the plain result printed beside it) where
    there is one, and the [kernels] line."""
    got = pre.residual(fields)
    ref = pre.pre.residual(fields)
    err, rel = compare(f"{kid} {family} PRE", got, ref, 1e-5)
    same_bits(f"{kid} {family}", got, pre.residual(fields))
    field_bytes = nbytes(fields) // fields.shape[1]
    r = results[(kid, family)] = dict(
        max_abs_err=err, rel_err=rel,
        bound=bound(n_fields_read * field_bytes + nbytes(ref), flops_a_cell * ref.numel()),
        ms=cuda_ms(lambda: pre.residual(fields)), plain_ms=cuda_ms(plain_ms_fn))
    if library_fn is not None:
        lib_err = float((library_fn() - ref).abs().max())
        r["library_ms"] = cuda_ms(library_fn)
        extra.update(library_max_abs_err=f"{lib_err:.3e}")
    report(results, kid, family, shape=list(fields.shape), **extra)


def phase_uq(results, device):
    """The UQ comparison harness (`cppre_torch.uq.run_eval.run`) at the
    shipped configs with Epochs cut from 500 to 2: Wave with all 8 methods,
    then `Dist: "out"` for Deterministic and PRE (the trained weights from
    the train cache), then NS and MHD with `UQ: ["PRE"]`. One line per
    method: l2, coverage, joint coverage, eval_time and the launches of K2
    and K4-K8 in its window (its training included). Gates: AER and PRE
    coverage >= 0.7. Beside it, the kernels at the harness's shapes: the
    PRE scores through K8 (wave; beside conv3d, the library call) and K2
    (NS momentum, MHD energy) against the plain PRE classes on the same
    rollout (1e-5 of max), a Bayesian head draw through K4/K5 against the
    module's forward with the same draw (1e-4 of max), and K4-K7 at the
    wave UQ model's rollout and training batch, at step 1 and at the MLE
    head's step 2. Returns the windows "uq" (Wave), "uq-out", "uq-ns",
    "uq-mhd" and "uq-mle" (the MLE method's share of "uq")."""
    import torch
    import torch.nn.functional as F
    from cppre_torch.models import FNO2d, make_fused_apply
    from cppre_torch.models.variants import FNO2dBayesian, make_dropout_fno
    from cppre_torch.ops import kernels as K
    from cppre_torch.train.rollout import autoregressive_rollout
    from cppre_torch.uq import data_loaders, run_eval
    from cppre_torch.uq import validation as V

    cfg = run_eval.load_config(os.path.join(os.path.dirname(run_eval.__file__), "configs",
                                            "Wave_FNO.yaml"))
    width, modes, t_out = cfg["Width_time"], cfg["Modes"], cfg["T_out"]
    n_eval = 30        # min(n_eval 300, the pool: n_total 60 - n_train 30)
    windows = {}
    # each case's in-distribution data and PRE, simulated once (as `run`
    # would, at the shipped n_total 60 and Seed 0) and shared by its runs
    loads = {"Wave": data_loaders.load_wave, "Navier-Stokes": data_loaders.load_ns,
             "MHD": data_loaders.load_mhd}
    sims = {}
    for case, load in loads.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sims[case] = load("in", n=60, seed=0, device=device)
        torch.cuda.synchronize()
        say("uq-sim", case=case, shape=list(sims[case][0].shape),
            s=f"{time.perf_counter() - t0:.2f}")

    def run_case(case, window, gate, **ov):
        counts, last = {}, {k: 0 for k in K.KERNELS}

        def banked(uq, r):
            now = K.launch_counts()
            counts[uq] = {k: now[k] - last[k] for k in K.KERNELS}
            last.update(now)

        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_eval.run(case, overrides=dict({"Epochs": TRAIN_EPOCHS}, **ov), verbose=False,
                           on_method_done=banked, device=device, case_data=sims[case])
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        windows[window] = K.launch_counts()
        for uq, r in res.items():
            say("uq", case=case, dist=ov.get("Dist", "in"), method=uq,
                l2=f"{r['l2'][0]:.6e}", coverage=f"{r['coverage'][0]:.4f}",
                joint_coverage=f"{r['joint_coverage'][0]:.4f}",
                eval_time_s=f"{r['eval_time'][0]:.4f}",
                launches=json.dumps({k: counts[uq][k] for k in UQ_KERNELS},
                                    separators=(",", ":")))
            if not np.isfinite(r["l2"][0]):
                raise AssertionError(f"uq {case} {uq}: l2 {r['l2']} not finite")
            if uq in gate and r["coverage"][0] < 0.7:
                raise AssertionError(f"uq {case} {uq}: coverage {r['coverage'][0]:.4f} < 0.7")
        say("uq-run", case=case, dist=ov.get("Dist", "in"), run_s=f"{t_run:.2f}",
            launches=json.dumps(windows[window], separators=(",", ":")))
        check_path(window, windows[window])
        return counts

    with tempfile.TemporaryDirectory(prefix="chip_smoke_uq_") as cache:
        # the MLE model's training and rollouts, its head at step 2
        windows["uq-mle"] = run_case("Wave", "uq", ("AER", "PRE"), train_cache_dir=cache)["MLE"]
        check_path("uq-mle", windows["uq-mle"])
        run_case("Wave", "uq-out", ("AER", "PRE"), UQ=["Deterministic", "PRE"], Dist="out",
                 train_cache_dir=cache)
    run_case("Navier-Stokes", "uq-ns", ("PRE",), UQ=["PRE"])
    run_case("MHD", "uq-mhd", ("PRE",), UQ=["PRE"])

    # ---- the kernels at the harness's shapes, on its data and PREs ---------
    gen = torch.Generator().manual_seed(SEED + 60)
    for case, window, nvar, kid in (("Wave", "uq", 1, "K8"), ("Navier-Stokes", "uq-ns", 3, "K2"),
                                    ("MHD", "uq-mhd", 6, "K2")):
        data, pre, _ = sims.pop(case)
        data = data[:n_eval]
        model = FNO2d(1, 1, modes, modes, nvar, width, device=device, generator=gen).eval()
        with torch.no_grad():
            pred = autoregressive_rollout(make_fused_apply(model), data[..., :1].contiguous(),
                                          1, t_out)
        fields = pred.permute(0, 1, 4, 2, 3).contiguous()
        if kid == "K8":
            kern = pre.pre.D.kernel
            w = torch.as_tensor(kern, device=device)[None, None]
            _uq_pre_kernel(results, window, kid, pre, fields,
                           lambda: K.fused_stencil_residual_plain(fields[:, 0], kern), 1,
                           2 * int(np.count_nonzero(kern)) - 1,
                           library_fn=lambda: F.conv3d(fields, w)[:, 0],
                           library="torch.nn.functional.conv3d")
        elif nvar == 3:
            _uq_pre_kernel(results, window, kid, pre, fields,
                           lambda: pre.pre.residual(fields), NS_FIELDS, NS_RES_FLOPS)
        else:
            _uq_pre_kernel(results, window, kid, pre, fields,
                           lambda: pre.pre.residual(fields), MHD_FIELDS["energy"],
                           MHD_RES_FLOPS["energy"], equation="energy")
        del data, pre, pred, fields
    torch.cuda.empty_cache()

    # a Bayesian head draw through K4/K5 against the module's forward
    bayes = FNO2dBayesian(1, 1, modes, modes, 1, width, device=device, generator=gen)
    x = torch.randn((n_eval, 1, 64, 64, 1), generator=torch.Generator(device=device)
                    .manual_seed(SEED + 61), device=device)
    head = bayes.sample_head(torch.Generator(device=device).manual_seed(SEED + 62))
    with torch.no_grad():
        got = make_fused_apply(bayes, head=head)(x)
        ref = bayes(x, head=head)
    _, rel = compare("Bayesian draw K4/K5 vs forward", got, ref, 1e-4)
    say("uq-bayes", shape=list(x.shape), rel=f"{rel:.3e}")
    del bayes, x, got, ref
    fno_kernels(results, "uq", device, width, modes, 1, 64, 64, n_eval, n_eval, SEED + 63)
    # K5 and K7 at the MLE head's step 2 (mean and log-variance), at the
    # rollout and training batch (Batch Size 50 over n_train 30)
    fno_kernels(results, "uq-mle", device, width, modes, 1, 64, 64, n_eval, n_eval, SEED + 66,
                step=2 * cfg["Step"])

    # one MC-dropout forward (the module's own, dropout live) at the
    # harness's shape, the path the fused applies must refuse: eager, and
    # as the harness runs it, a CUDA graph (`validation._DropoutForward`)
    drop = make_dropout_fno(1, 1, modes, modes, 1, width, device=device, generator=gen)
    x = torch.rand((n_eval, 1, 64, 64, 1), generator=torch.Generator(device=device)
                   .manual_seed(SEED + 64), device=device)
    masks = torch.Generator(device=device).manual_seed(SEED + 65)
    graphed, state = V._DropoutForward(drop, masks), masks.get_state()
    with torch.no_grad():
        eager_ms = host_ms(lambda: drop(x, deterministic=False, generator=masks))
        fwd = lambda: graphed(x, state)
        fwd()       # eager; host_ms's warm-up call captures the graph
        ms = host_ms(fwd)
        say("uq-dropout", shape=list(x.shape), forward_ms_median=f"{eager_ms:.3f}",
            graphed_ms_median=f"{ms:.3f}")
        profile_step(fwd, ms, "one MC-dropout forward (graphed)")
    return windows


def _k8_pi_kernels(results, kern, asym, device):
    """K8 at the physics-informed loss's shape: the rollout's interior
    [50, 18, 62, 62] zero-padded to [50, 20, 64, 64] (`fused_stencil_same`,
    the pad and K8) against its plain version, and K8's backward
    (`fused_stencil_residual_bwd`: K8 on the cotangent padded by 1 with the
    flipped stencil) against autograd of the plain twin, on the wave stencil
    and on a random asymmetric 3x3x3 stencil, both 1e-5 of max; then the
    wave stencil's times, bounds (the unpadded field or cotangent in, the
    result out) and the library's: conv3d (padding 1) for the forward,
    conv3d's input gradient (`torch.autograd.grad`) for the backward."""
    import torch
    import torch.nn.functional as F
    from cppre_torch.ops import kernels as K

    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    shape = (WAVE["batch"], T_OUT - 2, WAVE["nx"] - 2, WAVE["ny"] - 2)
    f = torch.randn(shape, generator=gen, device=device)
    g = torch.randn(shape, generator=gen, device=device)
    for name, k in (("wave", kern), ("asymmetric", asym)):
        x = f.clone().requires_grad_(True)
        out = K.fused_stencil_same(x, k)
        (got,) = torch.autograd.grad(out, x, g)
        compare(f"K8 same {name}", out.detach(), K.fused_stencil_same_plain(f, k), 1e-5)
        ref = K.fused_stencil_residual_bwd_plain(g, k, 1)
        err, rel = compare(f"K8-bwd {name}", got, ref, 1e-5)
        compare(f"K8-bwd wrapper {name}", K.fused_stencil_residual_bwd(g, k, 1), ref, 1e-5)
        say("k8-adjoint", stencil=name, shape=list(shape), max_abs_err=f"{err:.3e}",
            rel_err=f"{rel:.3e}")
        del x, out, got
    n_taps = int(np.count_nonzero(kern))
    w = torch.as_tensor(kern, device=device)[None, None]
    xl = f[:, None].clone().requires_grad_(True)
    yl = F.conv3d(xl, w, padding=1)
    lib_bwd = lambda: torch.autograd.grad(yl, xl, g[:, None], retain_graph=True)[0]
    ref = K.fused_stencil_same_plain(f, kern)
    fwd_err = compare("K8 pi", K.fused_stencil_same(f, kern), ref, 1e-5)
    results[("K8", "pi")] = dict(
        max_abs_err=fwd_err[0], rel_err=fwd_err[1],
        bound=bound(nbytes(f, ref), (2 * n_taps - 1) * ref.numel()),
        ms=cuda_ms(lambda: K.fused_stencil_same(f, kern)),
        plain_ms=cuda_ms(lambda: K.fused_stencil_same_plain(f, kern)),
        library_ms=cuda_ms(lambda: F.conv3d(f[:, None], w, padding=1)))
    dev_ms = device_ms(lambda: K.fused_stencil_same(f, kern))
    report(results, "K8", "pi", shape=list(f.shape), launched_on=[shape[0]] + [
        n + 2 for n in shape[1:]], device_ms="not measured" if dev_ms is None else
        f"{dev_ms:.4f} (pad and K8)", library="torch.nn.functional.conv3d (padding 1)")
    ref = K.fused_stencil_residual_bwd_plain(g, kern, 1)
    err, rel = compare("K8-bwd pi", K.fused_stencil_residual_bwd(g, kern, 1), ref, 1e-5)
    lib_err = float((lib_bwd()[:, 0] - ref).abs().max())
    results[("K8-bwd", "pi")] = dict(
        max_abs_err=err, rel_err=rel,
        bound=bound(nbytes(g, ref), (2 * n_taps - 1) * ref.numel()),
        ms=cuda_ms(lambda: K.fused_stencil_residual_bwd(g, kern, 1)),
        plain_ms=cuda_ms(lambda: K.fused_stencil_residual_bwd_plain(g, kern, 1)),
        library_ms=cuda_ms(lib_bwd))
    dev_ms = device_ms(lambda: K.fused_stencil_residual_bwd(g, kern, 1))
    report(results, "K8-bwd", "pi", cotangent=list(g.shape), launched_on=[shape[0]] + [
        n + 2 for n in shape[1:]], device_ms="not measured" if dev_ms is None else
        f"{dev_ms:.4f} (pad and K8)", library="conv3d input gradient (torch.autograd.grad)",
        library_max_abs_err=f"{lib_err:.3e}")
    del f, g, xl, yl, ref
    torch.cuda.empty_cache()


def _pi_step(model, kern, device):
    """One physics-informed train step of `model` at the PI batch (`kern`
    the PI residual's stencil): `finetune_physics_informed` for one epoch
    of one batch (rollout of T_OUT checkpointed steps through K4-K7, the PI
    loss through K8 and K8's backward, clip, Adam), on random inputs: its
    launches (K4 12 n, K5 2 n, K6 6 n, K7 n, K8 and K8-bwd 1 each) and
    median ms of 5, then its `[profile]` line."""
    import torch
    from cppre_torch.experiments import pi_wave
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.ops import kernels as K
    from cppre_torch.pi import StencilOperator, finetune_physics_informed, make_pi_loss
    from cppre_torch.pi.losses import fno_chunk_residual

    apply_fn = make_fused_train_apply(model.train())
    loss_fn = make_pi_loss(fno_chunk_residual(StencilOperator(kern)))
    n = WAVE["batch"]
    xx = torch.rand((n, 1, WAVE["nx"], WAVE["ny"], 1),
                    generator=torch.Generator(device=device).manual_seed(SEED + 71), device=device)
    yy = torch.zeros((n, 1, WAVE["nx"], WAVE["ny"], T_OUT), device=device)   # unused by PI

    def step():
        finetune_physics_informed(apply_fn, model, xx, yy, loss_fn=loss_fn, epochs=1,
                                  batch_size=n, step=1, T_out=T_OUT,
                                  lr=pi_wave.PI_CONFIG["Learning Rate"])

    step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    per_step = K.launch_counts()
    want = {"K4": 240, "K5": 40, "K6": 120, "K7": 20, "K8": 1, "K8-bwd": 1}
    ms = host_ms(step)
    say("pi-step", batch=n, rollout_steps=T_OUT, step_ms_median=f"{ms:.2f}",
        launches_per_step=json.dumps({k: per_step[k] for k in want}, separators=(",", ":")))
    if any(per_step[k] != v for k, v in want.items()):
        raise AssertionError(f"pi-step: launches {per_step}, expected {want}")
    profile_step(step, ms, "one PI wave train step")


def phase_al_pi(results, device):
    """Active learning and physics-informed training, at the wave family's
    full width (FNO width 32, modes 16, 64^2, T_out 20, step 1): K8's
    backward against autograd of its plain twin (`_k8_pi_kernels`);
    `pi_wave.run("pi", "finetune")` with n_train 50 (one batch), 1 pretrain
    epoch and 5 PI epochs: MSE and |PRE| before and after, the PI loss of
    the first and last steps (the last must be lower), the window's
    launches (K4-K7, K8 and K8-bwd all launched), then one PI step
    (`_pi_step`); `al_more.run("wave", "CP")` with cppre's pool of 100
    candidates, n_train 50, n_cal 100, 1 epoch, 1 iteration: test_mse,
    sims_sampled, the run's launches; then the run's pretrain and
    calibration again (`al_more.loop_inputs`) and its AL iteration
    (`active_learning_loop`) counted (K4, K5, K8 in acquisition, K6, K7 in
    the fine-tune), timed and profiled; the 1-D drivers once each at cut counts (plain
    torch), and `EulerFVRHS` at [8, 4, 128, 128] with a backward. Returns
    the windows "pi" and "al"."""
    import torch
    import torch.nn.functional as F
    from cppre_torch.al import active_learning_loop
    from cppre_torch.experiments import al_advection, al_more, pi_advection, pi_wave, wave
    from cppre_torch.ops import kernels as K
    from cppre_torch.residuals import PRE_Wave
    from cppre_torch.solvers.cns_differentiable import EulerFVRHS

    t_phase = time.perf_counter()
    sim = wave._sim(wave.CONFIG, device)
    kern = PRE_Wave(sim.dt * wave.CONFIG["t_slice"], sim.dx, 0.5).D.kernel
    asym = np.random.default_rng(SEED + 72).standard_normal((3, 3, 3)).astype(np.float32)
    _k8_pi_kernels(results, kern, asym, device)
    windows = {}

    # ---- PI wave: the loss through K8 forward and backward ----------------
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pi_wave.run("pi", "finetune", config={"n_train": WAVE["batch"], "n_test": 20,
                                                "Epochs": 1, "PI_Epochs": 5},
                      verbose=False, device=device)
    torch.cuda.synchronize()
    windows["pi"] = K.launch_counts()
    pi_losses = out["pi_losses"]        # one batch an epoch: the loss of each step
    nums = [out[k] for k in ("mse_before", "mse_after", "pre_before", "pre_after")] + pi_losses
    say("pi", run_s=f"{time.perf_counter() - t0:.2f}", mse=f"{out['mse_before']:.6e}->"
        f"{out['mse_after']:.6e}", pre=f"{out['pre_before']:.6e}->{out['pre_after']:.6e}",
        pi_loss_first=f"{pi_losses[0]:.6e}", pi_loss_last=f"{pi_losses[-1]:.6e}",
        steps=len(pi_losses), launches=json.dumps(windows["pi"], separators=(",", ":")))
    check_path("pi", windows["pi"])
    if not np.all(np.isfinite(nums)) or not pi_losses[-1] < pi_losses[0]:
        raise AssertionError(f"pi: losses {pi_losses} must be finite and fall; {out}")
    _pi_step(out["model"], kern, device)
    del out
    torch.cuda.empty_cache()

    # ---- AL wave: CP acquisition over 100 candidates ------------------------
    cfg = {"n_train": WAVE["batch"], "n_test": 20, "n_cal": 100, "n_pred": 100, "Epochs": 1,
           "n_iterations": 1}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = al_more.run("wave", "CP", config=cfg, verbose=False, device=device)
    torch.cuda.synchronize()
    windows["al"] = K.launch_counts()
    run_s = time.perf_counter() - t0
    check_path("al", windows["al"])
    if not np.all(np.isfinite(out["test_mse"])):
        raise AssertionError(f"al: test_mse {out['test_mse']} not finite")
    # the AL iteration alone: the run's pretrain and calibration
    # (`loop_inputs`), then its loop from the same weights twice, counted
    # and timed, then under the profiler
    kw = al_more.loop_inputs("wave", "CP", config=cfg, verbose=False, device=device)
    start = copy.deepcopy(kw["model"].state_dict())

    def iteration():
        kw["model"].load_state_dict(start)
        return active_learning_loop(**kw)

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    iteration_s, counts = time.perf_counter() - t0, K.launch_counts()
    say("al", case="wave", acq="CP", run_s=f"{run_s:.2f}",
        test_mse=json.dumps([round(m, 8) for m in out["test_mse"]]),
        sims_sampled=out["sims_sampled"], iteration_s=f"{iteration_s:.2f}",
        iteration_launches=json.dumps({k: counts[k] for k in ("K4", "K5", "K6", "K7", "K8")},
                                      separators=(",", ":")),
        launches=json.dumps(windows["al"], separators=(",", ":")))
    if any(counts[k] == 0 for k in ("K4", "K5", "K6", "K7", "K8")):
        raise AssertionError(f"al: the iteration launched {counts}")
    profile_step(iteration, iteration_s * 1e3, "one AL wave iteration (CP, 100 candidates)")
    del out, kw, start, iteration
    # K8 at the acquisition's shape: the pool's 100 rollouts
    gen = torch.Generator(device=device).manual_seed(SEED + 73)
    pool = torch.randn((cfg["n_pred"], T_OUT, WAVE["nx"], WAVE["ny"]), generator=gen,
                       device=device)
    ref = K.fused_stencil_residual_plain(pool, kern)
    err, rel = compare("K8 al", K.wave_residual_fused(pool, kern), ref, 1e-5)
    w = torch.as_tensor(kern, device=device)[None, None]
    results[("K8", "al")] = dict(
        max_abs_err=err, rel_err=rel,
        bound=bound(nbytes(pool, ref), (2 * int(np.count_nonzero(kern)) - 1) * ref.numel()),
        ms=cuda_ms(lambda: K.wave_residual_fused(pool, kern)),
        plain_ms=cuda_ms(lambda: K.fused_stencil_residual_plain(pool, kern)),
        library_ms=cuda_ms(lambda: F.conv3d(pool[:, None], w)))
    report(results, "K8", "al", shape=list(pool.shape), library="torch.nn.functional.conv3d")
    del pool, ref
    torch.cuda.empty_cache()

    # ---- the 1-D drivers, plain torch --------------------------------------
    cut = {"n_train": 10, "n_test": 10, "n_cal": 20, "n_pred": 20, "Epochs": 1,
           "n_iterations": 1}
    runs = {"al_advection": lambda: al_advection.run("PRE", config=cut, verbose=False,
                                                     device=device)["PRE"],
            "al_more-burgers": lambda: al_more.run("burgers", "PRE", config=cut, verbose=False,
                                                   device=device),
            "pi_advection": lambda: pi_advection.run("finetune", config={**cut, "PI_Epochs": 2},
                                                     verbose=False, device=device)}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        vals = (r["test_mse"] if "test_mse" in r else
                [r[k] for k in ("mse_before", "mse_after", "pre_before", "pre_after")])
        say("al-pi-1d", driver=name, wall_s=f"{time.perf_counter() - t0:.2f}",
            values=json.dumps([round(float(v), 8) for v in vals]),
            sims_sampled=r.get("sims_sampled", "-"))
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{name}: {vals} not finite")

    # ---- EulerFVRHS on the card, with a backward ---------------------------
    fields = torch.rand((8, 4, 128, 128), generator=gen, device=device) + 0.5
    fields.requires_grad_(True)
    rhs = EulerFVRHS(1 / 128, 1 / 128)(fields)
    (rhs ** 2).mean().backward()
    finite = bool(torch.isfinite(rhs).all()) and bool(torch.isfinite(fields.grad).all())
    rhs = rhs.detach()
    say("cns", shape=list(fields.shape), rhs_max=f"{float(rhs.abs().max()):.6e}",
        grad_max=f"{float(fields.grad.abs().max()):.6e}", finite=finite)
    if not finite:
        raise AssertionError("EulerFVRHS or its gradient is not finite")
    say("al-pi", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return windows


# set propagation at a prediction set's size: B trajectories of NT_SETS
# steps (N = NT_SETS + 2 cells after the zero padding)
SETS_B, NT_SETS = 4096, 998
# node.run's epochs: sho at cppre's 300, the other three cut to keep the
# phase near two minutes (the fit integrates at rtol = atol = 1.4e-8)
NODE_EPOCHS = {"sho": 300, "dho": 10, "bessel": 10, "cauchy_euler": 10}
# the bf16 run_2d_cp's training samples (of ns.CONFIG's 100): 5 steps
BF16_RUN_TRAIN = 25


def _set_pre_f64(x):
    """`set_pre_batched`'s bounds of x [B, Nt] in float64 numpy: the same
    FFT convolution, cell policy and propagation, exact phases."""
    n = x.shape[-1] + 2
    kernel = np.concatenate(([1.0, -2.0 + 0.1010101 ** 2, 1.0], np.zeros(n - 3)))
    k_hat = np.fft.fft(kernel)
    conv = np.real(np.fft.ifft(np.fft.fft(np.pad(x.astype(np.float64), ((0, 0), (1, 1))))
                               * k_hat))
    idx = np.arange(n)
    edge = (idx <= 3) | (idx == n - 1)
    inv = 1.0 / (k_hat + 1e-16)
    centres = np.real(np.fft.ifft(np.fft.fft(np.where(edge, conv, 0.0)) * inv))
    w = np.abs(np.real(inv[None, :] * np.exp(2j * np.pi * np.outer(idx, idx) / n))).sum(1)
    radii = np.where(edge, 0.0, np.abs(conv)) @ w[(idx[:, None] - idx[None, :]) % n].T / n
    return centres - radii, centres + radii


def _sets_phase(device):
    """`set_pre_batched` at [SETS_B, NT_SETS] on the card against the same
    call on the CPU (2e-5 of max|bound|: each float32 result lies up to
    ~9e-6 of it from the float64 bounds, printed for 256 rows, since the
    FFT's rounding of the padded trajectory reaches the radii through
    |residual|), containment of every padded trajectory, its ms and the
    radius product's share of them, and `set_PRE` on one trajectory against
    the batched row (2e-4 of the bound scale: float64 intervals against
    float32, cppre's own test's bound)."""
    import torch
    from cppre_torch.sets import set_PRE, set_pre_batched
    from cppre_torch.sets.interval_fft import _lag_kernel

    r = np.random.default_rng(SEED + 80)
    t = np.arange(NT_SETS) * 0.1010101
    x = (np.cos(t * r.uniform(0.8, 1.2, (SETS_B, 1))) * r.uniform(0.5, 1.5, (SETS_B, 1))
         + 0.01 * r.standard_normal((SETS_B, NT_SETS))).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    lo, up = set_pre_batched(xd, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clo, cup = set_pre_batched(x, device="cpu")
    cpu_s = time.perf_counter() - t0
    compare("set_pre_batched lower, card vs cpu", lo.cpu(), clo, 2e-5)
    err, rel = compare("set_pre_batched upper, card vs cpu", up.cpu(), cup, 2e-5)
    lo64, up64 = _set_pre_f64(x[:256])
    scale64 = max(np.abs(lo64).max(), np.abs(up64).max())
    f64_rel = {name: max(np.abs(a[:256].cpu().numpy() - lo64).max(),
                         np.abs(b[:256].cpu().numpy() - up64).max()) / scale64
               for name, a, b in (("card", lo, up), ("cpu", clo, cup))}
    padded = torch.nn.functional.pad(xd, (1, 1))
    contained = bool((lo <= padded).all()) and bool((up >= padded).all())
    if not contained:
        raise AssertionError("set_pre_batched: a padded trajectory leaves its bounds")
    n = NT_SETS + 2
    ms = cuda_ms(lambda: set_pre_batched(xd, device=device))
    # the radius map alone: [B, N] x [N, N] (the lag kernel built outside)
    kernel = np.concatenate(([1.0, -2.0 + 0.1010101 ** 2, 1.0], np.zeros(n - 3)))
    C = torch.as_tensor(1.0 / (np.fft.fft(kernel) + 1e-16), device=device).to(torch.complex64)
    w = _lag_kernel(C)
    h = torch.arange(n, device=device)
    W = w[(h[:, None] - h[None, :]) % n].T.contiguous()
    radii = (up - lo) / 2
    product_ms = cuda_ms(lambda: radii @ W / n)
    one = np.array(set_PRE(x[0], device=device))
    scale = float(cup.abs().max())
    row_err = float(max(np.abs(one[:, 0] - clo[0].numpy()).max(),
                        np.abs(one[:, 1] - cup[0].numpy()).max()))
    say("sets", shape=[SETS_B, NT_SETS], cells=n, max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        card_vs_f64_rel=f"{f64_rel['card']:.3e}", cpu_vs_f64_rel=f"{f64_rel['cpu']:.3e}",
        contained=contained, ms=f"{ms:.4f}", radius_product_ms=f"{product_ms:.4f}",
        product_share=f"{product_ms / ms:.3f}",
        product_bound_ms=f"{bound(nbytes(radii, W, radii), 2 * SETS_B * n * n)[0]:.4f}",
        cpu_s=f"{cpu_s:.3f}", set_PRE_vs_row_rel=f"{row_err / scale:.3e}")
    if row_err > 2e-4 * scale:
        raise AssertionError(f"set_PRE vs set_pre_batched's row: {row_err:.3e} > 2e-4 of "
                             f"{scale:.3e}")


def _node_phase(device):
    """`node.run` for each problem at cppre's defaults (n_train 4, n_cal 32,
    n_pred 16, Nt 100, width 50), epochs `NODE_EPOCHS`: mse, coverage at
    alpha 0.1 (>= 0.7), qhat, the round trip, the run's and its fit's wall s
    and the rollouts' accepted and
    rejected steps; then with the trained sho and bessel fields, a family
    of 16 against the per-sample loop on the card (1e-6 of max|y|) and the steps
    of one trajectory at the fit's tolerance (1.4e-8) and at
    neural_odeint's (1e-6 / 1e-7)."""
    import torch
    from cppre_torch.node import experiments as node_exp
    from cppre_torch.node import neural_odeint

    trained = {}
    for problem in node_exp.PROBLEMS:
        epochs = NODE_EPOCHS[problem]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = node_exp.run(problem, epochs=epochs, seed=SEED, verbose=False, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        q = out["qhat"]
        say("node", problem=problem, epochs=f"{epochs} of 300", wall_s=f"{wall:.2f}",
            fit_s=f"{out['fit_s']:.2f}",
            mse=f"{out['mse']:.6e}", coverage=f"{out['coverage']:.4f}",
            qhat_mean=f"{float(np.mean(q)):.6e}", qhat_max=f"{float(np.max(q)):.6e}",
            roundtrip_err=f"{out['roundtrip_err']:.6e}",
            fit_loss=f"{out['fit_losses'][0]:.6e}->{out['fit_losses'][-1]:.6e}",
            rollout_steps=json.dumps(out["steps"], separators=(",", ":")))
        vals = [out["mse"], out["roundtrip_err"], *out["fit_losses"]] + list(np.ravel(q))
        if not np.all(np.isfinite(vals)) or out["coverage"] < 0.7:
            raise AssertionError(f"node {problem}: not finite, or coverage "
                                 f"{out['coverage']} < 0.7")
        trained[problem] = out["model"]
    for problem in ("sho", "bessel"):
        model = trained[problem]
        t = node_exp._domain(problem, 100, None)
        fam = node_exp._trajectories(problem, 16, t, SEED + 1)
        with torch.no_grad():
            ys = neural_odeint(model, fam[:, 0], t)
            loop = torch.stack([neural_odeint(model, y, t) for y in fam[:, 0]])
            _, fit_steps = neural_odeint(model, fam[0, 0], t, rtol=1.4e-8, atol=1.4e-8,
                                         return_stats=True)
            _, run_steps = neural_odeint(model, fam[0, 0], t, return_stats=True)
        err, rel = compare(f"node {problem} family vs per-sample loop", ys, loop, 1e-6)
        steps = lambda s: f"{int(s['accepted'][0])}+{int(s['rejected'][0])}"
        say("node-family", problem=problem, family=list(fam.shape[:2]),
            max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
            steps_at_fit_tol=steps(fit_steps), steps_at_odeint_tol=steps(run_steps))


def _train_opts_phase(device):
    """The training options at the NS flagship's width (FNO2d modes 8, 3
    variables, width 16, 100^2, T_out 20, batch 5): one train step through
    K4-K7 at "highest", "high", "default" and "highest" again (launches K4
    240, K5 40, K6 120, K7 20 a step; median ms of 5), "bf16" on the plain
    path (no K4-K7; median of 3: a plain step takes ~2 s), `remat_policy`
    None / "dots" / "dots_no_batch" on the plain path (the loss and
    gradients equal to None's within 1e-6 of max; the ms and peak memory of
    that one call, the model's first at its policy), the precision flags back at "highest" and False after every
    step; then `run_2d_cp(fused_train=False, train_precision="bf16")` at 1
    epoch on smooth fields, n_train cut to `BF16_RUN_TRAIN` (finite qhat,
    holdout coverage, no K6/K7). Returns the window's launch counts."""
    import torch
    from cppre_torch.experiments import ns
    from cppre_torch.experiments.base2d import run_2d_cp
    from cppre_torch.models import make_fused_train_apply, with_train_precision
    from cppre_torch.ops import kernels as K
    from cppre_torch.train.loops import make_optimizer, make_train_step, rollout_loss
    from cppre_torch.train.losses import lp_loss

    def flags_restored(what):
        got = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        if got != ("highest", False, False):
            raise AssertionError(f"{what}: precision flags {got} after the step")

    gen = torch.Generator(device=device).manual_seed(SEED + 90)
    xx = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_IN), generator=gen, device=device)
    yy = torch.rand((TRAIN_BATCH, NVAR, NX, NY, T_OUT), generator=gen, device=device)
    n = T_OUT // STEP
    K.reset_launch_counts()
    window = K.launch_counts()
    # "highest" twice, first and last, for the spread between turns
    for turn, precision in enumerate(("highest", "high", "default", "bf16", "highest")):
        model = build_model(device).train()
        apply = model if precision == "bf16" else make_fused_train_apply(model)
        step = make_train_step(with_train_precision(apply, precision),
                               make_optimizer(model.parameters(), 5e-3), STEP, T_OUT, lp_loss)
        step(xx, yy)
        torch.cuda.synchronize()
        flags_restored(precision)
        before = K.launch_counts()
        loss, _ = step(xx, yy)
        torch.cuda.synchronize()
        per_step = {k: K.launch_counts()[k] - before[k] for k in ("K4", "K5", "K6", "K7")}
        flags_restored(precision)
        ms = host_ms(lambda: step(xx, yy), reps=3 if precision == "bf16" else 5)
        flags_restored(precision)
        want = ({k: 0 for k in per_step} if precision == "bf16"
                else {"K4": 12 * n, "K5": 2 * n, "K6": 6 * n, "K7": n})
        say("train-opts", precision=precision, turn=turn,
            route="plain" if precision == "bf16" else "K4-K7",
            step_ms_median=f"{ms:.2f}", of=3 if precision == "bf16" else 5,
            loss=f"{float(loss):.6e}",
            launches_per_step=json.dumps(per_step, separators=(",", ":")))
        if per_step != want or not np.isfinite(float(loss)):
            raise AssertionError(f"train-opts {precision}: launches {per_step}, expected {want},"
                                 f" loss {float(loss)}")
        del model, step
    ref = None
    for policy in (None, "dots", "dots_no_batch"):
        model = build_model(device).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        loss, _ = rollout_loss(model, xx, yy, STEP, T_OUT, lp_loss, remat_policy=policy)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, grads = loss.detach(), [p.grad for p in model.parameters()]
        peak_gb = (torch.cuda.max_memory_allocated(device) - base) / 1e9
        flags_restored(f"remat {policy}")
        if ref is None:
            ref = (loss, grads)
            err = 0.0
        else:
            err, _ = compare(f"remat {policy} loss", loss, ref[0], 1e-6)
            for g, r in zip(grads, ref[1]):
                if g.is_complex():
                    g, r = torch.view_as_real(g), torch.view_as_real(r)
                err = max(err, compare(f"remat {policy} gradient", g, r, 1e-6)[0])
        say("train-opts", remat_policy=policy, route="plain", loss_and_grads_ms=f"{ms:.2f}",
            peak_gb=f"{peak_gb:.3f}", max_abs_err_vs_none=f"{err:.3e}")
        del model, grads
    ref = None
    torch.cuda.empty_cache()
    # run_2d_cp trains in bf16 on the plain path; the CP phase stays float32
    data_np, _ = smooth_fields(N_ALL, T_IN + T_OUT, NX, NY, SEED + 91, layout="fno")
    cfg = dict(ns.CONFIG, Epochs=1, n_train=BF16_RUN_TRAIN)
    data_np = data_np[ns.CONFIG["n_train"] - BF16_RUN_TRAIN:]
    before = K.launch_counts()
    t0 = time.perf_counter()
    out = run_2d_cp(data=data_np, cfg=cfg, verbose=False, fused_train=False,
                    train_precision="bf16", device=device, return_residuals=True,
                    residual_fn=lambda f: K.ns_momentum_residual_fused(f, DT, DX, DY, NU))
    torch.cuda.synchronize()
    counts = {k: K.launch_counts()[k] - before[k] for k in ("K2", "K4", "K5", "K6", "K7")}
    flags_restored("run_2d_cp bf16")
    cov = coverage_at_alpha(out)
    qhat = float(out["qhat"])
    say("train-opts", run="run_2d_cp(fused_train=False, train_precision='bf16')", epochs=1,
        n_train=f"{BF16_RUN_TRAIN} of 100", n_cal=cfg["n_cal"], n_pred=cfg["n_pred"],
        run_s=f"{time.perf_counter() - t0:.2f}", train_s=f"{out['train_time']:.2f}",
        loss=f"{out['train_losses'][0][0]:.6f}", qhat=f"{qhat:.6e}", coverage_alpha_0_1=cov,
        launches=json.dumps(counts, separators=(",", ":")))
    if not np.isfinite(qhat) or counts["K6"] or counts["K7"] or not counts["K4"]:
        raise AssertionError(f"run_2d_cp bf16: qhat {qhat}, launches {counts}")
    del out, data_np
    torch.cuda.empty_cache()
    return {k: v - window[k] for k, v in K.launch_counts().items()}


def phase_sets_node(device):
    """Set propagation, the neural-ODE studies (plain torch on the card, as
    they are XLA in cppre: no kernel) and the training options (K4-K7 under
    each precision). Imports scipy first: `node`'s Bessel problem needs
    `scipy.special`, `sets.Zonotope` `scipy.optimize`. Returns the window
    "train-opts"."""
    import scipy.optimize  # noqa: F401
    import scipy.special  # noqa: F401
    import torch

    t_phase = time.perf_counter()
    _sets_phase(device)
    torch.cuda.empty_cache()
    _node_phase(device)
    windows = {"train-opts": _train_opts_phase(device)}
    check_path("train-opts", windows["train-opts"])
    say("sets-node", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return windows


def _wave_composite_kernel():
    """cppre's scaling-study wave kernel (scripts/bench_scaling.py:152-156):
    D_tt - 0.25 D_xxyy, 7 taps."""
    from cppre_torch.ops.stencils import embed_kernel_3d, stencil_2d

    lap = np.asarray(stencil_2d(2))
    return np.asarray(embed_kernel_3d(lap, 2) - 0.25 * embed_kernel_3d(lap, 0), np.float32)


def phase_scaling(results, device):
    """K3 at cppre's grid-scaling shapes, through the explicit chunked entry
    and the routed scores + calibrate (the main path, one window per
    instance), then held against its plain version (1e-5 of max), against K1
    (bit for bit, the centred sum of squares too), at t_block 1, 2 and 5
    (bit for bit), and the routed qhat against the plain route's (1e-3).
    Times K3, K1 and plain. Returns {window: launch counts}."""
    import torch
    from cppre_torch.cp import calibrate
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import stencil_kernels as sk

    windows = {}
    kern = _wave_composite_kernel()
    n_taps = int(np.count_nonzero(kern))
    args = (DT, DX, DY, NU)
    for family, shape in SCALING.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        truth, pred = device_fields(shape, SEED + 40, device, density=family == "mhd")
        if family == "ns":
            res, t5, p5 = sk._ns_cell(*args), truth, pred
            chunked = lambda tb=5: K.ns_joint_cp_diff_stats_chunked(truth, pred, *args, t_block=tb)
            plain = lambda: K.ns_joint_cp_diff_stats_chunked_plain(truth, pred, *args)
            routed = lambda: K.ns_joint_cp_scores_fused(truth, pred, *args, eps=EPS)
            routed_plain = lambda: K.ns_joint_cp_scores_plain(truth, pred, *args, eps=EPS)
            in_bytes, flops = nbytes(truth, pred), 2 * NS_RES_FLOPS + 4
        elif family == "mhd":
            res, t5, p5 = sk._mhd_cell("induction"), truth, pred
            chunked = lambda tb=5: K.mhd_joint_cp_diff_stats_chunked(truth, pred, t_block=tb)
            plain = lambda: K.mhd_joint_cp_diff_stats_chunked_plain(truth, pred)
            routed = lambda: K.mhd_induction_joint_cp_scores_fused(truth, pred, eps=EPS)
            routed_plain = lambda: K.mhd_induction_joint_cp_scores_plain(truth, pred, eps=EPS)
            in_bytes = 2 * MHD_FIELDS["induction"] * nbytes(truth) // 6
            flops = 2 * MHD_RES_FLOPS["induction"] + 1 + 4
        elif family == "jorek":
            R = jorek_r(shape[3])
            res, t5, p5 = sk._jorek_cell(R, 3.4, 2.25e-7, "continuity"), truth, pred
            chunked = lambda tb=5: K.jorek_joint_cp_diff_stats_chunked(truth, pred, R, t_block=tb)
            plain = lambda: K.jorek_joint_cp_diff_stats_chunked_plain(truth, pred, R)
            routed = lambda: K.jorek_joint_cp_scores_fused(truth, pred, R, eps=EPS)
            routed_plain = lambda: K.jorek_joint_cp_scores_plain(truth, pred, R, eps=EPS)
            in_bytes = 2 * JOREK_FIELDS["continuity"] * nbytes(truth) // 3 + R.nbytes
            flops = 2 * JOREK_RES_FLOPS["continuity"] + 1 + 4
        else:
            res, t5, p5 = sk._taps_cell(kern), truth[:, None], pred[:, None]
            chunked = lambda tb=5: K.wave_joint_cp_diff_stats_chunked(truth, pred, kern,
                                                                      t_block=tb)
            plain = lambda: K.wave_joint_cp_diff_stats_chunked_plain(truth, pred, kern)
            routed = lambda: K.wave_joint_cp_scores_fused(truth, pred, kern, eps=EPS)
            routed_plain = lambda: K.wave_joint_cp_scores_plain(truth, pred, kern, eps=EPS)
            in_bytes, flops = nbytes(truth, pred), 2 * (2 * n_taps - 1) + 4
        bs = shape[0]
        route = K.routing_decision(tuple(t5.shape))

        # the main path: the explicit chunked entry, the routed scores, calibrate
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = chunked()
        qhat = calibrate(routed(), bs, ALPHA)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
        window = f"scaling-{family}"
        windows[window] = K.launch_counts()
        check_path("scaling", windows[window])

        ref = plain()
        err, rel = compare(f"K3 {family} diff", got[0], ref[0], 1e-5)
        compare(f"K3 {family} sum", got[1], ref[1], 1e-5)
        compare(f"K3 {family} sumsq", got[2], ref[2], 1e-5)
        del ref
        k1 = sk._joint_cp_diff_stats(t5, p5, res, centred=True)
        k3 = sk._joint_cp_diff_stats_chunked(t5, p5, res, centred=True)
        same_bits(f"K3 vs K1 {family} (diff, sum, sumsq, centred)", k1, k3)
        del k1, k3
        for tb in (1, 2):
            same_bits(f"K3 {family} t_block={tb} vs 5", got, chunked(tb))
        q_plain = calibrate(routed_plain(), bs, ALPHA)
        _, q_rel = compare(f"scaling {family} routed qhat", qhat, q_plain, 1e-3)
        out_bytes = nbytes(*got)
        cells = got[0].numel()
        results[("K3", window)] = dict(
            max_abs_err=err, rel_err=rel, bound=bound(in_bytes + out_bytes, flops * cells),
            ms=cuda_ms(lambda: chunked()), plain_ms=cuda_ms(plain))
        # K1, which the routed scores launched, on the same inputs (its bits
        # are K3's, so are its errors against the plain version)
        results[("K1", window)] = dict(
            results[("K3", window)],
            ms=cuda_ms(lambda: sk._joint_cp_diff_stats(t5, p5, res)))
        geom = sk._chunk_geom(tuple(t5.shape), res)
        if geom["window"] != sk._chunk_window(res):
            raise AssertionError(f"K3 {family}: the library's ring slot {geom['window']} is not "
                                 f"the one the tap table was built for {sk._chunk_window(res)}")
        report(results, "K3", window, shape=json.dumps(list(shape)), route=route,
               k1_ms=f"{results[('K1', window)]['ms']:.4f}", k3_vs_k1_bitwise=True,
               t_blocks_bitwise="1,2,5", t_block_run=geom["frames"],
               blocks=geom["blocks"], threads_a_block=geom["threads"], smem_bytes=geom["smem"],
               tile=f"{geom['tile'][0]}x{geom['tile'][1]}", chunks=geom["chunks"],
               qhat=f"{float(qhat):.6e}", qhat_vs_plain=f"{q_rel:.3e}",
               path_s=f"{t_path:.3f}", peak_gb=f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}",
               launches=json.dumps(windows[window], separators=(",", ":")))
        del truth, pred, t5, p5, got

    # K1 against K3 at the flagship K1 shapes too: the other half of the
    # measurement behind routing_decision
    flagship = {"ns": ((100, 3, 21, 100, 100), sk._ns_cell(*args)),
                "wave": ((WAVE["res_shape"][0], 1) + WAVE["res_shape"][1:], sk._taps_cell(kern)),
                "mhd": (MHD["res_shape"], sk._mhd_cell("induction"))}
    for family, (shape, res) in flagship.items():
        torch.cuda.empty_cache()
        truth, pred = device_fields(shape, SEED + 41, device, density=family == "mhd")
        same_bits(f"K3 vs K1 {family} {list(shape)}",
                  sk._joint_cp_diff_stats(truth, pred, res)[:3],
                  sk._joint_cp_diff_stats_chunked(truth, pred, res)[:3])
        geom = sk._chunk_geom(shape, res)
        say("route", family=family, shape=json.dumps(list(shape)),
            k1_ms=f"{cuda_ms(lambda: sk._joint_cp_diff_stats(truth, pred, res)):.4f}",
            k3_ms=f"{cuda_ms(lambda: sk._joint_cp_diff_stats_chunked(truth, pred, res)):.4f}",
            k3_frames_a_block=geom["frames"], k3_blocks=geom["blocks"],
            k3_vs_k1_bitwise=True, routing_decision=K.routing_decision(shape))
        del truth, pred
    torch.cuda.empty_cache()
    return windows


def flat_conv_weight(kernel, ny, off, device):
    """The [1, 1, 3, 2 off + 1] weight of F.conv2d over a flat [BS, 1, nt, L]
    field that computes a 3x3x3 tap table's valid residual [BS, 1, nt-2, Lo]:
    tap (it, ix, iy) at column off + (ix - 1) Ny + (iy - 1) of row it."""
    import itertools

    import torch

    w = np.zeros((1, 1, 3, 2 * off + 1), np.float32)
    for it, ix, iy in itertools.product(range(3), repeat=3):
        if kernel[it, ix, iy] != 0.0:   # a corner tap only where off = Ny + 1
            w[0, 0, it, off + (ix - 1) * ny + (iy - 1)] = np.float32(kernel[it, ix, iy])
    return torch.tensor(w, device=device)


class forced_flat_route:
    """Within the block, `_scores_flat` takes `route` whatever
    `flat_routing_decision` says (cppre's test forces the two-kernel route
    the same way, through its VMEM estimate)."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        from cppre_torch.ops.kernels import flat_kernels as fk

        self.saved = fk.flat_routing_decision
        fk.flat_routing_decision = lambda shape: self.route

    def __exit__(self, *exc):
        from cppre_torch.ops.kernels import flat_kernels as fk

        fk.flat_routing_decision = self.saved


def phase_flat(results, device):
    """K10, K11 and K12 at the shapes where K1 is timed: NS [100,3,21,100,100],
    wave [1000,20,64,64] (the wave experiment's composite kernel and a
    3x3x3 kernel with a corner tap), MHD [100,6,20,128,128] (all five
    equations). The main path (one window per family): the flat scores and
    calibrate, by `flat_routing_decision` and again through the other route.
    Then K10, K11 and K12 against their plain versions over the whole
    window (1e-5 of max), K11 then K12 against K10 (bit for bit), the flat
    qhat against the plain flat qhat (1e-3); for a tap table, F.conv2d over
    the flat field against K11's plain version (1e-5 of max). Times K10,
    K11, K12, K11 then K12, plain and conv2d by events, the kernels also by
    device time. Returns {window: launch counts}."""
    import torch
    from cppre_torch.cp import calibrate
    from cppre_torch.experiments import wave
    from cppre_torch.ops import kernels as K
    from cppre_torch.ops.kernels import flat_kernels as fk
    from cppre_torch.ops.kernels import stencil_kernels as sk
    from cppre_torch.residuals import PRE_Wave
    from cppre_torch.solvers import Wave2D

    c = wave.CONFIG
    sim = Wave2D(c["Nx"], c["x_min"], c["x_max"], c["tend"], c["c"], device=device)
    wave_kern = np.asarray(PRE_Wave(sim.dt * c["t_slice"], sim.dx, c["c"]).D.kernel)
    corner = np.array(wave_kern, np.float32)
    corner[1, 0, 0] = corner[1, 2, 2] = 0.125              # a D_xy cross term
    args = (DT, DX, DY, NU)
    cases = {"ns": [("ns", (100, 3, 21, 100, 100), None)],
             "wave": [("wave", WAVE["res_shape"], wave_kern),
                      ("wave-corner", WAVE["res_shape"], corner)],
             "mhd": [(f"mhd-{eq}", MHD["res_shape"], eq) for eq in K.MHD_EQUATIONS]}
    windows = {}
    for family, variants in cases.items():
        torch.cuda.empty_cache()
        shape = variants[0][1]
        truth, pred = device_fields(shape, SEED + 50, device, density=family == "mhd")
        t5, p5 = (truth[:, None], pred[:, None]) if family == "wave" else (truth, pred)
        bs, nvar, nt, nx, ny = t5.shape
        entries = {}
        for name, _, arg in variants:
            if family == "ns":
                entries[name] = (sk._ns_cell(*args), ny,
                                 lambda: K.ns_joint_cp_scores_flat(truth, pred, *args, eps=EPS),
                                 lambda: K.ns_joint_cp_scores_flat_plain(truth, pred, *args,
                                                                         eps=EPS))
            elif family == "wave":
                entries[name] = (sk._taps_cell(arg), fk._composite_off(arg, ny),
                                 lambda k=arg: K.wave_joint_cp_scores_flat(truth, pred, k, eps=EPS),
                                 lambda k=arg: K.wave_joint_cp_scores_flat_plain(truth, pred, k,
                                                                                 eps=EPS))
            else:
                entries[name] = (sk._mhd_cell(arg), ny,
                                 lambda e=arg: K.mhd_joint_cp_scores_flat(truth, pred, e, eps=EPS),
                                 lambda e=arg: K.mhd_joint_cp_scores_flat_plain(truth, pred, e,
                                                                                eps=EPS))
        # the main path: each variant's flat scores and calibrate, by the
        # routing rule and through the other route
        route = K.flat_routing_decision(tuple(t5.shape))
        other = "two_kernel" if route == "paired" else "paired"
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qhats = {}
        for name, (_, _, flat, _) in entries.items():
            qhats[name] = calibrate(flat(), bs, ALPHA)
            with forced_flat_route(other):
                qhats[name + "-other"] = calibrate(flat(), bs, ALPHA)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
        window = f"flat-{family}"
        windows[window] = K.launch_counts()
        check_path("flat", windows[window])

        tf, pf = t5.reshape(bs, nvar, nt, nx * ny), p5.reshape(bs, nvar, nt, nx * ny)
        for name, (res, off, flat, flat_plain) in entries.items():
            same_bits(f"{name} flat qhat, route {route} vs {other}", qhats[name],
                      qhats[name + "-other"])
            _, q_rel = compare(f"{name} flat qhat", qhats[name],
                               calibrate(flat_plain(), bs, ALPHA), 1e-3)
            got = fk._flat_paired_absdiff_stats(tf, pf, res, ny, off)
            ref = fk._flat_paired_absdiff_stats_plain(tf, pf, res, ny, off)
            err, rel = compare(f"K10 {name} |d|", got[0], ref[0], 1e-5)
            compare(f"K10 {name} sum", got[1], ref[1], 1e-5)
            compare(f"K10 {name} sumsq", got[2], ref[2], 1e-5)
            del ref
            r = fk._flat_residual_kernel(tf, res, ny, off)
            r_ref = fk._flat_residual_plain(tf, res, ny, off)
            err11, rel11 = compare(f"K11 {name}", r, r_ref, 1e-5)
            del r_ref
            two = fk._flat_absdiff_stats_from_res(pf, r, res, ny, off)
            same_bits(f"K11 then K12 vs K10 {name}", two, got)
            two_ref = fk._flat_absdiff_stats_from_res_plain(pf, r, res, ny, off)
            err12, rel12 = compare(f"K12 {name} |d|", two[0], two_ref[0], 1e-5)
            compare(f"K12 {name} sum", two[1], two_ref[1], 1e-5)
            compare(f"K12 {name} sumsq", two[2], two_ref[2], 1e-5)
            del two, two_ref
            library_ms = None
            if res.kernel is not None:
                weight = flat_conv_weight(res.kernel, ny, off, device)
                conv = lambda: torch.nn.functional.conv2d(tf, weight)
                compare(f"conv2d {name}", conv()[:, 0], fk._flat_residual_plain(tf, res, ny, off),
                        1e-5)
                library_ms = cuda_ms(conv)
            if family == "ns":
                fields, flops = NS_FIELDS, NS_RES_FLOPS
            elif family == "wave":
                fields, flops = 1, 2 * int(np.count_nonzero(res.kernel)) - 1
            else:
                fields, flops = MHD_FIELDS[name[4:]], MHD_RES_FLOPS[name[4:]]
            in_b = fields * nbytes(truth) // nvar           # one tensor's fields
            cells = got[0].numel()
            key = window if name in ("ns", "wave", "mhd-induction") else f"flat-{name}"
            k10 = lambda: fk._flat_paired_absdiff_stats(tf, pf, res, ny, off)
            k11 = lambda: fk._flat_residual_kernel(tf, res, ny, off)
            k12 = lambda: fk._flat_absdiff_stats_from_res(pf, r, res, ny, off)
            two_kernel = lambda: fk._flat_absdiff_stats_from_res(pf, k11(), res, ny, off)
            two_ms = cuda_ms(two_kernel)
            dev = {n: device_ms(f) for n, f in (("K10", k10), ("K11", k11), ("K12", k12),
                                                  ("two", two_kernel))}
            results[("K10", key)] = dict(
                max_abs_err=err, rel_err=rel,
                bound=bound(2 * in_b + nbytes(*got), (2 * flops + 1 + 4) * cells),
                ms=cuda_ms(k10),
                plain_ms=cuda_ms(lambda: fk._flat_paired_absdiff_stats_plain(tf, pf, res, ny,
                                                                             off)))
            results[("K11", key)] = dict(
                max_abs_err=err11, rel_err=rel11, bound=bound(in_b + nbytes(r), flops * cells),
                ms=cuda_ms(k11),
                plain_ms=cuda_ms(lambda: fk._flat_residual_plain(tf, res, ny, off)),
                library_ms=library_ms)
            results[("K12", key)] = dict(
                max_abs_err=err12, rel_err=rel12,
                bound=bound(in_b + nbytes(r, *got), (flops + 1 + 4) * cells),
                ms=cuda_ms(k12),
                plain_ms=cuda_ms(lambda: fk._flat_absdiff_stats_from_res_plain(pf, r, res, ny,
                                                                               off)))
            fmt = lambda ms: "not_measured" if ms is None else f"{ms:.4f}"
            blocks, threads = fk._k10_grid(tuple(tf.shape), res, ny, off)
            report(results, "K10", key, shape=json.dumps(list(t5.shape)), off=off,
                   route=route, device_ms=fmt(dev["K10"]), two_kernel_ms=f"{two_ms:.4f}",
                   two_kernel_device_ms=fmt(dev["two"]), blocks=blocks,
                   threads_a_block=threads, k11_k12_vs_k10_bitwise=True,
                   qhat=f"{float(qhats[name]):.6e}", qhat_vs_plain=f"{q_rel:.3e}",
                   qhat_routes_bitwise=True)
            g11 = fk._k11_grid(tuple(tf.shape), res, ny, off)
            report(results, "K11", key, device_ms=fmt(dev["K11"]), route=g11["route"],
                   blocks=g11["blocks"], threads_a_block=g11["threads"], span=g11["span"],
                   spans=g11["spans"], smem_bytes=g11["smem"], frames_a_block=g11["frames"])
            blocks, threads = fk._k12_grid(tuple(tf.shape), res, ny, off)
            report(results, "K12", key, device_ms=fmt(dev["K12"]), blocks=blocks,
                   threads_a_block=threads)
            del got, r
        say("flat", family=family, path_s=f"{t_path:.3f}",
            launches=json.dumps(windows[window], separators=(",", ":")))
        del truth, pred, t5, p5, tf, pf
    torch.cuda.empty_cache()
    return windows


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
    spilled = []
    for name in _build.SOURCES:
        for fn, info in ptxas_summary(_build.ptxas_report(name)).items():
            say("ptxas", lib=name, kernel=fn, **info)
            if (re.split(r"<", fn)[0] in NO_SPILL.get(name, ())
                    and (info.get("spill_stores") or info.get("spill_loads"))):
                spilled.append(fn)
    if spilled:
        raise AssertionError(f"ptxas spills registers in K1-K12: {spilled}")

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
    phase_kernels_wave(results, device)
    phase_kernels_mhd(results, device)
    phase_kernels_jorek(results, device)

    # ---- NS serve: the main path ----------------------------------------
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
    check_path("ns-serve", counts)
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
    del x, y100, y7, data, srv, served, pred, accept

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as keep_dir:
        windows = {"ns": {k: serve_counts[k] + train_counts[k] for k in serve_counts},
                   "wave": phase_family("wave", device, keep_dir),
                   "mhd": phase_family("mhd", device),
                   "jorek": phase_family("jorek", device)}
        windows.update(phase_1d(device, keep_dir))
    phase_gs(device)
    windows.update(phase_uq(results, device))
    windows.update(phase_al_pi(results, device))
    windows.update(phase_sets_node(device))
    windows.update(phase_scaling(results, device))
    windows.update(phase_flat(results, device))

    kernels = []
    names = {("K1", "ns"): "ns_joint_cp_diff_stats", ("K2", "ns"): "ns_momentum_residual_fused",
             ("K1", "wave"): "wave_joint_cp_diff_stats", ("K1", "mhd"): "mhd_joint_cp_diff_stats",
             ("K2", "mhd"): "mhd_residual_fused", ("K8", "wave"): "wave_residual_fused",
             ("K9", "mhd"): "mhd_induction_joint_cp_scores_fused(single_pass=True)",
             "K4": "fno_block2d_fused", "K5": "projection2d_fused",
             "K6": "fno_block2d_bwd_fused", "K7": "projection2d_bwd_fused",
             ("K3", "scaling-ns"): "ns_joint_cp_diff_stats_chunked",
             ("K3", "scaling-mhd"): "mhd_joint_cp_diff_stats_chunked",
             ("K3", "scaling-wave"): "wave_joint_cp_diff_stats_chunked",
             ("K3", "scaling-jorek"): "jorek_joint_cp_diff_stats_chunked",
             ("K1", "scaling-jorek"): "jorek_joint_cp_scores_fused",
             ("K1", "jorek"): "jorek_joint_cp_scores_fused",
             ("K2", "jorek"): "jorek_residual_fused",
             ("K3", "jorek"): "jorek_joint_cp_diff_stats_chunked",
             ("K1", "scaling-ns"): "ns_joint_cp_diff_stats",
             ("K1", "scaling-mhd"): "mhd_joint_cp_diff_stats",
             ("K1", "scaling-wave"): "wave_joint_cp_diff_stats",
             ("K10", "flat-ns"): "ns_joint_cp_scores_flat",
             ("K10", "flat-wave"): "wave_joint_cp_scores_flat",
             ("K10", "flat-mhd"): "mhd_joint_cp_scores_flat",
             "K11": "_flat_residual_kernel", "K12": "_flat_absdiff_stats_from_res",
             ("K8", "uq"): "wave_residual_fused (uq PRE)",
             ("K2", "uq-ns"): "ns_momentum_residual_fused (uq PRE)",
             ("K2", "uq-mhd"): "mhd_residual_fused(energy) (uq PRE)",
             ("K8", "pi"): "fused_stencil_same (PI loss)",
             ("K8-bwd", "pi"): "fused_stencil_residual_bwd (PI loss backward)",
             ("K8", "al"): "wave_residual_fused (AL acquisition)"}
    for (kid, family), r in results.items():
        # variants timed beside a path's instance, and kernels timed at a
        # path's shapes that its run does not launch (K9 at NS)
        if family not in windows or windows[family][kid] == 0:
            continue
        src, rep = KERNEL_INFO[kid]
        name = names.get((kid, family)) or names[kid]
        kernels.append({"name": f"{name} ({kid}, {family})", "route": "cuda", "source": src,
                        "replaces": rep, "launches": windows[family][kid],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r.get("library_ms")})
    for k in KERNEL_INFO:
        if sum(w[k] for w in windows.values()) == 0:
            raise AssertionError(f"kernel {k} never launched on any main path")
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
