#!/usr/bin/env python3
"""Time this checkout's FNO block kernels (K4, K6) against another
checkout's, in turns on one CUDA card.

    python3 tools/fno_vs_parent.py PARENT_DIR [--ns-run]

PARENT_DIR holds another checkout's `cppre_torch/` (for example the parent
commit unpacked with `git archive <commit> cppre_torch | tar -x -C DIR`).
Both packages are loaded into one process and built from their own
sources. At the four model families' shapes (NS, wave, MHD, JOREK: K4 at
the rollout batch, K6 at the training batch) each kernel is held against
this checkout's plain version, then timed (`chip_smoke.cuda_ms`, median of
15 CUDA-event-timed calls) in the order parent, change, change, parent,
change, parent, parent, change, and the plain version once. One profile of
each kernel at the training batch gives its device ms by stage.

`--ns-run` also runs `experiments.ns.run("joint", Epochs=2)` through each
package and prints its qhat beside quantiles of the in-sample calibration
scores and the spread of the modulation.

Prints the card's name and power limit first. Needs one card; makes its
data on the card from seeds.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# width, modes, variables, nx, ny, rollout batch (K4), training batch (K6)
FAMILIES = {
    "ns": (16, 8, 3, 100, 100, 100, 5), "wave": (32, 16, 1, 64, 64, 1100, 50),
    "mhd": (16, 8, 6, 128, 128, 200, 5), "jorek": (16, 8, 3, 32, 32, 200, 5)}
TURNS = ("parent", "change", "change", "parent", "change", "parent", "parent", "change")


def load(path):
    """cppre_torch from `path`, as a fresh import."""
    for k in [k for k in sys.modules if k.startswith("cppre_torch")]:
        del sys.modules[k]
    sys.path.insert(0, path)
    try:
        import cppre_torch.ops.kernels.fno_block as fb
        from cppre_torch.experiments import ns
        from cppre_torch.models import FNO2d
        from cppre_torch.ops.kernels import _build
    finally:
        sys.path.remove(path)
    return dict(fb=fb, ns=ns, FNO2d=FNO2d, build=_build)


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def stages(fn):
    """Device ms of one call of `fn` by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name)
            name = re.split(r"[<(]", name, maxsplit=1)[0]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 3e3
    return {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def kernels(pkg, dev, cuda_ms):
    fb, pfb = pkg["change"]["fb"], pkg["parent"]["fb"]
    for fam, (w, m, v, nx, ny, b_fwd, b_bwd) in FAMILIES.items():
        model = pkg["change"]["FNO2d"](1, 1, m, m, v, w, device=dev,
                                       generator=torch.Generator().manual_seed(0))
        blk = model.f0
        gen = torch.Generator(device=dev).manual_seed(1)
        x3 = torch.randn((1, w, v, nx, ny), generator=gen, device=dev)
        with torch.no_grad():
            x = torch.randn((b_fwd, w, v, nx, ny), generator=gen, device=dev)
            run = {"change": lambda: fb.fno_block2d_fused(x, blk, x3, m, m),
                   "parent": lambda: pfb.fno_block2d_fused(x, blk, x3, m, m)}
            plain = lambda: fb.fno_block2d_plain(x, blk, x3, m, m)
            got = run["change"]()
            err = rel(got, plain())
            same = torch.equal(fb.fno_block2d_fused(x[:7].contiguous(), blk, x3, m, m), got[:7])
            del got
            t = {"change": [], "parent": []}
            for who in TURNS:
                t[who].append(round(cuda_ms(run[who]), 4))
            print(f"[K4] {fam} x={list(x.shape)} rel={err:.2e} batch7_bitwise={same} "
                  f"change_ms={t['change']} parent_ms={t['parent']} "
                  f"plain_ms={cuda_ms(plain):.4f}", flush=True)
            del x
        x = torch.randn((b_bwd, w, v, nx, ny), generator=gen, device=dev)
        g = torch.randn_like(x)
        run = {"change": lambda: fb.fno_block2d_bwd_fused(x, g, blk, x3, m, m),
               "parent": lambda: pfb.fno_block2d_bwd_fused(x, g, blk, x3, m, m)}
        plain = lambda: fb.fno_block2d_bwd_plain(x, g, blk, x3, m, m)
        got, ref = run["change"](), plain()
        err_dx = rel(got[0], ref[0])
        err_w = max(rel(a, b) for a, b in zip(got[1:], ref[1:]))
        same = all(torch.equal(a, b) for a, b in zip(got, run["change"]()))
        del got, ref
        t = {"change": [], "parent": []}
        for who in TURNS:
            t[who].append(round(cuda_ms(run[who]), 4))
        print(f"[K6] {fam} x={list(x.shape)} dx_rel={err_dx:.2e} wgrad_rel={err_w:.2e} "
              f"bitwise_rerun={same} change_ms={t['change']} parent_ms={t['parent']} "
              f"plain_ms={cuda_ms(plain):.4f}", flush=True)
        with torch.no_grad():
            k4 = stages(lambda: fb.fno_block2d_fused(x, blk, x3, m, m))
        print(f"[stages] K4 {fam} batch {b_bwd} {json.dumps(k4)}", flush=True)
        print(f"[stages] K6 {fam} batch {b_bwd} {json.dumps(stages(run['change']))}",
              flush=True)
        del x, g, x3, model
        torch.cuda.empty_cache()


def ns_runs(paths, dev):
    for who in ("parent", "change"):
        p = load(paths[who])
        from cppre_torch.cp import ncf_metric_joint, modulation_func

        out = p["ns"].run("joint", config={"Epochs": 2}, seed=0, verbose=False, device=dev,
                          return_residuals=True)
        ro, rp = out["res_out_cal"], out["res_pred_cal"]
        mod = modulation_func(ro, rp)
        s = ncf_metric_joint(ro, rp, mod).flatten().double()
        q = torch.quantile(s, torch.tensor([0.1, 0.5, 0.8, 0.9, 0.95], dtype=torch.float64,
                                           device=s.device))
        mf = mod.flatten()
        print(f"[ns-run] {who} loss_last={out['train_losses'][-1][0]:.6f} "
              f"qhat={float(out['qhat']):.6e} scores_q10_50_80_90_95="
              f"{[float(f'{v:.4e}') for v in q.tolist()]} score_max={float(s.max()):.4e} "
              f"mod_min={float(mf.min()):.3e} mod_median={float(mf.median()):.3e} "
              f"mod_below_1e-6={int((mf < 1e-6).sum())}/{mf.numel()}", flush=True)
        del out, ro, rp, mod, s
        torch.cuda.empty_cache()


def main(argv):
    if len(argv) < 2 or not os.path.isdir(os.path.join(argv[1], "cppre_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fno_vs_parent: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    paths = {"parent": os.path.abspath(argv[1]), "change": ROOT}
    pkg = {who: load(path) for who, path in paths.items()}
    t0 = time.perf_counter()
    for who in ("change", "parent"):
        pkg[who]["build"].build(("fno_block", "fno_block_bwd"))
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms

    dev = torch.device("cuda", 0)
    kernels(pkg, dev, cuda_ms)
    if "--ns-run" in argv:
        ns_runs(paths, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
