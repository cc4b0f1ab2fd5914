#!/usr/bin/env python3
"""Time this checkout's FNO kernels (K4-K7) against another checkout's, in
turns on one CUDA card.

    python3 tools/fno_vs_parent.py PARENT_DIR [--ns-run] [--gelu-sass]

PARENT_DIR holds another checkout's `cppre_torch/` (for example the parent
commit unpacked with `git archive <commit> cppre_torch | tar -x -C DIR`).
Both packages are loaded into one process and built from their own
sources. At the four model families' shapes (NS, wave, MHD, JOREK: K4 and
K5 at the rollout batch, K6 and K7 at the training batch, K5/K7 at the
family's step) each kernel is held against this checkout's plain version,
then timed (`chip_smoke.cuda_ms`, median of 15 CUDA-event-timed calls) in
turns, and the plain version once. K4 and K6 take the order parent,
change, change, parent, change, parent, parent, change. K5 and K7 are
timed a third way, `erff`, in the turns of HEAD_TURNS (four each): a copy
of this checkout (under build/fno_vs_parent/erff/) whose K5/K7 gelu
helpers in csrc/common.cuh are replaced by CUDA's erff and expf
(`GELU_FORMS`, the form K4/K6 keep). K5's and K7's lines end with the
card's SM clock, temperature and power draw after their turns. One
profile of each kernel (K5 at the rollout batch, the others at the
training batch) gives its device ms by stage, the part of a timed call
that the card spends in it. The ptxas lines (registers, spills) of K5's and K7's kernels are
printed for both gelu forms.

`--ns-run` also runs `experiments.ns.run("joint", Epochs=2)` through each
package and prints its qhat beside quantiles of the in-sample calibration
scores and the spread of the modulation.

`--gelu-sass` counts the instructions of K5's and K7's gelu in the built
libraries: `cuobjdump -sass` of every `projection_tile_kernel<W,S>` and
`projection_bwd_tile_kernel<W,S>`, in this checkout and in the `erff`
copy, less the same kernel built with gelu as the identity (a third copy,
`none`), over the gelus the kernel body holds (K5 32, unrolled; K7 16, in
its chunk loop). The difference also holds what the compiler schedules
differently without gelu, so it is a count per gelu to within a few
instructions. Branch instructions are counted beside.

Prints the card's name and power limit first. Needs one card; makes its
data on the card from seeds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# width, modes, variables, nx, ny, rollout batch (K4, K5), training batch (K6, K7), step
FAMILIES = {
    "ns": (16, 8, 3, 100, 100, 100, 5, 1), "wave": (32, 16, 1, 64, 64, 1100, 50, 1),
    "mhd": (16, 8, 6, 128, 128, 200, 5, 1), "jorek": (16, 8, 3, 32, 32, 200, 5, 10)}
TURNS = ("parent", "change", "change", "parent", "change", "parent", "parent", "change")
# K5/K7's gelu helpers in csrc/common.cuh (proj_cdf through
# proj_gelu_and_grad), and what a variant copy puts in their place
GELU_HELPERS = re.compile(
    r"__device__ __forceinline__ float proj_cdf\(.*?void proj_gelu_and_grad\(.*?\n}\n", re.S)
GELU_FORMS = {
    "erff": """__device__ __forceinline__ float proj_cdf(float u) {
    return 0.5f * (1.0f + erff(u * 0.70710678118654752440f));
}
__device__ __forceinline__ float proj_gelu(float u) { return u * proj_cdf(u); }
__device__ __forceinline__ void proj_gelu_and_grad(float u, float& h, float& d) {
    const float cdf = proj_cdf(u);
    h = u * cdf;
    d = cdf + u * (0.39894228040143267794f * expf(-0.5f * u * u));
}
""",
    "none": """__device__ __forceinline__ float proj_gelu(float u) { return u; }
__device__ __forceinline__ void proj_gelu_and_grad(float u, float& h, float& d) {
    h = u;
    d = u;
}
""",
}
# gelus in the body of K5's and K7's kernels
GELUS_PER_BODY = {"projection_tile_kernel": 32, "projection_bwd_tile_kernel": 16}
HEAD_TURNS = ("parent", "change", "erff", "erff", "change", "parent", "change", "erff",
              "parent", "parent", "erff", "change")


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


def card_state():
    """The card's SM clock, temperature and power draw now, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout.strip().split(", ")
    return f"sm_mhz={out[0]} temp_c={out[1]} power_w={out[2]}" if len(out) == 3 else "card=?"


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


def variant(form):
    """A copy of this checkout's cppre_torch under build/fno_vs_parent/<form>/
    with K5/K7's gelu helpers replaced by GELU_FORMS[form]; its directory."""
    root = os.path.join(ROOT, "build", "fno_vs_parent", form)
    dst = os.path.join(root, "cppre_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "cppre_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "csrc", "common.cuh")
    with open(path) as f:
        src, n = GELU_HELPERS.subn(lambda _: GELU_FORMS[form], f.read())
    if n != 1:
        raise RuntimeError(f"{path}: found {n} blocks of gelu helpers, expected 1")
    with open(path, "w") as f:
        f.write(src)
    return root


def heads(pkg, dev, cuda_ms):
    """K5 at the rollout batch and K7 at the training batch, per family."""
    fb, pfb, efb = pkg["change"]["fb"], pkg["parent"]["fb"], pkg["erff"]["fb"]
    for fam, (w, m, v, nx, ny, b_fwd, b_bwd, step) in FAMILIES.items():
        model = pkg["change"]["FNO2d"](1, step, m, m, v, w, device=dev,
                                       generator=torch.Generator().manual_seed(0))
        fc1, fc2 = model.fc1_time, model.fc2_time
        gen = torch.Generator(device=dev).manual_seed(2)
        with torch.no_grad():
            z = torch.randn((b_fwd, v, nx, ny, w), generator=gen, device=dev)
            run = {"change": lambda: fb.projection2d_fused(z, fc1, fc2),
                   "parent": lambda: pfb.projection2d_fused(z, fc1, fc2)}
            run["erff"] = lambda: efb.projection2d_fused(z, fc1, fc2)
            plain = lambda: fb.projection2d_plain(z, fc1, fc2)
            got, ref = run["change"](), plain()
            err, err_e = rel(got, ref), rel(run["erff"](), ref)
            same = torch.equal(fb.projection2d_fused(z[:7].contiguous(), fc1, fc2), got[:7])
            del got, ref
            t = {k: [] for k in run}
            for who in HEAD_TURNS:
                t[who].append(round(cuda_ms(run[who]), 4))
            print(f"[K5] {fam} z={list(z.shape)} step={step} rel={err:.2e} erff_rel={err_e:.2e} "
                  f"batch7_bitwise={same} change_ms={t['change']} erff_ms={t['erff']} "
                  f"parent_ms={t['parent']} plain_ms={cuda_ms(plain):.4f} {card_state()}",
                  flush=True)
            print(f"[stages] K5 {fam} batch {b_fwd} {json.dumps(stages(run['change']))}",
                  flush=True)
            del z
        z = torch.randn((b_bwd, v, nx, ny, w), generator=gen, device=dev)
        g = torch.randn((b_bwd, v, nx, ny, step), generator=gen, device=dev)
        run = {"change": lambda: fb.projection2d_bwd_fused(z, g, fc1, fc2),
               "parent": lambda: pfb.projection2d_bwd_fused(z, g, fc1, fc2)}
        run["erff"] = lambda: efb.projection2d_bwd_fused(z, g, fc1, fc2)
        plain = lambda: fb.projection2d_bwd_plain(z, g, fc1, fc2)
        got, ref = run["change"](), plain()
        err_dz = rel(got[0], ref[0])
        err_w = max(rel(a, b) for a, b in zip(got[1:], ref[1:]))
        same = all(torch.equal(a, b) for a, b in zip(got, run["change"]()))
        del got, ref
        t = {k: [] for k in run}
        for who in HEAD_TURNS:
            t[who].append(round(cuda_ms(run[who]), 4))
        print(f"[K7] {fam} z={list(z.shape)} step={step} dz_rel={err_dz:.2e} "
              f"wgrad_rel={err_w:.2e} bitwise_rerun={same} change_ms={t['change']} "
              f"erff_ms={t['erff']} parent_ms={t['parent']} plain_ms={cuda_ms(plain):.4f} "
              f"{card_state()}", flush=True)
        print(f"[stages] K7 {fam} batch {b_bwd} {json.dumps(stages(run['change']))}",
              flush=True)
        del z, g, model
        torch.cuda.empty_cache()


def kernels(pkg, dev, cuda_ms):
    fb, pfb = pkg["change"]["fb"], pkg["parent"]["fb"]
    for fam, (w, m, v, nx, ny, b_fwd, b_bwd, _) in FAMILIES.items():
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


def sass_counts(build):
    """{(kernel, W, S): (instructions, branch instructions)} of K5's and K7's
    kernels in `build`'s libraries, from cuobjdump -sass."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = {}
    for name in ("fno_block", "fno_block_bwd"):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(name))], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        key = None
        for line in sass.splitlines():
            m = re.search(r"Function : \S*?(projection(?:_bwd)?_tile_kernel)ILi(\d+)ELi(\d+)E",
                          line)
            if "Function :" in line:
                key = (m.group(1), int(m.group(2)), int(m.group(3))) if m else None
                if key:
                    out[key] = [0, 0]
                continue
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if key and m and m.group(2) != "NOP":
                out[key][0] += 1
                out[key][1] += m.group(2).startswith(("BRA", "BSSY", "BSYNC"))
    return out


def gelu_sass(pkg):
    """Instructions a gelu in K5 and K7 (with its derivative), rational and
    erff, from the built libraries less the gelu-free build."""
    count = {who: sass_counts(pkg[who]["build"]) for who in ("change", "erff", "none")}
    for key in sorted(count["none"]):
        base, per = count["none"][key][0], GELUS_PER_BODY[key[0]]
        form = {who: count[who][key] for who in ("change", "erff")}
        print(f"[gelu-sass] {key[0]}<{key[1]},{key[2]}> instructions_per_gelu="
              f"rational {(form['change'][0] - base) / per:.1f} erff "
              f"{(form['erff'][0] - base) / per:.1f} (kernel: rational {form['change'][0]}, "
              f"erff {form['erff'][0]}, none {base}; {per} gelus) branch_instructions="
              f"rational {form['change'][1]} erff {form['erff'][1]} none "
              f"{count['none'][key][1]}", flush=True)


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
    paths = {"parent": os.path.abspath(argv[1]), "change": ROOT, "erff": variant("erff")}
    if "--gelu-sass" in argv:
        paths["none"] = variant("none")
    pkg = {who: load(path) for who, path in paths.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(pkg)) as pool:
        list(pool.map(lambda p: p["build"].build(("fno_block", "fno_block_bwd")), pkg.values()))
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, ptxas_summary

    for who, gelu in (("change", "rational"), ("erff", "erff")):
        for name in ("fno_block", "fno_block_bwd"):
            for fn, info in ptxas_summary(pkg[who]["build"].ptxas_report(name)).items():
                if fn.startswith("projection"):
                    print(f"[ptxas] gelu={gelu} {fn} {json.dumps(info)}", flush=True)
    if "--gelu-sass" in argv:
        gelu_sass(pkg)
    dev = torch.device("cuda", 0)
    heads(pkg, dev, cuda_ms)
    kernels(pkg, dev, cuda_ms)
    if "--ns-run" in argv:
        ns_runs(paths, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
