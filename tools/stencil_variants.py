#!/usr/bin/env python3
"""Time variant builds of `cppre_torch/csrc/stencil_kernels.cu` and
`flat_kernels.cu` against this checkout's build, K2, K9, K11 and K12 at
`chip_smoke.py`'s shapes, on one CUDA card.

    python3 tools/stencil_variants.py VARIANTS.json [--parent DIR]
                                      [--cases K2,K9,K11,K12] [--rounds N]

VARIANTS.json maps a variant's name to a list of text replacements, each
[old, new] in `csrc/stencil_kernels.cu` or [path, old, new] in another file
of `cppre_torch/`, which must match exactly once
(`tools/stencil_variants.json` holds the K2 and K9 design questions). Each
variant is a copy of `cppre_torch/` under `build/variants/<name>/` with its
replacements made; `--parent DIR` adds another checkout's package as it is.
All are built at once and loaded into one process. Then, per case (a
`--cases` prefix selects them: K2 NS, the five MHD equations, the two JOREK
equations; K9 NS and MHD induction; K11 and K12 at the flat NS, wave (the
composite kernel, and one with a corner tap) and five MHD shapes, K12 on
this checkout's K11 output):
- whether each variant's output equals this checkout's bit for bit (its
  output memory filled with NaN first, so a stale result cannot pass);
- each variant's device ms a call (`chip_smoke.device_ms`);
- `--rounds` rounds of CUDA-event-timed calls (`chip_smoke.cuda_ms`), the
  variants in turn, forwards then backwards.
Prints the card's name and power limit, each variant's K2, K9, K11 and K12
ptxas lines, and one `[variants]` line per case. Exits 1 if a variant
spills in those kernels. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import stencil_vs_parent as svp  # noqa: E402

BODIES = {"stencil_kernels": ("residual_window_kernel", "scores_stash_kernel",
                              "scores_single_pass_kernel"),
          "flat_kernels": ("diff_stats_kernel", "flat_span_kernel", "flat_residual_kernel")}


def make_variant(name, replacements):
    """A copy of this checkout's package under build/variants/<name> with
    the replacements made; its path."""
    d = os.path.join(ROOT, "build", "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "cppre_torch"), os.path.join(d, "cppre_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rep in replacements:
        path, old, new = rep if len(rep) == 3 else ("csrc/stencil_kernels.cu", *rep)
        src = os.path.join(d, "cppre_torch", path)
        with open(src) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} matches {text.count(old)} times in {path}")
        with open(src, "w") as f:
            f.write(text.replace(old, new))
    return d


def cases(jc, wave_kern):
    """[(name, fields shape, seed, make(truth, pred, this) -> run(pkg))] at
    chip_smoke's shapes; `this` is this checkout's loaded package, `pkg` a
    variant's."""
    args = (cs.DT, cs.DX, cs.DY, cs.NU)
    R = cs.jorek_r(cs.JOREK["nx"])

    def k2(mk, prep=None):
        def make(t, p, this):
            f = t if prep is None else prep(t)
            return lambda m: m["sk"]._batched_residual_fused(f, mk(m["sk"]))
        return make

    def k9(mk):
        return lambda t, p, this: (lambda m: m["sk"]._joint_cp_scores_single_pass(
            t, p, mk(m["sk"]), cs.EPS))

    def flat(which, mk, off_of):
        def make(t, p, this):
            bs, nvar, nt, nx, ny = t.shape
            tf, pf = t.reshape(bs, nvar, nt, nx * ny), p.reshape(bs, nvar, nt, nx * ny)
            off = off_of(this["fk"], ny)
            if which == "K11":
                return lambda m: m["fk"]._flat_residual_kernel(tf, mk(m["sk"]), ny, off)
            r = this["fk"]._flat_residual_kernel(tf, mk(this["sk"]), ny, off)
            return lambda m: m["fk"]._flat_absdiff_stats_from_res(pf, r, mk(m["sk"]), ny, off)
        return make

    out = [("K2 ns", (100, 3, 21, 100, 100), 41, k2(lambda sk: sk._ns_cell(*args),
                                                    lambda t: t[:, :, :cs.T_OUT].contiguous()))]
    out += [(f"K2 mhd-{eq}", cs.MHD["res_shape"], 20, k2(lambda sk, eq=eq: sk._mhd_cell(eq)))
            for eq in cs.MHD_RES_FLOPS]
    out += [(f"K2 jorek-{eq}", cs.JOREK["res_shape"], 60,
             k2(lambda sk, eq=eq: sk._jorek_cell(R, jc["D"], jc["K"], eq)))
            for eq in cs.JOREK_RES_FLOPS]
    out += [("K9 ns", (100, 3, 21, 100, 100), 41, k9(lambda sk: sk._ns_cell(*args))),
            ("K9 mhd", cs.MHD["res_shape"], 20, k9(lambda sk: sk._mhd_cell("induction")))]
    for which in ("K11", "K12"):
        for name, (shape, seed, mk, off_of) in svp.flat_cases(cs, wave_kern).items():
            out.append((f"{which} {name}", shape, seed - cs.SEED, flat(which, mk, off_of)))
    return out


def _equal(a, b):
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants")
    ap.add_argument("--parent")
    ap.add_argument("--cases", default="K2,K9")
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("stencil_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with open(a.variants) as f:
        variants = json.load(f)
    paths = {"this": ROOT, **{n: make_variant(n, r) for n, r in variants.items()}}
    if a.parent:
        paths["parent"] = os.path.abspath(a.parent)
    pkg = {n: svp.load(p) for n, p in paths.items()}
    t0 = time.perf_counter()
    # a variant whose replacements leave a library's sources as they are
    # takes this checkout's build of it
    this = pkg["this"]["build"]
    this.build(tuple(BODIES))
    for p in pkg.values():
        for lib in BODIES:
            mine, dst = this._lib_path(lib), p["build"]._lib_path(lib)
            if dst.name == mine.name and not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(mine, dst)
                shutil.copyfile(mine.with_suffix(".log"), dst.with_suffix(".log"))
    with ThreadPoolExecutor(2 * len(pkg)) as pool:
        list(pool.map(lambda a: a[0]["build"].build((a[1],)),
                      [(p, lib) for p in pkg.values() for lib in BODIES]))
    print(f"[build] builds={len(pkg)} seconds={time.perf_counter() - t0:.1f}", flush=True)
    bad = []
    for n, p in pkg.items():
        for lib, bodies in BODIES.items():
            info = {k: v for k, v in cs.ptxas_summary(p["build"].ptxas_report(lib)).items()
                    if k.split("<")[0] in bodies}
            print(f"[ptxas] {n} {lib} {json.dumps(info)}", flush=True)
            bad += [f"{n}: spill in {k}" for k, v in info.items()
                    if v.get("spill_stores") or v.get("spill_loads")]

    dev = torch.device("cuda", 0)
    wave_kern = svp.cases(cs, {"change": pkg["this"]}, dev)[1]
    for name, shape, seed, make in cases(pkg["this"]["jorek"].CONFIG, wave_kern):
        if not any(name.startswith(c) for c in a.cases.split(",")):
            continue
        torch.cuda.empty_cache()
        truth, pred = cs.device_fields(shape, cs.SEED + seed, dev, density="mhd" in name)
        run = make(truth, pred, pkg["this"])
        ref = run(pkg["this"])
        same, device, times = {}, {}, {n: [] for n in pkg}
        for n, p in pkg.items():
            for x in (ref,) if torch.is_tensor(ref) else ref:
                torch.full_like(x, float("nan"))   # freed: the next output may take it
            same[n] = _equal(run(p), ref)
            ms = cs.device_ms(lambda: run(p))
            device[n] = None if ms is None else round(ms, 4)
        for r in range(a.rounds):
            for n, p in (list(pkg.items()) if r % 2 == 0 else list(pkg.items())[::-1]):
                times[n].append(round(cs.cuda_ms(lambda: run(p)), 4))
        print(f"[variants] {name} shape={json.dumps(list(shape))} "
              + " ".join(f"{n}=(device_ms={device[n]} ms={times[n]} equal={same[n]})" for n in pkg),
              flush=True)
        del truth, pred, ref, run
    print(f"[done] failures={json.dumps(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
