#!/usr/bin/env python3
"""Hold this checkout's K1, K2, K8 and K9 bit for bit against another
checkout's, and time both in turns on one CUDA card.

    python3 tools/stencil_vs_parent.py PARENT_DIR

PARENT_DIR holds another checkout's `cppre_torch/` (for example the parent
commit unpacked with `git archive <commit> cppre_torch | tar -x -C DIR`).
Both packages are loaded into one process and built from their own
sources. At `chip_smoke.py`'s shapes, with its seeded fields:
- bitwise: K1's diff (float32 and bfloat16), sum, sumsq and, with the
  centred pass, m2 for the NS, wave, MHD-induction and JOREK cells and at
  the four grid-scaling shapes; K8's output at the wave shape, plain and
  with |.|; K2's output at the NS shape (the served [100, 3, 20, 100,
  100]), for the five MHD equations and for the two JOREK equations on the
  affine and a non-affine R; K9's scores at the NS and MHD-induction
  shapes. Each line says `equal=True` or names what differs.
- turns: K1 uncentred and centred at the eight shapes, K8 in both forms,
  K2 at each of its instances above (the NS one on a prepared contiguous
  tensor, as `chip_smoke.py` times it), K9 at its two shapes beside the
  two-pass route (K1 centred and the score epilogue, this checkout's),
  each timed (`chip_smoke.cuda_ms`, median of 15 CUDA-event-timed calls)
  in the order parent, change, change, parent, change, parent, parent,
  change, with the blocks each launches and the card's SM clock,
  temperature and power after its turns; K2 and K9 also by their device
  time (`chip_smoke.device_ms`, torch.profiler over 20 calls), which
  leaves out the host's launch time that the events around one call hold.
- ptxas: registers and spill bytes of this checkout's K1, K2, K8 and K9
  kernels (`diff_stats_kernel`, `residual_window_kernel`,
  `stencil_march_kernel`, `scores_stash_kernel`,
  `scores_single_pass_kernel`).
- sass: in each checkout's K1 kernels, the FFMAs whose two factors are one
  register (the q += d * d of the sum of squares), from `cuobjdump -sass`.

Prints the card's name and power limit first. Exits 1 if any output
differs from the parent's or a K1, K2, K8 or K9 kernel spills. Needs one
card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("parent", "change", "change", "parent", "change", "parent", "parent", "change")
NEW_BODIES = ("diff_stats_kernel", "stencil_march_kernel", "residual_window_kernel",
              "scores_stash_kernel", "scores_single_pass_kernel")


def load(path):
    """cppre_torch's stencil kernels, build module and residuals from
    `path`, as a fresh import."""
    for k in [k for k in sys.modules if k.startswith("cppre_torch")]:
        del sys.modules[k]
    sys.path.insert(0, path)
    try:
        import cppre_torch.ops.kernels.stencil_kernels as sk
        from cppre_torch.experiments import jorek, wave
        from cppre_torch.ops.kernels import _build
        from cppre_torch.residuals import PRE_Wave
        from cppre_torch.solvers import Wave2D
    finally:
        sys.path.remove(path)
    return dict(sk=sk, build=_build, jorek=jorek, wave=wave, PRE_Wave=PRE_Wave, Wave2D=Wave2D)


def card_state():
    """The card's SM clock, temperature and power draw now, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout.strip().split(", ")
    return f"sm_mhz={out[0]} temp_c={out[1]} power_w={out[2]}" if len(out) == 3 else "card=?"


def differs(a, b):
    """Names of the outputs where two result tuples differ ('' if none)."""
    names = ("diff", "sum", "sumsq", "m2")
    return ",".join(n for n, x, y in zip(names, a, b)
                    if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)))


def cases(cs, pkg, dev):
    """({name: (fields shape, seed, cell maker, K2 runners, K9 runner)}, the
    wave kernel) at chip_smoke's shapes: K1's families, then the
    grid-scaling shapes. A cell maker takes a package's stencil module; K2's
    instances ({name: (prepare, cell maker)}) each prepare their input from
    the truth fields once; a K9 runner takes a module, truth, prediction and
    single_pass."""
    c = pkg["change"]["wave"].CONFIG
    sim = pkg["change"]["Wave2D"](c["Nx"], c["x_min"], c["x_max"], c["tend"], c["c"], device=dev)
    wave_kern = np.asarray(pkg["change"]["PRE_Wave"](sim.dt * c["t_slice"], sim.dx,
                                                     c["c"]).D.kernel)
    jc = pkg["change"]["jorek"].CONFIG
    R, Rn = cs.jorek_r(cs.JOREK["nx"]), cs.jorek_r(cs.JOREK["nx"], affine=False)
    args = (cs.DT, cs.DX, cs.DY, cs.NU)
    cell = {
        "ns": lambda sk: sk._ns_cell(*args),
        "wave": lambda sk: sk._taps_cell(wave_kern),
        "mhd": lambda sk: sk._mhd_cell("induction"),
        "jorek": lambda sk: sk._jorek_cell(R, jc["D"], jc["K"], jc["equation"]),
    }
    whole = lambda t: t
    k2 = {
        "ns": {"ns": (lambda t: t[:, :, :cs.T_OUT].contiguous(), cell["ns"])},
        "mhd": {f"mhd-{eq}": (whole, lambda sk, eq=eq: sk._mhd_cell(eq))
                for eq in cs.MHD_RES_FLOPS},
        "jorek": {f"jorek-{eq}{tag}": (whole, lambda sk, eq=eq, r=r: sk._jorek_cell(
                      r, jc["D"], jc["K"], eq))
                  for eq in cs.JOREK_RES_FLOPS for tag, r in (("", R), ("-non-affine-R", Rn))},
    }
    k9 = {
        "ns": lambda sk, t, p, sp: sk.ns_joint_cp_scores_fused(t, p, *args, eps=cs.EPS,
                                                               single_pass=sp),
        "mhd": lambda sk, t, p, sp: sk.mhd_induction_joint_cp_scores_fused(t, p, eps=cs.EPS,
                                                                           single_pass=sp),
    }
    out = {"ns": ((100, 3, 21, 100, 100), cs.SEED + 41, cell["ns"], k2["ns"], k9["ns"]),
           "wave": ((cs.WAVE["res_shape"][0], 1) + cs.WAVE["res_shape"][1:], cs.SEED + 10,
                    cell["wave"], {}, None),
           "mhd": (cs.MHD["res_shape"], cs.SEED + 20, cell["mhd"], k2["mhd"], k9["mhd"]),
           "jorek": (cs.JOREK["res_shape"], cs.SEED + 60, cell["jorek"], k2["jorek"], None)}
    scale_kern = cs._wave_composite_kernel()
    for fam, shape in cs.SCALING.items():
        if fam == "wave":
            shape, mk = (shape[0], 1) + shape[1:], (lambda sk: sk._taps_cell(scale_kern))
        elif fam == "jorek":
            Rs = cs.jorek_r(shape[3])
            mk = lambda sk, Rs=Rs: sk._jorek_cell(Rs, 3.4, 2.25e-7, "continuity")
        else:
            mk = cell[fam]
        out[f"scaling-{fam}"] = (shape, cs.SEED + 40, mk, {}, None)
    return out, wave_kern


def turns(cs, run, timer=None):
    """{who: [ms, ...]} of run[who] timed in the order of TURNS (by
    `cs.cuda_ms`, or `timer`); a runner that is neither parent nor change
    takes each turn beside change."""
    timer = timer or cs.cuda_ms
    t = {who: [] for who in run}
    for who in TURNS:
        for w in [who] + ([k for k in run if k not in TURNS] if who == "change" else []):
            ms = timer(run[w])
            t[w].append(None if ms is None else round(ms, 4))
    return t


def main(argv):
    if len(argv) < 2 or not os.path.isdir(os.path.join(argv[1], "cppre_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("stencil_vs_parent: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    paths = {"parent": os.path.abspath(argv[1]), "change": ROOT}
    pkg = {who: load(path) for who, path in paths.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(pkg)) as pool:
        list(pool.map(lambda p: p["build"].build(("stencil_kernels",)), pkg.values()))
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    bad = []
    report = pkg["change"]["build"].ptxas_report("stencil_kernels")
    for fn, info in cs.ptxas_summary(report).items():
        if fn.split("<")[0] in NEW_BODIES:
            print(f"[ptxas] {fn} {json.dumps(info)}", flush=True)
            if info.get("spill_stores") or info.get("spill_loads"):
                bad.append(f"spill in {fn}")
    tool = os.path.join(os.path.dirname(pkg["change"]["build"]._nvcc()), "cuobjdump")
    for who in ("parent", "change"):
        sass = subprocess.run([tool, "-sass", str(pkg[who]["build"]._lib_path("stencil_kernels"))],
                              capture_output=True, text=True, check=True, timeout=600).stdout
        fn, found = None, {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = cs._kernel_name(m.group(1))
                continue
            if fn and fn.startswith("diff_stats_kernel"):
                if re.search(r"\bFFMA\s+R\d+,\s+(-?)(R\d+),\s+\1\2,", line):
                    found[fn] = found.get(fn, 0) + 1
        print(f"[sass] {who} ffma_with_one_register_squared={json.dumps(found)}", flush=True)

    dev = torch.device("cuda", 0)
    table, wave_kern = cases(cs, pkg, dev)
    sk, psk = pkg["change"]["sk"], pkg["parent"]["sk"]
    for name, (shape, seed, mk, k2, k9) in table.items():
        torch.cuda.empty_cache()
        truth, pred = cs.device_fields(shape, seed, dev, density=name.endswith("mhd"))
        res = {"change": mk(sk), "parent": mk(psk)}
        mods = {"change": sk, "parent": psk}
        for dtype in (None, torch.bfloat16):
            for centred in (False, True):
                got = {who: mods[who]._joint_cp_diff_stats(truth, pred, res[who], diff_dtype=dtype,
                                                           centred=centred)
                       for who in mods}
                d = differs(got["change"], got["parent"])
                tag = f"K1 {name} diff={'bf16' if dtype else 'f32'} centred={centred}"
                print(f"[bitwise] {tag} equal={not d}" + (f" differs={d}" if d else ""),
                      flush=True)
                if d:
                    bad.append(tag)
                del got
        t = {(c, who): [] for c in (False, True) for who in mods}
        for centred in (False, True):
            for who in TURNS:
                t[(centred, who)].append(round(cs.cuda_ms(
                    lambda: mods[who]._joint_cp_diff_stats(truth, pred, res[who],
                                                           centred=centred)), 4))
        blocks, threads = sk._k1_grid(shape, res["change"])
        print(f"[turns] K1 {name} shape={json.dumps(list(shape))} blocks={blocks} "
              f"threads_a_block={threads} change_ms={t[(False, 'change')]} "
              f"parent_ms={t[(False, 'parent')]} centred_change_ms={t[(True, 'change')]} "
              f"centred_parent_ms={t[(True, 'parent')]} {card_state()}", flush=True)
        for inst, (prepare, mk2) in k2.items():
            f, cell2 = prepare(truth), {who: mk2(mods[who]) for who in mods}
            run = {who: (lambda who=who: mods[who]._batched_residual_fused(f, cell2[who]))
                   for who in mods}
            same = torch.equal(run["change"](), run["parent"]())
            print(f"[bitwise] K2 {inst} equal={same}", flush=True)
            if not same:
                bad.append(f"K2 {inst}")
            tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
            geom = sk._residual_geom(tuple(f.shape), cell2["change"])
            print(f"[turns] K2 {inst} shape={json.dumps(list(f.shape))} "
                  f"blocks={geom['blocks']} threads_a_block={geom['threads']} "
                  f"smem={geom['smem']} tile={json.dumps(list(geom['tile']))} "
                  f"frames_a_block={geom['frames']} change_ms={tk['change']} "
                  f"parent_ms={tk['parent']} change_device_ms={td['change']} "
                  f"parent_device_ms={td['parent']} {card_state()}", flush=True)
            del f
        if k9 is not None:
            run = {who: (lambda who=who: k9(mods[who], truth, pred, True)) for who in mods}
            run["two_pass"] = lambda: k9(sk, truth, pred, False)
            got = {who: run[who]() for who in run}
            same = torch.equal(got["change"], got["parent"])
            gap = float((got["change"] - got["two_pass"]).abs().max()
                        / got["two_pass"].abs().max())
            print(f"[bitwise] K9 {name} equal={same} vs_two_pass_rel={gap:.3e}", flush=True)
            if not same:
                bad.append(f"K9 {name}")
            tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
            geom = sk._k9_grid(tuple(truth.shape), res["change"])
            print(f"[turns] K9 {name} shape={json.dumps(list(shape))} route={geom['route']} "
                  f"cells={geom['cells']} blocks={geom['blocks']} "
                  f"threads_a_block={geom['threads']} smem={geom['smem']} "
                  f"change_ms={tk['change']} parent_ms={tk['parent']} "
                  f"two_pass_ms={tk['two_pass']} change_device_ms={td['change']} "
                  f"parent_device_ms={td['parent']} two_pass_device_ms={td['two_pass']} "
                  f"{card_state()}", flush=True)
            del got
        if name == "wave":
            field = truth[:, 0]
            for take_abs in (False, True):
                run = {who: (lambda who=who: mods[who].fused_stencil_residual(
                    field, wave_kern, take_abs=take_abs)) for who in mods}
                same = torch.equal(run["change"](), run["parent"]())
                tag = f"K8 wave take_abs={take_abs}"
                print(f"[bitwise] {tag} equal={same}", flush=True)
                if not same:
                    bad.append(tag)
                tk = turns(cs, run)
                print(f"[turns] {tag} shape={json.dumps(list(field.shape))} "
                      f"blocks={sk._march_geom(tuple(field.shape), 3)[2]} change_ms={tk['change']} "
                      f"parent_ms={tk['parent']} {card_state()}", flush=True)
        del truth, pred
    print(f"[done] failures={json.dumps(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
