#!/usr/bin/env python3
"""Hold this checkout's K1, K2, K3, K8, K9, K10, K11 and K12 bit for bit
against another checkout's, and time both in turns on one CUDA card.

    python3 tools/stencil_vs_parent.py PARENT_DIR [--only k1,k2,k3,k8,k9,k10,k11,k12]

PARENT_DIR holds another checkout's `cppre_torch/` (for example the parent
commit unpacked with `git archive <commit> cppre_torch | tar -x -C DIR`).
Both packages are loaded into one process and built from their own
sources. `--only` keeps the named kernels' bitwise and timing lines (the
ptxas and SASS lines always print). At `chip_smoke.py`'s shapes, with its
seeded fields:
- bitwise: K1's diff (float32 and bfloat16), sum, sumsq and, with the
  centred pass, m2 for the NS, wave, MHD-induction and JOREK cells and at
  the four grid-scaling shapes; K8's output at the wave shape, plain and
  with |.|; K2's output at the NS shape (the served [100, 3, 20, 100,
  100]), for the five MHD equations and for the two JOREK equations on the
  affine and a non-affine R; K9's scores at the NS and MHD-induction
  shapes; K3's diff, sum, sumsq and centred m2 at the four grid-scaling
  shapes and JOREK's [100, 3, 40, 32, 32], at t_block 1, 2, 5 and 8,
  against the parent's K3 and this checkout's K1; K10's |d|, sum and sumsq
  at the flat NS, wave (the composite kernel and one with a corner tap) and
  the five MHD equations' shapes, against the parent's K10 and this
  checkout's K11 then K12; at the same shapes K11's residual and K12's
  |d|, sum and sumsq (on this checkout's K11 output) against the parent's.
  Each line says `equal=True` or names what differs.
- turns: K1 uncentred and centred at the eight shapes, K8 in both forms,
  K2 at each of its instances above (the NS one on a prepared contiguous
  tensor, as `chip_smoke.py` times it), K9 at its two shapes beside the
  two-pass route (K1 centred and the score epilogue, this checkout's), K3
  at its five shapes (t_block 5) beside this checkout's K1, K10 at its
  eight shapes beside this checkout's K11 then K12, K11 and K12 at the
  same shapes, each timed
  (`chip_smoke.cuda_ms`, median of 15 CUDA-event-timed calls) in the order
  parent, change, change, parent, change, parent, parent, change, with the
  blocks each launches and the card's SM clock, temperature and power after
  its turns; K2, K3, K9, K10, K11 and K12 also by their device time
  (`chip_smoke.device_ms`, torch.profiler over 20 calls; None where the
  profiler lost records), which leaves out the host's launch time that the
  events around one call hold. Then the routed scores that could take K3
  (MHD induction and JOREK continuity at their grid-scaling shapes and at
  a batch of 32), with the route forced to K3 and to K1: bitwise, and
  turns of both routes and of the centred K3 and K1 alone, by events.
- ptxas: registers and spill bytes of both checkouts' K1, K2, K3, K8, K9,
  K10, K11 and K12 kernels (`diff_stats_kernel`, `residual_window_kernel`,
  `diff_stats_chunked_kernel`, `stencil_march_kernel`,
  `scores_stash_kernel`, `scores_single_pass_kernel`, and in
  `flat_kernels` `diff_stats_kernel` (K10, K12), `flat_span_kernel` and
  `flat_residual_kernel` (K11), or an older checkout's `flat_paired_kernel`
  and `flat_from_res_kernel`), and a `[ptxas-diff]` line naming the K1,
  K2, K8, K9 and K10 instances (those in both checkouts) whose registers
  or spills differ between the two.
- sass: in each checkout's K1, K10 and K12 kernels, the FFMAs whose two factors
  are one register (the q += d * d of the sum of squares), from
  `cuobjdump -sass`.

Prints the card's name and power limit first. Exits 1 if any output
differs from the parent's, K3 from K1 (or its routed scores from K1's),
K10 from K11 then K12, or a K1, K2, K3, K8, K9, K10, K11 or K12 kernel of
this checkout spills. Needs one card.
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
# the kernel bodies of each library whose ptxas lines print (K1, K2, K3, K8,
# K9; K10, K11 and K12, and older checkouts' K10-K12); the instances of K1,
# K2, K8, K9 and K10 that both checkouts build are compared
BODIES = {"stencil_kernels": ("diff_stats_kernel", "stencil_march_kernel",
                              "residual_window_kernel", "scores_stash_kernel",
                              "scores_single_pass_kernel", "diff_stats_chunked_kernel"),
          "flat_kernels": ("diff_stats_kernel", "flat_span_kernel", "flat_residual_kernel",
                           "flat_paired_kernel", "flat_from_res_kernel")}
UNCHANGED = {"stencil_kernels": ("diff_stats_kernel", "stencil_march_kernel",
                                 "residual_window_kernel", "scores_stash_kernel",
                                 "scores_single_pass_kernel"),
             "flat_kernels": ("diff_stats_kernel",)}
KERNELS = ("k1", "k2", "k3", "k8", "k9", "k10", "k11", "k12")


def load(path):
    """cppre_torch's stencil kernels, build module and residuals from
    `path`, as a fresh import."""
    for k in [k for k in sys.modules if k.startswith("cppre_torch")]:
        del sys.modules[k]
    sys.path.insert(0, path)
    try:
        import cppre_torch.ops.kernels.flat_kernels as fk
        import cppre_torch.ops.kernels.stencil_kernels as sk
        from cppre_torch.experiments import jorek, wave
        from cppre_torch.ops.kernels import _build
        from cppre_torch.residuals import PRE_Wave
        from cppre_torch.solvers import Wave2D
    finally:
        sys.path.remove(path)
    return dict(sk=sk, fk=fk, build=_build, jorek=jorek, wave=wave, PRE_Wave=PRE_Wave,
                Wave2D=Wave2D)


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


def ptxas_lines(cs, pkg, bad):
    """Print both checkouts' ptxas figures of the kernel bodies; a spill in
    this checkout's is a failure; name the K1, K2, K8, K9 and K10 instances
    whose figures differ between the two."""
    seen = {}
    for who in ("parent", "change"):
        for lib, bodies in BODIES.items():
            for fn, info in cs.ptxas_summary(pkg[who]["build"].ptxas_report(lib)).items():
                if fn.split("<")[0] not in bodies:
                    continue
                print(f"[ptxas] {who} {lib} {fn} {json.dumps(info)}", flush=True)
                # K1's index map became a template argument (its default)
                seen[(who, lib, fn.replace(",PlaneCells>", ">"))] = info
                if who == "change" and (info.get("spill_stores") or info.get("spill_loads")):
                    bad.append(f"spill in {lib} {fn}")
    moved = sorted(f"{fn}: {info} -> {seen.get(('change', lib, fn))}"
                   for (who, lib, fn), info in seen.items()
                   if who == "parent" and fn.split("<")[0] in UNCHANGED[lib]
                   and seen.get(("change", lib, fn)) != info)
    print(f"[ptxas-diff] k1_k2_k8_k9_k10_instances_that_differ={json.dumps(moved)}", flush=True)


def sass_lines(cs, pkg):
    """In each checkout's K1, K10 and K12 kernels, the FFMAs whose two
    factors are one register (q += d * d)."""
    tool = os.path.join(os.path.dirname(pkg["change"]["build"]._nvcc()), "cuobjdump")
    for who in ("parent", "change"):
        for lib in ("stencil_kernels", "flat_kernels"):
            sass = subprocess.run([tool, "-sass", str(pkg[who]["build"]._lib_path(lib))],
                                  capture_output=True, text=True, check=True, timeout=600).stdout
            fn, found = None, {}
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    fn = cs._kernel_name(m.group(1))
                    continue
                if fn and fn.startswith(("diff_stats_kernel", "flat_paired_kernel",
                                         "flat_from_res_kernel")):
                    if re.search(r"\bFFMA\s+R\d+,\s+(-?)(R\d+),\s+\1\2,", line):
                        found[fn] = found.get(fn, 0) + 1
            print(f"[sass] {who} {lib} ffma_with_one_register_squared={json.dumps(found)}",
                  flush=True)


def flat_cases(cs, wave_kern):
    """{name: (fields shape [BS, nvar, nt, nx, ny], seed, cell maker, its
    window's margin)} at chip_smoke's flat shapes."""
    corner = np.array(wave_kern, np.float32)
    corner[1, 0, 0] = corner[1, 2, 2] = 0.125              # a D_xy cross term
    args = (cs.DT, cs.DX, cs.DY, cs.NU)
    out = {"flat-ns": ((100, 3, 21, 100, 100), cs.SEED + 50, lambda sk: sk._ns_cell(*args),
                       lambda fk, ny: ny)}
    for name, kern in (("flat-wave", wave_kern), ("flat-wave-corner", corner)):
        out[name] = ((cs.WAVE["res_shape"][0], 1) + cs.WAVE["res_shape"][1:], cs.SEED + 50,
                     lambda sk, k=kern: sk._taps_cell(k),
                     lambda fk, ny, k=kern: fk._composite_off(k, ny))
    for eq in cs.MHD_RES_FLOPS:
        out[f"flat-mhd-{eq}"] = (cs.MHD["res_shape"], cs.SEED + 50,
                                 lambda sk, e=eq: sk._mhd_cell(e), lambda fk, ny: ny)
    return out


def k3_lines(cs, pkg, table, dev, bad):
    """K3 at the grid-scaling shapes and JOREK's: bitwise against the parent
    and against this checkout's K1 at t_block 1, 2, 5 and 8 (centred), then
    turns beside K1, by events and device time."""
    sk, psk = pkg["change"]["sk"], pkg["parent"]["sk"]
    mods = {"change": sk, "parent": psk}
    for name in ("scaling-ns", "scaling-mhd", "scaling-wave", "scaling-jorek", "jorek"):
        shape, seed, mk = table[name][:3]
        torch.cuda.empty_cache()
        truth, pred = cs.device_fields(shape, seed, dev, density=name.endswith("mhd"))
        res = {who: mk(mods[who]) for who in mods}
        k1 = sk._joint_cp_diff_stats(truth, pred, res["change"], centred=True)
        for tb in (1, 2, 5, 8):
            got = {who: mods[who]._joint_cp_diff_stats_chunked(truth, pred, res[who],
                                                                t_block=tb, centred=True)
                   for who in mods}
            d, d1 = differs(got["change"], got["parent"]), differs(got["change"], k1)
            tag = f"K3 {name} t_block={tb}"
            print(f"[bitwise] {tag} equal={not d} equal_k1={not d1}"
                  + (f" differs={d}" if d else "") + (f" differs_k1={d1}" if d1 else ""),
                  flush=True)
            if d or d1:
                bad.append(tag)
            del got
        del k1
        run = {who: (lambda who=who: mods[who]._joint_cp_diff_stats_chunked(truth, pred,
                                                                             res[who]))
               for who in mods}
        run["k1"] = lambda: sk._joint_cp_diff_stats(truth, pred, res["change"])
        tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
        geom = sk._chunk_geom(shape, res["change"])
        print(f"[turns] K3 {name} shape={json.dumps(list(shape))} blocks={geom['blocks']} "
              f"threads_a_block={geom['threads']} smem={geom['smem']} "
              f"frames_a_block={geom['frames']} chunks={geom['chunks']} "
              f"change_ms={tk['change']} parent_ms={tk['parent']} k1_ms={tk['k1']} "
              f"change_device_ms={td['change']} parent_device_ms={td['parent']} "
              f"k1_device_ms={td['k1']} {card_state()}", flush=True)
        del truth, pred


# The routed scores of the cells that `routing_decision` could send to K3:
# the grid-scaling shapes and a batch near the short-batch limit
ROUTED = {"mhd-induction": ((25, 6, 21, 256, 256), (32, 6, 21, 256, 256)),
          "jorek-continuity": ((12, 3, 21, 512, 512), (32, 3, 21, 512, 512))}


def k3_route_lines(cs, pkg, dev, bad):
    """The routed joint-CP scores (`mhd_induction_/jorek_joint_cp_scores_fused`,
    which take the centred pass) with the route forced to K3 and to K1:
    bitwise, then turns (K1's route in the parent's slots, K3's in the
    change's) by events, and the centred K3 and K1 alone beside them."""
    sk = pkg["change"]["sk"]
    decide = sk.routing_decision
    for name, shapes in ROUTED.items():
        for shape in shapes:
            torch.cuda.empty_cache()
            truth, pred = cs.device_fields(shape, cs.SEED + 40, dev,
                                           density=name.startswith("mhd"))
            if name.startswith("mhd"):
                res = sk._mhd_cell("induction")
                score = lambda: sk.mhd_induction_joint_cp_scores_fused(truth, pred, eps=cs.EPS)
            else:
                R = cs.jorek_r(shape[3])
                res = sk._jorek_cell(R, 3.4, 2.25e-7, "continuity")
                score = lambda: sk.jorek_joint_cp_scores_fused(truth, pred, R, eps=cs.EPS)

            def via(route):
                def run():
                    sk.routing_decision = lambda *a, **k: route
                    try:
                        return score()
                    finally:
                        sk.routing_decision = decide
                return run

            routes = {"change": via("chunked"), "parent": via("paired")}
            same = torch.equal(routes["change"](), routes["parent"]())
            tag = f"K3 routed {name} {list(shape)}"
            print(f"[bitwise] {tag} k3_route_equal_k1_route={same}", flush=True)
            if not same:
                bad.append(tag)
            tr = turns(cs, routes)
            kernels = {"change": lambda: sk._joint_cp_diff_stats_chunked(truth, pred, res,
                                                                         centred=True),
                       "parent": lambda: sk._joint_cp_diff_stats(truth, pred, res, centred=True)}
            tk = turns(cs, kernels)
            print(f"[turns] K3 routed {name} shape={json.dumps(list(shape))} "
                  f"routing_decision={decide(shape)} "
                  f"k3_route_ms={tr['change']} k1_route_ms={tr['parent']} "
                  f"k3_centred_ms={tk['change']} k1_centred_ms={tk['parent']} {card_state()}",
                  flush=True)
            del truth, pred


def flat_lines(cs, pkg, wave_kern, dev, bad, only):
    """K10, K11 and K12 at the flat shapes: K10 bitwise against the parent
    and against this checkout's K11 then K12, then turns beside K11 then
    K12; K11 and K12 bitwise against the parent (K12 on this checkout's K11
    output), then turns; by events and device time."""
    fk, pfk = pkg["change"]["fk"], pkg["parent"]["fk"]
    sk, psk = pkg["change"]["sk"], pkg["parent"]["sk"]
    flat = {"change": fk, "parent": pfk}
    for name, (shape, seed, mk, off_of) in flat_cases(cs, wave_kern).items():
        torch.cuda.empty_cache()
        truth, pred = cs.device_fields(shape, seed, dev, density="mhd" in name)
        bs, nvar, nt, nx, ny = shape
        tf, pf = truth.reshape(bs, nvar, nt, nx * ny), pred.reshape(bs, nvar, nt, nx * ny)
        res = {"change": mk(sk), "parent": mk(psk)}
        off = off_of(fk, ny)
        if "k10" in only:
            run = {who: (lambda who=who: flat[who]._flat_paired_absdiff_stats(tf, pf, res[who],
                                                                               ny, off))
                   for who in flat}
            run["two_kernel"] = lambda: fk._flat_absdiff_stats_from_res(
                pf, fk._flat_residual_kernel(tf, res["change"], ny, off), res["change"], ny, off)
            got = {who: run[who]() for who in run}
            d = differs(got["change"], got["parent"])
            d2 = differs(got["change"], got["two_kernel"])
            tag = f"K10 {name}"
            print(f"[bitwise] {tag} equal={not d} equal_two_kernel={not d2}"
                  + (f" differs={d}" if d else "") + (f" differs_two_kernel={d2}" if d2 else ""),
                  flush=True)
            if d or d2:
                bad.append(tag)
            del got
            tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
            blocks, threads = fk._k10_grid(tuple(tf.shape), res["change"], ny, off)
            print(f"[turns] K10 {name} shape={json.dumps(list(shape))} off={off} "
                  f"blocks={blocks} threads_a_block={threads} change_ms={tk['change']} "
                  f"parent_ms={tk['parent']} two_kernel_ms={tk['two_kernel']} "
                  f"change_device_ms={td['change']} parent_device_ms={td['parent']} "
                  f"two_kernel_device_ms={td['two_kernel']} {card_state()}", flush=True)
        r = fk._flat_residual_kernel(tf, res["change"], ny, off)
        if "k11" in only:
            run = {who: (lambda who=who: flat[who]._flat_residual_kernel(tf, res[who], ny, off))
                   for who in flat}
            same = torch.equal(r, run["parent"]())
            print(f"[bitwise] K11 {name} equal={same}", flush=True)
            if not same:
                bad.append(f"K11 {name}")
            tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
            g = fk._k11_grid(tuple(tf.shape), res["change"], ny, off)
            print(f"[turns] K11 {name} shape={json.dumps(list(shape))} off={off} "
                  f"route={g['route']} blocks={g['blocks']} threads_a_block={g['threads']} "
                  f"span={g['span']} spans={g['spans']} smem={g['smem']} "
                  f"frames_a_block={g['frames']} change_ms={tk['change']} "
                  f"parent_ms={tk['parent']} change_device_ms={td['change']} "
                  f"parent_device_ms={td['parent']} {card_state()}", flush=True)
        if "k12" in only:
            run = {who: (lambda who=who: flat[who]._flat_absdiff_stats_from_res(pf, r, res[who],
                                                                                 ny, off))
                   for who in flat}
            d = differs(run["change"](), run["parent"]())
            print(f"[bitwise] K12 {name} equal={not d}" + (f" differs={d}" if d else ""),
                  flush=True)
            if d:
                bad.append(f"K12 {name}")
            tk, td = turns(cs, run), turns(cs, run, cs.device_ms)
            blocks, threads = fk._k12_grid(tuple(tf.shape), res["change"], ny, off)
            print(f"[turns] K12 {name} shape={json.dumps(list(shape))} off={off} "
                  f"blocks={blocks} threads_a_block={threads} change_ms={tk['change']} "
                  f"parent_ms={tk['parent']} change_device_ms={td['change']} "
                  f"parent_device_ms={td['parent']} {card_state()}", flush=True)
        del truth, pred, tf, pf, r


def main(argv):
    only = set(KERNELS)
    if "--only" in argv:
        i = argv.index("--only")
        only = set(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    if (len(argv) < 2 or not os.path.isdir(os.path.join(argv[1], "cppre_torch"))
            or not only <= set(KERNELS)):
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
    with ThreadPoolExecutor(2 * len(pkg)) as pool:
        list(pool.map(lambda a: a[0]["build"].build((a[1],)),
                      [(p, lib) for p in pkg.values() for lib in BODIES]))
    print(f"[build] seconds={time.perf_counter() - t0:.1f}", flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    bad = []
    ptxas_lines(cs, pkg, bad)
    sass_lines(cs, pkg)

    dev = torch.device("cuda", 0)
    table, wave_kern = cases(cs, pkg, dev)
    sk, psk = pkg["change"]["sk"], pkg["parent"]["sk"]
    for name, (shape, seed, mk, k2, k9) in table.items():
        if not (only & {"k1", "k2", "k8", "k9"}):
            break
        torch.cuda.empty_cache()
        truth, pred = cs.device_fields(shape, seed, dev, density=name.endswith("mhd"))
        res = {"change": mk(sk), "parent": mk(psk)}
        mods = {"change": sk, "parent": psk}
        for dtype in (None, torch.bfloat16) if "k1" in only else ():
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
        for centred in (False, True) if "k1" in only else ():
            for who in TURNS:
                t[(centred, who)].append(round(cs.cuda_ms(
                    lambda: mods[who]._joint_cp_diff_stats(truth, pred, res[who],
                                                           centred=centred)), 4))
        if "k1" in only:
            blocks, threads = sk._k1_grid(shape, res["change"])
            print(f"[turns] K1 {name} shape={json.dumps(list(shape))} blocks={blocks} "
                  f"threads_a_block={threads} change_ms={t[(False, 'change')]} "
                  f"parent_ms={t[(False, 'parent')]} centred_change_ms={t[(True, 'change')]} "
                  f"centred_parent_ms={t[(True, 'parent')]} {card_state()}", flush=True)
        for inst, (prepare, mk2) in (k2.items() if "k2" in only else ()):
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
        if k9 is not None and "k9" in only:
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
        if name == "wave" and "k8" in only:
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
    if "k3" in only:
        k3_lines(cs, pkg, table, dev, bad)
        k3_route_lines(cs, pkg, dev, bad)
    if only & {"k10", "k11", "k12"}:
        flat_lines(cs, pkg, wave_kern, dev, bad, only)
    print(f"[done] failures={json.dumps(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
