#!/usr/bin/env python3
"""Hold this checkout's K1 and K8 bit for bit against another checkout's,
and time both in turns on one CUDA card, with K2 beside them.

    python3 tools/stencil_vs_parent.py PARENT_DIR

PARENT_DIR holds another checkout's `cppre_torch/` (for example the parent
commit unpacked with `git archive <commit> cppre_torch | tar -x -C DIR`).
Both packages are loaded into one process and built from their own
sources. At `chip_smoke.py`'s shapes, with its seeded fields:
- bitwise: K1's diff (float32 and bfloat16), sum, sumsq and, with the
  centred pass, m2 for the NS, wave, MHD-induction and JOREK cells and at
  the four grid-scaling shapes; K8's output at the wave shape, plain and
  with |.|. Each line says `equal=True` or names what differs.
- turns: K1 uncentred and centred at the eight shapes, K8 in both forms,
  K2 at the NS, MHD-induction and JOREK shapes, each timed
  (`chip_smoke.cuda_ms`, median of 15 CUDA-event-timed calls) in the order
  parent, change, change, parent, change, parent, parent, change, with
  the blocks each launches and the card's SM clock, temperature and power
  after its turns.
- ptxas: registers and spill bytes of this checkout's K1 and K8 kernels
  (`diff_stats_kernel`, `stencil_march_kernel`).
- sass: in each checkout's K1 kernels, the FFMAs whose two factors are one
  register (the q += d * d of the sum of squares), from `cuobjdump -sass`.

Prints the card's name and power limit first. Exits 1 if any output
differs from the parent's or a K1/K8 kernel spills. Needs one card.
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
NEW_BODIES = ("diff_stats_kernel", "stencil_march_kernel")


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
    """({name: (fields shape, seed, cell maker, K2 runner or None)}, the wave
    kernel) at chip_smoke's shapes: K1's families, then the grid-scaling
    shapes. A cell maker takes a package's stencil module; a K2 runner that
    module and the truth fields."""
    c = pkg["change"]["wave"].CONFIG
    sim = pkg["change"]["Wave2D"](c["Nx"], c["x_min"], c["x_max"], c["tend"], c["c"], device=dev)
    wave_kern = np.asarray(pkg["change"]["PRE_Wave"](sim.dt * c["t_slice"], sim.dx,
                                                     c["c"]).D.kernel)
    jc = pkg["change"]["jorek"].CONFIG
    R = cs.jorek_r(cs.JOREK["nx"])
    args = (cs.DT, cs.DX, cs.DY, cs.NU)
    cell = {
        "ns": lambda sk: sk._ns_cell(*args),
        "wave": lambda sk: sk._taps_cell(wave_kern),
        "mhd": lambda sk: sk._mhd_cell("induction"),
        "jorek": lambda sk: sk._jorek_cell(R, jc["D"], jc["K"], jc["equation"]),
    }
    k2 = {
        "ns": lambda sk, t: sk.ns_momentum_residual_fused(t[:, :, :cs.T_OUT].contiguous(), *args),
        "mhd": lambda sk, t: sk.mhd_residual_fused(t, "induction"),
        "jorek": lambda sk, t: sk.jorek_residual_fused(t, R, Dc=jc["D"], K=jc["K"],
                                                       equation=jc["equation"]),
    }
    out = {"ns": ((100, 3, 21, 100, 100), cs.SEED + 41, cell["ns"], k2["ns"]),
           "wave": ((cs.WAVE["res_shape"][0], 1) + cs.WAVE["res_shape"][1:], cs.SEED + 10,
                    cell["wave"], None),
           "mhd": (cs.MHD["res_shape"], cs.SEED + 20, cell["mhd"], k2["mhd"]),
           "jorek": (cs.JOREK["res_shape"], cs.SEED + 60, cell["jorek"], k2["jorek"])}
    scale_kern = cs._wave_composite_kernel()
    for fam, shape in cs.SCALING.items():
        if fam == "wave":
            shape, mk = (shape[0], 1) + shape[1:], (lambda sk: sk._taps_cell(scale_kern))
        elif fam == "jorek":
            Rs = cs.jorek_r(shape[3])
            mk = lambda sk, Rs=Rs: sk._jorek_cell(Rs, 3.4, 2.25e-7, "continuity")
        else:
            mk = cell[fam]
        out[f"scaling-{fam}"] = (shape, cs.SEED + 40, mk, None)
    return out, wave_kern


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
    for name, (shape, seed, mk, k2) in table.items():
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
        if k2 is not None:
            tk = {who: [] for who in mods}
            for who in TURNS:
                tk[who].append(round(cs.cuda_ms(lambda: k2(mods[who], truth)), 4))
            print(f"[turns] K2 {name} change_ms={tk['change']} parent_ms={tk['parent']} "
                  f"{card_state()}", flush=True)
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
                tk = {who: [] for who in mods}
                for who in TURNS:
                    tk[who].append(round(cs.cuda_ms(run[who]), 4))
                print(f"[turns] {tag} shape={json.dumps(list(field.shape))} "
                      f"blocks={sk._march_geom(tuple(field.shape), 3)[2]} change_ms={tk['change']} "
                      f"parent_ms={tk['parent']} {card_state()}", flush=True)
        del truth, pred
    print(f"[done] failures={json.dumps(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
