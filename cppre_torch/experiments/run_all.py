"""Smoke-run every experiment pipeline at reduced scale (port of
`cppre.experiments.run_all`).

`python -m cppre_torch.experiments.run_all` runs each PDE family's CP
pipeline end to end (data -> train -> rollout -> PRE -> calibrate ->
coverage) with the JAX package's fifteen tiny configurations, in its order,
printing one line per pipeline, on the card unless the caller passes
`device="cpu"`. A pipeline that raises is reported as `[FAIL]` and the
others still run: the tool checks that every pipeline runs. The behavioural
oracle (coverage tracking 1 - alpha) needs the full-scale configs.
"""

from __future__ import annotations

import time

__all__ = ["run_all"]


def run_all(verbose: bool = False, device="cuda"):
    """{name: {"ok": True, "wall_s": s} or {"ok": False, "error": repr}}
    for the fifteen pipelines."""
    results = {}

    def _run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            out = fn(*args, device=device, **kw)
            cov = out.get("coverage_aer_pre") if isinstance(out, dict) else None
            results[name] = {"ok": True, "wall_s": round(time.perf_counter() - t0, 1)}
            extra = ""
            if cov is not None:
                extra = f" cov@0.05={float(cov[0]):.2f}"
            print(f"[ok]   {name:22s} {results[name]['wall_s']:7.1f}s{extra}")
        except Exception as e:  # keep going; report at the end
            results[name] = {"ok": False, "error": repr(e)}
            print(f"[FAIL] {name:22s} {e!r}")

    from .advection import run as adv
    from .burgers import run as burg
    from .wave import run as wave
    from .ns import run as ns
    from .mhd import run as mhd
    from .jorek import run as jorek
    from .gs import run_efit, run_freegsnke
    from .al_advection import run as al_adv
    from .pi_advection import run as pi_adv

    small = dict(Epochs=4, n_train=12, n_cal=16, n_pred=10)
    _run("advection/marginal", adv, "marginal",
         config=dict(small, n_test=10), verbose=verbose)
    _run("advection/joint", adv, "joint",
         config=dict(small, n_test=10), verbose=verbose)
    _run("burgers/joint", burg, "joint", config=dict(small), verbose=verbose)
    _run("wave/joint", wave, "joint",
         config=dict(small, Nx=32, Width_time=8, Modes=8, **{"Batch Size": 6}),
         verbose=verbose)
    _run("ns/joint", ns, "joint",
         config=dict(small, N=48, x_slice=2, tEnd=0.2, Width_time=8, Modes=4,
                     **{"Batch Size": 6}), verbose=verbose)
    _run("mhd/joint", mhd, "joint",
         config=dict(small, N=32, tEnd=0.1, t_slice=16, dt=2.5e-4,
                     Width_time=8, Modes=4, **{"Batch Size": 6}), verbose=verbose)
    _run("jorek/joint", jorek, "joint",
         config=dict(small, Width_time=8, Modes=4, **{"Batch Size": 6}),
         verbose=verbose)
    _run("gs/freegsnke", run_freegsnke,
         config={"Epochs": 10, "n_total": 40, "n_train": 20, "NR": 32, "NZ": 32},
         verbose=verbose)
    _run("gs/efit", run_efit, verbose=verbose)
    _run("al/advection", al_adv, "PRE",
         config={"Epochs": 3, "Nx": 64, "Nt": 40, "T_out": 10, "n_train": 10,
                 "n_test": 8, "n_cal": 10, "n_pred": 10, "n_iterations": 1},
         verbose=verbose)
    from .al_more import run as al_more

    _run("al/burgers", al_more, "burgers", "PRE",
         config={"Epochs": 3, "Nx": 64, "Nt": 21, "T_out": 10, "n_train": 8,
                 "n_test": 6, "n_cal": 8, "n_pred": 6, "n_iterations": 1,
                 "Modes": 8, "Width": 8}, verbose=verbose)
    _run("al/wave", al_more, "wave", "PRE",
         config={"Epochs": 3, "Nx": 32, "T_out": 10, "n_train": 6,
                 "n_test": 5, "n_cal": 6, "n_pred": 5, "n_iterations": 1,
                 "Modes": 8, "Width_time": 8, **{"Batch Size": 6}},
         verbose=verbose)
    _run("pi/advection", pi_adv, "finetune",
         config={"Epochs": 3, "PI_Epochs": 3, "Nx": 64, "Nt": 40, "T_out": 10,
                 "n_train": 10, "n_test": 8}, verbose=verbose)
    from ..node.experiments import run as node_run

    _run("node/sho", node_run, "sho", n_train=1, n_cal=16, n_pred=8, Nt=50,
         epochs=40, verbose=verbose)
    _run("node/bessel", node_run, "bessel", n_train=1, n_cal=16, n_pred=8,
         Nt=50, epochs=40, verbose=verbose)

    failed = [k for k, v in results.items() if not v["ok"]]
    print(f"\n{len(results) - len(failed)}/{len(results)} pipelines ok"
          + (f"; FAILED: {failed}" if failed else ""))
    return results


if __name__ == "__main__":
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_all()
