"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `portbench/` and
the program, `cppre_torch/`. Exits non-zero, printing no result, without
enough CUDA devices for the cell, when a guard finds JAX or the JAX package
loaded, or when anything fails. The kernels build into the program's own
cache inside the checkout (`build/cppre_torch/`, keyed by source hash), so
only a checkout's first run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, heads the import path: a module
# here must never shadow one of the standard library's
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import core

    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    cell = core.Cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    core.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
