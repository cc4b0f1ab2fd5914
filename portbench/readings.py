"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 [--seconds 3] [--out FILE]

For each of `--seeds`, one run of the cell as `run.py` makes it, with a
short window: the numbers its check compares; the same again with each of
`--faults` (names in `faults.py`) planted underneath. For each of
`--control-seeds`, the control in the program's place (the plain
reference at TF32, on that seed's inputs): the same numbers. Then, per
number, the largest the program read (the lower reading), the smallest
the control read and the smallest each fault read. One JSON object a line, on standard
output and, with `--out`, appended to FILE. Not run by the benchmark
itself.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import core
    from portbench.faults import planted

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        cell = core.Cell(json.load(f), args.workload)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    seen = {}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for side in ["program"] + [f for f in args.faults.split(",") if f]:
        for seed in seeds:
            with contextlib.ExitStack() as stack:
                if side != "program":
                    stack.enter_context(planted(side))
                r = core.run_cell(cell, seed, args.seconds, False, dev, time.perf_counter())
            nums = {k: c["value"] for k, c in r["checks"].items()}
            emit({"workload": args.workload, "seed": seed, "side": side, "numbers": nums,
                  "correct": r["correct"], "attempted": r["attempted"], "metrics": r["metrics"]})
            for k, v in nums.items():
                seen.setdefault(side, {}).setdefault(k, []).append(v)
            del r
            gc.collect()
            torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        nums = cell.client.check(cell, seed, cell.client.control(cell, seed, dev), dev)
        emit({"workload": args.workload, "seed": seed, "side": "control", "numbers": nums})
        for k, v in nums.items():
            seen.setdefault("control", {}).setdefault(k, []).append(v)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {side: {k: (max if side == "program" else min)(v) for k, v in nums.items()}
               for side, nums in seen.items()}
    emit({"workload": args.workload, "summary": summary,
          "device": torch.cuda.get_device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
