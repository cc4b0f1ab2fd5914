#!/usr/bin/env python3
"""What the served path's spans cost while they record: requests a second
of each benchmark cell's request with spans off, and with them on under
`cppre_torch.utils.profiling.recording()` (no profiler), in turns on one
CUDA card.

    python3 tools/span_cost.py [--cells ns-serve,ns-judge,wave-serve] [--seconds 4]
                               [--turns 5] [--seed 20]

Each cell is set up as `portbench/run.py` sets it up (its client, its
configuration at full size, its inputs and weights from the seed), then
timed in windows of `--seconds` closed-loop requests, off and on in turns
(off, on, on, off, ...), `--turns` windows each. Prints one JSON line a
cell: the card, the rates of every window, their medians, the on-cost as a
share of the off rate and in microseconds a request, the spans a request
recorded, and whether one request's outputs are bit for bit the same with
spans off and on. Needs one card.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def window(client, state, seconds, on):
    from cppre_torch.utils import profiling

    n, t0 = 0, time.perf_counter()
    with profiling.recording() if on else contextlib.nullcontext():
        while time.perf_counter() - t0 < seconds:
            client.item(state, n)
            n += 1
    return n / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="ns-serve,ns-judge,wave-serve")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from cppre_torch.utils import profiling
    from portbench import core

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in args.cells.split(","):
        cell = core.Cell(spec, name)
        state = cell.client.setup(cell, args.seed, dev)
        for j in range(3):
            cell.client.item(state, -1 - j)
        torch.cuda.synchronize(dev)
        rates = {False: [], True: []}
        for t in range(args.turns):
            for on in ((False, True) if t % 2 == 0 else (True, False)):
                rates[on].append(window(cell.client, state, args.seconds, on))
        profiling.reset()
        off_out = cell.client.item(state, 0)["keep"]
        with profiling.recording():
            on_out = cell.client.item(state, 0)["keep"]
        per_request = {n: s["count"] for n, s in profiling.summary()["spans"].items()}
        profiling.reset()
        same = all(torch.equal(off_out[k], on_out[k]) for k in off_out)
        off, on = statistics.median(rates[False]), statistics.median(rates[True])
        print(json.dumps({"cell": name, "card": card.strip(), "seconds": args.seconds,
                          "off_rates": rates[False], "on_rates": rates[True],
                          "off_median": off, "on_median": on,
                          "on_cost_share": 1 - on / off,
                          "on_cost_us_a_request": 1e6 * (1 / on - 1 / off),
                          "spans_a_request": per_request,
                          "bit_identical_on_and_off": same}), flush=True)
        del state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
