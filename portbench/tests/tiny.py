"""Tiny cells for the CPU tests: the benchmark's cells with every size cut
so that a whole run takes seconds on the CPU, where the program's kernels
take their plain versions."""

from __future__ import annotations

import json
import time

import torch

from portbench import core

TINY = {
    "fno2d-ns": {"Nx": 12, "Ny": 12, "Width_time": 4, "Modes": 3, "T_out": 4, "n_cal": 16,
                 "n_pred": 4, "Batch Size": 4, "n_train": 16},
    "fno2d-wave": {"Nx": 12, "Ny": 12, "Width_time": 4, "Modes": 3, "T_out": 4, "n_cal": 16,
                   "n_pred": 4, "Batch Size": 4, "n_train": 16},
}
TINY_TRAFFIC = {"pool_batches": 2, "batch": 6, "trace_seconds": 0.5}


def spec():
    """BENCHMARK.json, with the entries of the cells held out of it under
    proposed/ (their clients are tested all the same)."""
    with open(core.HERE.parent / "BENCHMARK.json") as f:
        s = json.load(f)
    for path in sorted((core.HERE / "proposed").glob("*.json")):
        extra = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            s[key] += [dict(m, bound=0.25) if key == "end_to_end" else m for m in extra[key]]
    return s


def tiny_cell(name, here=core.HERE, spec_=None):
    cell = core.Cell(spec_ or spec(), name, here)
    cell.config.update(TINY[cell.config["name"]])
    for k, v in TINY_TRAFFIC.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    cell.traffic.setdefault("check", {})["rows"] = 3
    return cell


def run_tiny(name, seed=7, seconds=0.3, trace=False, cell=None):
    torch.set_num_threads(2)
    return core.run_cell(cell or tiny_cell(name), seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter())
