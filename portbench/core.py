"""The harness: finds a cell's files by name, sets it up, measures a window,
checks what the window produced against the plain reference, and reports.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json      the configuration as it is run (`file` in BENCHMARK.json)
    traffic/<traffic>.json     the mix's parameters; its "client" names clients/<client>.py
    residuals/<kind>.py        the program's residual for a config's residual kind
    reference/<kind>.py        the plain reference of that residual
    metrics/<metric>.py        read(run) -> the metric's value, or None where it finds nothing
    limits/<workload>.json     the limit of each number the cell's check compares

A client exposes setup(cell, seed, device) -> state, item(state, i) -> dict
(one request or step, finished on the host), work(cell) -> the work of one
item, answers(state, kept) -> what the window produced, and
check(cell, seed, answers, device) -> {number: value}.
"""

from __future__ import annotations

import ast
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from . import devtrace
from .fields import sub_seed

HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cppre"})


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str):
    """Import the file at `path` as a module of its own."""
    name = "portbench._" + "".join(c if c.isalnum() else "_" for c in f"{tag}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of `BENCHMARK.json` with its files, found by name under `here`."""

    def __init__(self, spec: dict, name: str, here: Path = HERE):
        workloads = {w["name"]: w for w in spec["workloads"]}
        if name not in workloads:
            raise SystemExit(f"unknown workload {name!r}; one of {sorted(workloads)}")
        wl = workloads[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.name, self.chips, self.here = name, int(wl["chips"]), here
        self.config = load_json(here.parent / configs[wl["config"]]["file"])
        self.traffic = load_json(here / "traffic" / f"{wl['traffic']}.json")
        self.client = load_module(here / "clients" / f"{self.traffic['client']}.py", "client")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
        self.readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py", "metric")
                        for m in self.end_to_end + self.per_layer}

    def port_residual(self):
        """The program's residual for this configuration's residual kind."""
        r = self.config["residual"]
        return load_module(self.here / "residuals" / f"{r['kind']}.py", "residual").port(r)

    def reference_residual(self):
        """The plain reference's residual, fields [B, V, Nt, Nx, Ny] -> residual."""
        r = self.config["residual"]
        mod = importlib.import_module(f"portbench.reference.{r['kind']}")
        return lambda f: mod.residual(f, r)


@dataclass
class Run:
    """What the metric readers read: the window and the work of one item;
    in a traced run also `traced`, a second window under the profiler,
    with its kernel counters, and `trace`, what the profiler saw there."""
    cell: Cell
    setup_s: float
    window_s: float = 0.0
    latencies: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    samples: int = 0
    extra: dict = field(default_factory=dict)
    launches: dict | None = None
    trace: devtrace.Trace | None = None
    work: dict = field(default_factory=dict)
    traced: Run | None = None

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def launches_match(self, ids) -> bool:
        """Whether the kernels `ids` launched exactly the work's count per
        item in this window."""
        want = self.work.get("launches", {})
        return self.launches is not None and all(
            k in want and self.launches.get(k) == want[k] * self.completed for k in ids)


def p95(values):
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)] if s else None


class Reservoir:
    """A uniform sample of k of the window's items, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(sub_seed(seed, "sample")), [], 0

    def offer(self, i, obj):
        if obj is None:
            return
        if len(self.kept) < self.k:
            self.kept.append((i, obj))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (i, obj)
        self.seen += 1


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, client, state, seconds: float, reservoir: Reservoir):
    """Closed loop, one client: items back to back until `seconds` have
    passed; the window ends when the last item has finished."""
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run.attempted += 1
        s = time.perf_counter()
        try:
            out = client.item(state, i)
        except Exception:
            traceback.print_exc()
            run.failed += 1
            break
        run.latencies.append(time.perf_counter() - s)
        run.samples += out["samples"]
        for k, v in out.items():
            if k not in ("samples", "keep"):
                run.extra.setdefault(k, []).append(v)
        reservoir.offer(i, out.get("keep"))
        i += 1
    run.window_s = time.perf_counter() - t0


def reference_imports(here: Path = HERE):
    """Modules of the program or of JAX that a file under reference/ imports."""
    bad = []
    for path in sorted((here / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN | {"cppre_torch"}]
    return bad


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set up, measure, check, read the metrics. Returns the result's dict,
    or raises SystemExit when a guard fails."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cppre_torch.ops import kernels as K

    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)            # the allocator exists before its reset
        torch.cuda.reset_peak_memory_stats(device)
    client = cell.client
    print(f"[setup] {time.perf_counter() - t_start:.3f} s: imports, CUDA context", file=sys.stderr)
    state = client.setup(cell, seed, device)
    _sync(device)
    print(f"[setup] {time.perf_counter() - t_start:.3f} s: the client's set-up", file=sys.stderr)
    keep = int(cell.traffic.get("check", {}).get("requests", 0))
    # as many items as the check keeps, and one: the allocator holds the
    # blocks the window's kept outputs need before the window opens
    warm = [client.item(state, -1 - j) for j in range(keep + 1)]
    del warm
    _sync(device)
    run = Run(cell, setup_s=time.perf_counter() - t_start, work=client.work(cell))
    print(f"[setup] {run.setup_s:.3f} s: the warm items", file=sys.stderr)
    reservoir = Reservoir(keep, seed)
    measure(run, client, state, seconds, reservoir)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # a second window under the profiler for the device's metrics (the
        # host-clock ones come from the first: the profiler slows a
        # host-paced step by a third); it traces the device alone
        run.traced = Run(cell, setup_s=run.setup_s, work=run.work)
        acts = [ProfilerActivity.CUDA] if on_cuda else [ProfilerActivity.CPU]
        K.reset_launch_counts()
        with profile(activities=acts) as prof:
            measure(run.traced, client, state, cell.traffic["trace_seconds"], Reservoir(0, seed))
        run.traced.launches = K.launch_counts()
        run.trace = devtrace.from_profiler(prof)
        # a few items more with the host traced as well, to name the idle gaps
        with profile(activities=[ProfilerActivity.CPU] + acts[:on_cuda]) as prof:
            for j in range(int(cell.traffic["gap_items"])):
                client.item(state, j)
        gaps = devtrace.from_profiler(prof)
        if run.trace is not None and gaps is not None:
            run.trace.gaps = gaps.gaps
        del prof
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    answers = client.answers(state, reservoir.kept)
    del state, reservoir
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    numbers = client.check(cell, seed, answers, device)
    del answers
    checks = {n: {"value": float(numbers[n]) if n in numbers else None, "limit": lim}
              for n, lim in cell.limits["limits"].items()}
    failed = run.failed + (run.traced.failed if run.traced else 0)
    correct = failed == 0 and run.completed > 0 and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": run.attempted + (run.traced.attempted if run.traced else 0),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.traced.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks

    bad = forbidden_modules() + reference_imports(cell.here)
    if bad:
        print(f"import guard: {bad}", file=sys.stderr)
        raise SystemExit(3)
    return result


def report(result, out=sys.stdout, err=sys.stderr):
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    err.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
