"""Whole runs at a tiny size on the CPU: the result line, a cell added by
files alone, and faults and the control that the check must catch."""

import io
import json
import shutil

import pytest
import torch

from portbench import core
from portbench.faults import planted
from portbench.tests.tiny import run_tiny, spec, tiny_cell

CELLS = ["ns-serve", "wave-train", "ns-judge", "wave-serve"]
with open(core.HERE.parent / "BENCHMARK.json") as _f:
    LISTED = [w["name"] for w in json.load(_f)["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    result = run_tiny(name, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    core.report(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = tiny_cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and metric, copied in as files and
    named in BENCHMARK.json, are found without an edit to the harness."""
    here = tmp_path / "portbench"
    shutil.copytree(core.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((here / "configs" / "fno2d-ns.json").read_text())
    cfg.update(name="fno2d-ns-b", Nx=10, Ny=10, Width_time=4, Modes=2, T_out=3, n_cal=12,
               n_pred=3)
    (here / "configs" / "fno2d-ns-b.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "serve.json").read_text())
    traffic.update(pool_batches=2, check={"requests": 1, "rows": 3}, trace_seconds=0.5)
    (here / "traffic" / "serve-b.json").write_text(json.dumps(traffic))
    (here / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(run.completed)\n")
    shutil.copy(here / "limits" / "ns-serve.json", here / "limits" / "ns-serve-b.json")
    s = spec()
    s["configs"].append({"name": "fno2d-ns-b", "source": "test", "reduced": [],
                         "file": "portbench/configs/fno2d-ns-b.json", "why": "test"})
    s["workloads"].append({"name": "ns-serve-b", "config": "fno2d-ns-b", "traffic": "serve-b",
                           "chips": 1, "why": "test"})
    s["end_to_end"][0]["workloads"].append("ns-serve-b")
    s["per_layer"].append({"name": "requests_done", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "serving front end",
                           "moves": "serve_samples_per_s", "workloads": ["ns-serve-b"]})
    cell = core.Cell(s, "ns-serve-b", here)
    assert cell.config["Nx"] == 10 and cell.traffic["pool_batches"] == 2
    result = run_tiny("ns-serve-b", trace=True, cell=cell)
    assert result["correct"] is True
    assert 0 < result["metrics"]["requests_done"]["value"] < result["attempted"]


@pytest.mark.parametrize("name,fault", [
    ("ns-serve", "serve_answer_altered"), ("wave-serve", "serve_answer_altered"),
    ("ns-judge", "judge_answer_altered"), ("ns-serve", "bias_branch_dropped"),
    ("wave-serve", "bias_branch_dropped"), ("ns-judge", "bias_branch_dropped"),
    ("ns-serve", "head_gelu_dropped"), ("wave-serve", "head_gelu_dropped"),
    ("wave-train", "state_unchanged"),
    ("wave-train", "half_batch")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    with planted(fault):
        result = run_tiny(name)
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name):
    """The reference at TF32 in the program's place reads above a limit."""
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    nums = cell.client.check(cell, 11, cell.client.control(cell, 11, cpu), cpu)
    assert any(nums[k] > lim for k, lim in cell.limits["limits"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", LISTED)
def test_a_run_on_the_card(name):
    """One short run of each cell of BENCHMARK.json through run.py on the card."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", "5",
                        "--seconds", "2", "--trace", "0"], cwd=core.HERE.parent,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
