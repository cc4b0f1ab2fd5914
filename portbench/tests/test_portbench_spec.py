"""BENCHMARK.json is well formed (keys, names, units, bounds, budget), and
every name in it has its files."""

import json
import re

from portbench.core import HERE, Cell

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((HERE.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/") and (HERE.parent / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert {w["config"] for w in SPEC["workloads"]} == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        cell = Cell(SPEC, w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert cell.limits["limits"]


def test_held_out_cells_have_their_files():
    for path in (HERE / "proposed").glob("*.json"):
        extra = json.loads(path.read_text())
        for w in extra["workloads"]:
            assert (HERE / "limits" / f"{w['name']}.json").is_file()
            assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        for m in extra["end_to_end"] + extra["per_layer"]:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_check_budget_fits():
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a
    # cell to compile, 1200 spare, within 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
