"""The port's utilities (`cppre_torch.utils.{benchmark,profiling,runlog,
plot_tools}`, `plots_dir`, `experiments.run_all`) against cppre's.

Inputs are made from seeds with numpy; the port's side takes tensors,
cppre's arrays. What is compared: the timing helpers' contracts and output
formats; `assert_almost_equal`'s verdicts at cppre's 5e-5 mean and 1e-4
max tolerances; the files `Run` writes (times removed); the plot functions'
artist data (lines, images, contour levels, titles) exactly; the file names
that `plots_dir` writes; `run_all`'s fifteen calls, recorded with each
family's entry stubbed in both packages. matplotlib runs on its Agg
backend.
"""

import json
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import cppre.utils as J  # noqa: E402
import cppre.utils.plot_tools as jplots  # noqa: E402
import cppre_torch.utils as T  # noqa: E402
import cppre_torch.utils.plot_tools as tplots  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


# ---- benchmark, assert_almost_equal, timer, trace ----------------------------

def test_benchmark_discards_the_first_call_and_matches_cppre_repr():
    calls = []
    out = T.benchmark(lambda x: calls.append(x) or torch.ones(3) * x, 2.0, num_iterations=4)
    assert len(calls) == 5 and isinstance(out, T.Benchmark)
    assert out.mean >= 0 and out.std >= 0
    assert repr(T.Benchmark(1.25e-3, 2e-5)) == repr(J.Benchmark(1.25e-3, 2e-5))
    assert T.Benchmark._fields == J.Benchmark._fields


@pytest.mark.parametrize("scale,where", [(1e-6, None), (1.5e-5, None), (2e-4, "mean"),
                                         (0.0, "max")])
def test_assert_almost_equal_verdicts_match_cppre(scale, where):
    x = _rng(0).standard_normal((64, 32)).astype(np.float32)
    y = x + scale * _rng(1).standard_normal(x.shape).astype(np.float32)
    if where == "max":
        y[3, 4] += 5e-4           # one cell above the max tolerance, mean below
    verdicts = []
    for fn, a, b in ((J.assert_almost_equal, x, y),
                     (T.assert_almost_equal, torch.from_numpy(x), torch.from_numpy(y))):
        try:
            fn(a, b)
            verdicts.append(None)
        except AssertionError as e:
            verdicts.append(str(e).split(" err")[0])
    assert verdicts[0] == verdicts[1] == (None if where is None else f"{where} abs")


def test_timer_matches_cppre():
    lines = {}
    for name, mod in (("port", T), ("cppre", J)):
        sink = []
        with mod.timer("epoch", sink=sink.append) as r:
            sum(range(1000))
        assert r["label"] == "epoch" and r["seconds"] >= 0
        lines[name] = sink[0]
    for line in lines.values():
        label, secs = line.split(": ")
        assert label == "epoch" and secs.endswith("s") and float(secs[:-1]) >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with T.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert logdir == str(tmp_path / "tr")
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ---- Run ---------------------------------------------------------------------

def _drive_run(mod, folder, make):
    os.makedirs(folder)
    src = os.path.join(folder, "notes.txt")
    with open(src, "w") as f:
        f.write("config\n")
    run = mod.Run().init(name="wave_cp", folder=folder, tags=("wave", "joint"),
                         metadata={"Epochs": 2, "alpha": 0.1})
    run.update_metadata({"qhat": 0.5})
    run.save_file(src, category="config")
    arr = _rng(2).standard_normal((3, 4)).astype(np.float32)
    run.save_object(make(arr), name="qhat")
    run.save_object({"lo": make(arr), "hi": make(arr + 1)}, name="sets", category="cp")
    run.log_metrics({"loss": 1.5}, step=0)
    run.log_metrics({"loss": 0.75}, step=1)
    run.close()
    return run.dir


def test_run_writes_cppre_files(tmp_path):
    dirs = {"port": _drive_run(T, str(tmp_path / "port"), torch.from_numpy),
            "cppre": _drive_run(J, str(tmp_path / "cppre"), np.asarray)}
    trees = {k: sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs) for k, d in dirs.items()}
    assert trees["port"] == trees["cppre"]
    assert "metrics.jsonl" in trees["port"] and "cp/sets.npz" in trees["port"]
    read = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        with open(os.path.join(d, "metrics.jsonl")) as f:
            metrics = [{m: v for m, v in json.loads(line).items() if m != "time"} for line in f]
        npz = {name: dict(np.load(os.path.join(d, name))) for name in trees[k]
               if name.endswith(".npz")}
        read[k] = (meta, metrics, npz)
    assert read["port"][0] == read["cppre"][0]
    assert read["port"][1] == read["cppre"][1]
    for name, arrays in read["cppre"][2].items():
        for key, value in arrays.items():
            np.testing.assert_array_equal(read["port"][2][name][key], value)


def test_noop_run_drops_everything():
    run = T.NoOpRun()
    assert run.init("x", folder="never") is run
    for call in (run.update_metadata, run.save_file, run.save_object, run.log_metrics):
        assert call({}) is None
    run.close()


# ---- plots -------------------------------------------------------------------

def _artists(fig):
    """Every axes' title, labels, line data, image arrays and contour levels."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    [np.asarray(line.get_xydata()) for line in ax.lines],
                    [np.asarray(im.get_array()) for im in ax.images],
                    [np.asarray(c.levels) for c in ax.collections if hasattr(c, "levels")]))
    out.append(fig._suptitle.get_text() if fig._suptitle else None)
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (list, tuple)):
            _same(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _figures(call):
    figs = call(tplots, torch.from_numpy), call(jplots, np.asarray)
    try:
        _same(_artists(figs[0]), _artists(figs[1]))
    finally:
        for f in figs:
            plt.close(f)


def test_plot_functions_match_cppre():
    rng = _rng(3)
    fields = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(5)]
    _figures(lambda m, t: m.subplots_2d([t(f) for f in fields], titles=list("abcde"),
                                        suptitle="fields"))
    x = np.linspace(0, 1, 7).astype(np.float32)
    vals = {"truth": rng.standard_normal((4, 7)).astype(np.float32),
            "pred": rng.standard_normal((4, 7)).astype(np.float32)}
    _figures(lambda m, t: m.subplots_1d(t(x), {k: t(v) for k, v in vals.items()}, [0, 2, 3],
                                        suptitle="rollout"))
    alphas = np.linspace(0.05, 0.95, 6)
    covs = {"AER+PRE": 1 - alphas + 0.01, "PRE": None}
    _figures(lambda m, t: m.coverage_figure(t(alphas), {k: None if v is None else t(v)
                                                        for k, v in covs.items()},
                                            title="wave"))
    R, Z = np.linspace(1, 2, 12), np.linspace(-1, 1, 10)
    field = rng.standard_normal((12, 10)).astype(np.float32)
    qhat = np.abs(rng.standard_normal((12, 10))).astype(np.float32)
    _figures(lambda m, t: m.wall_contour_figure(t(R), t(Z), t(field), t(qhat)))


def test_save_experiment_artifacts_matches_cppre(tmp_path):
    rng = _rng(4)
    results = {"mode": "joint", "alphas": np.linspace(0.1, 0.9, 5),
               "coverage_aer_pre": rng.random(5), "coverage_pre": rng.random(5),
               "coverage_aer_pre_holdout": rng.random(5),
               "pred_pred": rng.standard_normal((2, 1, 8, 8, 5)).astype(np.float32)}
    tplots.save_experiment_artifacts(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in results.items()},
        str(tmp_path / "port"), "Wave")
    jplots.save_experiment_artifacts(results, str(tmp_path / "cppre"), "Wave")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "cppre")) == [
        "Wave_joint_coverage.pdf", "Wave_joint_fields.pdf"]


def test_run_2d_cp_plots_dir_writes_cppre_files(tmp_path):
    from cppre_torch.experiments import wave

    torch.manual_seed(0)
    cfg = {"Epochs": 1, "Nx": 16, "Modes": 4, "Width_time": 4, "Batch Size": 4, "n_train": 4,
           "n_cal": 6, "n_pred": 4, "T_out": 4, "plots_dir": str(tmp_path / "port")}
    r = wave.run("joint", config=cfg, verbose=False, device="cpu")
    j_results = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in r.items()
                 if k in ("mode", "alphas", "coverage_aer_pre", "coverage_pre",
                          "coverage_aer_pre_holdout", "pred_pred")}
    jplots.save_experiment_artifacts(j_results, str(tmp_path / "cppre"), r["config"]["Case"])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "cppre")) == [
        "Wave_joint_coverage.pdf", "Wave_joint_fields.pdf"]


def test_run_efit_plots_dir_writes_cppre_file(tmp_path):
    from cppre_torch.experiments.gs import run_efit

    out = run_efit(verbose=False, plots_dir=str(tmp_path), device="cpu")
    assert os.listdir(tmp_path) == ["efit_wall_contour.pdf"]
    assert len(out["coverage"]) == len(out["alphas"])


def test_plots_dir_without_matplotlib_raises_importerror(tmp_path, monkeypatch):
    from cppre_torch.experiments.gs import run_efit

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        run_efit(verbose=False, plots_dir=str(tmp_path), device="cpu")
    with pytest.raises(ImportError):
        tplots.coverage_figure(np.linspace(0.1, 0.9, 3), {"PRE": np.ones(3)})
    assert not os.listdir(tmp_path)


# ---- run_all ---------------------------------------------------------------------

_ENTRIES = [("experiments.advection", "run"), ("experiments.burgers", "run"),
            ("experiments.wave", "run"), ("experiments.ns", "run"), ("experiments.mhd", "run"),
            ("experiments.jorek", "run"), ("experiments.gs", "run_efit"),
            ("experiments.gs", "run_freegsnke"), ("experiments.al_advection", "run"),
            ("experiments.pi_advection", "run"), ("experiments.al_more", "run"),
            ("node.experiments", "run")]


def _record(package, monkeypatch, fail=None):
    """Stub every family entry of `package`; returns the calls list."""
    import importlib

    calls = []
    for mod_name, fn in _ENTRIES:
        mod = importlib.import_module(f"{package}.{mod_name}")

        def stub(*args, _where=f"{mod_name}.{fn}", **kwargs):
            calls.append((_where, args, {k: v for k, v in kwargs.items() if k != "device"}))
            if fail is not None and _where == fail:
                raise RuntimeError("stubbed failure")
            return {"coverage_aer_pre": [0.9]}

        monkeypatch.setattr(mod, fn, stub)
    return calls


def test_run_all_makes_cppre_fifteen_calls(monkeypatch, capsys):
    from cppre.experiments.run_all import run_all as j_run_all
    from cppre_torch.experiments.run_all import run_all

    j_calls = _record("cppre", monkeypatch)
    calls = _record("cppre_torch", monkeypatch)
    j_res = j_run_all()
    res = run_all(device="cpu")
    assert len(calls) == len(j_calls) == 15
    assert calls == j_calls
    assert list(res) == list(j_res) and all(v["ok"] for v in res.values())
    assert "15/15 pipelines ok" in capsys.readouterr().out


def test_run_all_reports_a_failing_pipeline_and_goes_on(monkeypatch, capsys):
    from cppre_torch.experiments.run_all import run_all

    calls = _record("cppre_torch", monkeypatch, fail="experiments.ns.run")
    res = run_all(device="cpu")
    assert len(calls) == 15
    assert not res["ns/joint"]["ok"] and "stubbed failure" in res["ns/joint"]["error"]
    assert sum(v["ok"] for v in res.values()) == 14
    out = capsys.readouterr().out
    assert "[FAIL] ns/joint" in out and "14/15 pipelines ok" in out
