"""The readers of the program's spans: each against a synthetic store, None
where a span is missing, and reported by a tiny traced run on the CPU."""

from types import SimpleNamespace

import pytest

from cppre_torch.utils import profiling
from portbench import core
from portbench.tests.tiny import run_tiny, tiny_cell

# reader -> the spans it sums
READERS = {"rollout_ms.serve": ("serve.rollout",), "lift_ms.serve": ("fno.lift",),
           "layout_ms.serve": ("serve.layout",), "residual_ms.serve": ("pre.residual",),
           "sets_ms.serve": ("cp.sets", "cp.accept")}
# device s of one request's spans in the traced window, and how many of each
ONE = {"serve.predict": (2.0, 1), "serve.rollout": (1.6, 1), "fno.lift": (0.01, 20),
       "serve.layout": (0.04, 1), "pre.residual": (0.03, 1), "cp.sets": (0.05, 1),
       "cp.accept": (0.01, 1)}
TRACED, GAP = 5, 2


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py", "metric")


def _run(traced=TRACED, gap=GAP):
    return SimpleNamespace(traced=SimpleNamespace(attempted=traced),
                           cell=SimpleNamespace(traffic={"gap_items": gap}))


def _store(monkeypatch, names=tuple(ONE), gap_scale=10.0):
    """Records of TRACED requests, then GAP slower ones, in closing order."""
    recs = []
    for i in range(TRACED + GAP):
        scale = gap_scale if i >= TRACED else 1.0
        for name in names:
            s, k = ONE[name]
            recs += [{"name": name, "device_s": scale * s}] * k
    monkeypatch.setattr(profiling, "spans", lambda: recs)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_store(monkeypatch, name):
    _store(monkeypatch)
    want = 1e3 * sum(ONE[n][0] * ONE[n][1] for n in READERS[name])
    assert _reader(name).read(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_where_a_span_is_missing(monkeypatch, name):
    for gone in set(READERS[name]) | {"cp.sets"}:
        _store(monkeypatch, [n for n in ONE if n != gone])
        assert _reader(name).read(_run()) is None
    _store(monkeypatch)
    assert _reader(name).read(_run(traced=0)) is None
    assert _reader(name).read(_run(traced=TRACED + 1)) is None


@pytest.mark.parametrize("cell", ["ns-serve", "ns-judge"])
def test_a_traced_run_reports_the_span_metrics(cell):
    profiling.reset()
    try:
        result = run_tiny(cell, trace=True)
    finally:
        spans = profiling.summary()["spans"]
        profiling.reset()
    want = {m["name"] for m in tiny_cell(cell).per_layer} & set(READERS)
    assert want and want <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] > 0 for n in want)
    # one request a cp.sets span: the traced window's and the gap items'
    assert spans["cp.sets"]["count"] > int(tiny_cell(cell).traffic["gap_items"])
    if cell == "ns-judge":
        assert "serve.rollout" not in spans and "fno.lift" not in spans
    else:
        assert spans["serve.predict"]["count"] == spans["cp.sets"]["count"]
