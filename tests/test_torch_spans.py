"""The served path's spans (`cppre_torch.utils.profiling.span`): off by
default, on under a profiler or `recording()`, the tree they record, their
clock against the profiler's, and the spans of `CalibratedSurrogate.predict`
on a tiny fused FNO2d. CPU tests at tiny shapes; the two `cuda` tests (the
device interval from events, none during a graph capture) skip without a
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py

This file imports neither JAX nor cppre.
"""

import json
import os
import resource
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cppre_torch.deploy import CalibratedSurrogate
from cppre_torch.models import FNO2d
from cppre_torch.ops.kernels import ns_momentum_residual_fused
from cppre_torch.utils import profiling as P

SERVED = ("serve.predict", "serve.rollout", "fno.lift", "serve.layout", "pre.residual",
          "cp.sets", "cp.accept")


@pytest.fixture(autouse=True)
def store():
    P.reset()
    yield
    P.reset()


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def _trace_start_ns(prof):
    r = prof.profiler.kineto_results
    return r.trace_start_ns() if hasattr(r, "trace_start_ns") else 1000 * r.trace_start_us()


def test_off_by_default(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: opened.append(a))
    cm = P.span("serve.predict", torch.zeros(1))
    assert cm is P.span("cp.sets")                   # the one shared null context
    with cm:
        torch.ones(3).sum()
    assert opened == [] and P.summary()["spans"] == {} and P.spans() == []


def test_on_under_a_profiler_and_under_recording():
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("a"):
            pass
    with P.recording():
        with P.recording():
            with P.span("b"):
                pass
        with P.span("b"):
            pass
    with P.span("c"):                                # off again
        pass
    s = P.summary()
    assert {n: v["count"] for n, v in s["spans"].items()} == {"a": 1, "b": 2}
    assert set(s["launches"]) >= {"K2", "K4", "K5", "K8"}


def test_tree_request_ids_and_self_time():
    with P.recording():
        for _ in range(2):
            with P.span("root"):
                _busy(2e-3)
                with P.span("child"):
                    _busy(3e-3)
                    with P.span("leaf"):
                        _busy(1e-3)
                with P.span("child"):
                    pass
    recs = P.spans()
    assert [r["name"] for r in recs] == ["leaf", "child", "child", "root"] * 2
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "root":
            assert r["parent"] is None
        else:
            up = by_id[r["parent"]]
            assert up["name"] == {"leaf": "child", "child": "root"}[r["name"]]
            assert up["request"] == r["request"]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= up["end_ns"]
    assert len({r["request"] for r in recs}) == 2
    s = P.summary()["spans"]
    assert s["child"]["count"] == 4 and s["root"]["count"] == 2
    for n in ("root", "child", "leaf"):
        assert s[n]["device_s"] == s[n]["host_s"]          # on the CPU
    kids = s["child"]["host_s"]
    assert s["root"]["self_host_s"] == pytest.approx(s["root"]["host_s"] - kids, abs=1e-9)
    assert s["child"]["self_device_s"] == pytest.approx(kids - s["leaf"]["host_s"], abs=1e-9)
    assert s["root"]["self_host_s"] >= 2 * 2e-3 and s["leaf"]["self_host_s"] >= 2 * 1e-3


def _switches():
    u = resource.getrusage(resource.RUSAGE_THREAD)
    return u.ru_nvcsw + u.ru_nivcsw


def _clock_trial():
    """Nested spans under a CPU profiler: (the span records, the profiler's
    clock.* ranges in Unix ns, whether this thread was switched out)."""
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the first record_function under a new profiler starts its range
        # tens of µs before it returns (~45 µs on the H100 host): not compared
        with P.span("first"):
            pass
        n0 = _switches()
        for i in range(3):
            with P.span(f"clock.{i}"):
                with P.span("clock.in"):
                    _busy(1e-4)
        switched = _switches() != n0
    t0 = _trace_start_ns(prof)
    events = {}
    for e in prof.events():
        if e.name.startswith("clock."):
            events.setdefault(e.name, []).append(
                (t0 + 1e3 * e.time_range.start, t0 + 1e3 * e.time_range.end))
    return [r for r in P.spans() if r["name"] != "first"], events, switched


def test_spans_share_the_profilers_clock():
    # A thread switched out between the profiler's stamp and the span's (the
    # GIL handed to another thread, or the core to another process) shifts
    # that span by the time away; such a trial is made again, up to 50 times,
    # and the last one is held to the bound whatever happened in it.
    for _ in range(50):
        recs, events, switched = _clock_trial()
        if not switched:
            break
    assert len(recs) == 6
    for r in recs:
        got = (r["start_ns"], r["end_ns"])
        assert min(max(abs(g - w) for g, w in zip(got, ev)) for ev in events[r["name"]]) < 50e3


def _surrogate(t_out=4, step=1):
    torch.manual_seed(0)
    model = FNO2d(2, step, 3, 3, 3, 4, device="cpu").eval()
    srv = CalibratedSurrogate(model, lambda f: ns_momentum_residual_fused(f, 0.1, 0.1, 0.1),
                              step=step, T_out=t_out, fused=True)
    gen = torch.Generator().manual_seed(1)
    srv.calibrate(torch.rand(8, 3, 8, 8, 2, generator=gen), alpha=0.2)
    return srv, torch.rand(3, 3, 8, 8, 2, generator=gen)


def test_predict_spans_and_bits():
    srv, a = _surrogate(t_out=4, step=1)
    P.reset()                                        # calibrate ran with spans off
    off = srv.predict(a)
    assert P.spans() == []
    with P.recording():
        on = srv.predict(a)
    for k in ("prediction", "residual", "accept"):
        assert torch.equal(on[k], off[k])
    assert all(torch.equal(x, y) for x, y in zip(on["sets"], off["sets"]))
    recs = P.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["serve.predict"]
    top = {r["name"]: r for r in recs if r["parent"] == roots[0]["id"]}
    assert list(top) == ["serve.rollout", "serve.layout", "pre.residual", "cp.sets",
                         "cp.accept"]
    lifts = [r for r in recs if r["name"] == "fno.lift"]
    assert len(lifts) == 4 and all(r["parent"] == top["serve.rollout"]["id"] for r in lifts)
    assert {r["request"] for r in recs} == {roots[0]["request"]}


def test_the_chrome_trace_carries_the_spans(tmp_path):
    srv, a = _surrogate(t_out=3, step=1)
    with P.trace(str(tmp_path)) as logdir:
        srv.predict(a)
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SERVED) <= names
    assert P.summary()["spans"]["fno.lift"]["count"] == 3


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_interval_from_events(dev):
    x = torch.ones(2048, 2048, device=dev)
    torch.cuda.synchronize(dev)
    with P.recording():
        with P.span("mm", x):
            for _ in range(20):
                x = x @ x * 1e-3
    s = P.summary()["spans"]["mm"]
    # the host returns before the device finishes: the events see the work
    assert s["count"] == 1 and s["device_s"] > 0 and s["device_s"] >= 0.5 * s["host_s"]


@pytest.mark.cuda
def test_no_events_while_a_graph_captures(dev):
    x = torch.ones(256, device=dev)
    side = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        (x * 2).sum()                                # warm up on the side stream
    torch.cuda.synchronize(dev)
    with P.recording():
        with torch.cuda.graph(graph):
            with P.span("captured", x):
                y = x * 2
        graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(y, x * 2)
    (r,) = P.spans()
    assert r["name"] == "captured" and r["device_s"] == r["host_s"]
