"""Profiling helpers: torch.profiler traces, wall-clock timers (port of
`cppre.utils.profiling`) and the served path's spans.

`trace(logdir)` records the enclosed block with `torch.profiler` (host
activity, and the card's where CUDA is available) and writes a Chrome trace,
viewable in Perfetto or chrome://tracing, under `logdir` when the block
ends; it yields `logdir`, as the JAX package's does. `timer()` is the
epoch-level wall clock.

`span(name, on)` times one phase of a call where it runs:

    with span("serve.rollout", device):
        ...

Spans are off unless a `torch.profiler` is recording or the caller is
inside `recording()`. Off, a span site costs one check and enters a shared
null context. On, a span opens `torch.profiler.record_function(name)` where
the profiler records (so `trace()`'s Chrome trace shows the span tree over
the kernels), takes its host start and end on the profiler's clock (Unix
ns, `time.time_ns()`), and on a CUDA device records a pair of timing
events on the current stream, read when the store is read; no event is
recorded while the stream captures a CUDA graph, and on the CPU the device
interval is the host interval. The outermost open span starts a new
request id and every span inside it carries that id and its parent's.

The store keeps, per name, the count, host seconds, device seconds and
self seconds of each (the span less its children), and the latest
`KEEP` records. `summary()` reads the totals with the kernels' launch
counts (`ops.kernels.launch_counts()`), `spans()` the records, `reset()`
clears both.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled

__all__ = ["trace", "timer", "span", "recording", "summary", "spans", "reset"]

KEEP = 100_000           # span records kept, the latest first to stay
_PENDING_LIMIT = 4096    # closed CUDA spans held before the finished ones are read


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "cppre_trace")):
    """Capture a torch.profiler trace of the enclosed block into
    `<logdir>/trace_<pid>_<ns>.json`. The profiler stays on until the block
    ends, also on an exception, and the trace is written then."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    """Wall-clock the enclosed block (the reference's epoch-timer pattern)."""
    t0 = time.perf_counter()
    result = {"label": label, "seconds": None}
    try:
        yield result
    finally:
        result["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink(f"{label}: {result['seconds']:.3f}s")


# ---- spans -----------------------------------------------------------------------

class _Record:
    """One span: its tree (id, parent, request), host interval (ns), device
    seconds once read, and what its children took of each."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "events",
                 "up", "child_host_ns", "child_device_s")

    def __init__(self, name, id_, up, request):
        self.name, self.id, self.up, self.request = name, id_, up, request
        self.parent = None if up is None else up.id
        self.events = None
        self.child_host_ns = 0
        self.child_device_s = 0.0


class _SpanStore:
    """Totals per span name and the latest `KEEP` records, in process memory."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.requests = itertools.count()
        self.reset()

    def reset(self):
        with self.lock:
            self.totals = {}        # name -> [count, host_s, device_s, self_host_s, self_device_s]
            self.records = collections.deque(maxlen=KEEP)
            self.pending = collections.deque()   # closed, device interval not read yet

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def open(self, name):
        stack = self.stack()
        up = stack[-1] if stack else None
        rec = _Record(name, next(self.ids), up,
                      next(self.requests) if up is None else up.request)
        stack.append(rec)
        return rec

    def close(self, rec):
        self.stack().pop()
        host_ns = rec.end_ns - rec.start_ns
        if rec.up is not None:
            rec.up.child_host_ns += host_ns
        with self.lock:
            # a parent is read after its children: pending spans are read in
            # the order they closed
            self.pending.append(rec)
            if rec.events is None and len(self.pending) == 1:
                self._read(block=True)
            elif len(self.pending) >= _PENDING_LIMIT:
                self._read(block=False)

    def _read(self, block):
        """Read closed spans in order: all of them with `block`, else those
        whose end event the device has passed."""
        while self.pending:
            rec = self.pending[0]
            if rec.events is None:
                device_s = (rec.end_ns - rec.start_ns) * 1e-9
            else:
                e0, e1 = rec.events
                if not block and not e1.query():
                    return
                e1.synchronize()
                device_s = e0.elapsed_time(e1) * 1e-3
            self.pending.popleft()
            self._add(rec, device_s)

    def _add(self, rec, device_s):
        host_s = (rec.end_ns - rec.start_ns) * 1e-9
        t = self.totals.setdefault(rec.name, [0, 0.0, 0.0, 0.0, 0.0])
        t[0] += 1
        t[1] += host_s
        t[2] += device_s
        t[3] += host_s - rec.child_host_ns * 1e-9
        t[4] += device_s - rec.child_device_s
        if rec.up is not None:
            rec.up.child_device_s += device_s
        rec.up = rec.events = None
        self.records.append({"name": rec.name, "id": rec.id, "parent": rec.parent,
                             "request": rec.request, "start_ns": rec.start_ns,
                             "end_ns": rec.end_ns, "host_s": host_s, "device_s": device_s})

    def summary(self):
        with self.lock:
            self._read(block=True)
            return {n: dict(zip(("count", "host_s", "device_s", "self_host_s",
                                 "self_device_s"), t)) for n, t in self.totals.items()}

    def spans(self):
        with self.lock:
            self._read(block=True)
            return list(self.records)


_STORE = _SpanStore()
_forced = 0              # open recording() blocks


def _cuda_device(on):
    dev = on.device if isinstance(on, torch.Tensor) else on
    if dev is None:
        return None
    dev = torch.device(dev)
    return dev if dev.type == "cuda" else None


class _Span:
    __slots__ = ("name", "device", "stream", "rec", "rf")

    def __init__(self, name, device):
        self.name, self.device, self.rf = name, device, None

    def __enter__(self):
        rec = self.rec = _STORE.open(self.name)
        if self.device is not None and not torch.cuda.is_current_stream_capturing():
            self.stream = torch.cuda.current_stream(self.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        # the host interval lies just inside the profiler's range, the
        # device interval inside the host interval
        rec.start_ns = time.time_ns()
        if rec.events is not None:
            rec.events[0].record(self.stream)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.end_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _STORE.close(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, on=None):
    """A span named `name` around the work the block does on `on` (a tensor
    or device; a CUDA one takes the device interval from events on its
    current stream). Off unless a profiler records or `recording()` is
    open: then the shared null context."""
    if not (_forced or _profiler_enabled()):
        return _OFF
    return _Span(name, _cuda_device(on))


@contextlib.contextmanager
def recording():
    """Record spans in the enclosed block without a profiler (for
    `summary()`); nests."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def summary() -> dict:
    """{"spans": {name: {count, host_s, device_s, self_host_s,
    self_device_s}}, "launches": {kernel id: launches since the counters'
    last reset}}; reads the device intervals of closed spans first (which
    waits for the device to pass them)."""
    from ..ops.kernels import launch_counts

    return {"spans": _STORE.summary(), "launches": launch_counts()}


def spans() -> list:
    """The latest `KEEP` span records, oldest first: name, id, parent id
    (None at a root), request id, start_ns and end_ns on the profiler's
    clock, host_s, device_s."""
    return _STORE.spans()


def reset() -> None:
    """Clear the store's totals and records."""
    _STORE.reset()
