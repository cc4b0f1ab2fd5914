"""Reading a `torch.profiler` trace of the measured window.

Copied in substance from `chip_smoke.py` (`device_activity`,
`profile_step`): a device event counts when it is a kernel or a memory
operation, never an annotated range around them. From the events this
module takes the seconds the device was busy (the union of those
intervals), the device seconds of each kernel by name, and the idle gaps
between them, each named by the innermost host operation running at its
midpoint.
"""

from __future__ import annotations

import bisect

from .yardstick import base_name

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(e):
    """Whether a CUDA-side profiler event is a kernel or a memory operation;
    None where the event tells neither (a PyTorch without those attributes)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in DEVICE_ACTIVITIES
    if not hasattr(e, "is_user_annotation"):
        return None
    return not e.is_user_annotation


class Trace:
    """Device time by kernel name, busy seconds and idle gaps of a window."""

    def __init__(self, device_events, host_events):
        """device_events: [(name, start_us, end_us)] of kernels and memory
        operations; host_events: [(name, start_us, end_us)] of host ops."""
        self.by_name = {}
        for name, s, e in device_events:
            n = base_name(name)
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s) * 1e-6
        spans = sorted((s, e) for _, s, e in device_events)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        host = sorted(host_events, key=lambda h: h[1])
        starts = [h[1] for h in host]
        self.gaps = {}
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = 0.5 * (e0 + s1)
            name = "no host op"
            # the innermost host op covering mid: the latest start among those
            # that have not ended (looked for among the 2 000 latest starts)
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(last - 2000, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            self.gaps[name] = self.gaps.get(name, 0.0) + (s1 - e0) * 1e-6

    def device_s(self, names):
        return sum(v for k, v in self.by_name.items() if k in names)

    def device_s_except(self, names):
        return sum(v for k, v in self.by_name.items() if k not in names)

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def from_profiler(prof):
    """A `Trace` of a finished `torch.profiler.profile`; None where the
    events cannot tell kernels from annotated ranges."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if str(e.device_type).endswith("CUDA"):
            act = device_activity(e)
            if act is None:
                return None
            if act:
                dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    return Trace(dev, host)
