"""Device ms a request in `serve.rollout`: encode, the fused autoregressive
rollout (K4, K5 and the glue around them) and decode.

From the program's spans (`cppre_torch.utils.profiling.spans()`), which
record only while a profiler records: in a traced run, the traced window's
n requests and then the traffic's `gap_items`, whose host is traced too
and runs slower. Device ms a request over the traced window alone: of the
spans of each name, k a request (the `cp.sets` spans count the requests,
one a request on both paths), the k n before the gap items' k
`gap_items`. None where a span is missing (a program without spans)."""

NAMES = ("serve.rollout",)


def read(run):
    try:
        from cppre_torch.utils.profiling import spans
    except ImportError:
        return None
    n = run.traced.attempted if run.traced is not None else 0
    gap = int(run.cell.traffic.get("gap_items", 0))
    device = {}
    for r in spans():
        device.setdefault(r["name"], []).append(r["device_s"])
    requests = len(device.get("cp.sets", ()))
    if not n or requests < n + gap or any(name not in device for name in NAMES):
        return None
    total = 0.0
    for name in NAMES:
        k, rest = divmod(len(device[name]), requests)
        if rest:
            return None
        end = len(device[name]) - k * gap
        total += sum(device[name][end - k * n:end])
    return 1e3 * total / n
