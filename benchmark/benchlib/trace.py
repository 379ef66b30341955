"""Reading a ``torch.profiler`` trace: the device's busy time in the traced
window, the device operations that took most time, and the idle gaps by
what the host was doing. The trace is the profiler's Chrome-trace export;
times are in microseconds there and in seconds here.

The window is the profiled stretch: from the first to the last host or
device event of the trace (the window loop starts the profiler just before the
traced operations and stops it after the final synchronisation; its span
``WINDOW`` marks the same stretch for a reader of the trace)."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t: float, reach: int = 4096) -> str:
    """The name of the host event with the latest start that covers time
    ``t`` (the innermost, for events nested on one thread)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host event)"


def summarize(events: list[dict], top: int = 10, name_len: int = 160) -> dict | None:
    """From Chrome-trace events: the window's length, the seconds in which
    a device operation ran (their union), the device operations by name
    (count and seconds; names cut to ``name_len`` characters in the
    breakdown), and the idle gaps' seconds by the innermost host event
    under each gap's middle. None when the trace holds no event."""
    timed = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS + DEVICE_CATS
             and e.get("name") != WINDOW]
    if not timed:
        return None
    w0 = min(e["ts"] for e in timed)
    w1 = max(e["ts"] + e["dur"] for e in timed)
    dev = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] + e["dur"] > w0 and e["ts"] < w1]
    busy = _merge([(max(s, w0), min(e, w1)) for _, s, e in dev])
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in dev:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) * 1e-6
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e["name"] != WINDOW and e["ts"] < w1 and e["ts"] + e["dur"] > w0))
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps[_innermost(host, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "ops": {k: {"count": v[0], "seconds": v[1]} for k, v in by_name.items()},
            "device_ops": [[k[:name_len], v[1]] for k, v in sorted(by_name.items(),
                                                                   key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[k[:name_len], v] for k, v in sorted(gaps.items(),
                                                               key=lambda kv: -kv[1])[:top]]}


def read_chrome_trace(path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
