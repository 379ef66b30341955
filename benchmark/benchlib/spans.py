"""The port's own regions in a ``torch.profiler`` trace: for each ``lrds.*``
region (``sde_sampler_lrds_torch/utils/profiling.py`` lists them) its count,
its host seconds, the device seconds of the operations launched inside it
and the seconds the card stood idle while the host was inside it.

The window is ``summarize``'s: from the first to the last host or device
event of the trace. A device operation is credited through its
``correlation`` to the runtime or driver call that launched it, on any
thread (the autograd engine's thread launches the backward while the main
thread sits in ``lrds.step.backward``), and from there to the innermost
region whose interval holds that call's start. An idle gap goes to the
innermost region that covers its middle. Device operations and gaps that no
region holds go under ``OUTSIDE``."""
from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import DEVICE_CATS, HOST_CATS, WINDOW, _merge

PREFIX = "lrds."
OUTSIDE = "(outside)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans, starts, t: float) -> str:
    """The region with the latest start that covers time ``t``."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return OUTSIDE


def split(events: list[dict]) -> dict | None:
    """{region: {count, host_s, device_s, idle_s}} of the regions in the
    trace, with ``OUTSIDE`` for what none holds; None when the trace holds
    no event."""
    timed = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS + DEVICE_CATS
             and e.get("name") != WINDOW]
    if not timed:
        return None
    w0 = min(e["ts"] for e in timed)
    w1 = max(e["ts"] + e["dur"] for e in timed)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in timed
                   if e["cat"] == "user_annotation" and e["name"].startswith(PREFIX))
    starts = [s[0] for s in spans]
    out = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
    out[OUTSIDE]                        # reported even where nothing is outside
    for s, e, name in spans:
        out[name]["count"] += 1
        out[name]["host_s"] += (e - s) * 1e-6
    launched = {e["args"]["correlation"]: e["ts"] for e in timed
                if e["cat"] in LAUNCH_CATS and "correlation" in e.get("args", {})}
    busy = []
    for e in timed:
        if e["cat"] not in DEVICE_CATS:
            continue
        s, end = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        t = launched.get(e.get("args", {}).get("correlation"))
        out[OUTSIDE if t is None else _innermost(spans, starts, t)]["device_s"] += (end - s) * 1e-6
        busy.append((s, end))
    edges = [w0] + [x for iv in _merge(busy) for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            out[_innermost(spans, starts, 0.5 * (s + e))]["idle_s"] += (e - s) * 1e-6
    return dict(out)


def per_op(spans: dict | None, outer: str, name: str, field: str) -> float | None:
    """``field`` of the region ``name`` over the count of the region
    ``outer`` (a pass's ``lrds.eval``, a step's ``lrds.step``), in ms for the
    seconds fields; None where either region is absent."""
    if not spans or name not in spans or not spans.get(outer, {}).get("count"):
        return None
    value = spans[name][field] / spans[outer]["count"]
    return value if field == "count" else 1e3 * value
