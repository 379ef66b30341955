"""Run one benchmark cell once with its last seconds traced, as

    python3 benchmark/split.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, and print after the harness's own lines one
more, ``program_split {...}``: the traced window split by the port's own
regions (``benchlib/spans.py``: count, host, device and idle seconds of
each, ``(outside)`` for what none holds) and the same in ms an operation
(over the count of ``lrds.eval`` or ``lrds.step``), the share of the
device's seconds that a region holds, the port's program counters over the
whole window (``benchlib/counters.py``: their rise and their rise an
operation), and the operation times of the window: the mean of its
unprofiled head, the first traced operation (which carries the profiler's
start on the card) and the mean of the traced ones after it. It drives
``benchlib.harness.main`` unchanged and reads what it reads on the way: the
trace's events as ``summarize`` gets them, the counters where it reads the
launch counters, the window's records as the metrics get them. Against a
program without regions or counters the split holds ``(outside)`` alone and
the counters are empty."""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from benchlib import counters, harness, spans  # noqa: E402
from benchlib.system import System  # noqa: E402


def main(argv, **kw) -> int:
    """``kw`` goes to ``harness.main`` (the tests' CPU runs)."""
    seen = {"counters": []}
    summarize, read_metrics, launch_counters = (harness.summarize, harness.read_metrics,
                                                System.launch_counters)

    def summarize_and_split(events, *a, **k):
        seen["spans"] = spans.split(events)
        return summarize(events, *a, **k)

    def counted(system):
        seen["counters"].append(counters.snapshot())
        return launch_counters(system)

    def read_and_keep(entries, ctx, *a, **k):
        seen["ctx"] = ctx
        return read_metrics(entries, ctx, *a, **k)

    harness.summarize, harness.read_metrics = summarize_and_split, read_and_keep
    System.launch_counters = counted
    try:
        rc = harness.main([*argv, "--trace", "1"], **{"t_start": T_START, **kw})
    finally:
        harness.summarize, harness.read_metrics = summarize, read_metrics
        System.launch_counters = launch_counters
    if rc != 0 or "ctx" not in seen:
        return rc
    ctx, split = seen["ctx"], seen.get("spans") or {}
    n_ops, n_head = len(ctx.records), len(ctx.head_records)
    outer = next((k for k in ("lrds.eval", "lrds.step") if k in split), None)
    before, after = (seen["counters"] + [{}, {}])[:2]
    device = sum(v["device_s"] for v in split.values())
    held = sum(v["device_s"] for k, v in split.items() if k != spans.OUTSIDE)
    tail = [1e3 * (r[1] - r[0]) for r in ctx.records[n_head:]]
    out = {"spans": split,
           "per_op_ms": {k: {f: spans.per_op(split, outer, k, f)
                             for f in ("host_s", "device_s", "idle_s")} for k in split},
           "device_share_held": held / device if device else None,
           "counters": counters.delta(before, after),
           "counters_per_op": counters.per_op(before, after, n_ops), "ops": n_ops,
           "head_ops": n_head, "head_mean_ms": _mean([1e3 * (r[1] - r[0])
                                                     for r in ctx.head_records]),
           "tail_ops": len(tail), "tail_first_ms": tail[0] if tail else None,
           "tail_mean_ms": _mean(tail[1:])}
    print("program_split " + json.dumps(out), flush=True)
    return 0


def _mean(values):
    return sum(values) / len(values) if values else None


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
