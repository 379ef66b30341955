"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json`` with its sizes, and
``configs/<config>.py``, which builds the program's system from the seed),
its traffic mix (``traffic/<traffic>.json``), and each metric's reader
(``metrics/<metric>.py``, whose ``read(ctx)`` returns a number or None).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

from . import util, window, yardstick
from .trace import read_chrome_trace, summarize

TRACE_S = 2.0     # the traced tail of a --trace 1 window, at most a quarter of it


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell(bench: dict, name: str):
    """(workload entry, configuration entry) of the cell ``name``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(work)}")
    conf = {c["name"]: c for c in bench["configs"]}[work[name]["config"]]
    return work[name], conf


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]]


def read_metrics(entries: list[dict], ctx, bench_dir: Path = util.BENCH_DIR) -> dict:
    """Each metric's reader ``metrics/<name>.py``, loaded by name; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        reader = util.load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                  f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def prepare(root: Path, conf: dict, work: dict, seed: int, device, overrides: dict | None = None,
            fault: str | None = None):
    """A run's set-up after the look for a chip, shared by the harness and
    ``calibrate.py``: the configuration's precision set, its system built
    from the seed (with ``fault`` planted) and warmed up. (system, mix,
    sync)."""
    import torch

    spec = util.read_json(root / conf["file"])
    mix = util.read_json(util.BENCH_DIR / "traffic" / f"{work['traffic']}.json")
    if spec.get("precision") != "float32":
        raise SystemExit(f"precision {spec.get('precision')!r}: the harness sets float32 only")
    # float32 as stated: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = util.load_module(util.BENCH_DIR / "configs" / f"{conf['name']}.py",
                             f"bench_config_{conf['name']}")
    system = build.build(spec, mix, seed, device, overrides or {})
    if fault is not None:
        system.plant(fault)
    system.warm_up()
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    return system, mix, sync


def launch_check(system, before: dict, after: dict, n_ops: int) -> dict:
    """The port's B1 launch counters over the window against the cell's
    expectation: printed, and the check's number (0 when they agree)."""
    delta = {k: after[k] - before[k] for k in after}
    want = system.expected_launches(n_ops)
    print(f"launch_counters {json.dumps(delta)} expected {json.dumps(want)}", flush=True)
    return {"b1_launches_off": (float(sum(abs(delta[k] - want.get(k, 0)) for k in delta)), 0.0)}


def main(argv=None, t_start: float | None = None, root: Path | None = None, device=None,
         overrides: dict | None = None, fault: str | None = None) -> int:
    """Run one cell; print the result line; the exit code. ``device``,
    ``overrides`` and ``fault`` serve the tests alone: a run on the CPU at
    smaller sizes, with a fault planted in the timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = Path.cwd() if root is None else Path(root)
    bench = util.read_json(root / "BENCHMARK.json")
    work, conf = cell(bench, args.workload)
    util.set_cache_dirs(root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
            print(f"needs {work['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        card = util.card_info(torch)
        print(f"card {json.dumps(card)}", flush=True)
    else:
        card = {"name": "cpu", "power_limit": "none"}
    system, mix, sync = prepare(root, conf, work, args.seed, device, overrides, fault)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = system.launch_counters()
    profiler = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    setup_s = time.perf_counter() - t_start
    win = window.run(mix, system.operation(mix["operation"]), args.seconds, sync,
                     profiler=profiler, trace_s=min(TRACE_S, args.seconds / 4))
    after = system.launch_counters()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    trace = None
    if profiler is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            profiler.export_chrome_trace(path)
            trace = summarize(read_chrome_trace(path))
        finally:
            os.unlink(path)
    _, peaks, sfu_rate = yardstick.card_peaks(card["name"])
    ctx = SimpleNamespace(records=win.records, window_s=win.seconds, head_records=win.head_records,
                          head_s=win.head_s, setup_s=setup_s, trace=trace, counts=system.counts(),
                          peaks=peaks, sfu_rate=sfu_rate, on_card=on_card)
    metrics = read_metrics(metrics_for(bench, work["name"], bool(args.trace)), ctx)

    checks = launch_check(system, before, after, len(win.records))
    system.free()
    t_ref = time.perf_counter()
    checks.update(system.check())
    print(f"reference_s {time.perf_counter() - t_ref}", flush=True)

    found = util.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": card["name"], "count": 1,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(win.records),
              "failed": sum(1 for r in win.records if not r[3]), "metrics": metrics,
              "device": device_out, "card": card}
    if trace is not None:
        device_out.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
