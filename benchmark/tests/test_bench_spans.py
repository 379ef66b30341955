"""The split of a traced window by the port's own regions
(``benchlib/spans.py``) on a synthetic trace, the program counters
(``benchlib/counters.py``) against a program with and without them, and
``split.py`` on the CPU at small sizes."""
import json
import os
import time

import pytest
import torch

from benchlib import counters, spans, util
from benchlib.trace import WINDOW

US = 1000.0     # a millisecond in the trace's microseconds


def ev(cat, name, t0_ms, t1_ms, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": t0_ms * US, "dur": (t1_ms - t0_ms) * US,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace_events():
    """A 12 ms window. The main thread (tid 1) in ``lrds.step`` over 0–10
    ms, its ``backward`` over 2–6 and ``simulate`` over 6–9. The autograd
    thread (tid 2) launches kernel 7 at 3 ms; the main thread launches
    kernel 8 at 7 ms and kernel 9 at 11 ms, outside every region; kernel 10
    has no launch in the trace. The card is busy 4–5, 7.5–8.5 and 11.2–11.6
    ms, and with kernel 10 over 0.5–1; the GPU's copy of a region's range
    (``gpu_user_annotation``) is not a region."""
    return [
        ev("user_annotation", WINDOW, 0, 12),
        ev("user_annotation", "lrds.step", 0, 10),
        ev("user_annotation", "lrds.step.backward", 2, 6),
        ev("user_annotation", "lrds.step.simulate", 6, 9),
        ev("gpu_user_annotation", "lrds.step.simulate", 7.5, 8.5),
        ev("cuda_runtime", "cudaLaunchKernel", 3, 3.1, tid=2, corr=7),
        ev("cuda_runtime", "cudaGraphLaunch", 7, 7.2, corr=8),
        ev("cuda_runtime", "cudaLaunchKernel", 11, 11.1, corr=9),
        ev("kernel", "wgrad", 4, 5, corr=7),
        ev("kernel", "conv", 7.5, 8.5, corr=8),
        ev("kernel", "reduce", 11.2, 11.6, corr=9),
        ev("kernel", "unlaunched", 0.5, 1, corr=10),
        ev("cpu_op", "aten::item", 11.9, 12),
    ]


def test_device_time_goes_to_the_region_around_its_launch_on_any_thread():
    got = spans.split(trace_events())
    assert got["lrds.step.backward"]["device_s"] == pytest.approx(0.001)   # launched on tid 2
    assert got["lrds.step.simulate"]["device_s"] == pytest.approx(0.001)
    assert got["lrds.step"]["device_s"] == 0.0
    assert got[spans.OUTSIDE]["device_s"] == pytest.approx(0.0009)          # kernels 9 and 10
    assert "(no host event)" not in got


def test_idle_gaps_go_to_the_region_over_their_middle():
    got = spans.split(trace_events())
    # gaps: 0–0.5 and 1–4 (middles in lrds.step at 0.25, in backward at 2.5),
    # 5–7.5 (middle 6.25, simulate), 8.5–11.2 (middle 9.85, lrds.step),
    # 11.6–12 (outside)
    assert got["lrds.step.backward"]["idle_s"] == pytest.approx(0.003)
    assert got["lrds.step.simulate"]["idle_s"] == pytest.approx(0.0025)
    assert got["lrds.step"]["idle_s"] == pytest.approx(0.0005 + 0.0027)
    assert got[spans.OUTSIDE]["idle_s"] == pytest.approx(0.0004)
    idle = sum(v["idle_s"] for v in got.values())
    busy = sum(v["device_s"] for v in got.values())
    assert idle + busy == pytest.approx(0.012)


def test_regions_count_host_time_and_read_per_operation():
    got = spans.split(trace_events())
    assert got["lrds.step"]["count"] == 1 and got["lrds.step"]["host_s"] == pytest.approx(0.010)
    assert got["lrds.step.simulate"]["count"] == 1          # the GPU's copy not counted
    assert spans.per_op(got, "lrds.step", "lrds.step.backward", "host_s") == pytest.approx(4.0)
    assert spans.per_op(got, "lrds.step", "lrds.step.simulate", "idle_s") == pytest.approx(2.5)
    assert spans.per_op(got, "lrds.step", "lrds.step.backward", "count") == 1.0


def test_readers_find_nothing_without_a_trace_regions_or_counters(monkeypatch):
    assert spans.split([]) is None
    plain = [e for e in trace_events() if not e["name"].startswith("lrds.")]
    got = spans.split(plain)
    assert set(got) == {spans.OUTSIDE}
    assert got[spans.OUTSIDE]["device_s"] == pytest.approx(0.0029)
    for split in (None, {}, got):
        assert spans.per_op(split, "lrds.step", "lrds.step.simulate", "device_s") is None
    assert counters.per_op({}, {}, 10) == {} and counters.per_op({"a": 1}, {"a": 3}, 0) == {}

    from sde_sampler_lrds_torch.solvers import oc
    from sde_sampler_lrds_torch.utils import profiling

    assert set(counters.snapshot()) == {"host_read.count", "GraphedCall.captures"}
    monkeypatch.delattr(profiling, "host_read")
    monkeypatch.delattr(oc.GraphedCall, "captures")
    assert counters.snapshot() == {}


def test_counters_rise_by_the_reads_of_a_pass():
    from sde_sampler_lrds_torch.losses.base import compute_results

    before = counters.snapshot()
    compute_results(torch.randn(64), compute_weights=True, max_rnd=1e8)
    after = counters.snapshot()
    assert counters.delta(before, after) == {"host_read.count": 7, "GraphedCall.captures": 0}
    assert counters.per_op(before, after, 2) == {"host_read.count": 3.5,
                                                 "GraphedCall.captures": 0.0}


@pytest.mark.parametrize("workload, overrides, seconds, reads, regions", [
    ("many_modes_d8.sample", {"batch": 1024, "spec": {"fit_draws": 4000}}, "0.5", 7.0,
     {"lrds.eval", "lrds.eval.plan", "lrds.eval.prior", "lrds.eval.simulate",
      "lrds.eval.results"}),
    ("mnist_unet.train", {"batch": 4, "spec": {"n_steps": 20, "fit_draws": 2000}}, "2", 1.0,
     {"lrds.step", "lrds.step.loss", "lrds.step.plan", "lrds.step.simulate",
      "lrds.step.ctrl_eval", "lrds.step.backward", "lrds.step.guard", "lrds.step.update"}),
])
def test_split_prints_the_regions_and_counters_of_a_run(capsys, workload, overrides, seconds,
                                                        reads, regions):
    """The traced tail is the window's last quarter: the training cell's
    steps take long enough on the CPU that it needs a longer window."""
    split = util.load_module(util.BENCH_DIR / "split.py", "bench_split")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rc = split.main(["--workload", workload, "--seed", "3000000019", "--seconds", seconds],
                    t_start=time.perf_counter(), root=util.BENCH_DIR.parent, device="cpu",
                    overrides=overrides)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2])["correct"]
    out = json.loads(lines[-1].removeprefix("program_split "))
    assert set(out["spans"]) == regions | {spans.OUTSIDE}
    assert out["counters_per_op"] == {"host_read.count": reads, "GraphedCall.captures": 0.0}
    outer = "lrds.eval" if workload.endswith("sample") else "lrds.step"
    assert out["spans"][outer]["count"] == out["tail_ops"] >= 1
    assert out["per_op_ms"][outer]["host_s"] == pytest.approx(
        1e3 * out["spans"][outer]["host_s"] / out["tail_ops"])
