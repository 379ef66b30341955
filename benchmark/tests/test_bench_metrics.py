"""Each metric's arithmetic on synthetic records and traces."""
from types import SimpleNamespace

import pytest

from benchlib import harness, util
from benchlib.trace import WINDOW, summarize

PEAKS = (67e12, 3.35e12, 989e12, 494.7e12)


def ctx(**kw):
    base = dict(records=[], window_s=1.0, head_records=[], head_s=0.0, setup_s=12.5, trace=None,
                counts={}, peaks=PEAKS, sfu_rate=16 * 132 * 1980e6, on_card=True)
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, c):
    return util.load_module(util.BENCH_DIR / "metrics" / f"{name}.py", f"m_{name}").read(c)


def test_sample_rate_is_all_work_over_the_window():
    recs = [(0.0, 0.02, 1000, True), (0.02, 0.05, 1000, True), (0.05, 0.06, 1000, False)]
    assert read("sample_rate", ctx(records=recs, window_s=0.1)) == pytest.approx(30000.0)


def test_p95_is_over_all_passes_by_nearest_rank():
    durations = [0.010] * 95 + [0.050] * 4 + [0.100]
    recs = [(i, i + d, 1, True) for i, d in enumerate(durations)]
    assert read("sample_p95_ms", ctx(records=recs)) == pytest.approx(10.0)
    recs.append((200, 200.2, 1, True))            # one more slow pass moves the rank
    assert read("sample_p95_ms", ctx(records=recs)) == pytest.approx(50.0)


def test_train_step_is_the_window_over_the_steps():
    recs = [(0, 0.4, 1, True)] * 25
    assert read("train_step_ms", ctx(records=recs, window_s=10.5)) == pytest.approx(420.0)


def test_setup_is_passed_through():
    assert read("setup_s", ctx()) == 12.5


def test_no_records_read_nothing():
    for name in ("sample_rate", "sample_p95_ms", "train_step_ms"):
        assert read(name, ctx()) is None


def trace_events():
    """A 10 ms window: kernels busy 0–4 and 5–8 ms (one overlapping), the
    host in a synchronise over the 4–5 ms gap and in nothing over 8–10."""
    us = 1000.0
    return [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0.0, "dur": 10 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 0.5 * us},
        {"ph": "X", "cat": "kernel", "name": "traj_kernel_diag<false, 4, 1>", "ts": 0.0, "dur": 4 * us},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 3.9 * us,
         "dur": 1.2 * us},
        {"ph": "X", "cat": "kernel", "name": "reduce", "ts": 5 * us, "dur": 3 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 7 * us, "dur": 0.5 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 9.9 * us, "dur": 0.1 * us},
    ]


def test_trace_busy_idle_and_breakdown():
    t = summarize(trace_events())
    assert t["window_s"] == pytest.approx(0.010)
    assert t["busy_s"] == pytest.approx(0.007)
    assert t["device_ops"][0] == ["traj_kernel_diag<false, 4, 1>", pytest.approx(0.004)]
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.001)
    assert gaps["(no host event)"] == pytest.approx(0.002)
    c = ctx(trace=t)
    assert read("idle.sample", c) == pytest.approx(30.0)
    assert read("idle.train", c) == pytest.approx(30.0)


def test_roofline_reads_b1_launches_from_the_trace():
    from benchlib import yardstick

    b1 = yardstick.b1_counts(8, 64, 2, 4, 100, 131072)
    t = {"ops": {"void traj_kernel_diag<false, 4, 1>(Params)": {"count": 2, "seconds": 0.030},
                 "reduce": {"count": 5, "seconds": 0.001}}}
    got = read("b1_roofline", ctx(trace=t, counts={"b1": b1}))
    assert got == pytest.approx(100 * 3.6558e-3 / 0.015, rel=1e-3)
    assert read("b1_roofline", ctx(trace={"ops": {"reduce": {"count": 1, "seconds": 1.0}}},
                                   counts={"b1": b1})) is None


def test_mfu_uses_the_unprofiled_head_and_never_a_cpu_run():
    head = [(0, 0.02, 1, True)] * 50
    c = ctx(head_records=head, head_s=1.0, counts={"model_flops_per_op": 2.449e11})
    assert read("mfu.sample", c) == pytest.approx(100 * 50 * 2.449e11 / 67e12)
    assert read("mfu.train", ctx(head_records=head, head_s=1.0, counts={"model_flops_per_op": 1.0},
                                 on_card=False)) is None
    assert read("idle.sample", ctx(trace={"window_s": 1.0, "busy_s": 0.5}, on_card=False)) is None


def test_metrics_for_a_cell_follow_their_workloads_key():
    bench = util.read_json(util.BENCH_DIR.parent / "BENCHMARK.json")
    e2e = [m["name"] for m in harness.metrics_for(bench, "mnist_unet.train", False)]
    per = [m["name"] for m in harness.metrics_for(bench, "many_modes_d8.sample", True)]
    assert e2e == ["train_step_ms", "setup_s"]
    assert per == ["b1_roofline", "mfu.sample", "idle.sample"]
