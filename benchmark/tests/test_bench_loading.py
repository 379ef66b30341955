"""Configurations, traffic mixes and metrics are found by name: a new one
is a new file and a new entry, with no edit to an existing file."""
import json
import shutil
from types import SimpleNamespace

import pytest

from benchlib import harness, util, window

BENCH = util.BENCH_DIR


def test_every_entry_has_its_files():
    bench = util.read_json(BENCH.parent / "BENCHMARK.json")
    for conf in bench["configs"]:
        spec = util.read_json(BENCH.parent / conf["file"])
        assert spec["name"] == conf["name"] and spec["reduced"] == conf["reduced"]
        assert (BENCH / "configs" / f"{conf['name']}.py").is_file()
        assert (BENCH / "reference" / f"{conf['name']}.py").is_file()
    for work in bench["workloads"]:
        mix = util.read_json(BENCH / "traffic" / f"{work['traffic']}.json")
        assert mix["loop"] in window.LOOPS
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(util.load_module(BENCH / "metrics" / f"{m['name']}.py", "m").read)


def test_a_new_config_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark with a configuration and a metric added as
    new files and new entries: the harness's loaders find both."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "ops_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    spec = util.read_json(BENCH / "configs" / "many_modes_d8.json")
    spec.update(name="many_modes_d8_wide", channels=128)
    (copy / "configs" / "many_modes_d8_wide.json").write_text(json.dumps(spec))
    shutil.copy(copy / "configs" / "many_modes_d8.py", copy / "configs" / "many_modes_d8_wide.py")
    (copy / "traffic" / "sample_2k.json").write_text(json.dumps(
        {"loop": "closed", "operation": "sample", "batch": 2048}))
    bench = util.read_json(BENCH.parent / "BENCHMARK.json")
    bench["configs"].append({"name": "many_modes_d8_wide", "source": "x", "reduced": [],
                             "file": "benchmark/configs/many_modes_d8_wide.json", "why": "x"})
    bench["workloads"].append({"name": "many_modes_d8_wide.sample_2k",
                               "config": "many_modes_d8_wide", "traffic": "sample_2k",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "ops_done", "unit": "ops", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "sample_rate",
                               "workloads": ["many_modes_d8_wide.sample_2k"]})
    work, conf = harness.cell(bench, "many_modes_d8_wide.sample_2k")
    assert conf["file"].endswith("many_modes_d8_wide.json")
    entries = harness.metrics_for(bench, work["name"], True)
    assert [m["name"] for m in entries] == ["ops_done"]
    ctx = SimpleNamespace(records=[(0, 1, 1, True)] * 3)
    assert harness.read_metrics(entries, ctx, bench_dir=copy) == {
        "ops_done": {"value": 3.0, "unit": "ops"}}
    mod = util.load_module(copy / "configs" / f"{conf['name']}.py", "bench_config_new")
    assert callable(mod.build)


def test_an_unknown_cell_or_loop_is_refused():
    bench = util.read_json(BENCH.parent / "BENCHMARK.json")
    with pytest.raises(SystemExit):
        harness.cell(bench, "many_modes_d8.nothing")
    with pytest.raises(ValueError):
        window.run({"loop": "open"}, lambda i: (1, True), 0.0, lambda: None)


def test_the_closed_loop_records_every_operation_it_starts():
    ops = []

    def op(i):
        ops.append(i)
        return 10, i != 2
    w = window.run({"loop": "closed"}, op, 0.05, lambda: None)
    assert len(w.records) == len(ops) and ops == list(range(len(ops)))
    assert w.seconds >= 0.05 and all(r[2] == 10 for r in w.records)
    assert [r[3] for r in w.records][2] is False
