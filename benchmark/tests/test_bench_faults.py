"""A run with the timed path broken underneath comes out not correct, and
so does the control (the plain reference in TF32 put in the program's
place); a sound run at a small size comes out correct. On the CPU: the
harness's look for a chip is skipped and the cells run at smaller batches
(the sampling cell at its K 100, the training cell at K 20)."""
import importlib
import json
import math
import os
import time

import pytest
import torch

from benchlib import harness, util

ROOT = util.BENCH_DIR.parent
SAMPLE = {"batch": 1024, "spec": {"fit_draws": 4000}}
TRAIN = {"batch": 4, "spec": {"n_steps": 20, "fit_draws": 2000}}


def run(capsys, workload, overrides, fault=None, seed=3_000_000_019):
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5"],
                      t_start=time.perf_counter(), root=ROOT, device="cpu",
                      overrides=overrides, fault=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_sampling_run_is_correct(capsys):
    out = run(capsys, "many_modes_d8.sample", SAMPLE)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out["checks"])[0] == "b1_launches_off" and list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["altered", "half_batch", "half_reduction"])
def test_a_broken_sampling_pass_is_not_correct(capsys, fault):
    out = run(capsys, "many_modes_d8.sample", SAMPLE, fault=fault)
    assert not out["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(capsys, fault):
    out = run(capsys, "mnist_unet.train", TRAIN, fault=fault)
    assert not out["correct"]


def test_a_sound_training_run_is_correct(capsys):
    out = run(capsys, "mnist_unet.train", TRAIN)
    assert out["correct"], out["checks"]


def failed(readings: dict, limits: dict) -> list:
    return [k for k in limits if not (math.isfinite(readings[k]) and readings[k] <= limits[k])]


@pytest.mark.parametrize("workload, overrides", [
    ("many_modes_d8.sample", {"batch": 4096, "spec": {"fit_draws": 4000}}),
    ("mnist_unet.train", {"batch": 8, "spec": {"n_steps": 20, "fit_draws": 2000}})])
def test_the_control_is_not_correct(workload, overrides):
    from calibrate import readings

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for rec in readings(workload, [17, 18], True, None, 0.3, ROOT, device="cpu",
                        overrides=overrides):
        limits = _limits(workload)
        assert failed(rec["control"], limits), rec["control"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["many_modes_d8.sample", "mnist_unet.train"])
def test_the_control_at_the_cells_size_on_the_card(card, workload):
    """On the card at the cell's own size, three seeds: the program's
    readings hold their limits and the control's fail one."""
    from calibrate import readings

    for rec in readings(workload, [1, 2, 3], True, None, 1.0, ROOT, device=card):
        limits = _limits(workload)
        assert not failed(rec["program"], limits), rec["program"]
        assert failed(rec["control"], limits), rec["control"]


def _limits(workload: str) -> dict:
    bench = util.read_json(ROOT / "BENCHMARK.json")
    _, conf = harness.cell(bench, workload)
    return importlib.import_module(f"reference.{conf['name']}").LIMITS
