"""The port's CLI (``python -m sde_sampler_lrds_torch.scripts.main``) held
against the JAX package's ``scripts/main.py``: the same flags and defaults
(``--device`` aside), the same ``--set`` parsing (the JAX script's
``parse_overrides``, loaded with importlib: it imports no JAX at module
level), and the runs at the JAX CLI tests' ``TINY`` flags on ``--device
cpu`` as subprocesses: the artifacts (config.json, resolved.json with the
device, metrics.jsonl, the final checkpoint), resume from the checkpoint,
``--set`` overrides reaching every namespace (a bf16 control and a
hyperparameter schedule among them), and the failure path (error.txt, exit
code 1), with the presets the port lacks (the UNet models, ``--plots``)
refused naming their ROADMAP queue item; the VI presets (pis, dds, dis
with GBS's inference control, cmcd; the score, langevin_init and lerp
models) run, and where make_model refuses a preset the message is the JAX
CLI's.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sde_sampler_lrds_torch.scripts import main as port_main

REPO = Path(__file__).parents[1]
MODULE = "sde_sampler_lrds_torch.scripts.main"

TINY = [
    "--device", "cpu", "--steps", "8", "--train-steps", "6",
    "--train-batch-size", "32", "--eval-batch-size", "128",
    "--eval-interval", "1000000", "--log-interval", "2", "--seed", "3",
    "--target", "two_modes", "--dim", "2",
]


def _jax_main():
    spec = importlib.util.spec_from_file_location("jax_cli_main", REPO / "scripts" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cli(extra, out_dir, tiny=TINY):
    cmd = [sys.executable, "-m", MODULE, *tiny, "--out-dir", str(out_dir), *extra]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600)


def _records(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_flags_and_presets_match_jax():
    jax_main = _jax_main()
    assert port_main.SOLVER_PRESETS == jax_main.SOLVER_PRESETS
    assert port_main.MODEL_PRESETS == jax_main.MODEL_PRESETS
    assert port_main._OVERRIDE_NS == jax_main._OVERRIDE_NS
    jp, tp = jax_main.build_parser(), port_main.build_parser()
    jopts = {a.dest: (a.option_strings, a.default, a.choices) for a in jp._actions}
    topts = {a.dest: (a.option_strings, a.default, a.choices) for a in tp._actions}
    assert set(topts) == set(jopts)
    for dest in jopts:
        if dest != "device":
            assert topts[dest] == jopts[dest], dest
    assert topts["device"] == (["--device"], "cuda", ["cuda", "cpu"])


@pytest.mark.parametrize("pairs", [
    [["train.lr=1e-3", "sde.diff_coeff_sq_max=20"]],
    [["train.param_schedule={'loss.max_rnd': {'milestones': [4], 'gamma': 0.1}}"],
     ["model.compute_dtype=bfloat16", "solver.sigma=1.5", "target.a=0.5"]],
    [["loss.max_rnd=1e6", "train.use_ema=True", "train.name=word", "train.t=(1, 2)"]],
])
def test_parse_overrides_matches_jax(pairs):
    assert port_main.parse_overrides(pairs) == _jax_main().parse_overrides(pairs)


@pytest.mark.parametrize("item", ["nosuch.lr=1", "train.lr", "lr=1", "train.=3"])
def test_parse_overrides_rejects_as_jax(item):
    with pytest.raises(SystemExit) as want:
        _jax_main().parse_overrides([[item]])
    with pytest.raises(SystemExit) as got:
        port_main.parse_overrides([[item]])
    assert str(got.value) == str(want.value)


def test_compute_dtype_override():
    assert port_main._compute_dtype("bfloat16") is torch.bfloat16
    assert port_main._compute_dtype("float32") is None
    assert port_main._compute_dtype(None) is None
    with pytest.raises(ValueError, match="compute_dtype"):
        port_main._compute_dtype("nosuch")


def test_cli_run_writes_artifacts_and_resumes(tmp_path):
    out = tmp_path / "run"
    proc = run_cli(["--solver", "vp_rds"], out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["solver"] == "vp_rds" and cfg["device"] == "cpu"
    resolved = json.loads((out / "resolved.json").read_text())
    assert resolved["device"] == {"type": "cpu", "name": "cpu"}
    assert resolved["sde"]["class"] == "VP" and resolved["train"]["train_steps"] == 6
    lines = _records(out)
    assert [r["step"] for r in lines] == [2, 4, 6, 6]
    assert any("train/loss" in r for r in lines) and "eval/elbo" in lines[-1]
    assert not (out / "error.txt").exists()
    assert [p.name for p in (out / "ckpt").glob("ckpt*.pt")] == ["ckpt000006.pt"]
    # resume: from the final checkpoint to step 10, appending to metrics.jsonl
    proc2 = run_cli(["--solver", "vp_rds", "--resume", "--train-steps", "10"], out)
    assert proc2.returncode == 0, proc2.stderr[-2000:]
    assert "resumed from step 6" in (proc2.stderr + proc2.stdout)
    assert [r["step"] for r in _records(out)] == [2, 4, 6, 6, 8, 10, 10]
    assert sorted(p.name for p in (out / "ckpt").glob("ckpt*.pt")) == \
        ["ckpt000006.pt", "ckpt000010.pt"]


def test_cli_set_overrides(tmp_path):
    """--set reaches every namespace; resolved.json records the effective
    config; a bf16 control and a scheduled loss attribute run end to end."""
    out = tmp_path / "ovr"
    spec = "{'loss.max_rnd': {'milestones': [4], 'gamma': 0.1}}"
    proc = run_cli(["--solver", "vp_rds", "--integrator", "ei", "--time-type", "snr",
                    "--ckpt-interval", "3", "--set", "train.lr=0.001",
                    "sde.diff_coeff_sq_max=20.0", "train.steps_per_call=2",
                    "loss.max_rnd=1000000.0", f"train.param_schedule={spec}",
                    "model.compute_dtype=bfloat16"], out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads((out / "resolved.json").read_text())
    assert r["train"]["lr"] == 0.001
    assert r["train"]["steps_per_call"] == 2
    assert r["train"]["ckpt_interval"] == 3
    assert r["sde"]["class"] == "VP"
    assert r["sde"]["diff_coeff_sq_max"] == 20.0
    sched = [(x["step"], x["sched/loss.max_rnd"]) for x in _records(out)
             if "sched/loss.max_rnd" in x]
    assert sched == [(2, 1e6), (4, pytest.approx(1e5)), (6, pytest.approx(1e5))]
    # the steps stride by steps_per_call: checkpoints at 3 and 6 are not on
    # the stride, so only the final one is written
    assert [p.name for p in (out / "ckpt").glob("ckpt*.pt")] == ["ckpt000006.pt"]


def test_cli_set_rejects_bad_namespace(tmp_path):
    proc = run_cli(["--solver", "vp_rds", "--set", "nosuch.lr=1"], tmp_path / "badns")
    assert proc.returncode != 0
    assert "--set expects NS.KEY=VALUE" in proc.stderr


def test_cli_failure_writes_error_txt(tmp_path):
    out = tmp_path / "fail"
    proc = run_cli(["--solver", "vp_rds", "--target", "no_such_target"], out,
                   tiny=["--device", "cpu"])
    assert proc.returncode == 1
    err = (out / "error.txt").read_text()
    assert "Traceback" in err and "no_such_target" in err


def test_cli_default_solver_refuses_naming_a2(tmp_path):
    """The JAX CLI's default preset, dis, waited on ROADMAP A2 here. With
    its default model (basic) the JAX CLI itself exits 1 on make_model's
    rule "Model base_zero_init is not supported." and so does the port,
    with that message; with ``--model score`` the default solver runs to
    exit 0 with finite metrics and the final checkpoint."""
    out = tmp_path / "dis"
    proc = run_cli([], out, tiny=["--device", "cpu"])
    assert proc.returncode == 1
    err = (out / "error.txt").read_text()
    assert "Model base_zero_init is not supported." in err and "ROADMAP" not in err
    assert json.loads((out / "config.json").read_text())["solver"] == "dis"
    out = tmp_path / "dis_score"
    proc = run_cli(["--model", "score"], out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    final = _records(out)[-1]
    assert final["step"] == 6 and all(
        isinstance(final[k], float) and final[k] == final[k]
        for k in ("eval/elbo", "eval/log_norm_const_is"))
    assert json.loads((out / "resolved.json").read_text())["sde"]["class"] == "VP"
    assert (out / "ckpt" / "ckpt000006.pt").exists()


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--solver", "pis", "--model", "score"], None, id="flags0-ROADMAP A2"),
    pytest.param(["--solver", "dds", "--model", "score"], None, id="flags1-ROADMAP A2"),
    pytest.param(["--solver", "cmcd"], None, id="flags2-ROADMAP A2"),
    pytest.param(["--solver", "vp_rds", "--model", "score"], None, id="flags3-ROADMAP A2"),
    pytest.param(["--solver", "vp_rds", "--model", "basic_unet", "--target", "mnist_zero_one",
                  "--dim", "196"], None, id="flags4-ROADMAP A6"),
    pytest.param(["--solver", "pbm_rds", "--plots"], "ROADMAP A7", id="flags5-ROADMAP A7"),
    pytest.param(["--solver", "vp_rds", "--model", "score_unet", "--target", "mnist_zero_one",
                  "--dim", "196"], None, id="flags6-ROADMAP A6"),
])
def test_cli_refuses_unported_in_process(flags, item, tmp_path):
    """--plots exits 1 naming its queue item. The presets refused here
    until ROADMAP A2 (pis, dds, cmcd, the score model) and A6 (the MNIST
    UNet's basic_unet and score_unet, on the NICE mixture) now run in
    process to exit 0 with finite metrics (pis and dds with the score
    model, which make_model requires of them, as in the JAX CLI)."""
    out = tmp_path / "refused"
    tiny = ["--steps", "6", "--train-steps", "4", "--train-batch-size", "16",
            "--eval-batch-size", "64", "--log-interval", "2", "--dim", "2"]
    if item is None:
        port_main.main(["--device", "cpu", "--out-dir", str(out), *tiny, *flags])
        assert not (out / "error.txt").exists()
        final = _records(out)[-1]
        assert final["step"] == 4 and final["eval/elbo"] == final["eval/elbo"]
        return
    with pytest.raises(SystemExit) as exit_info:
        port_main.main(["--device", "cpu", "--out-dir", str(out), *flags])
    assert exit_info.value.code == 1
    assert item in (out / "error.txt").read_text()
    assert not (out / "metrics.jsonl").exists()


@pytest.mark.parametrize("flags", [
    ["--solver", "dis", "--model", "lerp"], ["--solver", "dis", "--model", "langevin_init"],
    ["--solver", "vp_rds", "--model", "langevin_init"],
    ["--solver", "dis", "--model", "score", "--set",
     "model.inference_ctrl_arch=base_zero_init"],
    ["--solver", "dis", "--model", "score", "--set",
     "model.inference_ctrl_arch=base_zero_init", "loss.div_estimator=rademacher"],
])
def test_cli_vi_presets_run_in_process(flags, tmp_path):
    """The other VI presets in process on --device cpu: DIS with the lerp
    and Langevin-init controls, vp_rds with the Langevin-init control (the
    reference score taken out of it), and GBS (DIS with a learned inference
    control, its divergence exact or Hutchinson) run to their final record
    and checkpoint."""
    out = tmp_path / "run"
    port_main.main(["--device", "cpu", "--out-dir", str(out), "--steps", "6",
                    "--train-steps", "4", "--train-batch-size", "16", "--eval-batch-size",
                    "64", "--log-interval", "2", "--dim", "2", *flags])
    assert not (out / "error.txt").exists()
    assert _records(out)[-1]["step"] == 4 and (out / "ckpt" / "ckpt000004.pt").exists()


@pytest.mark.parametrize("flags", [["--solver", "dds", "--model", "basic"],
                                   ["--solver", "pis", "--model", "basic"]])
def test_cli_vi_refusals_match_jax(flags, tmp_path):
    """pis and dds with the basic model exit 1 in both CLIs with
    make_model's own message ("Only target_informed_zero_init model is
    supported.")."""
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    proc = run_cli(flags, out_t)
    cmd = [sys.executable, str(REPO / "scripts" / "main.py"), *TINY, "--out-dir", str(out_j),
           *flags]
    jproc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600)
    assert proc.returncode == jproc.returncode == 1
    last = lambda p: p.read_text().strip().splitlines()[-1]
    assert last(out_t / "error.txt") == last(out_j / "error.txt") == (
        "ValueError: Only target_informed_zero_init model is supported.")
