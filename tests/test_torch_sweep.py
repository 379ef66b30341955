"""The port's sweep launcher (``python -m sde_sampler_lrds_torch.scripts.sweep``)
held against the JAX package's ``scripts/sweep.py`` (loaded with importlib:
it imports no JAX): the same grid expansion, run names and per-job argv
(the port's calls its CLI as a module), a real two-job local sweep on the
CPU with its summary.json, the slurm script writer, and device slots leased
from a pool and pinned with CUDA_VISIBLE_DEVICES only.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from sde_sampler_lrds_torch.scripts import sweep as port_sweep

REPO = Path(__file__).parents[1]
TINY_BASE = ("--device cpu --solver vp_rds --target two_modes --dim 2 "
             "--steps 8 --train-steps 4 --train-batch-size 32 "
             "--eval-batch-size 128 --eval-interval 1000000 --log-interval 2")


def _jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_sweep", REPO / "scripts" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GRIDS = [["seed=0,1,2"], ["seed=3,4", "loss-method=kl,lv"], ["train.lr=1e-3,3e-4", "sigma=1"],
         []]


@pytest.mark.parametrize("sweeps", GRIDS)
def test_grid_names_and_commands_match_jax(sweeps):
    jax_sweep = _jax_sweep()
    runs = list(port_sweep.expand_grid(sweeps))
    assert runs == list(jax_sweep.expand_grid(sweeps))
    base = ["--solver", "vp_rds", "--train-steps", "8"]
    for i, ov in enumerate(runs or [{}]):
        assert port_sweep.run_name(i, ov) == jax_sweep.run_name(i, ov)
        got = port_sweep.job_cmd(base, ov, "out/x")
        want = jax_sweep.job_cmd(Path("scripts/main.py"), base, ov, "out/x")
        assert got[:3] == [sys.executable, "-m", "sde_sampler_lrds_torch.scripts.main"]
        assert got[3:] == want[2:]


def test_expand_grid_rejects_as_jax():
    with pytest.raises(SystemExit) as want:
        list(_jax_sweep().expand_grid(["seed"]))
    with pytest.raises(SystemExit) as got:
        list(port_sweep.expand_grid(["seed"]))
    assert str(got.value) == str(want.value)


def test_slot_env_pins_cuda_only(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = port_sweep.slot_env(1, 2)
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    assert {k for k in env if k.startswith("TPU_")} == \
        {k for k in os.environ if k.startswith("TPU_")}
    assert str(port_sweep.ROOT) in env["PYTHONPATH"].split(os.pathsep)
    assert "CUDA_VISIBLE_DEVICES" not in port_sweep.slot_env(0, 0)


def test_local_sweep_two_jobs_and_summary(tmp_path):
    out_root = tmp_path / "sweep"
    proc = subprocess.run(
        [sys.executable, "-m", "sde_sampler_lrds_torch.scripts.sweep", "--jobs", "2",
         "--base", TINY_BASE, "--sweep", "seed=3,4", "--out-root", str(out_root)],
        capture_output=True, text=True, cwd=tmp_path, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout[-2000:]
    summary = json.loads((out_root / "summary.json").read_text())
    assert summary["n_jobs"] == 2 and summary["n_failed"] == 0
    assert {j["out_dir"] for j in summary["jobs"]} == {f"{out_root}/seed3", f"{out_root}/seed4"}
    for j in summary["jobs"]:
        assert j["returncode"] == 0
        assert j["final_metrics"].get("step") == 4
        assert any(k.startswith("eval/") for k in j["final_metrics"])
        resolved = json.loads((Path(j["out_dir"]) / "resolved.json").read_text())
        assert resolved["device"]["type"] == "cpu"
        assert resolved["train"]["seed"] == int(j["overrides"]["seed"])


def test_slurm_script_writer(tmp_path):
    out_root = tmp_path / "slurm"
    with pytest.raises(SystemExit) as exit_info:
        port_sweep.main(["--launcher", "slurm", "--jobs", "2", "--slurm-no-submit",
                         "--base", TINY_BASE, "--sweep", "seed=0,1,2",
                         "--out-root", str(out_root)])
    assert exit_info.value.code == 0
    script = (out_root / "sweep.sbatch").read_text()
    assert "#SBATCH --array=0-2%2" in script
    assert script.count("-m sde_sampler_lrds_torch.scripts.main") == 3
    assert "--seed 0" in script and "--seed 2" in script
    assert f"export PYTHONPATH={port_sweep.ROOT}" in script


def test_device_slots_are_leased_not_index_derived(tmp_path, monkeypatch):
    """With more grid points than slots, a slot derived from the job index
    could hand a busy card to the next job: slots are leased from a pool."""
    stub = tmp_path / "stub_main.py"
    log = tmp_path / "slots.log"
    stub.write_text(
        "import os, time\n"
        "t0 = time.time(); time.sleep(0.4); t1 = time.time()\n"
        f"open({str(log)!r}, 'a').write(\n"
        "    f\"{os.environ.get('CUDA_VISIBLE_DEVICES')} {t0} {t1}\\n\")\n")
    monkeypatch.setattr(port_sweep, "job_cmd",
                        lambda base, overrides, out_dir: [sys.executable, str(stub)])
    args = SimpleNamespace(out_root=str(tmp_path / "out"), jobs=3, device_slots=2)
    results = port_sweep.launch_local([], [{"seed": str(i)} for i in range(5)], args)
    assert all(r["returncode"] == 0 for r in results)
    rows = [ln.split() for ln in log.read_text().splitlines()]
    assert len(rows) == 5 and {r[0] for r in rows} <= {"0", "1"}
    by_slot = {}
    for slot, t0, t1 in rows:
        by_slot.setdefault(slot, []).append((float(t0), float(t1)))
    for slot, spans in by_slot.items():
        spans.sort()
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 <= b0 + 1e-3, f"slot {slot} double-booked"
