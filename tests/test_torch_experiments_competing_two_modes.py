"""The port's TwoModes competing driver end to end on the CPU at a tiny
size against the JAX package's ``competing_run`` (TwoModes d 4): original
DDS (scale moment-matched to the MALA dataset, no EUBO) and CMCD (its prior
fitted to the dataset, with the EUBO). The pickle has the JAX cell's keys,
numpy and builtins only, and experiments/summarize_results.py reads it; the
'smc' and 're' cells run at a tiny depth (helpers in
tests/test_torch_experiments.py; the baselines against the JAX package in
tests/test_torch_experiments_baselines.py)."""
import math
import pickle

import pytest

from test_torch_experiments import check_competing_against_jax


@pytest.mark.parametrize("solver_type", ["dds_orig", "cmcd"])
def test_two_modes_competing_driver_matches_jax(solver_type, tmp_path, monkeypatch):
    data = check_competing_against_jax("two_modes", solver_type, tmp_path, monkeypatch)
    metrics = data["results"][0]["metrics"]
    assert ("eval/eubo" in metrics) == (solver_type == "cmcd")


@pytest.mark.parametrize("baseline", ["smc", "re"])
def test_two_modes_competing_baselines_name_a3(baseline, tmp_path):
    """The baselines of ROADMAP A3, which this driver once refused naming
    that item, run through it: a tiny SMC or RE cell at d 2 writes its
    pickle, one chunk of finite sample metrics."""
    from sde_sampler_lrds_torch.experiments import sample_two_modes_competing

    sample_two_modes_competing.main([
        "--solver_type", baseline, "--device", "cpu", "--dim_range", "2", "--results_path",
        str(tmp_path), "--dataset_size", "1000", "--eval_batch_size", "128",
        "--n_sampling_seeds", "1", "--smc_n_steps", "4", "--smc_n_particles", "32",
        "--smc_n_mcmc_steps", "4", "--smc_n_warmup_mcmc_steps", "4", "--re_n_steps", "4",
        "--re_batch_size", "32", "--re_n_mcmc_steps", "4", "--re_n_warmup_mcmc_steps", "8"])
    (path,) = tmp_path.glob("*.pkl")
    with open(path, "rb") as f:
        (cell,) = pickle.load(f)["results"]
    m = cell["metrics"]
    for key in ("error/sinkhorn", "error/mmd", "error/ks", "eval/mode_weight"):
        assert len(m[key]) == 1 and math.isfinite(m[key][0]), key
