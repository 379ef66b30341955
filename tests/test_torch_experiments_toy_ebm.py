"""The port's sample_toy_ebm_mcmc driver on Rings end to end on the CPU at
a tiny size (one EBM epoch over 5 levels, 16 VI steps, 2 eval seeds)
against the JAX package's driver run through its own main: the same pickle
name, keys and structure (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_ebm_driver_against_jax


def test_toy_ebm_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_ebm_driver_against_jax("sample_toy_ebm_mcmc", [], tmp_path, monkeypatch)
    assert path.name == "toy_rings_ebm_mcmc_solver_vp-ref_seed_0.pkl"
    cell = data["results"][0]
    assert cell["params"] == {"target": "rings"}
    assert {"mcmc", "ref", "ebm_train"} <= set(cell["times"])
    assert cell["metrics"]["samples"].shape[1] == 2
    assert data["config"]["ebm_n_accumulation_steps"] == 5
