"""The port's toy driver on Rings end to end on the CPU at a tiny size
against the JAX package's ``lrds_run``: Rings (d 2), chains from 4 draws on
every ring, an 8-component diagonal GMM, vp-ref. The pickle has the JAX
cell's keys and name, numpy and builtins only, and
experiments/summarize_results.py reads it (helpers in
tests/test_torch_experiments.py)."""
from test_torch_experiments import check_driver_against_jax


def test_toy_rings_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("toy_rings", tmp_path, monkeypatch)
    assert path.name == "toy_rings_gmm_mcmc_ref_gmm_solver_vp-ref_seed_0.pkl"
    assert data["config"]["n_components"] == 8 and data["config"]["target_type"] == "rings"
    m = data["results"][0]["metrics"]
    assert m["samples"].shape[1] == 2
    assert {"eval/emc", "eval/kl_weights", "eval/tv_weights",
            "eval/num_forgotten_modes"} <= set(m)
