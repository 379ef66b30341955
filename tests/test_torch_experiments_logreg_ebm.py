"""The port's sample_bayesian_logreg_ebm_mcmc driver on ionosphere (d 34)
end to end on the CPU at a tiny size, with the preconditioned negatives,
against the JAX package's driver run through its own main: the same pickle
name, keys and structure (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_ebm_driver_against_jax


def test_logreg_ebm_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_ebm_driver_against_jax(
        "sample_bayesian_logreg_ebm_mcmc", ["--datasets", "ionosphere", "--ebm_use_precond"],
        tmp_path, monkeypatch)
    assert path.name == "bayesian_logreg_ebm_mcmc_solver_vp-ref_seed_0.pkl"
    cell = data["results"][0]
    assert cell["params"] == {"dataset": "ionosphere"}
    assert cell["metrics"]["samples"].shape[1] == 34
    assert data["config"]["ebm_use_precond"] is True
