"""The port's sample_phi_four_ebm_mcmc driver end to end on the CPU at a
tiny size (d 8, b 0.02, the GMM means seeded at the Laplace oracle's minima,
forward-ESS checkpoint selection) against the JAX package's driver run
through its own main: the same pickle name, keys and structure, and the
dataset weights beside the transfer-matrix weight (helpers in
tests/test_torch_experiments.py)."""
import math

from test_torch_experiments import check_ebm_driver_against_jax


def test_phi_four_ebm_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_ebm_driver_against_jax(
        "sample_phi_four_ebm_mcmc", ["--dim", "8", "--b_range", "0.02", "--select_best"],
        tmp_path, monkeypatch)
    assert path.name == "phi_four_ebm_mcmc_solver_vp-ref_seed_0.pkl"
    cell = data["results"][0]
    assert cell["params"] == {"b": 0.02, "dim": 8}
    assert {"ebm_select_step", "ebm_select_fwd_ess"} <= set(cell["times"])
    assert math.isfinite(cell["dataset_weight_rb"]) and cell["dataset_weight_raw"] > 0
    assert all(math.isfinite(v) for v in cell["metrics"]["eval/weight_rb"])
