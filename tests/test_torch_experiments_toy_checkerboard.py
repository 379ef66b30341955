"""The port's toy driver on Checkerboard end to end on the CPU at a tiny
size against the JAX package's ``lrds_run``: Checkerboard (d 2, width 4),
chains from the squares' centres, an 8-component diagonal GMM, vp-ref. The
target's density is exactly 0 off the board, so a terminal sample there
gives rnd = +inf: the unfiltered ELBO is -inf in both packages, and the
filtered metrics and ``eval/filtered_frac`` carry the cell (helpers in
tests/test_torch_experiments.py)."""
import math

from test_torch_experiments import check_driver_against_jax


def test_toy_checkerboard_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("toy_checkerboard", tmp_path, monkeypatch)
    assert path.name == "toy_checkerboard_gmm_mcmc_ref_gmm_solver_vp-ref_seed_0.pkl"
    m = data["results"][0]["metrics"]
    assert all(0.0 <= f < 1.0 for f in m["eval/filtered_frac"])
    for elbo, elbo_f, frac in zip(m["eval/elbo"], m["eval/elbo_filtered"],
                                  m["eval/filtered_frac"]):
        # the unfiltered bound is -inf exactly when a trajectory was filtered
        assert (elbo == -math.inf) == (frac > 0) and math.isfinite(elbo_f)
    for log_z, log_z_f, elbo_f in zip(m["eval/log_norm_const_is"],
                                      m["eval/log_norm_const_is_filtered"],
                                      m["eval/elbo_filtered"]):
        assert elbo_f <= log_z_f and log_z <= log_z_f
