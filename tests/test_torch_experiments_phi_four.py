"""The port's phi four driver end to end on the CPU at a tiny size
against the JAX package's ``lrds_run``: φ⁴ (d 8, b 0.02, 2-component full-covariance GMM, no
sample-based losses). The pickle has the JAX
cell's keys, numpy and builtins only, and experiments/summarize_results.py
reads it (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_driver_against_jax


def test_phi_four_driver_matches_jax(tmp_path, monkeypatch):
    check_driver_against_jax("phi_four", tmp_path, monkeypatch)
