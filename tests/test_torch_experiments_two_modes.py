"""The port's two modes driver end to end on the CPU at a tiny size
against the JAX package's ``lrds_run``: TwoModes (d 4, 2-component diagonal GMM, vp-ref). The pickle has the JAX
cell's keys, numpy and builtins only, and experiments/summarize_results.py
reads it (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_driver_against_jax


def test_two_modes_driver_matches_jax(tmp_path, monkeypatch):
    check_driver_against_jax("two_modes", tmp_path, monkeypatch)
