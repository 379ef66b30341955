"""The port's increasing-distance sweep end to end on the CPU at a tiny
size against the JAX package's ``lrds_run``: TwoModes (d 4) at a = 1 and 4,
a 2-component diagonal GMM, vp-ref on the vp_20 schedule; one pickle with a
cell per distance (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_driver_against_jax


def test_distance_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("distance", tmp_path, monkeypatch, n_points=2)
    assert path.name == "two_modes_distance_ref_gmm_solver_vp-ref_seed_0.pkl"
    assert [c["params"] for c in data["results"]] == [{"a": 1.0, "dim": 4},
                                                       {"a": 4.0, "dim": 4}]
