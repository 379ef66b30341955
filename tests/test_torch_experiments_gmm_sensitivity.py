"""The port's GMM-components sweep end to end on the CPU at a tiny size
against the JAX package's ``lrds_run``: TwoModes (d 4), 1 and 2 diagonal
components fitted to one MALA dataset, vp-ref; one pickle with a cell per
component count (helpers in tests/test_torch_experiments.py)."""
from test_torch_experiments import check_driver_against_jax


def test_gmm_sensitivity_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("gmm_sensitivity", tmp_path, monkeypatch,
                                          n_points=2)
    assert path.name == "two_modes_gmm_sensitivity_solver_vp-ref_seed_0.pkl"
    assert [c["params"] for c in data["results"]] == [{"n_components": 1},
                                                       {"n_components": 2}]
    # one dataset for the sweep: both cells carry its moments
    first, second = (c["gauss_params"]["mean"] for c in data["results"])
    assert (first == second).all()
