"""The port's ManyModes competing driver end to end on the CPU at a tiny
size against the JAX package's ``competing_run`` (ManyModes d 2, 4 modes):
PIS (σ over √T, the SDE's horizon from --terminal_t_pis) and DIS on the
vp_20 schedule, as that driver runs it (helpers in
tests/test_torch_experiments.py)."""
import pytest

from test_torch_experiments import check_competing_against_jax


@pytest.mark.parametrize("solver_type", ["pis_orig", "dis_orig"])
def test_many_modes_competing_driver_matches_jax(solver_type, tmp_path, monkeypatch):
    check_competing_against_jax("many_modes", solver_type, tmp_path, monkeypatch)
