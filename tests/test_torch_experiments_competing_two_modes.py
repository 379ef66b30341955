"""The port's TwoModes competing driver end to end on the CPU at a tiny
size against the JAX package's ``competing_run`` (TwoModes d 4): original
DDS (scale moment-matched to the MALA dataset, no EUBO) and CMCD (its prior
fitted to the dataset, with the EUBO). The pickle has the JAX cell's keys,
numpy and builtins only, and experiments/summarize_results.py reads it; the
'smc' cell raises naming its queue item (helpers in
tests/test_torch_experiments.py)."""
import pytest

from test_torch_experiments import check_competing_against_jax


@pytest.mark.parametrize("solver_type", ["dds_orig", "cmcd"])
def test_two_modes_competing_driver_matches_jax(solver_type, tmp_path, monkeypatch):
    data = check_competing_against_jax("two_modes", solver_type, tmp_path, monkeypatch)
    metrics = data["results"][0]["metrics"]
    assert ("eval/eubo" in metrics) == (solver_type == "cmcd")


@pytest.mark.parametrize("baseline", ["smc", "re"])
def test_two_modes_competing_baselines_name_a3(baseline, tmp_path):
    from sde_sampler_lrds_torch.experiments import sample_two_modes_competing

    with pytest.raises(NotImplementedError, match="A3"):
        sample_two_modes_competing.main(["--solver_type", baseline, "--device", "cpu",
                                         "--dim_range", "2", "--results_path", str(tmp_path)])
    assert not list(tmp_path.glob("*.pkl"))
