"""The φ⁴ weight-estimator analysis in both packages on one tiny pickle,
and experiments/summarize_results.py on a pickle of the port's.

The pickle is written by the port's ``dump_results`` with the keys the
port's ``sample_phi_four_ebm_mcmc`` stores (d 8, b 0.02: the dataset's raw
and Rao-Blackwellized weights, the eval seeds' raw and RB weights, the
first eval's samples). The JAX package's experiments/analyze_phi4_rb.py
(its experiments/common.py loaded as tests/test_torch_experiments.py loads
it) and the port's print the same table (3 decimals; the RB weight
recomputed from the samples by both targets agrees to 1e-4 relative). With
``--distances`` each computes the Sinkhorn distance, MMD and sliced KS
against its own exact FFBS draws, so those agree only statistically: the
port's are finite and within a factor 1.5 of the JAX package's.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.experiments import analyze_phi4_rb
from sde_sampler_lrds_torch.experiments.common import dump_results

from test_torch_experiments import _jax_experiments_common

REPO = Path(__file__).parents[1]
DIM, B_COUPLING = 8, 0.02


def _write_pickle(path: Path, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    signs = np.where(rng.random((512, 1)) < 0.6, 1.0, -1.0)
    samples = (signs + 0.3 * rng.normal(size=(512, DIM))).astype(np.float32)
    cell = {"params": {"b": B_COUPLING, "dim": DIM},
            "metrics": {"eval/weight": [1.31, 1.52], "eval/weight_rb": [1.21, 1.27],
                        "eval/elbo": [-3.0, -3.1], "samples": samples},
            "dataset_weight_raw": 1.05, "dataset_weight_rb": 1.08, "forward_ess_ebm": 0.41}
    dump_results(path, f"phi_four_ebm_mcmc_solver_vp-ref_seed_{seed}.pkl",
                 {"seed": seed, "device": "cpu"}, [cell])


def _jax_analysis(results_dir, distances, tmp_path, monkeypatch, capsys) -> list:
    common = _jax_experiments_common(tmp_path, monkeypatch)
    monkeypatch.setitem(sys.modules, "common", common)
    spec = importlib.util.spec_from_file_location("jax_analyze_phi4_rb",
                                                  REPO / "experiments" / "analyze_phi4_rb.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capsys.readouterr()
    module.main(str(results_dir), distances=distances, device="cpu")
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("distances", [False, True])
def test_analysis_prints_the_jax_rows(distances, tmp_path, monkeypatch, capsys):
    results = tmp_path / "results_rb"
    _write_pickle(results)
    want = _jax_analysis(results, distances, tmp_path, monkeypatch, capsys)
    argv = [str(results), "--device", "cpu"] + (["--distances"] if distances else [])
    rows = analyze_phi4_rb.main(argv)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2 and got[0] == want[0]
    (row,) = rows
    j_fields, t_fields = want[1].split("sink")[0], got[1].split("sink")[0]
    # every column but the recomputed RB weight is the pickle's, printed alike
    assert t_fields.split()[:-1] == j_fields.split()[:-1]
    np.testing.assert_allclose(row["vi_rb_recomputed"], float(j_fields.split()[-1]),
                               rtol=1e-3)
    if distances:
        tail = want[1].split("sink")[1].split()      # value, 'mmd', value, 'ks', value
        for key, value in zip(("sinkhorn", "mmd", "ks"), tail[0::2]):
            assert np.isfinite(row[key]) and 1 / 1.5 <= row[key] / float(value) <= 1.5, key


def test_analysis_without_pickles(tmp_path, capsys):
    assert analyze_phi4_rb.main([str(tmp_path), "--device", "cpu"]) == []
    assert capsys.readouterr().out.strip() == f"no pickles under {tmp_path}/"
