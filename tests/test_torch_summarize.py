"""experiments/summarize_results.py (numpy only, no port of its own) on a
pickle the port's ``dump_results`` writes, with ``--results_dirs`` and
``--out`` pointed into a temporary folder, away from
experiments/results/SUMMARY.md: one row for each cell, the medians over the
eval seeds, and the divergence flag on a cell with a non-finite metric."""
import importlib.util
from pathlib import Path

from sde_sampler_lrds_torch.experiments.common import dump_results

REPO = Path(__file__).parents[1]


def test_summarize_results_reads_a_port_pickle(tmp_path):
    results = tmp_path / "results_port"
    cells = [{"params": {"dim": 16, "seed": 0},
              "metrics": {"eval/elbo": [-1.0, -2.0, -3.0],
                          "error/log_norm_const_is": [0.1, 0.3, 0.2],
                          "eval/norm_effective_sample_size": [0.9, 0.8, 0.95]}},
             {"params": {"dim": 64, "seed": 0},
              "metrics": {"eval/elbo": [-1.0, float("nan")]}}]
    dump_results(results, "two_modes_port.pkl", {"seed": 0, "device": "cpu"}, cells)
    spec = importlib.util.spec_from_file_location(
        "summarize_results", REPO / "experiments" / "summarize_results.py")
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    out = tmp_path / "SUMMARY.md"
    before = (REPO / "experiments" / "results" / "SUMMARY.md").read_bytes()
    summarize.main(["--results_dirs", str(results), "--out", str(out)])
    assert (REPO / "experiments" / "results" / "SUMMARY.md").read_bytes() == before
    rows = [line for line in out.read_text().splitlines() if line.startswith("| two_modes")]
    assert len(rows) == 2
    assert "| dim=16,seed=0 | 0.2 | -2 |" in rows[0] and rows[0].endswith("| ok |")
    assert "0.9" in rows[0] and rows[1].endswith("| **DIVERGED** |")
