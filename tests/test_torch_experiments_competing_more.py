"""The port's φ⁴ and toy competing drivers: every flag, default and choice
of their parsers against the JAX drivers' (the JAX driver scripts executed
up to their ``parse_args``; ``--device`` is 'cuda' or 'cpu' in the port),
and a tiny run of each on the CPU (φ⁴ d 8 with CMCD, Rings and
Checkerboard with DDS and PIS) whose pickle holds finite sampler metrics
(helpers in tests/test_torch_experiments.py)."""
import argparse
import math
import pickle
import sys

import pytest
import torch

import test_torch_experiments as te

TINY_FLAGS = [f"--{k}={v}" for k, v in te.TINY.items()]


def _jax_parser(script, tmp_path, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX driver script builds, from its source up to the
    parse_args line, with the JAX experiments' common module importable as
    ``common``."""
    monkeypatch.setitem(sys.modules, "common", te._jax_experiments_common(tmp_path, monkeypatch))
    src = (te.REPO / "experiments" / f"{script}.py").read_text()
    scope = {"__name__": "jax_driver"}
    exec(compile(src[:src.index("args = parser.parse_args()")], script, "exec"), scope)
    return scope["parser"]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script", ["sample_phi_four_competing", "sample_toy_competing"])
def test_competing_parser_matches_jax(script, tmp_path, monkeypatch):
    import importlib

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{script}")
    want = _actions(_jax_parser(script, tmp_path, monkeypatch))
    got = _actions(driver.build_parser())
    assert set(got) == set(want)
    for dest, w in want.items():
        if dest == "device":
            assert got[dest][0] == w[0] and tuple(got[dest][3]) == ("cuda", "cpu")
        else:
            assert got[dest] == w, dest


@pytest.mark.parametrize("script,flags", [
    ("sample_phi_four_competing", ["--solver_type", "cmcd", "--dim", "8", "--b_range", "0.02"]),
    ("sample_toy_competing", ["--solver_type", "dds_orig"]),
    ("sample_toy_competing", ["--solver_type", "pis_orig", "--target_type", "checkerboard"]),
])
def test_competing_driver_tiny_run(script, flags, tmp_path):
    import importlib

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{script}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        driver.main(flags + ["--device", "cpu", "--results_path", str(tmp_path)] + TINY_FLAGS)
    finally:
        torch.set_num_threads(threads)
    (path,) = tmp_path.glob("*.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert te._only_host_types(data)
    (cell,) = data["results"]
    m = cell["metrics"]
    # the checkerboard's density is 0 off its squares: its filtered bound
    key = "eval/elbo_filtered" if "checkerboard" in flags else "eval/elbo"
    assert len(m[key]) == te.TINY["n_sampling_seeds"]
    assert all(math.isfinite(v) for v in m[key]) and all(
        math.isfinite(v) for v in m["eval/log_norm_const_is_filtered"])
