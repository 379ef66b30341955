"""The port's SMC and replica-exchange baselines of the competing drivers
held against the JAX package at tiny sizes: ``run_sampling_baseline`` (the
run count, the pooled samples cut into ``eval_batch_size`` chunks across
runs, the metric keys, the sample time and the Sinkhorn config), a
competing driver's 'smc' and 're' cells through its ``main`` against the
JAX ``competing_run`` of the same cell (the ``--smc_*`` / ``--re_*`` flags
taking any value), and ROADMAP C5 in both packages: the logistic-regression
posteriors have no sampler, so their baseline cells stop at
``target.sample`` (helpers in tests/test_torch_experiments.py).
"""
import math
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_experiments as te
from sde_sampler_lrds_torch.experiments.common import run_sampling_baseline
from sde_sampler_lrds_torch.targets import LogisticRegression as TLogReg
from sde_sampler_lrds_torch.targets import TwoModes as TTwoModes
from sde_sampler_lrds_tpu.targets import LogisticRegression, TwoModes

SMC = {"n_steps": 6, "n_particles": 64, "n_mcmc_steps": 4, "n_warmup_mcmc_steps": 4,
       "step_size": 1e-2}
RE = {"n_steps": 6, "batch_size": 32, "swap_frequency": 2, "n_mcmc_steps": 3,
      "n_warmup_mcmc_steps": 4, "step_size": 1e-2}


def _gauss(dim=2):
    data = np.asarray(TwoModes(dim=dim).sample(jax.random.PRNGKey(0), (4000,)))
    return data.mean(0).astype(np.float32), np.cov(data.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["smc", "re"])
def test_run_sampling_baseline_matches_jax(kind, tmp_path, monkeypatch):
    """SMC: 256 samples a run, 2 runs, 2 chunks of 256. RE: 96 a run,
    int(512 / 96) = 5 runs, 480 pooled samples, 1 chunk (the leftover of
    each run carried to the next)."""
    common = te._jax_experiments_common(tmp_path, monkeypatch)
    mean, cov = _gauss()
    kw = dict(eval_batch_size=256, n_sampling_seeds=2, smc_kwargs=SMC, re_kwargs=RE)
    want = common.run_sampling_baseline(jax.random.PRNGKey(1), kind, TwoModes(dim=2),
                                        jnp.asarray(mean), jnp.asarray(cov), **kw)
    target = TTwoModes(dim=2, device="cpu")
    got = run_sampling_baseline(torch.Generator().manual_seed(1), kind, target,
                                torch.as_tensor(mean), torch.as_tensor(cov), device="cpu", **kw)
    assert set(got) == set(want)
    n_chunks = 2 if kind == "smc" else 1
    for k, v in want.items():
        if isinstance(v, list):
            assert len(got[k]) == len(v) == n_chunks, k
            assert all(math.isfinite(x) for x in got[k]), k
    # the same Sinkhorn, up to the backend each package records
    drop = lambda c: {k: v for k, v in c.items() if k != "backend"}  # noqa: E731
    assert drop(got["sinkhorn_config"]) == drop(want["sinkhorn_config"])
    assert got["eval/sample_time"] > 0
    # the two-mode weight of 2/3 within the tiny runs' Monte Carlo error:
    # 256 samples of at least 32 chains; 4 standard errors at 32
    w = np.asarray(got["eval/mode_weight"]) / 100
    assert np.all(np.abs(w - 2 / 3) < 4 * math.sqrt(2 / 9 / 32))


def test_run_sampling_baseline_derives_fresh_ground_truth_per_chunk(monkeypatch):
    """Each chunk's ground truth comes from its own generator: a run whose
    pool gives two chunks draws two different target samples."""
    target = TTwoModes(dim=2, device="cpu")
    draws = []
    sample = target.sample

    def spy(generator, shape):
        out = sample(generator, shape)
        draws.append(out)
        return out

    monkeypatch.setattr(target, "sample", spy)
    mean, cov = _gauss()
    run_sampling_baseline(torch.Generator().manual_seed(2), "smc", target, torch.as_tensor(mean),
                          torch.as_tensor(cov), eval_batch_size=128, n_sampling_seeds=1,
                          smc_kwargs=SMC, device="cpu")
    assert len(draws) == 2 and not torch.equal(draws[0], draws[1])


def _jax_args(tmp_path, solver_type):
    return types.SimpleNamespace(
        results_path=str(tmp_path / "jax"), solver_type=solver_type, terminal_t_pis=5.0,
        **{f"smc_{k}": v for k, v in SMC.items() if k != "step_size"},
        **{f"re_{k}": v for k, v in RE.items() if k != "step_size"}, **te.TINY)


@pytest.mark.parametrize("solver_type", ["smc", "re"])
def test_competing_driver_baseline_cell_matches_jax(solver_type, tmp_path, monkeypatch):
    """sample_two_modes_competing d 4 with non-default --smc_* / --re_*
    flags (step size 1e-4, as both packages fix it) against the JAX
    competing_run of the same cell: the pickle's keys, the chunk count."""
    from sde_sampler_lrds_torch.experiments import sample_two_modes_competing as driver

    flags = [f"--{k}={v}" for k, v in vars(_jax_args(tmp_path, solver_type)).items()
             if k.startswith(("smc_", "re_")) or k in te.TINY]
    out = tmp_path / "port"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        driver.main(flags + ["--solver_type", solver_type, "--dim_range", "4", "--device", "cpu",
                             "--results_path", str(out)])
    finally:
        torch.set_num_threads(threads)
    (path,) = out.glob("*.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert te._only_host_types(data)
    assert data["config"]["re_batch_size"] == RE["batch_size"]
    common = te._jax_experiments_common(tmp_path, monkeypatch)
    details = common.make_target_details("two_modes", dim=4, ill_conditioned="not")
    target = common.make_target(details)
    want = common.competing_run(_jax_args(tmp_path, solver_type), target, details, target.loc,
                                path.name, extra_params={"dim": 4})
    (cell,) = data["results"]
    assert set(cell) == set(want) and cell["params"] == want["params"]
    assert set(cell["metrics"]) == set(want["metrics"])
    assert set(cell["times"]) == set(want["times"])
    n = len(want["metrics"]["error/sinkhorn"])
    assert n >= 1 and len(cell["metrics"]["error/sinkhorn"]) == n
    assert all(math.isfinite(v) for v in cell["metrics"]["error/sinkhorn"])


@pytest.mark.parametrize("kind", ["smc", "re"])
def test_logreg_baselines_stop_at_target_sample_in_both_packages(kind, tmp_path, monkeypatch):
    """ROADMAP C5, held in both packages: each chunk's ground truth is a
    ``target.sample`` draw, which the logistic-regression posteriors lack."""
    common = te._jax_experiments_common(tmp_path, monkeypatch)
    kw = dict(eval_batch_size=32, n_sampling_seeds=1,
              smc_kwargs={**SMC, "n_particles": 16}, re_kwargs={**RE, "batch_size": 16})
    j_target = LogisticRegression(data_type="sonar")
    with pytest.raises(NotImplementedError):
        common.run_sampling_baseline(jax.random.PRNGKey(0), kind, j_target,
                                     jnp.zeros(j_target.dim), jnp.eye(j_target.dim), **kw)
    t_target = TLogReg(data_type="sonar", device="cpu")
    with pytest.raises(NotImplementedError):
        run_sampling_baseline(torch.Generator().manual_seed(0), kind, t_target,
                              torch.zeros(t_target.dim), torch.eye(t_target.dim), device="cpu",
                              **kw)
