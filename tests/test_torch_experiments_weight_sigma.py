"""The port's weight and sigma sensitivity sweeps end to end on the CPU at a
tiny size against the JAX package's driver preamble and ``run_vi``:
TwoModes (d 4), vp-ref; the weight sweep on a 2-component diagonal fit with
its weights set to (skew, 1 - skew), the sigma sweep on the 'default'
reference around the moment-matched sigma, whose scale the 'default'
reference and the VP prior take (held against JAX with a JAX solver's
parameters, under fed noise). The solvers the port does not have yet are
refused (helpers in tests/test_torch_experiments.py)."""
import math

import jax
import numpy as np
import pytest
import torch

import test_torch_experiments as te
from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.ops.fused_traj import fused_simulate
from sde_sampler_lrds_tpu.api import make_model
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from test_torch_experiments import check_driver_against_jax


def test_weight_sensitivity_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("weight_sensitivity", tmp_path, monkeypatch,
                                          n_points=2)
    assert path.name == "weight_sensitivity_solver_vp-ref_seed_0.pkl"
    assert [c["params"] for c in data["results"]] == [{"weight_skew": 0.1},
                                                       {"weight_skew": 0.5}]


def test_sigma_sensitivity_driver_matches_jax(tmp_path, monkeypatch):
    data, path = check_driver_against_jax("sigma_sensitivity", tmp_path, monkeypatch,
                                          n_points=2)
    assert path.name == "sigma_sensitivity_solver_vp-ref_seed_0.pkl"
    (a, b) = (c["params"] for c in data["results"])
    assert (a["sigma_factor"], b["sigma_factor"]) == (0.25, 1.0)
    assert math.isclose(a["sigma"], 0.25 * b["sigma"], rel_tol=1e-12) and b["sigma"] > 0


@pytest.mark.parametrize("solver_type", ["pis_orig", "dds_orig", "dis_orig"])
def test_sigma_sensitivity_refuses_unported_solvers(solver_type, tmp_path):
    from sde_sampler_lrds_torch.experiments import sigma_sensitivity

    with pytest.raises(NotImplementedError, match=f"{solver_type} is not ported.*A2"):
        sigma_sensitivity.main(["--solver_type", solver_type, "--device", "cpu",
                                "--results_path", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_default_reference_scaled_sigma_matches_jax():
    """vp-ref on the 'default' reference at sigma 0.25 (the sigma sweep's
    smallest factor scales the VP and its Gaussian prior): with the JAX
    solver's perturbed parameters, the LV loss and the evaluation agree under
    the JAX package's own noise."""
    args = te._args("vp-ref", "default", "ei", "snr", n_steps=12, batch=64)
    args["solver_details"] = {"sigma": 0.25}
    j, t = make_model(mesh=get_mesh(1), **args), t_make_model(device="cpu", **args)
    assert float(t.prior.scale[0, 0]) == pytest.approx(0.25)
    j.setup(jax.random.PRNGKey(3))
    j.state = j.state.replace(params=jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape),
        j.state.params))
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    k, b, d = j.train_ts.shape[0] - 1, 64, te.DIM
    key = jax.random.PRNGKey(11)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (b,)))
    zs = np.asarray(jax.random.normal(jax.random.split(k_sim)[0], (k, b, d)))
    want, _ = j.loss_fn(j.state.params, key)
    got, _ = t.loss_fn(None, x0=te.T(x0), noise=te.T(zs))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    key = jax.random.PRNGKey(12)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (b,)))
    zs, kk = [], k_sim
    for _ in range(k):
        kk, k_z, _ = jax.random.split(kk, 3)
        zs.append(np.asarray(jax.random.normal(k_z, (b, d))))
    want = j.evaluate(key)
    cfg, arrays = t._fused_eval_plan()
    x_t, rnd = fused_simulate(cfg, arrays, None, te.T(x0),
                              noise=te.T(np.stack(zs)), **t.loss_call_args())
    np.testing.assert_allclose(te.N(x_t), np.asarray(want.samples), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(te.N(rnd), np.asarray(want.rnd), rtol=1e-4, atol=1e-4)


def test_default_reference_zero_control_chain_and_its_log_z():
    """vp-ref with EI on the 'default' reference at sigma 0.25 on TwoModes d
    16: at zero control (untrained) both packages' samples end at N(0, rho
    sigma^2), rho from the steps' recursion in
    chip_smoke.default_reference_log_z, not at the reference's sigma^2 that
    the rnd divides by; and its closed-form log Z' (what the ELBO and IS aim
    at instead of log Z = 0) matches a Monte Carlo mean over target draws."""
    import chip_smoke

    sigma, b, d = 0.25, 8192, 16
    args = te._args("vp-ref", "default", "ei", "snr", n_steps=100, batch=b, dim=d)
    args["solver_details"] = {"sigma": sigma}
    j, t = make_model(mesh=get_mesh(1), **args), t_make_model(device="cpu", **args)
    rho, log_z_prime = chip_smoke.default_reference_log_z(t)
    se = rho * math.sqrt(2.0 / (b * d))          # of a variance ratio over b * d draws
    assert rho - 1.0 > 8 * se
    j.setup(jax.random.PRNGKey(0))
    t.setup(torch.Generator().manual_seed(0))
    x_j = np.asarray(j.evaluate(jax.random.PRNGKey(1)).samples)
    x_t = te.N(t.evaluate(torch.Generator().manual_seed(1)).samples)
    for x in (x_j, x_t):
        assert abs(x.var() / sigma**2 - rho) < 5 * se
    g = torch.Generator().manual_seed(2)
    y = t.target.sample(g, (200_000,)).double()
    log_ratio = (-0.5 * d * math.log(rho)
                 + (1.0 - 1.0 / rho) / (2 * sigma**2) * torch.sum(y**2, dim=-1))
    mc = float(torch.logsumexp(log_ratio, dim=0)) - math.log(y.shape[0])
    assert log_z_prime > 4.0 and abs(mc - log_z_prime) < 0.01
