"""φ⁴'s Laplace oracle and the base grid quadrature in the port, held
against the JAX package on the CPU: ``boole_grid`` and the base
``Target.compute_stats_integration`` on a 2-d Gaussian with an unknown
normalizing constant, ``run_gdflow``, ``sample_uniform``'s box, the φ⁴
Hessian (the 1-d band and the autograd Hessian of a 2-d lattice),
``log_laplace`` and ``compute_stats_integration`` (the flow from ±1 to
``x_min``, the raw and Laplace weights, the transfer-matrix statistics).

Tolerances: float32 in both packages; the flow's 10 000 steps of a
contraction agree to 1e-5; the Laplace log-densities (values ~ −10) and the
quadrature sums to 1e-5 relative.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.targets import PhiFour as TPhiFour
from sde_sampler_lrds_torch.targets import base as tb
from sde_sampler_lrds_tpu.targets import PhiFour
from sde_sampler_lrds_tpu.targets import base as jb


def N(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("dim,n_points", [(1, 50), (2, 400), (2, 81), (3, 1000)])
def test_boole_grid_matches_jax(dim, n_points):
    domain = np.stack([-np.arange(1, dim + 1), 0.5 * np.arange(1, dim + 1)], axis=1)
    jp_, jw = jb.boole_grid(jnp.asarray(domain, jnp.float32), n_points)
    tp_, tw = tb.boole_grid(torch.as_tensor(domain, dtype=torch.float32), n_points)
    np.testing.assert_allclose(N(tp_), np.asarray(jp_), rtol=0, atol=0)
    np.testing.assert_allclose(N(tw), np.asarray(jw), rtol=1e-7, atol=0)
    # the weights integrate the box's volume
    np.testing.assert_allclose(float(tw.sum()), np.prod(domain[:, 1] - domain[:, 0]),
                               rtol=1e-5)


class _JGauss(jb.Target):
    def unnorm_log_prob(self, x):
        return -0.5 * jnp.sum(((x - jnp.asarray([0.3, -0.2])) / jnp.asarray([0.7, 1.1])) ** 2,
                              axis=-1)


class _TGauss(tb.Target):
    def unnorm_log_prob(self, x):
        return -0.5 * torch.sum(((x - torch.tensor([0.3, -0.2])) / torch.tensor([0.7, 1.1])) ** 2,
                                dim=-1)


def test_base_quadrature_matches_jax():
    """log Z, the expectations and the standard deviations of an
    unnormalized 2-d Gaussian by Boole quadrature on [-6, 6]²; both against
    the closed form (log Z = log(2π·0.7·1.1))."""
    j = _JGauss(dim=2, domain=6.0, grid_points=4000)
    t = _TGauss(dim=2, domain=6.0, grid_points=4000, device="cpu")
    j.compute_stats()
    t.compute_stats()
    assert math.isclose(t.log_norm_const, j.log_norm_const, rel_tol=1e-5)
    assert math.isclose(t.log_norm_const, math.log(2 * math.pi * 0.7 * 1.1), rel_tol=1e-4)
    for k, v in j.expectations.items():
        assert math.isclose(t.expectations[k], v, rel_tol=1e-4, abs_tol=1e-5), k
    np.testing.assert_allclose(N(t.stddevs), np.asarray(j.stddevs), rtol=1e-4)
    np.testing.assert_allclose(N(t.stddevs), [0.7, 1.1], rtol=1e-3)


def test_run_gdflow_and_sample_uniform():
    x0 = np.array([[2.0, -1.0], [0.5, 3.0]], np.float32)
    grad = lambda x: 2.0 * x - 1.0
    want = jb.run_gdflow(grad, jnp.asarray(x0), 200, 1e-2)
    got = tb.run_gdflow(grad, torch.as_tensor(x0), 200, 1e-2)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    domain = torch.tensor([[-1.0, 2.0], [3.0, 4.0]])
    u = tb.sample_uniform(torch.Generator().manual_seed(0), domain, 10_000)
    assert u.shape == (10_000, 2)
    assert bool((u >= domain[:, 0]).all() and (u <= domain[:, 1]).all())
    np.testing.assert_allclose(N(u.mean(0)), [0.5, 3.5], atol=0.05)


def test_hessian_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=8).astype(np.float32)
    j = PhiFour(a=0.1, b=0.02, dim=8)
    t = TPhiFour(a=0.1, b=0.02, dim=8, device="cpu")
    np.testing.assert_allclose(N(t.hessian(torch.as_tensor(x))), np.asarray(j.hessian(
        jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    # 2-d lattice (4 × 4): the autograd Hessian of U in both packages
    x2 = rng.normal(size=16).astype(np.float32)
    j2 = PhiFour(a=0.1, b=0.0, dim=4, dim_phys=2)
    t2 = TPhiFour(a=0.1, b=0.0, dim=4, dim_phys=2, device="cpu")
    np.testing.assert_allclose(N(t2.hessian(torch.as_tensor(x2))),
                               np.asarray(j2.hessian(jnp.asarray(x2))), rtol=1e-5, atol=1e-5)
    # the 1-d band is the autograd Hessian of U as well
    auto = torch.autograd.functional.hessian(lambda y: t.U(y[None])[0], torch.as_tensor(x))
    np.testing.assert_allclose(N(t.hessian(torch.as_tensor(x))), N(auto), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,b", [(8, 0.0), (16, 0.02)])
def test_laplace_oracle_matches_jax(dim, b):
    j = PhiFour(a=0.1, b=b, dim=dim)
    t = TPhiFour(a=0.1, b=b, dim=dim, device="cpu")
    j.compute_stats_integration()
    t.compute_stats_integration()
    np.testing.assert_allclose(N(t.x_min), np.asarray(j.x_min), rtol=1e-5, atol=1e-5)
    for x_j, x_t in zip(j.x_min, t.x_min):
        for got, want in zip(t.log_laplace(x_t), j.log_laplace(x_j)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("true_weight", "true_weight_cor", "true_weight_tm", "weight", "weight_rb"):
        assert math.isclose(t.expectations[k], j.expectations[k], rel_tol=1e-4), k
    assert math.isclose(t.log_norm_const, j.log_norm_const, rel_tol=1e-9)
    # the minima are the two wells, mirrored at b = 0
    assert float(t.x_min[0].mean()) > 0.5 and float(t.x_min[1].mean()) < -0.5
    if b == 0.0:
        np.testing.assert_allclose(N(t.x_min[0]), -N(t.x_min[1]), atol=1e-6)
