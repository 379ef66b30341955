"""The port's time grids and SDEs of the other VI samplers held against the
JAX package: ``get_timesteps``' 'quad' and 'cosine' rescalings (DDS's
cosine grid at its solver's 0 → 6.4, dt 0.05), ``ConstOU`` and ``ScaledBM``
(coefficients, integrals, transition kernels, noised marginals and their
scores, PIS's terminal reference), the OU base's generic drift / diff /
divergence, VP's integrals, the Langevin SDEs and the Euler-Maruyama
integrator under the JAX integrator's own draws.

Inputs are drawn with numpy from a seed and handed to both packages; every
comparison is float32 against float32 at rtol = 1e-5 (atol 1e-6) unless
stated where used."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import sde as t_sde
from sde_sampler_lrds_torch.utils.common import get_timesteps as t_get_timesteps
from sde_sampler_lrds_tpu import sde as j_sde
from sde_sampler_lrds_tpu.sde.integrator import integrate_sde, interpolate_traj
from sde_sampler_lrds_tpu.sde.langevin import ControlledLangevinSDE, ControlledSDE
from sde_sampler_lrds_tpu.utils.common import get_timesteps

TOL = dict(rtol=1e-5, atol=1e-6)


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("rescale,start,end,kw", [
    ("quad", 0.0, 1.0, {"steps": 16}), ("quad", 0.1, 5.0, {"steps": 40}),
    ("cosine", 0.0, 6.4, {"dt": 0.05}), ("cosine", 0.0, 3.2, {"steps": 20}),
    (None, 0.0, 5.0, {"steps": 100}),
])
def test_rescaled_grids_match_jax(rescale, start, end, kw):
    """The cosine grid has steps + 2 points (DDS: ceil(6.4 / 0.05) = 128
    increments plus one, K = 129), as in the JAX package; the float32
    cumulative sum of its increments agrees to 1e-6 relative."""
    want = np.asarray(get_timesteps(start, end, rescale_t=rescale, **kw))
    got = N(t_get_timesteps(start, end, rescale_t=rescale, device="cpu", **kw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * end)
    if rescale == "cosine" and "dt" in kw:
        assert got.shape == (130,) and got[0] == 0.0 and abs(got[-1] - 6.4) < 1e-5
    with pytest.raises(ValueError, match="rescaling"):
        t_get_timesteps(0.0, 1.0, steps=4, rescale_t="nope", device="cpu")


def _sdes():
    return [("ConstOU", j_sde.ConstOU(drift_coeff=0.7, diff_coeff=1.3, terminal_t=2.0),
             t_sde.ConstOU(drift_coeff=0.7, diff_coeff=1.3, terminal_t=2.0)),
            ("ScaledBM", j_sde.ScaledBM(diff_coeff=0.8, terminal_t=5.0),
             t_sde.ScaledBM(diff_coeff=0.8, terminal_t=5.0)),
            ("VP", j_sde.VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, scale_diff_coeff=1.7),
             t_sde.VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, scale_diff_coeff=1.7))]


@pytest.mark.parametrize("which", ["ConstOU", "ScaledBM", "VP"])
def test_linear_sde_coefficients_match_jax(which):
    (_, j, t), = [c for c in _sdes() if c[0] == which]
    rng = np.random.default_rng(1)
    s = np.sort(rng.uniform(0.01, 0.9 * j.terminal_t, 9)).astype(np.float32)
    e = (s + rng.uniform(0.01, 0.1, 9)).astype(np.float32)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    pairs = [(t.drift_coeff_t(T(s)), j.drift_coeff_t(s)), (t.diff_coeff_t(T(s)), j.diff_coeff_t(s)),
             (t.int_drift_coeff_t(T(s), T(e)), j.int_drift_coeff_t(s, e)),
             (t.int_diff_coeff_sq_t(T(s), T(e)), j.int_diff_coeff_sq_t(s, e)),
             (t.drift(T(s)[:, None], T(x)), j.drift(s[:, None], x)),
             (t.diff(T(s)), j.diff(s)),
             (t.drift_div(T(s), T(x)), j.drift_div(s, x)),
             (t.drift_div_int(T(s), T(e), T(x)), j.drift_div_int(s, e, x)),
             (t.s(T(s)), j.s(s)), (t.sigma_sq(T(s)), j.sigma_sq(s)),
             *zip(t.transition_params(T(s), T(e)), j.transition_params(s, e))]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(N(got), np.asarray(want), err_msg=str(i), **TOL)


def test_const_ou_keeps_the_exact_sigma_sq():
    """σ²(t) = g²(e^{2kt} − 1)/(2k), the exact integral (the reference's
    formula without 1/(2k) holds only at k = 1)."""
    t = t_sde.ConstOU(drift_coeff=2.0, diff_coeff=1.5)
    want = 1.5**2 * np.expm1(4.0 * 0.3) / 4.0
    np.testing.assert_allclose(float(t.sigma_sq(0.3)), want, rtol=1e-6)
    with pytest.raises(ValueError):
        t_sde.ConstOU(drift_coeff=-1.0)


@pytest.mark.parametrize("which", ["ConstOU", "ScaledBM"])
def test_marginals_and_scores_match_jax(which):
    """Noised marginals of a point (PIS's reference: ScaledBM at T from the
    origin) and of a diagonal Gaussian: log-densities and scores."""
    (_, j, t), = [c for c in _sdes() if c[0] == which]
    rng = np.random.default_rng(2)
    x = rng.normal(scale=2.0, size=(64, 3)).astype(np.float32)
    loc = rng.normal(size=3).astype(np.float32)
    var0 = (0.2 + rng.random(3)).astype(np.float32)
    for tt in (0.3, j.terminal_t):
        jt, tt_ = jnp.asarray(tt, jnp.float32), torch.tensor(tt, dtype=torch.float32)
        np.testing.assert_allclose(N(t.marginal_log_prob(tt_, T(x), T(loc))),
                                   j.marginal_log_prob(jt, x, loc), **TOL)
        np.testing.assert_allclose(N(t.marginal_score(tt_, T(x), T(loc))),
                                   j.marginal_score(jt, x, loc), **TOL)
        np.testing.assert_allclose(
            N(t.marginal_log_prob(tt_, T(x), T(loc), var_init=T(var0))),
            j.marginal_log_prob(jt, x, loc, var_init=var0), **TOL)
        np.testing.assert_allclose(
            N(t.marginal_score(tt_, T(x), T(loc), var_init=T(var0))),
            j.marginal_score(jt, x, loc, var_init=var0), **TOL)


def test_langevin_sdes_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    mu = rng.normal(size=3).astype(np.float32)
    j_score, t_score = (lambda y: -(y - mu)), (lambda y: -(y - T(mu)))
    j_prior, t_prior = (lambda y: -y / 4.0), (lambda y: -y / 4.0)
    pairs = [(j_sde.LangevinSDE(j_score, diff_coeff=1.3, clip_score=0.5),
              t_sde.LangevinSDE(t_score, diff_coeff=1.3, clip_score=0.5)),
             (ControlledLangevinSDE(j_score, j_prior, diff_coeff=0.9, terminal_t=2.0,
                                    clip_score=1e5),
              t_sde.ControlledLangevinSDE(t_score, t_prior, diff_coeff=0.9, terminal_t=2.0,
                                          clip_score=1e5))]
    for j, t in pairs:
        for tt in (0.0, 0.7, 2.0):
            np.testing.assert_allclose(N(t.drift(torch.tensor(tt), T(x))),
                                       j.drift(jnp.float32(tt), x), **TOL)
        assert float(t.diff(0.3)) == float(j.diff(0.3))
    vp_j, vp_t = j_sde.VP(diff_coeff_sq_max=10.0), t_sde.VP(diff_coeff_sq_max=10.0)
    ctrl = lambda t, y: 0.3 * y + t
    j, t = ControlledSDE(vp_j, ctrl), t_sde.ControlledSDE(vp_t, ctrl)
    np.testing.assert_allclose(N(t.drift(torch.tensor(0.4), T(x))),
                               j.drift(jnp.float32(0.4), x), **TOL)
    np.testing.assert_allclose(N(t.diff(torch.tensor(0.4))), j.diff(jnp.float32(0.4)), **TOL)


def test_integrate_sde_matches_jax_under_its_draws():
    """Euler-Maruyama over 12 steps of the VP SDE from fed states, with the
    JAX integrator's per-step normals fed to the port; and the port's
    interpolation and Brownian increments."""
    vp_j, vp_t = j_sde.VP(diff_coeff_sq_max=10.0), t_sde.VP(diff_coeff_sq_max=10.0)
    ts = np.linspace(0.0, 1.0, 13).astype(np.float32)
    x0 = np.random.default_rng(4).normal(size=(32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(integrate_sde(vp_j, key, jnp.asarray(ts), jnp.asarray(x0)))
    zs, k = [], key
    for _ in range(12):
        k, sub = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(sub, (32, 3))))
    got = t_sde.integrate_sde(vp_t, None, T(ts), T(x0), noise=T(np.stack(zs)))
    np.testing.assert_allclose(N(got), want, rtol=1e-5, atol=1e-5)
    last = t_sde.integrate_sde(vp_t, None, T(ts), T(x0), return_traj=False,
                               noise=T(np.stack(zs)))
    np.testing.assert_allclose(N(last), want[-1], rtol=1e-5, atol=1e-5)
    out_ts = np.array([0.0, 0.05, 0.5, 0.99, 1.0], np.float32)
    np.testing.assert_allclose(N(t_sde.interpolate_traj(got, T(ts), T(out_ts))),
                               interpolate_traj(jnp.asarray(want), jnp.asarray(ts),
                                                jnp.asarray(out_ts)), rtol=1e-5, atol=1e-5)
    inc = t_sde.make_brownian_increments(torch.Generator().manual_seed(0), T(ts), (20000,))
    var = N(inc).var(axis=1)
    np.testing.assert_allclose(var, np.diff(ts), rtol=0.05)
