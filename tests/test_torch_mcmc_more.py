"""The port's RWMH and preconditioned MCMC kernels held against the JAX
package: ``rwmh_step``, ``precond_mala_step`` and ``precond_ula_step`` under
the draws the JAX kernels make from their keys (rebuilt from those keys and
fed to the port), ``VP.ei_integration_step`` (PDDS's reverse-kernel move)
under fed noise, and RWMH chains (``run_chain`` and ``mcmc_sample``)
statistically.

Inputs are drawn with numpy from a seed and handed to both packages; each
tolerance is stated with its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.mcmc import MCMCState as TState
from sde_sampler_lrds_torch.mcmc import precond_mala_step as t_precond_mala_step
from sde_sampler_lrds_torch.mcmc import precond_ula_step as t_precond_ula_step
from sde_sampler_lrds_torch.mcmc import run_chain as t_run_chain
from sde_sampler_lrds_torch.mcmc import rwmh_step as t_rwmh_step
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_torch.targets import TwoModes as TTwoModes
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu.mcmc import MCMCState, precond_mala_step, precond_ula_step, rwmh_step
from sde_sampler_lrds_tpu.mcmc.kernels import run_chain
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets import ManyModes

# one float32 step from the same inputs and draws: the two packages sum the
# (D, D) products and the log-density terms in other orders
RTOL, ATOL = 1e-5, 1e-5


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _targets(dim=3):
    return (ManyModes(n_modes=3, dim=dim, var=0.3),
            TManyModes(n_modes=3, dim=dim, var=0.3, device="cpu"))


def _precond(dim, seed):
    """A symmetric positive-definite M and its Cholesky factor C (C Cᵀ = M)."""
    a = np.random.default_rng(seed).normal(size=(dim, dim)).astype(np.float32)
    m = (a @ a.T / dim + 0.3 * np.eye(dim)).astype(np.float32)
    return m, np.linalg.cholesky(m).astype(np.float32)


def _close_state(got, want, fields=("x", "log_prob", "grad", "step_size")):
    for f in fields:
        np.testing.assert_allclose(N(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_rwmh_step_matches_jax_under_its_draws():
    j_target, t_target = _targets()
    x = (2 * np.random.default_rng(0).normal(size=(64, 3))).astype(np.float32)
    j_state = MCMCState.init(jnp.asarray(x), j_target.log_prob_and_score, 0.5)
    # a stale score, as RWMH leaves it: it must stay as it was
    t_state = TState.init(T(x), t_target.log_prob_and_score, 0.5)
    key = jax.random.PRNGKey(3)
    k_prop, k_acc = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_prop, x.shape))
    uniforms = np.asarray(jax.random.uniform(k_acc, (64,)))
    want, want_acc = rwmh_step(key, j_state, j_target.unnorm_log_prob)
    got, got_acc = t_rwmh_step(None, t_state, t_target.unnorm_log_prob, noise=T(noise),
                               uniforms=T(uniforms))
    np.testing.assert_allclose(N(got_acc), np.asarray(want_acc), rtol=RTOL, atol=ATOL)
    _close_state(got, want)
    accepted = N(got.x != t_state.x).any(-1)
    assert 0 < accepted.sum() < 64
    assert torch.equal(got.grad, t_state.grad)


@pytest.mark.parametrize("per_chain", [False, True])
def test_precond_mala_step_matches_jax_under_its_draws(per_chain):
    """Prop-1's ratio of arXiv:2305.14442, with one (D, D) preconditioner or
    one a chain."""
    dim, b = 3, 64
    j_target, t_target = _targets(dim)
    x = (2 * np.random.default_rng(1).normal(size=(b, dim))).astype(np.float32)
    m, c = _precond(dim, 2)
    if per_chain:
        scales = (0.5 + np.random.default_rng(3).random(b)).astype(np.float32)
        m = (m[None] * scales[:, None, None]).astype(np.float32)
        c = (c[None] * np.sqrt(scales)[:, None, None]).astype(np.float32)
    j_state = MCMCState.init(jnp.asarray(x), j_target.log_prob_and_score, 0.05,
                             precond_matrix=jnp.asarray(m))
    t_state = TState.init(T(x), t_target.log_prob_and_score, 0.05, precond_matrix=T(m))
    np.testing.assert_allclose(N(t_state.precond_grad), np.asarray(j_state.precond_grad),
                               rtol=RTOL, atol=ATOL)
    key = jax.random.PRNGKey(4)
    k_prop, k_acc = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_prop, x.shape))
    uniforms = np.asarray(jax.random.uniform(k_acc, (b,)))
    want, want_acc = precond_mala_step(key, j_state, j_target.log_prob_and_score,
                                       jnp.asarray(m), jnp.asarray(c))
    got, got_acc = t_precond_mala_step(None, t_state, t_target.log_prob_and_score, T(m), T(c),
                                       noise=T(noise), uniforms=T(uniforms))
    # the log-ratio sums terms of ~1e2 that cancel: 1e-4 absolute
    np.testing.assert_allclose(N(got_acc), np.asarray(want_acc), rtol=1e-5, atol=1e-4)
    _close_state(got, want, ("x", "log_prob", "grad", "step_size", "precond_grad"))
    assert 0 < N(got.x != t_state.x).any(-1).sum() < b


def test_precond_mala_ratio_is_the_gaussian_proposal_ratio_without_inverse():
    """Prop-1's form of the ratio (arXiv:2305.14442) is the Gaussian
    proposal's log q(x|y) − log q(y|x) for N(x + ss·M∇, 2ss·M) rewritten
    with no M⁻¹: the two agree up to float32 rounding (the inverse's, on
    log-ratios up to ~4e2), and with M = I both are MALA's."""
    dim, b, ss = 2, 16, 0.3
    _, t_target = _targets(dim)
    x = T((2 * np.random.default_rng(5).normal(size=(b, dim))).astype(np.float32))
    m, c = (T(a) for a in _precond(dim, 6))
    noise = torch.randn(b, dim, generator=torch.Generator().manual_seed(0))
    u = torch.full((b,), 0.5)
    state = TState.init(x, t_target.log_prob_and_score, ss, precond_matrix=m)
    new, log_acc = t_precond_mala_step(None, state, t_target.log_prob_and_score, m, c,
                                       noise=noise, uniforms=u)
    y = state.x + ss * state.precond_grad + (2 * ss) ** 0.5 * noise @ c.T
    lp_y, g_y = t_target.log_prob_and_score(y)
    m_inv = torch.linalg.inv(m)

    def log_q(to, frm, g_frm):
        d = to - frm - ss * g_frm @ m.T
        return -torch.einsum("bi,ij,bj->b", d, m_inv, d) / (4 * ss)

    gauss = lp_y - state.log_prob + log_q(x, y, g_y) - log_q(y, x, state.grad)
    torch.testing.assert_close(log_acc, gauss, rtol=1e-5, atol=1e-3)
    mala_state = TState.init(x, t_target.log_prob_and_score, ss, precond_matrix=torch.eye(dim))
    eye = torch.eye(dim)
    _, acc_eye = t_precond_mala_step(None, mala_state, t_target.log_prob_and_score, eye, eye,
                                     noise=noise, uniforms=u)
    from sde_sampler_lrds_torch.mcmc import mala_step
    _, acc_mala = mala_step(None, mala_state, t_target.log_prob_and_score, noise=noise,
                            uniforms=u)
    torch.testing.assert_close(acc_eye, acc_mala, rtol=1e-4, atol=1e-4)


def test_precond_ula_step_matches_jax_under_its_draws():
    dim, b = 3, 32
    j_target, t_target = _targets(dim)
    x = np.random.default_rng(7).normal(size=(b, dim)).astype(np.float32)
    m, c = _precond(dim, 8)
    j_state = MCMCState.init(jnp.asarray(x), j_target.log_prob_and_score, 0.02,
                             precond_matrix=jnp.asarray(m))
    t_state = TState.init(T(x), t_target.log_prob_and_score, 0.02, precond_matrix=T(m))
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, x.shape))
    want = precond_ula_step(key, j_state, j_target.log_prob_and_score, jnp.asarray(m),
                            jnp.asarray(c))
    got = t_precond_ula_step(None, t_state, t_target.log_prob_and_score, T(m), T(c),
                             noise=T(noise))
    _close_state(got, want, ("x", "log_prob", "grad", "precond_grad"))


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_vp_ei_integration_step_matches_jax(scale):
    j_sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, scale_diff_coeff=scale)
    t_sde = TVP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, scale_diff_coeff=scale)
    rng = np.random.default_rng(10)
    x, score, z = (rng.normal(size=(32, 4)).astype(np.float32) for _ in range(3))
    for t_k, t_k1 in ((0.0, 0.1), (0.37, 0.52), (0.9, 0.999)):
        want = j_sde.ei_integration_step(jnp.asarray(x), t_k, t_k1, jnp.asarray(score),
                                         jnp.asarray(z))
        got = t_sde.ei_integration_step(T(x), torch.tensor(t_k), torch.tensor(t_k1),
                                        T(score), T(z))
        # the same float32 closed form (expm1, sqrt) in the same order
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        N(t_sde.transition_params(torch.tensor(0.3), torch.tensor(0.6))[1]),
        np.asarray(j_sde.transition_params(0.3, 0.6)[1]), rtol=RTOL)


def _moments_close(a, b, n_eff, what):
    """Means and standard deviations of two chains' pooled draws within 5
    standard errors of a difference, at ``n_eff`` effective draws a side."""
    sd = b.std(0)
    tol = 5 * np.sqrt(2.0 / n_eff) * sd
    assert np.all(np.abs(a.mean(0) - b.mean(0)) <= tol), (what, a.mean(0), b.mean(0), tol)
    assert np.all(np.abs(a.std(0) - sd) <= tol), (what, a.std(0), sd, tol)


def test_rwmh_run_chain_matches_jax_statistically():
    """RWMH on a correlated Gaussian mixture component (one mode of
    ManyModes at var 0.3), 256 chains × 200 steps after 200 warm-up steps,
    step sizes adapted toward acceptance 0.75 in both."""
    j_target, t_target = _targets(2)
    x0 = np.repeat(np.asarray(j_target.loc)[:1], 256, axis=0)
    lpg_j, lpg_t = j_target.log_prob_and_score, t_target.log_prob_and_score
    j_state = MCMCState.init(jnp.asarray(x0), lpg_j, 0.1)
    j_state, _ = run_chain(jax.random.PRNGKey(0), j_state, lpg_j, 200, kernel="rwmh",
                           collect=False)
    j_state, j_xs = run_chain(jax.random.PRNGKey(1), j_state, lpg_j, 200, kernel="rwmh")
    g = torch.Generator().manual_seed(0)
    t_state = TState.init(T(x0), lpg_t, 0.1)
    t_state, _ = t_run_chain(g, t_state, lpg_t, 200, kernel="rwmh", collect=False)
    t_state, t_xs = t_run_chain(g, t_state, lpg_t, 200, kernel="rwmh")
    assert t_xs.shape == j_xs.shape == (200, 256, 2)
    # the adapted step sizes settle at the same scale (within 30 %: each
    # chain's step size random-walks by 1 % a step around its fixed point)
    ratio = float(N(t_state.step_size).mean() / np.asarray(j_state.step_size).mean())
    assert 0.7 < ratio < 1.3, ratio
    # RWMH draws 200 steps apart are nearly independent; count 4 draws a chain
    _moments_close(N(t_xs).reshape(-1, 2), np.asarray(j_xs).reshape(-1, 2), 4 * 256, "rwmh")


def test_mcmc_sample_rwmh_matches_jax_statistically():
    """``mcmc_sample(mcmc_type='rwmh')`` (any value but 'mala' is RWMH, as
    in the JAX package) on TwoModes d 2: pooled dataset moments of both
    packages, each mode holding points."""
    from sde_sampler_lrds_tpu.targets import TwoModes

    j_target = TwoModes(dim=2, n_reference_samples=1000)
    t_target = TTwoModes(dim=2, n_reference_samples=1000, device="cpu")
    kw = dict(mcmc_type="rwmh", step_size=0.3, dataset_length=8000, n_warmup_steps=256)
    j_data = np.asarray(j_api.mcmc_sample(jax.random.PRNGKey(0), j_target, j_target.loc, **kw))
    t_data = N(t_api.mcmc_sample(torch.Generator().manual_seed(0), t_target, t_target.loc,
                                 device="cpu", **{**kw, "mcmc_type": "random_walk"}))
    assert t_data.shape == j_data.shape == (8000, 2)
    # chains seeded at both modes: both hold points
    for data in (j_data, t_data):
        assert np.all(N(t_target.compute_mode_count(T(data))) > 0)
    # each mode's points: 4 chains of 1000 correlated steps, counted as 200
    # effective draws a chain
    for c in np.asarray(j_target.loc):
        near = lambda d: d[np.linalg.norm(d - c, axis=1) < 2.0]  # noqa: E731
        _moments_close(near(t_data), near(j_data), 4 * 200, f"mode {c}")
