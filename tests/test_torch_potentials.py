"""The port's EBM potentials held against the JAX package's on the CPU:
GMMTiltedPotential with every variance form (diagonal, full, eigen-factored
(eig, P)) and tilt ('dot', 'sq_norm', 'sum'), with and without t_limit and
the s(t) scaling, with a scalar and a per-row scaling factor; its score
(written out by hand) against autograd; the noised-prior draws under the
JAX sampler's own draws; GaussTiltedPotential, BetterPotentialCtrl,
DRLWrapper, EBMAnatomyTrick and WrapperDistrNN.

Inputs are drawn with numpy from a seed; the JAX parameters are loaded into
the port's modules. Tolerance: float32 with other summation orders (the MLP
layers, the eigenbasis rotation where JAX solves a Cholesky system for the
full covariances), relative and absolute 1e-4 on log-probs and scores of
size up to ~50.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.models import FourierMLP as TFourierMLP
from sde_sampler_lrds_torch.models import potentials as tp
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets.base import WrapperDistrNN as TWrapperDistrNN
from sde_sampler_lrds_tpu.models import FourierMLP
from sde_sampler_lrds_tpu.models import potentials as jp
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets.base import WrapperDistrNN

TOL = dict(rtol=1e-4, atol=1e-4)
D, K, H, B = 3, 2, 16, 7


def N(t):
    return t.detach().cpu().numpy()


def T(a):
    return torch.as_tensor(np.array(a))


def _mixture(form: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.3, 1.0, K).astype(np.float32)
    m = rng.normal(size=(K, D)).astype(np.float32)
    if form == "diag":
        return w, m, rng.uniform(0.2, 1.0, (K, D)).astype(np.float32)
    a = rng.normal(size=(K, D, D))
    cov = (a @ a.transpose(0, 2, 1) / D + 0.3 * np.eye(D)).astype(np.float32)
    if form == "full":
        return w, m, cov
    eig, p = np.linalg.eigh(cov.astype(np.float64))
    return w, m, (eig.astype(np.float32), p.astype(np.float32))


def _pair(form: str, tilt: str, t_limit: float = 0.0, s_t: bool = False):
    """The same potential in both packages, the JAX parameters (a random,
    not zero-init, energy net) loaded into the port's."""
    w, m, v = _mixture(form)
    jv = tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v)
    sde_kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    j_pot = jp.GMMTiltedPotential(
        base_model=FourierMLP(dim=D, channels=H, num_layers=3), sde=VP(**sde_kw),
        weights=jnp.asarray(w), means=jnp.asarray(m), variances=jv, t_limit=t_limit,
        use_s_t_scaling=s_t, tilt_type=tilt)
    params = j_pot.init(jax.random.PRNGKey(1), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_pot = tp.GMMTiltedPotential(
        TFourierMLP(dim=D, channels=H, num_layers=3), TVP(**sde_kw), w, m, v,
        t_limit=t_limit, use_s_t_scaling=s_t, tilt_type=tilt)
    t_pot.load_flax_params(jax.tree.map(np.asarray, params))
    return j_pot, params, t_pot


def _inputs(seed: int = 2):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.normal(size=(B, D))).astype(np.float32)
    t = rng.uniform(0.0, 1.0, B).astype(np.float32)
    sf = rng.uniform(0.5, 1.5, (B, 1)).astype(np.float32)
    return x, t, sf


@pytest.mark.parametrize("tilt", ["dot", "sq_norm", "sum"])
@pytest.mark.parametrize("form", ["diag", "full", "eig"])
def test_gmm_tilted_potential_matches_jax(form, tilt):
    x, t, sf = _inputs()
    for t_limit, s_t, scaling in ((0.0, False, 1.0), (0.3, True, 0.8), (0.3, False, sf)):
        j_pot, params, t_pot = _pair(form, tilt, t_limit, s_t)
        j_sf = jnp.asarray(scaling) if isinstance(scaling, np.ndarray) else scaling
        t_sf = T(scaling) if isinstance(scaling, np.ndarray) else scaling
        jx, jt = jnp.asarray(x), jnp.asarray(t)
        tx, tt = T(x), T(t)
        for method in ("energy", "unnorm_log_prob", "prior_log_prob", "scaling_input"):
            want = j_pot.apply(params, jt, jx, method=method, scaling_factor=j_sf)
            got = getattr(t_pot, method)(tt, tx, scaling_factor=t_sf)
            np.testing.assert_allclose(N(got), np.asarray(want), **TOL, err_msg=method)
        j_lp, j_g = j_pot.apply(params, jt, jx, method="unnorm_log_prob_and_grad",
                                scaling_factor=j_sf)
        t_lp, t_g = t_pot.unnorm_log_prob_and_grad(tt, tx, scaling_factor=t_sf)
        np.testing.assert_allclose(N(t_lp), np.asarray(j_lp), **TOL)
        np.testing.assert_allclose(N(t_g), np.asarray(j_g), **TOL)
        np.testing.assert_allclose(N(t_pot(tt, tx, scaling_factor=t_sf)), np.asarray(j_g), **TOL)
        _, j_pg = j_pot.apply(params, jt, jx, method="prior_log_prob_and_grad",
                              scaling_factor=j_sf)
        np.testing.assert_allclose(N(t_pot.prior_log_prob_and_grad(tt, tx, t_sf)[1]),
                                   np.asarray(j_pg), **TOL)


@pytest.mark.parametrize("tilt", ["dot", "sq_norm", "sum"])
@pytest.mark.parametrize("form", ["diag", "full", "eig"])
def test_score_by_hand_matches_autograd(form, tilt):
    """The hand-written −∇ₓE against torch.autograd.grad of the port's own
    log-density (float32: 1e-5 absolute on scores of size ~10)."""
    _, _, t_pot = _pair(form, tilt, 0.2, True)
    x, t, sf = _inputs(3)
    for scaling in (1.0, T(sf)):
        y = T(x).requires_grad_(True)
        (want,) = torch.autograd.grad(t_pot.unnorm_log_prob(T(t), y, scaling).sum(), y)
        lp, got = t_pot.unnorm_log_prob_and_grad(T(t), T(x), scaling)
        np.testing.assert_allclose(N(got), N(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(N(lp), N(t_pot.unnorm_log_prob(T(t), T(x), scaling)),
                                   rtol=0, atol=0)


def test_zero_init_potential_is_the_noised_gmm():
    """With the zero-init energy net the score and log-prob are the exact
    noised mixture's at every level (the construction's point)."""
    w, m, v = _mixture("diag")
    t_pot = tp.GMMTiltedPotential(TFourierMLP(dim=D, channels=H, zero_init=True),
                                  TVP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0), w, m, v)
    x = T(_inputs()[0])
    for t in (0.05, 0.4, 0.9):
        tv = torch.full((B,), t)
        want = t_pot.sde.marginal_gmm_score(torch.tensor(t), x, T(m), T(v), T(w))
        np.testing.assert_allclose(N(t_pot(tv, x)), N(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", ["diag", "full", "eig"])
def test_sample_prior_matches_jax_under_its_draws(form):
    """The noised-mixture draws with the JAX sampler's own component
    indices and normals fed (its key split three ways)."""
    j_pot, params, t_pot = _pair(form, "dot", t_limit=0.1)
    n = 64
    ts = np.random.default_rng(4).uniform(0.0, 1.0, n).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = j_pot.apply(params, key, jnp.asarray(ts), method="sample_prior")
    k1, k2, k3 = jax.random.split(key, 3)
    w = jnp.asarray(N(t_pot.weights))
    idx = jax.random.categorical(k1, jnp.log(w / w.sum()), shape=(n,))
    eps = jax.random.normal(k2, (n, D))
    z = jax.random.normal(k3, (n, D))
    got = t_pot.sample_prior(None, T(ts), draws=(T(idx).long(), T(eps), T(z)))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the port's own draws: shape, and the mean of the t ≈ 0 mixture
    many = t_pot.sample_prior(torch.Generator().manual_seed(0), torch.full((20_000,), 1e-3))
    wn = N(t_pot.weights) / N(t_pot.weights).sum()
    np.testing.assert_allclose(N(many.mean(0)), wn @ N(t_pot.means), atol=0.05)


def test_gauss_tilted_from_gaussian_matches_jax():
    rng = np.random.default_rng(6)
    mean = rng.normal(size=D).astype(np.float32)
    a = rng.normal(size=(D, D))
    eig, p = np.linalg.eigh(a @ a.T / D + 0.5 * np.eye(D))
    eig, p = eig.astype(np.float32), p.astype(np.float32)
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    j_pot = jp.GaussTiltedPotential.from_gaussian(
        FourierMLP(dim=D, channels=H, num_layers=3), VP(**kw), jnp.asarray(mean),
        (jnp.asarray(eig), jnp.asarray(p)), tilt_type="sq_norm")
    params = j_pot.init(jax.random.PRNGKey(7), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_pot = tp.GaussTiltedPotential.from_gaussian(
        TFourierMLP(dim=D, channels=H, num_layers=3), TVP(**kw), mean, (eig, p),
        tilt_type="sq_norm").load_flax_params(jax.tree.map(np.asarray, params))
    x, t, _ = _inputs(8)
    want = j_pot.apply(params, jnp.asarray(t), jnp.asarray(x), method="unnorm_log_prob_and_grad")
    got = t_pot.unnorm_log_prob_and_grad(T(t), T(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("energy_type,gaussian", [("dot", True), ("sq_norm", True),
                                                  ("residual_sq_norm", True),
                                                  ("residual_sq_norm", False), ("sum", False)])
def test_better_potential_ctrl_matches_jax(energy_type, gaussian):
    rng = np.random.default_rng(9)
    mean = rng.normal(size=D).astype(np.float32)
    var = np.float32(0.7)
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    j_pot = jp.BetterPotentialCtrl(base_model=FourierMLP(dim=D, channels=H, num_layers=3),
                                   sde=VP(**kw), data_mean=jnp.asarray(mean),
                                   data_scalar_var=jnp.asarray(var), energy_type=energy_type,
                                   use_gaussian_prior=gaussian, clip_model=5.0)
    params = j_pot.init(jax.random.PRNGKey(10), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_pot = tp.BetterPotentialCtrl(TFourierMLP(dim=D, channels=H, num_layers=3), TVP(**kw),
                                   mean, var, energy_type=energy_type,
                                   use_gaussian_prior=gaussian, clip_model=5.0)
    t_pot.load_flax_params(jax.tree.map(np.asarray, params))
    x, t, _ = _inputs(11)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    np.testing.assert_allclose(N(t_pot.energy(T(t), T(x))),
                               np.asarray(j_pot.apply(params, jt, jx, method="energy")), **TOL)
    np.testing.assert_allclose(N(t_pot(T(t), T(x))), np.asarray(j_pot.apply(params, jt, jx)),
                               **TOL)


def test_drl_wrapper_and_anatomy_trick_match_jax():
    j_base, params, t_base = _pair("diag", "dot")
    x, t, sf = _inputs(12)
    jx, jt, jsf = jnp.asarray(x), jnp.asarray(t), jnp.asarray(sf)
    times = np.linspace(0.0, 1.0, 6).astype(np.float32)
    steps = np.linspace(0.1, 0.6, 6).astype(np.float32)
    for j_mod, t_mod in (
            (jp.DRLWrapper(net=j_base), tp.DRLWrapper(t_base)),
            (jp.EBMAnatomyTrick(net=j_base, times=jnp.asarray(times),
                                step_sizes=jnp.asarray(steps)),
             tp.EBMAnatomyTrick(t_base, times, steps))):
        wrapped = {"params": {"net": params["params"]}}
        t_mod.load_flax_params(jax.tree.map(np.asarray, wrapped))
        for scaling, tsc in ((1.0, 1.0), (jsf, T(sf))):
            for method in ("energy", "unnorm_log_prob"):
                want = j_mod.apply(wrapped, jt, jx, method=method, scaling_factor=scaling)
                got = getattr(t_mod, method)(T(t), T(x), scaling_factor=tsc)
                np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
            want = j_mod.apply(wrapped, jt, jx, method="unnorm_log_prob_and_grad",
                               scaling_factor=scaling)
            got = t_mod.unnorm_log_prob_and_grad(T(t), T(x), scaling_factor=tsc)
            for g, w in zip(got, want):
                np.testing.assert_allclose(N(g), np.asarray(w), **TOL)
            np.testing.assert_allclose(
                N(t_mod(T(t), T(x), scaling_factor=tsc)),
                np.asarray(j_mod.apply(wrapped, jt, jx, scaling_factor=scaling)), **TOL)


def test_wrapper_distr_nn_matches_jax():
    j_pot, params, t_pot = _pair("eig", "dot")
    x = _inputs(13)[0]
    j_w = WrapperDistrNN(dim=D, unnorm_log_prob_t=lambda t, y: j_pot.apply(
        params, t, y, method="unnorm_log_prob"), t=1e-4)
    t_w = TWrapperDistrNN(dim=D, unnorm_log_prob_t=t_pot.unnorm_log_prob, t=1e-4, device="cpu")
    np.testing.assert_allclose(N(t_w.unnorm_log_prob(T(x))),
                               np.asarray(j_w.unnorm_log_prob(jnp.asarray(x))), **TOL)
    assert t_w.log_norm_const == 0.0
    np.testing.assert_allclose(N(t_w.score(T(x))), np.asarray(j_w.score(jnp.asarray(x))), **TOL)
