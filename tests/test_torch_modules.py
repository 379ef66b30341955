"""The PyTorch port's modules held against the JAX package, one by one.

Inputs are drawn with numpy from a seed and handed to both packages; random
draws that the JAX code makes internally are rebuilt from its key and fed to
the port. Everything runs in float32 on the CPU. Tolerances are stated at
each comparison with their reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.losses import compute_results as t_compute_results
from sde_sampler_lrds_torch.mcmc import MCMCState as TState
from sde_sampler_lrds_torch.mcmc import mala_step as t_mala_step
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_torch.utils.common import resolve_device
from sde_sampler_lrds_torch.utils.gmm_fit import fit_gmm_em as t_fit_gmm_em
from sde_sampler_lrds_tpu.losses import compute_results
from sde_sampler_lrds_tpu.mcmc import MCMCState, mala_step
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl
from sde_sampler_lrds_tpu.targets import ManyModes
from sde_sampler_lrds_tpu.utils.gmm_fit import fit_gmm_em

CPU = "cpu"
# float32 schedule/transcendental arithmetic done by two libraries: XLA and
# torch evaluate exp/expm1/tanh/sqrt with different polynomial kernels, a few
# ulps apart
RTOL_F32 = 2e-5


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def test_resolve_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("steps", [12, 100])
def test_get_timesteps_uniform(steps):
    ts_j = np.asarray(get_timesteps(0.0, 1.0, steps=steps))
    ts_t = N(t_get_timesteps(0.0, 1.0, steps=steps, device=CPU))
    assert ts_t.dtype == np.float32 and ts_t.shape == ts_j.shape
    # the two linspace implementations round differently: at most 1 ulp
    np.testing.assert_allclose(ts_t, ts_j, rtol=0, atol=1.2e-7)


def test_vp_schedule():
    sde_j, sde_t = VP(0.1, 10.0), TVP(0.1, 10.0)
    ts = np.linspace(0.0, 1.0, 13).astype(np.float32)
    s, t = ts[:-1], ts[1:]
    tt = T(ts)
    np.testing.assert_allclose(N(sde_t.s(tt)), sde_j.s(ts), rtol=RTOL_F32)
    np.testing.assert_allclose(N(sde_t.sigma_sq(tt)), sde_j.sigma_sq(ts), rtol=RTOL_F32,
                               atol=1e-7)
    np.testing.assert_allclose(N(sde_t.alpha_(tt)), sde_j.alpha_(ts), rtol=RTOL_F32)
    np.testing.assert_allclose(N(sde_t.omega(T(s), T(t))), sde_j.omega(s, t), rtol=RTOL_F32)
    for name in ("ei_step_coeffs", "ddpm_step_coeffs"):
        got = getattr(sde_t, name)(T(s), T(t))
        want = getattr(sde_j, name)(s, t)
        for g, w in zip(got, want):
            np.testing.assert_allclose(N(g), w, rtol=RTOL_F32, err_msg=name)
    for g, w in zip(sde_t.transition_params(T(s), T(t)), sde_j.transition_params(s, t)):
        np.testing.assert_allclose(N(g), w, rtol=RTOL_F32)


def test_many_modes():
    tgt_j = ManyModes(n_modes=4, dim=3, var=0.5)
    tgt_t = TManyModes(n_modes=4, dim=3, var=0.5, device=CPU)
    # the location draw is numpy's own: bit-identical
    np.testing.assert_array_equal(N(tgt_t.loc), np.asarray(tgt_j.loc))
    np.testing.assert_array_equal(N(tgt_t._probs), np.asarray(tgt_j._probs))
    x = np.random.default_rng(0).normal(scale=3.0, size=(64, 3)).astype(np.float32)
    # log-sum-exp and softmax over 4 components in float32
    np.testing.assert_allclose(N(tgt_t.unnorm_log_prob(T(x))), tgt_j.unnorm_log_prob(x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(tgt_t.score(T(x))), tgt_j.score(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(N(tgt_t.compute_mode_count(T(x))),
                                  np.asarray(tgt_j.compute_mode_count(x)))


def _gmm_ref_params(c=3, d=3, seed=1):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(c, d)).astype(np.float32)
    variances = (0.5 + rng.random((c, d))).astype(np.float32)
    weights = (0.5 + rng.random(c)).astype(np.float32)
    return means, variances, weights


def test_gmm_reference_tables_and_log_prob():
    means, variances, weights = _gmm_ref_params()
    sde_j, sde_t = VP(0.1, 10.0), TVP(0.1, 10.0)
    ref_j = GMMReferenceCtrl(sde_j, jnp.asarray(means), jnp.asarray(variances),
                             jnp.asarray(weights))
    ref_t = TGMMRef(sde_t, T(means), T(variances), T(weights))
    t_grid = np.linspace(1.0, 1.0 / 12, 12).astype(np.float32)
    tab_j = ref_j.precompute(jnp.asarray(t_grid))
    tab_t = ref_t.precompute(T(t_grid))
    for g, w in zip(tab_t, tab_j):
        np.testing.assert_allclose(N(g), np.broadcast_to(w, g.shape), rtol=RTOL_F32)
    x = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)
    k = 5
    step_j = tuple(a[k] for a in tab_j)
    step_t = tuple(a[k] for a in tab_t)
    # softmax-weighted mixture score in float32
    np.testing.assert_allclose(N(TGMMRef.apply(step_t, T(x))),
                               GMMReferenceCtrl.apply(step_j, jnp.asarray(x)),
                               rtol=1e-5, atol=1e-5)
    for t in (0.0, 0.4):
        np.testing.assert_allclose(
            N(sde_t.marginal_gmm_log_prob(torch.tensor(t), T(x), T(means), T(variances),
                                          T(weights))),
            sde_j.marginal_gmm_log_prob(jnp.asarray(t), x, means, variances, weights),
            rtol=1e-5, atol=1e-5)


def _flax_ctrl(dim=3, channels=16, num_layers=3, seed=0):
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=dim, channels=channels,
                                             num_layers=num_layers), clip_model=0.5)
    params = ctrl.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, dim)))
    params = jax.tree.map(np.asarray, params)
    t_ctrl = TClipped(TFourier(dim=dim, channels=channels, num_layers=num_layers),
                      clip_model=0.5)
    load_flax_params(t_ctrl, params)
    return ctrl, params, t_ctrl


def test_fourier_mlp_forward_with_flax_weights():
    ctrl, params, t_ctrl = _flax_ctrl()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    t = rng.random(16).astype(np.float32)
    # a 3-layer float32 MLP; the time features' frequencies come from two
    # linspace implementations that differ by ≤1 ulp (≤7.6e-6 at 100), which
    # moves the angles and so the outputs by a few 1e-6
    tol = dict(rtol=1e-5, atol=5e-6)
    with torch.no_grad():
        # per-row times
        np.testing.assert_allclose(N(t_ctrl(T(t), T(x))), ctrl.apply(params, t, x), **tol)
        # batch-1 time branch
        np.testing.assert_allclose(N(t_ctrl(torch.tensor(0.3), T(x))),
                                   ctrl.apply(params, jnp.asarray(0.3), x), **tol)
        # flat states (K, B, D) with per-step times, as flat_ctrl_eval calls it
        xs = rng.normal(size=(4, 5, 3)).astype(np.float32)
        tk = rng.random(4).astype(np.float32)
        want = jax.vmap(lambda tt, xx: ctrl.apply(params, tt, xx))(tk, xs)
        np.testing.assert_allclose(N(t_ctrl(T(tk)[:, None], T(xs))), want, **tol)
    with pytest.raises(ValueError):
        t_ctrl(torch.zeros(3), torch.zeros(5, 3))


def test_compute_results():
    rnd = np.random.default_rng(4).normal(scale=2.0, size=256).astype(np.float32)
    rnd[7] = 1e9  # filtered by max_rnd
    r_j = compute_results(jnp.asarray(rnd), compute_weights=True, max_rnd=1e8)
    r_t = t_compute_results(T(rnd), compute_weights=True, max_rnd=1e8)
    # float32 reductions (mean, variance, logsumexp) in different orders
    for k, v in r_j.metrics.items():
        np.testing.assert_allclose(r_t.metrics[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(r_t.log_norm_const_preds["log_norm_const_is"],
                               r_j.log_norm_const_preds["log_norm_const_is"], rtol=1e-5)
    np.testing.assert_allclose(N(r_t.weights), r_j.weights, rtol=1e-5, atol=1e-9)


def test_mala_step_fed_draws():
    tgt_j = ManyModes(n_modes=3, dim=2, var=0.3)
    tgt_t = TManyModes(n_modes=3, dim=2, var=0.3, device=CPU)
    x = np.random.default_rng(5).normal(scale=2.0, size=(64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    st_j = MCMCState.init(jnp.asarray(x), tgt_j.log_prob_and_score, 0.05)
    new_j, la_j = mala_step(key, st_j, tgt_j.log_prob_and_score)
    # the draws mala_step makes from its key, fed to the port
    k_prop, k_acc = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_prop, x.shape, jnp.float32))
    unif = np.asarray(jax.random.uniform(k_acc, (x.shape[0],)))
    st_t = TState.init(T(x), tgt_t.log_prob_and_score, 0.05)
    new_t, la_t = t_mala_step(None, st_t, tgt_t.log_prob_and_score,
                              noise=T(noise), uniforms=T(unif))
    # log-acceptance: differences of float32 log-densities of size ~10
    np.testing.assert_allclose(N(la_t), la_j, rtol=1e-4, atol=1e-4)
    # acceptance decisions agree wherever the ratio is not within rounding
    clear = np.abs(np.log(unif) - np.asarray(la_j)) > 1e-3
    np.testing.assert_allclose(N(new_t.x)[clear], np.asarray(new_j.x)[clear], rtol=1e-6)


def test_fit_gmm_em_from_means_init():
    rng = np.random.default_rng(7)
    centres = np.array([[-3.0, 0.0], [2.0, 2.0], [2.0, -3.0]], np.float32)
    data = np.concatenate([c + 0.5 * rng.normal(size=(400, 2)) for c in centres])
    data = data.astype(np.float32)
    init = centres + 0.3
    w_j, m_j, v_j, _ = fit_gmm_em(3, jnp.asarray(data), means_init=jnp.asarray(init))
    w_t, m_t, v_t, _ = t_fit_gmm_em(3, T(data), means_init=T(init))
    # EM iterates to a fixed point in float32; both stop at tol 1e-3
    np.testing.assert_allclose(N(w_t), w_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(m_t), m_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(v_t), v_j, rtol=1e-3, atol=1e-5)
    # the api sweep returns the first (weakest-reg) fit that is sound
    w_a, m_a, v_a = t_api.fit_gmm(3, data, means_init=init, device=CPU)
    np.testing.assert_allclose(N(m_a), N(m_t), rtol=1e-5, atol=1e-5)


def test_fit_gmm_seeding_recovers_every_mode():
    """The port seeds EM with sklearn's greedy k-means++; the JAX package's
    single-candidate seeding (utils/gmm_fit.py:117-126) merges two of the
    demo's four modes into one component for some seeds."""
    loc = TManyModes(n_modes=4, dim=8, var=0.5, device=CPU).loc.numpy()
    rng = np.random.default_rng(8)
    data = np.concatenate([c + np.sqrt(0.5) * rng.normal(size=(1000, 8)) for c in loc])
    data = data.astype(np.float32)
    jax_merged = 0
    for seed in range(10):
        w_t, _, _, _ = t_fit_gmm_em(4, T(data), generator=torch.Generator().manual_seed(seed))
        # each component holds one mode's quarter of the data
        np.testing.assert_allclose(np.sort(N(w_t)), 0.25, atol=0.01)
        w_j, _, _, _ = fit_gmm_em(4, jnp.asarray(data), key=jax.random.PRNGKey(seed))
        jax_merged += bool(np.min(np.asarray(w_j)) < 0.2)
    assert jax_merged > 0  # the fault logged in ROADMAP.md §C
