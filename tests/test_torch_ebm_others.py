"""The port's other EBM trainers held against the JAX package's on the CPU:
DAEBM's energy-difference loss and its Gibbs sampler's shapes, DRL's
transition tables, its noising pairs under the JAX draws, its per-row
scaled energy and loss, and the denoising, target and perfect
score-matching losses under the JAX draws; each trainer then runs a few
steps to finite losses.

Tolerance: float32 in both packages with other summation orders, 1e-5
relative / 1e-5 absolute on losses of size ~1–100.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.ebm import DAEBM as TDAEBM
from sde_sampler_lrds_torch.ebm import DiffusionRecoveryLikelihood as TDRL
from sde_sampler_lrds_torch.ebm import PerfectScoreMatching as TPSM
from sde_sampler_lrds_torch.ebm import ScoreMatching as TSM
from sde_sampler_lrds_torch.ebm import TargetScoreMatching as TTSM
from sde_sampler_lrds_torch.ebm import sample_langevin_gibbs_mcmc as t_gibbs
from sde_sampler_lrds_torch.models import FourierMLP as TFourierMLP
from sde_sampler_lrds_torch.models.mlp import load_flax_params
from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential as TPot
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets import Gauss as TGauss
from sde_sampler_lrds_tpu.ebm import DAEBM, DiffusionRecoveryLikelihood, PerfectScoreMatching
from sde_sampler_lrds_tpu.ebm import ScoreMatching, TargetScoreMatching
from sde_sampler_lrds_tpu.models import FourierMLP, GMMTiltedPotential
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets import Gauss

MEANS = np.array([[-1.0, 0.5], [1.0, -0.5]], np.float32)
VARS = np.array([[0.3, 0.5], [0.4, 0.2]], np.float32)
WEIGHTS = np.array([0.6, 0.4], np.float32)
D, H, B = 2, 16, 12
TOL = dict(rtol=1e-5, atol=1e-5)


def N(t):
    return t.detach().cpu().numpy()


def T(a):
    return torch.as_tensor(np.array(a))


def _potentials():
    j_pot = GMMTiltedPotential(base_model=FourierMLP(dim=D, channels=H, num_layers=3),
                               sde=VP(), weights=jnp.asarray(WEIGHTS),
                               means=jnp.asarray(MEANS), variances=jnp.asarray(VARS))
    params = j_pot.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_pot = TPot(TFourierMLP(dim=D, channels=H, num_layers=3), TVP(), WEIGHTS, MEANS, VARS)
    t_pot.load_flax_params(jax.tree.map(np.asarray, params))
    return j_pot, params, t_pot


def _data(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, D)).astype(np.float32), rng


def test_daebm_loss_and_gibbs_shapes():
    j_pot, params, t_pot = _potentials()
    xs_p, rng = _data(1)
    xs_n = rng.normal(size=(2 * B, D)).astype(np.float32)
    ts_p = rng.uniform(0, 1, B).astype(np.float32)
    ts_n = rng.uniform(0, 1, 2 * B).astype(np.float32)
    want = (j_pot.apply(params, jnp.asarray(ts_p), jnp.asarray(xs_p), method="energy").mean()
            - j_pot.apply(params, jnp.asarray(ts_n), jnp.asarray(xs_n), method="energy").mean())
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    tr = TDAEBM(TVP(), prior, t_pot, step_size=1e-2, persistent_size=64, n_steps=5)
    np.testing.assert_allclose(float(tr.loss(T(ts_p), T(xs_p), T(ts_n), T(xs_n)).detach()),
                               float(want), **TOL)
    np.testing.assert_allclose(N(tr.times), np.asarray(DAEBM(VP(), None, j_pot, n_steps=5).times),
                               rtol=1e-6)
    lpg = lambda t, y: t_pot.unnorm_log_prob_and_grad(t, y)
    ks, ts, xs, ss, diags = t_gibbs(
        torch.Generator().manual_seed(0), torch.full((B,), 5), T(xs_p), tr.times,
        lambda t, y: t_pot.unnorm_log_prob(t, y), lpg, 3, 4, 2, torch.full((6,), 1e-2))
    assert ks.shape == ts.shape == (4, B) and xs.shape == (4, B, D) and ss.shape == (6, 1)
    assert diags["local_acc"].shape == (4, 6)
    np.testing.assert_array_equal(N(ts), N(tr.times[ks]))
    losses, d = tr.train(torch.Generator().manual_seed(1), torch.as_tensor(_data(2, 64)[0]),
                         batch_size=16, n_epochs=1, initial_n_warmup_mcmc_steps=3,
                         n_mcmc_steps=2, n_local_steps=2)
    assert len(losses) == 4 and np.isfinite(losses).all() and 0 <= d[0]["local_acc"] <= 1


@pytest.mark.parametrize("weighting", ["gao", "bar", "none"])
def test_drl_tables_pairs_energy_and_loss_match_jax(weighting):
    j_pot, params, t_pot = _potentials()
    flags = dict(use_gao_weighting=weighting == "gao", use_bar_weighting=weighting == "bar")
    j_tr = DiffusionRecoveryLikelihood(VP(), None, j_pot, n_steps=6, **flags)
    t_tr = TDRL(TVP(), None, t_pot, n_steps=6, **flags)
    for name in ("times", "alphas", "sigmas_sq", "alphas_bar", "sigmas_sq_bar", "step_size"):
        np.testing.assert_allclose(N(getattr(t_tr, name)), np.asarray(getattr(j_tr, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    x, rng = _data(3)
    ks = rng.integers(0, 5, B)
    key = jax.random.PRNGKey(4)
    j_pair = j_tr.sample_noise_process_pairs(key, jnp.asarray(ks), jnp.asarray(x))
    k1, k2 = jax.random.split(key)
    t_pair = t_tr.sample_noise_process_pairs(None, T(ks), T(x),
                                             z=T(jax.random.normal(k1, x.shape)),
                                             z2=T(jax.random.normal(k2, x.shape)))
    for got, want in zip(t_pair, j_pair):
        np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
    # the conditional's log-density and score at the JAX pairs
    j_lpg = j_tr._cond_lpg(params, jnp.asarray(ks), j_pair[1])
    t_lpg = t_tr._cond_lpg(t_pot, T(ks), T(j_pair[1]))
    for got, want in zip(t_lpg(T(j_pair[0])), j_lpg(j_pair[0])):
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-4)
    en = j_tr.net_energy(params, jnp.asarray(ks), jnp.asarray(x))
    np.testing.assert_allclose(N(t_tr.net_energy(t_pot, T(ks), T(x))), np.asarray(en), **TOL)
    y_neg = rng.normal(size=(B, D)).astype(np.float32)
    en_neg = j_tr.net_energy(params, jnp.asarray(ks), jnp.asarray(y_neg))
    w = np.asarray(t_tr.weights(T(ks)))
    want = np.mean(w * np.asarray(en)) - np.mean(w * np.asarray(en_neg)) \
        + 5e-3 * (np.mean(np.asarray(en) ** 2) + np.mean(np.asarray(en_neg) ** 2))
    got = t_tr.loss(t_pot, T(ks), T(x), T(ks), T(y_neg), T(w), T(w), 5e-3)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    losses, accs = t_tr.train(torch.Generator().manual_seed(0), torch.as_tensor(_data(5, 64)[0]),
                              batch_size=32, n_epochs=1, n_mcmc_steps=3)
    assert len(losses) == 2 and np.isfinite(losses).all() and 0 <= np.mean(accs) <= 1


def _score_nets():
    j_net = FourierMLP(dim=D, channels=H, num_layers=3)
    params = j_net.init(jax.random.PRNGKey(6), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_net = TFourierMLP(dim=D, channels=H, num_layers=3)
    load_flax_params(t_net, jax.tree.map(np.asarray, params))
    return j_net, params, t_net


@pytest.mark.parametrize("kind", ["dsm", "dsm_plain", "tsm", "psm"])
def test_score_matching_losses_match_jax(kind):
    j_net, params, t_net = _score_nets()
    mu, var = np.float32(0.5), np.float32(0.64)
    kw = dict(t_start=0.01, t_end=0.99, n_steps=8, antithetic=kind != "dsm_plain")
    if kind in ("dsm", "dsm_plain"):
        j_sm = ScoreMatching(sde=VP(), prior=None, score_net=j_net, **kw)
        t_sm = TSM(sde=TVP(), prior=None, score_net=t_net, **kw)
    elif kind == "tsm":
        j_sm = TargetScoreMatching(target_score=Gauss(dim=D, loc=mu, scale=0.8).score,
                                   sde=VP(), prior=None, score_net=j_net, **kw)
        t_sm = TTSM(target_score=TGauss(dim=D, loc=mu, scale=0.8, device="cpu").score,
                    sde=TVP(), prior=None, score_net=t_net, **kw)
    else:
        j_sde, t_sde = VP(), TVP()
        j_sm = PerfectScoreMatching(
            perfect_score=lambda t, y: j_sde.marginal_score(
                t[0], y, jnp.full((D,), mu), var_init=jnp.full((D,), var)),
            sde=j_sde, prior=None, score_net=j_net, **kw)
        t_sm = TPSM(perfect_score=lambda t, y: t_sde.marginal_score(
            t[0], y, torch.full((D,), float(mu)), var_init=torch.full((D,), float(var))),
            sde=t_sde, prior=None, score_net=t_net, **kw)
    x, rng = _data(7)
    ts = rng.uniform(0.01, 0.99, B).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = j_sm.compute_loss(params, key, jnp.asarray(ts), jnp.asarray(x))
    got = t_sm.compute_loss(t_net, None, T(ts), T(x), z=T(jax.random.normal(key, x.shape)))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_score_matching_trains_and_samples():
    _, _, t_net = _score_nets()
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    sm = TSM(sde=TVP(), prior=prior, score_net=t_net, t_start=0.01, t_end=0.99, n_steps=8,
             time_type="multinomial_snr")
    losses = sm.train(torch.Generator().manual_seed(0), torch.as_tensor(_data(9, 128)[0]),
                      batch_size=32, n_epochs=2)
    assert len(losses) == 8 and np.isfinite(losses).all()
    g = torch.Generator().manual_seed(1)
    assert sm.sample(g, 64).shape == (64, D)
    traj = sm.sample(g, 64, keep_intermediates=True, use_ddpm_kernel=True)
    assert traj.shape == (9, 64, D) and bool(torch.isfinite(traj).all())
