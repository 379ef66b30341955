"""The port's pinned-BM reference process, its targets and the EUBO held
against the JAX package: ``TwoModes`` (every ``ill_conditioned`` setting)
and ``Delta``, every ``PinnedBM`` method the EM / EI losses and the log-SNR
grid read, the default reference of 'pbm-ref', and ``compute_eubo`` of the
EM and EI losses on VP and PinnedBM under fed noise.

Inputs are drawn with numpy from a seed and handed to both packages as
numpy arrays; the noise the JAX noising pass draws from its key is rebuilt
from that key and fed to the port. Everything runs in float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.losses import EIReferenceSDELoss as TEILoss
from sde_sampler_lrds_torch.losses import EMReferenceSDELoss as TEMLoss
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.sde import PinnedBM as TPinnedBM
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import RDS as TRDS
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import Delta as TDelta
from sde_sampler_lrds_torch.targets import TwoModes as TTwoModes
from sde_sampler_lrds_tpu.losses import EIReferenceSDELoss, EMReferenceSDELoss
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.sde import VP, PinnedBM, get_timesteps
from sde_sampler_lrds_tpu.solvers import RDS
from sde_sampler_lrds_tpu.solvers.base import TrainConfig
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl
from sde_sampler_lrds_tpu.targets import Delta, TwoModes

RTOL = 1e-5  # float32 closed forms evaluated in the same order on both sides


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# (1) TwoModes and Delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [5, 16])
@pytest.mark.parametrize("cond", ["not", "medium", "hard"])
def test_two_modes_matches_jax(dim, cond):
    jt = TwoModes(dim=dim, ill_conditioned=cond, n_reference_samples=4096)
    tt = TTwoModes(dim=dim, ill_conditioned=cond, n_reference_samples=4096, device="cpu")
    close(tt.loc, jt.loc)
    close(tt.scale, jt.scale)
    rng = np.random.default_rng(dim)
    x = (rng.normal(size=(257, dim)) * 1.2).astype(np.float32)
    close(tt.unnorm_log_prob(T(x)), jt.unnorm_log_prob(jnp.asarray(x)), atol=1e-5)
    close(tt.log_prob(T(x)), jt.log_prob(jnp.asarray(x)), atol=1e-5)
    # the score sums the components' (x - m_c)/v_c (up to 60 here) weighted
    # by their responsibilities: relative to its largest entry
    want = np.asarray(jt.score(jnp.asarray(x)))
    close(tt.score(T(x)), want, atol=RTOL * np.abs(want).max())
    # the same samples on both sides: each package's compute_stats_sampling
    # reduces them to its expectations (mode_weight among them)
    samples = np.asarray(jt.sample(jax.random.PRNGKey(dim), (4096,)))
    close(tt.compute_mode_weight(T(samples)), jt.compute_mode_weight(jnp.asarray(samples)))
    jt.sample = lambda key, shape: jnp.asarray(samples)
    tt.sample = lambda gen, shape: T(samples)
    jt.compute_stats_sampling(jax.random.PRNGKey(0))
    tt.compute_stats_sampling(torch.Generator().manual_seed(0))
    assert set(tt.expectations) == set(jt.expectations)
    assert "mode_weight" in tt.expectations
    for k, v in jt.expectations.items():
        np.testing.assert_allclose(tt.expectations[k], v, rtol=RTOL, atol=1e-6, err_msg=k)


def test_two_modes_refuses_unknown_conditioning():
    with pytest.raises(ValueError, match="ill_conditioned"):
        TTwoModes(dim=4, ill_conditioned="very", device="cpu")


def test_delta_matches_jax():
    dim = 6
    jd, td = Delta(dim=dim, loc=0.0), TDelta(dim=dim, loc=0.0, device="cpu")
    x = (1e-3 * np.random.default_rng(3).normal(size=(33, dim))).astype(np.float32)
    close(td.log_prob(T(x)), jd.log_prob(jnp.asarray(x)), rtol=1e-5)
    close(td.score(T(x)), jd.score(jnp.asarray(x)), rtol=1e-5)
    s = td.sample(torch.Generator().manual_seed(0), (7,))
    close(s, jd.sample(jax.random.PRNGKey(0), (7,)))
    assert s.shape == (7, dim) and s.is_contiguous()


# ---------------------------------------------------------------------------
# (2) PinnedBM
# ---------------------------------------------------------------------------

def _pbm_pair(diff):
    return PinnedBM(diff_coeff=diff, terminal_t=5.0), TPinnedBM(diff_coeff=diff, terminal_t=5.0)


@pytest.mark.parametrize("diff", [1.0, float(np.sqrt(0.2))])
def test_pinned_bm_grid_matches_jax(diff):
    """The log-SNR grid of 'pbm-ref' (1e-4 .. T - 1e-4, 100 steps) to 1e-5
    relative: both bisect on a float32 log-SNR whose logs the two libraries
    round apart, so inner points differ by a few ulps."""
    jsde, tsde = _pbm_pair(diff)
    jts = np.asarray(get_timesteps(1e-4, 5.0 - 1e-4, steps=100, sde=jsde))
    tts = N(t_get_timesteps(1e-4, 5.0 - 1e-4, steps=100, sde=tsde, device="cpu"))
    assert tts[0] == np.float32(1e-4) and tts[-1] == np.float32(5.0 - 1e-4)
    np.testing.assert_allclose(tts, jts, rtol=RTOL)


@pytest.mark.parametrize("diff", [1.0, float(np.sqrt(0.2))])
def test_pinned_bm_methods_match_jax(diff):
    """Every method the EM / EI / DDPM losses and the grid read, at the grid's
    times (T - 1e-4 included), in the noising time T - t the losses use, and
    on step pairs (s, t) of the grid."""
    jsde, tsde = _pbm_pair(diff)
    ts = np.asarray(get_timesteps(1e-4, 5.0 - 1e-4, steps=100, sde=jsde))
    tc = np.float32(ts[-1]) - ts[:-1]                      # the losses' t_ctrl
    times = np.concatenate([ts, tc]).astype(np.float32)
    s_arr, t_arr = ts[:-1], ts[1:]
    for name in ("drift_coeff_t", "diff_coeff_t", "s", "sigma_sq", "log_snr"):
        close(getattr(tsde, name)(T(times)), getattr(jsde, name)(jnp.asarray(times)))
    for name in ("int_drift_coeff_t", "int_diff_coeff_sq_t", "transition_params",
                 "omega", "omega_ddpm", "ei_step_coeffs", "ddpm_step_coeffs"):
        got = getattr(tsde, name)(T(s_arr), T(t_arr))
        want = getattr(jsde, name)(jnp.asarray(s_arr), jnp.asarray(t_arr))
        # log(T - t) - log(T - s) cancels two float32 logs of ≈ 1.6 at the
        # first steps: 2 ulps of log(T) absolute
        atol = 2.5e-7 if name == "int_drift_coeff_t" else 0.0
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            close(g, w, atol=atol)
    # the noising pass's transition from T - t to T - s
    T_ = ts[-1]
    got = tsde.transition_params(T(T_ - t_arr[::-1].copy()), T(T_ - s_arr[::-1].copy()))
    want = jsde.transition_params(jnp.asarray(T_ - t_arr[::-1]), jnp.asarray(T_ - s_arr[::-1]))
    for g, w in zip(got, want):
        close(g, w)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(17, 3)).astype(np.float32)
    score = rng.normal(size=(17, 3)).astype(np.float32)
    z = rng.normal(size=(17, 3)).astype(np.float32)
    close(tsde.ei_integration_step(T(x), T(ts[3]), T(ts[4]), T(score), T(z)),
          jsde.ei_integration_step(jnp.asarray(x), ts[3], ts[4], jnp.asarray(score),
                                   jnp.asarray(z)), atol=1e-6)
    means = rng.normal(size=(2, 3)).astype(np.float32)
    variances = (0.2 + rng.random((2, 3))).astype(np.float32)
    weights = np.array([0.3, 0.7], np.float32)
    for t in (ts[0], ts[50], tc[0], tc[-1]):
        tt, jt = T(np.float32(t)), jnp.asarray(np.float32(t))
        close(tsde.marginal_gmm_log_prob(tt, T(x), T(means), T(variances), T(weights)),
              jsde.marginal_gmm_log_prob(jt, jnp.asarray(x), means, variances, weights),
              atol=1e-4)
        close(tsde.marginal_gmm_score(tt, T(x), T(means), T(variances), T(weights)),
              jsde.marginal_gmm_score(jt, jnp.asarray(x), means, variances, weights),
              rtol=1e-4, atol=1e-3)
        close(tsde.marginal_score(tt, T(x), T(means[0]), var_init=T(variances[0])),
              jsde.marginal_score(jt, jnp.asarray(x), means[0], var_init=variances[0]),
              rtol=1e-4, atol=1e-3)


def test_pinned_bm_refuses_nonpositive_diffusion():
    with pytest.raises(ValueError, match="positive diff_coeff"):
        TPinnedBM(diff_coeff=0.0)


def _tiny_ctrl(dim, seed=0):
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=dim, channels=16, num_layers=3), clip_model=1e4)
    params = ctrl.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, dim)))
    t_ctrl = TClipped(TFourier(dim=dim, channels=16, num_layers=3), clip_model=1e4)
    load_flax_params(t_ctrl, jax.tree_util.tree_map(np.asarray, params))
    return ctrl, params, t_ctrl


def test_pbm_default_reference_matches_jax():
    """'pbm-ref' with its default reference: N(prior loc, T·g²) installed
    from the Delta prior, its log-density and its per-step score tables."""
    dim = 4
    jsde, tsde = _pbm_pair(1.0)
    ts = get_timesteps(1e-4, 5.0 - 1e-4, steps=12, sde=jsde)
    ctrl, _, t_ctrl = _tiny_ctrl(dim)
    target = TwoModes(dim=dim)
    j = RDS(target, Delta(dim=dim), jsde, ctrl, EIReferenceSDELoss, {"method": "lv"},
            train_ts=ts, cfg=TrainConfig(train_batch_size=8, eval_batch_size=8),
            mesh=get_mesh(1))
    t = TRDS(TTwoModes(dim=dim, device="cpu"), TDelta(dim=dim, device="cpu"), tsde, t_ctrl,
             TEILoss, {"method": "lv"}, train_ts=T(ts),
             cfg=TTrainConfig(train_batch_size=8, eval_batch_size=8), device="cpu")
    for k in ("x_init", "var_init"):
        close(t.reference_distr_utils[k], j.reference_distr_utils[k])
    np.testing.assert_allclose(N(t.reference_distr_utils["var_init"]), 5.0)
    x = np.random.default_rng(2).normal(size=(9, dim)).astype(np.float32)
    close(t.reference_log_prob(T(x)), j.reference_log_prob(jnp.asarray(x)))
    tc = np.asarray(ts[-1] - ts[:-1])
    got = t.reference_score_t.precompute(T(tc))
    want = j.reference_score_t.precompute(jnp.asarray(tc))
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# (3) compute_eubo
# ---------------------------------------------------------------------------

EUBO_CASES = [(sde, loss) for sde in ("vp", "pbm") for loss in ("em", "ei")]


@pytest.mark.parametrize("sde_name,loss_name", EUBO_CASES)
def test_compute_eubo_matches_jax(sde_name, loss_name):
    """The noising pass from target samples under the noise the JAX pass
    draws from its key, with a random (not near-zero) control and a
    2-component GMM reference: the per-sample log-ratio to 1e-4."""
    dim, k, b = 3, 12, 64
    rng = np.random.default_rng(7)
    means = rng.normal(size=(2, dim)).astype(np.float32)
    variances = (0.3 + 0.3 * rng.random((2, dim))).astype(np.float32)
    weights = np.array([0.4, 0.6], np.float32)
    if sde_name == "vp":
        jsde, tsde = VP(0.1, 10.0), TVP(0.1, 10.0)
        ts = get_timesteps(0.0, 1.0, steps=k)
    else:
        jsde, tsde = _pbm_pair(float(np.sqrt(0.2)))
        ts = get_timesteps(1e-4, 5.0 - 1e-4, steps=k, sde=jsde)
    jcls, tcls = {"em": (EMReferenceSDELoss, TEMLoss), "ei": (EIReferenceSDELoss, TEILoss)}[
        loss_name]
    jloss = jcls(sde=jsde, method="lv", reference_ctrl=GMMReferenceCtrl(
        jsde, jnp.asarray(means), jnp.asarray(variances), jnp.asarray(weights)))
    tloss = tcls(sde=tsde, method="lv", reference_ctrl=TGMMRef(
        tsde, T(means), T(variances), T(weights)))
    ctrl, params, t_ctrl = _tiny_ctrl(dim, seed=3)
    target = TwoModes(dim=dim)
    x = np.asarray(target.sample(jax.random.PRNGKey(1), (b,)))
    j_ref_lp = lambda y: jsde.marginal_gmm_log_prob(jnp.asarray(0.0), y, means, variances,
                                                   weights)
    t_ref_lp = lambda y: tsde.marginal_gmm_log_prob(torch.zeros(()), y, T(means),
                                                   T(variances), T(weights))
    key = jax.random.PRNGKey(5)
    want = jloss.compute_eubo(key, ts, jnp.asarray(x), lambda t, y: ctrl.apply(params, t, y),
                              target.unnorm_log_prob, j_ref_lp)
    noise = np.asarray(jax.random.normal(key, (k, b, dim)))
    tt = TTwoModes(dim=dim, device="cpu")
    got = tloss.compute_eubo(None, T(ts), T(x), t_ctrl, tt.unnorm_log_prob, t_ref_lp,
                             noise=T(noise))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
