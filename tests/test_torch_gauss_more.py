"""The rest of the port's Gaussian family and the cosine VP SDE held against
the JAX package: the ``gmm_params`` presets and ``GMM(name=...)``,
``GMMFull``, ``TwoModesFull`` ('medium' / 'hard'), ``BracketTwoModes`` and
the truncated ``IsotropicGauss`` (parameters, log-densities, scores, mode
counts, sampling moments and the mode weight); ``CosineVP``'s schedule
methods and both of its time grids; ``make_model(force_vp_cosine=True)``;
B1's plan on the cosine EI loss against the JAX ``build_plan`` /
``_step_coeffs`` tables at K = 100; and the port's plain fused trajectory
against the JAX Pallas kernel (interpret mode) under fed noise on both
grids.

Inputs are drawn with numpy from a seed and handed to both packages.
Densities and scores agree to rtol = 1e-5 (atol 1e-5) in float32. Sampling
draws from different RNG streams and is held to 5 Monte Carlo standard
errors. The cosine schedule's tolerances are stated where used: its α is
−2 log cos, and the two libraries' float32 cosines differ by an ulp at some
arguments, which α carries into the log-SNR and the step coefficients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import losses as t_losses
from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.ops import fused_traj as t_ft
from sde_sampler_lrds_torch.sde import CosineVP as TCosineVP
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.targets import gauss as tg
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.sde import CosineVP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl
from sde_sampler_lrds_tpu.targets import gauss as jg

TOL = dict(rtol=1e-5, atol=1e-5)


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _points(dim, n=256, scale=1.5, seed=0):
    return np.random.default_rng(seed).normal(scale=scale, size=(n, dim)).astype(np.float32)


def _target_points(j, n=256):
    """Draws of the JAX target and the points halfway to the origin (between
    the modes), where the mixtures' responsibilities are balanced."""
    x = np.asarray(j.sample(jax.random.PRNGKey(0), (n,)))
    return np.concatenate([x, 0.5 * x[: n // 4]])


def _density_parity(j, t, x, tol=TOL):
    np.testing.assert_allclose(N(t.unnorm_log_prob(T(x))), np.asarray(j.unnorm_log_prob(x)),
                               **tol)
    np.testing.assert_allclose(N(t.score(T(x))), np.asarray(j.score(jnp.asarray(x))), **tol)
    np.testing.assert_array_equal(N(t.compute_mode_count(T(x))),
                                  np.asarray(j.compute_mode_count(jnp.asarray(x))))


def _sampling_parity(j, t, n=40_000):
    """Means and covariances of each package's draws within 5 standard errors
    of the other's (the JAX draws' moments are the reference)."""
    xj = np.asarray(j.sample(jax.random.PRNGKey(3), (n,)), np.float64)
    xt = N(t.sample(torch.Generator().manual_seed(3), (n,))).astype(np.float64)
    se_mean = np.sqrt(2 * xj.var(0) / n)
    assert np.all(np.abs(xt.mean(0) - xj.mean(0)) <= 5 * se_mean)
    cj, ct = np.cov(xj.T), np.cov(xt.T)
    se_cov = np.sqrt(2 * (np.outer(xj.var(0), xj.var(0)) + cj**2) / n)
    assert np.all(np.abs(ct - cj) <= 5 * se_cov)
    return xj, xt


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 4])
@pytest.mark.parametrize("name", ["heart", "dist", "fab", "multi", "grid", "circle"])
def test_gmm_params_presets_match_jax(name, dim):
    for a, b in zip(tg.gmm_params(name, dim=dim), jg.gmm_params(name, dim=dim)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="Unknown mode"):
        tg.gmm_params("nope")


@pytest.mark.parametrize("name", ["heart", "circle", "grid"])
def test_named_gmm_matches_jax(name):
    j = jg.GMM(dim=3, name=name, n_reference_samples=100)
    t = tg.GMM(dim=3, name=name, n_reference_samples=100, device="cpu")
    np.testing.assert_array_equal(N(t.loc), np.asarray(j.loc))
    _density_parity(j, t, _points(3, scale=3.0))
    np.testing.assert_allclose(N(t.domain), np.asarray(j.domain), rtol=1e-6)


def _gmm_full_params(dim=3, n=3, seed=4):
    rng = np.random.default_rng(seed)
    loc = (3.0 * rng.normal(size=(n, dim))).astype(np.float32)
    a = rng.normal(size=(n, dim, dim))
    cov = (np.einsum("kij,klj->kil", a, a) / dim + 0.2 * np.eye(dim)).astype(np.float32)
    return loc, cov, np.array([1.0, 2.0, 3.0], np.float32)[:n]


def test_gmm_full_matches_jax():
    loc, cov, w = _gmm_full_params()
    j = jg.GMMFull(dim=3, loc=loc, cov=cov, mixture_weights=w, n_reference_samples=100)
    t = tg.GMMFull(dim=3, loc=loc, cov=cov, mixture_weights=w, n_reference_samples=100,
                   device="cpu")
    # float32 inverses, Cholesky factors and log-determinants in two libraries
    np.testing.assert_allclose(N(t.prec), np.asarray(j.prec), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(t.cov_log_det), np.asarray(j.cov_log_det), rtol=1e-5)
    np.testing.assert_allclose(N(t.chol), np.asarray(j.chol), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(t.stddevs), np.asarray(j.stddevs), rtol=1e-6)
    _density_parity(j, t, _points(3, scale=4.0))
    x = _points(3, scale=4.0, seed=1)
    np.testing.assert_allclose(N(t.entropy(T(x))), float(j.entropy(jnp.asarray(x))), rtol=1e-6)
    _sampling_parity(j, t)
    # given the precisions instead of the covariances
    t2 = tg.GMMFull(dim=3, loc=loc, prec=N(t.prec), mixture_weights=w, device="cpu")
    np.testing.assert_allclose(N(t2.cov), cov, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="Either cov or prec"):
        tg.GMMFull(dim=3, loc=loc, mixture_weights=w, device="cpu")
    with pytest.raises(ValueError, match="Require mixture weights"):
        tg.GMMFull(dim=3, loc=loc, cov=cov, device="cpu")


@pytest.mark.parametrize("ill_conditioned", ["medium", "hard"])
def test_two_modes_full_matches_jax(ill_conditioned):
    j = jg.TwoModesFull(dim=5, ill_conditioned=ill_conditioned, n_reference_samples=4000)
    t = tg.TwoModesFull(dim=5, ill_conditioned=ill_conditioned, n_reference_samples=4000,
                        device="cpu")
    # the same QR rotation from numpy's default_rng(42), rounded once
    np.testing.assert_array_equal(N(t.loc), np.asarray(j.loc))
    np.testing.assert_array_equal(N(t.cov), np.asarray(j.cov))
    # its eigenvalues span 2 decades at 'hard': inverses carry the condition
    # number, and so do the densities (measured 3.7e-4 on log-densities of
    # 24, 4.4e-5 relative on the scores)
    np.testing.assert_allclose(N(t.prec), np.asarray(j.prec), rtol=1e-3, atol=1e-3)
    _density_parity(j, t, _target_points(j), tol=dict(rtol=1e-4, atol=1e-4))
    xj, xt = _sampling_parity(j, t)
    # the strongest mode's weight (2/3) within 5 binomial standard errors
    se = 100 * np.sqrt((2 / 3) * (1 / 3) / xt.shape[0])
    assert abs(float(t.compute_mode_weight(T(xt.astype(np.float32)))) - 200 / 3) <= 5 * se
    assert abs(float(j.compute_mode_weight(jnp.asarray(xj, jnp.float32))) - 200 / 3) <= 5 * se
    with pytest.raises(ValueError, match="ill_conditioned"):
        tg.TwoModesFull(dim=5, ill_conditioned="not", device="cpu")


@pytest.mark.parametrize("equilibrated", [False, True])
def test_bracket_two_modes_matches_jax(equilibrated):
    j = jg.BracketTwoModes(dim=6, equilibrated=equilibrated, n_reference_samples=4000)
    t = tg.BracketTwoModes(dim=6, equilibrated=equilibrated, n_reference_samples=4000,
                           device="cpu")
    np.testing.assert_array_equal(N(t.loc), np.asarray(j.loc))
    np.testing.assert_array_equal(N(t.mixture_weights), np.asarray(j.mixture_weights))
    # float32 linspace and square root: within an ulp
    np.testing.assert_allclose(N(t.scale), np.asarray(j.scale), rtol=2.4e-7)
    _density_parity(j, t, _target_points(j))
    xj, xt = _sampling_parity(j, t)
    p = 0.5 if equilibrated else 2 / 3
    se = 100 * np.sqrt(p * (1 - p) / xt.shape[0])
    assert abs(float(t.compute_mode_weight(T(xt.astype(np.float32)))) - 100 * p) <= 5 * se
    t.compute_stats(torch.Generator().manual_seed(0))
    assert abs(t.expectations["mode_weight"] - 100 * p) <= 5 * 100 * np.sqrt(p * (1 - p) / 4000)


@pytest.mark.parametrize("quartile", [0.05, 0.5])
def test_truncated_isotropic_gauss_matches_jax(quartile):
    j = jg.IsotropicGauss(dim=3, loc=0.5, scale=2.0, truncate_quartile=quartile)
    t = tg.IsotropicGauss(dim=3, loc=0.5, scale=2.0, truncate_quartile=quartile,
                          device="cpu")
    # scipy's norm.ppf against the standard library's NormalDist.inv_cdf
    np.testing.assert_allclose(t.truncate_quartile, j.truncate_quartile, rtol=1e-12)
    x = _points(3)
    # the density is the untruncated one's in both packages
    np.testing.assert_allclose(N(t.unnorm_log_prob(T(x))), np.asarray(j.unnorm_log_prob(x)),
                               **TOL)
    xj, xt = _sampling_parity(j, t)
    lo, hi = t.truncate_quartile
    assert xt.min() >= lo - 1e-5 and xt.max() <= hi + 1e-5
    assert xj.min() >= lo - 1e-5 and xj.max() <= hi + 1e-5
    # the central 1 − q of the mass: a standard deviation below the scale
    assert np.all(xt.std(0) < 2.0)
    assert tg.IsotropicGauss(dim=2, device="cpu").truncate_quartile is None


# ---------------------------------------------------------------------------
# CosineVP
# ---------------------------------------------------------------------------

def _grids(k=100):
    """The cosine model's two grids, as make_model builds them in the port,
    and the same values for the JAX side."""
    sde = TCosineVP()
    uni = t_get_timesteps(1e-3, 1.0, steps=k, device="cpu")
    snr = t_get_timesteps(1e-4, 1.0 - 1e-4, steps=k, sde=sde, device="cpu")
    return {"uniform": uni, "snr": snr}


# α = −2 log cos(π/2 u) in float32: the two libraries' cosines are an ulp
# apart at some arguments, which moves α by up to 1.2e-7 near t = 0 (α ≈
# 1.6e-4) and by half an ulp of α near T (α ≈ 17.5); measured 9.5e-7
ALPHA_TOL = dict(rtol=1e-6, atol=2.5e-7)


def test_cosine_vp_schedule_matches_jax():
    j, t = CosineVP(scale_diff_coeff=1.3), TCosineVP(scale_diff_coeff=1.3)
    assert vars(t) == vars(j)
    ts = np.concatenate([np.linspace(0.0, 1.0 - 1e-4, 2001),
                         1.0 - 1e-4 * np.arange(1, 50)]).astype(np.float32)
    jt, tt = jnp.asarray(ts), T(ts)
    np.testing.assert_allclose(N(t.alpha_(tt)), np.asarray(j.alpha_(jt)), **ALPHA_TOL)
    # β, the drift and the diffusion read tan, not α: an ulp or two
    for name in ("_diff_coeff_sq_t", "drift_coeff_t", "diff_coeff_t", "s"):
        np.testing.assert_allclose(N(getattr(t, name)(tt)), np.asarray(getattr(j, name)(jt)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # σ² = c²·expm1(α): α's ulp relative to α itself near t = 0
    np.testing.assert_allclose(N(t.sigma_sq(tt)), np.asarray(j.sigma_sq(jt)), rtol=1e-3,
                               atol=0)
    # log-SNR = −log σ²(t) up to rounding: α's 1.2e-7 over α ≈ 1.6e-4 near
    # t = 0 (measured 1.4e-4)
    np.testing.assert_allclose(N(t.log_snr(tt)), np.asarray(j.log_snr(jt)), rtol=0, atol=3e-4)
    # at T itself the float32 cosine of π/2 is negative: NaN in both
    assert np.isnan(float(j.alpha_(jnp.float32(1.0)))) and bool(torch.isnan(t.alpha_(1.0)))


@pytest.mark.parametrize("grid", ["uniform", "snr"])
def test_cosine_vp_grids_and_step_coefficients_match_jax(grid):
    j, t = CosineVP(), TCosineVP()
    tts = _grids()[grid]
    if grid == "uniform":  # linspace rounding: an ulp
        want = get_timesteps(1e-3, 1.0, steps=100)
        np.testing.assert_allclose(N(tts), np.asarray(want), rtol=0, atol=1.2e-7)
    else:
        # the bisection targets are equispaced between the log-SNR at the
        # ends, and the t_eps end moves with α's ulp (above): measured 8.0e-5
        want = get_timesteps(1e-4, 1.0 - 1e-4, steps=100, sde=j)
        np.testing.assert_allclose(N(tts), np.asarray(want), rtol=0, atol=1e-4)
    s, e = tts[:-1], tts[1:]
    js, je = jnp.asarray(N(s)), jnp.asarray(N(e))
    T_ = 1.0
    np.testing.assert_allclose(N(t.alpha_(T_ - s)), np.asarray(j.alpha_(T_ - js)), **ALPHA_TOL)
    # λ = expm1(Δα) and the EI coefficients: at the last steps Δα ≈ 1e-6 is
    # a difference of two α an ulp apart, so √λ (a_z) moves by up to 8e-5
    coef_tol = dict(rtol=1e-6, atol=1e-4)
    for a, b in zip(t.ei_step_coeffs(s, e), j.ei_step_coeffs(js, je)):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(N(a), np.asarray(b), **coef_tol)
    np.testing.assert_allclose(N(t.omega(s, e)), np.asarray(j.omega(js, je)), **coef_tol)
    # B1's coefficient table on the cosine EI loss (K = 100)
    t_coefs, t_ctrl = t_ft._step_coeffs(t_losses.EIReferenceSDELoss(sde=t, method="lv"), tts)
    j_coefs, j_ctrl, _ = j_ft._step_coeffs(j_losses.EIReferenceSDELoss(sde=j, method="lv"),
                                           jnp.asarray(N(tts)))
    assert t_coefs.shape == (100, 6) and bool(torch.isfinite(t_coefs).all())
    np.testing.assert_allclose(N(t_coefs), np.asarray(j_coefs), **coef_tol)
    np.testing.assert_array_equal(N(t_ctrl), np.asarray(j_ctrl))
    # the first reverse step reads α near T: a_x = √(1 + λ) far from 1
    assert float(t_coefs[0, 0]) > 10.0


@pytest.mark.parametrize("time_type", ["uniform", "snr"])
def test_make_model_force_vp_cosine_matches_jax(time_type):
    """The cosine model with another sigma (tests/test_torch_experiments.py
    holds its config, SDE, prior and grids at sigma 1) takes the fused paths,
    and pbm-ref refuses it with the JAX message."""
    args = dict(solver_type="vp-ref", ref_type="default", loss_type="lv", integrator_type="ei",
                model_type="base_zero_init", time_type=time_type,
                solver_details={"sigma": 1.2},
                target_details=make_target_details("two_modes", dim=3),
                training_details={"train_steps": 4, "train_batch_size": 8,
                                  "eval_batch_size": 8},
                force_vp_cosine=True, compute_samples_based_metrics=False)
    j = make_model(mesh=get_mesh(1), **args)
    t = t_make_model(device="cpu", **args)
    assert vars(t.sde) == vars(j.sde) and type(t.sde).__name__ == "CosineVP"
    assert float(t.prior.scale[0, 0]) == float(j.prior.scale[0, 0]) == pytest.approx(1.2)
    assert t.train_path() == "flat_lv_plain" and t.eval_path() == "plain"
    pbm = {**args, "solver_type": "pbm-ref", "time_type": "snr"}
    with pytest.raises(ValueError) as want:
        make_model(mesh=get_mesh(1), **pbm)
    with pytest.raises(ValueError) as got:
        t_make_model(device="cpu", **pbm)
    assert str(got.value) == str(want.value) == "Can't use vp_20 or vp_cosine with PBM."


DIM, K, H = 3, 12, 16


def _cosine_pair(time_type):
    """The same cosine EI loss, control and GMM reference in both packages."""
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=DIM, channels=H, num_layers=3),
                       clip_model=1e4)
    params = jax.tree.map(np.asarray, ctrl.init(
        jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, DIM))))
    t_ctrl = TClipped(TFourier(dim=DIM, channels=H, num_layers=3), clip_model=1e4)
    load_flax_params(t_ctrl, params)
    sde, t_sde = CosineVP(), TCosineVP()
    rng = np.random.default_rng(1)
    means = rng.normal(size=(3, DIM)).astype(np.float32)
    variances = (0.5 + rng.random((3, DIM))).astype(np.float32)
    weights = (0.5 + rng.random(3)).astype(np.float32)
    ref = GMMReferenceCtrl(sde, jnp.asarray(means), jnp.asarray(variances),
                           jnp.asarray(weights))
    t_ref = TGMMRef(t_sde, T(means), T(variances), T(weights))
    loss = j_losses.EIReferenceSDELoss(sde=sde, method="lv", reference_ctrl=ref)
    t_loss = t_losses.EIReferenceSDELoss(sde=t_sde, method="lv", reference_ctrl=t_ref)
    t_ts = _grids(K)[time_type]
    return (loss, ctrl, params, jnp.asarray(N(t_ts))), (t_loss, t_ctrl, t_ts)


@pytest.mark.parametrize("time_type", ["uniform", "snr"])
def test_cosine_plain_fused_traj_matches_jax_kernel(time_type):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _cosine_pair(time_type)
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=128)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert set(arr_t) == set(arr_j)
    np.testing.assert_allclose(N(arr_t["coefs"]), arr_j["coefs"], rtol=1e-6, atol=1e-4)
    for name in ("ref_const", "ref_m", "ref_iv"):
        np.testing.assert_allclose(N(arr_t[name]), arr_j[name], rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=(200, DIM)).astype(np.float32)
    noise = rng.normal(size=(K, 200, DIM)).astype(np.float32)
    xt_j, rnd_j, xs_j = j_ft._fused_traj(cfg_j, arr_j, jnp.asarray(x0), jnp.asarray(noise),
                                         True, True)
    xt_t, rnd_t, xs_t = t_ft.fused_traj(cfg_t, arr_t, T(x0), noise=T(noise), return_traj=True)
    # the first step multiplies x by a_x ≈ 11-12 and the random control by
    # a_s ≈ 20, so the states reach 5e3 and the rnd 4e6 over K = 12 float32
    # steps: each output within 1e-4 of its largest magnitude (measured 2.4e-5)
    for got, want in ((xt_t, xt_j), (rnd_t, rnd_j), (xs_t, xs_j)):
        want = np.asarray(want)
        assert bool(torch.isfinite(got).all())
        assert np.abs(N(got) - want).max() <= 1e-4 * np.abs(want).max()
