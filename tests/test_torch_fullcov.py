"""The port's full-covariance pieces held against the JAX package: the
Gaussian / MoG densities and scores (from full matrices and from
precomputed precisions), the noised marginals in full-matrix and
eigen-factored (eig, P) form, the reference controls' per-step tables and
their flat evaluation, full-covariance EM, the log-SNR time grid, and the
fused trajectory's eigen-factored mode: the port's build_plan + plain
version against the JAX Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU. The CUDA kernel itself runs only on
the card: chip_smoke.py holds it against its plain version there.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch import losses as t_losses
from sde_sampler_lrds_torch.losses import flat_ctrl_eval as t_flat_ctrl_eval
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.ops import fused_traj as t_ft
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import GaussianReferenceCtrl as TGaussRef
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.targets import gauss as t_gauss
from sde_sampler_lrds_torch.utils.gmm_fit import fit_gmm_em as t_fit_gmm_em
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.losses.base import flat_ctrl_eval
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GaussianReferenceCtrl, GMMReferenceCtrl
from sde_sampler_lrds_tpu.targets import gauss as j_gauss
from sde_sampler_lrds_tpu.utils.gmm_fit import fit_gmm_em


def T(a):
    if isinstance(a, tuple):
        return tuple(T(v) for v in a)
    return torch.as_tensor(np.array(a))


def J(a):
    if isinstance(a, tuple):
        return tuple(J(v) for v in a)
    return jnp.asarray(a)


def N(t):
    return t.detach().cpu().numpy()


def _mixture(d, c=3, batch=64, seed=0):
    """Means, well-conditioned full covariances, weights and query points."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(c, d)).astype(np.float32)
    a = rng.normal(size=(c, d, d))
    covs = (a @ a.transpose(0, 2, 1) / d + 0.5 * np.eye(d)).astype(np.float32)
    weights = (0.5 + rng.random(c)).astype(np.float32)
    x = (1.5 * rng.normal(size=(batch, d))).astype(np.float32)
    return means, covs, weights, x


def _eigh(covs):
    """(eig, P) from a float64 eigendecomposition, handed to both packages."""
    eig, p = np.linalg.eigh(covs.astype(np.float64))
    return eig.astype(np.float32), p.astype(np.float32)


def _step(tab, k):
    return tuple(_step(a, k) if isinstance(a, tuple) else a[k] for a in tab)


# float32 solves / rotations of matrices with condition numbers up to ~30,
# summed in other orders: log-densities of size ~10-50 to 1e-3, scores to 1e-4
LP_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [4, 16])
def test_full_densities_match_jax(d):
    means, covs, weights, x = _mixture(d)
    prec = np.linalg.inv(covs.astype(np.float64)).astype(np.float32)
    log_det = np.linalg.slogdet(covs.astype(np.float64))[1].astype(np.float32)
    for kw in ({}, {"precisions": prec, "covariances_log_det": log_det}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: T(v) for k, v in kw.items()}
        np.testing.assert_allclose(
            N(t_gauss.log_prob_gaussian_full(T(x), T(means), T(covs), **tkw)),
            j_gauss.log_prob_gaussian_full(J(x), J(means), J(covs), **jkw), **LP_TOL)
        np.testing.assert_allclose(
            N(t_gauss.mog_full_log_prob(T(x), T(weights), T(means), T(covs), **tkw)),
            j_gauss.mog_full_log_prob(J(x), J(weights), J(means), J(covs), **jkw), **LP_TOL)
        np.testing.assert_allclose(
            N(t_gauss.score_mog_full(T(x), T(weights), T(means), T(covs), **tkw)),
            j_gauss.score_mog_full(J(x), J(weights), J(means), J(covs), **jkw), **SCORE_TOL)
    for p in (None, prec[0]):
        np.testing.assert_allclose(
            N(t_gauss.score_gauss_full(T(x), T(means[0]), T(covs[0]),
                                       precisions=None if p is None else T(p))),
            j_gauss.score_gauss_full(J(x), J(means[0]), J(covs[0]),
                                     precisions=None if p is None else J(p)), **SCORE_TOL)


@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("form", ["matrix", "eig"])
@pytest.mark.parametrize("t", [0.0, 0.6])
def test_noised_marginals_match_jax(d, form, t):
    means, covs, weights, x = _mixture(d, seed=d)
    var = covs if form == "matrix" else _eigh(covs)
    var0 = covs[0] if form == "matrix" else _eigh(covs[0])
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    tj, tt = jnp.asarray(t, jnp.float32), torch.tensor(t)
    np.testing.assert_allclose(
        N(t_sde.marginal_gmm_log_prob(tt, T(x), T(means), T(var), T(weights))),
        sde.marginal_gmm_log_prob(tj, J(x), J(means), J(var), J(weights)), **LP_TOL)
    np.testing.assert_allclose(
        N(t_sde.marginal_gmm_score(tt, T(x), T(means), T(var), T(weights))),
        sde.marginal_gmm_score(tj, J(x), J(means), J(var), J(weights)), **SCORE_TOL)
    np.testing.assert_allclose(
        N(t_sde.marginal_log_prob(tt, T(x), T(means[0]), var_init=T(var0))),
        sde.marginal_log_prob(tj, J(x), J(means[0]), var_init=J(var0)), **LP_TOL)
    np.testing.assert_allclose(
        N(t_sde.marginal_score(tt, T(x), T(means[0]), var_init=T(var0))),
        sde.marginal_score(tj, J(x), J(means[0]), var_init=J(var0)), **SCORE_TOL)


def _references(kind, form, d=4, seed=0):
    """The same full-covariance reference control in both packages."""
    means, covs, weights, _ = _mixture(d, seed=seed)
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    if kind == "gauss":
        var = covs[0] if form == "matrix" else _eigh(covs[0])
        return (GaussianReferenceCtrl(sde, J(means[0]), J(var)),
                TGaussRef(t_sde, T(means[0]), T(var)))
    var = covs if form == "matrix" else _eigh(covs)
    return (GMMReferenceCtrl(sde, J(means), J(var), J(weights)),
            TGMMRef(t_sde, T(means), T(var), T(weights)))


@pytest.mark.parametrize("kind", ["gmm", "gauss"])
@pytest.mark.parametrize("form", ["matrix", "eig"])
def test_reference_ctrl_tables_and_flat_eval(kind, form):
    ref_j, ref_t = _references(kind, form)
    ts = get_timesteps(0.0, 1.0, steps=6)
    t_grid = ts[-1] - ts[:-1]
    tab_j, tab_t = ref_j.precompute(t_grid), ref_t.precompute(T(t_grid))
    rng = np.random.default_rng(5)
    xs = (1.5 * rng.normal(size=(6, 16, 4))).astype(np.float32)
    for k in (0, 3, 5):
        np.testing.assert_allclose(
            N(ref_t.apply(_step(tab_t, k), T(xs[k]))),
            ref_j.apply(jax.tree.map(lambda a: a[k], tab_j), J(xs[k])), **SCORE_TOL)
        np.testing.assert_allclose(N(ref_t(T(t_grid[k]), T(xs[k]))),
                                   ref_j(t_grid[k], J(xs[k])), **SCORE_TOL)
    # over per-step states (K, B, D), in one call and through the chunked path
    want = flat_ctrl_eval(ref_j, t_grid, J(xs))
    for max_flat in (4_000_000, 1):
        np.testing.assert_allclose(N(t_flat_ctrl_eval(ref_t, T(t_grid), T(xs),
                                                      max_flat=max_flat)),
                                   want, **SCORE_TOL)


@pytest.mark.parametrize("kind", ["gmm", "gauss"])
@pytest.mark.parametrize("form", ["diag", "matrix", "eig"])
def test_reference_ctrl_one_step_chunk_matches_jax(kind, form):
    """flat_ctrl_eval past max_flat calls a reference control once per
    16-step chunk; on a grid of K = 33 (≡ 1 mod 16) steps the last chunk
    holds one step, (1, B, D) states at (1, 1) times. Each step's score,
    diagonal or full-covariance, is the JAX reference's score at that step's
    time and states (the port once took such a chunk for one time)."""
    means, covs, weights, _ = _mixture(4, seed=7)
    var = {"diag": np.diagonal(covs, axis1=-2, axis2=-1).copy(), "matrix": covs,
           "eig": _eigh(covs)}[form]
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    if kind == "gauss":
        var = var[0] if form != "eig" else tuple(a[0] for a in var)
        ref_j = GaussianReferenceCtrl(sde, J(means[0]), J(var))
        ref_t = TGaussRef(t_sde, T(means[0]), T(var))
    else:
        ref_j = GMMReferenceCtrl(sde, J(means), J(var), J(weights))
        ref_t = TGMMRef(t_sde, T(means), T(var), T(weights))
    k_steps = 33
    ts = get_timesteps(0.0, 1.0, steps=k_steps)
    t_grid = np.asarray(ts[-1] - ts[:-1])
    xs = (1.5 * np.random.default_rng(9).normal(size=(k_steps, 8, 4))).astype(np.float32)
    got = N(t_flat_ctrl_eval(ref_t, T(t_grid), T(xs), max_flat=1))
    assert got.shape == xs.shape
    for k in range(k_steps):
        np.testing.assert_allclose(got[k], ref_j(jnp.asarray(t_grid[k]), J(xs[k])),
                                   err_msg=f"step {k}", **SCORE_TOL)


def test_flat_ctrl_eval_chunked_matches_one_call_and_jax():
    """The flat control evaluation past max_flat: 16-step chunks,
    checkpointed under autograd, with the same values and gradients."""
    ctrl = FourierMLP(dim=4, channels=16, num_layers=4)
    params = jax.tree.map(np.asarray, ctrl.init(jax.random.PRNGKey(1), jnp.zeros((2,)),
                                                jnp.zeros((2, 4))))
    t_ctrl = load_flax_params(TFourier(dim=4, channels=16, num_layers=4), params)
    t_grid = np.linspace(0.9, 0.05, 40).astype(np.float32)
    xs = np.random.default_rng(2).normal(size=(40, 8, 4)).astype(np.float32)
    want = flat_ctrl_eval(lambda t, x: ctrl.apply(params, t, x), J(t_grid), J(xs),
                          max_flat=1)
    outs, grads = [], []
    for max_flat in (4_000_000, 1):
        t_ctrl.zero_grad()
        u = t_flat_ctrl_eval(t_ctrl, T(t_grid), T(xs), max_flat=max_flat)
        (u**2).sum().backward()
        outs.append(N(u))
        grads.append([N(p.grad).copy() for p in t_ctrl.parameters()])
    np.testing.assert_allclose(outs[1], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)
    for g0, g1 in zip(*grads):
        np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=1e-6 * np.abs(g0).max())


def test_fit_gmm_full_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 4, 4))
    chol = a / 2 + np.eye(4)
    centres = np.array([[4.0, 0.0, 2.0, -2.0], [-4.0, 2.0, 0.0, 2.0]])
    lab = rng.random(2000) < 0.35
    z = rng.normal(size=(2000, 4))
    data = np.where(lab[:, None], centres[0] + z @ chol[0].T,
                    centres[1] + z @ chol[1].T).astype(np.float32)
    means_init = data[[int(np.argmax(lab)), int(np.argmin(lab))]]
    w_j, m_j, v_j, ll_j = fit_gmm_em(2, J(data), means_init=J(means_init), em_type="full")
    w_t, m_t, v_t, ll_t = t_fit_gmm_em(2, T(data), means_init=T(means_init), em_type="full")
    # float32 EM iterations in two libraries, to the same fixed point
    np.testing.assert_allclose(N(w_t), w_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(m_t), m_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(v_t), v_j, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ll_t, float(ll_j), rtol=1e-5)
    # the entry point with its seeding and reg_covar sweep: full (K, D, D)
    w, m, v = t_api.fit_gmm(2, data, em_type="full", device="cpu")
    assert v.shape == (2, 4, 4) and abs(float(w.sum()) - 1.0) < 1e-5
    assert np.allclose(sorted(N(w)), sorted(w_j), atol=1e-3)
    with pytest.raises(ValueError, match="em_type"):
        t_fit_gmm_em(2, T(data), em_type="spherical")


@pytest.mark.parametrize("steps", [10, 100])
def test_log_snr_grid_matches_jax(steps):
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    ts_j = get_timesteps(1e-4, 1.0 - 1e-4, steps=steps, sde=sde)
    ts_t = t_get_timesteps(1e-4, 1.0 - 1e-4, steps=steps, sde=t_sde, device="cpu")
    # float32 bisection on log-SNRs that may differ by an ulp between libraries
    np.testing.assert_allclose(N(ts_t), ts_j, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(N(t_sde.log_snr(ts_t)), sde.log_snr(ts_j), rtol=1e-5, atol=1e-5)
    snr = N(t_sde.log_snr(ts_t))
    assert ts_t.dtype == torch.float32 and np.all(np.diff(snr) < 0)
    np.testing.assert_allclose(np.diff(snr), np.diff(snr).mean(), rtol=1e-3)


# -- the fused trajectory's eigen-factored mode -------------------------------

DIM, K, H, C = 8, 10, 16, 3
# two 128-lane tiles of the JAX kernel with a ragged end
BATCH = 200


def _setup(kind, form):
    base = FourierMLP(dim=DIM, channels=H, num_layers=4)
    ctrl = ClippedCtrl(base_model=base, clip_model=0.5)
    params = jax.tree.map(np.asarray, ctrl.init(jax.random.PRNGKey(3), jnp.zeros((2,)),
                                                jnp.zeros((2, DIM))))
    t_ctrl = load_flax_params(TClipped(TFourier(dim=DIM, channels=H, num_layers=4),
                                       clip_model=0.5), params)
    ref_j, ref_t = _references(kind, form, d=DIM, seed=11)
    sde, t_sde = ref_j.sde, ref_t.sde
    loss = j_losses.EIReferenceSDELoss(sde=sde, method="kl", reference_ctrl=ref_j)
    t_loss = t_losses.EIReferenceSDELoss(sde=t_sde, method="kl", reference_ctrl=ref_t)
    ts = get_timesteps(1e-4, 1.0 - 1e-4, steps=K, sde=sde)
    return (loss, ctrl, params, ts), (t_loss, t_ctrl, T(ts))


@pytest.mark.parametrize("kind,form", [("gmm", "matrix"), ("gmm", "eig"),
                                       ("gauss", "matrix"), ("gauss", "eig")])
def test_full_cov_plain_matches_jax_kernel(kind, form):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(kind, form)
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=128)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert cfg_j.full_cov and cfg_t.full_cov and set(arr_t) == set(arr_j)
    assert cfg_t.n_comp == (C if kind == "gmm" else 1)
    # eigenvalue tables: eigh sorts ascending in both libraries
    for name in ("ref_const", "ref_m", "ref_iv"):
        np.testing.assert_allclose(N(arr_t[name]), arr_j[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # rotations: torch and jax eigh may pick other signs (and orders among
    # equal eigenvalues), so compare the precision P diag(iv) Pᵀ they give
    c, d = cfg_t.n_comp, DIM

    def prec(p, iv):
        p = np.asarray(p).reshape(c, d, d)
        return np.einsum("cik,ck,cjk->cij", p, np.asarray(iv[0]).reshape(c, d), p)

    np.testing.assert_allclose(prec(N(arr_t["ref_p"]), N(arr_t["ref_iv"])),
                               prec(arr_j["ref_p"], arr_j["ref_iv"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(N(arr_t["ref_pt"]).reshape(c, d, d),
                                  N(arr_t["ref_p"]).reshape(c, d, d).transpose(0, 2, 1))
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    noise = rng.normal(size=(K, BATCH, DIM)).astype(np.float32)
    xt_j, rnd_j, xs_j = j_ft._fused_traj(cfg_j, arr_j, J(x0), J(noise), True, True)
    xt_t, rnd_t, xs_t = t_ft.fused_traj(cfg_t, arr_t, T(x0), noise=T(noise),
                                        return_traj=True)
    # K = 10 float32 steps of MLP and rotated mixture-score arithmetic summed
    # in other orders, on tables that differ by a few ulps
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(xt_t), xt_j, **tol)
    np.testing.assert_allclose(N(rnd_t), rnd_j, **tol)
    np.testing.assert_allclose(N(xs_t), xs_j, **tol)
    np.testing.assert_array_equal(N(xs_t[0]), x0)
    # the losses' own loops (the references' precompute / apply tables)
    term = lambda x: -0.5 * jnp.sum(x**2, axis=-1)
    t_term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    x_s, r_s, _ = loss.simulate(jax.random.PRNGKey(0), ts, J(x0[:64]),
                                lambda t, x: ctrl.apply(params, t, x), term, term,
                                noise=J(noise[:, :64]))
    with torch.no_grad():
        x_l, r_l, _ = t_loss.simulate(None, t_ts, T(x0[:64]), t_ctrl, t_term, t_term,
                                      noise=T(noise[:, :64]))
    np.testing.assert_allclose(N(x_l), x_s, **tol)
    np.testing.assert_allclose(N(r_l), r_s, **tol)
    np.testing.assert_allclose(N(x_l), N(xt_t[:64]), **tol)


def test_check_limits_covers_experiment_dims():
    """Every dim the experiments run (16, 32, 64, and φ⁴'s 100) fits at
    H = 64 with 2 hidden layers, in both modes. The diagonal mode's block
    holds the weights and a slice per warp (one warp of one trajectory at
    least: 90 752 bytes at D = 100), which takes it up to 364. The
    full-covariance mode's tile of 32 trajectories adds a ring of 2 panels
    of rows of P (36 rows at D = 100, 28 800 bytes) and the step's m, iv and
    const rows (816 bytes), which would take it to 131, and its rotations'
    one register tile per thread caps it at 128."""
    def cfg(d, full_cov):
        return t_ft.FusedTrajCfg(k_steps=100, dim=d, channels=64, n_hidden=2, n_comp=2,
                                 clip=1e4, full_cov=full_cov)

    assert t_ft.smem_bytes(100, 64, 2, full_cov=False) == 90_752
    assert t_ft.smem_bytes(8, 64, 2, full_cov=False) == 41_440
    assert t_ft.smem_bytes(100, 64, 2, full_cov=True) == 153_104 + 28_800 + 816
    assert t_ft.smem_bytes(8, 64, 2, full_cov=True) == 58_528 + 512 + 80
    assert t_ft.smem_bytes(131, 64, 2, full_cov=True) <= t_ft.MAX_SMEM_BYTES
    assert t_ft.smem_bytes(132, 64, 2, full_cov=True) > t_ft.MAX_SMEM_BYTES
    for full_cov, largest, why in ((False, 364, "shared memory"), (True, 128, "register tile")):
        for d in (8, 16, 32, 64, 100, largest):
            t_ft.check_limits(cfg(d, full_cov))
        with pytest.raises(ValueError, match=why):
            t_ft.check_limits(cfg(largest + 1, full_cov))
    with pytest.raises(ValueError, match="channels"):
        t_ft.check_limits(t_ft.FusedTrajCfg(k_steps=1, dim=8, channels=512, n_hidden=2,
                                            n_comp=1, clip=None))
