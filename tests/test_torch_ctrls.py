"""The port's target-informed controls and their helpers held against the
JAX package: ``AngleEncoding``, the angle-encoded ``FourierMLP``,
``DenseNet``, ``ScoreCtrl``, ``CancelDriftCtrl``, ``LerpCtrl`` (free and
hard-constrained), ``remove_reference_ctrl`` and ``make_ctrl`` for every
model type on both base architectures, each with the JAX module's
parameters carried across by ``load_flax_params``; ``compute_divx`` exact
and Hutchinson under fed probes and ``compute_gradx``; and the LV loss's
exploration hooks ``_sde_ctrl`` (noise, dropout) under fed draws.

The JAX parameters are perturbed from their near-zero init (by 0.05
normals) so every term counts. Controls agree at rtol = 1e-4, atol = 5e-5
in float32: the TwoModes score is a float32 softmax over its components
and reaches 10, and the nets sum 16 to 64 products in another order
(measured 3.2e-5 relative, 1.6e-5 absolute); the divergences at rtol = 1e-4, atol = 1e-4 (a sum of D
products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch import models as tm
from sde_sampler_lrds_torch.losses.rds import EMReferenceSDELoss as TEM
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.utils.autograd import compute_divx as t_divx
from sde_sampler_lrds_torch.utils.autograd import compute_gradx as t_gradx
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu import models as jm
from sde_sampler_lrds_tpu.losses.rds import EMReferenceSDELoss as JEM
from sde_sampler_lrds_tpu.models.mlp import AngleEncoding, DenseNet
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.utils.autograd import compute_divx, compute_gradx

DIM = 3
TOL = dict(rtol=1e-4, atol=5e-5)


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _targets():
    details = j_api.make_target_details("two_modes", dim=DIM)
    return j_api.make_target(details), t_api.make_target(details, device="cpu")


def _perturbed(module, seed=0, scale=0.05):
    """Flax params of ``module`` moved off their near-zero init."""
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [p + scale * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _inputs(seed=2, b=16, k=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=1.5, size=(b, DIM)).astype(np.float32)
    xs = rng.normal(scale=1.5, size=(k, b, DIM)).astype(np.float32)
    tk = np.linspace(0.05, 0.95, k).astype(np.float32)
    return x, xs, tk


def _check_ctrl(j_apply, t_ctrl):
    """One time, per-row times and per-step times over flat states."""
    x, xs, tk = _inputs()
    with torch.no_grad():
        for tt in (0.0, 0.37, 1.0):
            np.testing.assert_allclose(N(t_ctrl(torch.tensor(tt), T(x))),
                                       j_apply(jnp.float32(tt), x), **TOL)
        rows = np.linspace(0.0, 1.0, x.shape[0]).astype(np.float32)
        np.testing.assert_allclose(N(t_ctrl(T(rows), T(x))), j_apply(rows, x), **TOL)
        want = np.stack([j_apply(jnp.float32(t), x_k) for t, x_k in zip(tk, xs)])
        np.testing.assert_allclose(N(t_ctrl(T(tk)[:, None], T(xs))), want, **TOL)


def test_angle_encoding_and_angle_fourier_mlp_match_jax():
    x, _, _ = _inputs()
    np.testing.assert_allclose(N(tm.AngleEncoding()(T(x))),
                               AngleEncoding().apply({}, x), **TOL)
    j = jm.FourierMLP(dim=DIM, channels=16, use_angle_encoding=True)
    params = _perturbed(j)
    t = tm.FourierMLP(dim=DIM, channels=16, use_angle_encoding=True)
    assert t.x_embed.in_features == 2 * DIM
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    _check_ctrl(lambda tt, y: j.apply(params, tt, y), t)


@pytest.mark.parametrize("angle", [False, True])
def test_densenet_matches_jax(angle):
    j = DenseNet(dim=DIM, arch=(16, 8), use_angle_encoding=angle, zero_init=True)
    params = _perturbed(j)
    t = tm.DenseNet(dim=DIM, arch=(16, 8), use_angle_encoding=angle, zero_init=True)
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    _check_ctrl(lambda tt, y: j.apply(params, tt, y), t)


def _ctrl_pair(model_type, base_arch=None):
    jt, tt = _targets()
    j_sde, t_sde = VP(diff_coeff_sq_max=10.0), TVP(diff_coeff_sq_max=10.0)
    j_prior = j_api.IsotropicGauss(dim=DIM, scale=1.3)
    t_prior = t_api.IsotropicGauss(dim=DIM, scale=1.3, device="cpu")
    j = j_api.make_ctrl(model_type, DIM, jt, j_prior, j_sde, base_arch=base_arch)
    t = t_api.make_ctrl(model_type, DIM, tt, t_prior, t_sde, base_arch=base_arch)
    return j, t, (j_sde, t_sde)


@pytest.mark.parametrize("base_arch", [None, "densenet"])
@pytest.mark.parametrize("model_type", ["base_zero_init", "target_informed_zero_init",
                                        "target_informed_langevin_init",
                                        "target_informed_lerp_tempering"])
def test_make_ctrl_matches_jax(model_type, base_arch):
    """Each model type's control with the JAX control's perturbed
    parameters; the class and the scale net's shape follow JAX."""
    j, t, _ = _ctrl_pair(model_type, base_arch)
    assert type(t).__name__ == type(j).__name__
    params = _perturbed(j)
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    _check_ctrl(lambda tt, y: j.apply(params, tt, y), t)


@pytest.mark.parametrize("val", [None, 1.0])
def test_time_embed_scale_model_init(val):
    """The scale net's last layer starts near zero with its bias at val:
    the output is within 1e-6 · √(64)/√(64)·(1 + ‖h‖) of val at any time."""
    t = t_api._time_embed_scale_model(val)
    t.reset_parameters(torch.Generator().manual_seed(0))
    out = N(t(torch.linspace(0.0, 1.0, 7)))
    assert out.shape == (7, 1)
    np.testing.assert_allclose(out, 0.0 if val is None else val, atol=1e-4)
    j = j_api._time_embed_scale_model(val)
    jp = j.init(jax.random.PRNGKey(0), jnp.zeros((7,)))
    np.testing.assert_allclose(np.asarray(j.apply(jp, jnp.linspace(0.0, 1.0, 7))),
                               0.0 if val is None else val, atol=1e-4)


@pytest.mark.parametrize("hard", [False, True])
def test_lerp_hard_constrain_matches_jax(hard):
    jt, tt = _targets()
    j_sde, t_sde = VP(diff_coeff_sq_max=10.0, terminal_t=2.0), TVP(diff_coeff_sq_max=10.0,
                                                                    terminal_t=2.0)
    prior_j = lambda y: -y / 2.0
    j = jm.LerpCtrl(base_model=jm.FourierMLP(dim=DIM, channels=16), clip_model=1e4,
                    clip_score=1e4, target_score=jt.score, prior_score=prior_j,
                    score_model=jm.TimeEmbed(dim_out=1, channels=16, num_layers=3),
                    detach_score=True, sde=j_sde, hard_constrain=hard)
    t = tm.LerpCtrl(base_model=tm.FourierMLP(dim=DIM, channels=16), clip_model=1e4,
                    clip_score=1e4, target_score=tt.score, prior_score=prior_j,
                    score_model=tm.TimeEmbed(dim_out=1, channels=16, num_layers=3),
                    detach_score=True, sde=t_sde, hard_constrain=hard)
    params = _perturbed(j)
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    _check_ctrl(lambda tt_, y: j.apply(params, tt_, y), t)


def test_remove_reference_ctrl_matches_jax():
    jt, tt = _targets()
    j_sde, t_sde = VP(diff_coeff_sq_max=10.0), TVP(diff_coeff_sq_max=10.0)
    ref_j = lambda s, y: -(y - 0.5) / (1.0 + s)
    ref_t = lambda s, y: -(y - 0.5) / (1.0 + torch.as_tensor(s)[..., None]
                                       if torch.as_tensor(s).ndim else 1.0 + s)
    ctrl = lambda s, y: 0.2 * y + 0.1
    for rescale in (True, False):
        j = jm.remove_reference_ctrl(ctrl, ref_j, use_rescaling=rescale, sde=j_sde)
        t = tm.remove_reference_ctrl(ctrl, ref_t, use_rescaling=rescale, sde=t_sde)
        x, xs, tk = _inputs()
        np.testing.assert_allclose(N(t(torch.tensor(0.4), T(x))), j(jnp.float32(0.4), x),
                                   **TOL)
        want = np.stack([j(jnp.float32(s), x_k) for s, x_k in zip(tk, xs)])
        np.testing.assert_allclose(N(t(T(tk)[:, None], T(xs))), want, **TOL)


def test_score_ctrl_detach_score_cuts_the_x_gradient():
    """detach_score keeps ∇ₓ of the target-score term out of the control's
    x-gradient, as jax.lax.stop_gradient does."""
    _, tt = _targets()
    for detach in (True, False):
        ctrl = tm.ScoreCtrl(base_model=tm.FourierMLP(dim=DIM, channels=8, zero_init=True),
                            target_score=tt.score, detach_score=detach)
        x = torch.randn(4, DIM, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
        (g,) = torch.autograd.grad(ctrl(torch.tensor(0.3), x).sum(), x)
        assert (float(g.abs().max()) < 1e-4) == detach


@pytest.mark.parametrize("noise_type", [None, "rademacher", "gaussian"])
def test_compute_divx_matches_jax(noise_type):
    """The divergence of a nonlinear field, exact or Hutchinson under the
    JAX estimator's own probe (fed to the port), and its gradient through
    the field's parameters."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(DIM, DIM)).astype(np.float32)
    x = rng.normal(size=(32, DIM)).astype(np.float32)
    j_f = lambda t, y: jnp.tanh(y @ w) * (1.0 + t)
    key = jax.random.PRNGKey(9)
    div_j, out_j = compute_divx(j_f, jnp.float32(0.5), jnp.asarray(x), key=key,
                                noise_type=noise_type)
    probe = None
    if noise_type == "rademacher":
        probe = T(np.asarray(jax.random.rademacher(key, x.shape, dtype=jnp.float32)))
    elif noise_type == "gaussian":
        probe = T(np.asarray(jax.random.normal(key, x.shape)))
    wt = T(w).requires_grad_(True)
    t_f = lambda t, y: torch.tanh(y @ wt) * (1.0 + t)
    div_t, out_t = t_divx(t_f, torch.tensor(0.5), T(x), noise_type=noise_type, probe=probe)
    np.testing.assert_allclose(N(div_t), np.asarray(div_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(out_t), np.asarray(out_j), **TOL)
    # the gradient of Σ div through the parameters
    g_j = jax.grad(lambda ww: compute_divx(lambda t, y: jnp.tanh(y @ ww) * (1.0 + t),
                                           jnp.float32(0.5), jnp.asarray(x), key=key,
                                           noise_type=noise_type)[0].sum())(jnp.asarray(w))
    (g_t,) = torch.autograd.grad(div_t.sum(), wt)
    np.testing.assert_allclose(N(g_t), np.asarray(g_j), rtol=1e-4, atol=1e-4)
    if noise_type is not None:   # a drawn probe has the probe's moments
        d, _ = t_divx(t_f, torch.tensor(0.5), T(x).repeat(2000, 1),
                      generator=torch.Generator().manual_seed(0), noise_type=noise_type)
        exact, _ = t_divx(t_f, torch.tensor(0.5), T(x))
        err = abs(float(d.mean()) - float(exact.mean()))
        assert err < 5 * float(d.std()) / np.sqrt(d.shape[0])
    with pytest.raises(ValueError, match="noise type"):
        t_divx(t_f, 0.5, T(x), noise_type="nope")


def test_compute_gradx_matches_jax():
    x = np.random.default_rng(8).normal(size=(16, DIM)).astype(np.float32)
    j_f = lambda t, y: jnp.sum(jnp.sin(y) * y, axis=-1) * t
    t_f = lambda t, y: torch.sum(torch.sin(y) * y, dim=-1) * t
    g_j, v_j = compute_gradx(j_f, 2.0, jnp.asarray(x))
    g_t, v_t = t_gradx(t_f, 2.0, T(x))
    np.testing.assert_allclose(N(g_t), np.asarray(g_j), **TOL)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), **TOL)


@pytest.mark.parametrize("hooks", [{"sde_ctrl_noise": 0.3}, {"sde_ctrl_dropout": 0.4},
                                   {"sde_ctrl_noise": 0.3, "sde_ctrl_dropout": 0.4}])
def test_sde_ctrl_hooks_match_jax(hooks):
    """The detached simulation control with exploration noise and / or
    dropout, the port fed the JAX hook's draws (noise first, then the
    dropout uniforms, each from its own split of the key)."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(64, DIM)).astype(np.float32)
    x = rng.normal(size=(64, DIM)).astype(np.float32)
    j = JEM(sde=VP(diff_coeff_sq_max=10.0), method="lv", **hooks)
    t = TEM(sde=TVP(diff_coeff_sq_max=10.0), method="lv", **hooks)
    key = jax.random.PRNGKey(3)
    want = j._sde_ctrl(jnp.asarray(u), key, jnp.float32(0.6), jnp.asarray(x))
    k, noise, uniform = key, None, None
    if "sde_ctrl_noise" in hooks:
        k, sub = jax.random.split(k)
        noise = T(np.asarray(jax.random.normal(sub, u.shape)))
    if "sde_ctrl_dropout" in hooks:
        k, sub = jax.random.split(k)
        uniform = T(np.asarray(jax.random.uniform(sub, u.shape)))
    ut = T(u).requires_grad_(True)
    got = t._sde_ctrl(ut, None, torch.tensor(0.6), T(x), noise=noise, uniform=uniform)
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
    assert not got.requires_grad
    with pytest.raises(ValueError, match="hooks"):
        t._flat_lv_setup(None, torch.linspace(0, 1, 3), T(x))
