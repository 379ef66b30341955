"""The port's fused trajectory (build_plan tables and the kernel's plain
version) held against the JAX package's ``build_plan`` and Pallas kernel.

The JAX kernel runs in Pallas interpret mode on the CPU, as the JAX
package's own tests run it. Both sides get the same control weights (carried
across with ``load_flax_params``), the same reference and the same noise.
The CUDA kernel itself runs only on the card: chip_smoke.py holds it against
its plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import losses as t_losses
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.ops import fused_traj as t_ft
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.solvers import GaussianReferenceCtrl as TGaussRef
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GaussianReferenceCtrl, GMMReferenceCtrl

DIM, K, H = 3, 12, 16
LOSSES = {"ei": "EIReferenceSDELoss", "ddpm": "DDPMLikeReferenceSDELoss",
          "em": "EMReferenceSDELoss"}


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _setup(family="ei", ref_kind="gmm", clip=1e4, seed=0):
    """The same (loss, control, reference) triple in both packages."""
    base = FourierMLP(dim=DIM, channels=H, num_layers=3)
    ctrl = ClippedCtrl(base_model=base, clip_model=clip) if clip else base
    params = jax.tree.map(np.asarray, ctrl.init(
        jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM))))
    t_base = TFourier(dim=DIM, channels=H, num_layers=3)
    t_ctrl = TClipped(t_base, clip_model=clip) if clip else t_base
    load_flax_params(t_ctrl, params)
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    rng = np.random.default_rng(seed + 1)
    if ref_kind == "gauss":
        loc = rng.normal(size=DIM).astype(np.float32)
        var = (0.5 + rng.random(DIM)).astype(np.float32)
        ref = GaussianReferenceCtrl(sde, jnp.asarray(loc), jnp.asarray(var))
        t_ref = TGaussRef(t_sde, T(loc), T(var))
    else:
        means = rng.normal(size=(3, DIM)).astype(np.float32)
        variances = (0.5 + rng.random((3, DIM))).astype(np.float32)
        weights = (0.5 + rng.random(3)).astype(np.float32)
        ref = GMMReferenceCtrl(sde, jnp.asarray(means), jnp.asarray(variances),
                               jnp.asarray(weights))
        t_ref = TGMMRef(t_sde, T(means), T(variances), T(weights))
    loss = getattr(j_losses, LOSSES[family])(sde=sde, method="kl", reference_ctrl=ref)
    t_loss = getattr(t_losses, LOSSES[family])(sde=t_sde, method="kl", reference_ctrl=t_ref)
    ts = get_timesteps(0.0, 1.0, steps=K)
    t_ts = T(ts)  # the same grid values on both sides
    return (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts)


def _inputs(batch, seed=2):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, DIM)).astype(np.float32)
    noise = rng.normal(size=(K, batch, DIM)).astype(np.float32)
    return x0, noise


@pytest.mark.parametrize("family", ["ei", "ddpm", "em"])
@pytest.mark.parametrize("ref_kind", ["gmm", "gauss"])
@pytest.mark.parametrize("clip", [0.05, None])
def test_build_plan_tables(family, ref_kind, clip):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(family, ref_kind, clip)
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=128)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert (cfg_t.k_steps, cfg_t.dim, cfg_t.channels, cfg_t.n_hidden, cfg_t.n_comp,
            cfg_t.clip) == (cfg_j.k_steps, cfg_j.dim, cfg_j.channels, cfg_j.n_hidden,
                            cfg_j.n_comp, cfg_j.clip)
    assert set(arr_t) == set(arr_j)
    # weights were copied bit for bit
    for name in ("w0", "b0", "wh", "bh", "w_out", "b_out"):
        np.testing.assert_array_equal(N(arr_t[name]), np.asarray(arr_j[name]), err_msg=name)
    # float32 schedule transcendentals (expm1, tanh, sqrt) in two libraries
    np.testing.assert_allclose(N(arr_t["coefs"]), arr_j["coefs"], rtol=2e-5, atol=1e-7)
    # the time MLP's frequencies differ by ≤1 ulp between linspace versions
    np.testing.assert_allclose(N(arr_t["embed"]), arr_j["embed"], rtol=1e-5, atol=5e-6)
    for name in ("ref_const", "ref_m", "ref_iv"):
        np.testing.assert_allclose(N(arr_t[name]), arr_j[name], rtol=2e-5, atol=1e-6,
                                   err_msg=name)


def test_build_plan_out_of_scope():
    (_, _, _, _), (t_loss, t_ctrl, t_ts) = _setup()
    # another network: outside the kernel's scope, as in the JAX package
    assert t_ft.build_plan(t_loss, torch.nn.Linear(DIM, DIM), t_ts) is None
    # a raw full-covariance reference is in scope: eigendecomposed at plan
    # time into the kernel's full-covariance mode, as in the JAX package
    t_loss.reference_ctrl = TGaussRef(TVP(0.1, 10.0), torch.zeros(DIM), torch.eye(DIM))
    cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert cfg.full_cov and arrays["ref_p"].shape == (DIM, DIM)
    # a non-tabulated callable reference is not
    t_loss.reference_ctrl = lambda t, x: -x
    assert t_ft.build_plan(t_loss, t_ctrl, t_ts) is None


# a batch that is not a multiple of the JAX kernel's 128-lane tile, so the
# JAX side runs its padded two-tile path
BATCH = 200


@pytest.mark.parametrize("family,ref_kind", [("ei", "gmm"), ("ddpm", "gmm"),
                                             ("em", "gauss")])
def test_plain_matches_jax_kernel(family, ref_kind):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(family, ref_kind)
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=128)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    x0, noise = _inputs(BATCH)
    xt_j, rnd_j, xs_j = j_ft._fused_traj(cfg_j, arr_j, jnp.asarray(x0),
                                         jnp.asarray(noise), True, True)
    xt_t, rnd_t, xs_t = t_ft.fused_traj(cfg_t, arr_t, T(x0), noise=T(noise),
                                        return_traj=True)
    # K = 12 steps of float32 MLP + mixture-score arithmetic, summed in other
    # orders; the tables themselves differ by a few ulps (see above)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(xt_t), xt_j, **tol)
    np.testing.assert_allclose(N(rnd_t), rnd_j, **tol)
    np.testing.assert_allclose(N(xs_t), xs_j, **tol)
    np.testing.assert_array_equal(N(xs_t[0]), x0)  # pre-step states
    # the JAX public entry points on the same inputs
    xs_s, xt_s = j_ft.fused_traj_states(cfg_j, arr_j, jnp.asarray(x0), jnp.asarray(noise))
    np.testing.assert_allclose(N(xs_t), xs_s, **tol)
    np.testing.assert_allclose(N(xt_t), xt_s, **tol)
    term = lambda x: -0.5 * jnp.sum(x**2, axis=-1)
    t_term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    x_f, r_f = j_ft.fused_simulate(cfg_j, arr_j, None, jnp.asarray(x0), term,
                                   noise=jnp.asarray(noise))
    x_p, r_p = t_ft.fused_simulate(cfg_t, arr_t, None, T(x0), t_term, noise=T(noise))
    np.testing.assert_allclose(N(x_p), x_f, **tol)
    np.testing.assert_allclose(N(r_p), r_f, **tol)


@pytest.mark.parametrize("family", ["ei", "ddpm", "em"])
def test_plain_matches_loss_simulate(family):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(family)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    x0, noise = _inputs(64, seed=3)
    term = lambda x: -0.5 * jnp.sum(x**2, axis=-1)
    ref_lp = lambda x: -0.6 * jnp.sum((x - 0.1) ** 2, axis=-1)
    t_term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    t_ref_lp = lambda x: -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)
    x_s, r_s, xs_s = loss.simulate(jax.random.PRNGKey(7), ts, jnp.asarray(x0),
                                   lambda t, x: ctrl.apply(params, t, x), term, ref_lp,
                                   return_traj=True, noise=jnp.asarray(noise))
    with torch.no_grad():
        x_l, r_l, xs_l = t_loss.simulate(None, t_ts, T(x0), t_ctrl, t_term, t_ref_lp,
                                         return_traj=True, noise=T(noise))
    x_p, r_p = t_ft.fused_simulate(cfg_t, arr_t, None, T(x0), t_term, t_ref_lp,
                                   noise=T(noise))
    # float32 K-step accumulation; the plain kernel and the loss loop sum the
    # same terms in other orders and use tabulated vs recomputed time features
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(x_l), x_s, **tol)
    np.testing.assert_allclose(N(r_l), r_s, **tol)
    np.testing.assert_allclose(N(xs_l), xs_s, **tol)
    np.testing.assert_allclose(N(x_p), x_s, **tol)
    np.testing.assert_allclose(N(r_p), r_s, **tol)


def test_wrapper_takes_plain_version_on_cpu_only():
    (_, _, _, _), (t_loss, t_ctrl, t_ts) = _setup()
    cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    x0, noise = _inputs(8)
    before = t_ft.fused_traj.launches
    a = t_ft.fused_traj(cfg, arrays, T(x0), noise=T(noise))
    b = t_ft.fused_traj_plain(cfg, arrays, T(x0), noise=T(noise))
    np.testing.assert_array_equal(N(a[1]), N(b[1]))
    assert t_ft.fused_traj.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        t_ft.fused_traj(cfg, arrays, T(x0).to("meta"), noise=T(noise))
    # noise drawn from a generator when none is fed
    g = torch.Generator().manual_seed(0)
    x1, _, _ = t_ft.fused_traj(cfg, arrays, T(x0), generator=g)
    x2, _, _ = t_ft.fused_traj(cfg, arrays, T(x0), generator=g.manual_seed(0))
    np.testing.assert_array_equal(N(x1), N(x2))
