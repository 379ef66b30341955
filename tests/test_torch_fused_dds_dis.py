"""B1's plans for the other VI samplers held against the JAX package: the
port's ``_step_coeffs`` / ``build_plan`` tables for original DDS (on its
cosine grid, the Itô term on and off), discrete DIS (VP(0.1, 10)) and PIS's
EM plan (``ScaledBM`` without a reference score) against the JAX
``build_plan``; the port's plain fused trajectory on each plan against the
JAX Pallas kernel in interpret mode and against the port's own loss loop
under fed noise; and the fused KL path's value and gradient on DDS and
discrete DIS against autograd through ``simulate`` (the JAX package's own
check, tests/test_fused_traj.py).

Small sizes: d 3, H 16, K 12 (DDS: the cosine grid of 11 steps plus one),
batch 48. Tables agree at rtol = 1e-6 (atol 1e-7), the time-embed table
(an MLP's output on angles up to 500 rad) at rtol = 1e-5, atol = 1e-4;
trajectories and RNDs
at rtol = 2e-5, atol = 2e-4 (the JAX package's kernel-against-scan
tolerance); the fused KL at rtol = 1e-5 in value and, leaf by leaf,
rtol = 3e-4 with an atol of 2e-5 + 3e-6 of the leaf's largest magnitude
(the JAX test's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import losses as tl
from sde_sampler_lrds_torch import models as tm
from sde_sampler_lrds_torch import sde as ts_
from sde_sampler_lrds_torch.ops import fused_traj as t_ft
from sde_sampler_lrds_tpu import losses as jl
from sde_sampler_lrds_tpu import models as jm
from sde_sampler_lrds_tpu import sde as js
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft

DIM, H, K, B = 3, 16, 12, 48
TRAJ_TOL = dict(rtol=2e-5, atol=2e-4)
PLANS = ("dds_ito", "dds_no_ito", "dis_discrete", "pis_em")


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ctrl_pair():
    j = jm.ClippedCtrl(base_model=jm.FourierMLP(dim=DIM, channels=H), clip_model=1e4)
    params = j.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, DIM)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [p + 0.05 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    t = tm.ClippedCtrl(base_model=tm.FourierMLP(dim=DIM, channels=H), clip_model=1e4)
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    return j, params, t


def _plan_case(name, method="lv"):
    """(JAX loss, port loss, grid, ito, boundary kwargs name)."""
    if name.startswith("dds"):
        ts = np.asarray(js.get_timesteps(0.0, 1.6, steps=K - 2, rescale_t="cosine"))
        return (jl.ExponentialIntegratorSDELoss(alpha=1.0, sigma=1.3, method=method),
                tl.ExponentialIntegratorSDELoss(alpha=1.0, sigma=1.3, method=method),
                ts, name == "dds_ito", "reference_log_prob")
    ts = np.linspace(0.0, 1.0 if name == "dis_discrete" else 5.0, K + 1).astype(np.float32)
    if name == "dis_discrete":
        return (jl.DiscreteTimeReversalLossEI(sde=js.VP(diff_coeff_sq_max=10.0), method=method),
                tl.DiscreteTimeReversalLossEI(sde=ts_.VP(diff_coeff_sq_max=10.0), method=method),
                ts, True, "initial_log_prob")
    return (jl.EMReferenceSDELoss(sde=js.ScaledBM(diff_coeff=0.9, terminal_t=5.0), method=method),
            tl.EMReferenceSDELoss(sde=ts_.ScaledBM(diff_coeff=0.9, terminal_t=5.0), method=method),
            ts, True, "reference_log_prob")


@pytest.mark.parametrize("name", PLANS)
def test_plan_tables_match_jax(name):
    jloss, tloss, ts, ito, _ = _plan_case(name)
    j_mod, params, t_ctrl = _ctrl_pair()
    cfg_j, arr_j = j_ft.build_plan(jloss, j_mod, params, jnp.asarray(ts), ito=ito)
    cfg_t, arr_t = t_ft.build_plan(tloss, t_ctrl, T(ts), ito=ito)
    assert set(arr_t) == set(arr_j)
    assert (cfg_t.k_steps, cfg_t.dim, cfg_t.n_comp, cfg_t.full_cov) == (
        cfg_j.k_steps, cfg_j.dim, cfg_j.n_comp, cfg_j.full_cov) == (ts.shape[0] - 1, DIM, 1,
                                                                    False)
    for key in arr_j:
        # the time-embed table is TimeEmbed's MLP output on sin / cos of
        # angles up to 100·T = 500 rad (PIS), where one float32 ulp of the
        # angle is 3e-5 (measured 2.4e-5)
        tol = (dict(rtol=1e-5, atol=1e-4) if key == "embed"
               else dict(rtol=1e-6, atol=1e-7 if key == "coefs" else 1e-6))
        np.testing.assert_allclose(N(arr_t[key]), np.asarray(arr_j[key]), err_msg=key, **tol)
    coefs = N(arr_t["coefs"])
    # no reference score: the dummy table's inverse variances are 0 (PIS's
    # EM plan keeps its a_ref = g²dt against that zero score)
    assert not N(arr_t["ref_iv"]).any() and (name == "pis_em" or not coefs[:, 1].any())
    if name == "dds_no_ito":
        # the last cosine increment is ~0 (cos⁴ at π/2), so is its a_z
        assert not coefs[:, 5].any() and coefs[:-1, 3].all()
    t_coefs, t_ctrl_times = t_ft._step_coeffs(tloss, T(ts), ito=ito)
    want_times = ts[:-1] if name.startswith("dds") else ts[-1] - ts[:-1]
    np.testing.assert_allclose(N(t_ctrl_times), want_times, rtol=1e-6)


@pytest.mark.parametrize("name", PLANS)
def test_plain_fused_traj_matches_jax_kernel_and_scan(name):
    jloss, tloss, ts, ito, bnd = _plan_case(name)
    j_mod, params, t_ctrl = _ctrl_pair()
    cfg_j, arr_j = j_ft.build_plan(jloss, j_mod, params, jnp.asarray(ts), block_b=B // 2,
                                   ito=ito)
    cfg_t, arr_t = t_ft.build_plan(tloss, t_ctrl, T(ts), ito=ito)
    k = ts.shape[0] - 1
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=(B, DIM)).astype(np.float32)
    noise = rng.normal(size=(k, B, DIM)).astype(np.float32)
    xt_j, rnd_j, xs_j = j_ft._fused_traj(cfg_j, arr_j, jnp.asarray(x0), jnp.asarray(noise),
                                         True, True)
    xt_t, rnd_t, xs_t = t_ft.fused_traj(cfg_t, arr_t, T(x0), noise=T(noise), return_traj=True)
    for got, want in ((xt_t, xt_j), (rnd_t, rnd_j), (xs_t, xs_j)):
        np.testing.assert_allclose(N(got), np.asarray(want), **TRAJ_TOL)
    # the fused simulation with its boundary costs against the loss's loop
    term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    b_fn = lambda x: -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)
    x_f, r_f = t_ft.fused_simulate(cfg_t, arr_t, None, T(x0), term, noise=T(noise),
                                   **{bnd: b_fn})
    flags = {"compute_ito_int": ito} if name.startswith("dds") else (
        {"train": False} if name == "dis_discrete" else {})
    x_s, r_s, _ = tloss.simulate(None, T(ts), T(x0), t_ctrl, term, noise=T(noise),
                                 **{bnd: b_fn}, **flags)
    np.testing.assert_allclose(N(x_f), N(x_s), **TRAJ_TOL)
    np.testing.assert_allclose(N(r_f), N(r_s), **TRAJ_TOL)


@pytest.mark.parametrize("family", ["dds", "dis_discrete"])
def test_kl_fused_matches_autograd_through_simulate(family):
    """The fused KL's value and gradient against autograd through the
    loss's loop under the same noise (DDS trains plain KL without the Itô
    term; discrete DIS starts from rnd₀ = 0)."""
    name = "dds_no_ito" if family == "dds" else family
    _, tloss, ts, _, bnd = _plan_case(name, method="kl")
    ito = getattr(tloss, "fused_train_ito", True)
    assert ito is (family != "dds")
    _, _, t_ctrl = _ctrl_pair()
    k = ts.shape[0] - 1
    rng = np.random.default_rng(3)
    x0 = T(rng.normal(size=(B, DIM)).astype(np.float32))
    zs = T(rng.normal(size=(k, B, DIM)).astype(np.float32))
    term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    b_fn = lambda x: -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)
    flags = {"compute_ito_int": ito} if family == "dds" else {"train": True}
    x_t, rnd, _ = tloss.simulate(None, T(ts), x0, t_ctrl, term, noise=zs, **{bnd: b_fn},
                                 **flags)
    v_scan = tloss.reduce(rnd, samples=x_t)[0]
    g_scan = torch.autograd.grad(v_scan, list(t_ctrl.parameters()))
    cfg, arrays = t_ft.build_plan(tloss, t_ctrl, T(ts), differentiable=True, ito=ito)
    fn = lambda a, b: t_ft.fused_kl_traj(cfg, arrays, a, b)
    v_fused, _ = tloss.kl_fused_call(None, T(ts), x0, t_ctrl, term, traj_rnd_fn=fn,
                                     noise=zs, **{bnd: b_fn})
    g_fused = torch.autograd.grad(v_fused, list(t_ctrl.parameters()))
    np.testing.assert_allclose(float(v_fused.detach()), float(v_scan.detach()), rtol=1e-5,
                               atol=1e-5)
    for (pname, _), gf, gs in zip(t_ctrl.named_parameters(), g_fused, g_scan):
        gs = N(gs)
        np.testing.assert_allclose(N(gf), gs, rtol=3e-4,
                                   atol=2e-5 + 3e-6 * np.abs(gs).max(), err_msg=pname)
