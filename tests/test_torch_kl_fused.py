"""Fused KL training in the port — ``kl_fused_call`` through
``fused_kl_traj``, whose forward is the fused trajectory (the CUDA kernel
on the card, its plain version here) and whose backward is the adjoint loop
— held against the JAX package's ``kl_fused_call`` + ``fused_kl_traj``
(Pallas forward in interpret mode, ``lax.scan`` adjoint) and against autograd
through the port's own ``loss.simulate``, in value and in every parameter
gradient; then the solver's routing.

Both packages get the same control weights (``load_flax_params``), the same
reference, x0 and per-step noise, made with numpy from a seed. The port's
TimeEmbed frequencies are set to ``jnp.linspace``'s, which differs from
``torch.linspace`` by up to an ulp (ROADMAP §C), so that the two packages
tabulate the same time embedding.
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
from sde_sampler_lrds_torch.solvers import RDS as TRDS
from sde_sampler_lrds_torch.solvers import GaussianReferenceCtrl as TGaussRef
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsoGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GaussianReferenceCtrl, GMMReferenceCtrl

DIM, K, B, H = 4, 12, 64, 16
LOSSES = {"ei": "EIReferenceSDELoss", "ddpm": "DDPMLikeReferenceSDELoss",
          "em": "EMReferenceSDELoss"}
# JAX's own tolerances for fused KL against the scan (tests/test_fused_traj.py)
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=3e-4, atol=2e-5)


def T(a):
    if isinstance(a, tuple):
        return tuple(T(v) for v in a)
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _mixture(seed, full):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(3, DIM)).astype(np.float32)
    weights = (0.5 + rng.random(3)).astype(np.float32)
    if full:
        a = rng.normal(size=(3, DIM, DIM))
        covs = a @ a.transpose(0, 2, 1) / DIM + 0.5 * np.eye(DIM)
        eig, p = np.linalg.eigh(covs)
        return means, (eig.astype(np.float32), p.astype(np.float32)), weights
    return means, (0.5 + rng.random((3, DIM))).astype(np.float32), weights


def _setup(family="ei", ref_kind="gmm", clip=1e4, seed=0, **loss_kw):
    """The same KL loss, control and reference in both packages."""
    base = FourierMLP(dim=DIM, channels=H, num_layers=4)
    ctrl = ClippedCtrl(base_model=base, clip_model=clip) if clip else base
    params = jax.tree.map(np.asarray, ctrl.init(
        jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM))))
    t_base = TFourier(dim=DIM, channels=H, num_layers=4)
    t_ctrl = TClipped(t_base, clip_model=clip) if clip else t_base
    load_flax_params(t_ctrl, params)
    t_base.time_embed.coeff.copy_(T(jnp.linspace(0.1, 100.0, H)[None, :]))
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    if ref_kind == "gauss":
        rng = np.random.default_rng(seed + 1)
        loc = rng.normal(size=DIM).astype(np.float32)
        var = (0.5 + rng.random(DIM)).astype(np.float32)
        ref = GaussianReferenceCtrl(sde, jnp.asarray(loc), jnp.asarray(var))
        t_ref = TGaussRef(t_sde, T(loc), T(var))
    else:
        means, var, weights = _mixture(seed + 1, full=ref_kind == "gmm_full")
        j_var = tuple(map(jnp.asarray, var)) if isinstance(var, tuple) else jnp.asarray(var)
        ref = GMMReferenceCtrl(sde, jnp.asarray(means), j_var, jnp.asarray(weights))
        t_ref = TGMMRef(t_sde, T(means), T(var), T(weights))
    loss = getattr(j_losses, LOSSES[family])(sde=sde, method="kl", max_rnd=1e8,
                                             reference_ctrl=ref, **loss_kw)
    t_loss = getattr(t_losses, LOSSES[family])(sde=t_sde, method="kl", max_rnd=1e8,
                                               reference_ctrl=t_ref, **loss_kw)
    ts = get_timesteps(0.0, 0.96 if family == "ddpm" else 1.0, steps=K)
    return (loss, ctrl, params, ts), (t_loss, t_ctrl, T(ts))


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, DIM)).astype(np.float32)
    zs = rng.normal(size=(K, B, DIM)).astype(np.float32)
    return x0, zs


def term(x):
    return -0.5 * jnp.sum(x**2, axis=-1)


def ref_lp(x):
    return -0.6 * jnp.sum((x - 0.1) ** 2, axis=-1)


def t_term(x):
    return -0.5 * torch.sum(x**2, dim=-1)


def t_ref_lp(x):
    return -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)


def _grads_as_flax(ctrl):
    """The port's parameter gradients laid out as the Flax param tree."""
    base = ctrl.base_model if isinstance(ctrl, TClipped) else ctrl
    lin = lambda l: {"kernel": N(l.weight.grad).T, "bias": N(l.bias.grad)}
    tree = {"Dense_0": lin(base.x_embed), f"Dense_{base.num_layers - 1}": lin(base.out)}
    tree.update({f"Dense_{i}": lin(l) for i, l in enumerate(base.hidden, start=1)})
    te = base.time_embed
    tree["TimeEmbed_0"] = {f"Dense_{i}": lin(l) for i, l in enumerate([*te.dense, te.out])}
    tree["TimeEmbed_0"]["timestep_phase"] = N(te.timestep_phase.grad)
    return {"params": {"base_model": tree} if isinstance(ctrl, TClipped) else tree}


def _port_fused(t_loss, t_ctrl, t_ts, x0, zs):
    """Value and parameter gradients of the port's kl_fused_call."""
    t_ctrl.zero_grad()
    cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts, differentiable=True)
    fn = lambda x0_, zs_: t_ft.fused_kl_traj(cfg, arrays, x0_, zs_)
    value, _ = t_loss.kl_fused_call(None, t_ts, T(x0), None, t_term, t_ref_lp,
                                    traj_rnd_fn=fn, noise=T(zs))
    value.backward()
    return float(value.detach()), _grads_as_flax(t_ctrl)


def _assert_grads_close(got, want):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


CASES = [("ei", "gmm", 1e4, {}), ("ddpm", "gmm", 1e4, {}),
         ("em", "gmm", 1e4, {"use_rescaling": True}),
         ("em", "gmm", 1e4, {"use_rescaling": False}),
         ("ei", "gmm_full", 1e4, {}), ("ei", "gauss", None, {})]
IDS = ["ei", "ddpm", "em_rescaled", "em_unscaled", "ei_gmm_full", "ei_gauss_no_clip"]


@pytest.mark.parametrize("family,ref_kind,clip,kw", CASES, ids=IDS)
def test_kl_fused_matches_jax(family, ref_kind, clip, kw):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(family, ref_kind, clip, **kw)
    x0, zs = _inputs()

    def j_value(p):
        cfg, arrays = j_ft.build_plan(loss, ctrl, p, ts)
        fn = lambda x0_, _: j_ft.fused_kl_traj(cfg, None, arrays, x0_, jnp.asarray(zs))
        return loss.kl_fused_call(jax.random.PRNGKey(0), ts, jnp.asarray(x0), None, term,
                                  ref_lp, traj_rnd_fn=fn)[0]

    v_j, g_j = jax.value_and_grad(j_value)(params)
    v_t, g_t = _port_fused(t_loss, t_ctrl, t_ts, x0, zs)
    np.testing.assert_allclose(v_t, float(v_j), **VALUE_TOL)
    _assert_grads_close(g_t, g_j)


@pytest.mark.parametrize("family,ref_kind,clip,kw", CASES, ids=IDS)
def test_kl_fused_matches_autograd_through_simulate(family, ref_kind, clip, kw):
    (_, _, _, _), (t_loss, t_ctrl, t_ts) = _setup(family, ref_kind, clip, **kw)
    x0, zs = _inputs(seed=3)
    t_ctrl.zero_grad()
    value, _ = t_loss(None, t_ts, T(x0), t_ctrl, t_term, t_ref_lp, noise=T(zs))
    value.backward()
    v_s, g_s = float(value.detach()), _grads_as_flax(t_ctrl)
    v_f, g_f = _port_fused(t_loss, t_ctrl, t_ts, x0, zs)
    np.testing.assert_allclose(v_f, v_s, **VALUE_TOL)
    _assert_grads_close(g_f, g_s)


def test_kl_fused_reaches_time_embed_and_x0():
    """The differentiable plan carries the table cotangents back to every
    parameter, TimeEmbed's included, and the adjoint's λ₀ to x0; a bf16
    plan is refused."""
    (_, _, _, _), (t_loss, t_ctrl, t_ts) = _setup()
    x0, zs = _inputs(seed=4)
    cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts, differentiable=True)
    assert all(arrays[k].requires_grad for k in ("embed", "w0", "b0", "wh", "bh"))
    assert not any(arrays[k].requires_grad for k in ("coefs", "ref_const", "ref_m", "ref_iv"))
    x0_t = T(x0).requires_grad_()
    x_t, rnd = t_ft.fused_kl_traj(cfg, arrays, x0_t, T(zs))
    (rnd.sum() + (x_t**2).sum()).backward()
    te = t_ctrl.base_model.time_embed
    for p in (te.timestep_phase, *te.dense[0].parameters(), *te.out.parameters()):
        assert p.grad is not None and float(p.grad.abs().max()) > 0
    # λ₀ against autograd through the plain loop on the same tables
    x0_s = T(x0).requires_grad_()
    xs_s, rnd_s = _autograd_traj(cfg, {k: v.detach() for k, v in arrays.items()}, x0_s, T(zs))
    (rnd_s.sum() + (xs_s**2).sum()).backward()
    np.testing.assert_allclose(N(x0_t.grad), N(x0_s.grad), **GRAD_TOL)
    # no plan of the port is differentiable unless asked for
    _, plain = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert not any(v.requires_grad for v in plain.values())


def _autograd_traj(cfg, arrays, x0, zs):
    """fused_traj_plain's float32 step, written with autograd on: the
    reference the adjoint loop is held to."""
    from sde_sampler_lrds_torch.models import gelu_tanh

    a, d, c = arrays, cfg.dim, cfg.n_comp
    x, rnd = x0, torch.zeros(x0.shape[0])
    for k in range(cfg.k_steps):
        h = x @ a["w0"] + a["b0"] + a["embed"][k]
        for i in range(cfg.n_hidden):
            h = gelu_tanh(h) @ a["wh"][i] + a["bh"][i]
        u = torch.clamp(gelu_tanh(h) @ a["w_out"] + a["b_out"], -cfg.clip, cfg.clip)
        g = (x[:, None, :] - a["ref_m"][k].reshape(c, d)) * a["ref_iv"][k].reshape(c, d)
        logits = a["ref_const"][k] - 0.5 * torch.sum(
            (x[:, None, :] - a["ref_m"][k].reshape(c, d)) * g, dim=-1)
        r = -torch.sum(torch.softmax(logits, dim=-1)[..., None] * g, dim=1)
        a_x, a_ref, a_u, a_z, c_cost, c_dot = a["coefs"][k]
        rnd = rnd + c_cost * 0.5 * torch.sum(u * u, -1) + c_dot * torch.sum(u * zs[k], -1)
        x = a_x * x + a_ref * r + a_u * u + a_z * zs[k]
    return x, rnd


def _kl_solver(fused_kl, method="kl", compute_dtype=None):
    ctrl = TClipped(TFourier(dim=DIM, channels=H, num_layers=4, zero_init=True,
                             compute_dtype=compute_dtype), clip_model=1e4)
    cfg = TTrainConfig(train_batch_size=32, eval_batch_size=32, lr=1e-3, fused_kl=fused_kl)
    solver = TRDS(TManyModes(n_modes=3, dim=DIM, var=0.3, n_reference_samples=500,
                             device="cpu"),
                  TIsoGauss(dim=DIM, device="cpu"), TVP(0.1, 10.0), ctrl,
                  t_losses.EIReferenceSDELoss, {"method": method, "max_rnd": 1e8},
                  train_ts=T(get_timesteps(0.0, 1.0, steps=K)), cfg=cfg, device="cpu")
    solver.setup()
    return solver


def test_solver_fused_kl_routing_and_trains():
    """'auto' and 'force' route KL training through the fused KL path (its
    forward the plain version on the CPU), 'off' through the loss's own
    loop; each trains a step to a finite loss; other values raise."""
    g = torch.Generator().manual_seed(0)
    for mode, path in (("auto", "kl_plain"), ("force", "kl_plain"), ("off", "scan")):
        solver = _kl_solver(mode)
        assert solver.train_path() == path
        assert (solver._fused_kl_fn() is None) == (mode == "off")
        metrics = solver.step(g)
        assert np.isfinite(float(metrics["train/loss"])) and solver.n_skipped == 0
    # the LV loss keeps the flat path whatever fused_kl says
    assert _kl_solver("force", method="lv").train_path() == "flat_lv_plain"
    solver = _kl_solver("sometimes")
    with pytest.raises(ValueError, match="fused_kl"):
        solver.train_path()


def kl_demo_quality(batches=(256, 1024), steps=256, lr=3e-3, n_data=8000):
    """The LRDS demo (ManyModes 4 × d 8, MALA-fitted diagonal GMM reference,
    VP(0.1, 10), EI, K = 100, ClippedCtrl(FourierMLP H 64, zero init)) at a
    reduced dataset size, trained with method kl — in the JAX package through
    its own scan (its fused KL path is TPU-only), in the port through the
    fused KL path (plain forward on the CPU) — and with method lv in the JAX
    package: IS log Z, normalized ESS and mode weights of an 8192-sample
    eval after half and all of the steps. Quality numbers, not speeds."""
    from sde_sampler_lrds_torch.api import fit_gmm as t_fit_gmm
    from sde_sampler_lrds_torch.api import mcmc_sample as t_mcmc_sample
    from sde_sampler_lrds_tpu.api import fit_gmm, mcmc_sample
    from sde_sampler_lrds_tpu.losses import EIReferenceSDELoss
    from sde_sampler_lrds_tpu.solvers import RDS
    from sde_sampler_lrds_tpu.solvers.base import TrainConfig
    from sde_sampler_lrds_tpu.targets import IsotropicGauss, ManyModes

    def report(pkg, method, batch, n, log_z, w, counts):
        w = np.asarray(w, np.float64)
        counts = np.asarray(counts, np.float64)
        print(f"{pkg} {method} batch {batch} after {n} steps: log_z_is {float(log_z):.4f}, "
              f"norm_ess {w.sum() ** 2 / (w**2).sum() / w.size:.4f}, mode weights "
              f"{np.round(counts / counts.sum(), 4).tolist()}", flush=True)

    target = ManyModes(n_modes=4, dim=8, var=0.5, n_reference_samples=10_000)
    print("true mode weights", np.round(np.asarray(target._probs), 4).tolist())
    ts = get_timesteps(0.0, 1.0, steps=100)
    data = mcmc_sample(jax.random.PRNGKey(99), target, target.loc, step_size=1e-2,
                       dataset_length=n_data)
    w_fit, m_fit, v_fit = fit_gmm(4, data, em_type="diag")
    print("JAX GMM fit weights", np.round(np.asarray(w_fit), 4).tolist())
    for method, batch in [("kl", b) for b in batches] + [("lv", batches[0])]:
        cfg = TrainConfig(train_steps=steps, train_batch_size=batch, eval_batch_size=8192,
                          lr=lr, steps_per_call=32)
        solver = RDS(target, IsotropicGauss(dim=8, loc=0.0, scale=1.0), VP(0.1, 10.0),
                     ClippedCtrl(base_model=FourierMLP(dim=8, zero_init=True), clip_model=1e4),
                     EIReferenceSDELoss, {"method": method, "max_rnd": 1e8}, train_ts=ts,
                     cfg=cfg)
        solver.change_reference_type("gmm", means=m_fit, variances=v_fit, weights=w_fit)
        solver.setup()
        key = jax.random.PRNGKey(0)
        for i in range(steps // 32):
            key, sub = jax.random.split(key)
            solver.step(sub)
            if (i + 1) * 32 in (steps // 2, steps):
                res = solver.evaluate(jax.random.PRNGKey(5))
                report(f"JAX ({solver.train_path()})", method, batch, (i + 1) * 32,
                       res.log_norm_const_preds["log_norm_const_is"], res.weights,
                       target.compute_mode_count(res.samples))
    t_target = TManyModes(n_modes=4, dim=8, var=0.5, n_reference_samples=10_000, device="cpu")
    data = t_mcmc_sample(torch.Generator().manual_seed(99), t_target, t_target.loc,
                         step_size=1e-2, dataset_length=n_data, device="cpu")
    w_fit, m_fit, v_fit = t_fit_gmm(4, data, em_type="diag", device="cpu")
    print("port GMM fit weights", np.round(N(w_fit), 4).tolist())
    for batch in batches:
        cfg = TTrainConfig(train_steps=steps, train_batch_size=batch, eval_batch_size=8192,
                           lr=lr, steps_per_call=32)
        solver = TRDS(t_target, TIsoGauss(dim=8, device="cpu"), TVP(0.1, 10.0),
                      TClipped(TFourier(dim=8, zero_init=True), clip_model=1e4),
                      t_losses.EIReferenceSDELoss, {"method": "kl", "max_rnd": 1e8},
                      train_ts=T(ts), cfg=cfg, device="cpu")
        solver.change_reference_type("gmm", means=m_fit, variances=v_fit, weights=w_fit)
        solver.setup()
        g = torch.Generator().manual_seed(299)
        for i in range(steps // 32):
            solver.step(g)
            if (i + 1) * 32 in (steps // 2, steps):
                res = solver.evaluate(torch.Generator().manual_seed(5))
                report(f"port ({solver.train_path()})", "kl", batch, (i + 1) * 32,
                       res.log_norm_const_preds["log_norm_const_is"], N(res.weights),
                       N(t_target.compute_mode_count(res.samples)))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    kl_demo_quality()
