"""The ported slice as a whole — flat-LV RDS training and the fused eval —
held against the JAX package on a tiny problem (ManyModes with 3 modes in
2-D, a fitted-GMM-style reference, K = 10 steps, batch 64).

Both sides start from the same control weights (carried across with
``load_flax_params``) and consume the same x0 and per-step noise: the noise
the JAX loss derives from its key is rebuilt from that key and fed to the
port. The JAX side calls its loss and optax directly (its solvers would shard
over the test suite's virtual devices); the port runs its own RDS solver.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sde_sampler_lrds_torch.losses import EIReferenceSDELoss as TEILoss
from sde_sampler_lrds_torch.losses import compute_results as t_compute_results
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.ops.fused_traj import build_plan as t_build_plan
from sde_sampler_lrds_torch.ops.fused_traj import fused_simulate as t_fused_simulate
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.solvers import RDS as TRDS
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsoGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu.losses import EIReferenceSDELoss, compute_results
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl
from sde_sampler_lrds_tpu.targets import ManyModes

DIM, K, B, H, LR = 2, 10, 64, 16, 1e-3


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _reference():
    rng = np.random.default_rng(11)
    means = (2.0 * rng.normal(size=(3, DIM))).astype(np.float32)
    variances = (0.3 + 0.3 * rng.random((3, DIM))).astype(np.float32)
    weights = np.array([0.2, 0.3, 0.5], np.float32)
    return means, variances, weights


@pytest.fixture(scope="module")
def pair():
    means, variances, weights = _reference()
    sde = VP(0.1, 10.0)
    target = ManyModes(n_modes=3, dim=DIM, var=0.3)
    ref = GMMReferenceCtrl(sde, jnp.asarray(means), jnp.asarray(variances),
                           jnp.asarray(weights))
    loss = EIReferenceSDELoss(sde=sde, method="lv", max_rnd=1e8, reference_ctrl=ref)
    ref_lp = lambda x: sde.marginal_gmm_log_prob(jnp.asarray(0.0), x, means,
                                                 variances, weights)
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=DIM, channels=H, num_layers=3),
                       clip_model=1e4)
    params = ctrl.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, DIM)))
    ts = get_timesteps(0.0, 1.0, steps=K)

    def j_loss(p, key, x0):
        return loss.lv_flat_call(key, ts, x0, lambda t, x: ctrl.apply(p, t, x),
                                 target.unnorm_log_prob, ref_lp)[0]

    t_ctrl = TClipped(TFourier(dim=DIM, channels=H, num_layers=3), clip_model=1e4)
    cfg = TTrainConfig(train_batch_size=B, eval_batch_size=B, lr=LR)
    solver = TRDS(TManyModes(n_modes=3, dim=DIM, var=0.3, n_reference_samples=1000,
                             device="cpu"),
                  TIsoGauss(dim=DIM, device="cpu"), TVP(0.1, 10.0), t_ctrl, TEILoss,
                  {"method": "lv", "max_rnd": 1e8}, train_ts=T(ts), cfg=cfg,
                  device="cpu")
    solver.change_reference_type("gmm", means=means, variances=variances,
                                 weights=weights)
    solver.setup()
    return dict(j_loss=j_loss, params=params, ctrl=ctrl, loss=loss, ts=ts,
                target=target, ref_lp=ref_lp, solver=solver)


def _fresh(pair):
    solver = pair["solver"]
    load_flax_params(solver.generative_ctrl, jax.tree.map(np.asarray, pair["params"]))
    solver.reset_optimizer()
    return solver


def _batch(step):
    """x0 and the noise lv_flat_call draws from its key (_flat_lv_setup)."""
    key = jax.random.PRNGKey(100 + step)
    x0 = np.random.default_rng(step).normal(size=(B, DIM)).astype(np.float32)
    zs = jax.random.normal(jax.random.split(key)[0], (K, B, DIM))
    return key, x0, np.asarray(zs)


def _as_flax(ctrl, get):
    """The port's parameters (or grads) laid out as the Flax tree."""
    base = ctrl.base_model
    lin = lambda l: {"kernel": N(get(l.weight)).T, "bias": N(get(l.bias))}
    tree = {"Dense_0": lin(base.x_embed), f"Dense_{base.num_layers - 1}": lin(base.out)}
    tree.update({f"Dense_{i}": lin(l) for i, l in enumerate(base.hidden, start=1)})
    te = base.time_embed
    tree["TimeEmbed_0"] = {f"Dense_{i}": lin(l) for i, l in enumerate([*te.dense, te.out])}
    tree["TimeEmbed_0"]["timestep_phase"] = N(get(te.timestep_phase))
    return {"params": {"base_model": tree}}


def _assert_trees_close(got, want, rel):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        w = np.asarray(w)
        scale = float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(flat_g[path], w, rtol=rel, atol=rel * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_lv_flat_loss_and_grads(pair):
    solver = _fresh(pair)
    key, x0, zs = _batch(0)
    loss_j, grads_j = jax.value_and_grad(pair["j_loss"])(pair["params"], key,
                                                         jnp.asarray(x0))
    assert solver.train_path() == ("flat_lv_fused" if solver.device.type == "cuda"
                                   else "flat_lv_plain")
    solver.generative_ctrl.zero_grad()
    loss_t, _ = solver.loss_fn(None, x0=T(x0), noise=T(zs))
    loss_t.backward()
    # a variance over 64 trajectories of K = 10 float32 steps: relative 1e-4
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    # gradients: one flat MLP backward over all K·B states, summed in another
    # order; compared per leaf relative to the leaf's largest entry
    _assert_trees_close(_as_flax(solver.generative_ctrl, lambda p: p.grad), grads_j,
                        rel=1e-3)


def test_three_adam_steps_match_optax(pair):
    solver = _fresh(pair)
    params = pair["params"]
    opt = optax.adam(LR)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(pair["j_loss"]))
    for step in range(3):
        key, x0, zs = _batch(step)
        grads = grad_fn(params, key, jnp.asarray(x0))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        solver.step(None, x0=T(x0), noise=T(zs))
    assert solver.step_count == 3 and solver.n_skipped == 0
    # Adam moves every parameter by ≈ lr per step whatever the gradient's
    # scale, so float32 gradient differences show up at ≪ lr
    _assert_trees_close(_as_flax(solver.generative_ctrl, lambda p: p), params, rel=1e-4)


def test_eval_fed_noise_matches(pair):
    solver = _fresh(pair)
    _, x0, zs = _batch(7)
    ctrl_fn = lambda t, x: pair["ctrl"].apply(pair["params"], t, x)
    _, rnd_j, _ = pair["loss"].simulate(jax.random.PRNGKey(0), pair["ts"], jnp.asarray(x0),
                                        ctrl_fn, pair["target"].unnorm_log_prob,
                                        pair["ref_lp"], noise=jnp.asarray(zs))
    res_j = compute_results(rnd_j, compute_weights=True)
    cfg, arrays = t_build_plan(solver.loss, solver.generative_ctrl, solver.eval_ts)
    _, rnd_t = t_fused_simulate(cfg, arrays, None, T(x0), noise=T(zs),
                                **solver.loss_call_args())
    res_t = t_compute_results(rnd_t, compute_weights=True)
    # K = 10 float32 steps, then log-densities of size ~10
    np.testing.assert_allclose(N(rnd_t), rnd_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res_t.log_norm_const_preds["log_norm_const_is"],
                               res_j.log_norm_const_preds["log_norm_const_is"],
                               rtol=1e-4, atol=1e-4)


def test_solver_on_cpu_routes_and_evaluates(pair, monkeypatch):
    solver = _fresh(pair)
    assert solver.eval_path() == "plain" and solver.train_path() == "flat_lv_plain"
    g = torch.Generator().manual_seed(3)
    metrics = solver.step(g)
    assert np.isfinite(float(metrics["train/loss"]))
    res = solver.evaluate(g)
    assert res.samples.shape == (B, DIM) and np.isfinite(N(res.rnd)).all()
    assert np.isfinite(res.log_norm_const_preds["log_norm_const_is"])
    x_t, rnd = solver.fused_eval_sampler()(g)
    assert x_t.shape == (B, DIM) and rnd.shape == (B,)
    # with the flat path off, the loss's own loop trains (autograd through it)
    solver.cfg.flat_lv = "off"
    try:
        assert solver.train_path() == "scan"
        assert np.isfinite(float(solver.step(g)["train/loss"]))
    finally:
        solver.cfg.flat_lv = "auto"
    # no device and no GPU: the solver refuses to fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRDS(solver.target, solver.prior, solver.sde,
             TClipped(TFourier(dim=DIM, channels=H, num_layers=3)), TEILoss,
             {"method": "lv"}, train_ts=solver.train_ts, cfg=solver.cfg)
