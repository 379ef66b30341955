"""The port's VI solvers held against the JAX package's: ``make_model`` for
'dds_orig', 'pis_orig', 'dis_orig' (also with GBS's ``inference_ctrl_arch``
and its Hutchinson estimator), 'cmcd' (also with its prior refitted by
``update_prior``) and the ``force_base_zero_init`` controls that put DDS and
PIS on B1's plans (the TrainConfig, SDE, prior, time grid, loss, control,
training and evaluation paths); training steps from the JAX solver's
parameters under the JAX steps' own draws, compared with the JAX parameters
after each step; and checkpoints that round-trip bit for bit, CMCD's refit
prior and Bridge's inference control included.

Tiny sizes (TwoModes d 3, K 6, batch 16) on the CPU with SGD at lr 1e-3
and the gradient clipped to norm 1, so a step's update is lr times the
clipped gradient: each step's update agrees with JAX's, leaf by leaf, at
rtol = 1e-3 with an atol of 1e-3 of the leaf's largest update plus 1e-6 of
its largest parameter (float32 gradients summed in another order, and the
parameters' own rounding), and the losses at rtol = 1e-4. The port's torch is pinned to one intra-op
thread."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh

DIM, K, B = 3, 6, 16

CASES = {
    # solver, model, extra make_model kwargs, loss method
    "dds": ("dds_orig", "target_informed_zero_init", {"force_T_cosine": 0.3}, "lv"),
    "dds_b1_kl": ("dds_orig", "base_zero_init",
                  {"force_base_zero_init": True, "force_T_cosine": 0.3}, "kl"),
    "pis": ("pis_orig", "target_informed_zero_init", {}, "lv"),
    "pis_b1": ("pis_orig", "base_zero_init", {"force_base_zero_init": True}, "lv"),
    "dis": ("dis_orig", "target_informed_zero_init", {}, "lv"),
    "dis_lerp": ("dis_orig", "target_informed_lerp_tempering", {}, "lv"),
    "dis_gbs": ("dis_orig", "target_informed_zero_init",
                {"inference_ctrl_arch": "base_zero_init"}, "lv"),
    "dis_gbs_hutchinson": ("dis_orig", "target_informed_zero_init",
                           {"inference_ctrl_arch": "base_zero_init",
                            "loss_details": {"div_estimator": "rademacher"}}, "kl"),
    "cmcd": ("cmcd", "target_informed_zero_init", {}, "lv"),
    "cmcd_refit": ("cmcd", "target_informed_zero_init", {"ref": "gaussian"}, "lv"),
}
# the paths the port takes on the CPU (B1's plain version where in scope)
PATHS = {"dds": ("flat_lv_scan", "scan"), "dds_b1_kl": ("kl_plain", "plain"),
         "pis": ("flat_lv_scan", "scan"), "pis_b1": ("flat_lv_plain", "plain"),
         "dis": ("flat_lv_scan", "scan"), "dis_lerp": ("flat_lv_scan", "scan"),
         "dis_gbs": ("scan", "scan"), "dis_gbs_hutchinson": ("scan", "scan"),
         "cmcd": ("flat_lv_scan", "scan"), "cmcd_refit": ("flat_lv_scan", "scan")}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _args(case, **training):
    solver, model, extra, method = CASES[case]
    extra = dict(extra)
    ref = extra.pop("ref", "default")
    details = {"sigma": 1.2}
    if ref == "gaussian":
        rng = np.random.default_rng(1)
        details = {"mean": rng.normal(size=DIM).astype(np.float32),
                   "var": (0.5 + rng.random(DIM)).astype(np.float32)}
    return dict(solver_type=solver, ref_type=ref, loss_type=method, integrator_type="em",
                model_type=model, time_type="uniform", solver_details=details,
                target_details=make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 3, "train_batch_size": B,
                                  "eval_batch_size": 2 * B, "optimizer": "sgd", "lr": 1e-3,
                                  "grad_clip": 1.0,
                                  **training},
                n_steps=K, **extra)


def _pair(case, **training):
    args = _args(case, **training)
    return make_model(mesh=get_mesh(1), **args), t_make_model(device="cpu", **args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_model_matches_jax(case):
    j, t = _pair(case)
    assert type(t).__name__ == type(j).__name__
    jc, tc = dataclasses.asdict(j.cfg), dataclasses.asdict(t.cfg)
    assert jc == tc
    assert type(t.sde).__name__ == type(j.sde).__name__
    for k, v in (vars(j.sde) if j.sde is not None else {}).items():
        if isinstance(v, (int, float, type(None))):
            assert getattr(t.sde, k) == v, k
    assert type(t.prior).__name__ == type(j.prior).__name__
    np.testing.assert_allclose(N(t.prior.loc), np.asarray(j.prior.loc), rtol=1e-6)
    jts, tts = np.asarray(j.train_ts), N(t.train_ts)
    assert tts.shape == jts.shape
    np.testing.assert_allclose(tts, jts, rtol=1e-6, atol=1e-6)
    assert type(t.loss).__name__ == type(j.loss).__name__
    for k in ("method", "max_rnd", "traj_per_sample", "alpha", "sigma", "use_rescaling",
              "div_estimator", "sde_ctrl_noise", "sde_ctrl_dropout"):
        assert getattr(t.loss, k, None) == getattr(j.loss, k, None), k
    assert type(t.generative_ctrl).__name__ == type(j.generative_ctrl).__name__
    j_inf = getattr(j, "inference_ctrl_module", None)
    t_inf = getattr(t, "inference_ctrl_module", None)
    assert (j_inf is None) == (t_inf is None)
    assert t.eubo_available == j.eubo_available
    assert set(t.loss_call_args()) == set(j.loss_call_args())
    assert (t.train_path(), t.eval_path()) == PATHS[case]
    assert set(t.sample_losses) == {"sinkhorn", "mmd", "ks"}
    if case == "cmcd_refit":
        np.testing.assert_allclose(N(t.prior.scale[0] ** 2),
                                   _args(case)["solver_details"]["var"], rtol=1e-6)


def _perturbed_params(j, seed=3):
    leaves, tree = jax.tree_util.tree_flatten(j.state.params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.01 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _replayed_draws(j, case, key):
    """The prior draw and the per-step normals (and Hutchinson probes) that
    the JAX loss_fn takes from ``key``."""
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (B,)))
    k = j.train_ts.shape[0] - 1
    fed = {"x0": T(x0)}
    if getattr(j, "inference_ctrl_module", None) is None and j._flat_lv_ok():
        k_z, _ = jax.random.split(k_sim)
        fed["noise"] = T(np.asarray(jax.random.normal(k_z, (k, B, DIM))))
        return fed
    n_split = 4 if case.startswith("dis") else 3
    zs, probes, kk = [], [], k_sim
    for _ in range(k):
        kk, k_z, _, *k_div = jax.random.split(kk, n_split)
        zs.append(np.asarray(jax.random.normal(k_z, (B, DIM))))
        if k_div:
            probes.append(np.asarray(jax.random.rademacher(k_div[0], (B, DIM),
                                                           dtype=jnp.float32)))
    fed["noise"] = T(np.stack(zs))
    if case == "dis_gbs_hutchinson":
        fed["div_probes"] = T(np.stack(probes))
    return fed


def _params(t, j_params=None):
    """The port solver's parameters, or the JAX tree's in its layout (loaded
    into a copy of the solver)."""
    if j_params is not None:
        t = copy.deepcopy(t)
        t.load_flax_params(jax.tree_util.tree_map(np.asarray, j_params))
    return [N(p).copy() for p in t.module.parameters()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case):
    j, t = _pair(case)
    j.setup(jax.random.PRNGKey(0))
    params = _perturbed_params(j)
    j.state = j.state.replace(params=params)
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    names = [n for n, _ in t.module.named_parameters()]
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        fed = _replayed_draws(j, case, key)
        before = _params(t)
        want = j.step(key)
        got = t.step(None, **fed)
        np.testing.assert_allclose(float(got["train/loss"]), float(want["train/loss"]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"step {i}")
        assert int(got["train/n_filtered"]) == int(want["train/n_filtered"])
        for name, b, p, w in zip(names, before, _params(t), _params(t, j.state.params)):
            # JAX's update from the same point (the parameters agreed before)
            want_upd, got_upd = w - b, p - b
            np.testing.assert_allclose(got_upd, want_upd, rtol=1e-3,
                                       atol=1e-3 * np.abs(want_upd).max()
                                       + 1e-6 * np.abs(b).max(),
                                       err_msg=f"step {i} {name}")
        t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
        t.step_count, t.optimizer = i + 1, t.make_optimizer()
    assert t.step_count == 3 and t.n_skipped == int(j.state.n_skipped) == 0
    # the lerp control at this sigma sends every trajectory past max_rnd
    # (1e8) in both packages, so its loss is the empty mask's 0
    assert (float(got["train/loss"]) == 0.0) == (case == "dis_lerp")


def _same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("case", ["dds", "pis_b1", "dis_gbs", "cmcd_refit"])
def test_checkpoint_round_trip(case, tmp_path):
    """Stored after a run with EMA, restored into a solver built afresh (for
    CMCD, one without the refit prior): parameters, EMA, optimizer state,
    counters, CMCD's prior and Bridge's inference control, bit for bit; the
    next step under fed draws agrees bit for bit too."""
    args = _args(case, ckpt_interval=3, eval_interval=10**9)
    stored = t_make_model(device="cpu", out_dir=tmp_path, use_ema=True, **args)
    stored.setup()
    stored.run()
    fresh_args = dict(args)
    if case == "cmcd_refit":
        fresh_args.update(ref_type="default", solver_details={"sigma": 1.0})
    fresh = t_make_model(device="cpu", out_dir=tmp_path / "other", use_ema=True, **fresh_args)
    fresh.setup()
    assert fresh.load_checkpoint(tmp_path / "ckpt" / "ckpt000003.pt")
    _same(fresh.module.state_dict(), stored.module.state_dict(), "module")
    _same(fresh.ema_module.state_dict(), stored.ema_module.state_dict(), "ema")
    _same(fresh.optimizer.state_dict(), stored.optimizer.state_dict(), "optimizer")
    assert (fresh.step_count, fresh.n_skipped) == (stored.step_count, 0) == (3, 0)
    if case == "dis_gbs":
        assert any(k.startswith("inference.") for k in fresh.module.state_dict())
    if case == "cmcd_refit":
        assert type(fresh.prior).__name__ == "Gauss"
        _same(fresh.prior_fit, stored.prior_fit, "prior_fit")
        x = torch.randn(8, DIM, generator=torch.Generator().manual_seed(1))
        assert torch.equal(fresh.prior.log_prob(x), stored.prior.log_prob(x))
    rng = np.random.default_rng(6)
    x0 = T(rng.normal(size=(B, DIM)).astype(np.float32))
    k = stored.train_ts.shape[0] - 1
    noise = T(rng.normal(size=(k, B, DIM)).astype(np.float32))
    ms = [s.step(torch.Generator().manual_seed(0), x0=x0, noise=noise) for s in (stored, fresh)]
    assert torch.equal(ms[0]["train/loss"], ms[1]["train/loss"])
    _same(fresh.module.state_dict(), stored.module.state_dict(), "stepped")


def test_bridge_keeps_b1_off_with_an_inference_control():
    """With GBS's inference control the fused evaluation and the flat path
    are off by the solver's rule (the kernel has no inference control); the
    evaluation runs the loss's own loop and gives finite metrics."""
    _, t = _pair("dis_gbs")
    t.setup()
    assert t._fused_eval_plan() is None and t.fused_eval_sampler() is None
    res = t.evaluate(torch.Generator().manual_seed(0))
    assert np.isfinite(res.metrics["eval/elbo"])
    _, plain = _pair("dis")
    assert plain.loss.inference_ctrl is None and plain.inference_ctrl_module is None


def test_pis_inference_trajectory_and_eubo():
    """PIS's analytic inference control drives sample_inference_traj; PIS
    and DDS have no EUBO, as in the JAX package."""
    _, t = _pair("pis_b1")
    t.setup()
    traj = t.sample_inference_traj(torch.Generator().manual_seed(0), 8)
    assert traj.shape == (K + 1, 8, DIM) and bool(torch.isfinite(traj).all())
    for case in ("pis_b1", "dds"):
        _, s = _pair(case)
        s.setup()
        with pytest.raises(NotImplementedError, match="EUBO"):
            s.compute_eubo(None, torch.zeros(4, DIM))
