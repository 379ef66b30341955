"""The learned ('nn') reference of RDS in the port, held against the JAX
package on the CPU: ``make_model(..., ref_type='nn')`` with a trained
GMM-tilted potential (its reference score at per-step times, its reference
log-prob at eps = ts[0], the paths: B1 off), the flat-LV training steps
from the JAX solver's parameters under the JAX steps' own draws, the
evaluation's simulation and the EUBO under fed noise, and checkpoints: the
potential's state_dict restored bit for bit into a fresh solver (the next
step equal under fed inputs), and the errors of a restore that cannot
rebuild the potential.

Tiny sizes (TwoModes d 3, K 6, batch 16, the energy net 3 layers × 16);
SGD at lr 1e-3 with the gradient clipped to norm 1. Tolerances as
tests/test_torch_vi_solvers.py: the losses 1e-4 relative, each update 1e-3
relative with 1e-3 of the leaf's largest update; the simulation's states
and log-ratios 1e-4; the reference 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.models import FourierMLP as TFourierMLP
from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential as TPot
from sde_sampler_lrds_torch.ops.fused_traj import build_plan
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.models import FourierMLP, GMMTiltedPotential
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.sde import VP

DIM, K, B, H = 3, 6, 16, 16


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


def _potentials(seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([0.5, 0.5], np.float32)
    m = np.stack([np.ones(DIM), -np.ones(DIM)]).astype(np.float32)
    v = rng.uniform(0.2, 0.5, (2, DIM)).astype(np.float32)
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    j_pot = GMMTiltedPotential(base_model=FourierMLP(dim=DIM, channels=H, num_layers=3),
                               sde=VP(**kw), weights=jnp.asarray(w), means=jnp.asarray(m),
                               variances=jnp.asarray(v), t_limit=0.05)
    params = j_pot.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM)))
    # a small trained-looking tilt: the random net's output scaled down
    params = jax.tree.map(lambda a: a * 0.3, params)
    t_pot = TPot(TFourierMLP(dim=DIM, channels=H, num_layers=3), TVP(**kw), w, m, v,
                 t_limit=0.05)
    t_pot.load_flax_params(jax.tree.map(np.asarray, params))
    j_net = (lambda p, t, x: j_pot.apply(p, t, x),
             lambda p, t, x: j_pot.apply(p, t, x, method="unnorm_log_prob"), params)
    return j_net, t_pot


def _args(**training):
    return dict(solver_type="vp-ref", ref_type="nn", loss_type="lv", integrator_type="ei",
                model_type="base_zero_init", time_type="snr",
                target_details=make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 3, "train_batch_size": B,
                                  "eval_batch_size": 2 * B, "optimizer": "sgd", "lr": 1e-3,
                                  "grad_clip": 1.0, **training},
                n_steps=K)


def _pair(**training):
    j_net, t_pot = _potentials()
    j = make_model(solver_details={"sigma": 1.0, "net": j_net}, mesh=get_mesh(1),
                   **_args(**training))
    t = t_make_model(solver_details={"sigma": 1.0, "net": t_pot}, device="cpu",
                     **_args(**training))
    return j, t, t_pot


def test_make_model_with_nn_reference_matches_jax():
    j, t, t_pot = _pair()
    assert t.ref_type == j.ref_type == "nn"
    assert t._nn_eps == pytest.approx(j._nn_eps, rel=1e-6)
    assert t._nn_eps == pytest.approx(float(N(t.train_ts)[0]), rel=0)
    np.testing.assert_allclose(N(t.train_ts), np.asarray(j.train_ts), rtol=1e-6, atol=1e-7)
    # the installed potential is a frozen copy: training the original's
    # parameters later does not move the reference
    assert t.reference_distr_utils["net"] is not t_pot
    assert not any(p.requires_grad for p in t.reference_distr_utils["net"].parameters())
    assert (t.train_path(), t.eval_path()) == ("flat_lv_scan", "scan")
    assert build_plan(t.loss, t.generative_ctrl, t.train_ts) is None
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    np.testing.assert_allclose(N(t.reference_log_prob(T(x))),
                               np.asarray(j.reference_log_prob(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    for tc in (0.03, 0.7):
        np.testing.assert_allclose(N(t.reference_score_t(torch.tensor(tc), T(x))),
                                   np.asarray(j.reference_score_t(jnp.asarray(tc),
                                                                  jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)
    # flat states (K, B, D) with per-step times (K, 1), as flat_ctrl_eval calls it
    xs = rng.normal(size=(K, B, DIM)).astype(np.float32)
    tg = np.linspace(0.05, 0.95, K).astype(np.float32)
    got = t.reference_score_t(T(tg)[:, None], T(xs))
    want = np.stack([np.asarray(j.reference_score_t(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(tg, xs)])
    np.testing.assert_allclose(N(got), want, rtol=1e-5, atol=1e-5)


def _perturbed_params(j, seed=3):
    leaves, tree = jax.tree_util.tree_flatten(j.state.params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.01 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _flat(t, j_params=None):
    if j_params is not None:
        t = copy.deepcopy(t)
        t.load_flax_params(jax.tree_util.tree_map(np.asarray, j_params))
    return [N(p).copy() for p in t.module.parameters()]


def test_flat_lv_steps_match_jax_under_its_draws():
    j, t, _ = _pair()
    j.setup(jax.random.PRNGKey(0))
    params = _perturbed_params(j)
    j.state = j.state.replace(params=params)
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        k_prior, k_sim = jax.random.split(key)
        fed = {"x0": T(j.prior.sample(k_prior, (B,))),
               "noise": T(jax.random.normal(jax.random.split(k_sim)[0], (K, B, DIM)))}
        before = _flat(t)
        want = j.step(key)
        got = t.step(None, **fed)
        np.testing.assert_allclose(float(got["train/loss"]), float(want["train/loss"]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"step {i}")
        for b, p, w in zip(before, _flat(t), _flat(t, j.state.params)):
            want_upd, got_upd = w - b, p - b
            np.testing.assert_allclose(got_upd, want_upd, rtol=1e-3,
                                       atol=1e-3 * np.abs(want_upd).max()
                                       + 1e-6 * np.abs(b).max(), err_msg=f"step {i}")
        t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
        t.step_count, t.optimizer = i + 1, t.make_optimizer()


def test_simulation_and_eubo_match_jax_under_fed_noise():
    j, t, _ = _pair()
    j.setup(jax.random.PRNGKey(0))
    params = _perturbed_params(j)
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(2 * B, DIM)).astype(np.float32)
    zs = rng.normal(size=(K, 2 * B, DIM)).astype(np.float32)
    jx, jr, jxs = j.loss.simulate(jax.random.PRNGKey(0), j.eval_ts, jnp.asarray(x0), j.ctrl_fn(params),
                                  return_traj=True, noise=jnp.asarray(zs),
                                  **j.loss_call_args())
    with torch.no_grad():
        tx, tr, txs = t.loss.simulate(None, t.eval_ts, T(x0), t.eval_ctrl(False),
                                      return_traj=True, noise=T(zs), **t.loss_call_args())
    np.testing.assert_allclose(N(txs), np.asarray(jxs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(tr), np.asarray(jr), rtol=1e-4, atol=1e-4)
    x_t = rng.normal(size=(2 * B, DIM)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = j.loss.compute_eubo(key, j.eval_ts, jnp.asarray(x_t), j.ctrl_fn(params),
                               **j.loss_call_args())
    got = t.compute_eubo(None, T(x_t), use_ema=False,
                         noise=T(jax.random.normal(key, (K, 2 * B, DIM))))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    res = t.evaluate(torch.Generator().manual_seed(1))
    assert res.samples.shape == (2 * B, DIM) and bool(torch.isfinite(res.rnd).all())


def test_nn_reference_checkpoint_round_trip(tmp_path):
    """Stored after a run with EMA, restored into a solver built with the
    'default' reference and then given an untrained potential of the same
    architecture: the reference's state, eps and every train state bit for
    bit, and the next step under fed inputs equal bit for bit."""
    args = _args(ckpt_interval=3, eval_interval=10**9)
    _, t_pot = _potentials()
    stored = t_make_model(solver_details={"sigma": 1.0, "net": t_pot}, device="cpu",
                          out_dir=tmp_path, use_ema=True, **args)
    stored.setup()
    stored.run()
    fresh_pot = copy.deepcopy(t_pot)
    for p in fresh_pot.parameters():
        torch.nn.init.zeros_(p)
    fresh_args = dict(args, ref_type="default")
    fresh = t_make_model(solver_details={"sigma": 1.0}, device="cpu",
                         out_dir=tmp_path / "other", use_ema=True, **fresh_args)
    fresh.setup()
    fresh.change_reference_type("nn", net=fresh_pot, eps=0.5)
    assert fresh.load_checkpoint(tmp_path / "ckpt" / "ckpt000003.pt")
    assert fresh.ref_type == "nn" and fresh._nn_eps == stored._nn_eps
    for name, a in stored.reference_distr_utils["net"].state_dict().items():
        assert torch.equal(fresh.reference_distr_utils["net"].state_dict()[name], a), name
    for a, b in ((fresh.module, stored.module), (fresh.ema_module, stored.ema_module)):
        for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), n
    rng = np.random.default_rng(6)
    x0 = T(rng.normal(size=(B, DIM)).astype(np.float32))
    noise = T(rng.normal(size=(K, B, DIM)).astype(np.float32))
    ms = [s.step(torch.Generator().manual_seed(0), x0=x0, noise=noise) for s in (stored, fresh)]
    assert torch.equal(ms[0]["train/loss"], ms[1]["train/loss"])
    for x, y in zip(fresh.module.parameters(), stored.module.parameters()):
        assert torch.equal(x, y)


def test_nn_reference_restore_errors(tmp_path):
    """A checkpoint with the potential's state needs an installed 'nn'
    reference to rebuild it; one saved from a pair of callables has none to
    restore (kept when an 'nn' reference is installed, else an error)."""
    _, t_pot = _potentials()
    stored = t_make_model(solver_details={"sigma": 1.0, "net": t_pot}, device="cpu", **_args())
    stored.setup()
    raw = stored.save_attrs()
    assert set(raw["reference"]) == {"ref_type", "eps", "net_state"}
    plain = t_make_model(solver_details={"sigma": 1.0}, device="cpu",
                         **dict(_args(), ref_type="default"))
    plain.setup()
    with pytest.raises(ValueError, match="needs the potential's architecture"):
        plain.restore_attrs(raw)
    closure = t_make_model(solver_details={"sigma": 1.0, "net": (t_pot, t_pot.unnorm_log_prob)},
                           device="cpu", **_args())
    closure.setup()
    raw = closure.save_attrs()
    assert set(raw["reference"]) == {"ref_type", "eps"}
    with pytest.raises(ValueError, match="no serialized params"):
        plain.restore_attrs(raw)
    closure.restore_attrs(raw)               # keeps its installed reference
    assert closure.ref_type == "nn"
