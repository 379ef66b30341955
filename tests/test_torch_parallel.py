"""The port's data-parallel mesh held against the JAX package's on the CPU:
the placement of a batch and of replicated parameters, ``constrain_batch``
on a batch that divides the mesh and on one that does not, B1's sharded
entry points and the fused-KL forward against the JAX package's
``shard_map`` of the Pallas kernel (interpret mode) on the test suite's
8-device virtual mesh, the train-step loss on 1, 4 and 8 shards against
the JAX solver's on meshes of those sizes, and an eval split in shards.

The port's mesh here is the CPU repeated 8 times (a device may appear more
than once; the repeats share one copy of a replicated tensor). Under fed
noise the kernel's outputs are held at f32 tolerance: 1e-4 relative and
absolute on the states and log-ratios of K = 6 steps (the tables differ by
a few ulps between the packages, tests/test_torch_fused_traj.py), 1e-4
relative on the losses.
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
from sde_sampler_lrds_torch.parallel import (batch_sharding, constrain_batch, get_mesh,
                                             replicate, replicated_sharding, shard_batch)
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.utils.common import derive_generator
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.parallel import constrain_batch as j_constrain_batch
from sde_sampler_lrds_tpu.parallel import get_mesh as j_get_mesh
from sde_sampler_lrds_tpu.parallel import replicate as j_replicate
from sde_sampler_lrds_tpu.parallel import shard_batch as j_shard_batch
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl

DIM, K, H, B = 3, 6, 16, 64
TOL = dict(rtol=1e-4, atol=1e-4)


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def cpu_mesh(n: int = 8):
    return get_mesh(devices=["cpu"] * n)


def test_mesh_and_placement(monkeypatch):
    mesh, j_mesh = cpu_mesh(), j_get_mesh(8)
    assert mesh.size == j_mesh.devices.size == 8 and mesh.axis_names == ("data",)
    x = np.arange(64.0, dtype=np.float32).reshape(64, 1)
    shards = shard_batch(T(x), mesh)
    j_x = j_shard_batch(jnp.asarray(x), j_mesh)
    assert batch_sharding(mesh).spec == tuple(j_x.sharding.spec) == ("data",)
    assert len(shards) == 8
    for s, j_s in zip(shards, j_x.addressable_shards):
        assert tuple(s.shape) == batch_sharding(mesh).shard_shape(x.shape) == j_s.data.shape
        np.testing.assert_array_equal(N(s), np.asarray(j_s.data))
    # a tree of tensors is split leaf by leaf, one tree a shard
    tree = shard_batch({"a": T(x), "b": (T(2 * x),)}, mesh)
    np.testing.assert_array_equal(N(tree[3]["b"][0]), 2 * x[24:32])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(T(x[:63]), mesh)
    w = torch.ones(3)
    p = replicate({"w": w}, mesh)
    j_p = j_replicate({"w": jnp.ones((3,))}, j_mesh)
    assert replicated_sharding(mesh).spec == tuple(j_p["w"].sharding.spec) == ()
    # the repeated device shares one copy, which is the tensor itself here
    assert len(p) == 8 and all(q["w"] is w for q in p)
    assert replicated_sharding(mesh).shard_shape((3,)) == (3,)
    assert get_mesh(4, devices=["cpu"] * 8).size == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        get_mesh()


def test_constrain_batch_on_64_and_63_rows():
    mesh, j_mesh = cpu_mesh(), j_get_mesh(8)
    f = jax.jit(lambda key, n: j_constrain_batch(jax.random.normal(key, (n, 2)), j_mesh),
                static_argnums=1)
    j64 = f(jax.random.PRNGKey(0), 64)
    assert j64.sharding.shard_shape(j64.shape) == batch_sharding(mesh).shard_shape((64, 2))
    x = T(np.asarray(j64))
    out = constrain_batch(x, mesh)
    assert out.device == mesh.device and torch.equal(out, x)
    # no mesh, a one-device mesh and a batch that does not divide: untouched
    j63 = f(jax.random.PRNGKey(0), 63)
    assert j63.shape == (63, 2)
    y = T(np.asarray(j63))
    assert constrain_batch(y, mesh) is y
    assert constrain_batch(x, None) is x and constrain_batch(x, cpu_mesh(1)) is x


def _plan_pair(seed: int = 0):
    """One (loss, control, GMM reference) triple in both packages and its
    plans (the JAX one tiled at the batch, as the JAX sharded test does)."""
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=DIM, channels=H, num_layers=3), clip_model=1e4)
    params = jax.tree.map(np.asarray, ctrl.init(jax.random.PRNGKey(seed), jnp.zeros((2,)),
                                                jnp.zeros((2, DIM))))
    t_ctrl = TClipped(TFourier(dim=DIM, channels=H, num_layers=3), clip_model=1e4)
    load_flax_params(t_ctrl, params)
    rng = np.random.default_rng(seed + 1)
    means = rng.normal(size=(3, DIM)).astype(np.float32)
    variances = (0.5 + rng.random((3, DIM))).astype(np.float32)
    weights = (0.5 + rng.random(3)).astype(np.float32)
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    loss = j_losses.EIReferenceSDELoss(sde=sde, method="kl", reference_ctrl=GMMReferenceCtrl(
        sde, jnp.asarray(means), jnp.asarray(variances), jnp.asarray(weights)))
    t_loss = t_losses.EIReferenceSDELoss(sde=t_sde, method="kl", reference_ctrl=TGMMRef(
        t_sde, T(means), T(variances), T(weights)))
    ts = get_timesteps(0.0, 1.0, steps=K)
    j_plan = j_ft.build_plan(loss, ctrl, params, ts, block_b=B)
    return j_plan, (t_loss, t_ctrl, T(ts))


def _inputs(seed: int = 2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, DIM)).astype(np.float32),
            rng.normal(size=(K, B, DIM)).astype(np.float32))


def test_sharded_entry_points_match_jax():
    """fused_traj_states_sharded, fused_simulate_sharded and the fused-KL
    forward on 8 shards against the JAX package's shard_map on its 8-device
    mesh, under the same noise: the JAX sharded eval draws shard i's normals
    from fold_in(key, i), which are fed to the port in shard order."""
    (cfg_j, arr_j), (t_loss, t_ctrl, t_ts) = _plan_pair()
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    mesh, j_mesh = cpu_mesh(), j_get_mesh(8)
    x0, zs = _inputs()
    xs_j, xt_j = j_ft.fused_traj_states_sharded(j_mesh, cfg_j, arr_j, jnp.asarray(x0),
                                                jnp.asarray(zs))
    xs_t, xt_t = t_ft.fused_traj_states_sharded(mesh, cfg_t, arr_t, T(x0), T(zs))
    np.testing.assert_allclose(N(xs_t), np.asarray(xs_j), **TOL)
    np.testing.assert_allclose(N(xt_t), np.asarray(xt_j), **TOL)
    # the shards' rows are the unsharded plain version's, row for row
    xs_u, xt_u = t_ft.fused_traj_states(cfg_t, arr_t, T(x0), T(zs))
    np.testing.assert_allclose(N(xs_t), N(xs_u), rtol=1e-6, atol=1e-6)

    term = lambda x: -0.5 * jnp.sum(x**2, axis=-1)
    ref_lp = lambda x: -0.6 * jnp.sum((x - 0.1) ** 2, axis=-1)
    t_term = lambda x: -0.5 * torch.sum(x**2, dim=-1)
    t_ref_lp = lambda x: -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)
    key = jax.random.PRNGKey(33)
    x_j, rnd_j = j_ft.fused_simulate_sharded(j_mesh, cfg_j, arr_j, key, jnp.asarray(x0),
                                             term, ref_lp)
    per_shard = [jax.random.normal(jax.random.fold_in(key, i), (K, B // 8, DIM))
                 for i in range(8)]
    fed = T(np.concatenate([np.asarray(z) for z in per_shard], axis=1))
    x_t, rnd_t = t_ft.fused_simulate_sharded(mesh, cfg_t, arr_t, None, T(x0), t_term,
                                             t_ref_lp, noise=fed)
    np.testing.assert_allclose(N(x_t), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(N(rnd_t), np.asarray(rnd_j), **TOL)

    # the fused-KL forward per shard (values only in both packages)
    xt_kj, rnd_kj, _ = j_ft._kl_forward_all(cfg_j, j_mesh, arr_j, jnp.asarray(x0),
                                            jnp.asarray(zs))
    cfg_d, arr_d = t_ft.build_plan(t_loss, t_ctrl, t_ts, differentiable=True)
    xt_kt, rnd_kt = t_ft.fused_kl_traj(cfg_d, arr_d, T(x0), T(zs), mesh=mesh)
    np.testing.assert_allclose(N(xt_kt), np.asarray(xt_kj), **TOL)
    np.testing.assert_allclose(N(rnd_kt), np.asarray(rnd_kj), **TOL)


def test_fused_kl_gradient_on_shards_equals_one_shard():
    """The adjoint runs on the gathered rows, so the gradient of a loss of
    (x_T, rnd) on 8 shards is the one-device gradient (the forward's rows
    agree to the plain version's float32 sums over other batch sizes)."""
    _, (t_loss, t_ctrl, t_ts) = _plan_pair()
    x0, zs = _inputs(4)
    grads = []
    for mesh in (None, cpu_mesh()):
        t_ctrl.zero_grad()
        cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts, differentiable=True)
        x_t, rnd = t_ft.fused_kl_traj(cfg, arrays, T(x0), T(zs), mesh=mesh)
        (rnd.mean() + 0.1 * (x_t**2).sum(-1).mean()).backward()
        grads.append([p.grad.clone() for p in t_ctrl.parameters()])
    for g1, g8 in zip(*grads):
        np.testing.assert_allclose(N(g8), N(g1), rtol=1e-5, atol=1e-6 * float(g1.abs().max()))


def _solver_args():
    rng = np.random.default_rng(7)
    return dict(solver_type="vp-ref", ref_type="gmm", loss_type="lv", integrator_type="ei",
                model_type="base_zero_init", time_type="snr",
                solver_details={"sigma": 1.0, "weights_ref": np.array([0.5, 0.5], np.float32),
                                "means_ref": np.stack([np.ones(DIM), -np.ones(DIM)]
                                                      ).astype(np.float32),
                                "variances_ref": (0.3 + 0.3 * rng.random((2, DIM))
                                                  ).astype(np.float32)},
                target_details=make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 2, "train_batch_size": 32,
                                  "eval_batch_size": B},
                n_steps=K)


def _perturbed(params, seed=3):
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.05 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def test_train_step_loss_on_1_4_8_shards_as_jax():
    """One flat-LV training step from the same parameters under the JAX
    step's own draws: the port's loss on meshes of 1, 4 and 8 shards (B1's
    plain version once a shard) equals the JAX solver's on meshes of 1, 4
    and 8 devices, and the mesh size changes neither."""
    key = jax.random.PRNGKey(11)
    k_prior, k_sim = jax.random.split(key)
    losses_j, losses_t = {}, {}
    for n in (1, 4, 8):
        j = make_model(mesh=j_get_mesh(n), **_solver_args())
        j.setup(jax.random.PRNGKey(0))
        params = _perturbed(j.state.params)
        j.state = j.state.replace(params=params)
        params = jax.tree.map(np.asarray, params)      # the JAX step donates its state
        losses_j[n] = float(j.step(key)["train/loss"])
        t = t_make_model(mesh=cpu_mesh(n), **_solver_args())
        t.setup(torch.Generator().manual_seed(0))
        t.load_flax_params(params)
        assert t.mesh.size == n and t.device == torch.device("cpu")
        assert (t.train_path(), t.eval_path()) == ("flat_lv_plain", "plain")
        fed = {"x0": T(j.prior.sample(k_prior, (32,))),
               "noise": T(jax.random.normal(jax.random.split(k_sim)[0], (K, 32, DIM)))}
        losses_t[n] = float(t.step(None, **fed)["train/loss"])
    for n in (1, 4, 8):
        np.testing.assert_allclose(losses_t[n], losses_j[n], rtol=1e-4, err_msg=f"{n} shards")
        np.testing.assert_allclose(losses_t[n], losses_t[1], rtol=1e-5)
    # a batch that does not divide the mesh keeps off the per-shard paths,
    # as in the JAX package: the loss's own loop and the eval's
    t = t_make_model(mesh=cpu_mesh(3), **_solver_args())
    assert (t.train_path(), t.eval_path()) == ("flat_lv_scan", "scan")
    for n, path in ((3, "scan"), (8, "kl_plain")):
        t = t_make_model(mesh=cpu_mesh(n), **dict(_solver_args(), loss_type="kl"))
        assert t.train_path() == path


def test_eval_split_in_shards():
    """An RDS evaluation on 8 shards: shard i's trajectories draw from
    derive_generator(generator, i), the counterpart of the JAX package's
    fold_in(key, i), and the gathered rows are the per-shard runs', in
    shard order; the fused eval sampler draws the same."""
    t = t_make_model(mesh=cpu_mesh(), **_solver_args())
    t.setup(torch.Generator().manual_seed(0))
    assert t.eval_path() == "plain"
    res = t.evaluate(torch.Generator().manual_seed(5))
    assert res.samples.shape == (B, DIM) and bool(torch.isfinite(res.rnd).all())
    g = torch.Generator().manual_seed(5)
    x0 = t.prior.sample(g, (B,))
    cfg, arrays = t_ft.build_plan(t.loss, t.generative_ctrl, t.eval_ts)
    n = B // 8
    runs = [t_ft.fused_simulate(cfg, arrays, derive_generator(g, i), x0[i * n:(i + 1) * n],
                                **t.loss_call_args()) for i in range(8)]
    np.testing.assert_array_equal(N(res.samples), N(torch.cat([r[0] for r in runs])))
    np.testing.assert_allclose(N(res.rnd), N(torch.cat([r[1] for r in runs])),
                               rtol=1e-6, atol=1e-6)
    x_s, _ = t.fused_eval_sampler()(torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(N(x_s), N(res.samples))
