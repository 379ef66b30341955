"""Widths past the port's narrow kernel limits (ROADMAP C6), held against
the JAX package on the CPU. The JAX package takes any width; the port's
narrow B1 kernels stop at D 128 with a full-covariance reference and at the
block's shared memory with a diagonal one (D 364 at H 64 with two hidden
layers), and past them ``build_plan`` still gives a plan, which the wide
kernel runs (``uses_wide``: every trajectory's rows in shared memory, the
weights and rotations read from global memory). The solvers keep the
kernel's paths ('flat_lv_plain' / 'plain' here, 'flat_lv_fused' / 'fused'
on the card). The wide kernel runs only on the card (chip_smoke.py phase
15 (f) holds it against its plain version); here the plan's plain version
is held against the JAX Pallas kernel in interpret mode at D 129, and its
host geometry is checked. The Sinkhorn kernels stop at d 224; past it the
Sinkhorn runs its plain versions on the tensors' device and records
backend 'plain'.

Tiny depth (K 6, batch 16); tolerances as tests/test_torch_experiments.py
(losses and the evaluation's states and log-ratios 1e-4, the log-ratios'
absolute part grown by √(D/3) from its D 3) and
tests/test_torch_nn_reference.py (each update 1e-3 relative with 1e-3 of
the leaf's largest update).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.eval import sinkhorn as t_sinkhorn
from sde_sampler_lrds_torch.ops import fused_traj as t_ft
from sde_sampler_lrds_torch.ops.sinkhorn_lse import MAX_DIM
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh

K, B = 6, 16
FULL_DIM = t_ft.MAX_FULL_COV_DIM + 1


def _first_diag_dim_past_limit(channels=64, n_hidden=2) -> int:
    cfg = lambda d: t_ft.FusedTrajCfg(k_steps=K, dim=d, channels=channels,
                                      n_hidden=n_hidden, n_comp=2, clip=1e4)
    return next(d for d in range(1, t_ft.MAX_DIAG_DIM + 2)
                if t_ft.limit_error(cfg(d)) is not None)


DIAG_DIM = _first_diag_dim_past_limit()


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


def _gmm(dim: int, full: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    means = np.stack([-np.ones(dim), np.ones(dim)]).astype(np.float32)
    if full:
        a = rng.normal(size=(2, dim, dim))
        var = (0.05 * a @ a.transpose(0, 2, 1) / dim + 0.05 * np.eye(dim)).astype(np.float32)
    else:
        var = (0.04 + 0.02 * rng.random((2, dim))).astype(np.float32)
    return {"sigma": 1.0, "weights_ref": np.array([0.6, 0.4], np.float32),
            "means_ref": means, "variances_ref": var}


def _args(dim: int, full: bool, loss_type: str = "lv") -> dict:
    return dict(solver_type="vp-ref", ref_type="gmm", loss_type=loss_type,
                integrator_type="ei", model_type="base_zero_init", time_type="snr",
                solver_details=_gmm(dim, full),
                target_details=make_target_details("two_modes", dim=dim),
                training_details={"train_steps": 2, "train_batch_size": B,
                                  "eval_batch_size": B},
                n_steps=K)


@pytest.mark.parametrize("dim,full", [(FULL_DIM, True), (DIAG_DIM, False)],
                         ids=["full_cov_d129", "diagonal_first_past_limit"])
def test_paths_past_the_kernel_limits(dim, full):
    """D 129 with a full-covariance reference and the first diagonal D the
    narrow kernels refuse (364 + 1 at H 64, two hidden layers) keep the
    kernel's paths in training and evaluation (LV and KL): check_limits
    refuses the plan, so it runs on the wide kernel, which takes it."""
    if not full:
        assert DIAG_DIM == 365
    t = t_make_model(device="cpu", **_args(dim, full))
    assert t.loss.reference_ctrl is not None
    assert (t.train_path(), t.eval_path()) == ("flat_lv_plain", "plain")
    cfg, _ = t_ft.build_plan(t.loss, t.generative_ctrl, t.train_ts)
    assert (cfg.dim, cfg.full_cov, cfg.channels, cfg.n_hidden) == (dim, full, 64, 2)
    with pytest.raises(ValueError, match="fused_traj kernel"):
        t_ft.check_limits(cfg)
    assert t_ft.uses_wide(cfg) and t_ft.wide_limit_error(cfg) is None
    kl = t_make_model(device="cpu", **_args(dim, full, loss_type="kl"))
    assert kl._fused_kl_fn() is not None and kl.train_path() == "kl_plain"
    # one D less is inside the narrow kernels' limits: the same paths
    inside = t_make_model(device="cpu", **_args(dim - 1, full))
    assert (inside.train_path(), inside.eval_path()) == ("flat_lv_plain", "plain")
    in_cfg, _ = t_ft.build_plan(inside.loss, inside.generative_ctrl, inside.train_ts)
    assert not t_ft.uses_wide(in_cfg)


def _perturbed(j, seed=3):
    leaves, tree = jax.tree_util.tree_flatten(j.state.params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.01 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _flat(t, j_params=None):
    if j_params is not None:
        t = copy.deepcopy(t)
        t.load_flax_params(jax.tree_util.tree_map(np.asarray, j_params))
    return [N(p).copy() for p in t.module.parameters()]


@pytest.mark.parametrize("dim,full", [(FULL_DIM, True), (DIAG_DIM, False)],
                         ids=["full_cov_d129", "diagonal_first_past_limit"])
def test_step_and_eval_past_the_limits_match_jax(dim, full):
    """One LV training step under the JAX step's own draws and one
    evaluation under the JAX scan's per-step draws, from the same
    parameters: the loss, each update, the samples and the log-ratios."""
    args = _args(dim, full)
    j = make_model(mesh=get_mesh(1), **args)
    t = t_make_model(device="cpu", **args)
    j.setup(jax.random.PRNGKey(0))
    j.state = j.state.replace(params=_perturbed(j))
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    key = jax.random.PRNGKey(20)
    k_prior, k_sim = jax.random.split(key)
    fed = {"x0": T(j.prior.sample(k_prior, (B,))),
           "noise": T(jax.random.normal(jax.random.split(k_sim)[0], (K, B, dim)))}
    before = _flat(t)
    want = j.step(key)
    got = t.step(None, **fed)
    np.testing.assert_allclose(float(got["train/loss"]), float(want["train/loss"]),
                               rtol=1e-4, atol=1e-5)
    for b, p, w in zip(before, _flat(t), _flat(t, j.state.params)):
        want_upd, got_upd = w - b, p - b
        np.testing.assert_allclose(got_upd, want_upd, rtol=1e-3,
                                   atol=1e-3 * np.abs(want_upd).max() + 1e-6 * np.abs(b).max())
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    key = jax.random.PRNGKey(12)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (B,)))
    zs, kk = [], k_sim
    for _ in range(K):
        kk, k_z, _ = jax.random.split(kk, 3)
        zs.append(np.asarray(jax.random.normal(k_z, (B, dim))))
    want = j.evaluate(key)
    got = t.loss.eval(None, t.eval_ts, T(x0), t.eval_module(), noise=T(np.stack(zs)),
                      **t.loss_call_args())
    np.testing.assert_allclose(N(got.samples), np.asarray(want.samples), rtol=1e-4, atol=1e-4)
    # the log-ratio sums D terms a step: 1e-4 at D 3, grown as the rounding
    # of a D-term float32 sum does
    np.testing.assert_allclose(N(got.rnd), np.asarray(want.rnd), rtol=1e-4,
                               atol=1e-4 * np.sqrt(dim / 3))
    # the fused evaluation (the wide kernel's plan, its plain version here)
    # under the same draws
    cfg, arrays = t._fused_eval_plan()
    assert t_ft.uses_wide(cfg)
    samples, rnd = t_ft.fused_simulate(cfg, arrays, None, T(x0), noise=T(np.stack(zs)),
                                       **t.loss_call_args())
    np.testing.assert_allclose(N(samples), np.asarray(want.samples), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(rnd), np.asarray(want.rnd), rtol=1e-4,
                               atol=1e-4 * np.sqrt(dim / 3))


@pytest.mark.parametrize("dim,full", [(FULL_DIM, True), (DIAG_DIM, False)],
                         ids=["full_cov_d129", "diagonal_first_past_limit"])
def test_wide_plan_plain_matches_jax_kernel(dim, full):
    """The TPU kernel takes these widths: the port's plan and its plain
    version against the JAX plan and its Pallas kernel in interpret mode,
    under fed noise, with the states (an O(1) control: the perturbed
    parameters). Tolerance as tests/test_torch_fullcov.py's 1e-4, the
    absolute part grown by √(D/8) from its D 8."""
    args = _args(dim, full)
    j = make_model(mesh=get_mesh(1), **args)
    t = t_make_model(device="cpu", **args)
    j.setup(jax.random.PRNGKey(0))
    params = _perturbed(j)
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    cfg_j, arr_j = j_ft.build_plan(j.loss, j.generative_ctrl, j.ctrl_params(params),
                                   j.train_ts, block_b=128)
    cfg_t, arr_t = t_ft.build_plan(t.loss, t.generative_ctrl, t.train_ts)
    assert (cfg_j.dim, cfg_j.full_cov) == (cfg_t.dim, cfg_t.full_cov) == (dim, full)
    assert t_ft.uses_wide(cfg_t)
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(B, dim)).astype(np.float32)
    noise = rng.normal(size=(K, B, dim)).astype(np.float32)
    want = j_ft._fused_traj(cfg_j, arr_j, jnp.asarray(x0), jnp.asarray(noise), True, True)
    got = t_ft.fused_traj(cfg_t, arr_t, T(x0), noise=T(noise), return_traj=True)
    tol = dict(rtol=1e-4, atol=1e-4 * np.sqrt(dim / 8))
    for name, g, w in zip(("x_T", "rnd", "xs"), got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("batch", [1, 16, 256, 1000, 2048, 8192, 100_000])
@pytest.mark.parametrize("dim,channels", [(129, 64), (196, 64), (365, 64), (500, 300),
                                          (1500, 64), (3194, 64)])
def test_wide_rows_cover_the_batch(batch, dim, channels):
    """The wide kernel's block: a multiple of 4 trajectories (one register
    tile) up to 32 whose rows fit the card's shared memory, as many blocks
    as cover the card's 132 SMs where the batch allows it, and every
    trajectory in exactly one block."""
    tb = t_ft.wide_rows(batch, dim, channels, 132)
    blocks = -(-batch // tb)
    assert tb % 4 == 0 and 4 <= tb <= 32 and (blocks - 1) * tb < batch <= blocks * tb
    assert t_ft.wide_smem_bytes(dim, channels, tb) <= t_ft.MAX_SMEM_BYTES
    want = min(32, max(4, -(-(-(-batch // 132)) // 4) * 4))
    assert tb == want or (tb < want and t_ft.wide_smem_bytes(dim, channels, tb + 4)
                          > t_ft.MAX_SMEM_BYTES)


def test_wide_smem_formula_and_limit():
    """Four rows of tb·D (state, control, noise, score) and two of tb·H
    (hidden), each padded to 16 bytes, 3·32 softmax factors and the step's
    2·D + 1 reference entries padded so; the wide kernel's one limit is a
    block of 4 trajectories: D 3194 at H 64, and past it launch refuses."""
    assert t_ft.wide_smem_bytes(196, 64, 16) == 4 * (4 * 3136 + 2 * 1024 + 96 + 396)
    assert t_ft.wide_smem_bytes(129, 64, 4) == 4 * (4 * 516 + 2 * 256 + 96 + 260)
    cfg = lambda d: t_ft.FusedTrajCfg(k_steps=K, dim=d, channels=64, n_hidden=2, n_comp=2,
                                      clip=None, full_cov=True)
    assert t_ft.wide_limit_error(cfg(3194)) is None
    assert "shared memory" in t_ft.wide_limit_error(cfg(3195))
    with pytest.raises(ValueError, match="shared memory"):
        t_ft.wide_rows(16, 3195, 64, 132)
    # the narrow kernels' limits stand: channels and hidden layers past them
    # go wide too
    many = t_ft.FusedTrajCfg(k_steps=K, dim=8, channels=300, n_hidden=9, n_comp=1, clip=None)
    assert t_ft.uses_wide(many) and t_ft.wide_limit_error(many) is None


def test_sinkhorn_past_the_kernel_width_runs_the_plain_versions(monkeypatch):
    """At d 225 the Sinkhorn takes PLAIN_OPS whatever the device (the
    kernel ops are never called, shown here by ops that raise), equals a
    PLAIN_OPS run and records backend 'plain'; at d 224 it still takes the
    kernel ops."""
    def refused(*a, **k):
        raise AssertionError("the kernel ops ran past their width")

    monkeypatch.setattr(t_sinkhorn, "KERNEL_OPS", (refused, refused))
    rng = np.random.default_rng(5)
    x = T(rng.normal(size=(96, MAX_DIM + 1)).astype(np.float32))
    y = T((0.5 + rng.normal(size=(80, MAX_DIM + 1))).astype(np.float32))
    sk = t_sinkhorn.Sinkhorn(max_iters=30)
    got = sk(x, y)
    assert sk.config["backend"] == "plain" and sk.n_iters == 30
    want = t_sinkhorn.Sinkhorn(max_iters=30).compute(x, y, ops=t_sinkhorn.PLAIN_OPS)
    assert float(got) == float(want) and np.isfinite(float(got))
    with pytest.raises(AssertionError, match="past their width"):
        sk(x[:, :MAX_DIM], y[:, :MAX_DIM])
