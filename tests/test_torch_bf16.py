"""The port's bf16 control mode held against the JAX package: FourierMLP /
ClippedCtrl with ``compute_dtype=bfloat16`` (Flax ``nn.Dense(dtype=bf16)``
semantics), the bf16 plan tables, the fused trajectory's bf16 plain version
against the JAX Pallas kernel in interpret mode (block_b 32, so two tiles
run) and against the JAX loss's own loop, the flat-LV loss and its
gradient, and the solver's routing with a bf16 control.

Both packages get the same weights (``load_flax_params``), inputs and noise,
made with numpy from a seed; the port's TimeEmbed frequencies are set to
``jnp.linspace``'s (they differ from ``torch.linspace``'s by up to an ulp,
ROADMAP §C). The dense layers round as Flax's do, bit for bit; XLA on the
CPU computes gelu on bf16 values with a rounding after each of its
operations, where the port (and the CUDA kernel) computes it in float32 and
rounds once, so activations differ by about one bf16 ulp (2⁻⁸ relative) and
every tolerance below is stated in bf16 ulps of the compared values' scale.
The CUDA kernel itself runs only on the card: chip_smoke.py holds it against
its bf16 plain version there.
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
from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl as TGMMRef
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsoGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu import losses as j_losses
from sde_sampler_lrds_tpu.models import ClippedCtrl, FourierMLP
from sde_sampler_lrds_tpu.ops import fused_traj as j_ft
from sde_sampler_lrds_tpu.sde import VP, get_timesteps
from sde_sampler_lrds_tpu.solvers.oc import GMMReferenceCtrl

DIM, K, B, H = 8, 12, 64, 64
BF16_ULP = 2.0**-8          # bf16 spacing relative to a value's scale
# the JAX package's own bf16 parity of its kernel against its scan
# (tests/test_fused_traj.py:141-142), K = 12
X_TOL = dict(rtol=2e-2, atol=2e-2)
RND_TOL = dict(rtol=2e-2, atol=5e-2)


def T(a):
    if isinstance(a, tuple):
        return tuple(T(v) for v in a)
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().float().cpu().numpy()


def assert_within_ulps(got, want, n_ulps, what="", scale=None):
    """|got − want| ≤ n_ulps bf16 ulps of ``scale`` (want's largest entry
    by default)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=n_ulps * BF16_ULP * scale,
                               err_msg=what)


def _controls(clip=1e4, seed=0):
    """The same bf16 control in both packages."""
    base = FourierMLP(dim=DIM, channels=H, num_layers=4, compute_dtype=jnp.bfloat16)
    ctrl = ClippedCtrl(base_model=base, clip_model=clip) if clip else base
    params = jax.tree.map(np.asarray, ctrl.init(
        jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM))))
    t_base = TFourier(dim=DIM, channels=H, num_layers=4, compute_dtype=torch.bfloat16)
    t_ctrl = TClipped(t_base, clip_model=clip) if clip else t_base
    load_flax_params(t_ctrl, params)
    t_base.time_embed.coeff.copy_(T(jnp.linspace(0.1, 100.0, H)[None, :]))
    return ctrl, params, t_ctrl


def _setup(ref_kind="gmm", family="EIReferenceSDELoss", method="kl", seed=0):
    ctrl, params, t_ctrl = _controls(seed=seed)
    rng = np.random.default_rng(seed + 1)
    means = rng.normal(size=(3, DIM)).astype(np.float32)
    weights = (0.5 + rng.random(3)).astype(np.float32)
    if ref_kind == "gmm_full":
        a = rng.normal(size=(3, DIM, DIM))
        eig, p = np.linalg.eigh(a @ a.transpose(0, 2, 1) / DIM + 0.5 * np.eye(DIM))
        var = (eig.astype(np.float32), p.astype(np.float32))
        j_var = tuple(map(jnp.asarray, var))
    else:
        var = (0.5 + rng.random((3, DIM))).astype(np.float32)
        j_var = jnp.asarray(var)
    sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    ref = GMMReferenceCtrl(sde, jnp.asarray(means), j_var, jnp.asarray(weights))
    t_ref = TGMMRef(t_sde, T(means), T(var), T(weights))
    loss = getattr(j_losses, family)(sde=sde, method=method, max_rnd=1e8, reference_ctrl=ref)
    t_loss = getattr(t_losses, family)(sde=t_sde, method=method, max_rnd=1e8,
                                       reference_ctrl=t_ref)
    ts = get_timesteps(0.0, 1.0, steps=K)
    return (loss, ctrl, params, ts), (t_loss, t_ctrl, T(ts))


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, DIM)).astype(np.float32),
            rng.normal(size=(K, B, DIM)).astype(np.float32))


def term(x):
    return -0.5 * jnp.sum(x**2, axis=-1)


def ref_lp(x):
    return -0.6 * jnp.sum((x - 0.1) ** 2, axis=-1)


def t_term(x):
    return -0.5 * torch.sum(x**2, dim=-1)


def t_ref_lp(x):
    return -0.6 * torch.sum((x - 0.1) ** 2, dim=-1)


@pytest.mark.parametrize("clip", [1e4, 0.3, None])
@pytest.mark.parametrize("times", ["one", "per_row"])
def test_bf16_control_matches_flax(clip, times):
    ctrl, params, t_ctrl = _controls(clip=clip)
    rng = np.random.default_rng(5)
    x = (1.5 * rng.normal(size=(B, DIM))).astype(np.float32)
    t = np.float32(0.37) if times == "one" else rng.random(B).astype(np.float32)
    want = np.asarray(ctrl.apply(params, jnp.asarray(t), jnp.asarray(x)))
    got = t_ctrl(T(t), T(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # one bf16 ulp of gelu rounding per layer, carried through the layers,
    # in ulps of the output before the clip
    base = t_ctrl.base_model if clip else t_ctrl
    with torch.no_grad():
        scale = float(base(T(t), T(x)).abs().max())
    assert_within_ulps(N(got), want, 4, scale=scale)
    # the parameters stay float32 and receive float32 gradients through the casts
    got.square().sum().backward()
    assert all(p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
               for p in t_ctrl.parameters())


def test_bf16_plan_tables_match_jax():
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup()
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=32)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert cfg_j.bf16 and cfg_t.bf16 and set(arr_t) == set(arr_j)
    for name in ("w0", "b0", "wh", "bh", "w_out", "b_out"):
        assert arr_t[name].dtype == torch.bfloat16
        # both packages cast the same float32 weights round-to-nearest-even
        np.testing.assert_array_equal(N(arr_t[name]), np.asarray(arr_j[name], np.float32),
                                      err_msg=name)
    assert arr_t["embed"].dtype == torch.bfloat16 and arr_t["coefs"].dtype == torch.float32
    assert_within_ulps(N(arr_t["embed"]), np.asarray(arr_j["embed"], np.float32), 4)
    # a float16 compute dtype is out of the kernel's scope, as in the JAX package
    t_loss_ctrl = TClipped(TFourier(dim=DIM, channels=H, compute_dtype=torch.float16), 1e4)
    assert t_ft.build_plan(t_loss, t_loss_ctrl, t_ts) is None


@pytest.mark.parametrize("ref_kind", ["gmm", "gmm_full"])
def test_bf16_plain_matches_jax_kernel_and_scan(ref_kind):
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(ref_kind)
    cfg_j, arr_j = j_ft.build_plan(loss, ctrl, params, ts, block_b=32)
    cfg_t, arr_t = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    assert cfg_t.bf16 and cfg_t.full_cov == (ref_kind == "gmm_full")
    x0, noise = _inputs()
    x_k, r_k = j_ft.fused_simulate(cfg_j, arr_j, None, jnp.asarray(x0), term, ref_lp,
                                   noise=jnp.asarray(noise))
    x_s, r_s, _ = loss.simulate(jax.random.PRNGKey(7), ts, jnp.asarray(x0),
                                lambda t, x: ctrl.apply(params, t, x), term, ref_lp,
                                noise=jnp.asarray(noise))
    x_p, r_p = t_ft.fused_simulate(cfg_t, arr_t, None, T(x0), t_term, t_ref_lp,
                                   noise=T(noise))
    for x_w, r_w in ((x_k, r_k), (x_s, r_s)):
        np.testing.assert_allclose(N(x_p), x_w, **X_TOL)
        np.testing.assert_allclose(N(r_p), r_w, **RND_TOL)
    # the port's own loop with the bf16 control
    with torch.no_grad():
        x_l, r_l, _ = t_loss.simulate(None, t_ts, T(x0), t_ctrl, t_term, t_ref_lp,
                                      noise=T(noise))
    np.testing.assert_allclose(N(x_p), N(x_l), **X_TOL)
    np.testing.assert_allclose(N(r_p), N(r_l), **RND_TOL)
    # the pre-step states of the flat LV path, against the JAX entry point
    xs_j, xt_j = j_ft.fused_traj_states(cfg_j, arr_j, jnp.asarray(x0), jnp.asarray(noise))
    xs_t, xt_t = t_ft.fused_traj_states(cfg_t, arr_t, T(x0), T(noise))
    np.testing.assert_array_equal(N(xs_t[0]), x0)
    np.testing.assert_allclose(N(xs_t), xs_j, **X_TOL)
    np.testing.assert_allclose(N(xt_t), xt_j, **X_TOL)


def test_bf16_lv_flat_call_matches_jax():
    (loss, ctrl, params, ts), (t_loss, t_ctrl, t_ts) = _setup(method="lv")
    x0, _ = _inputs(seed=6)
    key = jax.random.PRNGKey(8)
    # the noise JAX's lv_flat_call draws from its key (_flat_lv_setup)
    zs = np.asarray(jax.random.normal(jax.random.split(key)[0], (K, B, DIM)))

    def j_loss(p):
        return loss.lv_flat_call(key, ts, jnp.asarray(x0), lambda t, x: ctrl.apply(p, t, x),
                                 term, ref_lp)[0]

    v_j, g_j = jax.value_and_grad(j_loss)(params)
    cfg, arrays = t_ft.build_plan(t_loss, t_ctrl, t_ts)
    for traj_fn in (None, lambda x, z: t_ft.fused_traj_states(cfg, arrays, x, z)):
        t_ctrl.zero_grad()
        v_t, _ = t_loss.lv_flat_call(None, t_ts, T(x0), t_ctrl, t_term, t_ref_lp,
                                     traj_fn=traj_fn, noise=T(zs))
        v_t.backward()
        # a variance of K = 12 steps of bf16 controls: 8 ulps relative
        np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=8 * BF16_ULP)
        base = t_ctrl.base_model
        pairs = [(base.x_embed, "Dense_0"), (base.out, "Dense_3"),
                 *[(l, f"Dense_{i}") for i, l in enumerate(base.hidden, start=1)],
                 (base.time_embed.dense[0], ("TimeEmbed_0", "Dense_0")),
                 (base.time_embed.out, ("TimeEmbed_0", "Dense_1"))]
        tree = g_j["params"]["base_model"]
        for layer, name in pairs:
            sub = tree[name[0]][name[1]] if isinstance(name, tuple) else tree[name]
            # gradients summed over K·B bf16 controls: 16 ulps of the leaf's scale
            assert_within_ulps(N(layer.weight.grad).T, sub["kernel"], 16, str(name))
            assert_within_ulps(N(layer.bias.grad), sub["bias"], 16, str(name))


def _solver(method):
    ctrl = TClipped(TFourier(dim=DIM, channels=H, num_layers=4, zero_init=True,
                             compute_dtype=torch.bfloat16), clip_model=1e4)
    cfg = TTrainConfig(train_batch_size=32, eval_batch_size=32, lr=1e-3)
    solver = TRDS(TManyModes(n_modes=3, dim=DIM, var=0.3, n_reference_samples=500,
                             device="cpu"),
                  TIsoGauss(dim=DIM, device="cpu"), TVP(0.1, 10.0), ctrl,
                  t_losses.EIReferenceSDELoss, {"method": method, "max_rnd": 1e8},
                  train_ts=T(get_timesteps(0.0, 1.0, steps=K)), cfg=cfg, device="cpu")
    solver.setup()
    return solver


def test_solver_routes_bf16_control():
    """LV training takes the flat path through the bf16 plain trajectory and
    the eval the fused one; KL training refuses the fused KL path (its
    adjoint mirrors a float32 control) and runs the loss's own loop."""
    g = torch.Generator().manual_seed(1)
    lv = _solver("lv")
    assert lv.train_path() == "flat_lv_plain" and lv.eval_path() == "plain"
    plan = t_ft.build_plan(lv.loss, lv.generative_ctrl, lv.train_ts)
    assert plan is not None and plan[0].bf16
    assert np.isfinite(float(lv.step(g)["train/loss"]))
    res = lv.evaluate(g)
    assert res.samples.shape == (32, DIM) and np.isfinite(N(res.rnd)).all()
    kl = _solver("kl")
    assert kl._fused_kl_fn() is None and kl.train_path() == "scan"
    assert np.isfinite(float(kl.step(g)["train/loss"])) and kl.n_skipped == 0
    with pytest.raises(ValueError, match="float32 plan"):
        t_ft.fused_kl_traj(*plan, torch.zeros(4, DIM), torch.zeros(K, 4, DIM))
