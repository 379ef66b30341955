"""The port's VI losses held against the JAX package's, parametrised over
the loss: original DDS (``ExponentialIntegratorSDELoss``), discrete DIS
(``DiscreteTimeReversalLossEI``), original DIS (``TimeReversalLoss``)
without and with a learned inference control (exact divergence, and
Hutchinson under the JAX estimator's own Rademacher probes) and CMCD
(``ControlledLangevinSDELoss``). For each: ``simulate`` in train and eval
mode, the training value and gradient of the KL and LV losses, the flat LV
path's value and gradient, ``eval`` and, where the loss has one,
``compute_eubo``.

The control is a small ClippedCtrl(FourierMLP) (H 16, d 3, K 8, batch 32)
with the JAX control's parameters perturbed by 0.05 normals and carried
across by ``load_flax_params``; the target is TwoModes (d 3); inputs and
noise are numpy draws from a seed fed to both packages, or the JAX loss's
own per-step draws replayed from its key. States, RNDs and values agree at
rtol = 1e-4, atol = 1e-4 in float32 (the RNDs reach 10³ with the initial
and terminal log-densities; measured ≤ 3e-5 relative); gradients, leaf by
leaf, at rtol = 1e-3 and an atol of 1e-4 of the leaf's largest magnitude
(float32 sums over the batch and K steps in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch import losses as tl
from sde_sampler_lrds_torch import models as tm
from sde_sampler_lrds_torch import sde as ts_
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu import losses as jl
from sde_sampler_lrds_tpu import models as jm
from sde_sampler_lrds_tpu import sde as js
from sde_sampler_lrds_tpu.sde.langevin import ControlledLangevinSDE

DIM, H, K, B = 3, 16, 8, 32
TOL = dict(rtol=1e-4, atol=1e-4)
LOSSES = ("dds", "dis_discrete", "dis", "dis_gbs_exact", "dis_gbs_hutchinson", "cmcd")


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _module_pair(seed):
    j = jm.ClippedCtrl(base_model=jm.FourierMLP(dim=DIM, channels=H), clip_model=1e4)
    params = j.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, DIM)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [p + 0.05 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    t = tm.ClippedCtrl(base_model=tm.FourierMLP(dim=DIM, channels=H), clip_model=1e4)
    tm.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    return j, params, t


class Case:
    """Both packages' loss, control(s), grid and boundary log-densities."""

    def __init__(self, name, method):
        self.name = name
        details = j_api.make_target_details("two_modes", dim=DIM)
        jt, tt = j_api.make_target(details), t_api.make_target(details, device="cpu")
        self.j_term, self.t_term = jt.unnorm_log_prob, tt.unnorm_log_prob
        self.j_bnd = lambda x: -0.5 * jnp.sum(x**2, axis=-1) / 1.7 - 0.3
        self.t_bnd = lambda x: -0.5 * torch.sum(x**2, dim=-1) / 1.7 - 0.3
        self.j_mod, self.params, self.t_ctrl = _module_pair(0)
        self.inf = None
        kw = {"method": method, "max_rnd": 1e8 if method == "lv" else None}
        if name == "dds":
            self.ts = np.asarray(js.get_timesteps(0.0, 1.6, steps=K - 1, rescale_t="cosine"))
            self.j = jl.ExponentialIntegratorSDELoss(alpha=1.0, sigma=1.3, **kw)
            self.t = tl.ExponentialIntegratorSDELoss(alpha=1.0, sigma=1.3, **kw)
        elif name == "cmcd":
            self.ts = np.linspace(0.0, 1.0, K + 1).astype(np.float32)
            prior_j = lambda x: -x / 4.0
            self.j = jl.ControlledLangevinSDELoss(
                sde=ControlledLangevinSDE(jt.score, prior_j, clip_score=1e5), **kw)
            self.t = tl.ControlledLangevinSDELoss(
                sde=ts_.ControlledLangevinSDE(tt.score, prior_j, clip_score=1e5), **kw)
        else:
            self.ts = np.linspace(0.0, 1.0, K + 1).astype(np.float32)
            jv, tv = js.VP(diff_coeff_sq_max=10.0), ts_.VP(diff_coeff_sq_max=10.0)
            if name == "dis_discrete":
                self.j = jl.DiscreteTimeReversalLossEI(sde=jv, **kw)
                self.t = tl.DiscreteTimeReversalLossEI(sde=tv, **kw)
            else:
                div = "rademacher" if name == "dis_gbs_hutchinson" else None
                self.j = jl.TimeReversalLoss(sde=jv, div_estimator=div, **kw)
                self.t = tl.TimeReversalLoss(sde=tv, div_estimator=div, **kw)
                if name.startswith("dis_gbs"):
                    self.inf = _module_pair(7)
        rng = np.random.default_rng(3)
        self.x0 = rng.normal(size=(B, DIM)).astype(np.float32)
        self.zs = rng.normal(size=(K, B, DIM)).astype(np.float32)

    @property
    def ref(self):
        return self.name == "dds"

    def j_args(self):
        return ({"reference_log_prob": self.j_bnd} if self.ref
                else {"initial_log_prob": self.j_bnd})

    def t_args(self):
        return ({"reference_log_prob": self.t_bnd} if self.ref
                else {"initial_log_prob": self.t_bnd})

    def j_ctrl(self, params):
        return lambda t, x: self.j_mod.apply(params, t, x)

    def j_inf(self):
        if self.inf is None:
            return {}
        j_mod, params, _ = self.inf
        return {"inference_ctrl": lambda t, x: j_mod.apply(params, t, x)}

    def t_inf(self):
        return {} if self.inf is None else {"inference_ctrl": self.inf[2]}

    def probes(self, key):
        """The Hutchinson probes the JAX simulate draws from its key."""
        if self.name != "dis_gbs_hutchinson":
            return {}
        out, k = [], key
        for _ in range(K):
            k, _, _, k_div = jax.random.split(k, 4)
            out.append(np.asarray(jax.random.rademacher(k_div, (B, DIM), dtype=jnp.float32)))
        return {"div_probes": T(np.stack(out))}


def _flags(name, train, lv):
    """simulate's flags for a training (method's) or an eval pass."""
    f = {"change_sde_ctrl": lv and train, "return_traj": True}
    if name in ("dds", "dis", "dis_gbs_exact", "dis_gbs_hutchinson"):
        f["compute_ito_int"] = (not train) or lv
    if name != "dds":
        f["train"] = train
    return f


def _grads_close(t_module, j_grads):
    """The port module's .grad against the JAX gradient tree, leaf by leaf
    (the JAX tree loaded into a copy of the module)."""
    want = type(t_module)(base_model=tm.FourierMLP(dim=DIM, channels=H), clip_model=1e4)
    tm.load_flax_params(want, jax.tree_util.tree_map(np.asarray, j_grads))
    for (name, p), w in zip(t_module.named_parameters(), want.parameters()):
        w = N(w)
        np.testing.assert_allclose(N(p.grad), w, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("train", [True, False])
def test_simulate_matches_jax(name, train):
    c = Case(name, "lv")
    key = jax.random.PRNGKey(5)
    j_kw = dict(_flags(name, train, True), noise=jnp.asarray(c.zs), **c.j_args(), **c.j_inf())
    xj, rj, xsj = c.j.simulate(key, jnp.asarray(c.ts), jnp.asarray(c.x0), c.j_ctrl(c.params),
                               c.j_term, **j_kw)
    t_kw = dict(_flags(name, train, True), noise=T(c.zs), **c.t_args(), **c.t_inf())
    if train:
        t_kw.update(c.probes(key))
    with torch.no_grad():
        xt, rt, xst = c.t.simulate(None, T(c.ts), T(c.x0), c.t_ctrl, c.t_term, **t_kw)
    np.testing.assert_allclose(N(xt), np.asarray(xj), **TOL)
    np.testing.assert_allclose(N(xst), np.asarray(xsj), **TOL)
    np.testing.assert_allclose(N(rt), np.asarray(rj), **TOL)


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("method", ["kl", "lv"])
def test_training_value_and_grad_match_jax(name, method):
    """The loss a training step takes (simulate with the method's flags
    under the fed noise, then ``reduce``) and its gradient; the port's
    ``__call__`` under the same noise gives the same value."""
    c = Case(name, method)
    key = jax.random.PRNGKey(6)
    lv = method == "lv"

    def j_loss(params):
        kw = dict(_flags(name, True, lv), return_traj=False, noise=jnp.asarray(c.zs),
                  **c.j_args(), **c.j_inf())
        x_t, rnd, _ = c.j.simulate(key, jnp.asarray(c.ts), jnp.asarray(c.x0),
                                   c.j_ctrl(params), c.j_term, **kw)
        return c.j.reduce(rnd, samples=x_t)[0]

    want, j_grads = jax.value_and_grad(j_loss)(c.params)
    got, _ = c.t(None, T(c.ts), T(c.x0), c.t_ctrl, c.t_term, noise=T(c.zs),
                 **c.t_args(), **c.t_inf(), **c.probes(key))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    _grads_close(c.t_ctrl, j_grads)
    if name in ("dis_gbs_exact", "dis_gbs_hutchinson"):
        # the inference control's gradient through the divergence term
        j_mod, params_i, t_inf = c.inf
        j_loss_i = lambda p: c.j.reduce(c.j.simulate(
            key, jnp.asarray(c.ts), jnp.asarray(c.x0), c.j_ctrl(c.params), c.j_term,
            **dict(_flags(name, True, lv), return_traj=False, noise=jnp.asarray(c.zs),
                   **c.j_args(), inference_ctrl=lambda t, x: j_mod.apply(p, t, x)))[1])[0]
        _grads_close(t_inf, jax.grad(j_loss_i)(params_i))


@pytest.mark.parametrize("name", ["dds", "dis_discrete", "dis", "cmcd"])
def test_lv_flat_call_matches_jax(name):
    """The flat LV path's value and gradient, the JAX flat path fed its own
    noise draw (the same normals fed to the port)."""
    c = Case(name, "lv")
    key = jax.random.PRNGKey(8)
    k_z, _ = jax.random.split(key)
    zs = np.asarray(jax.random.normal(k_z, (K, B, DIM)))
    want, j_grads = jax.value_and_grad(lambda p: c.j.lv_flat_call(
        key, jnp.asarray(c.ts), jnp.asarray(c.x0), c.j_ctrl(p), c.j_term,
        **c.j_args())[0])(c.params)
    assert c.t.supports_flat_lv(T(c.ts), frozenset({"terminal_unnorm_log_prob",
                                                    *c.t_args()}))
    got, _ = c.t.lv_flat_call(None, T(c.ts), T(c.x0), c.t_ctrl, c.t_term, noise=T(zs),
                              **c.t_args())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    _grads_close(c.t_ctrl, j_grads)
    # the flat path and the scan give the same LV value (JAX's own identity)
    scan, _ = c.t(None, T(c.ts), T(c.x0), c.t_ctrl, c.t_term, noise=T(zs), **c.t_args())
    np.testing.assert_allclose(float(scan.detach()), float(got.detach()), rtol=1e-4)


@pytest.mark.parametrize("name", LOSSES)
def test_eval_and_eubo_match_jax(name):
    c = Case(name, "lv")
    key = jax.random.PRNGKey(9)
    j_kw = dict(c.j_args(), **c.j_inf())
    if name in ("dds", "dis", "dis_gbs_exact", "dis_gbs_hutchinson"):
        # these evals draw inside the scan: feed the JAX simulate's noise
        want = c.j.simulate(key, jnp.asarray(c.ts), jnp.asarray(c.x0), c.j_ctrl(c.params),
                            c.j_term, **_flags(name, False, False), noise=jnp.asarray(c.zs),
                            **j_kw)
        want_rnd = want[1]
    else:
        want_rnd = c.j.simulate(key, jnp.asarray(c.ts), jnp.asarray(c.x0),
                                c.j_ctrl(c.params), c.j_term, train=False,
                                noise=jnp.asarray(c.zs), **j_kw)[1]
    res = c.t.eval(None, T(c.ts), T(c.x0), c.t_ctrl, c.t_term, noise=T(c.zs),
                   **c.t_args(), **c.t_inf())
    np.testing.assert_allclose(N(res.rnd), np.asarray(want_rnd), **TOL)
    assert res.xs.shape == (K + 1, B, DIM) and "log_norm_const_is" in res.log_norm_const_preds
    if getattr(c.j, "compute_eubo", None) is None:
        assert getattr(c.t, "compute_eubo", None) is None
        return
    x_target = np.random.default_rng(4).normal(size=(B, DIM)).astype(np.float32)
    want = c.j.compute_eubo(key, jnp.asarray(c.ts), jnp.asarray(x_target),
                            c.j_ctrl(c.params), c.j_term, **c.j_args())
    if name == "dis_discrete":
        noise = np.asarray(jax.random.normal(key, (K, B, DIM)))
    else:   # CMCD's reverse pass splits its key each step
        noise, k = [], key
        for _ in range(K):
            k, k_db = jax.random.split(k)
            noise.append(np.asarray(jax.random.normal(k_db, (B, DIM))))
        noise = np.stack(noise)
    got = c.t.compute_eubo(None, T(c.ts), T(x_target), c.t_ctrl, c.t_term, noise=T(noise),
                           **c.t_args())
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)


def test_original_dis_rnd_pairs_an_expanding_noising_law():
    """Original DIS's log-ratio (``TimeReversalLoss``, both packages) is a
    proper one against the initial law q₀ of an expanding noising process,
    not against the VP prior p₀ = N(0, 1) the solvers pair it with. On a
    1-D Gaussian target N(0.5, 0.8²) with VP(0.1, 10) (∫β = 5.05), under
    the fed noise and for two controls: with ``initial_log_prob`` the
    density of q₀ = N(m·e^{∫β/2}, (s² + 1)·e^{∫β} − 1) (the law at the end
    of dY = +½β(T − t)Y dt + √β(T − t) dW from the target), the IS estimate
    of log Z (= 0) is unbiased; with p₀, rnd gains log p₀(X₀) − log q₀(X₀),
    so the ELBO sits at least KL(p₀‖q₀) = 2.37 nats below log Z whatever
    the control (and the IS weights gain a factor q₀/p₀ of infinite
    variance). That gap, d·KL per dimension, is the DIS records' error
    (ROADMAP §C). The two packages agree. 2^15 draws, K 200: the unbiased
    estimate's standard error is 0.013."""
    import math

    m, s, k, b = 0.5, 0.8, 200, 1 << 15
    ts = np.linspace(0.0, 1.0, k + 1).astype(np.float32)
    ib = 0.1 + 0.5 * (10.0 - 0.1)                                     # ∫₀¹ β
    q_mu, q_var = m * math.exp(ib / 2), (s * s + 1) * math.exp(ib) - 1
    kl = 0.5 * (math.log(q_var) + (1.0 + q_mu**2) / q_var - 1.0)      # KL(p₀‖q₀)

    def gauss(lib, mu, var):
        return lambda x: (-0.5 * (x - mu) ** 2 / var - 0.5 * math.log(2 * math.pi * var)).sum(-1)

    laws = {"prior": (0.0, 1.0), "expanding": (q_mu, q_var)}
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(b, 1)).astype(np.float32)
    zs = rng.normal(size=(k, b, 1)).astype(np.float32)
    ctrls = {"zero": (lambda t, x: jnp.zeros_like(x), lambda t, x: torch.zeros_like(x)),
             "linear": (lambda t, x: 0.3 * x + 0.2 - 0.5 * t,
                        lambda t, x: 0.3 * x + 0.2 - 0.5 * t)}
    for cname, (j_ctrl, t_ctrl) in ctrls.items():
        elbo = {}
        for name, (mu, var) in laws.items():
            j = jl.TimeReversalLoss(sde=js.VP(0.1, 10.0), method="lv").simulate(
                jax.random.PRNGKey(0), jnp.asarray(ts), jnp.asarray(x0), j_ctrl,
                gauss(jnp, m, s * s), initial_log_prob=gauss(jnp, mu, var), train=False,
                compute_ito_int=True, noise=jnp.asarray(zs))[1]
            t = tl.TimeReversalLoss(sde=ts_.VP(0.1, 10.0), method="lv").eval(
                None, T(ts), T(x0), t_ctrl, gauss(torch, m, s * s),
                initial_log_prob=gauss(torch, mu, var), noise=T(zs), return_traj=False)
            np.testing.assert_allclose(N(t.rnd), np.asarray(j), **TOL)
            elbo[name] = t.metrics["eval/elbo"]
            if name == "expanding":
                log_z = t.log_norm_const_preds["log_norm_const_is"]
                assert abs(log_z) < 0.06, (cname, log_z)
                assert elbo[name] <= 0.0
        assert elbo["prior"] <= -kl < -2.3, (cname, elbo, kl)
