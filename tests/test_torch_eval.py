"""The port's sample-based evaluation held against the JAX package: the
Sinkhorn log-sum-exp and transport-cost reductions (the plain versions of
kernels B2 and B3), the Sinkhorn distance, the median-heuristic MMD, the
sliced KS distance, ``get_metrics`` and ``RDS.eval_metrics``.

Inputs are drawn with numpy from a seed and handed to both packages. Where
the JAX code draws internally (KS projections, target draws) the draw is
rebuilt from its key, or replaced on both sides by the same numpy array.
Everything runs in float32 on the CPU; each tolerance is stated with its
reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.eval import Sinkhorn as TSinkhorn
from sde_sampler_lrds_torch.eval import compute_sliced_ks as t_ks
from sde_sampler_lrds_torch.eval import get_metrics as t_get_metrics
from sde_sampler_lrds_torch.eval import mmd_median as t_mmd
from sde_sampler_lrds_torch.eval.mmd import median as t_median
from sde_sampler_lrds_torch.eval.sinkhorn import PLAIN_OPS
from sde_sampler_lrds_torch.losses import EIReferenceSDELoss as TEILoss
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.ops import sinkhorn_lse as t_ops
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import RDS as TRDS
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsoGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu.eval.ks import compute_sliced_ks
from sde_sampler_lrds_tpu.eval.metrics import get_metrics
from sde_sampler_lrds_tpu.eval.mmd import mmd_median
from sde_sampler_lrds_tpu.eval.sinkhorn import Sinkhorn
from sde_sampler_lrds_tpu.losses import compute_results
from sde_sampler_lrds_tpu.ops.sinkhorn_lse import pallas_lse, pallas_transport_cost
from sde_sampler_lrds_tpu.solvers.base import Trainable
from sde_sampler_lrds_tpu.targets import ManyModes
from sde_sampler_lrds_tpu.utils.common import Results


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _points(seed, n, m, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (0.5 + 1.3 * rng.normal(size=(m, d))).astype(np.float32)
    return rng, x, y


# ---------------------------------------------------------------------------
# B2 / B3 plain versions
# ---------------------------------------------------------------------------

# ragged on both axes against the JAX kernel's 8-row / 128-column tiles
SHAPES = [(37, 300, 3), (130, 129, 8)]


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_plain_matches_jax(p, shape):
    n, m, d = shape
    rng, x, y = _points(p, n, m, d)
    eps = 0.1
    dual = (eps * rng.normal(size=(m,))).astype(np.float32)
    dual[::7] = -np.inf                       # −inf duals drop out of the sum
    got = N(t_ops.lse(T(x), T(y), T(dual), eps, p))
    want_k = np.asarray(pallas_lse(x, y, dual, eps, p=p, bn=8, bm=128, interpret=True))
    want_x = np.asarray(Sinkhorn(p=p)._blocked_lse(jnp.asarray(x), jnp.asarray(y),
                                                   jnp.asarray(dual), eps, False))
    assert got.shape == (n,) and np.isfinite(got).all()
    # logits ~ 50 at eps = 0.1: float32 cost sums in other orders differ by a
    # few ulps of the cost (1e-6 relative), i.e. ~1e-5 in the logits
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want_x, rtol=1e-5, atol=1e-4)


def test_lse_all_minus_inf_row_and_tile():
    """A dual of −inf everywhere gives −inf, never NaN; a whole −inf column
    tile contributes nothing."""
    _, x, y = _points(5, 20, 256, 4)
    dual = np.zeros((256,), np.float32)
    dual[:128] = -np.inf                       # one whole JAX column tile
    got = N(t_ops.lse(T(x), T(y), T(dual), 0.5, 2))
    want = np.asarray(pallas_lse(x, y, dual, 0.5, p=2, bn=8, bm=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    all_inf = N(t_ops.lse(T(x), T(y), T(np.full((256,), -np.inf, np.float32)), 0.5, 2))
    assert np.all(all_inf == -np.inf)


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_transport_cost_plain_matches_jax(p, shape):
    n, m, d = shape
    rng, x, y = _points(10 + p, n, m, d)
    eps = 0.5
    u = (eps * (-np.log(n) + 0.3 * rng.normal(size=(n,)))).astype(np.float32)
    v = (eps * (-np.log(m) + 0.3 * rng.normal(size=(m,)))).astype(np.float32)
    u[3] = -np.inf
    v[::11] = -np.inf
    got = float(t_ops.transport_cost(T(x), T(y), T(u), T(v), eps, p))
    want = float(pallas_transport_cost(x, y, u, v, eps, p=p, bn=8, bm=128, interpret=True))
    assert np.isfinite(got)
    # a sum of n·m float32 terms in two orders
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_plain_versions_block_rows(monkeypatch):
    """The plain versions build the cost matrix a block of rows at a time;
    many small blocks give what one block gives."""
    rng, x, y = _points(3, 50, 40, 3)
    dual = rng.normal(size=(40,)).astype(np.float32)
    u = rng.normal(size=(50,)).astype(np.float32) - 4
    whole = N(t_ops.lse(T(x), T(y), T(dual), 0.3, 2))
    cost = float(t_ops.transport_cost(T(x), T(y), T(u), T(dual), 0.3, 3))
    monkeypatch.setattr(t_ops, "_BLOCK_ELEMS", 7 * 40 * 3)
    np.testing.assert_array_equal(N(t_ops.lse(T(x), T(y), T(dual), 0.3, 2)), whole)
    np.testing.assert_allclose(float(t_ops.transport_cost(T(x), T(y), T(u), T(dual), 0.3, 3)),
                               cost, rtol=1e-6)


def test_wrappers_take_plain_on_cpu_and_raise_elsewhere():
    rng, x, y = _points(4, 9, 7, 2)
    dual = rng.normal(size=(7,)).astype(np.float32)
    t_ops.lse.launches = t_ops.transport_cost.launches = 0
    np.testing.assert_array_equal(N(t_ops.lse(T(x), T(y), T(dual), 0.2)),
                                  N(t_ops.lse_plain(T(x), T(y), T(dual), 0.2)))
    t_ops.transport_cost(T(x), T(y), T(np.zeros(9, np.float32)), T(dual), 0.2)
    assert t_ops.lse.launches == 0 and t_ops.transport_cost.launches == 0
    meta = lambda a: T(a).to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_ops.lse(meta(x), meta(y), meta(dual), 0.2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_ops.transport_cost(meta(x), meta(y), meta(np.zeros(9, np.float32)), meta(dual), 0.2)
    with pytest.raises(ValueError, match="p must be"):
        t_ops.lse(T(x), T(y), T(dual), 0.2, p=0)
    with pytest.raises(ValueError, match="share d"):
        t_ops.lse(T(x), T(y[:, :1]), T(dual), 0.2)


# ---------------------------------------------------------------------------
# Sinkhorn
# ---------------------------------------------------------------------------

def _jax_sinkhorn_iters(monkeypatch, fn):
    """Run fn and return the JAX while_loop's final iteration count."""
    seen = {}
    orig = jax.lax.while_loop

    def spy(cond, body, init):
        out = orig(cond, body, init)
        seen["it"] = int(out[3])
        return out

    monkeypatch.setattr(jax.lax, "while_loop", spy)
    val = float(fn())
    monkeypatch.setattr(jax.lax, "while_loop", orig)
    return val, seen["it"]


SINKHORN_CASES = {
    # name: (Sinkhorn kwargs, weighted, p)
    "annealed": (dict(eps=1e-2, max_iters=60, stop_thresh=1e-5), False, 2),
    "annealed_weighted_nmax": (dict(eps=1e-2, max_iters=60, n_max=90), True, 2),
    "raw_eps_converges": (dict(eps=0.5, max_iters=200, stop_thresh=1e-4,
                               eps_annealing=False), False, 2),
    "raw_p1_weighted": (dict(eps=0.2, max_iters=40, eps_annealing=False), True, 1),
}


@pytest.mark.parametrize("case", sorted(SINKHORN_CASES))
def test_sinkhorn_matches_jax(case, monkeypatch):
    kwargs, weighted, p = SINKHORN_CASES[case]
    rng, x, y = _points(21, 120, 100, 3)
    w_x = w_y = None
    if weighted:
        w_x = rng.random(120).astype(np.float32) + 0.1
        w_y = rng.random(100).astype(np.float32) + 0.1
        w_x, w_y = w_x / w_x.sum(), w_y / w_y.sum()
    j = Sinkhorn(p=p, backend="xla", **kwargs)
    want, want_iters = _jax_sinkhorn_iters(monkeypatch, lambda: j(
        jnp.asarray(x), jnp.asarray(y), None if w_x is None else jnp.asarray(w_x),
        None if w_y is None else jnp.asarray(w_y)))
    t = TSinkhorn(p=p, **kwargs)
    got = float(t(T(x), T(y), None if w_x is None else T(w_x), None if w_y is None else T(w_y)))
    assert t.n_iters == want_iters
    if case == "raw_eps_converges":
        assert want_iters < kwargs["max_iters"]       # the stopping rule fired
    assert t.config["backend"] == "plain"
    assert {k for k in j.config if k != "backend"} <= set(t.config)
    # the same iteration run in two float32 libraries: the duals agree to
    # ~1e-6 relative per step, and the cost compounds that over the loop
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("eps,max_iters", [(1e-3, 100), (1e-2, 60), (1e-2, 100)])
def test_sinkhorn_schedule_matches_jax(eps, max_iters):
    t = TSinkhorn(eps=eps, max_iters=max_iters)
    got = t.eps_schedule()
    n_anneal = max(int(max_iters * 2 / 3), 1)
    decay = (eps / 1.0) ** (1.0 / n_anneal)
    want = np.asarray(jnp.maximum(1.0 * decay ** jnp.arange(max_iters), eps))
    assert got.dtype == np.float32 and got[0] == 1.0
    assert np.all(got[n_anneal + 1:] == np.float32(eps))
    # XLA's and torch's float32 pow may differ by one ulp
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


def test_sinkhorn_stops_early_once_polishing():
    _, x, _ = _points(2, 40, 40, 2)
    # a set against itself converges at once when ε does not anneal
    t = TSinkhorn(eps=0.5, eps_annealing=False, max_iters=50, stop_thresh=1e-3)
    t(T(x), T(x))
    assert 1 <= t.n_iters < 50
    # while annealing the stopping rule is off
    t = TSinkhorn(eps=0.5, eps_start=2.0, max_iters=30, stop_thresh=1e3)
    t(T(x), T(x))
    assert t.n_iters == int(30 * 2 / 3) + 1


def test_sinkhorn_plain_ops_equal_default_on_cpu():
    _, x, y = _points(8, 64, 64, 4)
    t = TSinkhorn(eps=1e-2, max_iters=30)
    a = float(t.compute(T(x), T(y)))
    b = float(t.compute(T(x), T(y), ops=PLAIN_OPS))
    assert a == b


# ---------------------------------------------------------------------------
# MMD and sliced KS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [50, 51])
def test_mmd_median_matches_jax(n):
    """n even gives an even count of pooled distances (2n² − n), n odd an
    odd one: both medians must be jnp.median's."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (0.3 + rng.normal(size=(n, 3))).astype(np.float32)
    got = float(t_mmd(T(x), T(y)))
    want = float(mmd_median(jnp.asarray(x), jnp.asarray(y)))
    # sums of n² kernel values in two orders, then a difference of three
    # such means: float32 rounding of ~1e-6 relative on each
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k", [6, 7])
def test_median_of_even_and_odd_lengths(k):
    v = np.random.default_rng(k).normal(size=k).astype(np.float32)
    assert float(t_median(T(v))) == pytest.approx(float(jnp.median(jnp.asarray(v))), rel=1e-7)


def _jax_projs(seed, n_proj, d):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n_proj, d)))


@pytest.mark.parametrize("shift", [0.0, 0.7, 100.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_sliced_ks_matches_jax(shift, weighted):
    """shift 100 puts the supports apart: the second set lies wholly out of
    the first set's range, its histograms are all zero, and the distance is
    the first CDF's maximum, 1."""
    rng = np.random.default_rng(31)
    n, d, n_proj = 400, 3, 16
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (shift + 1.2 * rng.normal(size=(n, d))).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    want = float(compute_sliced_ks(jnp.asarray(a), jnp.asarray(b), key=jax.random.PRNGKey(4),
                                   weights=None if w is None else jnp.asarray(w),
                                   n_random_projections=n_proj, n_bins=64))
    got = float(t_ks(T(a), T(b), weights=None if w is None else T(w),
                     n_random_projections=n_proj, n_bins=64,
                     projs=T(_jax_projs(4, n_proj, d))))
    # a projection rounded one ulp apart can move a sample across a bin
    # edge: one sample moves a CDF by at most 1/n on one projection
    assert got == pytest.approx(want, abs=2.0 / n)
    if shift == 100.0:
        assert got == pytest.approx(1.0)


def test_sliced_ks_draws_from_generator():
    x = torch.randn(100, 2, generator=torch.Generator().manual_seed(0))
    a = float(t_ks(x, x + 0.5, generator=torch.Generator().manual_seed(3)))
    b = float(t_ks(x, x + 0.5, generator=torch.Generator().manual_seed(3)))
    assert a == b and 0.0 < a < 1.0


# ---------------------------------------------------------------------------
# get_metrics and RDS.eval_metrics
# ---------------------------------------------------------------------------

def _targets(n_modes=3, dim=2):
    j = ManyModes(n_modes=n_modes, dim=dim, var=0.3, n_reference_samples=2000)
    j.compute_stats(jax.random.PRNGKey(0))
    t = TManyModes(n_modes=n_modes, dim=dim, var=0.3, n_reference_samples=2000,
                   device="cpu")
    t.expectations = dict(j.expectations)     # the same reference statistics
    return j, t


def _fixed_draws(gt):
    """Target sampling replaced by one numpy array on both sides."""
    return (lambda key, shape: jnp.asarray(gt[: shape[0]]),
            lambda generator, shape: T(gt[: shape[0]]))


def _losses(d, n_proj=32):
    projs = _jax_projs(0, n_proj, d)
    j = {"sinkhorn": Sinkhorn(eps=1e-2, max_iters=60), "mmd": mmd_median,
         "ks": lambda a, b: compute_sliced_ks(a, b, n_random_projections=n_proj)}
    t = {"sinkhorn": TSinkhorn(eps=1e-2, max_iters=60), "mmd": t_mmd,
         "ks": lambda a, b: t_ks(a, b, n_random_projections=n_proj, projs=T(projs))}
    return j, t


def test_get_metrics_matches_jax():
    j_target, t_target = _targets()
    rng = np.random.default_rng(7)
    n = 256
    samples = np.asarray(j_target.sample(jax.random.PRNGKey(5), (n,)))
    samples = samples + 0.05 * rng.normal(size=samples.shape).astype(np.float32)
    weights = rng.random(n).astype(np.float32)
    weights /= weights.sum()
    gt = np.asarray(j_target.sample(jax.random.PRNGKey(6), (n,)))
    j_target.sample, t_target.sample = _fixed_draws(gt)
    j_losses, t_losses = _losses(2)
    lz = {"log_norm_const_is": -0.01}
    want = get_metrics(j_target, jnp.asarray(samples), weights=jnp.asarray(weights),
                       log_norm_const_preds=lz, marginal_dims=[0, 1, 5],
                       sample_losses=j_losses)
    got = t_get_metrics(t_target, T(samples), weights=T(weights), log_norm_const_preds=lz,
                        marginal_dims=[0, 1, 5], sample_losses=t_losses)
    assert set(got) == set(want)
    for k in want:
        # means and sums over 256 float32 samples in two libraries; the
        # sample losses as in their own tests
        assert got[k] == pytest.approx(want[k], rel=2e-4, abs=2e-5), k


def test_get_metrics_without_weights_or_losses():
    j_target, t_target = _targets(n_modes=4, dim=3)
    samples = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32) * 4
    want = get_metrics(j_target, jnp.asarray(samples))
    got = t_get_metrics(t_target, T(samples))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_rds_eval_metrics_returns_the_jax_keys():
    """The port's RDS.eval_metrics on the CPU gives exactly the keys the JAX
    solver's eval_metrics gives for the same kind of Results."""
    dim, k, b = 2, 8, 64
    target = TManyModes(n_modes=3, dim=dim, var=0.3, n_reference_samples=1000, device="cpu")
    ctrl = TClipped(TFourier(dim=dim, channels=16, num_layers=3), clip_model=1e4)
    cfg = TTrainConfig(train_batch_size=b, eval_batch_size=b)
    solver = TRDS(target, TIsoGauss(dim=dim, device="cpu"), TVP(0.1, 10.0), ctrl, TEILoss,
                  {"method": "lv", "max_rnd": 1e8},
                  train_ts=t_get_timesteps(0.0, 1.0, steps=k, device="cpu"), cfg=cfg,
                  device="cpu")
    solver.setup()
    _, solver.sample_losses = _losses(dim)
    got = solver.eval_metrics(torch.Generator().manual_seed(0))

    j_target = ManyModes(n_modes=3, dim=dim, var=0.3, n_reference_samples=1000)
    j_target.compute_stats(jax.random.PRNGKey(0))
    rnd = jnp.asarray(np.random.default_rng(0).normal(size=(b,)).astype(np.float32))
    res = compute_results(rnd, compute_weights=True, max_rnd=1e8,
                          samples=jnp.zeros((b, dim)) + jnp.arange(b)[:, None] / b)
    j_losses, _ = _losses(dim)
    shell = type("Shell", (), {})()
    shell.target, shell.eval_marginal_dims, shell.sample_losses = j_target, [0], j_losses
    want = Trainable.metrics_from_results(shell, res, jax.random.PRNGKey(1))
    want["eval/sample_time"] = 0.0
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    assert got["error/sinkhorn"] > 0 and got["error/mmd"] > 0


def test_results_container_fields_match():
    from sde_sampler_lrds_torch.utils.common import Results as TResults

    assert [f.name for f in dataclasses.fields(TResults)] == \
        [f.name for f in dataclasses.fields(Results)]
