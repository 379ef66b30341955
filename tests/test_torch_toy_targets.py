"""The port's 2-D toy targets held against the JAX package: ``Rings`` and
``Checkerboard`` (densities, scores, the −inf off the board, the mode
metrics, sampling), ``make_target`` for both names (and for
'two_modes_full' and 'bracket_two_modes'), ``get_metrics`` on them,
and ``compute_results`` on density log-ratios that hold +inf, the value an
off-board terminal sample gives.

Inputs are drawn with numpy from a seed and handed to both packages. The
densities and scores agree at rtol = atol = 1e-5 in float32; counts are
equal and the floats derived from them agree to 1e-6. Sampling draws from
different RNG streams, so it is held to Monte Carlo tolerances (stated
where used). Everything runs on the CPU.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_target as t_make_target
from sde_sampler_lrds_torch.api import make_target_details as t_make_target_details
from sde_sampler_lrds_torch.eval.metrics import get_metrics as t_get_metrics
from sde_sampler_lrds_torch.losses.base import compute_results as t_compute_results
from sde_sampler_lrds_torch.targets import Checkerboard as TCheckerboard
from sde_sampler_lrds_torch.targets import Rings as TRings
from sde_sampler_lrds_tpu.api import make_target, make_target_details
from sde_sampler_lrds_tpu.eval.metrics import get_metrics
from sde_sampler_lrds_tpu.losses.base import compute_results
from sde_sampler_lrds_tpu.targets.checkerboard import Checkerboard
from sde_sampler_lrds_tpu.targets.rings import Rings

TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = 1e-6


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pair(name, **kw):
    jax_cls, port_cls = {"rings": (Rings, TRings),
                         "checkerboard": (Checkerboard, TCheckerboard)}[name]
    return jax_cls(**kw), port_cls(device="cpu", **kw)


def ring_points(rng, n):
    """Points near and between the rings, at every angle, and a few near the
    origin (where the score's eps matters)."""
    r = np.concatenate([rng.choice([1.0, 3.0, 5.0], n) + 0.3 * rng.normal(size=n),
                        rng.uniform(0.0, 6.5, n), [1e-3, 1e-2, 0.1]])
    theta = rng.uniform(0, 2 * np.pi, r.shape[0])
    return np.stack([r * np.cos(theta), r * np.sin(theta)], -1).astype(np.float32)


def board_points(rng, n):
    """Points on and off the board, and points on the squares' edges and
    corners (closed squares: an edge belongs to both sides)."""
    pts = rng.uniform(-5.5, 5.5, (n, 2))
    edges = np.array([[-2.0, 0.0], [0.0, 2.0], [-4.0, -4.0], [4.0, 4.0], [4.0, -4.0],
                      [-4.0, 4.0], [0.0, 0.0], [2.0, -2.0], [4.0001, 0.0], [-4.0001, 1.0],
                      [1.0, 4.0001], [-1.0, -1.0], [1.0, 1.0]])
    return np.concatenate([pts, edges]).astype(np.float32)


# ---------------------------------------------------------------------------
# (1) densities and scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("equilibrated", [False, True])
def test_rings_density_and_score_match_jax(equilibrated):
    j, t = pair("rings", equilibrated=equilibrated)
    x = ring_points(np.random.default_rng(0), 400)
    np.testing.assert_allclose(N(t.unnorm_log_prob(T(x))), np.asarray(j.unnorm_log_prob(x)),
                               **TOL)
    np.testing.assert_allclose(N(t.score(T(x))), np.asarray(j.score(x)), **TOL)
    # at r = 0 the score's eps keeps it at 0 in both
    zero = np.zeros((1, 2), np.float32)
    np.testing.assert_array_equal(N(t.score(T(zero))), np.asarray(j.score(zero)))
    assert j.domain.shape == t.domain.shape
    np.testing.assert_array_equal(N(t.domain), np.asarray(j.domain))
    np.testing.assert_allclose(N(t._probs), np.asarray(j._probs), rtol=1e-7)


@pytest.mark.parametrize("width,unequilibrated", [(4, True), (4, False), (6, True)])
def test_checkerboard_density_matches_jax_with_neg_inf_off_board(width, unequilibrated):
    j, t = pair("checkerboard", width=width, unequilibrated=unequilibrated)
    x = board_points(np.random.default_rng(1), 2000)
    got, want = N(t.unnorm_log_prob(T(x))), np.asarray(j.unnorm_log_prob(x))
    off = np.isneginf(want)
    assert off.any() and (~off).any()
    np.testing.assert_array_equal(np.isneginf(got), off)
    assert not np.isnan(got).any() and not np.isposinf(got).any()
    np.testing.assert_allclose(got[~off], want[~off], **TOL)
    # batch shapes pass through
    np.testing.assert_array_equal(N(t.unnorm_log_prob(T(x[:12].reshape(3, 4, 2)))),
                                  np.asarray(j.unnorm_log_prob(x[:12].reshape(3, 4, 2))))
    np.testing.assert_array_equal(N(t.score(T(x))), np.asarray(j.score(x)))
    for name in ("low", "high", "loc", "_probs", "domain"):
        np.testing.assert_array_equal(N(getattr(t, name)), np.asarray(getattr(j, name)), name)
    assert t.n_mixtures == j.n_mixtures


# ---------------------------------------------------------------------------
# (2) mode metrics on the same samples
# ---------------------------------------------------------------------------

def _mode_metric_cases(rng):
    rings = ring_points(rng, 3000)
    inner = ring_points(rng, 500)
    inner = inner[np.sum(inner**2, -1) < 4.0]        # only the first ring: two empty
    board = board_points(rng, 4000)
    few = np.array([[-1.0, 3.0], [-1.5, 3.5], [1.0, 1.0], [7.0, 7.0]], np.float32)
    return [("rings", {}, rings), ("rings", {}, inner),
            ("rings", {"equilibrated": True}, rings),
            ("checkerboard", {}, board), ("checkerboard", {}, few),
            ("checkerboard", {"width": 6}, board)]


@pytest.mark.parametrize("case", range(6))
def test_mode_metrics_match_jax(case):
    name, kw, samples = _mode_metric_cases(np.random.default_rng(2))[case]
    j, t = pair(name, **kw)
    counts_t, counts_j = t.compute_mode_count(T(samples)), j.compute_mode_count(samples)
    np.testing.assert_array_equal(N(counts_t), np.asarray(counts_j))
    if name == "checkerboard":
        np.testing.assert_allclose(N(t._board_hist(counts_t)), j._board_hist(counts_j),
                                   rtol=0, atol=METRIC_TOL)
    for fn in ("entropy", "kl_weights", "tv_weights", "compute_forgotten_modes"):
        got = float(getattr(t, fn)(T(samples)))
        want = float(getattr(j, fn)(samples))
        assert (got == want) if math.isinf(want) else abs(got - want) <= METRIC_TOL, (fn, got,
                                                                                       want)
        got_c = float(getattr(t, fn)(None, counts=counts_t))
        assert got_c == got or abs(got_c - got) <= METRIC_TOL


@pytest.mark.parametrize("name", ["rings", "checkerboard"])
def test_get_metrics_on_toy_target_matches_jax(name):
    """get_metrics' mode-coverage hooks, with the port's target given the
    JAX target's reference expectations and standard deviations."""
    j, t = pair(name)
    j.compute_stats_sampling(jax.random.PRNGKey(0))
    t.expectations = dict(j.expectations)
    t.stddevs = T(np.asarray(j.stddevs))
    rng = np.random.default_rng(3)
    samples = (ring_points(rng, 1500) if name == "rings" else board_points(rng, 3000))
    logw = rng.normal(size=samples.shape[0]).astype(np.float32)
    w = np.asarray(jax.nn.softmax(logw))
    want = get_metrics(j, jnp.asarray(samples), weights=jnp.asarray(w), marginal_dims=[0, 1])
    got = t_get_metrics(t, T(samples), weights=T(w), marginal_dims=[0, 1])
    assert set(got) == set(want)
    for k, v in want.items():
        if math.isinf(v) or math.isnan(v):
            assert got[k] == v or (math.isnan(v) and math.isnan(got[k])), k
        else:
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)
    for k in ("emc", "kl_weights", "tv_weights", "num_forgotten_modes"):
        assert k in j.expectations


# ---------------------------------------------------------------------------
# (3) sampling, to Monte Carlo tolerances
# ---------------------------------------------------------------------------

N_DRAWS = 200_000


def _ring_stats(x, radiuses):
    r = np.linalg.norm(x, axis=-1)
    idx = np.argmin(np.abs(r[:, None] - radiuses[None]), axis=-1)
    shares = np.bincount(idx, minlength=len(radiuses)) / len(r)
    means = np.array([r[idx == k].mean() for k in range(len(radiuses))])
    theta = np.arctan2(x[:, 1], x[:, 0])
    return shares, means, np.cos(theta).mean(), np.sin(theta).mean()


def test_rings_sampling_statistics_match_jax():
    """Ring shares within 5 binomial standard errors of the weights (and of
    the JAX draws' shares), each ring's mean radius within 5 standard errors
    of its radius (scale 0.1 over the ring's draws), the angle uniform (mean
    cos and sin within 5/sqrt(2 N) of 0)."""
    j, t = pair("rings")
    radiuses, probs = np.asarray(j.radiuses), np.asarray(j._probs)
    xj = np.asarray(j.sample(jax.random.PRNGKey(4), (N_DRAWS,)))
    xt = N(t.sample(torch.Generator().manual_seed(4), (N_DRAWS,)))
    assert xt.shape == xj.shape == (N_DRAWS, 2) and xt.dtype == np.float32
    se = np.sqrt(probs * (1 - probs) / N_DRAWS)
    stats_j, stats_t = _ring_stats(xj, radiuses), _ring_stats(xt, radiuses)
    for shares, means, c, s in (stats_j, stats_t):
        assert np.all(np.abs(shares - probs) <= 5 * se), shares
        assert np.all(np.abs(means - radiuses) <= 5 * 0.1 / np.sqrt(shares * N_DRAWS)), means
        assert abs(c) <= 5 / np.sqrt(2 * N_DRAWS) and abs(s) <= 5 / np.sqrt(2 * N_DRAWS)
    assert np.all(np.abs(stats_j[0] - stats_t[0]) <= 5 * np.sqrt(2) * se)
    # seeds for the MCMC chains: n points on every ring, ring k at rows k::3
    n = 20_000
    ij = np.asarray(j.sample_init_points(jax.random.PRNGKey(5), n))
    it = N(t.sample_init_points(torch.Generator().manual_seed(5), n))
    assert it.shape == ij.shape == (3 * n, 2)
    for pts in (ij, it):
        r = np.linalg.norm(pts, axis=-1).reshape(n, 3)
        assert np.all(np.abs(r.mean(0) - radiuses) <= 5 * 0.1 / np.sqrt(n))
        assert np.all(np.abs(r.std(0) - 0.1) <= 5 * 0.1 / np.sqrt(2 * n))


def test_checkerboard_sampling_statistics_match_jax():
    """Every draw on the board (a finite log-density), square shares within
    5 binomial standard errors of the weights, and each square's draws
    uniform over it (mean at its centre within 5 standard errors, 2/sqrt(12)
    a coordinate over the square's draws)."""
    j, t = pair("checkerboard")
    probs, low, loc = np.asarray(j._probs), np.asarray(j.low), np.asarray(j.loc)
    xj = np.asarray(j.sample(jax.random.PRNGKey(6), (N_DRAWS,)))
    xt = N(t.sample(torch.Generator().manual_seed(6), (N_DRAWS,)))
    se = np.sqrt(probs * (1 - probs) / N_DRAWS)
    for x in (xj, xt):
        assert np.isfinite(np.asarray(j.unnorm_log_prob(x))).all()
        counts = np.asarray(j.compute_mode_count(x))
        assert counts.sum() == N_DRAWS            # no draw on an edge of two squares
        shares = counts / N_DRAWS
        assert np.all(np.abs(shares - probs) <= 5 * se), shares
        sq = np.argmax(np.all((x[:, None] >= low[None]) & (x[:, None] <= low[None] + 2), -1),
                       -1)
        for k in range(len(probs)):
            pts = x[sq == k]
            assert np.all(np.abs(pts.mean(0) - loc[k]) <= 5 * (2 / np.sqrt(12)) /
                          np.sqrt(len(pts)))


# ---------------------------------------------------------------------------
# (4) make_target and compute_results with +inf log-ratios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rings", "checkerboard"])
def test_make_target_builds_toys_as_jax(name):
    details = make_target_details(name)
    assert t_make_target_details(name) == details
    j, t = make_target(details), t_make_target(details, device="cpu")
    assert type(t).__name__ == type(j).__name__ and t.dim == j.dim == 2
    assert t.n_reference_samples == j.n_reference_samples
    assert t.log_norm_const == j.log_norm_const == 0.0


@pytest.mark.parametrize("name", ["two_modes_full", "bracket_two_modes"])
def test_make_target_builds_gaussian_mixtures_as_jax(name):
    details = make_target_details(name, dim=4)
    assert t_make_target_details(name, dim=4) == details
    j, t = make_target(details), t_make_target(details, device="cpu")
    assert type(t).__name__ == type(j).__name__ and t.dim == j.dim == 4
    assert t.n_reference_samples == j.n_reference_samples
    assert t.log_norm_const == j.log_norm_const == 0.0
    np.testing.assert_array_equal(N(t.loc), np.asarray(j.loc))
    np.testing.assert_array_equal(N(t.mixture_weights), np.asarray(j.mixture_weights))
    if name == "two_modes_full":
        np.testing.assert_array_equal(N(t.cov), np.asarray(j.cov))
    else:  # float32 linspace and square root of the variances: an ulp
        np.testing.assert_allclose(N(t.scale), np.asarray(j.scale), rtol=2.4e-7)


@pytest.mark.parametrize("name", ["mnist", "cancer"])
def test_make_target_still_refuses_unported(name):
    """MNIST is not ported yet; the logistic-regression posteriors ('cancer'
    and the other three, ROADMAP A4) are, and build."""
    if name == "cancer":
        target = t_make_target(t_make_target_details(name), device="cpu")
        assert type(target).__name__ == "LogisticRegression" and target.dim == 31
        return
    with pytest.raises(NotImplementedError, match=f"Target {name} is not ported"):
        t_make_target(t_make_target_details(name), device="cpu")


def _rnd_cases():
    rng = np.random.default_rng(7)
    some = rng.normal(size=512).astype(np.float32) * 2.0
    some[rng.random(512) < 0.1] = np.inf
    over = some.copy()
    over[:7] = 5e8                                 # finite, above max_rnd
    return {"some_inf": some, "some_over_max": over,
            "all_inf": np.full(64, np.inf, np.float32),
            "finite": rng.normal(size=256).astype(np.float32)}


@pytest.mark.parametrize("case", ["some_inf", "some_over_max", "all_inf", "finite"])
@pytest.mark.parametrize("max_rnd", [None, 1e8])
@pytest.mark.parametrize("compute_weights", [False, True])
def test_compute_results_with_inf_rnd_matches_jax(case, max_rnd, compute_weights):
    rnd = _rnd_cases()[case]
    want = compute_results(jnp.asarray(rnd), compute_weights=compute_weights, max_rnd=max_rnd)
    got = t_compute_results(T(rnd), compute_weights=compute_weights, max_rnd=max_rnd)
    assert set(got.metrics) == set(want.metrics)
    assert set(got.log_norm_const_preds) == set(want.log_norm_const_preds)
    both = {**{k: (v, want.metrics[k]) for k, v in got.metrics.items()},
            **{k: (v, want.log_norm_const_preds[k]) for k, v in got.log_norm_const_preds.items()}}
    for k, (g, w) in both.items():
        w = float(w)
        if math.isnan(w) or math.isinf(w):
            assert (math.isnan(g) and math.isnan(w)) or g == w, (k, g, w)
        else:
            assert math.isfinite(g) and abs(g - w) <= 1e-5 * max(1.0, abs(w)), (k, g, w)
    if compute_weights:
        np.testing.assert_allclose(N(got.weights), np.asarray(want.weights), rtol=1e-5,
                                   atol=1e-8)
    else:
        assert got.weights is None and want.weights is None
