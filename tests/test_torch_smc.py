"""The port's SMC baseline held against the JAX package: the systematic
resampling lookup (the plain version of kernel B4), the full-covariance
Gaussian and target domains, the tempering path, ULA, and ``smc_sampler``
itself, statistically.

Inputs are drawn with numpy from a seed and handed to both packages; random
numbers the JAX code draws from a key (u₀, Langevin noise) are rebuilt from
that key and fed to the port. Each tolerance is stated with its reason.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.mcmc import MCMCState as TState
from sde_sampler_lrds_torch.mcmc import run_chain as t_run_chain
from sde_sampler_lrds_torch.mcmc import smc_sampler as t_smc_sampler
from sde_sampler_lrds_torch.mcmc import ula_step as t_ula_step
from sde_sampler_lrds_torch.ops import resample as t_resample
from sde_sampler_lrds_torch.targets import GaussFull as TGaussFull
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_torch.utils.common import derive_generator
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu.mcmc import MCMCState, ula_step
from sde_sampler_lrds_tpu.mcmc.smc import smc_sampler
from sde_sampler_lrds_tpu.ops.resample import _systematic_pallas, systematic_resample
from sde_sampler_lrds_tpu.targets import GaussFull, ManyModes


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# B4: systematic resampling
# ---------------------------------------------------------------------------

def _log_weights(n, seed):
    """Random log-weights with runs of −inf (zero weights), so the cdf has
    ties that the lookup must resolve as searchsorted-left."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=n).astype(np.float32) * 2
    lw[rng.random(n) < 0.3] = -np.inf
    lw[: n // 10] = -np.inf
    return lw


@pytest.mark.parametrize("n", [256, 1000, 1024, 4097])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_systematic_resample_matches_jax(n, use_pallas):
    lw = _log_weights(n, n)
    key = jax.random.PRNGKey(n + 1)
    want = np.asarray(systematic_resample(key, jnp.asarray(lw), use_pallas=use_pallas))
    u0 = float(jax.random.uniform(key, ()))
    cdf = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(lw))))
    pos = ((np.arange(n, dtype=np.float32) + np.float32(u0)) / np.float32(n)).astype(np.float32)
    # the lookup on the JAX package's own cdf: equal indices
    got_lookup = N(t_resample.systematic_lookup(T(cdf), T(pos)))
    assert got_lookup.dtype == np.int32
    np.testing.assert_array_equal(got_lookup, want)
    # end to end with the port's softmax and cumsum: equal on these inputs
    got = N(t_resample.systematic_resample(None, T(lw), u0=u0))
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, np.flatnonzero(np.isinf(lw))).any()


@pytest.mark.parametrize("n", [256, 1024])
def test_lookup_ties_on_exact_positions(n):
    """Dyadic weights make cdf values that equal positions exactly: the count
    #{j : cdf_j < pos_i} must take the first index of each tie, as the TPU
    kernel's strict compare does."""
    w = np.zeros(n, np.float32)
    w[::4] = 4.0 / n                          # every 4th particle, exact sums
    cdf = np.cumsum(w, dtype=np.float32)
    pos = (np.arange(n, dtype=np.float32) / n).astype(np.float32)     # u0 = 0
    want = np.asarray(_systematic_pallas(jnp.asarray(cdf), jnp.asarray(pos)))
    got = N(t_resample.systematic_lookup(T(cdf), T(pos)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.clip(np.searchsorted(cdf, pos, "left"), 0, n - 1))


def test_lookup_plain_chunks_and_clip(monkeypatch):
    cdf = np.array([0.1, 0.1, 0.5, 0.5, 0.9], np.float32)
    pos = np.array([0.0, 0.1, 0.3, 0.95, 2.0], np.float32)
    want = np.array([0, 0, 2, 4, 4], np.int32)        # the last two clipped to N − 1
    np.testing.assert_array_equal(N(t_resample.systematic_lookup(T(cdf), T(pos))), want)
    monkeypatch.setattr(t_resample, "_CHUNK_ELEMS", 3)
    np.testing.assert_array_equal(N(t_resample.systematic_lookup(T(cdf), T(pos))), want)


def test_weights_cdf_ties_zero_weights_to_their_prefix():
    """A zero weight ties with the prefix before it, so it is never drawn;
    leading zero weights are -inf, below every position."""
    w = T(np.array([0.0, 0.25, 0.0, 0.25, 0.0, 0.5], np.float32))
    cdf = t_resample.weights_cdf(w)
    np.testing.assert_array_equal(N(cdf), [-np.inf, 0.25, 0.25, 0.5, 0.5, 1.0])
    pos = (torch.arange(6, dtype=torch.float32) + 0.5) / 6
    idx = N(t_resample.systematic_lookup(cdf, pos))
    assert np.all(N(w)[idx] > 0)


def test_resample_wrapper_cpu_only():
    t_resample.systematic_lookup.launches = 0
    cdf, pos = torch.linspace(0.1, 1.0, 10), torch.linspace(0.0, 0.9, 10)
    t_resample.systematic_lookup(cdf, pos)
    assert t_resample.systematic_lookup.launches == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_resample.systematic_lookup(cdf.to("meta"), pos.to("meta"))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        t_resample.systematic_lookup(cdf, pos[:5])


def test_multinomial_resample_frequencies():
    w = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    lw = T(np.array([np.log(0.1), -np.inf, np.log(0.6), np.log(0.3)], np.float32))
    counts = np.zeros(4)
    g = torch.Generator().manual_seed(0)
    for _ in range(1000):          # N = 4 draws per call
        counts += np.bincount(N(t_resample.multinomial_resample(g, lw)), minlength=4)
    freq = counts / counts.sum()
    # 4000 draws: 4 standard errors of a frequency is at most 0.032
    assert counts[1] == 0
    np.testing.assert_allclose(freq, w, atol=4 * math.sqrt(0.25 / counts.sum()))


# ---------------------------------------------------------------------------
# targets: GaussFull and domains
# ---------------------------------------------------------------------------

def _cov(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)).astype(np.float32)
    return (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32), \
        rng.normal(size=d).astype(np.float32)


@pytest.mark.parametrize("by", ["cov", "prec"])
def test_gauss_full_matches_jax(by):
    d = 4
    cov, loc = _cov(d, 0)
    arg = {by: cov if by == "cov" else np.linalg.inv(cov).astype(np.float32)}
    j = GaussFull(dim=d, loc=loc, **arg)
    t = TGaussFull(dim=d, loc=loc, device="cpu", **arg)
    x = np.random.default_rng(1).normal(size=(64, d)).astype(np.float32) * 2
    # float32 inverse, Cholesky and slogdet by LAPACK in both, and (B,D)x(D,D)
    # products in other orders
    np.testing.assert_allclose(N(t.unnorm_log_prob(T(x))), np.asarray(j.unnorm_log_prob(x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(t.score(T(x))), np.asarray(j.score(x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(t.chol), np.asarray(j.chol), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(t.domain), np.asarray(j.domain), rtol=1e-6)
    np.testing.assert_allclose(N(t.stddevs), np.asarray(j.stddevs), rtol=1e-6)
    s = N(t.sample(torch.Generator().manual_seed(0), (40_000,)))
    # mean and covariance of 40 000 draws: 5 standard errors
    se = np.sqrt(np.diag(cov) / 40_000)
    assert np.all(np.abs(s.mean(0) - loc) < 5 * se)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=5 * np.sqrt(2.0 / 40_000) * cov.max())


def test_target_domains_match_jax():
    j = ManyModes(n_modes=4, dim=3, var=0.5)
    t = TManyModes(n_modes=4, dim=3, var=0.5, device="cpu")
    np.testing.assert_allclose(N(t.domain), np.asarray(j.domain), rtol=1e-6)
    for dom in (3.0, [-1.0, 2.0], np.arange(6, dtype=np.float32).reshape(3, 2)):
        j.set_domain(dom)
        t.set_domain(dom)
        np.testing.assert_array_equal(N(t.domain), np.asarray(j.domain))
    with pytest.raises(ValueError):
        t.set_domain(np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# tempering path, ULA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("autograd_score", [True, False])
def test_define_tempering_utils_matches_jax(full, autograd_score):
    d = 3
    cov, mean = _cov(d, 2)
    var = cov if full else np.diag(cov).copy()
    j_target = ManyModes(n_modes=3, dim=d, var=0.3)
    t_target = TManyModes(n_modes=3, dim=d, var=0.3, device="cpu")
    j_prior, j_lpg = j_api.define_tempering_utils(
        jnp.asarray(mean), jnp.asarray(var), j_target.unnorm_log_prob,
        None if autograd_score else j_target.score)
    t_prior, t_lpg = t_api.define_tempering_utils(
        mean, var, t_target.unnorm_log_prob, None if autograd_score else t_target.score,
        device="cpu")
    assert type(t_prior).__name__ == type(j_prior).__name__
    rng = np.random.default_rng(3)
    x = (3 * rng.normal(size=(50, d))).astype(np.float32)
    ts = rng.random(50).astype(np.float32)
    for t in (0.0, 0.37, 1.0, ts):
        lp_j, g_j = j_lpg(jnp.asarray(t), jnp.asarray(x))
        lp_t, g_t = t_lpg(T(t), T(x))
        # log-densities of ~ -100 and scores summed in other orders
        np.testing.assert_allclose(N(lp_t), np.asarray(lp_j), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(N(g_t), np.asarray(g_j), rtol=1e-5, atol=1e-4)


def test_ula_step_matches_jax_with_fed_noise():
    target_j = ManyModes(n_modes=3, dim=2, var=0.3)
    target_t = TManyModes(n_modes=3, dim=2, var=0.3, device="cpu")
    x = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32) * 2
    state_j = MCMCState.init(jnp.asarray(x), target_j.log_prob_and_score, 1e-2)
    state_t = TState.init(T(x), target_t.log_prob_and_score, 1e-2)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, x.shape))
    want = ula_step(key, state_j, target_j.log_prob_and_score)
    got = t_ula_step(None, state_t, target_t.log_prob_and_score, noise=T(noise))
    np.testing.assert_allclose(N(got.x), np.asarray(want.x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(got.log_prob), np.asarray(want.log_prob), rtol=1e-5)
    np.testing.assert_allclose(N(got.grad), np.asarray(want.grad), rtol=1e-5, atol=1e-5)
    # run_chain with ULA: no adaptation, every proposal taken
    final, samples = t_run_chain(torch.Generator().manual_seed(0), state_t,
                                 target_t.log_prob_and_score, 5, kernel="ula")
    assert samples.shape == (5, 32, 2) and torch.equal(final.step_size, state_t.step_size)


def test_derive_generator_is_deterministic_and_leaves_the_parent():
    g = torch.Generator().manual_seed(5)
    state = g.get_state().clone()
    a = torch.rand(4, generator=derive_generator(g, 7))
    b = torch.rand(4, generator=derive_generator(g, 7))
    c = torch.rand(4, generator=derive_generator(g, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(g.get_state(), state)


# ---------------------------------------------------------------------------
# smc_sampler, statistically against the JAX package
# ---------------------------------------------------------------------------

L, P, N_MCMC, N_WARM, STEP = 16, 512, 8, 32, 5e-2


@pytest.fixture(scope="module")
def smc_pair():
    """ManyModes (3 modes in 2-D) from a full-covariance Gaussian fitted to
    target draws: 16 levels, 512 particles, systematic resampling."""
    j_target = ManyModes(n_modes=3, dim=2, var=0.1)
    t_target = TManyModes(n_modes=3, dim=2, var=0.1, device="cpu")
    data = np.asarray(j_target.sample(jax.random.PRNGKey(0), (20_000,)))
    mean, cov = data.mean(0), np.cov(data.T).astype(np.float32)
    j_prior, j_lpg = j_api.define_tempering_utils(jnp.asarray(mean), jnp.asarray(cov),
                                                  j_target.unnorm_log_prob, j_target.score)
    t_prior, t_lpg = t_api.define_tempering_utils(mean, cov, t_target.unnorm_log_prob,
                                                  t_target.score, device="cpu")
    x0 = np.asarray(j_prior.sample(jax.random.PRNGKey(1), (P,)))
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    steps = np.full((L, P, 1), STEP, np.float32)
    j_out = smc_sampler(jax.random.PRNGKey(2), jnp.asarray(x0), jnp.asarray(times), j_lpg,
                        N_WARM, N_MCMC, jnp.asarray(steps), reweight_threshold=1.0)
    t_resample.systematic_lookup.launches = 0
    t_out = t_smc_sampler(torch.Generator().manual_seed(2), T(x0), T(times), t_lpg,
                          N_WARM, N_MCMC, T(steps), reweight_threshold=1.0)
    return dict(j=jax.tree.map(np.asarray, j_out), t=jax.tree.map(N, t_out),
                target=t_target)


def test_smc_shapes_and_diagnostics(smc_pair):
    (j_s, j_ss, j_d), (t_s, t_ss, t_d) = smc_pair["j"], smc_pair["t"]
    assert t_s.shape == j_s.shape == (L, N_MCMC, P, 2)
    assert t_ss.shape == j_ss.shape == (L, P, 1)
    for k in ("ess", "local_acc"):
        assert t_d[k].shape == j_d[k].shape == (L,)
    # the first processed level (the prior, index L − 1) starts from
    # uniform weights
    assert t_d["ess"][-1] == pytest.approx(1.0) and j_d["ess"][-1] == pytest.approx(1.0)
    assert np.all((t_d["ess"] > 0) & (t_d["ess"] <= 1.0 + 1e-6))
    assert np.all((t_d["local_acc"] > 0) & (t_d["local_acc"] < 1))
    # adaptation moves the step sizes the same way on both sides
    assert np.sign(np.log(t_ss[0] / STEP).mean()) == np.sign(np.log(j_ss[0] / STEP).mean())
    # acceptance around the 0.75 target in both: 0.1 covers the per-level
    # spread of an 8-step mean over 512 chains
    np.testing.assert_allclose(t_d["local_acc"].mean(), j_d["local_acc"].mean(), atol=0.1)
    # ESS below 1.0 at every later level, so one resampling per level
    assert t_resample.systematic_lookup.launches == 0          # plain on the CPU
    assert np.all(t_d["ess"][:-1] < 1.0)


def test_smc_mode_weights_and_means_match_jax(smc_pair):
    target = smc_pair["target"]
    j_x = smc_pair["j"][0][0].reshape(-1, 2)
    t_x = smc_pair["t"][0][0].reshape(-1, 2)
    w_j = N(target.compute_mode_count(T(j_x))) / len(j_x)
    w_t = N(target.compute_mode_count(T(t_x))) / len(t_x)
    # Monte Carlo error: the 8 MCMC slots of one population are correlated,
    # so count P = 512 independent particles per side; 4 standard errors
    # of a difference of two such frequencies
    tol_w = 4 * np.sqrt(2 * w_j * (1 - w_j) / P) + 1e-3
    assert np.all(np.abs(w_t - w_j) <= tol_w), (w_t, w_j, tol_w)
    sd = j_x.std(0)
    tol_m = 4 * np.sqrt(2.0 / P) * sd
    assert np.all(np.abs(t_x.mean(0) - j_x.mean(0)) <= tol_m)
    assert np.all(np.abs(t_x.std(0) - sd) <= tol_m)


def test_run_smc_sampler_returns_level_zero_block():
    target = TManyModes(n_modes=3, dim=2, var=0.1, device="cpu")
    g = torch.Generator().manual_seed(0)
    out = t_api.run_smc_sampler(g, torch.zeros(2), torch.eye(2) * 4, n_steps=4,
                                step_size=1e-2, n_particles=64, n_mcmc_steps=3,
                                n_warmup_mcmc_steps=2, target_log_prob=target.unnorm_log_prob,
                                device="cpu")
    assert out.shape == (3, 64, 2) and bool(torch.isfinite(out).all())


def test_smc_rejects_what_is_not_ported():
    """What ``smc_sampler`` still refuses, as the JAX package does: a
    per-level initialisation in SMC mode, and an unknown resampler. (The
    PDDS weights and the preconditioned levels it once refused are held in
    tests/test_torch_smc_pdds.py.)"""
    x = torch.zeros(4, 2)
    times = torch.linspace(0, 1, 3)
    lpg = lambda t, y: (torch.zeros(y.shape[0]), torch.zeros_like(y))
    with pytest.raises(ValueError, match="per_noise_init"):
        t_smc_sampler(None, x, times, lpg, 1, 1, 1e-2, per_noise_init=True)
    with pytest.raises(ValueError, match="per_noise_init"):
        t_smc_sampler(None, x[None].repeat(3, 1, 1), times, lpg, 1, 1, 1e-2,
                      per_noise_init=True, reweight_threshold=0.5)
    with pytest.raises(ValueError, match="resampler"):
        t_smc_sampler(None, x, times, lpg, 1, 1, 1e-2, resampler="stratified")
    # without SMC weights a per-level initialisation runs
    s, _, d = t_smc_sampler(torch.Generator().manual_seed(0), x[None].repeat(3, 1, 1), times,
                            lpg, 1, 1, 1e-2, per_noise_init=True, reweight_threshold=0.0)
    assert s.shape == (3, 1, 4, 2) and torch.all(d["ess"] == 1)


def test_smc_ula_and_multinomial_run():
    target = TManyModes(n_modes=3, dim=2, var=0.1, device="cpu")
    _, lpg = t_api.define_tempering_utils(torch.zeros(2), torch.ones(2) * 4,
                                          target.unnorm_log_prob, target.score, device="cpu")
    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(1)) * 2
    s, ss, d = t_smc_sampler(torch.Generator().manual_seed(1), x0, torch.linspace(0, 1, 5),
                             lpg, 3, 2, 1e-2, use_ula=True, resampler="multinomial")
    assert s.shape == (5, 2, 64, 2) and bool(torch.isfinite(s).all())
    assert torch.all(d["local_acc"] == 0) and torch.all(ss == 1e-2)
