"""The port's replica exchange held against the JAX package:
``make_re_pairings``, one swap step (``re_step``) under the uniforms the JAX
step draws from its key, and ``re_sampler`` — its shapes, its step-size
shapes and errors, a warm-up that collects nothing, persistent replicas
(``init_state`` / ``start_step``) continuing one run bitwise, and its mode
weights and moments against the JAX sampler's, statistically — and
``run_re_sampler``.

Inputs are drawn with numpy from a seed and handed to both packages; each
tolerance is stated with its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.mcmc import make_re_pairings as t_make_re_pairings
from sde_sampler_lrds_torch.mcmc import re_sampler as t_re_sampler
from sde_sampler_lrds_torch.mcmc import re_step as t_re_step
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu.mcmc.smc import make_re_pairings, re_sampler, re_step
from sde_sampler_lrds_tpu.targets import ManyModes


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n_levels", range(1, 10))
def test_make_re_pairings_match_jax(n_levels):
    for got, want in zip(t_make_re_pairings(n_levels), make_re_pairings(n_levels)):
        np.testing.assert_array_equal(N(got).reshape(-1, 2), np.asarray(want).reshape(-1, 2))


def _path(dim=2, n_modes=3):
    """The tempering path from a wide Gaussian to ManyModes in both
    packages."""
    j_target = ManyModes(n_modes=n_modes, dim=dim, var=0.1)
    t_target = TManyModes(n_modes=n_modes, dim=dim, var=0.1, device="cpu")
    data = np.asarray(j_target.sample(jax.random.PRNGKey(0), (20_000,)))
    mean, cov = data.mean(0), np.cov(data.T).astype(np.float32)
    _, j_lpg = j_api.define_tempering_utils(jnp.asarray(mean), jnp.asarray(cov),
                                            j_target.unnorm_log_prob, j_target.score)
    t_prior, t_lpg = t_api.define_tempering_utils(mean, cov, t_target.unnorm_log_prob,
                                                  t_target.score, device="cpu")
    return j_lpg, t_lpg, t_prior, t_target, mean, cov


@pytest.mark.parametrize("n_levels,parity", [(5, 0), (5, 1), (6, 1)])
def test_re_step_matches_jax_under_its_uniforms(n_levels, parity):
    """Both pairings, the odd one of an even level count padded with the
    (0, 0) self-pair; the pair rows written idx_i first, then idx_j."""
    j_lpg, t_lpg, _, _, _, _ = _path()
    b, dim = 64, 2
    rng = np.random.default_rng(n_levels + parity)
    times = np.linspace(0, 1, n_levels).astype(np.float32)
    x = (2 * rng.normal(size=(n_levels, b, dim))).astype(np.float32)
    t_flat = np.repeat(times, b)
    lp, g = (np.asarray(a) for a in j_lpg(jnp.asarray(t_flat), jnp.asarray(x.reshape(-1, dim))))
    lp, g = lp.reshape(n_levels, b), g.reshape(n_levels, b, dim)
    pairs = make_re_pairings(n_levels)
    n_pairs = max(p.shape[0] for p in pairs)
    idx = np.asarray(pairs[parity])
    idx = np.concatenate([idx, np.zeros((n_pairs - idx.shape[0], 2), idx.dtype)])
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (n_pairs, b)))
    want = re_step(key, jnp.asarray(x), jnp.asarray(lp), jnp.asarray(g), j_lpg,
                   jnp.asarray(times), jnp.asarray(idx[:, 0]), jnp.asarray(idx[:, 1]))
    got = t_re_step(None, T(x), T(lp), T(g), t_lpg, T(times), T(idx[:, 0]).long(),
                    T(idx[:, 1]).long(), uniforms=T(u))
    # swaps are decided on log-ratios the packages sum in other orders; on
    # these draws none of them is within rounding of its uniform, so the
    # decisions, the states and the rate are equal
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    for a, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(N(a), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert float(got[3]) == pytest.approx(float(want[3]))
    assert 0 < float(got[3]) < 1


def _run(gen, t_lpg, x0, times, n_warm, n_mcmc, steps, **kw):
    return t_re_sampler(gen, x0, times, t_lpg, swap_frequency=4, n_warmup_mcmc_steps=n_warm,
                        n_mcmc_steps=n_mcmc, step_sizes_per_noise=steps, **kw)


@pytest.mark.parametrize("steps_shape", ["L", "L1", "LB"])
def test_re_sampler_shapes_and_step_sizes(steps_shape):
    _, t_lpg, t_prior, _, _, _ = _path()
    n_levels, b = 5, 16
    times = torch.linspace(0, 1, n_levels)
    x0 = t_prior.sample(torch.Generator().manual_seed(0), (b,))
    steps = {"L": torch.full((n_levels,), 0.05), "L1": torch.full((n_levels, 1), 0.05),
             "LB": torch.full((n_levels, b), 0.05)}[steps_shape]
    samples, ss, diags, (x, lp, g) = _run(torch.Generator().manual_seed(1), t_lpg, x0, times,
                                          8, 6, steps)
    assert samples.shape == (n_levels, 6, b, 2) and ss.shape == (n_levels, b, 1)
    assert diags["acc"].shape == (6,)
    assert x.shape == (n_levels * b, 2) and lp.shape == (n_levels * b,) and g.shape == x.shape
    assert torch.equal(samples[:, -1].reshape(-1, 2), x)
    # the last step's states are the final ones, their cached log-densities
    # the path's at each level's time
    lp_want, _ = t_lpg(times.repeat_interleave(b), x)
    torch.testing.assert_close(lp, lp_want, rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(samples).all())
    assert bool(((diags["acc"] > 0) & (diags["acc"] <= 1)).all())


@pytest.mark.parametrize("bad", [(5, 3), (4,), (5, 16, 2)])
def test_re_sampler_refuses_other_step_size_shapes(bad):
    _, t_lpg, t_prior, _, _, _ = _path()
    x0 = t_prior.sample(torch.Generator().manual_seed(0), (16,))
    with pytest.raises(ValueError, match="step_sizes_per_noise"):
        _run(None, t_lpg, x0, torch.linspace(0, 1, 5), 1, 1, torch.full(bad, 0.05))


def test_re_sampler_warmup_collects_nothing():
    """A run with W warm-up steps returns only its M sampling steps, and
    they are the last M steps of the same run taken as W + M sampling
    steps."""
    _, t_lpg, t_prior, _, _, _ = _path()
    times = torch.linspace(0, 1, 4)
    x0 = t_prior.sample(torch.Generator().manual_seed(0), (32,))
    steps = torch.full((4,), 0.05)
    s_warm, ss_warm, d_warm, final_warm = _run(torch.Generator().manual_seed(3), t_lpg, x0,
                                               times, 10, 5, steps)
    s_all, ss_all, d_all, final_all = _run(torch.Generator().manual_seed(3), t_lpg, x0, times,
                                           0, 15, steps)
    assert s_warm.shape[1] == 5
    assert torch.equal(s_warm, s_all[:, 10:]) and torch.equal(d_warm["acc"], d_all["acc"][10:])
    assert torch.equal(ss_warm, ss_all)
    assert all(torch.equal(a, b) for a, b in zip(final_warm, final_all))


@pytest.mark.parametrize("precond,use_ula", [(False, False), (True, False), (True, True)])
def test_re_sampler_continues_one_run_bitwise(precond, use_ula):
    """Persistent replicas: a run of 7 + 9 steps, then 5 more from its final
    state, its step sizes and step 16 (swap every 4: the parity carries on),
    equals one run of 7 + 14 steps on the same generator."""
    _, t_lpg, t_prior, _, _, cov = _path()
    n_levels, b = 5, 16
    times = torch.linspace(0, 1, n_levels)
    x0 = t_prior.sample(torch.Generator().manual_seed(0), (b,))
    kw = {"use_ula": use_ula}
    if precond:
        m = torch.as_tensor(cov)[None] * torch.linspace(0.5, 1.0, n_levels)[:, None, None]
        kw.update(precond_matrix_per_noise=m,
                  precond_matrix_chol_per_noise=torch.linalg.cholesky(m))
    steps = torch.full((n_levels,), 0.02)
    s_one, ss_one, d_one, f_one = _run(torch.Generator().manual_seed(5), t_lpg, x0, times, 7,
                                       14, steps, **kw)
    gen = torch.Generator().manual_seed(5)
    s_a, ss_a, d_a, f_a = _run(gen, t_lpg, x0, times, 7, 9, steps, **kw)
    s_b, ss_b, d_b, f_b = _run(gen, t_lpg, x0, times, 0, 5, ss_a[..., 0], init_state=f_a,
                               start_step=16, **kw)
    assert torch.equal(torch.cat([s_a, s_b], dim=1), s_one)
    assert torch.equal(torch.cat([d_a["acc"], d_b["acc"]]), d_one["acc"])
    assert torch.equal(ss_b, ss_one) and all(torch.equal(a, b) for a, b in zip(f_b, f_one))
    if use_ula:   # local ULA steps count as accepted; swap steps as decided
        local = [i for i in range(7, 21) if i % 4]
        assert torch.all(d_one["acc"][[i - 7 for i in local]] == 1)


L_RE, B_RE, WARM_RE, N_RE = 8, 256, 96, 16


def test_re_sampler_matches_jax_statistically():
    """ManyModes (3 modes in 2-D) from the full-covariance Gaussian fitted to
    target draws: 8 levels, 256 replicas a level, 96 warm-up and 16 sampling
    steps, a swap every 4. The level-0 mode weights and moments of both
    packages agree within their Monte Carlo error."""
    j_lpg, t_lpg, t_prior, t_target, mean, cov = _path()
    times = np.linspace(0.0, 1.0, L_RE).astype(np.float32)
    x0 = N(t_prior.sample(torch.Generator().manual_seed(1), (B_RE,)))
    steps = np.full((L_RE,), 5e-2, np.float32)
    j_s, j_ss, j_d, _ = re_sampler(jax.random.PRNGKey(2), jnp.asarray(x0), jnp.asarray(times),
                                   j_lpg, 4, WARM_RE, N_RE, jnp.asarray(steps))
    t_s, t_ss, t_d, _ = t_re_sampler(torch.Generator().manual_seed(2), T(x0), T(times), t_lpg,
                                     4, WARM_RE, N_RE, T(steps))
    assert t_s.shape == j_s.shape == (L_RE, N_RE, B_RE, 2)
    assert t_ss.shape == j_ss.shape == (L_RE, B_RE, 1)
    assert t_d["acc"].shape == j_d["acc"].shape == (N_RE,)
    # the mean acceptance over the swap and local steps: 0.1 covers the
    # spread of a 16-step mean over 2048 chains
    np.testing.assert_allclose(float(t_d["acc"].mean()), float(j_d["acc"].mean()), atol=0.1)
    j_x, t_x = np.asarray(j_s[0]).reshape(-1, 2), N(t_s[0]).reshape(-1, 2)
    w_j = N(t_target.compute_mode_count(T(j_x))) / len(j_x)
    w_t = N(t_target.compute_mode_count(T(t_x))) / len(t_x)
    # the 16 slots of one level's 256 replicas are correlated: count the
    # 256 replicas; 4 standard errors of a difference of two frequencies
    tol_w = 4 * np.sqrt(2 * w_j * (1 - w_j) / B_RE) + 1e-3
    assert np.all(np.abs(w_t - w_j) <= tol_w), (w_t, w_j, tol_w)
    assert np.all(np.abs(w_t - N(t_target._probs)) <= tol_w + 0.05)
    sd = j_x.std(0)
    tol_m = 4 * np.sqrt(2.0 / B_RE) * sd
    assert np.all(np.abs(t_x.mean(0) - j_x.mean(0)) <= tol_m)
    assert np.all(np.abs(t_x.std(0) - sd) <= tol_m)


def test_run_re_sampler_returns_level_zero_block():
    target = TManyModes(n_modes=3, dim=2, var=0.1, device="cpu")
    out, diags = t_api.run_re_sampler(
        torch.Generator().manual_seed(0), torch.zeros(2), torch.eye(2) * 4, n_steps=4,
        step_size=1e-2, batch_size=32, swap_frequency=2, n_mcmc_steps=3,
        n_warmup_mcmc_steps=5, target_log_prob=target.unnorm_log_prob,
        return_diagnostics=True, device="cpu")
    assert out.shape == (3, 32, 2) and bool(torch.isfinite(out).all())
    assert diags["acc"].shape == (3,)
