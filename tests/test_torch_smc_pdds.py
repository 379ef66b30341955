"""The port's PDDS-weighted and preconditioned SMC held against the JAX
package on a two-mode GMM (TwoModes d 2: weights 2/3 and 1/3) annealed along
VP(0.1, 10)'s noised marginals, which both packages give in closed form.

The PDDS weights are held exactly: with no MCMC move (one ULA step of size
0) the only draws are the reverse-kernel noise, so each package's per-level
ESS is a closed function of its own draws — the move from the previous
level's final state and score, the first level skipped, t_next the previous
level's time, the weights accumulated across levels — and one NumPy
reference of that function must give both. The samplers themselves, with
their MALA steps, are compared statistically. Each tolerance is stated with
its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.mcmc import smc_sampler as t_smc_sampler
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets import TwoModes as TTwoModes
from sde_sampler_lrds_tpu.mcmc.smc import smc_sampler
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets import TwoModes

DIM = 2


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _setup(n_levels):
    """Both packages' VP, the GMM's noised log-density and score at a level's
    time, the target and the VP time grid (index 0 the target's t = 0, the
    last the prior's t = 1)."""
    j_target, t_target = TwoModes(dim=DIM), TTwoModes(dim=DIM, device="cpu")
    j_sde, t_sde = VP(0.1, 10.0), TVP(0.1, 10.0)
    means, var = np.asarray(j_target.loc), np.asarray(j_target.scale) ** 2
    w = np.asarray(j_target.mixture_weights / j_target.mixture_weights.sum())
    jm, jv, jw = (jnp.asarray(a) for a in (means, var, w))
    tm, tv, tw = (T(a) for a in (means, var, w))

    def j_lpg(t, x):
        return (j_sde.marginal_gmm_log_prob(t, x, jm, jv, jw),
                j_sde.marginal_gmm_score(t, x, jm, jv, jw))

    def t_lpg(t, x):
        return (t_sde.marginal_gmm_log_prob(t, x, tm, tv, tw),
                t_sde.marginal_gmm_score(t, x, tm, tv, tw))

    times = np.linspace(0.0, 1.0, n_levels).astype(np.float32)
    return j_sde, t_sde, j_lpg, t_lpg, t_target, times


def _reference_ess(t_sde, t_lpg, times, x0, zs):
    """The PDDS-weighted ESS per level (level order) of particles that no
    MCMC step moves, in float64 NumPy from the port's closed forms: level
    L − 1 keeps x0 and uniform weights; level l moves x_prev by the EI step
    from T − t_{l+1} to T − t_l with its score at t_{l+1}, and adds
    lp_l(x) − lp_{l+1}(x_prev) + log f − log b to the carried log-weights."""
    n_levels = len(times)
    ess = np.ones(n_levels)
    x_prev = T(x0)
    lp_prev, g_prev = t_lpg(T(times[-1]), x_prev)
    log_w = np.zeros(x0.shape[0])
    for pos, level in enumerate(range(n_levels - 2, -1, -1)):
        t, t_next = T(times[level]), T(times[level + 1])
        z = T(zs[pos])
        x = t_sde.ei_integration_step(x_prev, t_sde.terminal_t - t_next, t_sde.terminal_t - t,
                                      g_prev, z)
        mf, vf = t_sde.transition_params(t, t_next)
        lp_f = -0.5 * ((mf * x - x_prev) ** 2 / vf).sum(-1)
        lp, g = t_lpg(t, x)
        log_w = log_w + N(lp - lp_prev).astype(np.float64) + N(lp_f + 0.5 * (z**2).sum(-1))
        w = np.exp(log_w - log_w.max())
        w /= w.sum()
        ess[level] = 1.0 / (w**2).sum() / len(w)
        x_prev, lp_prev, g_prev = x, lp, g
    return ess


def test_pdds_weights_match_the_reference_in_both_packages():
    n_levels, b = 6, 256
    j_sde, t_sde, j_lpg, t_lpg, _, times = _setup(n_levels)
    x0 = np.random.default_rng(0).normal(size=(b, DIM)).astype(np.float32)
    zero = np.zeros((n_levels, b, 1), np.float32)
    kw = dict(n_warmup_mcmc_steps=0, n_mcmc_steps=1, use_ula=True, use_pdds_weights=True,
              reweight_threshold=1e-12)
    key = jax.random.PRNGKey(11)
    _, _, j_d = smc_sampler(key, jnp.asarray(x0), jnp.asarray(times), j_lpg,
                            step_sizes_per_noise=jnp.asarray(zero), sde=j_sde, **kw)
    # the JAX draws: the level loop splits its carried key 5 ways a level,
    # the second part the PDDS noise
    j_zs, k = [], key
    for _ in range(n_levels):
        k, k_pdds, _, _, _ = jax.random.split(k, 5)
        j_zs.append(np.asarray(jax.random.normal(k_pdds, (b, DIM))))
    # the port's: one generator; a level's PDDS noise, then its ULA step's
    gen = torch.Generator().manual_seed(11)
    _, _, t_d = t_smc_sampler(gen, T(x0), T(times), t_lpg, step_sizes_per_noise=T(zero),
                              sde=t_sde, **kw)
    gen = torch.Generator().manual_seed(11)
    torch.randn((b, DIM), generator=gen)      # the first level's ULA noise
    t_zs = []
    for _ in range(n_levels - 1):
        t_zs.append(N(torch.randn((b, DIM), generator=gen)))
        torch.randn((b, DIM), generator=gen)
    # float32 log-weights of up to ~1e2 summed over 5 levels against the
    # float64 sum of the same float32 terms
    np.testing.assert_allclose(np.asarray(j_d["ess"]),
                               _reference_ess(t_sde, t_lpg, times, x0, j_zs[1:]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(t_d["ess"]), _reference_ess(t_sde, t_lpg, times, x0, t_zs),
                               rtol=1e-4, atol=1e-5)
    assert N(t_d["ess"])[-1] == 1.0 and np.all(N(t_d["ess"])[:-1] < 1.0)


def test_pdds_needs_the_sde():
    x = torch.zeros(4, DIM)
    lpg = lambda t, y: (torch.zeros(y.shape[0]), torch.zeros_like(y))  # noqa: E731
    with pytest.raises(ValueError, match="SDE"):
        t_smc_sampler(None, x, torch.linspace(0, 1, 3), lpg, 1, 1, 1e-2, use_pdds_weights=True)


L, P, N_MCMC, N_WARM = 16, 512, 8, 16


def _precond(t_sde, times):
    """Per-level preconditioners s²(t)(Σ + σ²(t)I) of TwoModes' covariance,
    in the eigenbasis, as the JAX experiments build them, and their square
    roots P·diag(√λ)."""
    data = np.asarray(TwoModes(dim=DIM).sample(jax.random.PRNGKey(5), (20_000,)))
    eig, p = np.linalg.eigh(np.cov(data.T) + 1e-6 * np.eye(DIM))
    s2 = N(t_sde.s(T(times))).astype(np.float64) ** 2
    sig = N(t_sde.sigma_sq(T(times))).astype(np.float64)
    lam = s2[:, None] * (np.maximum(eig, 1e-8)[None] + sig[:, None])
    return (np.einsum("de,le,fe->ldf", p, lam, p).astype(np.float32),
            np.einsum("de,le->lde", p, np.sqrt(lam)).astype(np.float32))


@pytest.fixture(scope="module", params=["pdds", "precond"])
def smc_pair(request):
    """PDDS-weighted SMC (MALA, systematic resampling) or preconditioned
    SMC (no PDDS) on VP's noised marginals from N(0, I): 16 levels, 512
    particles, 16 warm-up and 8 sampling steps a level."""
    j_sde, t_sde, j_lpg, t_lpg, t_target, times = _setup(L)
    x0 = np.random.default_rng(1).normal(size=(P, DIM)).astype(np.float32)
    steps = np.full((L, P, 1), 0.05, np.float32) * np.linspace(0.05, 1.0, L)[:, None, None] ** 2
    j_kw, t_kw = {}, {}
    if request.param == "pdds":
        j_kw, t_kw = dict(use_pdds_weights=True, sde=j_sde), dict(use_pdds_weights=True,
                                                                   sde=t_sde)
    else:
        pm, pc = _precond(t_sde, times)
        j_kw = dict(precond_matrix_per_noise=jnp.asarray(pm),
                    precond_matrix_chol_per_noise=jnp.asarray(pc))
        t_kw = dict(precond_matrix_per_noise=T(pm), precond_matrix_chol_per_noise=T(pc))
        steps = np.full((L, P, 1), 0.3, np.float32)
    j_out = smc_sampler(jax.random.PRNGKey(2), jnp.asarray(x0), jnp.asarray(times), j_lpg,
                        N_WARM, N_MCMC, jnp.asarray(steps), **j_kw)
    t_out = t_smc_sampler(torch.Generator().manual_seed(2), T(x0), T(times), t_lpg, N_WARM,
                          N_MCMC, T(steps), **t_kw)
    return dict(j=jax.tree.map(np.asarray, j_out), t=jax.tree.map(N, t_out), target=t_target)


def test_smc_variants_shapes_and_diagnostics(smc_pair):
    (j_s, j_ss, j_d), (t_s, t_ss, t_d) = smc_pair["j"], smc_pair["t"]
    assert t_s.shape == j_s.shape == (L, N_MCMC, P, DIM)
    assert t_ss.shape == j_ss.shape == (L, P, 1)
    assert np.isfinite(t_s).all()
    assert t_d["ess"][-1] == pytest.approx(1.0)
    assert np.all((t_d["ess"] > 0) & (t_d["ess"] <= 1.0 + 1e-6))
    assert np.all((t_d["local_acc"] > 0) & (t_d["local_acc"] < 1))
    # acceptance near the 0.75 target in both: 0.1 covers the per-level
    # spread of an 8-step mean over 512 chains
    np.testing.assert_allclose(t_d["local_acc"].mean(), j_d["local_acc"].mean(), atol=0.1)


def test_smc_variants_mode_weights_and_means_match_jax(smc_pair):
    target = smc_pair["target"]
    j_x = smc_pair["j"][0][0].reshape(-1, DIM)
    t_x = smc_pair["t"][0][0].reshape(-1, DIM)
    w_j = N(target.compute_mode_count(T(j_x))) / len(j_x)
    w_t = N(target.compute_mode_count(T(t_x))) / len(t_x)
    # the 8 MCMC slots of one population are correlated, and resampling
    # duplicates particles: count P / 2 independent particles a side; 4
    # standard errors of a difference of two frequencies
    n_eff = P / 2
    tol_w = 4 * np.sqrt(2 * w_j * (1 - w_j) / n_eff) + 1e-3
    assert np.all(np.abs(w_t - w_j) <= tol_w), (w_t, w_j, tol_w)
    sd = j_x.std(0)
    tol_m = 4 * np.sqrt(2.0 / n_eff) * sd
    assert np.all(np.abs(t_x.mean(0) - j_x.mean(0)) <= tol_m)
    assert np.all(np.abs(t_x.std(0) - sd) <= tol_m)
