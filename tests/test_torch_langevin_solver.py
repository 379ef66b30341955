"""The port's unlearned ULA baseline (``LangevinSolver``) held against the
JAX package's under the JAX solver's own draws (its prior draws and the
Euler–Maruyama noise its scan splits from its key, rebuilt and fed to the
port): the trajectory, the terminal samples and the expectation predictions
over the states after the burn-in; and the solver's own draws and its
refusal of a burn-in as long as the grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.solvers import LangevinSolver as TLangevinSolver
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsotropicGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu.sde import get_timesteps
from sde_sampler_lrds_tpu.solvers import LangevinSolver
from sde_sampler_lrds_tpu.targets import IsotropicGauss, ManyModes

DIM, B, K, BURN = 2, 128, 40, 10


def N(t):
    return t.detach().cpu().numpy()


def _pair(clip_score=None):
    j_target, t_target = ManyModes(n_modes=3, dim=DIM, var=0.3), TManyModes(
        n_modes=3, dim=DIM, var=0.3, device="cpu")
    # one grid for both (the two float32 linspaces differ by an ulp at a few
    # points)
    ts = get_timesteps(0.0, 2.0, steps=K)
    j = LangevinSolver(j_target, IsotropicGauss(dim=DIM, scale=2.0),
                       eval_ts=ts, eval_batch_size=B,
                       burn_steps=BURN, diff_coeff=0.7, clip_score=clip_score)
    t = TLangevinSolver(t_target, TIsotropicGauss(dim=DIM, scale=2.0, device="cpu"),
                        eval_ts=torch.as_tensor(np.array(ts)),
                        eval_batch_size=B, burn_steps=BURN, diff_coeff=0.7,
                        clip_score=clip_score)
    return j, t


@pytest.mark.parametrize("clip_score", [None, 5.0])
def test_langevin_solver_matches_jax_under_its_draws(clip_score):
    j, t = _pair(clip_score)
    key = jax.random.PRNGKey(3)
    want = j.run(key)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (B,)))
    noise, k = [], k_sim
    for _ in range(K):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, DIM))))
    got = t.run(None, x_init=torch.as_tensor(x0.copy()), noise=torch.as_tensor(np.stack(noise)))
    assert got.xs.shape == want.xs.shape == (K + 1, B, DIM)
    # 40 Euler steps of a float32 mixture score, summed in other orders
    np.testing.assert_allclose(N(got.xs), np.asarray(want.xs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(got.samples), np.asarray(want.samples), rtol=1e-4, atol=1e-4)
    assert set(got.expectation_preds) == set(want.expectation_preds)
    for name, v in want.expectation_preds.items():
        assert got.expectation_preds[name] == pytest.approx(v, rel=1e-4, abs=1e-4), name
    assert set(got.metrics) == set(want.metrics) == {"eval/sample_time"}
    np.testing.assert_array_equal(N(got.ts), np.asarray(want.ts))


def test_langevin_solver_own_draws_and_burn_in():
    _, t = _pair()
    res = t.run(torch.Generator().manual_seed(0))
    again = t.run(torch.Generator().manual_seed(0))
    assert torch.equal(res.xs, again.xs) and res.weights is None
    pooled = res.xs[BURN:].reshape(-1, DIM)
    assert res.expectation_preds["square"] == pytest.approx(
        float((pooled**2).sum(-1).mean()), rel=1e-6)
    with pytest.raises(ValueError, match="burn_steps"):
        TLangevinSolver(t.target, t.prior, eval_ts=t.eval_ts, burn_steps=K + 1)
    with pytest.raises(ValueError, match="burn_steps"):
        LangevinSolver(ManyModes(n_modes=3, dim=DIM), IsotropicGauss(dim=DIM),
                       eval_ts=jnp.linspace(0, 1, 5), burn_steps=5)
