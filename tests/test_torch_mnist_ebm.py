"""The port's MNIST conv energy (``models/mnist_ebm.py``) against the JAX
package's on the CPU, on the repository's JAX-trained parameters
(experiments/results_mnist/ebm_params_mnist_zero_one_seed_0.msgpack, read
by the port's own reader): MNISTNet's features and MNISTEnergy alone at
per-row and single times, and the energy inside a GMMTiltedPotential with
the 'sum' tilt over the same numpy GMM in both packages (two components
at d 196, eigen-factored full covariances and diagonal ones), its
log-density and its score (autograd in both) at times below and above
t_limit.

Inputs are made with numpy from a seed (digit-mean images plus noise in
[−1, 1] space). Tolerance: float32 convolutions in other orders, 1e-4
relative with 1e-4 of the largest value; the potential's log-densities
(≈ 10² from the 196-d GMM) 1e-5 relative.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sde_sampler_lrds_torch.models import MNISTEnergy as TEnergy
from sde_sampler_lrds_torch.models import MNISTNet as TNet
from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential as TPot
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.utils import flax_msgpack
from sde_sampler_lrds_tpu.models import GMMTiltedPotential, MNISTEnergy
from sde_sampler_lrds_tpu.models.mnist_ebm import MNISTNet
from sde_sampler_lrds_tpu.sde import VP

REPO = Path(__file__).parents[1]
PARAMS = REPO / "experiments" / "results_mnist" / "ebm_params_mnist_zero_one_seed_0.msgpack"
T_LIMIT = 0.01


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def N(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def trained():
    """The JAX-trained potential's tree, by Flax and by the port's reader."""
    blob = PARAMS.read_bytes()
    return serialization.msgpack_restore(blob), flax_msgpack.msgpack_restore(blob)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    means = np.stack([np.load(REPO / "data" / f"mnist_mean_label_{d}.npy").reshape(-1)
                      for d in (0, 1)])
    rows = means[np.arange(n) % 2]
    return (2.0 * rows - 1.0 + 0.2 * rng.normal(size=rows.shape)).astype(np.float32), means


def test_energy_net_matches_jax_on_trained_params(trained):
    j_tree, t_tree = trained
    base = j_tree["params"]["base_model"]
    x, _ = _images(6, 0)
    ts = np.linspace(0.0, 1.0, 6).astype(np.float32)
    feats = MNISTNet().apply({"params": base["MNISTNet_0"]}, jnp.asarray(ts), jnp.asarray(x))
    t_net = TNet().load_flax_params(t_tree["params"]["base_model"]["MNISTNet_0"])
    assert feats.shape == (6, 112)
    _close(t_net(torch.as_tensor(ts), torch.as_tensor(x)), feats)
    energy = TEnergy().load_flax_params(t_tree["params"]["base_model"])
    for t_in in (ts, np.float32(0.4)):
        want = MNISTEnergy().apply({"params": base}, jnp.asarray(t_in), jnp.asarray(x))
        _close(energy(torch.as_tensor(t_in), torch.as_tensor(x)), want)


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_tilted_potential_and_score_match_jax(trained, cov):
    j_tree, t_tree = trained
    x, means = _images(8, 1)
    rng = np.random.default_rng(2)
    m = (2.0 * means - 1.0).astype(np.float32)
    w = np.array([0.75, 0.25], np.float32)
    if cov == "full":
        a = rng.normal(size=(2, 196, 196))
        full = 0.02 * a @ a.transpose(0, 2, 1) / 196 + 0.01 * np.eye(196)
        eig, p = np.linalg.eigh(full)
        var = (eig.astype(np.float32), p.astype(np.float32))
        j_var = tuple(jnp.asarray(v) for v in var)
    else:
        var = (0.01 + 0.02 * rng.random((2, 196))).astype(np.float32)
        j_var = jnp.asarray(var)
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    j = GMMTiltedPotential(base_model=MNISTEnergy(), sde=VP(**kw), weights=jnp.asarray(w),
                           means=jnp.asarray(m), variances=j_var, t_limit=T_LIMIT,
                           tilt_type="sum")
    t = TPot(TEnergy(), TVP(**kw), w, m, var, t_limit=T_LIMIT,
             tilt_type="sum").load_flax_params(t_tree)
    ts = np.array([0.005, 1e-4, 0.05, 0.3, 0.6, 0.9, 0.99, 0.5], np.float32)
    want_lp = j.apply(j_tree, jnp.asarray(ts), jnp.asarray(x), method="unnorm_log_prob")
    want_score = j.apply(j_tree, jnp.asarray(ts), jnp.asarray(x))
    got_lp, got_score = t.unnorm_log_prob_and_grad(torch.as_tensor(ts), torch.as_tensor(x))
    np.testing.assert_allclose(N(got_lp), np.asarray(want_lp), rtol=1e-5, atol=1e-3)
    _close(got_score, want_score)
    _close(t(torch.as_tensor(ts), torch.as_tensor(x)), want_score)
    np.testing.assert_allclose(N(t.unnorm_log_prob(torch.as_tensor(ts), torch.as_tensor(x))),
                               np.asarray(want_lp), rtol=1e-5, atol=1e-3)
    want_base = j.apply(j_tree, jnp.asarray(ts), jnp.asarray(x), method="base_energy")
    _close(t.base_energy(torch.as_tensor(ts), torch.as_tensor(x)), want_base)
    assert np.abs(np.asarray(want_base)).max() > 1e-3   # the trained tilt is not ≈ 0


def test_zero_init_head_starts_at_the_gmm():
    """At init the scalar head is ≈ 0, so the tilted potential is the GMM."""
    energy = TEnergy()
    energy.reset_parameters(torch.Generator().manual_seed(0))
    x, _ = _images(4, 3)
    out = energy(torch.full((4,), 0.5), torch.as_tensor(x))
    assert out.shape == (4, 1) and float(out.detach().abs().max()) < 1e-4
    assert jax.tree_util.tree_structure(
        MNISTEnergy().init(jax.random.PRNGKey(0), jnp.zeros(2), jnp.zeros((2, 196)))) \
        == jax.tree_util.tree_structure({"params": serialization.msgpack_restore(
            PARAMS.read_bytes())["params"]["base_model"]})
