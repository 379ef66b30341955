"""The port's NICE targets (``targets/nice.py``) against the JAX package's on
the CPU: the per-digit flows loaded from data/nice_label_*.msgpack by the
port's own reader, on 'mnist_zero_one' and the ten-digit 'mnist' — the
mixture's log-density and score, each flow's log-density, ``f`` and ``g``
on fed latents, f∘g = id — the digit-classification mode metrics on fed
samples, the reference statistics' keys, sampling's shape and digit
balance; and a small NiceModel with the sigmoid and dequantization
transforms (fed uniforms) and a normal latent.

Inputs are made with numpy from a seed (digit-mean images plus noise in
[−1, 1] space; logistic latents). Tolerance: float32 MLPs summed in other
orders, 1e-5 relative (log-densities of size ~10²–10³) and 1e-4 on
latents, images and scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_target as t_make_target
from sde_sampler_lrds_torch.targets import nice as t_nice
from sde_sampler_lrds_tpu.api import make_target, make_target_details
from sde_sampler_lrds_tpu.targets import nice as j_nice

DATA = t_nice.DATA_DIR
LP_TOL = dict(rtol=1e-5, atol=1e-3)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module", params=["mnist_zero_one", "mnist"])
def pair(request):
    details = make_target_details(request.param)
    return make_target(details), t_make_target(details, device="cpu")


def _images(target, n, seed):
    """Digit-mean images in [−1, 1] space plus noise, one digit a row."""
    rng = np.random.default_rng(seed)
    means = np.stack([np.load(DATA / f"mnist_mean_label_{d}.npy").reshape(-1)
                      for d in target.digits])
    rows = means[np.arange(n) % len(target.digits)]
    return (2.0 * rows - 1.0 + 0.1 * rng.normal(size=rows.shape)).astype(np.float32)


def test_mixture_density_and_score_match_jax(pair):
    j, t = pair
    assert (t.n_digits, t.dim, t.local_minimums) == (j.n_digits, 196, None)
    np.testing.assert_allclose(N(t.mixture_weights), np.asarray(j.mixture_weights), rtol=1e-7)
    x = _images(t, 6, 0)
    lp = N(t.unnorm_log_prob(torch.as_tensor(x)))
    np.testing.assert_allclose(lp, np.asarray(j.unnorm_log_prob(jnp.asarray(x))), **LP_TOL)
    assert N(t.unnorm_log_prob(torch.as_tensor(x[0]))).shape == ()
    np.testing.assert_allclose(N(t._component_log_probs(torch.as_tensor(x))),
                               np.asarray(j._component_log_probs(jnp.asarray(x))), **LP_TOL)
    want = np.asarray(j.score(jnp.asarray(x)))
    np.testing.assert_allclose(N(t.score(torch.as_tensor(x))), want,
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_flows_f_g_match_jax(pair):
    """Each flow's g on fed logistic latents, f back (f∘g = id, its
    log-determinant), and its log-density at the centred images."""
    j, t = pair
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(4, 196))
    z = np.log(u / (1 - u)).astype(np.float32)
    x = _images(t, 4, 2)
    for jd, td in zip(j.nice_dists, t.nice_dists):
        np.testing.assert_array_equal(N(td.mean), np.asarray(jd.mean))
        img = np.array(jd.model.apply(jd.params, jnp.asarray(z), method="g"))
        got = td.model.g(torch.as_tensor(z))
        np.testing.assert_allclose(N(got), img, **TOL)
        back, log_det = td.model.f(got)
        np.testing.assert_allclose(N(back), z, **TOL)
        want_z, want_ld = jd.model.apply(jd.params, jnp.asarray(img), method="f")
        np.testing.assert_allclose(N(log_det), np.asarray(want_ld), rtol=1e-6)
        np.testing.assert_allclose(N(td.model.f(torch.as_tensor(img))[0]), np.asarray(want_z),
                                   **TOL)
        c = (x + 1.0) / 2.0 - N(td.mean)
        np.testing.assert_allclose(N(td.log_prob_flow(torch.as_tensor(c))),
                                   np.asarray(jd.log_prob_flow(jnp.asarray(c))), **LP_TOL)


def test_mode_metrics_on_fed_samples_match_jax(pair):
    j, t = pair
    x = _images(t, 40, 3)
    x[::7] = _images(t, 40, 4)[::7][:, ::-1]      # some rows no digit would claim
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_array_equal(N(t.get_classes(xt)), np.asarray(j.get_classes(xj)))
    counts = N(t.compute_mode_count(xt))
    np.testing.assert_array_equal(counts, np.asarray(j.compute_mode_count(xj)))
    for name in ("entropy", "kl_weights", "tv_weights", "compute_forgotten_modes"):
        np.testing.assert_allclose(float(getattr(t, name)(xt)), float(getattr(j, name)(xj)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(t.compute_mode_weight(xt)),
                               float(j.compute_mode_weight(xj)), rtol=1e-6)
    # a digit with no sample: xlogy's 0, an infinite KL, a forgotten mode
    one = xt[counts.argmax() == N(t.get_classes(xt))]
    for name in ("entropy", "kl_weights", "compute_forgotten_modes"):
        np.testing.assert_allclose(float(getattr(t, name)(one)),
                                   float(getattr(j, name)(jnp.asarray(N(one)))), rtol=1e-6)


def test_sampling_and_reference_statistics(pair):
    j, t = pair
    g = torch.Generator().manual_seed(0)
    s = t.sample(g, (512,))
    assert s.shape == (512, 196) and bool(torch.isfinite(s).all())
    counts = N(t.compute_mode_count(s))
    assert counts.sum() == 512
    if t.n_digits == 2:          # the 3:1 weights favour digit 0
        assert counts[0] / counts.sum() > 0.6
    assert N(t.sample(g, (2, 3))).shape == (2, 3, 196)
    t.n_reference_samples = j.n_reference_samples = 256
    t.compute_stats_sampling(torch.Generator().manual_seed(1))
    j.compute_stats_sampling(jax.random.PRNGKey(1))
    assert set(t.expectations) == set(j.expectations)
    assert all(np.isfinite(v) for v in t.expectations.values())


@pytest.mark.parametrize("latent", ["logistic", "normal"])
def test_transforms_and_latents_match_jax(latent):
    """A small flow with the sigmoid and dequantization transforms: f and
    the log-density under the JAX key's uniforms, and g."""
    kw = dict(coupling=3, in_out_dim=8, mid_dim=16, hidden=2, mask_config=0, latent=latent,
              use_dequant=True, use_sigmoid=True)
    j = j_nice.NiceModel(**kw)
    params = j.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)), jax.random.PRNGKey(1),
                    method="log_prob")
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), params)
    t = t_nice.NiceModel(**kw).load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(2)
    x = rng.uniform(0.05, 0.95, size=(5, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    uniforms = np.asarray(jax.random.uniform(key, x.shape))
    want_z, want_ld = j.apply(params, jnp.asarray(x), dequant_key=key, method="f")
    got_z, got_ld = t.f(torch.as_tensor(x), dequant_uniforms=torch.as_tensor(uniforms))
    np.testing.assert_allclose(N(got_z), np.asarray(want_z), **TOL)
    np.testing.assert_allclose(N(got_ld), np.asarray(want_ld), rtol=1e-5)
    np.testing.assert_allclose(
        N(t.log_prob(torch.as_tensor(x), dequant_uniforms=torch.as_tensor(uniforms))),
        np.asarray(j.apply(params, jnp.asarray(x), dequant_key=key, method="log_prob")),
        **LP_TOL)
    z = rng.normal(size=(5, 8)).astype(np.float32)
    np.testing.assert_array_equal(N(t.g(torch.as_tensor(z))),
                                  np.asarray(j.apply(params, jnp.asarray(z), method="g")))
    with pytest.raises(ValueError, match="generator"):
        t.f(torch.as_tensor(x))


def test_nice_checkpoint_and_refusals():
    meta, model = t_nice.load_nice_checkpoint(DATA / "nice_label_3.msgpack", device="cpu")
    assert meta["mid_dim"] == 192 and meta["skip_centering"] is False
    assert len(model.couplings) == 4 and model.latent == "logistic"
    target = t_nice.Nice(DATA / "nice_label_3.msgpack", device="cpu")
    j = j_nice.Nice(checkpoint=DATA / "nice_label_3.msgpack")
    x = np.random.default_rng(4).uniform(0, 1, size=(3, 196)).astype(np.float32)
    np.testing.assert_allclose(N(target.unnorm_log_prob(torch.as_tensor(x))),
                               np.asarray(j.unnorm_log_prob(jnp.asarray(x))), **LP_TOL)
    with pytest.raises(ValueError, match="one of them"):
        t_nice.Nice(device="cpu")
    with pytest.raises(ValueError, match="196"):
        t_nice.Nice(DATA / "nice_label_3.msgpack", dim=100, device="cpu")
