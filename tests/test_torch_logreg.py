"""The port's Bayesian logistic-regression posteriors held against the JAX
package on all four datasets (the repository's data/*.npz): the
log-density (the log-sigmoid floored at log(threshold)), the analytic score
(and against autograd), the mean test-set predictive log-density, the
target details, the ``get_metrics`` hooks (``avg_predictive_log_prob``,
``objective``), the missing sampler (ROADMAP C5), and a tiny run of the
port's driver on the CPU.

Parameters are drawn with numpy from a seed and handed to both packages;
each tolerance is stated with its reason.
"""
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.eval import get_metrics as t_get_metrics
from sde_sampler_lrds_torch.targets import LogisticRegression as TLogReg
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu.eval.metrics import get_metrics
from sde_sampler_lrds_tpu.targets import LogisticRegression

DATASETS = ("cancer", "credit", "ionosphere", "sonar")


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _params(dim, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(size=(16, dim))).astype(np.float32)


@pytest.fixture(scope="module", params=DATASETS)
def pair(request):
    return request.param, LogisticRegression(data_type=request.param), TLogReg(
        data_type=request.param, device="cpu")


def test_data_and_dims_match_jax(pair):
    name, j, t = pair
    assert t.dim == j.dim and t.dim in range(25, 62)
    for k in ("X_train", "y_train", "X_test", "y_test"):
        np.testing.assert_array_equal(N(getattr(t, k)), np.asarray(getattr(j, k)))
    np.testing.assert_array_equal(N(t.domain), np.asarray(j.domain))


@pytest.mark.parametrize("scale", [0.5, 20.0])
def test_log_prob_score_and_predictive_match_jax(pair, scale):
    """At scale 20 most logits are confident (|z| ≫ 17): the floored
    log-sigmoid keeps the log-density finite in both."""
    name, j, t = pair
    x = _params(j.dim, 1, scale)
    # sums over up to ~700 data points and ~60 weights in other orders
    tol = dict(rtol=2e-5, atol=2e-3 * (1 + scale))
    lp_j, lp_t = np.asarray(j.unnorm_log_prob(jnp.asarray(x))), N(t.unnorm_log_prob(T(x)))
    assert np.isfinite(lp_t).all()
    np.testing.assert_allclose(lp_t, lp_j, **tol)
    np.testing.assert_allclose(N(t.score(T(x))), np.asarray(j.score(jnp.asarray(x))), **tol)
    np.testing.assert_allclose(float(t.compute_predictive_log_prob(T(x))),
                               float(j.compute_predictive_log_prob(jnp.asarray(x))), **tol)
    # one parameter vector: a scalar log-density
    assert t.unnorm_log_prob(T(x[0])).shape == ()


def test_score_is_the_gradient_of_the_log_density(pair):
    name, _, t = pair
    x = T(_params(t.dim, 2, 0.02))
    w, b = x[:, :-1], x[:, -1]
    assert float((w @ t.X_train.T + b[:, None]).abs().max()) < 15.0
    with torch.enable_grad():
        y = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(t.unnorm_log_prob(y).sum(), y)
    # the analytic score clips σ to [1e-8, 1 − 1e-8], autograd differentiates
    # the floored log-sigmoid: equal where no logit reaches the floor
    # (|z| < 18.4), as none does at this scale; sums over up to ~700 points
    torch.testing.assert_close(t.score(x), g, rtol=1e-4, atol=1e-3)


def test_make_target_and_details():
    for name in DATASETS:
        details = t_api.make_target_details(name)
        assert details == j_api.make_target_details(name) == {"name": name}
        target = t_api.make_target(details, device="cpu")
        assert isinstance(target, TLogReg) and target.dim == LogisticRegression(
            data_type=name).dim


def test_get_metrics_hooks_match_jax(pair):
    name, j, t = pair
    x = _params(j.dim, 3, 0.3)
    want = get_metrics(j, jnp.asarray(x), marginal_dims=[0, 1])
    got = t_get_metrics(t, T(x), marginal_dims=[0, 1])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=2e-5, abs=2e-3), k
    assert "eval/avg_predictive_log_prob" in got


def test_get_metrics_objective_hook():
    """The ``objective`` hook, which no ported target defines yet: the
    objective at the samples' mean, its mean and its minimum."""
    t = TLogReg(data_type="sonar", device="cpu")
    t.objective = lambda s: (s**2).sum(-1)
    x = T(_params(t.dim, 4))
    got = t_get_metrics(t, x)
    assert got["eval/obj_avg"] == pytest.approx(float((x.mean(0) ** 2).sum()))
    assert got["eval/avg_obj"] == pytest.approx(float((x**2).sum(-1).mean()))
    assert got["eval/min_obj"] == pytest.approx(float((x**2).sum(-1).min()))


def test_no_sampler_skips_the_sample_losses_as_jax():
    """ROADMAP C5: the posteriors have no sampler; ``get_metrics`` skips the
    sample losses in both packages, and ``sample`` raises."""
    j, t = LogisticRegression(data_type="cancer"), TLogReg(data_type="cancer", device="cpu")
    x = _params(j.dim, 5)
    want = get_metrics(j, jnp.asarray(x), sample_losses={"zero": lambda a, b: 0.0})
    got = t_get_metrics(t, T(x), sample_losses={"zero": lambda a, b: 0.0})
    assert "error/zero" not in got and set(got) == set(want)
    with pytest.raises(NotImplementedError):
        t.sample(torch.Generator(), (4,))


def test_logreg_driver_tiny_run(tmp_path):
    """The port's driver on ionosphere (d 35) with original DDS at a tiny
    size: chains from zeros, the headline metric finite on every seed."""
    from sde_sampler_lrds_torch.experiments import sample_bayesian_logreg_competing as driver

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        driver.main(["--solver_type", "dds_orig", "--datasets", "ionosphere", "--device", "cpu",
                     "--results_path", str(tmp_path), "--dataset_size", "400",
                     "--train_steps", "8", "--train_batch_size", "32",
                     "--eval_batch_size", "64", "--n_sampling_seeds", "2", "--n_steps", "8"])
    finally:
        torch.set_num_threads(threads)
    with open(tmp_path / "bayesian_logreg_solver_type_dds_orig_seed_0.pkl", "rb") as f:
        data = pickle.load(f)
    (cell,) = data["results"]
    assert cell["params"] == {"dataset": "ionosphere"}
    m = cell["metrics"]
    assert len(m["eval/avg_predictive_log_prob"]) == 2
    assert all(math.isfinite(v) for v in m["eval/avg_predictive_log_prob"])
    assert not any(k.startswith("error/sinkhorn") for k in m)
