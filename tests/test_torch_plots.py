"""The port's diagnostic plots (``eval/plots.py``) held against the JAX
package's on the same samples: the 1-D histograms' bar heights (plain and
IS-reweighted) and the true marginal's curve, the smoothed 2-D heatmaps,
the contour grids and levels, the trajectory fans, the bundle's figure keys,
and the file names the CLI's ``--plots`` writes against the JAX CLI's rule
(``scripts/main.py``: one PNG a key, '/' made '_').

Histograms run on host numpy in both packages, so the heights agree to
1e-6; the curves and the contour grid come from float32 log-densities in
two libraries (1e-5 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import pyplot as plt

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.eval import plots as t_plots
from sde_sampler_lrds_torch.scripts.main import write_plots
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_tpu.api import make_target_details
from sde_sampler_lrds_tpu.eval import plots as j_plots
from sde_sampler_lrds_tpu.targets import ManyModes


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _samples(n=2000, dim=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32) * 1.5
    w = rng.random(n).astype(np.float32)
    return x, w / w.sum()


def _targets():
    return (ManyModes(n_modes=3, dim=2, var=0.3),
            TManyModes(n_modes=3, dim=2, var=0.3, n_reference_samples=1000, device="cpu"))


def _heights(fig):
    return np.array([p.get_height() for p in fig.axes[0].patches])


def test_histograms_and_marginal_curve_match_jax():
    j_t, t_t = _targets()
    x, w = _samples()
    for dim in (0, 1):
        fj = j_plots.plot_marginal(jnp.asarray(x), weights=jnp.asarray(w),
                                   marginal=j_t.marginal, dim=dim, nbins=40,
                                   domain=j_t.domain)
        ft = t_plots.plot_marginal(torch.as_tensor(x), weights=torch.as_tensor(w),
                                   marginal=t_t.marginal, dim=dim, nbins=40, domain=t_t.domain)
        assert len(ft.axes[0].patches) == 80
        np.testing.assert_allclose(_heights(ft), _heights(fj), rtol=1e-6, atol=1e-6)
        (lj,), (lt,) = fj.axes[0].lines, ft.axes[0].lines
        np.testing.assert_allclose(lt.get_xdata(), lj.get_xdata(), rtol=1e-6)
        np.testing.assert_allclose(lt.get_ydata(), lj.get_ydata(), rtol=1e-5, atol=1e-7)
    # no domain: the range is the data's
    fj = j_plots.plot_marginal(jnp.asarray(x), dim=1, nbins=25)
    ft = t_plots.plot_marginal(torch.as_tensor(x), dim=1, nbins=25)
    np.testing.assert_allclose(_heights(ft), _heights(fj), rtol=1e-6, atol=1e-6)


def test_heatmaps_contours_and_trajectories_match_jax():
    j_t, t_t = _targets()
    x, w = _samples(seed=1)
    for weights in (None, w):
        fj = j_plots.plot_marginal_2d(jnp.asarray(x), weights=weights, nbins=30,
                                      domain=j_t.domain)
        ft = t_plots.plot_marginal_2d(torch.as_tensor(x), weights=weights, nbins=30,
                                      domain=t_t.domain)
        np.testing.assert_allclose(np.asarray(ft.axes[0].images[0].get_array()),
                                   np.asarray(fj.axes[0].images[0].get_array()),
                                   rtol=1e-6, atol=1e-9)
        assert ft.axes[0].images[0].get_extent() == pytest.approx(
            fj.axes[0].images[0].get_extent(), rel=1e-6)
    fj = j_plots.plot_contours_2d(j_t.log_prob, j_t.domain, nbins=40, levels=12)
    ft = t_plots.plot_contours_2d(t_t.log_prob, t_t.domain, nbins=40, levels=12)
    xg, yg, lp = t_plots.contour_grid(t_t.log_prob, t_t.domain, nbins=40)
    d = np.asarray(j_t.domain)
    jx, jy = np.meshgrid(np.linspace(d[0, 0], d[0, 1], 40), np.linspace(d[1, 0], d[1, 1], 40),
                         indexing="ij")
    j_lp = np.asarray(j_t.log_prob(jnp.asarray(np.stack([jx, jy], -1).reshape(-1, 2),
                                               jnp.float32))).reshape(40, 40).clip(min=-1000)
    np.testing.assert_allclose(xg, jx, rtol=1e-6)
    np.testing.assert_allclose(lp, j_lp, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ft.axes[0].collections[0].levels,
                               fj.axes[0].collections[0].levels, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(2)
    ts = np.linspace(0.0, 1.0, 9).astype(np.float32)
    xs = rng.normal(size=(9, 64, 2)).astype(np.float32)
    xs[3, 5, 0] = np.nan                       # filtered in both
    fj = j_plots.plot_evolution(jnp.asarray(ts), jnp.asarray(xs), dim=0, ntraj=20,
                                domain=j_t.domain)
    ft = t_plots.plot_evolution(torch.as_tensor(ts), torch.as_tensor(xs), dim=0, ntraj=20,
                                domain=t_t.domain)
    assert len(ft.axes[0].lines) == len(fj.axes[0].lines) == 20
    for lt, lj in zip(ft.axes[0].lines, fj.axes[0].lines):
        np.testing.assert_array_equal(lt.get_ydata(), lj.get_ydata())
        assert lt.get_color() == lj.get_color()


def test_bundle_keys_and_cli_file_names_match_jax(tmp_path):
    """The bundle's keys on the same samples, and the PNGs the port CLI's
    ``--plots`` step writes against the names the JAX CLI gives the JAX
    bundle's keys."""
    j_t, t_t = _targets()
    x, w = _samples(n=256, seed=3)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    xs = np.random.default_rng(4).normal(size=(5, 256, 2)).astype(np.float32)
    j_keys = set(j_plots.get_plots(j_t, jnp.asarray(x), weights=jnp.asarray(w),
                                   ts=jnp.asarray(ts), xs=jnp.asarray(xs),
                                   marginal_dims=[0, 1], nbins=20))
    t_keys = set(t_plots.get_plots(t_t, torch.as_tensor(x), weights=torch.as_tensor(w),
                                   ts=torch.as_tensor(ts), xs=torch.as_tensor(xs),
                                   marginal_dims=[0, 1], nbins=20))
    assert t_keys == j_keys and "plots/groundtruth_density_0_1" in t_keys
    solver = t_make_model(
        solver_type="vp-ref", ref_type="default", loss_type="lv", integrator_type="ei",
        model_type="base_zero_init", time_type="snr", solver_details={"sigma": 1.0},
        target_details=make_target_details("two_modes", dim=2),
        training_details={"train_steps": 1, "train_batch_size": 8, "eval_batch_size": 64},
        n_steps=4, device="cpu")
    solver.setup()
    paths = write_plots(solver, 3, tmp_path, "cpu")
    names = {p.name for p in tmp_path.glob("*.png")}
    assert names == {p.name for p in paths} == {f"{k.replace('/', '_')}.png" for k in j_keys}
