"""Diagnostic plots: contours, 1-D and 2-D marginals (plain and
IS-reweighted), trajectory fans (counterpart of
sde_sampler_lrds_tpu/eval/plots.py, with its functions, figure keys and
rules).

The histograms and grids are host numpy; tensors are read to the host
first, and a log-density or marginal is called on a float32 tensor on the
target's device. matplotlib (Agg) and scipy are imported when a plot is
made, not when this module is imported: a machine without matplotlib runs
everything else of the port, and a plot there raises ImportError.
"""
from __future__ import annotations

import itertools
import logging
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _call(fn: Callable, points: np.ndarray, device, **kwargs) -> np.ndarray:
    return _host(fn(torch.as_tensor(points, dtype=torch.float32, device=device), **kwargs))


def contour_grid(log_prob: Callable, domain, nbins: int = 200, thresh: float = -1000.0,
                 device=None):
    """The (x, y, log-density) grids of ``plot_contours_2d``: ``nbins`` points
    a side over the box ``domain``, clipped below at ``thresh``."""
    d = _host(domain)
    x = np.linspace(d[0, 0], d[0, 1], nbins)
    y = np.linspace(d[1, 0], d[1, 1], nbins)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    xy = np.stack([xg, yg], axis=-1).reshape(-1, 2)
    lp = _call(log_prob, xy, device).reshape(nbins, nbins).clip(min=thresh)
    return xg, yg, lp


def plot_contours_2d(log_prob: Callable, domain, nbins: int = 200, levels: int = 50,
                     thresh: float = -1000.0, ax=None, device=None):
    """Contours of a 2-D log-density over the box domain."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(1)
    xg, yg, lp = contour_grid(log_prob, domain, nbins, thresh, device)
    ax.contour(xg, yg, lp, levels=levels)
    ax.set_ylabel(r"$x_1$")
    ax.set_xlabel(r"$x_2$")
    return ax.get_figure()


def plot_marginal_2d(x, dim1: int = 0, dim2: int = 1, weights=None, nbins: int = 100,
                     domain=None, smoothing: float = 0.1, ax=None, scatter: bool = False):
    """2-D marginal heatmap: the smoothed density histogram."""
    from scipy.ndimage import gaussian_filter

    plt = _plt()
    data = _host(x)[:, [dim1, dim2]]
    if ax is None:
        _, ax = plt.subplots(1, 1)
    rng = None
    if domain is not None:
        d = _host(domain)
        rng = [d[dim1].tolist(), d[dim2].tolist()]
    w = None if weights is None else _host(weights)
    heatmap, binsx, binsy = np.histogram2d(data[:, 0], data[:, 1], bins=nbins, range=rng,
                                           weights=w, density=True)
    heatmap = gaussian_filter(heatmap, sigma=smoothing)
    extent = [binsx[0], binsx[-1], binsy[0], binsy[-1]]
    palette = plt.get_cmap("Blues").copy()
    palette.set_under("white", 0.0)
    ax.imshow(heatmap.T, extent=extent, vmin=0.0, origin="lower", cmap=palette,
              aspect="auto")
    if scatter:
        ax.scatter(x=data[:, 0], y=data[:, 1], s=0.001, c="k")
    ax.set_ylabel(rf"$x_{dim2 + 1:d}$")
    ax.set_xlabel(rf"$x_{dim1 + 1:d}$")
    return ax.get_figure()


def plot_marginal(x, weights=None, marginal: Callable | None = None, dim: int = 0,
                  nbins: int = 100, domain=None, ax=None, device=None):
    """1-D marginal histogram, with the IS-reweighted one and the true
    marginal's curve where given."""
    plt = _plt()
    data = _host(x)[:, dim]
    if ax is None:
        _, ax = plt.subplots(1, 1)
    if domain is None:
        rng = (float(data.min()), float(data.max()))
    else:
        rng = tuple(_host(domain)[dim].tolist())
    ax.hist(data, bins=nbins, range=rng, density=True, alpha=0.6, label="histogram")
    if weights is not None:
        ax.hist(data, bins=nbins, range=rng, density=True, alpha=0.6,
                weights=_host(weights), label="histogram_is")
    if marginal is not None:
        xlin = np.linspace(*rng, nbins)
        ax.plot(xlin, _call(marginal, xlin, device, dim=dim).reshape(-1), label="marginal")
    ax.legend()
    return ax.get_figure()


def plot_evolution(ts, xs, dim: int = 0, ntraj: int = 50, domain=None, ax=None):
    """Trajectory fan over time, hue-coded by the terminal value."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(1, 1)
    trajs = _host(xs)[:, :, dim].T  # (B, K+1)
    mask = np.isfinite(trajs).all(axis=1)
    discard = mask.size - mask.sum()
    if discard > 0:
        logging.warning("Filtering %d trajectories with non-finite values.", discard)
    if discard < mask.size:
        trajs = trajs[mask][:ntraj]
        term = trajs[:, -1]
        hues = (term - term.min()) / (1e-8 + term.max() - term.min())
        cmap = plt.get_cmap("hsv")
        for traj, hue in zip(trajs, hues):
            ax.plot(_host(ts), traj, color=cmap(hue), linewidth=0.4)
    if domain is not None:
        ax.set_ylim(*_host(domain)[dim].tolist())
    return ax.get_figure()


def get_plots(distr, samples, weights=None, ts=None, xs=None, marginal_dims=None,
              nbins: int = 100, domain=None, sample_generator: torch.Generator | None = None
              ) -> dict:
    """The plot bundle, under the JAX package's keys: ``plots/traj_d``,
    ``plots/hist_d``, ``plots/density_d1_d2`` and, where the target samples,
    ``plots/groundtruth_density_d1_d2`` from as many target draws as samples
    (``sample_generator``, by default a generator on the target's device
    seeded 4321)."""
    plots = {}
    marginal_dims = [d for d in (marginal_dims or []) if d < distr.dim]
    if domain is None and distr.domain is not None:
        domain = distr.domain if bool(torch.isfinite(distr.domain).all()) else None
    device = getattr(distr, "device", None)
    for d in marginal_dims:
        if ts is not None and xs is not None:
            plots[f"plots/traj_{d}"] = plot_evolution(ts=ts, xs=xs, dim=d, domain=domain)
        plots[f"plots/hist_{d}"] = plot_marginal(
            x=samples, weights=weights, marginal=getattr(distr, "marginal", None), dim=d,
            nbins=nbins, domain=domain, device=device)
    for dim1, dim2 in itertools.combinations(marginal_dims, r=2):
        plots[f"plots/density_{dim1}_{dim2}"] = plot_marginal_2d(
            x=samples, dim1=dim1, dim2=dim2, nbins=nbins, domain=domain)
    try:
        g = sample_generator if sample_generator is not None else \
            torch.Generator(device if device is not None else "cpu").manual_seed(4321)
        gt = distr.sample(g, (samples.shape[0],))
        for dim1, dim2 in itertools.combinations(marginal_dims, r=2):
            plots[f"plots/groundtruth_density_{dim1}_{dim2}"] = plot_marginal_2d(
                x=gt, dim1=dim1, dim2=dim2, nbins=nbins, domain=domain)
    except NotImplementedError:
        pass
    return plots


def save_fig(fig, path) -> None:
    """Write ``fig`` to ``path`` (its folders made) and close it."""
    plt = _plt()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
