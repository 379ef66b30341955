"""Target distribution protocol (counterpart of
sde_sampler_lrds_tpu/targets/base.py). Log-probabilities have shape (batch,);
sampling takes an explicit ``torch.Generator`` where JAX takes a key. Also
the Boole-rule grid quadrature (``boole_grid``, the base
``compute_stats_integration``), the gradient-descent flow ``run_gdflow``,
``sample_uniform`` and ``WrapperDistrNN``, which freezes a time-indexed
energy at one time as a static distribution (the learned 'nn' reference)."""
from __future__ import annotations

import logging
import math
from typing import Callable

import numpy as np
import torch

from ..utils.common import resolve_device

EXPECTATION_FNS: dict[str, Callable] = {
    "square": lambda x: (x**2).sum(dim=-1),
    "abs": lambda x: torch.abs(x).sum(dim=-1),
    "sum": lambda x: x.sum(dim=-1),
    "square_minus_sum": lambda x: (x**2 - x).sum(dim=-1),
}


class Target:
    """Base class for probability targets and priors. Subclasses implement
    ``unnorm_log_prob`` (and usually an analytic ``score``; the default
    differentiates the log-density with autograd)."""

    def __init__(self, dim: int, log_norm_const: float | None = None,
                 n_reference_samples: int | None = None, domain=None, device=None,
                 grid_points: int | None = None):
        self.dim = dim
        self.device = resolve_device(device)
        self.log_norm_const = log_norm_const
        self.n_reference_samples = n_reference_samples
        self.grid_points = grid_points
        self.domain: torch.Tensor | None = None
        self.set_domain(domain)
        self.stddevs: torch.Tensor | None = None
        self.expectations: dict[str, float] = {}

    # -- domain ------------------------------------------------------------
    def set_domain(self, d) -> None:
        """A box (dim, 2) of [low, high] per coordinate, from a scalar a
        (the box [-a, a]^dim), one [low, high] pair, or the full table."""
        if d is None:
            self.domain = None
            return
        d = torch.as_tensor(d, dtype=torch.float32, device=self.device)
        if d.ndim == 0:
            d = torch.stack([-d, d], dim=-1)
        if d.ndim == 1:
            d = d[None, :]
        if d.shape == (1, 2):
            d = d.repeat(self.dim, 1)
        if d.shape != (self.dim, 2):
            raise ValueError(f"domain must be ({self.dim}, 2), got {tuple(d.shape)}")
        self.domain = d

    # -- densities ---------------------------------------------------------
    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        if self.log_norm_const is None:
            raise NotImplementedError
        return self.unnorm_log_prob(x) - self.log_norm_const

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_prob(x))

    def unnorm_pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.unnorm_log_prob(x))

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """∇ log ρ(x) by autograd of the summed log-density."""
        with torch.enable_grad():
            y = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.unnorm_log_prob(y).sum(), y)
        return g

    def log_prob_and_score(self, x: torch.Tensor):
        """(unnorm_log_prob, score) in one call (shared by the MCMC kernels)."""
        return self.unnorm_log_prob(x), self.score(x)

    def has_entropy(self) -> bool:
        return False

    # -- sampling / stats --------------------------------------------------
    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        raise NotImplementedError

    def compute_stats_sampling(self, generator: torch.Generator,
                               return_samples: bool = False):
        """Reference expectations by Monte Carlo."""
        samples = self.sample(generator, (self.n_reference_samples,))
        for name, fn in EXPECTATION_FNS.items():
            if name not in self.expectations:
                self.expectations[name] = float(fn(samples).mean())
        if self.stddevs is None:
            self.stddevs = samples.std(dim=0, correction=0)
        if return_samples:
            return samples

    def compute_stats_integration(self):
        """Reference expectations (and the log normalizing constant where it
        is unknown) by Boole-rule quadrature over the box domain."""
        if self.domain is None or self.grid_points is None:
            raise ValueError("Integration requires domain and grid_points.")
        pts, weights = boole_grid(self.domain, self.grid_points)

        def integrate(fn):
            return float(torch.sum(fn(pts) * weights))

        if self.log_norm_const is None:
            self.log_norm_const = math.log(integrate(self.unnorm_pdf))
        for name, fn in EXPECTATION_FNS.items():
            if name not in self.expectations:
                self.expectations[name] = integrate(lambda x, fn=fn: fn(x) * self.pdf(x))
        if self.stddevs is None:
            pw = (self.pdf(pts) * weights)[:, None]
            mean = torch.sum(pts * pw, dim=0)
            self.stddevs = torch.sqrt(torch.sum((pts - mean) ** 2 * pw, dim=0))

    def compute_stats(self, generator: torch.Generator | None = None):
        if self.n_reference_samples is not None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            try:
                self.compute_stats_sampling(generator)
                return
            except NotImplementedError:
                pass
        if self.grid_points is not None and self.domain is not None:
            self.compute_stats_integration()
        else:
            logging.warning("Cannot compute statistics for %s", type(self).__name__)


class ModeMetrics:
    """Mode-coverage metrics of a target whose modes ``compute_mode_count``
    counts and ``_probs`` weighs (``n_mixtures`` of them), and their
    expectations over the target's reference draws. Mixed in before
    ``Target``."""

    def _entropy_norm(self) -> float:
        return math.log(self.n_mixtures)

    def _hist(self, samples, counts=None):
        counts = self.compute_mode_count(samples) if counts is None else counts
        return counts / counts.sum()

    def entropy(self, samples, counts=None):
        hist = self._hist(samples, counts)
        # xlogy: a mode with zero samples contributes 0, not NaN
        return -torch.sum(torch.special.xlogy(hist, hist)) / self._entropy_norm()

    def kl_weights(self, samples, counts=None):
        return torch.sum(self._probs * torch.log(self._probs / self._hist(samples, counts)))

    def tv_weights(self, samples, counts=None):
        return torch.sum(torch.abs(self._hist(samples, counts) - self._probs))

    def compute_forgotten_modes(self, samples, tol: float = 0.05, counts=None):
        hist = self._hist(samples, counts)
        return torch.sum(hist < tol * self._probs.min()) / self.n_mixtures

    def compute_stats_sampling(self, generator, return_samples: bool = False):
        samples = super().compute_stats_sampling(generator, return_samples=True)
        if self.has_entropy():
            counts = self.compute_mode_count(samples)
            self.expectations["emc"] = float(self.entropy(samples, counts=counts))
            self.expectations["kl_weights"] = float(self.kl_weights(samples, counts=counts))
            self.expectations["tv_weights"] = float(self.tv_weights(samples, counts=counts))
            self.expectations["num_forgotten_modes"] = float(
                self.compute_forgotten_modes(samples, counts=counts))
        if return_samples:
            return samples


def boole_grid(domain: torch.Tensor, n_points: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-product Boole (Newton-Cotes order 4) quadrature on the box
    ``domain`` (dim, 2) with about ``n_points`` points: the flattened grid
    (N, dim) and its weights (N,), on the domain's device, so that
    ``sum(f(points) * weights)`` approximates the integral. Each axis gets
    4k + 1 ≥ 5 points."""
    dim = domain.shape[0]
    n_per_dim = int(round(n_points ** (1.0 / dim)))
    n_per_dim = max(5, n_per_dim - ((n_per_dim - 1) % 4))
    axes, w1d = [], []
    pattern = np.array([2.0, 32.0, 12.0, 32.0])
    for d in range(dim):
        a, b = float(domain[d, 0]), float(domain[d, 1])
        h = (b - a) / (n_per_dim - 1)
        w = np.tile(pattern, (n_per_dim - 1) // 4 + 1)[:n_per_dim]
        w[0] = 7.0
        w[-1] = 7.0
        w[4:-1:4] = 14.0
        axes.append(np.linspace(a, b, n_per_dim))
        w1d.append(w * (2.0 * h / 45.0))
    pts = np.stack([m.reshape(-1) for m in np.meshgrid(*axes, indexing="ij")], axis=-1)
    weights = np.prod(np.stack([m.reshape(-1) for m in np.meshgrid(*w1d, indexing="ij")],
                               axis=-1), axis=-1)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=domain.device)
    return as_t(pts), as_t(weights)


def run_gdflow(grad_U: Callable, x_init: torch.Tensor, n_steps: int, dt: float,
               chunk: int = 100) -> torch.Tensor:
    """``n_steps`` of the gradient-descent flow x ← x − dt·∇U(x), toward the
    local energy minima. On the card ``chunk`` steps are captured once as a
    CUDA graph and replayed (the same kernels in the same order; ``grad_U``
    must be capturable: tensor operations only, no host reads)."""
    step = lambda y: y - dt * grad_U(y)
    x, n_graphed = x_init, 0
    if x_init.is_cuda and n_steps >= 2 * chunk:
        static = x_init.clone()
        side = torch.cuda.Stream(x_init.device)
        side.wait_stream(torch.cuda.current_stream(x_init.device))
        with torch.cuda.stream(side):
            step(static)                                     # warm-up, discarded
        torch.cuda.current_stream(x_init.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = static
            for _ in range(chunk):
                y = step(y)
        n_graphed = n_steps // chunk * chunk
        for _ in range(n_steps // chunk):
            graph.replay()
            static.copy_(y)
        x = static.clone()
    for _ in range(n_steps - n_graphed):
        x = step(x)
    return x


def sample_uniform(generator: torch.Generator, domain: torch.Tensor,
                   batch_size: int = 1) -> torch.Tensor:
    """Uniform draws (batch_size, dim) over the box ``domain``."""
    rand = torch.rand((batch_size, domain.shape[0]), generator=generator,
                      device=domain.device)
    return domain[:, 0] + rand * (domain[:, 1] - domain[:, 0])


class WrapperDistrNN(Target):
    """A time-indexed energy frozen at the time ``t`` as a static
    distribution: ``unnorm_log_prob(x) = unnorm_log_prob_t(t, x)`` with one
    time a row (the trained EBM installed as the RDS reference). Its log
    normalizing constant is taken as 0."""

    def __init__(self, dim: int, unnorm_log_prob_t: Callable, t: float, device=None):
        super().__init__(dim=dim, log_norm_const=0.0, device=device)
        self._unnorm_log_prob_t = unnorm_log_prob_t
        self.t = float(t)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.full(x.shape[:-1], self.t, dtype=x.dtype, device=x.device)
        return self._unnorm_log_prob_t(t, x)
