"""Target distribution protocol (counterpart of
sde_sampler_lrds_tpu/targets/base.py). Log-probabilities have shape (batch,);
sampling takes an explicit ``torch.Generator`` where JAX takes a key."""
from __future__ import annotations

import logging
import math
from typing import Callable

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
                 n_reference_samples: int | None = None, domain=None, device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self.log_norm_const = log_norm_const
        self.n_reference_samples = n_reference_samples
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

    def compute_stats(self, generator: torch.Generator | None = None):
        if self.n_reference_samples is not None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            try:
                self.compute_stats_sampling(generator)
                return
            except NotImplementedError:
                pass
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
