"""2-D concentric rings: a Gaussian mixture over the radius times a uniform
angle, in Cartesian coordinates through the polar change of variables
(counterpart of sde_sampler_lrds_tpu/targets/rings.py), with the analytic
score x·(score_r(|x|)/|x| − 1/|x|²) and the mode-coverage metrics."""
from __future__ import annotations

import math

import torch

from .base import ModeMetrics, Target
from .gauss import log_prob_gaussian, score_mog

# keeps the score finite at r = 0
SCORE_EPS = 1e-7


class Rings(ModeMetrics, Target):
    """``num_rad`` rings at radii linspace(lower_rad, upper_rad) of radial
    scale ``scale``, weighted by their radius (or equally when
    ``equilibrated``)."""

    def __init__(self, dim: int = 2, lower_rad: float = 1.0, upper_rad: float = 5.0,
                 num_rad: int = 3, scale: float = 0.1, equilibrated: bool = False,
                 n_reference_samples: int = int(1e6), domain_tol: float = 5.0,
                 domain=None, device=None):
        if dim != 2:
            raise ValueError("The rings should be two-dimensional.")
        super().__init__(dim=2, log_norm_const=0.0, n_reference_samples=n_reference_samples,
                         domain=domain, device=device)
        self.n_mixtures = num_rad
        self.radiuses = torch.linspace(lower_rad, upper_rad, num_rad, dtype=torch.float32,
                                       device=self.device)
        self.scale = scale
        weights = (torch.ones(num_rad, device=self.device) if equilibrated
                   else self.radiuses / self.radiuses.sum())
        self.mixture_weights = weights
        self._probs = weights / weights.sum()
        self._radius_var = torch.full((num_rad, 1), scale**2, device=self.device)
        if self.domain is None:
            r = upper_rad + domain_tol * scale
            self.set_domain([[-r, r], [-r, r]])

    # -- radius mixture ----------------------------------------------------
    def _radius_log_prob(self, r: torch.Tensor) -> torch.Tensor:
        lp = log_prob_gaussian(r.reshape(-1, 1), self.radiuses[:, None], self._radius_var)
        return torch.logsumexp(torch.log(self._probs)[None] + lp, dim=-1).reshape(r.shape)

    def score_radius(self, r: torch.Tensor) -> torch.Tensor:
        return score_mog(r, self.mixture_weights, self.radiuses[:, None], self._radius_var)

    # -- density -----------------------------------------------------------
    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.linalg.vector_norm(x, dim=-1)
        # the radius' log-density, the uniform angle's, and −log|J| (J = r)
        return self._radius_log_prob(r) - math.log(2 * math.pi) - torch.log(r)

    def score(self, x: torch.Tensor) -> torch.Tensor:
        norm_x = torch.linalg.vector_norm(x, dim=-1, keepdim=True) + SCORE_EPS
        return x * (self.score_radius(norm_x) / norm_x - 1.0 / norm_x**2)

    def _polar(self, r: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        theta = 2 * math.pi * torch.rand(r.shape, generator=generator, device=self.device)
        return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        idx = torch.multinomial(self._probs, math.prod(shape), replacement=True,
                                generator=generator).reshape(shape)
        r = self.radiuses[idx] + self.scale * torch.randn(shape, generator=generator,
                                                          device=self.device)
        return self._polar(r, generator)

    def sample_init_points(self, generator: torch.Generator,
                           n_points_per_mode: int) -> torch.Tensor:
        """``n_points_per_mode`` draws on every ring (seeds for the MCMC
        chains), (n_points_per_mode · num_rad, 2)."""
        r = self.radiuses[None, :] + self.scale * torch.randn(
            (n_points_per_mode, self.n_mixtures), generator=generator, device=self.device)
        return self._polar(r.reshape(-1), generator)

    # -- mode metrics --------------------------------------------------------
    def has_entropy(self) -> bool:
        return True

    def compute_mode_count(self, samples: torch.Tensor) -> torch.Tensor:
        """Samples per ring, each sample on the ring of the nearest squared
        radius."""
        r_sq = torch.sum(samples**2, dim=-1)
        idx = torch.argmin(torch.abs(r_sq[:, None] - self.radiuses[None] ** 2), dim=-1)
        return torch.bincount(idx, minlength=self.n_mixtures).to(torch.float32)
