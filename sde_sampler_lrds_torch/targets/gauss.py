"""Gaussian / Gaussian-mixture targets with closed-form log-probs and scores
(counterpart of sde_sampler_lrds_tpu/targets/gauss.py: the diagonal and
full-covariance functional densities, the ``gmm_params`` presets, the
diagonal mixtures GMM, TwoModes, BracketTwoModes and ManyModes, the
full-covariance mixtures GMMFull and TwoModesFull, Gauss, GaussFull and the
optionally truncated IsotropicGauss). Mixture scores are computed in
log-space with softmax responsibilities."""
from __future__ import annotations

import math
from numbers import Number
from statistics import NormalDist

import numpy as np
import torch

from .base import ModeMetrics, Target

_LOG_2PI = math.log(2.0 * math.pi)


def gmm_params(name: str = "heart", dim: int = 2):
    """Preset MoG parameters ('heart', 'dist', 'fab', 'multi', 'grid',
    'circle') as float32 numpy arrays (loc, scale, weights)."""
    if name == "heart":
        loc = 1.5 * np.array(
            [[-0.5, -0.25], [0.0, -1.0], [0.5, -0.25], [-1.0, 0.5],
             [-0.5, 1.0], [0.0, 0.5], [0.5, 1.0], [1.0, 0.5]])
        factor = 1.0 / len(loc)
    elif name == "dist":
        loc = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 3.0], [-4.0, 0.0], [0.0, -5.0]])
        factor = math.sqrt(0.2)
    elif name in ("fab", "multi"):
        n_mixes, loc_scaling = (40, 40) if name == "fab" else (80, 80)
        rng = np.random.default_rng(42)
        loc = (rng.random((n_mixes, 2)) - 0.5) * 2 * loc_scaling
        factor = math.log1p(math.e)  # softplus(1.0)
    elif name == "grid":
        x = np.linspace(-5, 5, 3)
        loc = np.stack(np.meshgrid(x, x, indexing="ij"), axis=-1).reshape(-1, 2)
        factor = math.sqrt(0.3)
    elif name == "circle":
        freq = 2 * np.pi * np.arange(1, 9) / 8
        loc = np.stack([4.0 * np.cos(freq), 4.0 * np.sin(freq)], axis=1)
        factor = math.sqrt(0.3)
    else:
        raise ValueError("Unknown mode for the Gaussian mixture.")
    if dim > 2:
        loc = np.concatenate([loc, np.zeros((loc.shape[0], dim - 2))], axis=1)
    loc = loc.astype(np.float32)
    scale = np.float32(factor) * np.ones_like(loc)
    return loc, scale, np.ones((loc.shape[0],), np.float32)


# ---------------------------------------------------------------------------
# functional log-probs / scores (vectorized over mixture components)
# ---------------------------------------------------------------------------

def log_prob_gaussian(x: torch.Tensor, means: torch.Tensor,
                      variances: torch.Tensor) -> torch.Tensor:
    """Per-component diagonal-Gaussian log-density.
    x: (B, D), means/variances: (K, D)  ->  (B, K)."""
    diff = x[:, None, :] - means[None, :, :]
    lp = -0.5 * torch.sum(diff**2 / variances[None, :, :], dim=-1)
    lp = lp - 0.5 * means.shape[-1] * _LOG_2PI
    return lp - 0.5 * torch.sum(torch.log(variances), dim=-1)[None, :]


def log_prob_gaussian_full(x: torch.Tensor, means: torch.Tensor, covariances,
                           precisions=None, covariances_log_det=None,
                           return_precision_times_diff: bool = False):
    """Per-component full-covariance Gaussian log-density, from the
    covariances (one solve per component, never a (B, K, D, D) tensor) or
    from precomputed precisions and log-determinants.
    x: (B, D), means: (K, D), covariances/precisions: (K, D, D) -> (B, K)."""
    diff = x[:, None, :] - means[None, :, :]                       # (B, K, D)
    if precisions is None:
        ptd = torch.stack([torch.linalg.solve(covariances[k], diff[:, k].T).T
                           for k in range(means.shape[0])], dim=1)
    else:
        ptd = torch.einsum("kij,bkj->bki", precisions, diff)
    lp = -0.5 * torch.sum(diff * ptd, dim=-1) - 0.5 * means.shape[-1] * _LOG_2PI
    if covariances_log_det is None:
        covariances_log_det = torch.linalg.slogdet(covariances)[1]
    lp = lp - 0.5 * covariances_log_det[None, :]
    return (lp, ptd) if return_precision_times_diff else lp


def score_mog(x, weights, means, variances):
    """Score of a diagonal-covariance MoG at x (B, D)."""
    w = weights / weights.sum()
    resp = torch.softmax(torch.log(w)[None, :]
                         + log_prob_gaussian(x, means, variances), dim=-1)
    grad_comp = (x[:, None, :] - means[None, :, :]) / variances[None, :, :]
    return -torch.sum(resp[..., None] * grad_comp, dim=1)


def score_mog_full(x, weights, means, covariances, precisions=None,
                   covariances_log_det=None):
    """Score of a full-covariance MoG at x (B, D)."""
    w = weights / weights.sum()
    lp, ptd = log_prob_gaussian_full(x, means, covariances, precisions=precisions,
                                     covariances_log_det=covariances_log_det,
                                     return_precision_times_diff=True)
    resp = torch.softmax(torch.log(w)[None, :] + lp, dim=-1)
    return -torch.sum(resp[..., None] * ptd, dim=1)


def score_gauss(x, means, variances):
    return -(x - means) / variances


def score_gauss_full(x, means, covariances, precisions=None):
    diff = x - means[None, :]
    if precisions is None:
        return -torch.linalg.solve(covariances, diff.T).T
    return -diff @ precisions.T


def mog_log_prob(x, weights, means, variances):
    """Normalized log-density of a diagonal MoG; x (B, D) -> (B,)."""
    logw = torch.log(weights / weights.sum())
    return torch.logsumexp(logw[None, :] + log_prob_gaussian(x, means, variances),
                           dim=-1)


def mog_full_log_prob(x, weights, means, covariances, precisions=None,
                      covariances_log_det=None):
    """Normalized log-density of a full-covariance MoG; x (B, D) -> (B,)."""
    logw = torch.log(weights / weights.sum())
    lp = log_prob_gaussian_full(x, means, covariances, precisions=precisions,
                                covariances_log_det=covariances_log_det)
    return torch.logsumexp(logw[None, :] + lp, dim=-1)


# ---------------------------------------------------------------------------
# distribution classes
# ---------------------------------------------------------------------------

class GMM(ModeMetrics, Target):
    """Mixture of Gaussians with diagonal component covariances, given its
    parameters or a ``gmm_params`` preset ``name``."""

    def __init__(self, dim: int = 2, loc=None, scale=None, mixture_weights=None,
                 n_reference_samples: int = int(1e6), name: str | None = None,
                 domain_scale: float = 5.0, domain=None, device=None):
        super().__init__(dim=dim, log_norm_const=0.0,
                         n_reference_samples=n_reference_samples, domain=domain,
                         device=device)
        if name is not None:
            loc, scale, mixture_weights = gmm_params(name, dim=dim)
        loc = torch.as_tensor(loc, dtype=torch.float32, device=self.device)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=self.device)
        self.n_mixtures = loc.shape[0]
        if loc.shape != scale.shape or loc.shape != (self.n_mixtures, self.dim):
            raise ValueError("Shape mismatch between loc and scale.")
        if mixture_weights is None:
            if self.n_mixtures > 1:
                raise ValueError("Require mixture weights.")
            mixture_weights = torch.ones((1,))
        self.loc = loc
        self.scale = scale
        self.mixture_weights = torch.as_tensor(
            mixture_weights, dtype=torch.float32, device=self.device)
        self._probs = self.mixture_weights / self.mixture_weights.sum()
        mean, std = self._mixture_mean_std()
        if self.domain is None:
            self.set_domain(torch.stack([mean - domain_scale * std,
                                         mean + domain_scale * std], dim=1))
        self.stddevs = std

    def _mixture_mean_std(self):
        p = self._probs[:, None]
        mean = torch.sum(p * self.loc, dim=0)
        second = torch.sum(p * (self.scale**2 + self.loc**2), dim=0)
        return mean, torch.sqrt(second - mean**2)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, self.dim)
        lp = mog_log_prob(flat, self.mixture_weights, self.loc, self.scale**2)
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return score_mog(x, self.mixture_weights, self.loc, self.scale**2)

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        n = math.prod(shape)
        idx = torch.multinomial(self._probs, n, replacement=True,
                                generator=generator).reshape(shape)
        eps = torch.randn((*shape, self.dim), generator=generator,
                          device=self.device)
        return self.loc[idx] + self.scale[idx] * eps

    def marginal(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The 1-D marginal density along coordinate ``dim`` at the points x
        (the plots' overlay)."""
        lp = log_prob_gaussian(x.reshape(-1, 1), self.loc[:, dim:dim + 1],
                               self.scale[:, dim:dim + 1] ** 2)
        return torch.exp(torch.logsumexp(torch.log(self._probs)[None] + lp, dim=-1))

    # -- mode-coverage metrics ---------------------------------------------
    def has_entropy(self) -> bool:
        return self.n_mixtures > 1

    def compute_mode_count(self, samples: torch.Tensor) -> torch.Tensor:
        lp = log_prob_gaussian(samples, self.loc, self.scale**2)
        idx = torch.argmax(lp, dim=-1)
        return torch.bincount(idx, minlength=self.n_mixtures).to(torch.float32)


class GMMFull(ModeMetrics, Target):
    """Mixture of Gaussians with full component covariances (K, D, D), given
    the covariances or the precisions."""

    def __init__(self, dim: int = 2, loc=None, cov=None, prec=None, cov_log_det=None,
                 mixture_weights=None, n_reference_samples: int = int(1e6),
                 domain_scale: float = 5.0, domain=None, device=None):
        super().__init__(dim=dim, log_norm_const=0.0,
                         n_reference_samples=n_reference_samples, domain=domain,
                         device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        loc = as_t(loc)
        self.n_mixtures = loc.shape[0]
        if cov is None and prec is None:
            raise ValueError("Either cov or prec must be set.")
        if cov is not None:
            cov = as_t(cov)
            prec = torch.linalg.inv(cov) if prec is None else as_t(prec)
        else:
            prec = as_t(prec)
            cov = torch.linalg.inv(prec)
        self.loc, self.cov, self.prec = loc, cov, prec
        self.cov_log_det = (torch.linalg.slogdet(cov)[1] if cov_log_det is None
                            else as_t(cov_log_det))
        if mixture_weights is None:
            if self.n_mixtures > 1:
                raise ValueError("Require mixture weights.")
            mixture_weights = torch.ones((1,))
        self.mixture_weights = as_t(mixture_weights)
        self._probs = self.mixture_weights / self.mixture_weights.sum()
        self.chol = torch.linalg.cholesky(cov)
        mean, std = self._mixture_mean_std()
        if self.domain is None:
            self.set_domain(torch.stack([mean - domain_scale * std,
                                         mean + domain_scale * std], dim=1))
        self.stddevs = std

    def _mixture_mean_std(self):
        p = self._probs[:, None]
        mean = torch.sum(p * self.loc, dim=0)
        diag = torch.diagonal(self.cov, dim1=-2, dim2=-1)
        second = torch.sum(p * (diag + self.loc**2), dim=0)
        return mean, torch.sqrt(second - mean**2)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, self.dim)
        lp = mog_full_log_prob(flat, self.mixture_weights, self.loc, self.cov,
                               precisions=self.prec, covariances_log_det=self.cov_log_det)
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return score_mog_full(x, self.mixture_weights, self.loc, self.cov,
                              precisions=self.prec, covariances_log_det=self.cov_log_det)

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        n = math.prod(shape)
        idx = torch.multinomial(self._probs, n, replacement=True,
                                generator=generator).reshape(shape)
        eps = torch.randn((*shape, self.dim), generator=generator, device=self.device)
        return self.loc[idx] + torch.einsum("...ij,...j->...i", self.chol[idx], eps)

    def has_entropy(self) -> bool:
        return self.n_mixtures > 1

    def compute_mode_count(self, samples: torch.Tensor) -> torch.Tensor:
        lp = log_prob_gaussian_full(samples, self.loc, self.cov, precisions=self.prec,
                                    covariances_log_det=self.cov_log_det)
        idx = torch.argmax(lp, dim=-1)
        return torch.bincount(idx, minlength=self.n_mixtures).to(torch.float32)


class _ModeWeightMixin:
    """Adds the strongest mode's weight, in percent of the samples, as a
    metric and as the expectation ``mode_weight``."""

    def compute_mode_weight(self, samples: torch.Tensor) -> torch.Tensor:
        counts = self.compute_mode_count(samples)
        return 100.0 * counts[0] / counts.sum()

    def compute_stats_sampling(self, generator, return_samples: bool = False):
        samples = super().compute_stats_sampling(generator, return_samples=True)
        self.expectations["mode_weight"] = float(self.compute_mode_weight(samples))
        if return_samples:
            return samples


class TwoModes(_ModeWeightMixin, GMM):
    """p = (2/3) N(-a·1, C) + (1/3) N(+a·1, C) with a diagonal C of variance
    0.05 (``ill_conditioned`` 'not'), or 0.05·logspace(-1, 0, dim) ('medium')
    or 0.05·logspace(-2, 0, dim) ('hard') along the coordinates."""

    def __init__(self, dim: int = 2, a: float = 1.0, centered: bool = False,
                 ill_conditioned: str = "not", **kwargs):
        if ill_conditioned not in ("not", "medium", "hard"):
            raise ValueError(f"ill_conditioned must be 'not', 'medium' or 'hard', "
                             f"got {ill_conditioned!r}")
        loc = np.stack([-a * np.ones(dim), a * np.ones(dim)]).astype(np.float32)
        if centered:
            loc = loc + np.float32(a / 3.0)
        if ill_conditioned == "not":
            var = np.full(dim, 0.05)
        else:
            var = 0.05 * np.logspace(-1.0 if ill_conditioned == "medium" else -2.0, 0.0, dim)
        scale = np.repeat(np.sqrt(var.astype(np.float32))[None, :], 2, axis=0)
        super().__init__(dim=dim, loc=loc, scale=scale,
                         mixture_weights=np.array([2.0, 1.0], np.float32), **kwargs)


class TwoModesFull(_ModeWeightMixin, GMMFull):
    """Two modes weighted 2 : 1 at ∓a·1 with one covariance for both:
    0.05·logspace(-1, 0, dim) ('medium') or 0.05·logspace(-2, 0, dim)
    ('hard') on its diagonal, rotated by the Q of a QR decomposition drawn
    from numpy's ``default_rng(seed_q)``."""

    def __init__(self, dim: int = 2, a: float = 1.0, centered: bool = False,
                 ill_conditioned: str = "medium", rand_factor: float = 5.0,
                 seed_q: int = 42, **kwargs):
        if ill_conditioned not in ("medium", "hard"):
            raise ValueError(f"ill_conditioned must be 'medium' or 'hard', "
                             f"got {ill_conditioned!r}")
        loc = np.stack([-a * np.ones(dim), a * np.ones(dim)]).astype(np.float32)
        if centered:
            loc = loc + np.float32(a / 3.0)
        rng = np.random.default_rng(seed_q)
        q, _ = np.linalg.qr(rand_factor * rng.random((dim, dim)))
        lo = -1.0 if ill_conditioned == "medium" else -2.0
        cov = q @ np.diag(0.05 * np.logspace(lo, 0.0, dim)) @ q.T
        super().__init__(dim=dim, loc=loc, cov=np.stack([cov, cov.copy()]).astype(np.float32),
                         mixture_weights=np.array([2.0, 1.0], np.float32), **kwargs)


class BracketTwoModes(_ModeWeightMixin, GMM):
    """Two modes at ∓a·1 with mirrored diagonal variances, linspace(var_min,
    var_max, dim) and its reverse, weighted 1 : 0.5 (or equally)."""

    def __init__(self, dim: int = 2, a: float = 0.75, equilibrated: bool = False,
                 var_min: float = 0.01, var_max: float = 0.2, **kwargs):
        loc = np.stack([-a * np.ones(dim), a * np.ones(dim)]).astype(np.float32)
        variance_diag = np.linspace(var_min, var_max, dim, dtype=np.float32)
        variances = np.stack([variance_diag, variance_diag[::-1]])
        weights = np.array([0.5, 0.5] if equilibrated else [1.0, 0.5], np.float32)
        super().__init__(dim=dim, loc=loc, scale=np.sqrt(variances),
                         mixture_weights=weights, **kwargs)


def many_modes_loc(n_modes: int, dim: int, seed_loc: int = 42) -> np.ndarray:
    """ManyModes' seeded mode centres, drawn exactly as the JAX package
    draws them (numpy ``default_rng(seed_loc)``)."""
    rng = np.random.default_rng(seed_loc)
    return 2 * n_modes * rng.random((n_modes, dim)) - n_modes


class ManyModes(GMM):
    """n_modes isotropic Gaussians at seeded random means."""

    def __init__(self, n_modes: int = 3, dim: int = 2, seed_loc: int = 42,
                 mixture_weight_factor: float = 3.0, var: float = 0.1, **kwargs):
        weights = np.logspace(0.0, 1.0, n_modes, base=mixture_weight_factor)
        loc = many_modes_loc(n_modes, dim, seed_loc)
        scale = math.sqrt(var) * np.ones((n_modes, dim))
        super().__init__(dim=dim, loc=loc.astype(np.float32),
                         scale=scale.astype(np.float32),
                         mixture_weights=weights.astype(np.float32), **kwargs)


class Gauss(GMM):
    """Single diagonal-covariance Gaussian."""

    def __init__(self, dim: int = 1, loc=0.0, scale=1.0, **kwargs):
        super().__init__(dim=dim, loc=_prepare_param(loc, dim),
                         scale=_prepare_param(scale, dim), **kwargs)
        self.stddevs = self.scale[0]

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return score_gauss(x, self.loc[0], self.scale[0] ** 2)


class GaussFull(Target):
    """Single full-covariance Gaussian, given its covariance or precision."""

    def __init__(self, dim: int = 1, loc=None, cov=None, prec=None,
                 n_reference_samples: int = int(1e6), domain_scale: float = 5.0,
                 domain=None, device=None):
        super().__init__(dim=dim, log_norm_const=0.0,
                         n_reference_samples=n_reference_samples, domain=domain,
                         device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        if cov is None and prec is None:
            raise ValueError("Either cov or prec must be set.")
        if cov is not None:
            cov = as_t(cov)
            prec = torch.linalg.inv(cov) if prec is None else as_t(prec)
        else:
            prec = as_t(prec)
            cov = torch.linalg.inv(prec)
        self.loc, self.cov, self.prec = as_t(loc), cov, prec
        self.cov_log_det = torch.linalg.slogdet(cov)[1]
        self.chol = torch.linalg.cholesky(cov)
        self.stddevs = torch.sqrt(torch.diagonal(cov))
        if self.domain is None:
            self.set_domain(torch.stack([self.loc - domain_scale * self.stddevs,
                                         self.loc + domain_scale * self.stddevs], dim=1))

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        diff = x.reshape(-1, self.dim) - self.loc
        lp = -0.5 * torch.sum(diff * (diff @ self.prec.T), dim=-1)
        lp = lp - 0.5 * self.dim * _LOG_2PI - 0.5 * self.cov_log_det
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return -(x - self.loc) @ self.prec.T

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        eps = torch.randn((*shape, self.dim), generator=generator, device=self.device)
        return self.loc + eps @ self.chol.T


class IsotropicGauss(Gauss):
    """Isotropic Gaussian prior. With ``truncate_quartile`` q its draws are
    truncated to the central 1 − q of its mass, coordinate by coordinate
    (the density stays the untruncated one's, as in the JAX package)."""

    def __init__(self, dim: int = 1, loc: float = 0.0, scale: float = 1.0,
                 truncate_quartile: float | None = None, **kwargs):
        super().__init__(dim=dim, loc=loc, scale=scale, **kwargs)
        self._loc0 = float(self.loc[0, 0])
        self._scale0 = float(self.scale[0, 0])
        if truncate_quartile is not None:
            dist = NormalDist(self._loc0, self._scale0)
            truncate_quartile = (dist.inv_cdf(truncate_quartile / 2),
                                 dist.inv_cdf(1 - truncate_quartile / 2))
        self.truncate_quartile = truncate_quartile

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = self._scale0**2
        norm_const = -0.5 * self.dim * math.log(2.0 * math.pi * var)
        sq = torch.sum((x - self._loc0) ** 2, dim=-1)
        return norm_const - 0.5 * sq / var

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return (self._loc0 - x) / self._scale0**2

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        if self.truncate_quartile is None:
            z = torch.randn((*shape, self.dim), generator=generator, device=self.device)
            return self._loc0 + self._scale0 * z
        # inverse-cdf draws between the standardized bounds
        std = NormalDist()
        lo, hi = ((b - self._loc0) / self._scale0 for b in self.truncate_quartile)
        c_lo, c_hi = std.cdf(lo), std.cdf(hi)
        u = torch.rand((*shape, self.dim), generator=generator, device=self.device,
                       dtype=torch.float64)
        z = torch.special.ndtri(c_lo + (c_hi - c_lo) * u).clamp(lo, hi).float()
        return self._loc0 + self._scale0 * z


def _prepare_param(param, dim: int) -> np.ndarray:
    if isinstance(param, Number):
        return np.full((1, dim), float(param), np.float32)
    if isinstance(param, torch.Tensor):
        param = param.detach().cpu().numpy()
    param = np.atleast_2d(np.asarray(param, np.float32))
    if param.size == 1:
        param = np.tile(param, (1, dim))
    return param
