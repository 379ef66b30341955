"""EM for diagonal or full-covariance Gaussian mixtures on the device
(counterpart of sde_sampler_lrds_tpu/utils/gmm_fit.py). Semantics follow
sklearn: greedy k-means++ seeding (or ``means_init``), ``reg_covar`` added to
the variances (the covariance diagonals), convergence when the mean
log-likelihood changes by less than ``tol`` between iterations."""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _component_log_prob_diag(x, means, variances):
    """x (B, D), means/variances (K, D) -> (B, K)."""
    diff = x[:, None, :] - means[None]
    lp = -0.5 * torch.sum(diff**2 / variances[None], dim=-1)
    lp = lp - 0.5 * torch.sum(torch.log(variances), dim=-1)[None]
    return lp - 0.5 * x.shape[-1] * _LOG_2PI


def _component_log_prob_full(x, means, chols):
    """x (B, D), means (K, D), chols (K, D, D) lower -> (B, K). Each D x D
    Cholesky factor is inverted once; the per-sample work is one batched
    (B, K, D) x (K, D, D) contraction."""
    d = x.shape[-1]
    eye = torch.eye(d, device=x.device).expand_as(chols)
    inv_l = torch.linalg.solve_triangular(chols, eye, upper=False)    # (K, D, D)
    y = torch.einsum("ked,bkd->bke", inv_l, x[:, None, :] - means[None])
    quad = torch.sum(y * y, dim=-1)
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + log_det[None] + d * _LOG_2PI)


def _cholesky_or_nan(covs):
    """Lower Cholesky factors; a factor that fails is all NaN, so the fit
    goes non-finite (as the JAX package's does) instead of raising."""
    chols, info = torch.linalg.cholesky_ex(covs)
    return torch.where((info == 0)[:, None, None], chols, torch.full_like(chols, math.nan))


@torch.no_grad()
def _em_fit(x, init_means, n_components: int, em_type: str, max_iter: int,
            tol: float, reg_covar: float):
    n, d = x.shape
    k = n_components
    var0 = x.var(dim=0, correction=0) + reg_covar
    weights = torch.full((k,), 1.0 / k, device=x.device)
    means = init_means
    if em_type == "full":
        covs = torch.diag(var0)[None].expand(k, d, d)
    else:
        covs = var0[None].expand(k, d)
    prev_ll, ll, it = -math.inf, math.inf, 0
    # one E-step per iteration; stop on the change of the E-step mean
    # log-likelihood between successive iterations (sklearn's lower_bound)
    while it < max_iter and abs(ll - prev_ll) > tol:
        if em_type == "full":
            lp = _component_log_prob_full(x, means, _cholesky_or_nan(covs))
        else:
            lp = _component_log_prob_diag(x, means, covs)
        lw = lp + torch.log(weights)[None]
        norm = torch.logsumexp(lw, dim=-1, keepdim=True)
        resp = torch.exp(lw - norm)
        prev_ll, ll = ll, float(norm.mean())
        nk = resp.sum(dim=0) + 1e-10
        means = (resp.T @ x) / nk[:, None]
        diff = x[:, None, :] - means[None]                          # (B, K, D)
        if em_type == "full":
            # Σ_b r_bk diff_bk diff_bkᵀ as one batched product per component
            covs = torch.einsum("bki,bkj->kij", resp[..., None] * diff, diff) / nk[:, None, None]
            covs = covs + reg_covar * torch.eye(d, device=x.device)[None]
        else:
            covs = torch.einsum("bk,bkd->kd", resp, diff**2) / nk[:, None] + reg_covar
        weights = nk / n
        it += 1
    return weights, means, covs, ll, it


def fit_gmm_em(n_components: int, dataset, means_init=None, em_type: str = "diag",
               max_iter: int = 1000, tol: float = 1e-3, reg_covar: float = 1e-6,
               generator: torch.Generator | None = None):
    """Fit a GMM by EM on ``dataset``'s device: ``em_type`` 'diag' gives
    (K, D) variances, 'full' (K, D, D) covariances. Returns (weights, means,
    variances, mean log-likelihood). ``means_init`` defaults to
    k-means++-style seeding drawn from ``generator``."""
    if em_type not in ("diag", "full"):
        raise ValueError(f"em_type must be 'diag' or 'full', got {em_type!r}")
    x = torch.as_tensor(dataset, dtype=torch.float32)
    x = x.reshape(-1, x.shape[-1])
    if means_init is None:
        if generator is None:
            generator = torch.Generator(x.device).manual_seed(0)
        init_means = kmeans_plus_plus(x, n_components, generator)
    else:
        init_means = torch.as_tensor(means_init, dtype=torch.float32, device=x.device)
    w, m, v, ll, _ = _em_fit(x, init_means, n_components, em_type, max_iter, tol,
                             reg_covar)
    return w, m, v, ll


@torch.no_grad()
def kmeans_plus_plus(x: torch.Tensor, n_components: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding, sklearn's: each next centre is the best, by
    total squared distance, of 2 + ⌊ln k⌋ candidates drawn ∝ d². (The JAX
    package draws a single candidate, which on the demo's 4-mode dataset
    merges two modes into one component for some seeds.)"""
    n_trials = 2 + int(math.log(n_components))
    first = torch.randint(0, x.shape[0], (1,), generator=generator, device=x.device)
    centres = [x[first[0]]]
    d2 = torch.sum((x - centres[0]) ** 2, dim=-1)
    for _ in range(1, n_components):
        cand = torch.multinomial(d2 / d2.sum(), n_trials, replacement=True,
                                 generator=generator)
        cand_d2 = torch.minimum(d2[None], torch.sum((x[None] - x[cand][:, None]) ** 2, dim=-1))
        best = torch.argmin(cand_d2.sum(dim=1))
        centres.append(x[cand[best]])
        d2 = cand_d2[best]
    return torch.stack(centres)
