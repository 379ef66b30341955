"""Gaussian mixtures, plain: the log-density and the score of a mixture
with diagonal or full covariances, and of its VP-noised marginal at time t
(means s·μ_c, covariances s²(Σ_c + σ² I)). A full covariance is handled
through its eigendecomposition Σ_c = P_c diag(e_c) P_cᵀ, given or taken
here in float64: noising keeps the eigenbasis."""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Mixture:
    """weights (C,), means (C, D), variances (C, D) diagonal, (C, D, D)
    full or their eigendecomposition (eig (C, D), P (C, D, D)), held in
    ``arith``'s dtype; ``arith`` (``precision.Arith``) does the
    full-covariance rotations."""

    def __init__(self, weights, means, variances, arith):
        self.arith, dt = arith, arith.dtype
        w = weights.double()
        self.log_w = torch.log(w / w.sum()).to(dt)
        self.means = means.to(dt)
        self.full = isinstance(variances, tuple) or variances.ndim == 3
        if self.full:
            e, p = (variances if isinstance(variances, tuple)
                    else torch.linalg.eigh(variances.double()))
            self.eig, self.p = e.to(dt), p.to(dt)
        else:
            self.var = variances.to(dt)

    def _terms(self, x, s, sig2):
        """(logits (B, C), per-component gradient terms g_c (B, C, D)) of the
        noised mixture: log p = logsumexp(logits), score = −Σ softmax·g."""
        d = x.shape[-1]
        m = s * self.means                                           # (C, D)
        if self.full:
            denom = s**2 * (self.eig + sig2)                         # (C, D)
            diff = x[:, None, :] - m[None]                           # (B, C, D)
            y = torch.stack([self.arith.mm(diff[:, c], self.p[c])
                             for c in range(m.shape[0])], dim=1)     # into each eigenbasis
            ys = y / denom
            g = torch.stack([self.arith.mm(ys[:, c], self.p[c].t())
                             for c in range(m.shape[0])], dim=1)
            quad = torch.sum(y * ys, dim=-1)
        else:
            denom = s**2 * (self.var + sig2)
            diff = x[:, None, :] - m[None]
            g = diff / denom
            quad = torch.sum(diff * g, dim=-1)
        logits = (self.log_w - 0.5 * d * _LOG_2PI - 0.5 * torch.sum(torch.log(denom), -1)
                  - 0.5 * quad)
        return logits, g

    def noised_score(self, x, s, sig2):
        logits, g = self._terms(x, s, sig2)
        return -torch.sum(torch.softmax(logits, dim=-1)[..., None] * g, dim=1)

    def log_prob(self, x):
        """log-density of the mixture itself (t = 0)."""
        logits, _ = self._terms(x, 1.0, 0.0)
        return torch.logsumexp(logits, dim=-1)
