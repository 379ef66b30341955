"""Bayesian logistic-regression posteriors over four UCI datasets
(counterpart of sde_sampler_lrds_tpu/targets/logistic_regression.py). The
posterior is p(θ|X,y) ∝ N(w; 0, s_w²I) N(b; μ_b, s_b²) Π σ(Xw+b)^y
(1-σ)^{1-y}, with an analytic score. The data are the repository's
data/{cancer,credit,ionosphere,sonar}.npz. No sampler exists: the sample
losses, and the SMC / replica-exchange cells, stop at ``sample`` (ROADMAP
C5)."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .base import Target

DATA_DIR = Path(__file__).parents[2] / "data"


class LogisticRegression(Target):
    def __init__(self, dim: int | None = None, data_type: str = "ionosphere",
                 use_intercept: bool = True, intercept_mean: float = 0.0,
                 intercept_scale: float = 2.5, weight_scale: float = 1.0,
                 threshold: float = 1e-8, domain=5.0, device=None, **kwargs):
        with np.load(DATA_DIR / f"{data_type}.npz") as data:
            arrays = {k: np.asarray(data[k], np.float32) for k in
                      ("X_train", "y_train", "X_test", "y_test")}
        super().__init__(dim=arrays["X_train"].shape[-1] + int(use_intercept), domain=domain,
                         device=device, **kwargs)
        as_t = lambda a: torch.as_tensor(a, device=self.device)
        self.X_train, self.X_test = as_t(arrays["X_train"]), as_t(arrays["X_test"])
        self.y_train = as_t(arrays["y_train"]).flatten()
        self.y_test = as_t(arrays["y_test"]).flatten()
        self.threshold = threshold
        self.use_intercept = use_intercept
        self.weight_scale = weight_scale
        self.intercept_mean = intercept_mean
        self.intercept_scale = intercept_scale

    def _split(self, params: torch.Tensor):
        params = params.reshape(-1, params.shape[-1])
        if self.use_intercept:
            return params[..., :-1], params[..., -1]
        return params, torch.zeros(params.shape[:-1], device=params.device)

    def posterior_log_prob(self, params, X, y) -> torch.Tensor:
        weights, intercept = self._split(params)
        dw = weights.shape[-1]
        prior = -0.5 * torch.sum(weights**2, dim=-1) / self.weight_scale**2
        prior = prior - 0.5 * dw * math.log(2 * math.pi * self.weight_scale**2)
        if self.use_intercept:
            prior = prior - 0.5 * (intercept - self.intercept_mean) ** 2 / self.intercept_scale**2
            prior = prior - 0.5 * math.log(2 * math.pi * self.intercept_scale**2)
        logits = weights @ X.T + intercept[:, None]  # (B, N)
        # clipping probabilities to [threshold, 1 − threshold] gives 0·log 0
        # in float32 (1 − 1e-8 rounds to 1); the log terms are floored at
        # log(threshold) instead, on log-sigmoids that never overflow
        log_thr = math.log(self.threshold)
        log_p = torch.clamp(F.logsigmoid(logits), min=log_thr)
        log_1mp = torch.clamp(F.logsigmoid(-logits), min=log_thr)
        ll = torch.sum(y[None] * log_p + (1 - y[None]) * log_1mp, dim=-1)
        return ll + prior

    def posterior_score(self, params, X, y) -> torch.Tensor:
        weights, intercept = self._split(params)
        prior_w = -weights / self.weight_scale**2
        probs = torch.clamp(torch.sigmoid(weights @ X.T + intercept[:, None]),
                            self.threshold, 1.0 - self.threshold)
        resid = y[None] - probs  # (B, N)
        score_w = prior_w + resid @ X
        if self.use_intercept:
            prior_b = -(intercept - self.intercept_mean) / self.intercept_scale**2
            score_b = prior_b + resid.sum(dim=-1)
            return torch.cat([score_w, score_b[:, None]], dim=-1)
        return score_w

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        lp = self.posterior_log_prob(torch.atleast_2d(x), self.X_train, self.y_train)
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return self.posterior_score(x, self.X_train, self.y_train)

    def compute_predictive_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Mean test-set posterior log-density of the samples."""
        return self.posterior_log_prob(x, self.X_test, self.y_test).mean()
