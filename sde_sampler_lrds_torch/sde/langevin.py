"""Langevin-type SDEs, plain and along the tempering path, and an SDE plus a
control drift (counterpart of sde_sampler_lrds_tpu/sde/langevin.py). Each
carries a score callable, a constant diffusion coefficient and an optional
clip of the drift. ``drift`` takes states of any leading shape, with one
time or times that broadcast against them (per-step (K, 1, 1) against
(K, B, D))."""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.common import clip_norm, on_rows


class LangevinSDE:
    """dX = (g²/2)·∇log π(X) dt + g dW."""

    def __init__(self, target_score: Callable, diff_coeff: float = 1.0,
                 clip_score: float | None = None, terminal_t: float = 1.0):
        self.target_score = target_score
        self.diff_coeff = float(diff_coeff)
        self.clip_score = clip_score
        self.terminal_t = float(terminal_t)

    def drift(self, t, x):
        return clip_norm(on_rows(self.target_score, x) * self.diff_coeff**2 / 2.0,
                         self.clip_score)

    def diff(self, t, x=None):
        return torch.tensor(self.diff_coeff, dtype=torch.float32)


class ControlledLangevinSDE:
    """Langevin SDE along the geometric tempering path
    (t/T)·log π + (1 − t/T)·log p₀, CMCD's SDE."""

    def __init__(self, target_score: Callable, prior_score: Callable,
                 diff_coeff: float = 1.0, terminal_t: float = 1.0,
                 clip_score: float | None = None):
        self.target_score = target_score
        self.prior_score = prior_score
        self.diff_coeff = float(diff_coeff)
        self.terminal_t = float(terminal_t)
        self.clip_score = clip_score

    def drift(self, t, x):
        u = t / self.terminal_t
        drift = on_rows(self.target_score, x) * u + on_rows(self.prior_score, x) * (1.0 - u)
        return clip_norm(drift * (0.5 * self.diff_coeff**2), self.clip_score)

    def diff(self, t, x=None):
        return torch.tensor(self.diff_coeff, dtype=torch.float32)


class ControlledSDE:
    """A base SDE plus the drift correction g·ctrl(T − t, x)."""

    def __init__(self, sde, ctrl: Callable | None):
        self.sde = sde
        self.ctrl = ctrl
        self.terminal_t = sde.terminal_t

    def drift(self, t, x):
        d = self.sde.drift(t, x)
        if self.ctrl is not None:
            d = d + self.sde.diff(t, x) * self.ctrl(self.terminal_t - t, x)
        return d

    def diff(self, t, x=None):
        return self.sde.diff(t, x)
