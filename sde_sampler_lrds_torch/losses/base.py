"""Shared machinery for the variational trajectory losses (counterpart of
sde_sampler_lrds_tpu/losses/base.py). KL vs LV is a ``detach`` placement on
the simulated ("sde") control; masked reductions replace boolean indexing.

A control is a callable ``ctrl(t, x) -> u`` — here the nn.Module itself.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.common import Results, masked_mean, masked_var


def flat_ctrl_eval(ctrl: Callable, t_grid: torch.Tensor, xs: torch.Tensor,
                   max_flat: int = 4_000_000) -> torch.Tensor:
    """Batched control evaluation over per-step states for the flat LV
    path: u[k] = ctrl(t_grid[k], xs[k]) for xs (K, B, ...), as one call with
    per-step times (K, 1) broadcast against the (K, B) batch. Past
    ``max_flat`` state elements the time axis goes in chunks of 16 steps,
    each checkpointed when autograd records it, so the backward pass stores
    only the chunks' outputs and recomputes their activations."""
    if xs.numel() <= max_flat:
        return ctrl(t_grid[:, None], xs)

    def chunk(t, x):
        return ctrl(t[:, None], x)

    out = []
    for t, x in zip(torch.split(t_grid, 16), torch.split(xs, 16)):
        out.append(checkpoint(chunk, t, x, use_reentrant=False)
                   if torch.is_grad_enabled() else chunk(t, x))
    return torch.cat(out)


def compute_results(rnd: torch.Tensor, compute_weights: bool = False,
                    ts=None, samples=None, xs=None,
                    max_rnd: float | None = None) -> Results:
    """Metrics from the density log-ratio: elbo = E[-rnd]; IS weights =
    softmax(-rnd); log_norm_const_is = logsumexp(-rnd) - log N. With
    ``max_rnd``, the ``_filtered`` variants also report the bound over
    trajectories with finite rnd < max_rnd."""
    neg = -rnd
    metrics = {"eval/elbo": float(neg.mean())}
    if max_rnd is not None:
        keep = torch.isfinite(rnd) & (rnd < max_rnd)
        n_keep = torch.clamp(keep.sum(), min=1)
        neg_safe = torch.where(keep, neg, torch.zeros_like(neg))
        metrics["eval/elbo_filtered"] = float(
            neg_safe.sum() / n_keep if bool(keep.any()) else math.nan)
        metrics["eval/filtered_frac"] = float(1.0 - keep.sum() / rnd.shape[0])
        metrics["eval/log_norm_const_is_filtered"] = float(
            torch.logsumexp(torch.where(keep, neg, torch.full_like(neg, -math.inf)), 0)
            - torch.log(n_keep.to(neg.dtype)))
    log_norm_const_preds = {}
    weights = None
    if compute_weights:
        weights = torch.softmax(neg, dim=0)
        log_norm_const_preds["log_norm_const_is"] = float(
            torch.logsumexp(neg, 0) - math.log(neg.shape[0]))
        metrics["eval/lv_loss"] = float(rnd.var(correction=1))
    return Results(samples=samples, weights=weights, rnd=rnd,
                   log_norm_const_preds=log_norm_const_preds,
                   ts=ts, xs=xs, metrics=metrics)


class BaseOCLoss:
    """Config + reduction shared by all trajectory losses, and the
    exploration hooks of the detached simulation control (``sde_ctrl_noise``,
    ``sde_ctrl_dropout``)."""

    def __init__(self, sde=None, method: str = "kl", traj_per_sample: int = 1,
                 filter_samples: Callable | None = None,
                 max_rnd: float | None = None, sde_ctrl_noise: float | None = None,
                 sde_ctrl_dropout: float | None = None):
        if method not in ("kl", "kl_ito", "lv", "lv_traj"):
            raise ValueError("Unknown loss method.")
        if traj_per_sample == 1 and method == "lv_traj":
            raise ValueError("Cannot compute variance over a single trajectory.")
        self.sde = sde
        self.method = method
        self.traj_per_sample = traj_per_sample
        self.filter_samples = filter_samples
        self.max_rnd = max_rnd
        self.sde_ctrl_noise = sde_ctrl_noise
        self.sde_ctrl_dropout = sde_ctrl_dropout

    @property
    def is_lv(self) -> bool:
        return self.method in ("lv", "lv_traj")

    def _sde_ctrl(self, u: torch.Tensor, generator, t, x, noise=None,
                  uniform=None) -> torch.Tensor:
        """The detached simulation control of the log-variance loss, with the
        optional exploration hooks: Gaussian noise of scale
        ``sde_ctrl_noise`` added, and each entry replaced with probability
        ``sde_ctrl_dropout`` by −drift/diff of the SDE. Their draws come
        from ``generator`` unless fed as ``noise`` and ``uniform``."""
        sde_ctrl = u.detach()
        if self.sde_ctrl_noise is not None:
            if noise is None:
                noise = torch.randn(u.shape, generator=generator, device=u.device)
            sde_ctrl = sde_ctrl + self.sde_ctrl_noise * noise
        if self.sde_ctrl_dropout is not None:
            if uniform is None:
                uniform = torch.rand(u.shape, generator=generator, device=u.device)
            replacement = -(self.sde.drift(t, x) / self.sde.diff(t, x))
            sde_ctrl = torch.where(uniform > self.sde_ctrl_dropout,
                                   torch.broadcast_to(replacement, u.shape).detach(), sde_ctrl)
        return sde_ctrl

    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        """Whether ``lv_flat_call`` covers this loss. Default: no."""
        return False

    def _flat_lv_setup(self, generator, ts, x, noise=None):
        """Shared lv_flat_call preamble: guard (plain LV only), trajectory
        repetition, and the per-step noise the detached simulation consumes
        (drawn from ``generator`` unless fed as ``noise``)."""
        if (not self.is_lv or self.sde_ctrl_noise is not None
                or self.sde_ctrl_dropout is not None):
            raise ValueError("lv_flat_call requires a plain LV loss "
                             "(no sde_ctrl noise/dropout hooks)")
        x = self.repeat_traj(x)
        if noise is None:
            noise = torch.randn((ts.shape[0] - 1, *x.shape), generator=generator,
                                device=x.device)
        return x, noise

    @staticmethod
    def _noising_states(generator, x, mean_f, std_f, noise=None):
        """Control-free reverse (noising) trajectory x_k = mf_k·x + sf_k·z_k
        from ``x``: the affine loop every EUBO pass shares. Returns the final
        state, the post-step states (K, B, D) and the noises that produced
        them (drawn from ``generator`` unless fed as ``noise``)."""
        zs = noise if noise is not None else torch.randn(
            (mean_f.shape[0], *x.shape), generator=generator, device=x.device)
        xs = []
        for mf, sf, z in zip(mean_f, std_f, zs):
            x = mf * x + sf * z
            xs.append(x)
        return x, torch.stack(xs), zs

    @staticmethod
    def running_cost(u: torch.Tensor, sde_ctrl: torch.Tensor, detached: bool) -> torch.Tensor:
        """Per-step quadratic cost summed over dims: KL = ½‖u‖²,
        LV = u·(ū − ½u) with ū the detached simulation control."""
        if detached:
            return torch.sum(u * (sde_ctrl - 0.5 * u), dim=-1)
        return 0.5 * torch.sum(u**2, dim=-1)

    # -- filtering + reduction --------------------------------------------
    def filter_mask(self, rnd: torch.Tensor, samples=None) -> torch.Tensor:
        mask = torch.ones_like(rnd, dtype=torch.bool)
        if samples is not None and self.filter_samples is not None:
            mask = mask & self.filter_samples(samples)
        if self.max_rnd is None:
            return mask & torch.isfinite(rnd)
        return mask & (rnd < self.max_rnd)

    def reduce(self, rnd: torch.Tensor, samples=None):
        """Masked mean (kl) / variance (lv) / per-sample trajectory variance
        (lv_traj) of the RND; the mask applies before the variance."""
        mask = self.filter_mask(rnd, samples=samples)
        n_filtered = torch.sum(~mask)
        if self.method == "lv_traj":
            r = rnd.reshape(self.traj_per_sample, -1)
            m = mask.reshape(self.traj_per_sample, -1).all(dim=0)
            loss = masked_mean(r.var(dim=0, correction=1), m)
        elif self.method == "lv":
            loss = masked_var(rnd, mask)
        else:
            loss = masked_mean(rnd, mask)
        return loss, {"train/n_filtered": n_filtered}

    def repeat_traj(self, x: torch.Tensor) -> torch.Tensor:
        if self.traj_per_sample != 1:
            return x.repeat(self.traj_per_sample, 1)
        return x
