"""The unlearned ULA baseline (counterpart of
sde_sampler_lrds_tpu/solvers/langevin.py): integrate the Langevin SDE from
the prior by Euler–Maruyama, drop a burn-in prefix of the trajectory and
predict the expectations from the pooled states after it."""
from __future__ import annotations

import time

import torch

from ..sde.integrator import integrate_sde
from ..sde.langevin import LangevinSDE
from ..targets.base import EXPECTATION_FNS
from ..utils.common import Results


class LangevinSolver:
    """ULA chains on ``eval_ts`` from ``eval_batch_size`` prior draws; the
    SDE is ``LangevinSDE(target.score, diff_coeff, clip_score)`` unless one
    is given."""

    def __init__(self, target, prior, sde: LangevinSDE | None = None, eval_ts=None,
                 eval_batch_size: int = 6000, burn_steps: int = 0, diff_coeff: float = 1.0,
                 clip_score: float | None = None):
        self.target = target
        self.prior = prior
        self.sde = sde if sde is not None else LangevinSDE(
            target_score=target.score, diff_coeff=diff_coeff, clip_score=clip_score)
        self.eval_ts = eval_ts
        self.eval_batch_size = eval_batch_size
        if burn_steps >= len(eval_ts):
            raise ValueError("Specify more eval_steps than burn_steps.")
        self.burn_steps = burn_steps

    def run(self, generator: torch.Generator, x_init: torch.Tensor | None = None,
            noise: torch.Tensor | None = None) -> Results:
        """One pass: the trajectory (K+1, B, D) under ``xs``, its last states
        as ``samples``, and the expectations of the states after the burn-in.
        ``x_init`` (B, D) and ``noise`` (K, B, D) replace the prior draws and
        the Brownian draws when fed. ``eval/sample_time`` is host seconds
        up to the trajectory's end on its device."""
        start = time.time()
        x = x_init if x_init is not None else self.prior.sample(
            generator, (self.eval_batch_size,))
        xs = integrate_sde(self.sde, generator, self.eval_ts, x, return_traj=True,
                           noise=noise)
        if xs.is_cuda:
            torch.cuda.synchronize(xs.device)
        metrics = {"eval/sample_time": time.time() - start}
        pooled = xs[self.burn_steps:].reshape(-1, self.target.dim)
        expectation_preds = {name: float(fn(pooled).mean())
                             for name, fn in EXPECTATION_FNS.items()}
        return Results(samples=xs[-1], weights=None, ts=self.eval_ts, xs=xs,
                       metrics=metrics, expectation_preds=expectation_preds)
