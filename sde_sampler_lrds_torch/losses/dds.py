"""Original DDS loss, Vargas et al.'s exponential-integrator update
(counterpart of sde_sampler_lrds_tpu/losses/dds.py):

  β_k = clip(α√dt, 0, 1), α_k = √(1 − β_k²),
  x ← α_k x + β_k²σ² ū + σβ_k ε,
  rnd += β_k²σ²·cost + σβ_k u·ε (the Itô term with ``compute_ito_int``),

with terminal cost log p_ref(x_T) − log ρ(x_T), the Gaussian prior being the
reference. The control runs on the forward clock (t = s).
"""
from __future__ import annotations

import torch

from .base import BaseOCLoss, compute_results, flat_ctrl_eval
from .rds import _step_noise


class ExponentialIntegratorSDELoss(BaseOCLoss):
    def __init__(self, *args, alpha: float, sigma: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = float(alpha)
        self.sigma = float(sigma)

    def _beta(self, ts):
        return torch.clamp(self.alpha * torch.sqrt(ts[1:] - ts[:-1]), 0.0, 1.0)

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 reference_log_prob, compute_ito_int: bool = False,
                 change_sde_ctrl: bool = False, return_traj: bool = False,
                 noise: torch.Tensor | None = None):
        """(x_T, rnd, xs or None); ``noise`` (K, B, D) replaces the draws."""
        s_arr = ts[:-1]
        beta = self._beta(ts)
        alpha_k = torch.sqrt(1.0 - beta**2)
        sig2 = self.sigma**2
        rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        traj = [x]
        for k in range(s_arr.shape[0]):
            u = ctrl(s_arr[k], x)
            sde_ctrl = self._sde_ctrl(u, generator, s_arr[k], x) if change_sde_ctrl else u
            rnd = rnd + beta[k]**2 * sig2 * self.running_cost(u, sde_ctrl, change_sde_ctrl)
            eps = _step_noise(noise, k, generator, x)
            x = x * alpha_k[k] + beta[k]**2 * sig2 * sde_ctrl + self.sigma * beta[k] * eps
            if compute_ito_int:
                rnd = rnd + self.sigma * beta[k] * torch.sum(u * eps, dim=-1)
            if return_traj:
                traj.append(x)
        rnd = rnd + reference_log_prob(x) - terminal_unnorm_log_prob(x)
        return x, rnd, (torch.stack(traj) if return_traj else None)

    def __call__(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 reference_log_prob, noise=None):
        x = self.repeat_traj(x)
        samples, rnd, _ = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob, reference_log_prob,
            compute_ito_int=self.method != "kl", change_sde_ctrl=self.is_lv,
            noise=noise)
        return self.reduce(rnd, samples=samples)

    # -- flat LV training path (see losses/rds.py lv_flat_call) ------------
    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        return call_args == frozenset({"terminal_unnorm_log_prob", "reference_log_prob"})

    def flat_states(self, ts, x, ctrl, zs, terminal_unnorm_log_prob, reference_log_prob):
        """The flat LV path's simulation by the loss's own loop: the
        pre-step states (K, B, D) and x_T under the fed noise ``zs``."""
        x_t, _, xs_all = self.simulate(None, ts, x, ctrl, terminal_unnorm_log_prob,
                                       reference_log_prob, change_sde_ctrl=True,
                                       return_traj=True, noise=zs)
        return xs_all[:-1], x_t

    def lv_flat_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     reference_log_prob, traj_fn=None, noise=None):
        """LV training as gradient-free simulation (``traj_fn(x0, zs) ->
        (xs, x_T)`` when given: the fused trajectory, or the solver's graph of
        ``flat_states``) plus one batched control evaluation carrying the
        cost β²σ²·u·(ū − ½u) + σβ·u·ε."""
        x, zs = self._flat_lv_setup(generator, ts, x, noise=noise)
        with torch.no_grad():
            xs, x_t = (traj_fn(x, zs) if traj_fn is not None else self.flat_states(
                ts, x, ctrl, zs, terminal_unnorm_log_prob, reference_log_prob))
        beta = self._beta(ts)[:, None]                                # (K, 1)
        u = flat_ctrl_eval(ctrl, ts[:-1], xs)                         # (K, B, D)
        u_bar = u.detach()
        steps = (beta**2 * self.sigma**2 * torch.sum(u * (u_bar - 0.5 * u), dim=-1)
                 + self.sigma * beta * torch.sum(u * zs, dim=-1))
        rnd = torch.sum(steps, dim=0) + reference_log_prob(x_t) - terminal_unnorm_log_prob(x_t)
        return self.reduce(rnd, samples=x_t)

    # -- fused KL training path (see losses/rds.py kl_fused_call) ----------
    @property
    def fused_train_ito(self) -> bool:
        """The Itô toggle of the training plan: ``__call__`` trains with
        compute_ito_int = (method != 'kl')."""
        return self.method != "kl"

    def supports_fused_kl(self, ts, call_args: frozenset) -> bool:
        return (self.method in ("kl", "kl_ito")
                and call_args == frozenset({"terminal_unnorm_log_prob", "reference_log_prob"}))

    def kl_fused_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                      reference_log_prob, traj_rnd_fn, noise=None):
        """KL training through the differentiable fused trajectory; the
        plan's c_dot carries the Itô toggle (``fused_train_ito``)."""
        del ctrl
        x = self.repeat_traj(x)
        zs = noise if noise is not None else torch.randn(
            (ts.shape[0] - 1, *x.shape), generator=generator, device=x.device)
        x_t, rnd = traj_rnd_fn(x, zs)
        rnd = rnd + reference_log_prob(x_t) - terminal_unnorm_log_prob(x_t)
        return self.reduce(rnd, samples=x_t)

    @torch.no_grad()
    def eval(self, generator, ts, x, ctrl, terminal_unnorm_log_prob, reference_log_prob,
             compute_weights: bool = True, return_traj: bool = True, noise=None):
        samples, rnd, xs = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob, reference_log_prob,
            compute_ito_int=compute_weights, change_sde_ctrl=False,
            return_traj=return_traj, noise=noise)
        return compute_results(rnd, compute_weights=compute_weights, ts=ts,
                               max_rnd=self.max_rnd, samples=samples, xs=xs)
