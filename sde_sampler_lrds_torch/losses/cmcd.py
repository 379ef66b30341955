"""Discrete-time CMCD loss, Controlled Monte Carlo Diffusion (counterpart of
sde_sampler_lrds_tpu/losses/cmcd.py): an annealed Langevin forward kernel
corrected by a learned control, whose per-step cost evaluates the drift and
the control at both ends of the step,

  cost = (f(s, x) + f(t, y))/g + u(s, x) − u(t, y),
  rnd += ½‖cost‖²dt + cost·(ū − u)dt + cost·dB,

with initial cost log p₀(x) (eval and LV) and terminal −log ρ(x_T). The
volatility g is constant (the annealed-Langevin SDE).
"""
from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .base import BaseOCLoss, compute_results, flat_ctrl_eval
from .rds import _step_noise


class ControlledLangevinSDELoss(BaseOCLoss):
    def __init__(self, *args, use_rescaling: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_rescaling = use_rescaling

    def _rescale(self, u, sde_diff):
        return u if self.use_rescaling else u * (0.5 * sde_diff)

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 initial_log_prob=None, train: bool = True,
                 change_sde_ctrl: bool = False, return_traj: bool = False,
                 noise: torch.Tensor | None = None):
        sde_diff = self.sde.diff_coeff
        if train and self.method in ("kl", "kl_ito"):
            rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        else:
            rnd = initial_log_prob(x)
        dt_arr = ts[1:] - ts[:-1]
        sqdt_arr = torch.sqrt(dt_arr)
        traj = [x]
        for k in range(dt_arr.shape[0]):
            s, t, dt = ts[k], ts[k + 1], dt_arr[k]
            u_s = ctrl(s, x)
            sde_ctrl = self._sde_ctrl(u_s, generator, s, x) if change_sde_ctrl else u_s
            u_s = self._rescale(u_s, sde_diff)
            sde_ctrl = self._rescale(sde_ctrl, sde_diff)
            db = sqdt_arr[k] * _step_noise(noise, k, generator, x)
            drift_s = self.sde.drift(s, x)
            y = x + (drift_s + sde_ctrl * sde_diff) * dt + sde_diff * db
            drift_t = self.sde.drift(t, y)
            u_t = self._rescale(ctrl(t, y), sde_diff)
            cost = (drift_s + drift_t) / sde_diff + u_s - u_t
            rnd = rnd + 0.5 * torch.sum(cost**2, dim=-1) * dt
            rnd = rnd + torch.sum(cost * (sde_ctrl - u_s), dim=-1) * dt
            rnd = rnd + torch.sum(cost * db, dim=-1)
            x = y
            if return_traj:
                traj.append(x)
        rnd = rnd - terminal_unnorm_log_prob(x)
        return x, rnd, (torch.stack(traj) if return_traj else None)

    def __call__(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 initial_log_prob=None, noise=None):
        x = self.repeat_traj(x)
        samples, rnd, _ = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob,
            initial_log_prob=initial_log_prob, train=True,
            change_sde_ctrl=self.is_lv, noise=noise)
        return self.reduce(rnd, samples=samples)

    # -- flat LV training path ---------------------------------------------
    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        return call_args == frozenset({"terminal_unnorm_log_prob", "initial_log_prob"})

    def flat_states(self, ts, x, ctrl, zs, terminal_unnorm_log_prob, initial_log_prob=None):
        """The flat LV path's simulation by the loss's own loop: the
        pre-step states (K, B, D) and x_T under the fed noise ``zs``."""
        x_t, _, xs_all = self.simulate(None, ts, x, ctrl, terminal_unnorm_log_prob,
                                       initial_log_prob=initial_log_prob, train=True,
                                       change_sde_ctrl=True, return_traj=True, noise=zs)
        return xs_all[:-1], x_t

    def lv_flat_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     initial_log_prob=None, traj_fn=None, noise=None):
        """LV training as gradient-free simulation plus one batched control
        evaluation over the K+1 states x_0..x_T: CMCD's cost reads the
        control at both ends of each step, so the flat pass evaluates it
        once a state where the loop evaluates it twice. The simulation is
        the loss's own loop, or ``traj_fn(x0, zs) -> (xs, x_T)`` when given
        (the solver's graph of ``flat_states``; the fused trajectory does
        not cover the Langevin step)."""
        x, zs = self._flat_lv_setup(generator, ts, x, noise=noise)
        with torch.no_grad(), annotate("lrds.step.simulate"):
            xs, x_t = (traj_fn(x, zs) if traj_fn is not None else self.flat_states(
                ts, x, ctrl, zs, terminal_unnorm_log_prob, initial_log_prob))
            xs_all = torch.cat([xs, x_t[None]])
        with annotate("lrds.step.ctrl_eval"):
            sde_diff = self.sde.diff_coeff
            dt = (ts[1:] - ts[:-1])[:, None]                          # (K, 1)
            db = torch.sqrt(dt)[..., None] * zs                       # (K, B, D)
            u_all = self._rescale(flat_ctrl_eval(ctrl, ts, xs_all), sde_diff)
            drift_all = self.sde.drift(ts[:, None, None], xs_all)      # (K+1, B, D)
            u_s, u_t = u_all[:-1], u_all[1:]
            cost = (drift_all[:-1] + drift_all[1:]) / sde_diff + u_s - u_t
            u_bar = u_s.detach()
            steps = (0.5 * torch.sum(cost**2, dim=-1) * dt
                     + torch.sum(cost * (u_bar - u_s), dim=-1) * dt
                     + torch.sum(cost * db, dim=-1))                  # (K, B)
            rnd = (initial_log_prob(xs_all[0]) + torch.sum(steps, dim=0)
                   - terminal_unnorm_log_prob(xs_all[-1]))
            return self.reduce(rnd, samples=xs_all[-1])

    @torch.no_grad()
    def eval(self, generator, ts, x, ctrl, terminal_unnorm_log_prob, initial_log_prob=None,
             compute_weights: bool = True, return_traj: bool = True, noise=None):
        samples, rnd, xs = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob,
            initial_log_prob=initial_log_prob, train=False, return_traj=return_traj,
            noise=noise)
        return compute_results(rnd, compute_weights=compute_weights, ts=ts,
                               max_rnd=self.max_rnd, samples=samples, xs=xs)

    @torch.no_grad()
    def compute_eubo(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     initial_log_prob=None, noise=None):
        """The reverse pass from target samples ``x``; the drift at the
        step's new state is read at time t, as the JAX package and its
        reference do."""
        sde_diff = self.sde.diff_coeff
        times_s, times_t = torch.flip(ts[:-1], (0,)), torch.flip(ts[1:], (0,))
        dt_arr = times_t - times_s
        sqdt_arr = torch.sqrt(dt_arr)
        rnd = -terminal_unnorm_log_prob(x)
        for k in range(dt_arr.shape[0]):
            s, t, dt = times_s[k], times_t[k], dt_arr[k]
            u_t = self._rescale(ctrl(t, x), sde_diff)
            db = sqdt_arr[k] * _step_noise(noise, k, generator, x)
            drift_t = self.sde.drift(t, x)
            y = x + (drift_t - u_t * sde_diff) * dt + sde_diff * db
            drift_s = self.sde.drift(t, y)
            u_s = self._rescale(ctrl(s, y), sde_diff)
            cost = (drift_s + drift_t) / sde_diff + u_s - u_t
            rnd = rnd - 0.5 * torch.sum(cost**2, dim=-1) * dt - torch.sum(cost * db, dim=-1)
            x = y
        return rnd + initial_log_prob(x)
