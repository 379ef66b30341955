"""Time-reversal (DIS) losses: the discrete-time EI variant and the original
continuous-time variant with an optional learned inference control
(counterpart of sde_sampler_lrds_tpu/losses/dis.py). The generative control
approximates the full score ∇log p_t, not a reference-relative one:

  discrete DIS: EI kernel with ω weights, initial cost log p₀(x) (eval and
      LV) and terminal −log ρ; the control runs on the clock T − s.
  original DIS: EM in forward time on the generative process's own clock,
      an optional inference control whose divergence enters by an exact or
      Hutchinson estimate (``div_estimator``), and the eval-only integral of
      the drift's divergence.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.autograd import compute_divx
from .base import BaseOCLoss, compute_results, flat_ctrl_eval
from .rds import _step_noise


class DiscreteTimeReversalLossEI(BaseOCLoss):
    """Discrete-time DIS with the exponential integrator."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_rescaling = False

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 initial_log_prob=None, train: bool = True,
                 change_sde_ctrl: bool = False, return_traj: bool = False,
                 noise: torch.Tensor | None = None):
        s_arr, t_arr = ts[:-1], ts[1:]
        t_ctrl = ts[-1] - s_arr
        omega = self.sde.omega(s_arr, t_arr)
        sq_omega = torch.sqrt(omega)
        a_x, a_s, a_z = self.sde.ei_step_coeffs(s_arr, t_arr)
        if train and self.method in ("kl", "kl_ito"):
            rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        else:
            rnd = initial_log_prob(x)
        traj = [x]
        for k in range(s_arr.shape[0]):
            tc = t_ctrl[k]
            u = ctrl(tc, x)
            sde_ctrl = self._sde_ctrl(u, generator, tc, x) if change_sde_ctrl else u
            rnd = rnd + omega[k] * self.running_cost(u, sde_ctrl, change_sde_ctrl)
            z = _step_noise(noise, k, generator, x)
            x = a_x[k] * x + a_s[k] * sde_ctrl + a_z[k] * z
            rnd = rnd + sq_omega[k] * torch.sum(u * z, dim=-1)
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

    # -- flat LV training path (see losses/rds.py lv_flat_call) ------------
    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        # LV starts from rnd₀ = initial_log_prob(x₀): both log-probs are wired
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
        """LV training as gradient-free simulation (``traj_fn(x0, zs) ->
        (xs, x_T)`` when given: the fused trajectory, or the solver's graph of
        ``flat_states``) plus one batched control evaluation carrying the
        cost ω·u·(ū − ½u) + √ω·u·z."""
        x, zs = self._flat_lv_setup(generator, ts, x, noise=noise)
        with torch.no_grad():
            xs, x_t = (traj_fn(x, zs) if traj_fn is not None else self.flat_states(
                ts, x, ctrl, zs, terminal_unnorm_log_prob, initial_log_prob))
        omega = self.sde.omega(ts[:-1], ts[1:])[:, None]              # (K, 1)
        u = flat_ctrl_eval(ctrl, ts[-1] - ts[:-1], xs)                # (K, B, D)
        u_bar = u.detach()
        steps = (omega * torch.sum(u * (u_bar - 0.5 * u), dim=-1)
                 + torch.sqrt(omega) * torch.sum(u * zs, dim=-1))      # (K, B)
        rnd = initial_log_prob(x) + torch.sum(steps, dim=0) - terminal_unnorm_log_prob(x_t)
        return self.reduce(rnd, samples=x_t)

    # -- fused KL training path (see losses/rds.py kl_fused_call) ----------
    def supports_fused_kl(self, ts, call_args: frozenset) -> bool:
        return (self.method in ("kl", "kl_ito")
                and call_args == frozenset({"terminal_unnorm_log_prob", "initial_log_prob"}))

    def kl_fused_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                      initial_log_prob=None, traj_rnd_fn=None, noise=None):
        """KL training through the differentiable fused trajectory. KL
        training starts from rnd₀ = 0: ``initial_log_prob`` is a boundary
        term of the evaluation only."""
        del ctrl, initial_log_prob
        x = self.repeat_traj(x)
        zs = noise if noise is not None else torch.randn(
            (ts.shape[0] - 1, *x.shape), generator=generator, device=x.device)
        x_t, rnd = traj_rnd_fn(x, zs)
        return self.reduce(rnd - terminal_unnorm_log_prob(x_t), samples=x_t)

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
        """The reverse (noising) pass from target samples ``x``: control-free,
        so the K control evaluations run as one flat batched pass."""
        T = ts[-1]
        times_s, times_t = torch.flip(ts[:-1], (0,)), torch.flip(ts[1:], (0,))
        mean_f, var_f = self.sde.transition_params(T - times_t, T - times_s)
        omega = self.sde.omega(times_s, times_t)[:, None]             # (K, 1)
        x_0, xs, zs = self._noising_states(generator, x, mean_f, torch.sqrt(var_f),
                                           noise=noise)
        u = flat_ctrl_eval(ctrl, T - times_s, xs)                     # (K, B, D)
        steps = (-0.5 * torch.sum(u**2, dim=-1) * omega
                 - torch.sum(u * zs, dim=-1) * torch.sqrt(omega))
        return -terminal_unnorm_log_prob(x) + torch.sum(steps, dim=0) + initial_log_prob(x_0)


class TimeReversalLoss(BaseOCLoss):
    """Original DIS loss, optionally with a learned inference control and
    its divergence (GBS / Bridge)."""

    def __init__(self, *args, inference_ctrl: Callable | None = None,
                 div_estimator: str | None = None, use_rescaling: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if not use_rescaling:
            raise ValueError("use_rescaling must be True for TimeReversalLoss.")
        self.inference_ctrl = inference_ctrl
        self.div_estimator = div_estimator

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 initial_log_prob=None, train: bool = True,
                 compute_ito_int: bool = False, change_sde_ctrl: bool = False,
                 return_traj: bool = False, inference_ctrl: Callable | None = None,
                 noise: torch.Tensor | None = None, div_probes: torch.Tensor | None = None):
        """(x_T, rnd, xs or None). ``noise`` (K, B, D) replaces the Brownian
        draws and ``div_probes`` (K, B, D) the Hutchinson probes of a
        training pass with an inference control."""
        inference_ctrl = inference_ctrl if inference_ctrl is not None else self.inference_ctrl
        s_arr, t_arr = ts[:-1], ts[1:]
        dt_arr = t_arr - s_arr
        sqdt_arr = torch.sqrt(dt_arr)
        linear = hasattr(self.sde, "drift_coeff_t")
        if linear:
            diff_arr = self.sde.diff_coeff_t(s_arr)
            drift_k_arr = self.sde.drift_coeff_t(s_arr)
            div_int_arr = self.sde.int_drift_coeff_t(s_arr, t_arr) * x.shape[-1]
        if train and self.method in ("kl", "kl_ito"):
            rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        else:
            rnd = initial_log_prob(x)
        traj = [x]
        for k in range(s_arr.shape[0]):
            s, dt = s_arr[k], dt_arr[k]
            u = ctrl(s, x)
            sde_ctrl = self._sde_ctrl(u, generator, s, x) if change_sde_ctrl else u
            sde_diff = diff_arr[k] if linear else self.sde.diff(s, x)
            if inference_ctrl is None:
                gen_plus = gen_minus = u
            else:
                div_type = self.div_estimator if train else None
                div_ctrl, inf = compute_divx(
                    inference_ctrl, s, x, generator=generator, noise_type=div_type,
                    probe=None if div_probes is None or div_type is None else div_probes[k])
                rnd = rnd + sde_diff * div_ctrl[:, 0] * dt
                gen_plus, gen_minus = u + inf, u - inf
            if change_sde_ctrl:
                cost = torch.sum(gen_plus * (sde_ctrl - 0.5 * gen_minus), dim=-1)
            else:
                cost = 0.5 * torch.sum(gen_plus**2, dim=-1)
            rnd = rnd + cost * dt
            if not train:
                rnd = rnd - (div_int_arr[k] if linear
                             else self.sde.drift_div_int(s, s + dt, x))
            db = sqdt_arr[k] * _step_noise(noise, k, generator, x)
            drift = drift_k_arr[k] * x if linear else self.sde.drift(s, x)
            x = x + (drift + sde_diff * sde_ctrl) * dt + sde_diff * db
            if compute_ito_int:
                rnd = rnd + torch.sum(gen_plus * db, dim=-1)
            if return_traj:
                traj.append(x)
        rnd = rnd - terminal_unnorm_log_prob(x)
        return x, rnd, (torch.stack(traj) if return_traj else None)

    def __call__(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 initial_log_prob=None, inference_ctrl: Callable | None = None,
                 noise=None, div_probes=None):
        x = self.repeat_traj(x)
        samples, rnd, _ = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob,
            initial_log_prob=initial_log_prob, train=True,
            compute_ito_int=self.method != "kl", change_sde_ctrl=self.is_lv,
            inference_ctrl=inference_ctrl, noise=noise, div_probes=div_probes)
        return self.reduce(rnd, samples=samples)

    # -- flat LV training path (see losses/rds.py lv_flat_call) ------------
    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        # a learned inference control adds a live divergence term along the
        # trajectory, outside the flat restructuring
        return (self.inference_ctrl is None
                and call_args == frozenset({"terminal_unnorm_log_prob", "initial_log_prob"}))

    def flat_states(self, ts, x, ctrl, zs, terminal_unnorm_log_prob, initial_log_prob=None):
        """The flat LV path's simulation by the loss's own loop: the
        pre-step states (K, B, D) and x_T under the fed noise ``zs``."""
        x_t, _, xs_all = self.simulate(None, ts, x, ctrl, terminal_unnorm_log_prob,
                                       initial_log_prob=initial_log_prob, train=True,
                                       change_sde_ctrl=True, return_traj=True, noise=zs)
        return xs_all[:-1], x_t

    def lv_flat_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     initial_log_prob=None, traj_fn=None, noise=None):
        """LV training as gradient-free simulation (the loss's own loop, or
        ``traj_fn(x0, zs) -> (xs, x_T)`` when given: the solver's graph of
        ``flat_states``; the fused trajectory does not cover this EM step on
        the forward clock) plus one batched control evaluation carrying
        dt·u·(ū − ½u) + √dt·u·z."""
        if self.inference_ctrl is not None:
            raise ValueError("lv_flat_call does not support a learned "
                             "inference control (live divergence term)")
        x, zs = self._flat_lv_setup(generator, ts, x, noise=noise)
        with torch.no_grad():
            xs, x_t = (traj_fn(x, zs) if traj_fn is not None else self.flat_states(
                ts, x, ctrl, zs, terminal_unnorm_log_prob, initial_log_prob))
            xs_all = torch.cat([xs, x_t[None]])
        dt = (ts[1:] - ts[:-1])[:, None]                              # (K, 1)
        u = flat_ctrl_eval(ctrl, ts[:-1], xs_all[:-1])                # (K, B, D)
        u_bar = u.detach()
        steps = (dt * torch.sum(u * (u_bar - 0.5 * u), dim=-1)
                 + torch.sqrt(dt) * torch.sum(u * zs, dim=-1))         # (K, B)
        rnd = (initial_log_prob(xs_all[0]) + torch.sum(steps, dim=0)
               - terminal_unnorm_log_prob(xs_all[-1]))
        return self.reduce(rnd, samples=xs_all[-1])

    def eval(self, generator, ts, x, ctrl, terminal_unnorm_log_prob, initial_log_prob=None,
             compute_weights: bool = True, return_traj: bool = True,
             inference_ctrl: Callable | None = None, noise=None):
        with torch.no_grad():
            samples, rnd, xs = self.simulate(
                generator, ts, x, ctrl, terminal_unnorm_log_prob,
                initial_log_prob=initial_log_prob, train=False,
                compute_ito_int=compute_weights, return_traj=return_traj,
                inference_ctrl=inference_ctrl, noise=noise)
        return compute_results(rnd, compute_weights=compute_weights, ts=ts,
                               max_rnd=self.max_rnd, samples=samples, xs=xs)
