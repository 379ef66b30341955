"""Reference-based diffusion sampler (RDS) losses: EM / EI / DDPM integrators
(counterpart of sde_sampler_lrds_tpu/losses/rds.py, with the flat LV and the
fused KL training paths and the EUBO's noising pass ``compute_eubo``).

RND accumulation per step, with terminal cost log p_ref(x_T) − log ρ(x_T):

  EM  :  rnd += cost·dt + u·dB,  x += (−f + g²·s_ref + g·ū)dt + g·dB
  EI  :  rnd += ω(s,t)·cost + √ω·u·z,  x = ei_step(x, s_ref+ū, z)
  DDPM:  same with ω_ddpm and the DDPM-like kernel

KL cost = ½‖u‖²; LV cost = u·(ū−½u) with ū detached. The JAX package's
``lax.scan`` over steps is a Python loop here; all per-step schedule values
are precomputed as grid tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.profiling import annotate
from .base import BaseOCLoss, compute_results, flat_ctrl_eval


def _at(tab, k):
    """Step k of a (possibly nested) tuple of per-step tables."""
    return tuple(_at(a, k) if isinstance(a, tuple) else a[k] for a in tab)


def _step_noise(noise, k, generator, x):
    return noise[k] if noise is not None else torch.randn(
        x.shape, generator=generator, device=x.device)


class EMReferenceSDELoss(BaseOCLoss):
    """RDS loss with the Euler-Maruyama integrator."""

    def __init__(self, *args, reference_ctrl: Callable | None = None,
                 use_rescaling: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.reference_ctrl = reference_ctrl
        self.use_rescaling = use_rescaling

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 reference_log_prob, change_sde_ctrl: bool = False,
                 return_traj: bool = False, noise: torch.Tensor | None = None):
        """(x_T, rnd, xs or None). ``noise`` (K, B, D), when given, replaces
        the draws from ``generator``; xs holds all K+1 states."""
        if not hasattr(self.sde, "drift_coeff_t"):
            raise NotImplementedError("only linear SDEs are ported")
        T = ts[-1]
        s_arr, t_arr = ts[:-1], ts[1:]
        t_ctrl = T - s_arr
        dt_arr = t_arr - s_arr
        sqdt_arr = torch.sqrt(dt_arr)
        diff_arr = self.sde.diff_coeff_t(t_ctrl)
        drift_arr = self.sde.drift_coeff_t(t_ctrl)
        tabulated = hasattr(self.reference_ctrl, "precompute")
        tab = self.reference_ctrl.precompute(t_ctrl) if tabulated else None
        rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        traj = [x]
        for k in range(t_ctrl.shape[0]):
            tc, dt, diff = t_ctrl[k], dt_arr[k], diff_arr[k]
            u = ctrl(tc, x)
            sde_ctrl = self._sde_ctrl(u, generator, tc, x) if change_sde_ctrl else u
            if not self.use_rescaling:
                u = u * diff
                sde_ctrl = sde_ctrl * diff
            rnd = rnd + self.running_cost(u, sde_ctrl, change_sde_ctrl) * dt
            db = sqdt_arr[k] * _step_noise(noise, k, generator, x)
            drift = -(drift_arr[k] * x)
            if self.reference_ctrl is not None:
                ref_score = (self.reference_ctrl.apply(_at(tab, k), x)
                             if tabulated else self.reference_ctrl(tc, x))
                drift = drift + torch.square(diff) * ref_score
            x = x + (drift + diff * sde_ctrl) * dt + diff * db
            rnd = rnd + torch.sum(u * db, dim=-1)
            if return_traj:
                traj.append(x)
        rnd = rnd + reference_log_prob(x) - terminal_unnorm_log_prob(x)
        return x, rnd, (torch.stack(traj) if return_traj else None)

    def __call__(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 reference_log_prob, noise=None):
        x = self.repeat_traj(x)
        samples, rnd, _ = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob, reference_log_prob,
            change_sde_ctrl=self.is_lv, return_traj=False, noise=noise)
        return self.reduce(rnd, samples=samples)

    # -- flat LV training path ---------------------------------------------
    def supports_flat_lv(self, ts, call_args: frozenset) -> bool:
        return (call_args == frozenset({"terminal_unnorm_log_prob",
                                        "reference_log_prob"})
                and self._flat_grids(ts) is not None)

    def _flat_grids(self, ts):
        """(c_cost, c_dot, u_scale) per step for ``lv_flat_call``: the RND is
        Σ_k c_cost·cost(u_scale·u_k) + c_dot·(u_scale·u_k)·z_k."""
        if not hasattr(self.sde, "drift_coeff_t"):
            return None
        t_ctrl = ts[-1] - ts[:-1]
        dt = ts[1:] - ts[:-1]
        scale = (torch.ones_like(dt) if self.use_rescaling
                 else torch.broadcast_to(self.sde.diff_coeff_t(t_ctrl), dt.shape))
        return dt, torch.sqrt(dt), scale

    def flat_states(self, ts, x, ctrl, zs, terminal_unnorm_log_prob, reference_log_prob):
        """The flat LV path's simulation by the loss's own loop: detached
        control, the fed per-step noise ``zs``; returns the pre-step states
        (K, B, D) and x_T."""
        x_t, _, xs_all = self.simulate(None, ts, x, ctrl, terminal_unnorm_log_prob,
                                       reference_log_prob, change_sde_ctrl=True,
                                       return_traj=True, noise=zs)
        return xs_all[:-1], x_t

    def lv_flat_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     reference_log_prob, traj_fn=None, noise=None):
        """LV training as gradient-free simulation + flat batched cost.

        The log-variance loss detaches the simulation control, so the
        trajectory carries no parameter gradient — only the per-step cost
        c_cost·u·(ū−½u) + c_dot·u·z does, evaluated at the frozen (x_k, z_k).
        The simulation runs without autograd (``traj_fn(x0, zs) -> (xs,
        x_T)`` when given: the fused trajectory kernel, or the solver's graph
        of ``flat_states``) and ONE batched control evaluation over all K·B
        states carries the gradient."""
        grids = self._flat_grids(ts)
        if grids is None:
            raise ValueError("the flat LV path needs a linear SDE")
        c_cost, c_dot, u_scale = grids
        x, zs = self._flat_lv_setup(generator, ts, x, noise=noise)
        with torch.no_grad(), annotate("lrds.step.simulate"):
            xs, x_t = (traj_fn(x, zs) if traj_fn is not None else self.flat_states(
                ts, x, ctrl, zs, terminal_unnorm_log_prob, reference_log_prob))
        with annotate("lrds.step.ctrl_eval"):
            u = flat_ctrl_eval(ctrl, ts[-1] - ts[:-1], xs) * u_scale[:, None, None]
            u_bar = u.detach()
            cost = torch.sum(u * (u_bar - 0.5 * u), dim=-1)           # (K, B)
            ito = torch.sum(u * zs, dim=-1)                           # (K, B)
            rnd = torch.sum(c_cost[:, None] * cost + c_dot[:, None] * ito, dim=0)
            rnd = rnd + reference_log_prob(x_t) - terminal_unnorm_log_prob(x_t)
            return self.reduce(rnd, samples=x_t)

    # -- fused KL training path ---------------------------------------------
    def supports_fused_kl(self, ts, call_args: frozenset) -> bool:
        """Whether ``kl_fused_call`` covers this loss: a KL method and the
        flat LV path's structural scope (linear SDE, the solver's two
        terminal log-probs)."""
        return (self.method in ("kl", "kl_ito")
                and call_args == frozenset({"terminal_unnorm_log_prob",
                                            "reference_log_prob"})
                and self._flat_grids(ts) is not None)

    def kl_fused_call(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                      reference_log_prob, traj_rnd_fn, noise=None):
        """KL training through the differentiable fused trajectory
        ``traj_rnd_fn(x0, zs) -> (x_T, rnd)`` (ops/fused_traj.fused_kl_traj:
        the kernel forward, the adjoint loop backward). The same estimator
        and gradient as ``__call__`` under common noise; the per-step noise
        is drawn as ``_flat_lv_setup`` draws it, or fed as ``noise``."""
        del ctrl  # the control rides inside traj_rnd_fn's tables
        x = self.repeat_traj(x)
        zs = noise if noise is not None else torch.randn(
            (ts.shape[0] - 1, *x.shape), generator=generator, device=x.device)
        with annotate("lrds.step.simulate"):
            x_t, rnd = traj_rnd_fn(x, zs)
        rnd = rnd + reference_log_prob(x_t) - terminal_unnorm_log_prob(x_t)
        return self.reduce(rnd, samples=x_t)

    @torch.no_grad()
    def eval(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
             reference_log_prob, compute_weights: bool = True,
             return_traj: bool = True, noise=None):
        samples, rnd, xs = self.simulate(
            generator, ts, x, ctrl, terminal_unnorm_log_prob, reference_log_prob,
            change_sde_ctrl=False, return_traj=return_traj, noise=noise)
        return compute_results(rnd, compute_weights=compute_weights, ts=ts,
                               max_rnd=self.max_rnd, samples=samples, xs=xs)

    def _eubo_grids(self, ts):
        """(times_s, times_t, t_ctrl, mean_f, std_f) of the noising pass,
        whose step k runs from noising time T − times_t[k] to T − times_s[k]
        on the flipped grid."""
        T = ts[-1]
        times_s, times_t = torch.flip(ts[:-1], (0,)), torch.flip(ts[1:], (0,))
        mean_f, var_f = self.sde.transition_params(T - times_t, T - times_s)
        return times_s, times_t, T - times_s, mean_f, torch.sqrt(var_f)

    @torch.no_grad()
    def compute_eubo(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     reference_log_prob, noise=None):
        """Reverse (noising) pass from true target samples ``x``: the
        per-sample log-ratio whose mean is the EUBO upper bound. The noising
        trajectory is control-free, so the control and the reference are
        evaluated once each over all K·B states (``flat_ctrl_eval``).
        ``noise`` (K, B, D), when given, replaces the draws from
        ``generator``."""
        times_s, times_t, t_ctrl, mean_f, std_f = self._eubo_grids(ts)
        dt_arr = times_t - times_s
        diff_arr = self.sde.diff_coeff_t(t_ctrl)
        drift_k_arr = self.sde.drift_coeff_t(t_ctrl)
        _, xs, zs = self._noising_states(generator, x, mean_f, std_f, noise=noise)
        u = flat_ctrl_eval(ctrl, t_ctrl, xs)                          # (K, B, D)
        ref = flat_ctrl_eval(self.reference_ctrl, t_ctrl, xs)
        if self.use_rescaling:
            u = u / diff_arr[:, None, None]
        cost = torch.sum(u * (ref + 0.5 * u), dim=-1)                 # (K, B)
        steps = (-cost * (dt_arr * diff_arr**2)[:, None]
                 + torch.sum(u * xs, dim=-1)
                 * (1.0 / mean_f - 1.0 + drift_k_arr * dt_arr)[:, None]
                 - torch.sum(u * zs, dim=-1) * (std_f / mean_f)[:, None])
        rnd0 = reference_log_prob(x) - terminal_unnorm_log_prob(x)
        return rnd0 + torch.sum(steps, dim=0)


class EIReferenceSDELoss(EMReferenceSDELoss):
    """RDS loss with the exponential integrator (no rescaling: the control
    output lives directly in score units)."""

    def __init__(self, *args, reference_ctrl: Callable | None = None, **kwargs):
        kwargs["use_rescaling"] = False
        super().__init__(*args, reference_ctrl=reference_ctrl, **kwargs)

    def _omega(self, s, t):
        return self.sde.omega(s, t)

    def _step_coeffs(self, s, t):
        return self.sde.ei_step_coeffs(s, t)

    def _flat_grids(self, ts):
        omega = self._omega(ts[:-1], ts[1:])
        return omega, torch.sqrt(omega), torch.ones_like(omega)

    def simulate(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                 reference_log_prob, change_sde_ctrl: bool = False,
                 return_traj: bool = False, noise: torch.Tensor | None = None):
        s_arr, t_arr = ts[:-1], ts[1:]
        t_ctrl = ts[-1] - s_arr
        omega = self._omega(s_arr, t_arr)
        sq_omega = torch.sqrt(omega)
        a_x, a_s, a_z = self._step_coeffs(s_arr, t_arr)
        tabulated = hasattr(self.reference_ctrl, "precompute")
        tab = self.reference_ctrl.precompute(t_ctrl) if tabulated else None
        rnd = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        traj = [x]
        for k in range(t_ctrl.shape[0]):
            tc = t_ctrl[k]
            ref_score = (self.reference_ctrl.apply(_at(tab, k), x)
                         if tabulated else self.reference_ctrl(tc, x))
            u = ctrl(tc, x)
            sde_ctrl = self._sde_ctrl(u, generator, tc, x) if change_sde_ctrl else u
            rnd = rnd + omega[k] * self.running_cost(u, sde_ctrl, change_sde_ctrl)
            z = _step_noise(noise, k, generator, x)
            x = a_x[k] * x + a_s[k] * (ref_score + sde_ctrl) + a_z[k] * z
            rnd = rnd + sq_omega[k] * torch.sum(u * z, dim=-1)
            if return_traj:
                traj.append(x)
        rnd = rnd + reference_log_prob(x) - terminal_unnorm_log_prob(x)
        return x, rnd, (torch.stack(traj) if return_traj else None)

    @torch.no_grad()
    def compute_eubo(self, generator, ts, x, ctrl, terminal_unnorm_log_prob,
                     reference_log_prob, noise=None):
        """Reverse noising pass with ω weights (see the EM variant)."""
        times_s, times_t, t_ctrl, mean_f, std_f = self._eubo_grids(ts)
        omega = self._omega(times_s, times_t)[:, None]                # (K, 1)
        _, xs, zs = self._noising_states(generator, x, mean_f, std_f, noise=noise)
        u = flat_ctrl_eval(ctrl, t_ctrl, xs)                          # (K, B, D)
        ref = flat_ctrl_eval(self.reference_ctrl, t_ctrl, xs)
        steps = (-torch.sum(u * (ref + 0.5 * u), dim=-1) * omega
                 - torch.sum(u * zs, dim=-1) * torch.sqrt(omega))
        rnd0 = reference_log_prob(x) - terminal_unnorm_log_prob(x)
        return rnd0 + torch.sum(steps, dim=0)


class DDPMLikeReferenceSDELoss(EIReferenceSDELoss):
    """RDS loss with the DDPM-like kernel. It has no EUBO: the DDPM-like
    kernel has no reverse pass, as in the JAX package."""

    compute_eubo = None

    def _omega(self, s, t):
        return self.sde.omega_ddpm(s, t)

    def _step_coeffs(self, s, t):
        return self.sde.ddpm_step_coeffs(s, t)
