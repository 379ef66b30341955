"""Batched MALA, ULA and RWMH, and preconditioned MALA and ULA (counterpart
of sde_sampler_lrds_tpu/mcmc/kernels.py). The state caches log-probs and
scores (and, with a preconditioner, the preconditioned scores) so each step
costs one log_prob_and_grad evaluation; per-chain step sizes adapt by the
log-space acceptance heuristic. Every step takes its proposal and acceptance
draws from a ``torch.Generator``, or fed as ``noise=`` / ``uniforms=``."""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class MCMCState(NamedTuple):
    """Chain state: positions (B, D), cached log-probs (B,), cached scores
    (B, D), per-chain step sizes (B, 1), optional preconditioned scores
    (B, D)."""

    x: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor
    step_size: torch.Tensor
    precond_grad: torch.Tensor | None = None

    @classmethod
    def init(cls, x, log_prob_and_grad: Callable, step_size, precond_matrix=None):
        lp, g = log_prob_and_grad(x)
        step_size = torch.broadcast_to(
            torch.as_tensor(step_size, dtype=x.dtype, device=x.device),
            (x.shape[0],) + (1,) * (x.ndim - 1)).clone()
        pg = None if precond_matrix is None else apply_precond(precond_matrix, g)
        return cls(x=x, log_prob=lp, grad=g, step_size=step_size, precond_grad=pg)


def apply_precond(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """M·g per row: ``m`` (D, D) or one (…, D, D) matrix a row of ``g``."""
    return torch.einsum("...ij,...j->...i", m, g)


def heuristics_step_size(step_size, log_acc, target_acceptance: float = 0.75,
                         factor: float = 1.01, tol: float = 0.05):
    """Per-chain multiplicative step-size adaptation in log space: grow when
    acceptance is above target, shrink when below."""
    la = log_acc.reshape((-1,) + (1,) * (step_size.ndim - 1))
    log_t = math.log(target_acceptance)
    up = (la - log_t) > math.log1p(tol)
    down = (log_t - la) > -math.log1p(-tol)
    return torch.where(up, step_size * factor,
                       torch.where(down, step_size / factor, step_size))


def mala_step(generator, state: MCMCState, log_prob_and_grad: Callable,
              noise: torch.Tensor | None = None, uniforms: torch.Tensor | None = None):
    """Metropolis-adjusted Langevin step; returns (new_state, log_acc (B,)).
    ``noise`` (B, D) and ``uniforms`` (B,) replace the proposal and
    acceptance draws when fed."""
    x, ss = state.x, state.step_size
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    y = x + ss * state.grad + torch.sqrt(2.0 * ss) * noise
    lp_y, g_y = log_prob_and_grad(y)
    axes = tuple(range(1, x.ndim))
    # q(y|x) = N(x + ss·grad, 2·ss·I)  ->  log q = -‖.‖² / (4·ss)
    fwd = -torch.sum((y - x - ss * state.grad) ** 2, dim=axes) / (4 * ss[:, 0])
    bwd = -torch.sum((x - y - ss * g_y) ** 2, dim=axes) / (4 * ss[:, 0])
    log_acc = (lp_y + bwd) - (state.log_prob + fwd)
    if uniforms is None:
        uniforms = torch.rand(log_acc.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
    accept = torch.log(uniforms) < log_acc
    acc_col = accept.reshape((-1,) + (1,) * (x.ndim - 1))
    new = state._replace(x=torch.where(acc_col, y, x),
                         log_prob=torch.where(accept, lp_y, state.log_prob),
                         grad=torch.where(acc_col, g_y, state.grad))
    return new, log_acc


def ula_step(generator, state: MCMCState, log_prob_and_grad: Callable,
             noise: torch.Tensor | None = None) -> MCMCState:
    """Unadjusted Langevin step: the MALA proposal, always taken. ``noise``
    (B, D) replaces the proposal draw when fed."""
    x, ss = state.x, state.step_size
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    y = x + ss * state.grad + torch.sqrt(2.0 * ss) * noise
    lp_y, g_y = log_prob_and_grad(y)
    return state._replace(x=y, log_prob=lp_y, grad=g_y)


def _precond_proposal(generator, state: MCMCState, precond_matrix_chol, noise):
    x, ss = state.x, state.step_size
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + ss * state.precond_grad + torch.sqrt(2.0 * ss) * apply_precond(
        precond_matrix_chol, noise)


def precond_mala_step(generator, state: MCMCState, log_prob_and_grad: Callable,
                      precond_matrix, precond_matrix_chol,
                      noise: torch.Tensor | None = None,
                      uniforms: torch.Tensor | None = None):
    """Preconditioned MALA, y = x + ss·M·∇ + √(2ss)·C·z with C Cᵀ = M, and
    the Metropolis–Hastings ratio in the Prop-1 form of arXiv:2305.14442:
    the Gaussian proposal's ratio with M⁻¹ cancelled, so no inverse is
    taken. ``state.precond_grad`` holds M·∇. Returns (new_state, log_acc
    (B,))."""
    x, ss = state.x, state.step_size
    y = _precond_proposal(generator, state, precond_matrix_chol, noise)
    lp_y, g_y = log_prob_and_grad(y)
    pg_y = apply_precond(precond_matrix, g_y)
    axes = tuple(range(1, x.ndim))
    log_acc = lp_y - state.log_prob
    log_acc = log_acc + 0.5 * torch.sum((x - y - 0.5 * ss * pg_y) * g_y, dim=axes)
    log_acc = log_acc - 0.5 * torch.sum((y - x - 0.5 * ss * state.precond_grad) * state.grad,
                                        dim=axes)
    if uniforms is None:
        uniforms = torch.rand(log_acc.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
    accept = torch.log(uniforms) < log_acc
    acc_col = accept.reshape((-1,) + (1,) * (x.ndim - 1))
    new = state._replace(x=torch.where(acc_col, y, x),
                         log_prob=torch.where(accept, lp_y, state.log_prob),
                         grad=torch.where(acc_col, g_y, state.grad),
                         precond_grad=torch.where(acc_col, pg_y, state.precond_grad))
    return new, log_acc


def precond_ula_step(generator, state: MCMCState, log_prob_and_grad: Callable,
                     precond_matrix, precond_matrix_chol,
                     noise: torch.Tensor | None = None) -> MCMCState:
    """Preconditioned ULA: the preconditioned MALA proposal, always taken."""
    y = _precond_proposal(generator, state, precond_matrix_chol, noise)
    lp_y, g_y = log_prob_and_grad(y)
    return state._replace(x=y, log_prob=lp_y, grad=g_y,
                          precond_grad=apply_precond(precond_matrix, g_y))


def rwmh_step(generator, state: MCMCState, log_prob: Callable,
              noise: torch.Tensor | None = None, uniforms: torch.Tensor | None = None):
    """Random-walk Metropolis–Hastings, y = x + ss·z. Only positions and
    log-probs move: ``state.grad`` stays as it was. Returns (new_state,
    log_acc (B,))."""
    x = state.x
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    y = x + state.step_size * noise
    lp_y = log_prob(y).reshape(-1)
    log_acc = lp_y - state.log_prob
    if uniforms is None:
        uniforms = torch.rand(log_acc.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
    accept = torch.log(uniforms) < log_acc
    acc_col = accept.reshape((-1,) + (1,) * (x.ndim - 1))
    new = state._replace(x=torch.where(acc_col, y, x),
                         log_prob=torch.where(accept, lp_y, state.log_prob))
    return new, log_acc


def mcmc_loop(generator, state: MCMCState, log_prob_and_grad: Callable, n_steps: int,
              kernel: str = "mala", target_acceptance: float = 0.75,
              out: torch.Tensor | None = None, precond_matrix=None,
              precond_matrix_chol=None):
    """n_steps of MALA or RWMH (each with step-size adaptation) or ULA, the
    first two preconditioned by ``precond_matrix`` (and its square root
    ``precond_matrix_chol``) where given, writing each step's positions into
    ``out[i]`` where given. RWMH reads ``log_prob_and_grad(y)[0]``. Returns
    (final_state, mean acceptance over the steps as a 0-d tensor; 0 for ULA,
    as in the JAX package)."""
    if kernel not in ("mala", "ula", "rwmh"):
        raise ValueError(f"Unknown kernel {kernel!r}")
    use_precond = precond_matrix is not None
    acc_sum = torch.zeros((), device=state.x.device)
    for i in range(n_steps):
        if kernel == "ula":
            state = (precond_ula_step(generator, state, log_prob_and_grad, precond_matrix,
                                      precond_matrix_chol) if use_precond
                     else ula_step(generator, state, log_prob_and_grad))
        else:
            if kernel == "rwmh":
                state, log_acc = rwmh_step(generator, state,
                                           lambda y: log_prob_and_grad(y)[0])
            elif use_precond:
                state, log_acc = precond_mala_step(generator, state, log_prob_and_grad,
                                                   precond_matrix, precond_matrix_chol)
            else:
                state, log_acc = mala_step(generator, state, log_prob_and_grad)
            if target_acceptance > 0.0:
                state = state._replace(step_size=heuristics_step_size(
                    state.step_size, log_acc, target_acceptance=target_acceptance))
            acc_sum = acc_sum + torch.exp(torch.clamp(log_acc, max=0.0)).mean()
        if out is not None:
            out[i] = state.x
    return state, acc_sum / max(n_steps, 1)


@torch.no_grad()
def run_chain(generator, state: MCMCState, log_prob_and_grad: Callable, n_steps: int,
              kernel: str = "mala", target_acceptance: float = 0.75,
              precond_matrix=None, precond_matrix_chol=None, collect: bool = True):
    """n_steps of MALA or RWMH (with step-size adaptation) or ULA,
    preconditioned where given; returns (final_state, samples (n_steps, B, D)
    or None)."""
    samples = (torch.empty((n_steps, *state.x.shape), dtype=state.x.dtype,
                           device=state.x.device) if collect else None)
    state, _ = mcmc_loop(generator, state, log_prob_and_grad, n_steps, kernel,
                         target_acceptance, out=samples, precond_matrix=precond_matrix,
                         precond_matrix_chol=precond_matrix_chol)
    return state, samples
