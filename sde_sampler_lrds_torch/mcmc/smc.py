"""Sequential Monte Carlo and replica exchange over a tempering path
(counterpart of ``smc_sampler`` and ``re_sampler`` in
sde_sampler_lrds_tpu/mcmc/smc.py).

``smc_sampler`` processes the levels from the last (the prior, t = 1 on the
tempering path) down to level 0 (the target). At each level the particles
are re-evaluated at the level's time (or, with PDDS weights, moved by the
reverse kernel from the previous level's final state), their log-weights
grow by the increment lp_t(x) − lp_{t_prev}(x_prev) (plus the PDDS
transition term; reset at the first level), they are resampled when the
normalized ESS falls below ``reweight_threshold``, and then they take
warm-up and sampling steps of MALA (or ULA), preconditioned per level where
given, with per-chain step-size adaptation.

The JAX package decides whether to resample with a data-dependent
``lax.cond``. Here the decision is one host read per level: it costs one
synchronisation per level against the thousand-odd MCMC steps that follow,
and it launches the resampling kernel only where a level resamples, so its
launch count is the number of resampling events.

``re_sampler`` runs every level at once: levels × chains form one (L·B, D)
super-batch for the local MALA / ULA steps, and every ``swap_frequency``-th
step is instead a swap step between adjacent levels, the even and the odd
pairs in turn. Which step swaps and which pairing it uses are host
integers, so a run needs no synchronisation at all.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.resample import multinomial_resample, systematic_resample
from .kernels import (MCMCState, apply_precond, heuristics_step_size, mala_step, mcmc_loop,
                      precond_mala_step, precond_ula_step, ula_step)


@torch.no_grad()
def smc_sampler(generator: torch.Generator, x_init: torch.Tensor, times: torch.Tensor,
                log_prob_and_grads: Callable, n_warmup_mcmc_steps: int, n_mcmc_steps: int,
                step_sizes_per_noise, per_noise_init: bool = False,
                reweight_threshold: float = 1.0, use_pdds_weights: bool = False, sde=None,
                target_acceptance: float = 0.75, precond_matrix_per_noise=None,
                precond_matrix_chol_per_noise=None, use_ula: bool = False,
                resampler: str = "systematic"):
    """Annealed-Langevin / SMC / PDDS sampling along ``times`` (L,), iterated
    from index L−1 down to 0; ``log_prob_and_grads(t, x)`` evaluates the
    annealed density. ``x_init`` is (B, D), or (L, B, D) with
    ``per_noise_init``. ``step_sizes_per_noise`` is one step size, or per
    level (L,), (L, 1) or (L, B, 1). With ``use_pdds_weights`` each level
    after the first starts with the reverse-kernel move of ``sde`` (which
    needs ``ei_integration_step`` and ``transition_params``) from the
    previous level's final state and score; the preconditioners are (L, D,
    D) matrices and their square roots. Returns (samples (L, n_mcmc, B, D),
    step sizes (L, B, 1), {"ess": (L,), "local_acc": (L,)}) in level
    order."""
    if per_noise_init and reweight_threshold > 0.0:
        raise ValueError("Can't use per_noise_init in SMC mode.")
    if use_pdds_weights and sde is None:
        raise ValueError("Can't use PDDS weights without the SDE object.")
    if resampler not in ("systematic", "multinomial"):
        raise ValueError(f"unknown resampler {resampler!r}")
    resample_fn = systematic_resample if resampler == "systematic" else multinomial_resample
    kernel = "ula" if use_ula else "mala"
    use_precond = precond_matrix_per_noise is not None
    n_levels = times.shape[0]
    batch, dim = x_init.shape[-2], x_init.shape[-1]
    dev = x_init.device
    step_sizes = torch.as_tensor(step_sizes_per_noise, dtype=torch.float32, device=dev)
    step_sizes = torch.broadcast_to(
        step_sizes.reshape(n_levels if step_sizes.ndim else 1, -1, 1), (n_levels, batch, 1))

    samples = torch.empty((n_levels, n_mcmc_steps, batch, dim), dtype=x_init.dtype,
                          device=dev)
    new_step_sizes = torch.empty((n_levels, batch, 1), device=dev)
    ess_out = torch.ones((n_levels,), device=dev)
    acc_out = torch.zeros((n_levels,), device=dev)

    x_prev = x_init[-1] if per_noise_init else x_init
    lp_prev, g_prev = log_prob_and_grads(times[-1], x_prev)
    log_w = torch.zeros((batch,), device=dev)
    for pos, level in enumerate(range(n_levels - 1, -1, -1)):
        t = times[level]
        lpg = lambda y, t=t: log_prob_and_grads(t, y)
        pm = precond_matrix_per_noise[level] if use_precond else None
        pc = precond_matrix_chol_per_noise[level] if use_precond else None
        lw_trans = 0.0
        if use_pdds_weights and pos > 0:
            # the reverse-kernel move from the previous level's final state
            # and its score at the previous level's time (t_next)
            t_next = times[level + 1]
            z = torch.randn(x_prev.shape, generator=generator, device=dev, dtype=x_prev.dtype)
            x = sde.ei_integration_step(x_prev, sde.terminal_t - t_next, sde.terminal_t - t,
                                        g_prev, z)
            lp_b = -0.5 * torch.sum(z**2, dim=-1)
            mf, vf = sde.transition_params(t, t_next)
            lp_f = -0.5 * torch.sum((mf * x - x_prev) ** 2 / vf, dim=-1)
            lw_trans = lp_f - lp_b
        else:
            x = x_init[level] if per_noise_init else x_prev
        # evaluate at the current level's time: the importance increment is
        # lp_t(x) − lp_{t_prev}(x_prev)
        lp, g = lpg(x)
        if reweight_threshold > 0.0:
            # the weights accumulate across levels, the PDDS ones too (the
            # JAX package's choice over its reference's reset)
            log_w = (log_w + (lp - lp_prev) + lw_trans) if pos > 0 else torch.zeros_like(lp)
            w = torch.softmax(log_w, dim=0)
            ess = (1.0 / torch.sum(w**2)) / batch
            ess_out[level] = ess
            if pos > 0 and bool(ess < reweight_threshold):
                idx = resample_fn(generator, log_w)
                x, lp, g = x[idx], lp[idx], g[idx]
                log_w = torch.zeros_like(log_w)

        state = MCMCState(x=x, log_prob=lp, grad=g, step_size=step_sizes[level].clone(),
                          precond_grad=None if pm is None else apply_precond(pm, g))
        state, _ = mcmc_loop(generator, state, lpg, n_warmup_mcmc_steps, kernel,
                             target_acceptance, precond_matrix=pm, precond_matrix_chol=pc)
        state, acc = mcmc_loop(generator, state, lpg, n_mcmc_steps, kernel,
                               target_acceptance, out=samples[level], precond_matrix=pm,
                               precond_matrix_chol=pc)
        new_step_sizes[level] = state.step_size
        acc_out[level] = acc
        x_prev, lp_prev, g_prev = state.x, state.log_prob, state.grad
    return samples, new_step_sizes, {"ess": ess_out, "local_acc": acc_out}


def make_re_pairings(num_noise_levels: int) -> list:
    """The even pairs (0, 1), (2, 3), … and the odd pairs (1, 2), (3, 4), …
    of adjacent levels, each a (P, 2) int64 tensor on the CPU."""
    arr = np.arange(num_noise_levels)
    out = []
    for parity in (0, 1):
        mask = (arr % 2 == parity) & (arr + 1 < num_noise_levels)
        out.append(torch.as_tensor(np.stack([arr[mask], arr[mask] + 1], axis=-1)))
    return out


def _eval_levels(log_prob_and_grads: Callable, ts: torch.Tensor, xs: torch.Tensor):
    """Evaluate (P, B, D) states at one time a level by flattening them to
    one (P·B, D) super-batch with per-row times."""
    n_pairs, batch, dim = xs.shape
    lp, g = log_prob_and_grads(ts.repeat_interleave(batch), xs.reshape(-1, dim))
    return lp.reshape(n_pairs, batch), g.reshape(n_pairs, batch, dim)


def re_step(generator, x: torch.Tensor, log_prob_x: torch.Tensor, grad_x: torch.Tensor,
            log_prob_and_grads: Callable, times: torch.Tensor, idx_i: torch.Tensor,
            idx_j: torch.Tensor, uniforms: torch.Tensor | None = None):
    """One swap step between the level pairs (idx_i, idx_j): x (L, B, D),
    log-probs (L, B) and scores (L, B, D) at each level's own time; each
    (pair, chain) swaps with probability min(1, e^Δ). The rows of idx_i are
    written first, then those of idx_j. ``uniforms`` (P, B) replace the
    acceptance draws when fed. Returns (x, log_prob_x, grad_x, acceptance
    rate as a 0-d tensor)."""
    p_i_i, p_j_j = log_prob_x[idx_i], log_prob_x[idx_j]
    g_i_i, g_j_j = grad_x[idx_i], grad_x[idx_j]
    x_i_old, x_j_old = x[idx_i], x[idx_j]
    p_i_j, g_i_j = _eval_levels(log_prob_and_grads, times[idx_i], x_j_old)
    p_j_i, g_j_i = _eval_levels(log_prob_and_grads, times[idx_j], x_i_old)
    log_acc = (p_i_j + p_j_i) - (p_i_i + p_j_j)
    if uniforms is None:
        uniforms = torch.rand(log_acc.shape, generator=generator, device=x.device,
                              dtype=log_acc.dtype)
    accept = torch.log(uniforms) < log_acc
    acc_col = accept[..., None]
    x, log_prob_x, grad_x = x.clone(), log_prob_x.clone(), grad_x.clone()
    x[idx_i] = torch.where(acc_col, x_j_old, x_i_old)
    x[idx_j] = torch.where(acc_col, x_i_old, x_j_old)
    log_prob_x[idx_i] = torch.where(accept, p_i_j, p_i_i)
    log_prob_x[idx_j] = torch.where(accept, p_j_i, p_j_j)
    grad_x[idx_i] = torch.where(acc_col, g_i_j, g_i_i)
    grad_x[idx_j] = torch.where(acc_col, g_j_i, g_j_j)
    return x, log_prob_x, grad_x, accept.float().mean()


def _pad_pairs(p: torch.Tensor, n: int) -> torch.Tensor:
    """Pad (P, 2) pairs to (n, 2) with (0, 0) self-pairs, no-op swaps."""
    if p.shape[0] == n:
        return p
    return torch.cat([p, torch.zeros((n - p.shape[0], 2), dtype=p.dtype)], dim=0)


@torch.no_grad()
def re_sampler(generator: torch.Generator, x_init: torch.Tensor, times: torch.Tensor,
               log_prob_and_grads: Callable, swap_frequency: int, n_warmup_mcmc_steps: int,
               n_mcmc_steps: int, step_sizes_per_noise, per_noise_init: bool = False,
               target_acceptance: float = 0.75, precond_matrix_per_noise=None,
               precond_matrix_chol_per_noise=None, use_ula: bool = False,
               init_state: tuple | None = None, start_step: int = 0):
    """Replica exchange across all levels of ``times`` (L,) at once.
    ``log_prob_and_grads(t_flat (N,), x_flat (N, D))`` evaluates the
    annealed density at one time a row. ``x_init`` is (B, D), copied to
    every level, or (L, B, D) with ``per_noise_init``; ``init_state`` (x
    (L·B, D), log-probs, scores) and ``start_step`` continue an earlier
    run's replicas. Step ``i`` (counted from ``start_step``) is a swap step
    when ``i % swap_frequency == 0``, with the even pairs when
    ``(i // swap_frequency) % 2 == 0`` and the odd ones (padded with (0, 0)
    self-pairs, counted in the acceptance) otherwise; every other step is a
    local MALA (step-size adapted) or ULA step (acceptance 1), preconditioned
    by (L, D, D) or (L·B, D, D) matrices where given. Step sizes are (L,),
    (L, 1) or (L, B). The warm-up steps collect nothing. Returns (samples
    (L, n_mcmc, B, D), step sizes (L, B, 1), {"acc": (n_mcmc,)}, final (x,
    log-probs, scores))."""
    n_levels = times.shape[0]
    dim = x_init.shape[-1]
    dev = x_init.device
    if per_noise_init:
        batch = x_init.shape[1]
        x = x_init.reshape(-1, dim)
    else:
        batch = x_init.shape[0]
        x = x_init.repeat(n_levels, 1)
    t_flat = times.repeat_interleave(batch)
    pm = pc = None
    if precond_matrix_per_noise is not None:
        def expand(mat):
            mat = torch.as_tensor(mat, dtype=x.dtype, device=dev)
            if mat.ndim == 3 and mat.shape[0] == n_levels:
                mat = torch.broadcast_to(mat[:, None], (n_levels, batch, dim, dim))
            return mat.reshape(-1, dim, dim)

        pm, pc = expand(precond_matrix_per_noise), expand(precond_matrix_chol_per_noise)

    local_lpg = lambda y: log_prob_and_grads(t_flat, y)
    if init_state is None:
        lp, g = local_lpg(x)
    else:
        x, lp, g = init_state
    ss = torch.as_tensor(step_sizes_per_noise, dtype=x.dtype, device=dev)
    if ss.numel() % n_levels or ss.reshape(n_levels, -1).shape[1] not in (1, batch):
        raise ValueError("step_sizes_per_noise must be (L,), (L,1) or (L,B)")
    ss = torch.broadcast_to(ss.reshape(n_levels, -1)[..., None],
                            (n_levels, batch, 1)).reshape(-1, 1).clone()

    pairs = make_re_pairings(n_levels)
    n_pairs = max(int(pairs[0].shape[0]), int(pairs[1].shape[0]))
    pair_arr = [_pad_pairs(p, n_pairs).to(dev) for p in pairs]

    samples = torch.empty((n_levels, n_mcmc_steps, batch, dim), dtype=x.dtype, device=dev)
    accs = torch.empty((n_mcmc_steps,), device=dev)
    for i in range(start_step, start_step + n_warmup_mcmc_steps + n_mcmc_steps):
        if i % swap_frequency == 0:
            idx = pair_arr[(i // swap_frequency) % 2]
            xr, lpr, gr, acc = re_step(
                generator, x.reshape(n_levels, batch, dim), lp.reshape(n_levels, batch),
                g.reshape(n_levels, batch, dim), log_prob_and_grads, times, idx[:, 0], idx[:, 1])
            x, lp, g = xr.reshape(-1, dim), lpr.reshape(-1), gr.reshape(-1, dim)
        else:
            st = MCMCState(x=x, log_prob=lp, grad=g, step_size=ss,
                           precond_grad=None if pm is None else apply_precond(pm, g))
            if use_ula:
                st = (precond_ula_step(generator, st, local_lpg, pm, pc) if pm is not None
                      else ula_step(generator, st, local_lpg))
                acc = torch.ones((), device=dev)
            else:
                st, log_acc = (precond_mala_step(generator, st, local_lpg, pm, pc)
                               if pm is not None else mala_step(generator, st, local_lpg))
                if target_acceptance > 0.0:
                    st = st._replace(step_size=heuristics_step_size(
                        st.step_size, log_acc, target_acceptance=target_acceptance))
                acc = torch.exp(torch.clamp(log_acc, max=0.0)).mean()
            x, lp, g, ss = st.x, st.log_prob, st.grad, st.step_size
        j = i - start_step - n_warmup_mcmc_steps
        if j >= 0:
            # the warm-up collects nothing: its (L, B, D) states a step would
            # be n_warmup·L·B·D·4 bytes (34 GB at 4096 × 128 × 1024 × 16)
            samples[:, j] = x.reshape(n_levels, batch, dim)
            accs[j] = acc
    return samples, ss.reshape(n_levels, batch, 1), {"acc": accs}, (x, lp, g)
