"""Sequential Monte Carlo over a tempering path (counterpart of
``smc_sampler`` in sde_sampler_lrds_tpu/mcmc/smc.py).

The levels are processed from the last (the prior, t = 1 on the tempering
path) down to level 0 (the target). At each level the particles are
re-evaluated at the level's time, their log-weights grow by the increment
lp_t(x) − lp_{t_prev}(x) (reset at the first level), they are resampled when
the normalized ESS falls below ``reweight_threshold``, and then they take
warm-up and sampling steps of MALA (or ULA) with per-chain step-size
adaptation.

The JAX package decides whether to resample with a data-dependent
``lax.cond``. Here the decision is one host read per level: it costs one
synchronisation per level against the thousand-odd MCMC steps that follow,
and it launches the resampling kernel only where a level resamples, so its
launch count is the number of resampling events.

Not ported yet (each raises NotImplementedError): the PDDS reverse-kernel
weights and the preconditioned kernels. Replica exchange (``re_sampler``)
waits for a later slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.resample import multinomial_resample, systematic_resample
from .kernels import MCMCState, mcmc_loop


@torch.no_grad()
def smc_sampler(generator: torch.Generator, x_init: torch.Tensor, times: torch.Tensor,
                log_prob_and_grads: Callable, n_warmup_mcmc_steps: int, n_mcmc_steps: int,
                step_sizes_per_noise, per_noise_init: bool = False,
                reweight_threshold: float = 1.0, use_pdds_weights: bool = False, sde=None,
                target_acceptance: float = 0.75, precond_matrix_per_noise=None,
                precond_matrix_chol_per_noise=None, use_ula: bool = False,
                resampler: str = "systematic"):
    """Annealed-Langevin / SMC sampling along ``times`` (L,), iterated from
    index L−1 down to 0; ``log_prob_and_grads(t, x)`` evaluates the annealed
    density. ``x_init`` is (B, D), or (L, B, D) with ``per_noise_init``.
    ``step_sizes_per_noise`` is one step size, or per level (L,), (L, 1) or
    (L, B, 1). Returns (samples (L, n_mcmc, B, D), step sizes (L, B, 1),
    {"ess": (L,), "local_acc": (L,)}) in level order."""
    if per_noise_init and reweight_threshold > 0.0:
        raise ValueError("Can't use per_noise_init in SMC mode.")
    if use_pdds_weights:
        raise NotImplementedError("PDDS weights are not ported yet")
    if precond_matrix_per_noise is not None or precond_matrix_chol_per_noise is not None:
        raise NotImplementedError("preconditioned SMC kernels are not ported yet")
    if resampler not in ("systematic", "multinomial"):
        raise ValueError(f"unknown resampler {resampler!r}")
    resample_fn = systematic_resample if resampler == "systematic" else multinomial_resample
    kernel = "ula" if use_ula else "mala"
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

    x = x_init[-1] if per_noise_init else x_init
    lp_prev, _ = log_prob_and_grads(times[-1], x)
    log_w = torch.zeros((batch,), device=dev)
    for pos, level in enumerate(range(n_levels - 1, -1, -1)):
        t = times[level]
        lpg = lambda y, t=t: log_prob_and_grads(t, y)
        if per_noise_init:
            x = x_init[level]
        # re-evaluate at the current level's time: the importance increment
        # is lp_t(x) − lp_{t_prev}(x)
        lp, g = lpg(x)
        if reweight_threshold > 0.0:
            log_w = log_w + (lp - lp_prev) if pos > 0 else torch.zeros_like(lp)
            w = torch.softmax(log_w, dim=0)
            ess = (1.0 / torch.sum(w**2)) / batch
            ess_out[level] = ess
            if pos > 0 and bool(ess < reweight_threshold):
                idx = resample_fn(generator, log_w)
                x, lp, g = x[idx], lp[idx], g[idx]
                log_w = torch.zeros_like(log_w)

        state = MCMCState(x=x, log_prob=lp, grad=g, step_size=step_sizes[level].clone())
        state, _ = mcmc_loop(generator, state, lpg, n_warmup_mcmc_steps, kernel,
                             target_acceptance)
        state, acc = mcmc_loop(generator, state, lpg, n_mcmc_steps, kernel,
                               target_acceptance, out=samples[level])
        new_step_sizes[level] = state.step_size
        acc_out[level] = acc
        x, lp_prev = state.x, state.log_prob
    return samples, new_step_sizes, {"ess": ess_out, "local_acc": acc_out}
