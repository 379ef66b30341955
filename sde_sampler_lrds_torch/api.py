"""Dataset and reference-fitting pipeline and the SMC baseline (counterpart
of the ``mcmc_sample``, ``fit_gmm``, ``define_tempering_utils`` and
``run_smc_sampler`` entry points of sde_sampler_lrds_tpu/api.py; the model
factory and the replica-exchange baseline are not ported yet)."""
from __future__ import annotations

from typing import Callable

import torch

from .mcmc.kernels import MCMCState, run_chain
from .mcmc.smc import smc_sampler
from .targets.gauss import Gauss, GaussFull
from .utils.common import resolve_device
from .utils.gmm_fit import fit_gmm_em


def mcmc_sample(generator: torch.Generator, target, x_init, mcmc_type: str = "mala",
                step_size: float = 1e-3, n_chains_per_mode: int = 4,
                dataset_length: int = 50000, n_warmup_steps: int = 512,
                skip_chain_per_mode: bool = False,
                target_log_prob_and_grad: Callable | None = None,
                adapt_step_size: bool = True, shuffle: bool = True,
                device=None) -> torch.Tensor:
    """MALA dataset: chains seeded at the given mode points,
    adaptive step sizes, post-warmup pooling. ``generator`` lives on
    ``device``."""
    device = resolve_device(device)
    if mcmc_type != "mala":
        raise NotImplementedError(f"mcmc_type {mcmc_type!r} is not ported")
    if target_log_prob_and_grad is None:
        target_log_prob_and_grad = target.log_prob_and_score
    x_init = torch.as_tensor(x_init, dtype=torch.float32, device=device)
    y_init = x_init if skip_chain_per_mode else torch.repeat_interleave(
        x_init, n_chains_per_mode, dim=0)
    n_mcmc_steps = int(dataset_length / y_init.shape[0])
    ta = 0.75 if adapt_step_size else 0.0
    state = MCMCState.init(y_init, target_log_prob_and_grad, step_size)
    state, _ = run_chain(generator, state, target_log_prob_and_grad, n_warmup_steps,
                         target_acceptance=ta, collect=False)
    state, samples = run_chain(generator, state, target_log_prob_and_grad,
                               n_mcmc_steps, target_acceptance=ta, collect=True)
    out = samples.reshape(-1, y_init.shape[-1])
    if shuffle:
        out = out[torch.randperm(out.shape[0], generator=generator, device=device)]
    return out


def fit_gmm(n_components: int, dataset, means_init=None, em_type: str = "diag",
            max_iter: int = 1000, device=None):
    """EM with an ascending reg_covar sweep; returns (weights, means,
    variances) on ``device``, the variances (K, D) for ``em_type`` 'diag' or
    full (K, D, D) covariances for 'full'. Each attempt seeds its own
    generator; after the strongest regularization fails, this raises."""
    device = resolve_device(device)
    data = torch.as_tensor(dataset, dtype=torch.float32, device=device)
    data = data.reshape(-1, data.shape[-1])
    last_err = None
    regs = (1e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2)
    for attempt_id, reg_covar in enumerate(regs):
        w, m, v, _ = fit_gmm_em(
            n_components, data, means_init=means_init, em_type=em_type,
            max_iter=max_iter, reg_covar=reg_covar,
            generator=torch.Generator(device).manual_seed(attempt_id))
        if not all(bool(torch.isfinite(a).all()) for a in (w, m, v)):
            last_err = "non-finite GMM parameters"
        elif bool((w < 1e-8).any()):
            last_err = "collapsed GMM component"
        else:
            return w, m, v
    raise ValueError(f"Couldn't fit a GMM on this dataset ({last_err}).")


def define_tempering_utils(mean, var, target_log_prob: Callable,
                           target_score: Callable | None = None, device=None):
    """The geometric path t·log p₀ + (1 − t)·log ρ between a Gaussian p₀
    (``GaussFull`` when ``var`` is a (D, D) covariance, else the diagonal
    ``Gauss``) and the target. Returns (p₀, log_prob_and_grads(t, x)); t is
    a scalar or one time per row of x. Without ``target_score`` the target's
    score is taken by autograd."""
    device = resolve_device(device)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    var = torch.as_tensor(var, dtype=torch.float32, device=device)
    dim = mean.shape[0]
    if var.ndim == 2:
        prior = GaussFull(dim=dim, loc=mean, cov=var, device=device)
    else:
        prior = Gauss(dim=dim, loc=mean, scale=torch.sqrt(var), device=device)
    if target_score is None:
        def target_score(x):
            with torch.enable_grad():
                y = x.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(torch.sum(target_log_prob(y)), y)
            return g

    def log_prob_and_grads(t, x):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t_flat = t.reshape(-1) if t.ndim > 0 else t
        t_col = t_flat[:, None] if t.ndim > 0 else t
        lp = t_flat * prior.log_prob(x) + (1.0 - t_flat) * target_log_prob(x).reshape(-1)
        g = t_col * prior.score(x) + (1.0 - t_col) * target_score(x)
        return lp, g

    return prior, log_prob_and_grads


def run_smc_sampler(generator: torch.Generator, mean, var, n_steps: int, step_size: float,
                    n_particles: int, n_mcmc_steps: int, n_warmup_mcmc_steps: int,
                    target_log_prob: Callable, target_score: Callable | None = None,
                    reweight_threshold: float = 1.0, target_acceptance: float = 0.75,
                    return_diagnostics: bool = False, device=None):
    """SMC baseline on the tempering path from the Gaussian (mean, var) to
    the target, with systematic resampling. Returns the whole level-0 (the
    target's) block of shape (n_mcmc_steps, n_particles, dim), and with
    ``return_diagnostics`` also ``smc_sampler``'s per-level ESS and
    acceptance."""
    device = resolve_device(device)
    prior, lpg = define_tempering_utils(mean, var, target_log_prob, target_score,
                                        device=device)
    times = torch.linspace(0.0, 1.0, n_steps, device=device)
    x0 = prior.sample(generator, (n_particles,))
    samples, _, diags = smc_sampler(
        generator, x0, times, lpg, n_warmup_mcmc_steps=n_warmup_mcmc_steps,
        n_mcmc_steps=n_mcmc_steps,
        step_sizes_per_noise=torch.full((n_steps, n_particles, 1), step_size, device=device),
        reweight_threshold=reweight_threshold, target_acceptance=target_acceptance)
    return (samples[0], diags) if return_diagnostics else samples[0]
