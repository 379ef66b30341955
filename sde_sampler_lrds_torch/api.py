"""Dataset and reference-fitting pipeline (counterpart of the
``mcmc_sample`` and ``fit_gmm`` entry points of sde_sampler_lrds_tpu/api.py;
the model factory is not ported yet)."""
from __future__ import annotations

from typing import Callable

import torch

from .mcmc.kernels import MCMCState, run_chain
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
    variances) on ``device``. Each attempt seeds its own generator; after
    the strongest regularization fails, this raises."""
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
