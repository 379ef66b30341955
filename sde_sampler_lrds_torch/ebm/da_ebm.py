"""Diffusion-assisted EBM: Langevin-within-Gibbs over (noise level, x)
(counterpart of sde_sampler_lrds_tpu/ebm/da_ebm.py). The joint sampler
alternates a draw of each chain's level from the softmax of its all-level
log-probs with local MALA moves at the chosen level; the trainer keeps a
persistent (level, x) buffer and trains on positives at random levels."""
from __future__ import annotations

import numpy as np
import torch

from ..mcmc.kernels import MCMCState, heuristics_step_size, mala_step
from ..utils.common import derive_generator, get_timesteps


@torch.no_grad()
def sample_langevin_gibbs_mcmc(generator: torch.Generator, k_init, x_init, times, log_probs,
                               log_prob_and_grads, n_warmup_mcmc_steps: int,
                               n_mcmc_steps: int, n_local_steps: int, step_sizes_per_noise,
                               target_acceptance: float = 0.75):
    """Gibbs over (k, x): ``log_probs(t_flat, x_flat)`` scores every chain at
    every level as one (L·B) batch, each chain draws its level from the
    softmax over levels, then takes ``n_local_steps`` adapted MALA steps
    there; the adapted step sizes are averaged back per visited level.
    Returns the kept steps' (levels (S, B), times (S, B), states (S, B, D)),
    the final per-level step sizes (L, 1) and {"local_acc": (S, L)}."""
    n_levels, batch = times.shape[0], x_init.shape[0]
    t_all = times.repeat_interleave(batch)
    k, x = k_init, x_init
    ss_per_noise = torch.as_tensor(step_sizes_per_noise, dtype=torch.float32,
                                   device=x.device).reshape(n_levels, 1).clone()
    ks, ts, xs, accs = [], [], [], []
    for _ in range(n_warmup_mcmc_steps + n_mcmc_steps):
        all_lp = log_probs(t_all, x.repeat(n_levels, 1)).reshape(n_levels, batch)
        k = torch.multinomial(torch.softmax(all_lp.T, dim=-1), 1, generator=generator)[:, 0]
        t = times[k]
        cur_lpg = lambda y, t=t: log_prob_and_grads(t, y)
        lp, g = cur_lpg(x)
        state = MCMCState(x=x, log_prob=lp, grad=g, step_size=ss_per_noise[k].clone())
        for _ in range(n_local_steps):
            state, log_acc = mala_step(generator, state, cur_lpg)
            state = state._replace(step_size=heuristics_step_size(
                state.step_size, log_acc, target_acceptance=target_acceptance))
        acc = torch.exp(torch.clamp(log_acc, max=0.0))
        counts = torch.zeros(n_levels, device=x.device).index_add_(0, k, torch.ones_like(acc))
        sums = torch.zeros(n_levels, device=x.device).index_add_(0, k, state.step_size[:, 0])
        ss_per_noise = torch.where(counts[:, None] > 0,
                                   (sums / torch.clamp(counts, min=1.0))[:, None], ss_per_noise)
        per_level_acc = torch.zeros(n_levels, device=x.device).index_add_(0, k, acc) \
            / torch.clamp(counts, min=1.0)
        x = state.x
        ks.append(k), ts.append(t), xs.append(x), accs.append(per_level_acc)
    sl = slice(n_warmup_mcmc_steps, None)
    return (torch.stack(ks[sl]), torch.stack(ts[sl]), torch.stack(xs[sl]), ss_per_noise,
            {"local_acc": torch.stack(accs[sl])})


class DAEBM:
    """Diffusion-assisted EBM trainer with a persistent (level, x) buffer of
    ``persistent_size`` chains, started at the last level from the prior."""

    def __init__(self, sde, prior, net, step_size: float = 1e-3,
                 target_acceptance: float = 0.75, perc_keep_mcmc: float = -1.0,
                 persistent_size: int = 8192, use_snr_adapted_disc: bool = False,
                 start_eps: float = 1e-3, end_eps: float = 0.0, n_steps: int = 100,
                 device=None):
        self.sde = sde
        self.prior = prior
        self.net = net
        self.device = next(net.parameters()).device if device is None else torch.device(device)
        self.step_size = step_size
        self.target_acceptance = target_acceptance
        self.perc_keep_mcmc = perc_keep_mcmc
        self.keep_some_mcmc = perc_keep_mcmc > 0.0
        self.persistent_size = persistent_size
        self.n_steps = n_steps
        self.times = get_timesteps(start_eps, sde.terminal_t - end_eps, steps=n_steps,
                                   sde=sde if use_snr_adapted_disc else None, device=self.device)

    def loss(self, ts_p, xs_p, ts_n, xs_n) -> torch.Tensor:
        """E[E(t, x⁺)] − E[E(t, x⁻)]."""
        return self.net.energy(ts_p, xs_p).mean() - self.net.energy(ts_n, xs_n).mean()

    def train(self, generator: torch.Generator, data, batch_size: int, n_epochs: int,
              lr: float = 3e-4, initial_n_warmup_mcmc_steps: int = 1024,
              n_warmup_mcmc_steps: int = 0, n_mcmc_steps: int = 32, n_local_steps: int = 8):
        """Adam on the energy difference; each batch's negatives continue a
        random subset of the persistent buffer by Gibbs (the first with
        ``initial_n_warmup_mcmc_steps``). Returns (losses, diagnostics)."""
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        dim = data.shape[-1]
        net = self.net
        g = derive_generator(generator, 0)
        self.persistent_k = torch.full((self.persistent_size,), self.n_steps - 1,
                                       dtype=torch.long, device=self.device)
        self.persistent_x = self.prior.sample(g, (self.persistent_size,))
        ss_per_noise = torch.full((self.times.shape[0], 1), self.step_size, device=self.device)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        n_kept = max(int(self.perc_keep_mcmc * n_mcmc_steps), 1)
        lpg = lambda t, y: net.unnorm_log_prob_and_grad(t, y)
        log_probs = lambda t, y: net.unnorm_log_prob(t, y)
        losses, diagnostics = [], []
        n_batches = data.shape[0] // batch_size
        first = True
        for _ in range(n_epochs):
            perm = torch.randperm(data.shape[0], generator=g, device=self.device)
            for b in range(n_batches):
                batch = data[perm[b * batch_size:(b + 1) * batch_size]]
                # positives at every level, the terminal one included
                ks_pos = torch.randint(0, self.times.shape[0], (batch_size,), generator=g,
                                       device=self.device)
                ts_p = self.times[ks_pos]
                s_t = self.sde.s(ts_p)[:, None]
                std = s_t * torch.sqrt(self.sde.sigma_sq(ts_p))[:, None]
                xs_p = s_t * batch + std * torch.randn(batch.shape, generator=g,
                                                       device=self.device)
                idx = torch.randperm(self.persistent_size, generator=g,
                                     device=self.device)[:batch_size]
                warm = initial_n_warmup_mcmc_steps if first else n_warmup_mcmc_steps
                first = False
                ks_n, ts_n, xs_n, ss_per_noise, diags = sample_langevin_gibbs_mcmc(
                    g, self.persistent_k[idx], self.persistent_x[idx], self.times, log_probs,
                    lpg, warm, n_mcmc_steps, n_local_steps, ss_per_noise,
                    target_acceptance=self.target_acceptance)
                self.persistent_k[idx] = ks_n[-1]
                self.persistent_x[idx] = xs_n[-1]
                if self.keep_some_mcmc:
                    ts_sel, xs_sel = ts_n[-n_kept:].reshape(-1), xs_n[-n_kept:].reshape(-1, dim)
                else:
                    ts_sel, xs_sel = ts_n[-1], xs_n[-1]
                loss = self.loss(ts_p, xs_p, ts_sel, xs_sel)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                diagnostics.append({"local_acc": float(diags["local_acc"].mean())})
        return np.asarray(losses), diagnostics
