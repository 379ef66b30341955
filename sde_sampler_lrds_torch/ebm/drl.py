"""Diffusion recovery likelihood (DRL) EBM training (counterpart of
sde_sampler_lrds_tpu/ebm/drl.py): learn E(t, x) by maximizing the recovery
likelihood p(y_k | x_{k+1}) ∝ e^{−E(t_k, y)} N(x_{k+1}; α_k y, σ̃²_k), with
conditional MALA at the step sizes 0.5·b·sqrt(σ̄²_k/σ̄²_0)·σ̃²_k, the Gao or
bar loss weightings and optional variance-reduced pairs."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..mcmc.kernels import MCMCState, mala_step
from ..utils.common import derive_generator, get_timesteps


class DiffusionRecoveryLikelihood:
    def __init__(self, sde, prior, net, b: float = 2e-2, use_b_adaptation: bool = False,
                 target_acceptance: float = 0.75, use_snr_adapted_disc: bool = False,
                 use_gao_weighting: bool = True, use_bar_weighting: bool = False,
                 use_weighting_on_reg: bool = False, use_var_reduction: bool = False,
                 perc_keep_mcmc: float = -1.0, start_eps: float = 1e-3, end_eps: float = 0.0,
                 n_steps: int = 100, device=None):
        self.sde = sde
        self.prior = prior
        self.net = net
        self.device = next(net.parameters()).device if device is None else torch.device(device)
        self.b = b
        self.use_b_adaptation = use_b_adaptation
        self.target_acceptance = target_acceptance
        self.use_gao_weighting = use_gao_weighting
        self.use_bar_weighting = use_bar_weighting
        self.use_weighting_on_reg = use_weighting_on_reg
        self.use_var_reduction = use_var_reduction
        self.perc_keep_mcmc = perc_keep_mcmc
        self.keep_some_mcmc = perc_keep_mcmc > 0.0
        self.n_steps = n_steps
        self.times = get_timesteps(start_eps, sde.terminal_t - end_eps, steps=n_steps,
                                   sde=sde if use_snr_adapted_disc else None, device=self.device)
        # per-step transition parameters
        self.alphas, self.sigmas_sq = sde.transition_params(self.times[:-1], self.times[1:])
        s = sde.s(self.times)
        self.alphas_bar = s
        self.sigmas_sq_bar = s**2 * sde.sigma_sq(self.times)
        self.step_size = 0.5 * b * torch.sqrt(
            self.sigmas_sq_bar[:-1] / self.sigmas_sq_bar[0]) * self.sigmas_sq

    def net_energy(self, net, k, x) -> torch.Tensor:
        """E(t_k, x) with the per-row scaling α_k."""
        return net.energy(self.times[k], x, scaling_factor=self.alphas[k][:, None])

    def _cond_lpg(self, net, k, x_k_p_1):
        """(log p, grad) of y ↦ −E(t_k, y) − ‖x_{k+1} − y‖²/(2σ̃²_k)."""
        sig = self.sigmas_sq[k][:, None]

        def f(y):
            lp_net, g_net = net.unnorm_log_prob_and_grad(self.times[k], y,
                                                         scaling_factor=self.alphas[k][:, None])
            return (lp_net - 0.5 * torch.sum((x_k_p_1 - y) ** 2 / sig, dim=-1),
                    g_net + (x_k_p_1 - y) / sig)

        return f

    def sample_noise_process_pairs(self, generator, k, x_data, z=None, z2=None):
        """(x_k, x_{k+1}) pairs, variance-reduced with ``use_var_reduction``;
        ``z`` / ``z2`` replace the two normal draws when fed."""
        if z is None:
            z = torch.randn(x_data.shape, generator=generator, device=x_data.device)
        x_k = self.alphas_bar[k][:, None] * x_data + torch.sqrt(self.sigmas_sq_bar[k])[:, None] * z
        if self.use_var_reduction:
            x_k_p_1 = (self.alphas_bar[k + 1][:, None] * x_data
                       + torch.sqrt(self.sigmas_sq_bar[k + 1])[:, None] * z)
        else:
            if z2 is None:
                z2 = torch.randn(x_k.shape, generator=generator, device=x_k.device)
            x_k_p_1 = self.alphas[k][:, None] * x_k + torch.sqrt(self.sigmas_sq[k])[:, None] * z2
        return x_k, x_k_p_1

    @torch.no_grad()
    def conditional_sample(self, net, generator, k, x_k_p_1, n_mcmc_steps: int):
        """MALA on the recovery conditional from chains at x_{k+1}; returns
        (final states, every step's states (S, B, D), acceptances (S, B))."""
        lpg = self._cond_lpg(net, k, x_k_p_1)
        lp0, g0 = lpg(x_k_p_1)
        ss = self.step_size[torch.clamp(k, 0, self.step_size.shape[0] - 1)][:, None]
        state = MCMCState(x=x_k_p_1, log_prob=lp0, grad=g0, step_size=ss)
        ys, accs = [], []
        for _ in range(n_mcmc_steps):
            state, log_acc = mala_step(generator, state, lpg)
            ys.append(state.x)
            accs.append(torch.exp(torch.clamp(log_acc, max=0.0)))
        return state.x, torch.stack(ys), torch.stack(accs)

    def weights(self, ks) -> torch.Tensor:
        if self.use_gao_weighting:
            return torch.sqrt(self.sigmas_sq[0] / self.sigmas_sq[ks])
        if self.use_bar_weighting:
            return torch.sqrt(self.sigmas_sq_bar[0] / self.sigmas_sq_bar[ks])
        return torch.ones(ks.shape, device=ks.device)

    def loss(self, net, ks, x_pos, ks_neg, x_neg, w, w_neg, reg_val: float) -> torch.Tensor:
        en_pos = self.net_energy(net, ks, x_pos)
        en_neg = self.net_energy(net, ks_neg, x_neg)
        loss = torch.mean(w * en_pos) - torch.mean(w_neg * en_neg)
        if self.use_weighting_on_reg:
            return loss + reg_val * (torch.mean(w * en_pos**2) + torch.mean(w_neg * en_neg**2))
        return loss + reg_val * (torch.mean(en_pos**2) + torch.mean(en_neg**2))

    def train(self, generator: torch.Generator, data, batch_size: int, n_epochs: int,
              lr: float = 3e-4, reg_val: float = 5e-3, n_mcmc_steps: int = 30):
        """Adam on the recovery-likelihood loss; levels drawn uniformly from
        0 … n_steps − 2. Returns (losses, acceptances)."""
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        dim = data.shape[-1]
        net = self.net
        g = derive_generator(generator, 0)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        n_kept = max(int(self.perc_keep_mcmc * n_mcmc_steps), 1)
        losses, acceptances = [], []
        n_batches = max(data.shape[0] // batch_size, 1)
        for _ in range(n_epochs):
            perm = torch.randperm(data.shape[0], generator=g, device=self.device)
            for b in range(n_batches):
                batch = data[perm[b * batch_size:(b + 1) * batch_size]]
                ks = torch.randint(0, self.n_steps - 1, (batch.shape[0],), generator=g,
                                   device=self.device)
                x_k_pos, x_k_p_1 = self.sample_noise_process_pairs(g, ks, batch)
                y_last, ys, accs = self.conditional_sample(net, g, ks, x_k_p_1, n_mcmc_steps)
                if self.keep_some_mcmc:
                    y_neg, ks_neg = ys[-n_kept:].reshape(-1, dim), ks.repeat(n_kept)
                else:
                    y_neg, ks_neg = y_last, ks
                w = self.weights(ks)
                w_neg = w.repeat(n_kept) if self.keep_some_mcmc else w
                loss = self.loss(net, ks, x_k_pos, ks_neg, y_neg, w, w_neg, reg_val)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                acc = float(accs.mean())
                acceptances.append(acc)
                if self.use_b_adaptation:
                    mean_log_acc = math.log(max(acc, 1e-12))
                    if mean_log_acc - math.log(self.target_acceptance) > math.log1p(0.05):
                        self.step_size = self.step_size * 1.01
                    elif math.log(self.target_acceptance) - mean_log_acc > -math.log1p(-0.05):
                        self.step_size = self.step_size / 1.01
        return losses, acceptances
