"""Contrastive maximum-likelihood training of time-indexed EBMs (counterpart
of sde_sampler_lrds_tpu/ebm/mle.py). The trainer learns an annealed energy
E(t, x) (usually a GMM- or Gauss-tilted potential) whose Gibbs
distributions match the SDE-noised data at every level:

  positives: the analytically noised data  x⁺ = s(t)·x₀ + s(t)√σ²(t)·ε
  negatives: draws of the current model by annealed MCMC, SMC, SMC with
             PDDS weights (B4 resamples), replica exchange with persistent
             replicas, or contrastive divergence from the positives
  loss:      E[E(t, x⁺)] − E[E(t, x⁻)]  (+ 1/σ²(t) reweighting, + energy L2)

The JAX package fuses ``batches_per_call`` steps into one scan with per-step
keys derived by ``fold_in``; here every step is issued from the host in
order on one generator, so the losses and parameters do not depend on
``batches_per_call``. As in the JAX package it only sets where the NaN /
divergence check and ``select_fn`` run: after the first step and after
every block of ``batches_per_call`` steps.
"""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from ..mcmc.kernels import MCMCState, mcmc_loop
from ..mcmc.smc import re_sampler, smc_sampler
from ..utils.common import derive_generator, get_timesteps

SAMPLER_TYPES = ("annealed_mcmc", "smc", "smc_pdds", "replica_exchange", "cd")


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tensors))


class MaximumLikelihoodEBM:
    """``net`` is an nn.Module with ``energy(t, x)`` and
    ``unnorm_log_prob_and_grad(t, x)`` at per-row times (and, for persistent
    replicas seeded from it, ``sample_prior``); ``prior`` seeds the other
    samplers. The levels are ``get_timesteps(start_eps, T − end_eps,
    n_steps)`` (log-SNR spaced with ``use_snr_adapted_disc``), n_steps + 1
    of them."""

    def __init__(self, sde, prior, net, sampler_type: str,
                 step_sizes_per_noise=1e-3, precond_matrix_per_noise=None,
                 precond_matrix_chol_per_noise=None, use_ula: bool = False,
                 reweight_threshold: float = 1.0, swap_frequency: int = 16,
                 target_acceptance: float = 0.75, perc_keep_mcmc: float = -1.0,
                 use_snr_adapted_disc: bool = False, start_eps: float = 1e-3,
                 end_eps: float = 0.0, n_steps: int = 100, device=None):
        if sampler_type not in SAMPLER_TYPES:
            raise NotImplementedError(f"Sampler {sampler_type} not found.")
        self.sde = sde
        self.prior = prior
        self.net = net
        self.device = next(net.parameters()).device if device is None else torch.device(device)
        self.sampler_type = sampler_type
        self.reweight_threshold = reweight_threshold
        self.swap_frequency = swap_frequency
        self.init_step_size = step_sizes_per_noise
        self.precond_matrix_per_noise = precond_matrix_per_noise
        self.precond_matrix_chol_per_noise = precond_matrix_chol_per_noise
        self.use_precond = precond_matrix_per_noise is not None
        self.use_ula = use_ula
        self.target_acceptance = target_acceptance
        self.use_snr_adapted_disc = use_snr_adapted_disc
        self.perc_keep_mcmc = perc_keep_mcmc
        self.start_eps = start_eps
        self.end_eps = end_eps
        self.n_steps = n_steps
        self.times = get_timesteps(start_eps, sde.terminal_t - end_eps, steps=n_steps,
                                   sde=sde if use_snr_adapted_disc else None, device=self.device)
        self.ema_net = None
        self.best_params = self.best_score = self.best_step = None
        self.select_history = []

    # -- random draws (tests replace these with another package's) -----------
    def draw_permutation(self, generator: torch.Generator, epoch: int, n: int) -> torch.Tensor:
        """The data order of an epoch."""
        return torch.randperm(n, generator=generator, device=self.device)

    def draw_positive_noise(self, generator: torch.Generator, step: int, shape) -> torch.Tensor:
        """ε of a step's positives x⁺ = s·x₀ + s√σ²·ε."""
        return torch.randn(shape, generator=generator, device=self.device)

    # -- negative sampling ---------------------------------------------------
    def _lpg(self, net):
        return lambda t, y: net.unnorm_log_prob_and_grad(t, y)

    @torch.no_grad()
    def sample_negatives(self, net, generator: torch.Generator, batch_size: int, step_sizes,
                         n_warmup: int, n_mcmc: int, persistent=None, xs_pos=None):
        """One negative-sampling pass under the current parameters. Returns
        (xs_neg flat (N, D) level-major — each level's n_mcmc·B rows
        consecutive, as the positives' times are —, the new per-level step
        sizes, the new persistent replica state, diagnostics)."""
        lpg = self._lpg(net)
        n_levels = self.times.shape[0]
        if self.sampler_type in ("annealed_mcmc", "smc", "smc_pdds"):
            x_init = self.prior.sample(generator, (batch_size,))
            thr = 0.0 if self.sampler_type == "annealed_mcmc" else self.reweight_threshold
            samples, new_ss, diags = smc_sampler(
                generator, x_init, self.times, lpg, n_warmup_mcmc_steps=n_warmup,
                n_mcmc_steps=n_mcmc, step_sizes_per_noise=step_sizes, reweight_threshold=thr,
                use_pdds_weights=self.sampler_type == "smc_pdds",
                sde=self.sde if self.sampler_type == "smc_pdds" else None,
                target_acceptance=self.target_acceptance,
                precond_matrix_per_noise=self.precond_matrix_per_noise,
                precond_matrix_chol_per_noise=self.precond_matrix_chol_per_noise,
                use_ula=self.use_ula)
            return samples.reshape(-1, samples.shape[-1]), new_ss, persistent, diags
        if self.sampler_type == "replica_exchange":
            # persistent replicas: an (L, B, D) tensor on the first call, the
            # re_sampler's (x, lp, grad) state afterwards; the swap schedule
            # restarts at step 0 on every call, as in the JAX package
            if persistent is None:
                x_init, init_state = self.prior.sample(generator, (n_levels, batch_size)), None
            elif isinstance(persistent, tuple):
                x_init, init_state = persistent[0].reshape(n_levels, batch_size, -1), persistent
            else:
                x_init, init_state = persistent, None
            samples, new_ss, diags, new_persistent = re_sampler(
                generator, x_init, self.times, lpg, swap_frequency=self.swap_frequency,
                n_warmup_mcmc_steps=n_warmup, n_mcmc_steps=n_mcmc,
                step_sizes_per_noise=step_sizes, per_noise_init=True,
                target_acceptance=self.target_acceptance,
                precond_matrix_per_noise=self.precond_matrix_per_noise,
                precond_matrix_chol_per_noise=self.precond_matrix_chol_per_noise,
                use_ula=self.use_ula, init_state=init_state)
            return samples.reshape(-1, samples.shape[-1]), new_ss, new_persistent, diags
        # 'cd': contrastive divergence from the positives
        t_flat = self.times.repeat_interleave(xs_pos.shape[0] // n_levels)
        local_lpg = lambda y: lpg(t_flat, y)
        lp0, g0 = local_lpg(xs_pos)
        ss_flat = torch.broadcast_to(torch.as_tensor(step_sizes, device=xs_pos.device)
                                     .reshape(-1, 1), (xs_pos.shape[0], 1)).clone()
        state = MCMCState(x=xs_pos, log_prob=lp0, grad=g0, step_size=ss_flat)
        n_total = n_warmup + n_mcmc
        kernel = "ula" if self.use_ula else "mala"
        out = torch.empty((n_total,) + tuple(xs_pos.shape), device=xs_pos.device)
        state, acc = mcmc_loop(generator, state, local_lpg, n_total, kernel,
                               self.target_acceptance, out=out)
        # (n_kept, L, B, D) -> level-major rows matching the levels' times
        dim = xs_pos.shape[-1]
        xs_neg = (out[n_warmup:].reshape(n_mcmc, n_levels, -1, dim)
                  .transpose(0, 1).reshape(-1, dim))
        return xs_neg, state.step_size, persistent, {"acc": acc}

    # -- training --------------------------------------------------------------
    def energy(self, net, t, x) -> torch.Tensor:
        return net.energy(t.reshape(-1), x)

    def train(self, generator: torch.Generator, data: torch.Tensor, batch_size: int,
              n_epochs: int, reweight_loss: bool = False, lr: float = 3e-4, decay: float = 0.0,
              clip_val: float = 1.0, initial_n_warmup_mcmc_steps: int = 1024,
              n_mcmc_steps: int = 32, n_accumulation_steps: int = 1, reg_val: float = 0.0,
              use_ema: bool = False, ema_decay: float = 0.995, ema_steps: int = 10,
              batches_per_call: int = 1, verbose: bool = False,
              select_fn: Callable | None = None, select_every: int | None = None):
        """Contrastive-MLE training of ``self.net`` in place (the EMA copy in
        ``self.ema_net``), with the JAX package's protocol:

        * ``perc_keep_mcmc`` > 0 keeps that share of ``n_mcmc_steps`` per
          level (the rest warm up), else one step after n_mcmc_steps − 1;
          the effective batch is min(batch_size · kept, N) (batch_size for
          'cd'), and the first step warms up ``initial_n_warmup_mcmc_steps``;
        * ``n_accumulation_steps`` = A > 1 accumulates with per-epoch groups:
          negatives are drawn when the batch index within the epoch is a
          multiple of A and reused in between; micro-losses are scaled by
          1/A, or 1/(n_batches % A) in the ragged tail group; the
          accumulated gradient is clipped to ``clip_val`` after every
          micro-step and applied at group ends and at the epoch's end;
        * Adam, or AdamW with ``decay`` > 0 (decoupled weight decay, which
          equals optax's adamw update);
        * ``use_ema``: one blend every ``ema_steps`` optimizer steps with the
          adjusted α = min(1, (1 − ema_decay)·A·L·eff_batch·ema_steps /
          n_epochs);
        * a non-finite loss raises "NaN loss detected at step …", one above
          1e9 "Training diverged (loss = …) at step …";
        * ``select_fn(net) -> float`` (higher is better) scores the live
          (EMA with ``use_ema``) net before training, after the first step,
          at most every ``select_every`` steps (default one epoch) at block
          ends and after the last step; the best state_dict, score and step
          land in ``best_params`` / ``best_score`` / ``best_step``, every
          (step, score) in ``select_history``.

        Per-level step sizes and the persistent replicas carry from one
        negative pass to the next. Returns (losses, pre-clip gradient
        norms, per-step diagnostics)."""
        net = self.net
        params = [p for p in net.parameters() if p.requires_grad]
        n_levels = self.times.shape[0]
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        dim = data.shape[-1]
        is_cd = self.sampler_type == "cd"
        if self.perc_keep_mcmc > 0:
            n_warmup = int((1.0 - self.perc_keep_mcmc) * n_mcmc_steps)
            n_kept = max(int(self.perc_keep_mcmc * n_mcmc_steps), 1)
        else:
            n_warmup, n_kept = n_mcmc_steps - 1, 1
        eff_batch = batch_size if is_cd else min(batch_size * n_kept, data.shape[0])
        n_acc = int(n_accumulation_steps)
        if n_acc != 1 and is_cd:
            raise ValueError("Can't use n_accumulation_steps != 1 if sampler_type is CD.")
        opt = (torch.optim.AdamW(params, lr=lr, weight_decay=decay) if decay > 0
               else torch.optim.Adam(params, lr=lr))
        self.ema_net = copy.deepcopy(net)

        ts_pos = self.times.repeat_interleave(eff_batch)
        mean_f = self.sde.s(ts_pos)[:, None]
        std_f = mean_f * torch.sqrt(self.sde.sigma_sq(ts_pos))[:, None]
        loss_scale = (1.0 / self.sde.sigma_sq(ts_pos)) if reweight_loss else 1.0

        step_sizes = torch.as_tensor(self.init_step_size, dtype=torch.float32,
                                     device=self.device)
        if step_sizes.ndim == 0:
            step_sizes = torch.full((n_levels, batch_size, 1), float(step_sizes),
                                    device=self.device)
        elif step_sizes.ndim == 1:
            step_sizes = torch.broadcast_to(step_sizes[:, None, None],
                                            (n_levels, batch_size, 1)).clone()

        g_perm, g_step = derive_generator(generator, 0), derive_generator(generator, 1)
        persistent = None
        if self.sampler_type == "replica_exchange":
            g_init = derive_generator(generator, 2)
            with torch.no_grad():
                if hasattr(net, "sample_prior"):
                    x0 = net.sample_prior(g_init, self.times.repeat_interleave(batch_size))
                    persistent = x0.reshape(n_levels, batch_size, dim)
                else:
                    persistent = self.prior.sample(g_init, (n_levels, batch_size))

        def loss_fn(ts_n, xs_n, xs_p, denom):
            en_pos = self.energy(net, ts_pos, xs_p)
            en_neg = self.energy(net, ts_n, xs_n)
            loss = (en_pos.mean() - en_neg.mean()) if is_cd else \
                torch.mean(loss_scale * (en_pos - en_neg))
            if reg_val > 0:
                loss = loss + reg_val * (torch.mean(en_pos**2) + torch.mean(en_neg**2))
            return loss / denom

        n_batches = data.shape[0] // eff_batch
        total_steps = n_epochs * n_batches
        self.best_params = self.best_score = self.best_step = None
        self.select_history = []
        if total_steps == 0:
            return np.zeros((0,)), np.zeros((0,)), []
        tail = n_batches % n_acc
        ema_alpha = min(1.0, (1.0 - ema_decay) * n_acc * n_levels * eff_batch
                        * ema_steps / n_epochs) if use_ema else 0.0
        sel_every = select_every if select_every is not None else n_batches
        sel_last = [-(10**9)]

        def live_or_ema():
            return self.ema_net if use_ema else net

        def maybe_select(step_pos: int):
            if select_fn is None or step_pos - sel_last[0] < sel_every:
                return
            sel_last[0] = step_pos
            scored = live_or_ema()
            score = float(select_fn(scored))
            self.select_history.append((int(step_pos), score))
            if np.isfinite(score) and (self.best_score is None or score > self.best_score):
                self.best_score, self.best_step = score, step_pos
                self.best_params = {k: v.detach().clone() for k, v in scored.state_dict().items()}

        def check_abort(loss_block: np.ndarray, offset: int):
            bad = ~np.isfinite(loss_block)
            if bad.any():
                raise RuntimeError(f"NaN loss detected at step {offset + int(bad.argmax())}.")
            big = np.abs(loss_block) > 1e9
            if big.any():
                i = int(big.argmax())
                raise RuntimeError(f"Training diverged (loss = {loss_block[i]:.2e}) at step "
                                   f"{offset + i}.")

        maybe_select(0)
        sel_last[0] = -(10**9)
        grad_acc = [torch.zeros_like(p) for p in params]
        opt_step, perm, neg_pool = 0, None, None
        losses, grad_norms, diagnostics = [], [], []
        block = []                               # (loss, gnorm, diags) tensors
        spc = max(int(batches_per_call), 1)
        block_end = 1                            # the first step is a block
        for step_id in range(total_steps):
            b = step_id % n_batches
            if b == 0:
                perm = self.draw_permutation(g_perm, step_id // n_batches,
                                             data.shape[0])[:n_batches * eff_batch]
            batch = data[perm[b * eff_batch:(b + 1) * eff_batch]]
            eps = self.draw_positive_noise(g_step, step_id, (ts_pos.shape[0], dim))
            xs_pos = mean_f * batch.repeat(n_levels, 1) + std_f * eps
            if step_id == 0 or n_acc == 1 or b % n_acc == 0:
                warm = initial_n_warmup_mcmc_steps if step_id == 0 else n_warmup
                xs_neg, step_sizes, persistent, diags = self.sample_negatives(
                    net, g_step, batch_size, step_sizes, warm, n_kept, persistent=persistent,
                    xs_pos=xs_pos if is_cd else None)
                neg_pool = (xs_neg, diags)
            xs_neg, diags = neg_pool
            ts_neg = self.times.repeat_interleave(xs_neg.shape[0] // n_levels)
            denom = float(tail) if (n_acc > 1 and tail > 0 and b >= n_batches - tail) \
                else float(n_acc)
            loss = loss_fn(ts_neg, xs_neg, xs_pos, denom)
            grads = torch.autograd.grad(loss, params)
            torch._foreach_add_(grad_acc, grads)
            # logged before the clip, as the gradient's size before it
            gnorm = _global_norm(grad_acc)
            if clip_val > 0:
                # the accumulated gradient is clipped after every micro-step
                scale = torch.where(gnorm > clip_val, clip_val / gnorm, torch.ones_like(gnorm))
                torch._foreach_mul_(grad_acc, scale)
            if (b + 1) % n_acc == 0 or b + 1 == n_batches:
                upd = grad_acc
                if clip_val > 0:      # optax's clip_by_global_norm at the update
                    norm = _global_norm(grad_acc)
                    upd = [torch.where(norm < clip_val, g, g / norm * clip_val)
                           for g in grad_acc]
                for p, g in zip(params, upd):
                    p.grad = g.clone()
                opt.step()
                opt.zero_grad(set_to_none=True)
                grad_acc = [torch.zeros_like(p) for p in params]
                opt_step += 1
                if use_ema and opt_step % ema_steps == 0:
                    with torch.no_grad():
                        for e, p in zip(self.ema_net.parameters(), net.parameters()):
                            e.mul_(1.0 - ema_alpha).add_(p, alpha=ema_alpha)
            block.append((loss.detach(), gnorm.detach(), diags))
            if step_id + 1 == block_end or step_id + 1 == total_steps:
                offset = step_id + 1 - len(block)
                loss_block = torch.stack([x[0] for x in block]).cpu().numpy()
                check_abort(loss_block, offset)
                losses.extend(loss_block.tolist())
                grad_norms.extend(torch.stack([x[1] for x in block]).cpu().tolist())
                diagnostics.extend({k: float(torch.as_tensor(v).float().mean())
                                    for k, v in d.items()} for _, _, d in block)
                block = []
                if not use_ema:
                    self.ema_net.load_state_dict(net.state_dict())
                maybe_select(step_id + 1)
                block_end = step_id + 1 + spc
        if not use_ema:
            self.ema_net.load_state_dict(net.state_dict())
        # always score the final parameters, so select_fn covers the whole run
        sel_last[0] = -(10**9)
        maybe_select(total_steps)
        if verbose:
            print(f"EBM-MLE: {total_steps} steps, last loss {losses[-1]:.4f}")
        return np.asarray(losses), np.asarray(grad_norms), diagnostics
