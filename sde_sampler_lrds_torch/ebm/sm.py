"""Denoising, target and perfect score matching (counterpart of
sde_sampler_lrds_tpu/ebm/sm.py): the σ²-weighted DSM loss with antithetic
noise, target score matching (s(t)·s_θ(t, y) regressed onto ∇log ρ(x₀)),
perfect score matching against a known score, and EI / DDPM ancestral
sampling from the learned score."""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from ..utils.common import derive_generator, get_timesteps


class ScoreMatching:
    def __init__(self, sde, prior, score_net, t_start: float, t_end: float,
                 n_steps: int = 100, antithetic: bool = True, time_type: str = "uniform",
                 device=None):
        self.sde = sde
        self.prior = prior
        self.score_net = score_net
        self.device = (next(score_net.parameters()).device if device is None
                       else torch.device(device))
        self.antithetic = antithetic
        self.t_start = t_start
        self.t_end = t_end
        self.n_steps = n_steps
        self.time_type = time_type
        if "multinomial" in time_type:
            self.times = get_timesteps(t_start, t_end, steps=n_steps,
                                       sde=sde if "snr" in time_type else None,
                                       device=self.device)
        self.ema_net = copy.deepcopy(score_net)

    def sample_time(self, generator, batch_size: int) -> torch.Tensor:
        if "multinomial" in self.time_type:
            idx = torch.randint(0, self.times.shape[0], (batch_size,), generator=generator,
                                device=self.device)
            return self.times[idx]
        return self.t_start + (self.t_end - self.t_start) * torch.rand(
            (batch_size,), generator=generator, device=self.device)

    def _noised(self, ts, xs, z):
        s_t = self.sde.s(ts)[:, None]
        return s_t, torch.sqrt(self.sde.sigma_sq(ts))[:, None], z

    def compute_loss(self, net, generator, ts, xs, z=None) -> torch.Tensor:
        """σ²-weighted DSM: E‖√v·s_θ(t, y) + z‖² with y = s·x₀ + √v·z (and
        its antithetic twin); ``z`` replaces the normal draw when fed."""
        if z is None:
            z = torch.randn(xs.shape, generator=generator, device=xs.device)
        s_t = self.sde.s(ts)[:, None]
        sd = torch.sqrt(s_t**2 * self.sde.sigma_sq(ts)[:, None])
        loss = torch.mean((sd * net(ts, s_t * xs + sd * z) + z) ** 2, dim=-1)
        if self.antithetic:
            loss = (loss + torch.mean((sd * net(ts, s_t * xs - sd * z) - z) ** 2, dim=-1)) / 2.0
        return loss.mean()

    @torch.no_grad()
    def sample(self, generator, n_samples: int, n_steps: int | None = None,
               use_ddpm_kernel: bool = False, keep_intermediates: bool = False, net=None):
        """EI (or DDPM-kernel) ancestral sampling from the learned score (the
        EMA copy unless ``net`` is given)."""
        net = net if net is not None else self.ema_net
        T = self.sde.terminal_t
        if "multinomial" in self.time_type:
            ts = self.times
        else:
            ts = get_timesteps(self.t_start, self.t_end, steps=n_steps or self.n_steps,
                               sde=self.sde if "snr" in self.time_type else None,
                               device=self.device)
        x = self.prior.sample(generator, (n_samples,))
        traj = [x]
        for s, t in zip(ts[:-1], ts[1:]):
            z = torch.randn(x.shape, generator=generator, device=x.device)
            score = net(torch.full((x.shape[0],), float(T), device=x.device) - s, x)
            coeffs = self.sde.ddpm_step_coeffs if use_ddpm_kernel else self.sde.ei_step_coeffs
            a_x, a_s, a_z = coeffs(s, t)
            x = a_x * x + a_s * score + a_z * z
            traj.append(x)
        return torch.stack(traj) if keep_intermediates else x

    def train(self, generator: torch.Generator, data, batch_size: int, n_epochs: int,
              lr: float = 3e-4, use_ema: bool = True, ema_decay: float = 0.995):
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        g = derive_generator(generator, 0)
        net = self.score_net
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        losses = []
        n_batches = max(data.shape[0] // batch_size, 1)
        for _ in range(n_epochs):
            perm = torch.randperm(data.shape[0], generator=g, device=self.device)
            for b in range(n_batches):
                xs = data[perm[b * batch_size:(b + 1) * batch_size]]
                ts = self.sample_time(g, xs.shape[0])
                loss = self.compute_loss(net, g, ts, xs)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                with torch.no_grad():
                    decay = ema_decay if use_ema else 0.0
                    for e, p in zip(self.ema_net.parameters(), net.parameters()):
                        e.mul_(decay).add_(p, alpha=1.0 - decay)
        return np.asarray(losses)


class TargetScoreMatching(ScoreMatching):
    """TSM: regress s(t)·s_θ(t, y) onto ∇log ρ(x₀)."""

    def __init__(self, target_score: Callable, **kwargs):
        super().__init__(**kwargs)
        self.target_score = target_score

    def compute_loss(self, net, generator, ts, xs, z=None) -> torch.Tensor:
        if z is None:
            z = torch.randn(xs.shape, generator=generator, device=xs.device)
        s_t = self.sde.s(ts)[:, None]
        sig = torch.sqrt(self.sde.sigma_sq(ts))[:, None]
        tgt = self.target_score(xs)
        loss = torch.mean((s_t * net(ts, s_t * xs + s_t * sig * z) - tgt) ** 2, dim=-1)
        if self.antithetic:
            loss = (loss + torch.mean((s_t * net(ts, s_t * xs - s_t * sig * z) - tgt) ** 2,
                                      dim=-1)) / 2.0
        return loss.mean()


class PerfectScoreMatching(ScoreMatching):
    """Regress onto a known time-indexed score ``perfect_score(t, y)``."""

    def __init__(self, perfect_score: Callable, **kwargs):
        super().__init__(**kwargs)
        self.perfect_score = perfect_score

    def compute_loss(self, net, generator, ts, xs, z=None) -> torch.Tensor:
        if z is None:
            z = torch.randn(xs.shape, generator=generator, device=xs.device)
        s_t = self.sde.s(ts)[:, None]
        sig = torch.sqrt(self.sde.sigma_sq(ts))[:, None]
        ys = s_t * xs + s_t * sig * z
        loss = torch.mean((net(ts, ys) - self.perfect_score(ts, ys)) ** 2, dim=-1)
        if self.antithetic:
            ys2 = s_t * xs - s_t * sig * z
            loss = (loss + torch.mean((net(ts, ys2) - self.perfect_score(ts, ys2)) ** 2,
                                      dim=-1)) / 2.0
        return loss.mean()
