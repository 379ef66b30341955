"""The VP SDE of both configurations, its log-SNR time grid and the
exponential integrator's per-step coefficients, from their equations:

  α(t) = β_min·t + t²(β_max − β_min)/(2T),  s(t) = e^{−α/2},
  σ²(t) = c²(e^α − 1),  log SNR(t) = −log σ²(t);

the grid is K + 1 times from ε to T − ε equispaced in log SNR (each time
solved in closed form in float64, then held in float32 as the program holds
its grid); step k runs from s_k to t_k on the reversed clock, its control and
reference read at t = t_K − s_k (the grid's last time, not T), with
Δα = α(T − s_k) − α(T − t_k), λ = e^{Δα} − 1 and

  a_x = √(1 + λ),  a_s = 2c²(√(1 + λ) − 1),  a_z = c·√λ,  ω = 4c²·tanh(Δα/4).
"""
from __future__ import annotations

import math

import torch


class VP:
    def __init__(self, beta_min: float, beta_max: float, c: float = 1.0, terminal_t: float = 1.0):
        self.beta_min, self.beta_max, self.c, self.T = beta_min, beta_max, c, terminal_t

    def alpha(self, t):
        return self.beta_min * t + (0.5 * t**2 / self.T) * (self.beta_max - self.beta_min)

    def s(self, t):
        return torch.exp(-0.5 * self.alpha(t))

    def sigma_sq(self, t):
        return self.c**2 * torch.expm1(self.alpha(t))

    def _t_of_alpha(self, a: float) -> float:
        q = (self.beta_max - self.beta_min) / self.T
        return (-self.beta_min + math.sqrt(self.beta_min**2 + 2.0 * q * a)) / q

    def snr_grid(self, steps: int, eps: float = 1e-4, device=None) -> torch.Tensor:
        """float32 (steps + 1,) times on [eps, T − eps], equispaced in log SNR."""
        start, end = eps, self.T - eps
        log_snr = lambda t: -math.log(self.c**2 * math.expm1(self.alpha(t)))
        targets = torch.linspace(log_snr(start), log_snr(end), steps + 1,
                                 dtype=torch.float32)[1:-1].double()
        inner = [self._t_of_alpha(math.log1p(math.exp(-float(v)) / self.c**2)) for v in targets]
        ts = torch.tensor([start] + inner + [end], dtype=torch.float64).float()
        return torch.sort(ts).values.to(device)

    def ei_coeffs(self, ts: torch.Tensor, dtype=torch.float64):
        """Per step (t_ctrl, a_x, a_s, a_z, ω) in ``dtype``, from the grid ts."""
        ts = ts.to(dtype)
        s_arr, t_arr = ts[:-1], ts[1:]
        d_alpha = self.alpha(self.T - s_arr) - self.alpha(self.T - t_arr)
        lam = torch.expm1(d_alpha)
        root = torch.sqrt(1.0 + lam)
        return (ts[-1] - s_arr, root, 2.0 * self.c**2 * (root - 1.0), self.c * torch.sqrt(lam),
                4.0 * self.c**2 * torch.tanh(d_alpha / 4.0))
