"""Plain reference of ``many_modes_d8``: LRDS sampling on ManyModes(4, d 8,
var 0.5) with a ClippedCtrl(FourierMLP) control, a diagonal-GMM reference
and the exponential integrator on the VP(0.1, 20) log-SNR grid.

One evaluation pass over B trajectories of K steps, for each trajectory:

  x_0 ~ N(0, I);  for k < K: u = clip(MLP(t_k, x)), r = ref score,
    rnd += ω_k·½|u|² + √ω_k·u·z_k,  x ← a_x x + a_s (r + u) + a_z z_k;
  rnd += log p_ref(x_K) − log ρ(x_K),

then log Z = logsumexp(−rnd) − log B and the normalized ESS of the weights
softmax(−rnd). The MLP is FourierMLP's: h = W_x x + b_x + TE(t), two hidden
layers of gelu(tanh form) then Linear, out = Linear(gelu(h)); TE(t) =
Linear(gelu(Linear([sin a, cos a]))) with a = linspace(0.1, 100, H)·t + φ.
The noise z is the kernel's Philox stream on the card and the generator's
per-step normals on the CPU, as the port draws it on each device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .gmm import Mixture
from .philox import step_normals
from .precision import Arith
from .vp import VP

_LOG_2PI = math.log(2.0 * math.pi)


def target_params(spec: dict):
    """ManyModes' (weights, means, std): centres from numpy
    ``default_rng(seed_loc)`` on [−n, n]^d, weights logspace(0, 1, n) base
    ``mixture_weight_factor``."""
    n, d = spec["n_modes"], spec["dim"]
    rng = np.random.default_rng(spec["seed_loc"])
    loc = 2 * n * rng.random((n, d)) - n
    weights = np.logspace(0.0, 1.0, n, base=spec["mixture_weight_factor"])
    return (torch.as_tensor(weights / weights.sum()), torch.as_tensor(loc),
            math.sqrt(spec["var"]))


def target_log_prob(spec: dict, x: torch.Tensor) -> torch.Tensor:
    w, loc, std = target_params(spec)
    w, loc = w.to(x), loc.to(x)
    diff = (x[:, None, :] - loc[None]) / std
    lp = (-0.5 * torch.sum(diff**2, -1) - 0.5 * x.shape[-1] * _LOG_2PI
          - x.shape[-1] * math.log(std))
    return torch.logsumexp(torch.log(w)[None] + lp, dim=-1)


def fit_reference(spec: dict, generator: torch.Generator, n: int):
    """The diagonal GMM both sides take as the RDS reference: ``n`` exact
    target draws from ``generator``, each component's weight, mean and
    per-coordinate variance taken from the draws it made."""
    w, loc, std = target_params(spec)
    dev = generator.device
    idx = torch.multinomial(w.float().to(dev), n, replacement=True, generator=generator)
    eps = torch.randn((n, spec["dim"]), generator=generator, device=dev, dtype=torch.float64)
    x = loc.to(dev)[idx] + std * eps
    weights, means, variances = [], [], []
    for c in range(spec["n_modes"]):
        xc = x[idx == c]
        weights.append(xc.shape[0] / n)
        means.append(xc.mean(0))
        variances.append(xc.var(0, correction=0))
    return (torch.tensor(weights, dtype=torch.float32, device=dev),
            torch.stack(means).float(), torch.stack(variances).float())


def mlp(W: dict, t: torch.Tensor, x: torch.Tensor, ar: Arith, n_hidden: int) -> torch.Tensor:
    """The control at one time t (0-d) for rows x (B, D)."""
    act = lambda h: F.gelu(h, approximate="tanh")
    w = {k: v.to(ar.dtype) for k, v in W.items()}
    h_dim = w["x_embed.weight"].shape[0]
    coeff = torch.linspace(0.1, 100.0, h_dim, dtype=torch.float32, device=x.device).to(ar.dtype)
    ang = coeff[None] * t + w["time_embed.timestep_phase"]
    te = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    te = act(ar.linear(te, w["time_embed.dense.0.weight"], w["time_embed.dense.0.bias"]))
    te = ar.linear(te, w["time_embed.out.weight"], w["time_embed.out.bias"])
    h = ar.linear(x, w["x_embed.weight"], w["x_embed.bias"]) + te
    for i in range(n_hidden):
        h = ar.linear(act(h), w[f"hidden.{i}.weight"], w[f"hidden.{i}.bias"])
    return ar.linear(act(h), w["out.weight"], w["out.bias"])


class Reference:
    """The configuration's pass from the benchmark's inputs: the control's
    weights ``W`` (FourierMLP names), the GMM (weights, means, variances),
    the time grid's settings in ``spec``."""

    def __init__(self, spec: dict, W: dict, gmm, mode: str = "f64"):
        self.spec, self.ar = spec, Arith(mode)
        self.W = W
        self.gmm = Mixture(*gmm, self.ar)
        sde = spec["sde"]
        self.vp = VP(sde["beta_min"], sde["beta_max"])
        self.ts = self.vp.snr_grid(spec["n_steps"], sde["t_eps"])

    def simulate(self, x0: torch.Tensor, noise, rows: torch.Tensor):
        """(x_K, rnd) for rows ``rows`` of a pass, from their x_0 and
        ``noise(k, rows) -> (len(rows), D)``."""
        ar, dt = self.ar, self.ar.dtype
        dev = x0.device
        t_ctrl, a_x, a_s, a_z, omega = (c.to(dev) for c in self.vp.ei_coeffs(self.ts, dt))
        x = x0.to(dt)
        rnd = torch.zeros(x.shape[0], dtype=dt, device=dev)
        clip, n_hidden = self.spec["clip"], self.spec["num_layers"] - 2
        for k in range(t_ctrl.shape[0]):
            tc = t_ctrl[k]
            u = torch.clamp(mlp(self.W, tc, x, ar, n_hidden), -clip, clip)
            r = self.gmm.noised_score(x, self.vp.s(tc), self.vp.sigma_sq(tc))
            z = noise(k, rows).to(dt)
            rnd = rnd + omega[k] * 0.5 * torch.sum(u * u, -1) + torch.sqrt(omega[k]) * torch.sum(u * z, -1)
            x = a_x[k] * x + a_s[k] * (r + u) + a_z[k] * z
        rnd = rnd + self.gmm.log_prob(x) - target_log_prob(self.spec, x)
        return x, rnd

    def run_pass(self, x0: torch.Tensor, kernel_seed: int | None, cpu_noise=None,
                 block: int = 32768):
        """(x_K, rnd) of a whole pass: the kernel's Philox noise from
        ``kernel_seed`` (card), or ``cpu_noise`` (K, B, D) (CPU), in blocks
        of rows."""
        outs = []
        for lo in range(0, x0.shape[0], block):
            rows = torch.arange(lo, min(lo + block, x0.shape[0]), device=x0.device)
            if kernel_seed is not None:
                noise = lambda k, r: step_normals(kernel_seed, k, r, x0.shape[1])
            else:
                noise = lambda k, r: cpu_noise[k, r]
            outs.append(self.simulate(x0[rows], noise, rows))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def is_stats(rnd: torch.Tensor, dtype=torch.float64):
    """(log Z, normalized ESS) of the IS weights softmax(−rnd), reduced in
    ``dtype``."""
    neg = -rnd.to(dtype)
    log_z = float(torch.logsumexp(neg, 0).double() - math.log(neg.shape[0]))
    w = torch.softmax(neg, 0)
    return log_z, float(1.0 / (neg.shape[0] * torch.sum(w * w).double()))


# the limits of the numbers compared, each between the largest reading of
# sound runs (lower) and the smallest of the control's (upper), on an H100
# at the cell's size (PERF.md §2): xT_q999 2.03e-4 / 4.21e-3, logw_q999
# 5.86e-5 / 1.59e-3, xT_max 1.95 / 279 (the altered answer; the control's
# 1.68 is under three times the lower), logz_reduce 1.19e-6 / 3.13e-2,
# ess_reduce 2.93e-7 / 1.71e-3 (the control's reduction in bfloat16)
LIMITS = {"xT_q999": 1e-3, "logw_q999": 3.5e-4, "xT_max": 30.0,
          "logz_reduce": 3e-4, "ess_reduce": 5e-5}


def traj_gaps(x_prog, rnd_prog, x_ref, rnd_ref):
    """Per trajectory: the widest gap of x_K over its dimensions and the gap
    of the log-weight, each over 1 + the reference's magnitude (NaN, or a
    trajectory the program did not return, reads as infinite)."""
    if x_prog.shape != x_ref.shape or rnd_prog.shape != rnd_ref.shape:
        inf = torch.full(rnd_ref.shape, math.inf, dtype=torch.float64, device=rnd_ref.device)
        return inf, inf
    x_prog, rnd_prog = x_prog.double(), rnd_prog.double()
    x_ref, rnd_ref = x_ref.double(), rnd_ref.double()
    gx = ((x_prog - x_ref).abs() / (1.0 + x_ref.abs())).amax(dim=1)
    gw = (rnd_prog - rnd_ref).abs() / (1.0 + rnd_ref.abs())
    return torch.nan_to_num(gx, nan=math.inf), torch.nan_to_num(gw, nan=math.inf)


def gaps(x_prog, rnd_prog, x_ref, rnd_ref, lz_p: float, ess_p: float) -> dict:
    """The numbers compared: the 99.9th percentile of the per-trajectory
    gaps of x_K and of the log-weights, the widest x_K gap; and the
    reduction's, from the program's own log-weights: the gap of its log Z
    from theirs reduced in float64, and its ESS's (relative)."""
    gx, gw = traj_gaps(x_prog, rnd_prog, x_ref, rnd_ref)
    lz_r, ess_r = is_stats(rnd_prog)
    q = lambda g: float(torch.quantile(g.float(), 0.999)) if torch.isfinite(g).all() else math.inf
    nan_inf = lambda v: v if v == v else math.inf
    return {"xT_q999": q(gx), "logw_q999": q(gw), "xT_max": float(gx.max()),
            "logz_reduce": nan_inf(abs(lz_p - lz_r)),
            "ess_reduce": nan_inf(abs(ess_p - ess_r) / ess_r)}


def look(x_prog, rnd_prog, x_ref, rnd_ref) -> dict:
    """Where the per-trajectory gaps lie: quantiles, maxima and the
    trajectories past 1e-2, for PERF.md's account of the widest gaps."""
    gx, gw = traj_gaps(x_prog, rnd_prog, x_ref, rnd_ref)
    qs = torch.tensor([0.5, 0.99, 0.999], dtype=torch.float64, device=gx.device)
    return {"x_quantiles": torch.quantile(gx, qs).tolist(), "x_max": float(gx.max()),
            "w_quantiles": torch.quantile(gw, qs).tolist(), "w_max": float(gw.max()),
            "x_over_1e-2": int((gx > 1e-2).sum()), "w_over_1e-2": int((gw > 1e-2).sum())}
