"""The MNIST NICE mixture target, plain, from the raw checkpoint files
under ``data/`` (Flax msgpack {meta, params} flows and the per-digit mean
images).

A flow maps a centred image v (B, 196) through additive couplings: coupling
i views v as (B, 98, 2) pairs, shifts column ``on`` by an MLP (ReLU hidden
layers) of the other column, with on = 0 when (mask_config + i) is odd and
1 otherwise; then z = v·e^{scale}, log p(v) = Σ log σ'(z) (logistic
latent) + Σ scale. The mixture over digits (0, 1) has weights 3:1; its
input x ∈ [−1, 1]^196 maps to u = (x + 1)/2, so
log ρ(x) = logsumexp_c(log w_c + log p_c(u − mean_c)) − 196·log 2.
Draws invert the flow from logistic latents, add the mean and map back."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .msgpack_reader import load
from .precision import Arith

DATA_DIR = Path(__file__).resolve().parents[2] / "data"


class Flow:
    def __init__(self, digit: int, device, dtype):
        raw = load(DATA_DIR / f"nice_label_{digit}.msgpack")
        meta, p = raw["meta"], raw["params"]
        p = p.get("params", p)
        as_t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device).to(dtype)
        self.mask_config = int(meta["mask_config"])
        if meta["latent"] != "logistic" or meta["use_sigmoid"] or meta["use_dequant"]:
            raise ValueError("the reference covers the logistic, sigmoid-free flows")
        self.couplings = []
        for i in range(int(meta["coupling"])):
            layers, j = [], 0
            while f"Dense_{j}" in p[f"couplings_{i}"]:
                d = p[f"couplings_{i}"][f"Dense_{j}"]
                layers.append((as_t(d["kernel"]), as_t(d["bias"])))   # kernel (in, out)
                j += 1
            self.couplings.append(layers)
        self.scale = as_t(p["scale"]).reshape(1, -1)
        mean = np.load(DATA_DIR / f"mnist_mean_label_{digit}.npy").reshape(1, -1)
        self.mean = (torch.zeros(1, mean.shape[1]) if meta.get("skip_centering", False)
                     else torch.as_tensor(mean, dtype=torch.float32)).to(device).to(dtype)

    def _shift(self, layers, off, ar: Arith):
        h = off
        for w, b in layers[:-1]:
            h = torch.relu(ar.mm(h, w) + b)
        w, b = layers[-1]
        return ar.mm(h, w) + b

    def _couple(self, i, v, ar: Arith, reverse: bool):
        b, w = v.shape
        vr = v.reshape(b, w // 2, 2)
        mc = (self.mask_config + i) % 2
        on_col = 0 if mc else 1
        on, off = vr[:, :, on_col], vr[:, :, 1 - on_col]
        shift = self._shift(self.couplings[i], off, ar)
        on = on - shift if reverse else on + shift
        cols = (on, off) if mc else (off, on)
        return torch.stack(cols, dim=2).reshape(b, w)

    def log_prob(self, v, ar: Arith):
        for i in range(len(self.couplings)):
            v = self._couple(i, v, ar, reverse=False)
        z = v * torch.exp(self.scale)
        return torch.sum(-(F.softplus(z) + F.softplus(-z)), dim=1) + torch.sum(self.scale)

    def sample(self, generator: torch.Generator, n: int, ar: Arith):
        d = self.scale.shape[1]
        # the logistic latent's logit in float64: a uniform within 2^-25 of 1
        # rounds to 1 in float32, and its logit, +inf, makes the whole draw NaN
        u = torch.rand((n, d), generator=generator, device=self.scale.device,
                       dtype=torch.float64).clamp_min(1e-20)
        v = (torch.log(u) - torch.log1p(-u)).to(ar.dtype) * torch.exp(-self.scale)
        for i in reversed(range(len(self.couplings))):
            v = self._couple(i, v, ar, reverse=True)
        return v + self.mean


class MixtureTarget:
    """log ρ on [−1, 1]^196 and exact draws, for ``digits`` with 3:1
    alternating weights."""

    def __init__(self, digits, device, ar: Arith):
        self.ar = ar
        self.flows = [Flow(d, device, ar.dtype) for d in sorted(digits)]
        w = np.ones(len(self.flows))
        w[::2] = 3.0
        self.weights = w / w.sum()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        u = (x.to(self.ar.dtype) + 1.0) / 2.0
        lps = torch.stack([f.log_prob(u - f.mean, self.ar) + math.log(wc)
                           for f, wc in zip(self.flows, self.weights)])
        return torch.logsumexp(lps, dim=0) - x.shape[-1] * math.log(2.0)

    def component_draws(self, generator: torch.Generator, n: int):
        """Per component, its share of ``n`` exact draws, mapped to [−1, 1]."""
        counts = torch.multinomial(torch.as_tensor(self.weights, dtype=torch.float32,
                                                   device=generator.device),
                                   n, replacement=True, generator=generator)
        counts = torch.bincount(counts, minlength=len(self.flows)).tolist()
        return [2.0 * (f.sample(generator, m, self.ar) - 0.5)
                for f, m in zip(self.flows, counts)]


def fit_reference(target: MixtureTarget, generator: torch.Generator, n: int, jitter: float,
                  reg: float = 1e-6):
    """The full-covariance GMM both sides take as the RDS reference:
    (weights, means, (eig, P)), each component's weight, mean and covariance
    (+ reg·I) from the exact draws it made, each draw jittered by
    N(0, jitter²) as MALA's steps jitter the experiment script's dataset; the
    covariance is handed over as its eigendecomposition P diag(eig) Pᵀ, taken
    in float64 on the host, all held in float32."""
    draws = target.component_draws(generator, n)
    weights = torch.tensor([x.shape[0] / n for x in draws], dtype=torch.float32)
    means, covs = [], []
    for x in draws:
        x = x.double() + jitter * torch.randn(x.shape, generator=generator, device=x.device,
                                              dtype=torch.float64)
        m = x.mean(0)
        c = (x - m).T @ (x - m) / x.shape[0]
        covs.append(c + reg * torch.eye(x.shape[1], dtype=torch.float64, device=x.device))
        means.append(m)
    dev = draws[0].device
    covs = torch.stack(covs)
    if not bool(torch.isfinite(covs).all()):
        raise ValueError("the GMM's fit draws are not all finite")
    eig, p = torch.linalg.eigh(covs.cpu())
    return (weights.to(dev), torch.stack(means).float(),
            (eig.float().to(dev), p.float().to(dev)))
