"""NICE normalizing-flow targets on 14×14 MNIST (counterpart of
sde_sampler_lrds_tpu/targets/nice.py): additive coupling layers over the
even / odd interleaved halves, a diagonal log-scaling layer, optional
dequantization and stabilized sigmoid transforms, a logistic or normal
latent. ``Nice`` wraps a trained flow as a Target; ``MixtureNice`` mixes
per-digit flows with 3:1 alternating weights and scores samples by digit
classification (the mode metrics).

The checkpoints are the JAX package's Flax msgpack files ({meta, params}),
read and written by the port's own msgpack code (``utils/flax_msgpack.py``);
``NiceModel.init_flax_`` draws a flow's first parameters by Flax's law, for
training one from scratch (``scripts/train_nice.py``).
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import flax_msgpack
from ..utils.common import resolve_device
from .base import ModeMetrics, Target

DATA_DIR = Path(__file__).parents[2] / "data"
_TINY, _EPS = 1.17549e-38, 1.19209e-07
# the standard deviation of a unit normal truncated to (-2, 2): Flax's
# variance_scaling divides by it, so a truncated draw has the variance asked
_TRUNC_STD = 0.87962566103423978


def logistic_log_prob(z: torch.Tensor) -> torch.Tensor:
    return -(F.softplus(z) + F.softplus(-z))


def logistic_sample(generator: torch.Generator, shape: tuple, device=None,
                    eps: float = 1e-20) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device) * (1.0 - 2 * eps) + eps
    return torch.log(u) - torch.log1p(-u)


class Coupling(nn.Module):
    """Additive coupling over the even / odd interleave of x (B, W): the
    (B, W/2, 2) view's column ``mask_config`` is shifted by an MLP of the
    other (``hidden`` ReLU layers of ``mid_dim``)."""

    def __init__(self, in_out_dim: int, mid_dim: int, hidden: int, mask_config: int):
        super().__init__()
        self.mask_config = mask_config
        self.dense = nn.ModuleList(
            [nn.Linear(in_out_dim // 2, mid_dim)]
            + [nn.Linear(mid_dim, mid_dim) for _ in range(hidden - 1)]
            + [nn.Linear(mid_dim, in_out_dim // 2)])

    def _shift(self, off: torch.Tensor) -> torch.Tensor:
        h = off
        for layer in self.dense[:-1]:
            h = torch.relu(layer(h))
        return self.dense[-1](h)

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        b, w = x.shape
        xr = x.reshape(b, w // 2, 2)
        on_col = 0 if self.mask_config else 1
        on, off = xr[:, :, on_col], xr[:, :, 1 - on_col]
        shift = self._shift(off)
        on = on - shift if reverse else on + shift
        cols = (on, off) if self.mask_config else (off, on)
        return torch.stack(cols, dim=2).reshape(b, w)


class NiceModel(nn.Module):
    """The NICE flow: ``f`` (data → latent, with its log-determinant), ``g``
    (latent → data) and ``log_prob``. The checkpoints' hyperparameters are
    its constructor's arguments."""

    def __init__(self, coupling: int = 4, in_out_dim: int = 196, mid_dim: int = 1000,
                 hidden: int = 5, mask_config: int = 1, latent: str = "logistic",
                 use_dequant: bool = False, use_sigmoid: bool = False,
                 alpha_sigmoid: float = 1e-5, quants: float = 256.0):
        super().__init__()
        self.in_out_dim = in_out_dim
        self.latent = latent
        self.use_dequant = use_dequant
        self.use_sigmoid = use_sigmoid
        self.alpha_sigmoid = alpha_sigmoid
        self.quants = quants
        self.couplings = nn.ModuleList(
            [Coupling(in_out_dim, mid_dim, hidden, (mask_config + i) % 2)
             for i in range(coupling)])
        self.scale = nn.Parameter(torch.zeros(1, in_out_dim))

    # -- elementwise transforms --------------------------------------------
    def _sigmoid_fwd(self, x):
        alpha = self.alpha_sigmoid
        x = x * (1.0 - alpha) + 0.5 * alpha
        log_det = math.log1p(-alpha) * x.shape[-1]
        x = torch.clamp(x, _TINY, 1.0 - _EPS)
        log_det = log_det - torch.sum(torch.log(x) + torch.log1p(-x), dim=-1)
        return torch.log(x) - torch.log1p(-x), log_det

    def _sigmoid_rev(self, x):
        alpha = self.alpha_sigmoid
        x = torch.clamp(torch.sigmoid(x), _TINY, 1.0 - _EPS)
        return (x - 0.5 * alpha) / (1.0 - alpha)

    def _dequant_fwd(self, x, uniforms):
        q = self.quants
        return (x * (q - 1.0) + uniforms) / q, -math.log1p(1.0 / (q - 1.0)) * x.shape[-1]

    def _dequant_rev(self, x):
        q = self.quants
        return torch.clamp(torch.floor(x * q), 0, q - 1) / (q - 1.0)

    # -- flow directions -----------------------------------------------------
    def f(self, x: torch.Tensor, generator: torch.Generator | None = None,
          dequant_uniforms: torch.Tensor | None = None):
        """(z, log|det ∂z/∂x|); dequantization draws its uniforms from
        ``generator`` unless ``dequant_uniforms`` are fed."""
        log_det = torch.zeros(x.shape[0], device=x.device)
        if self.use_dequant:
            if dequant_uniforms is None:
                if generator is None:
                    raise ValueError("Dequantization requires a generator.")
                dequant_uniforms = torch.rand(x.shape, generator=generator, device=x.device)
            x, ld = self._dequant_fwd(x, dequant_uniforms)
            log_det = log_det + ld
        if self.use_sigmoid:
            x, ld = self._sigmoid_fwd(x)
            log_det = log_det + ld
        for c in self.couplings:
            x = c(x)
        return x * torch.exp(self.scale), log_det + torch.sum(self.scale)

    def g(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.exp(-self.scale)
        for c in reversed(self.couplings):
            x = c(x, reverse=True)
        if self.use_sigmoid:
            x = self._sigmoid_rev(x)
        if self.use_dequant:
            x = self._dequant_rev(x)
        return x

    def log_prob(self, x: torch.Tensor, generator: torch.Generator | None = None,
                 dequant_uniforms: torch.Tensor | None = None) -> torch.Tensor:
        z, log_det = self.f(x, generator, dequant_uniforms)
        if self.latent == "normal":
            lp = -0.5 * (z**2 + math.log(2 * math.pi))
        else:
            lp = logistic_log_prob(z)
        return torch.sum(lp, dim=1) + log_det

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob(x)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "NiceModel":
        """Flax's initialisation of the JAX NiceModel, drawn from
        ``generator`` (on the parameters' device): each Dense kernel from
        ``lecun_normal`` (a normal truncated to ±2 of its scale, scaled to
        variance 1/fan_in), zero biases, a zero ``scale``."""
        for c in self.couplings:
            for layer in c.dense:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                layer.bias.zero_()
        self.scale.zero_()
        return self

    def flax_params(self) -> dict:
        """The JAX NiceModel's Flax tree of this flow, numpy float32 with the
        Dense kernels as (in, out): the inverse of ``load_flax_params``."""
        def arr(t):
            return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)

        p = {f"couplings_{i}": {f"Dense_{j}": {"kernel": arr(layer.weight.T),
                                               "bias": arr(layer.bias)}
                                for j, layer in enumerate(c.dense)}
             for i, c in enumerate(self.couplings)}
        p["scale"] = arr(self.scale)
        return {"params": p}

    def load_flax_params(self, params: dict) -> "NiceModel":
        """The JAX NiceModel's Flax tree ({"params": {"couplings_i": {"Dense_j":
        …}, "scale"}}, numpy arrays)."""
        from ..models.mlp import _fill

        p = params.get("params", params)
        with torch.no_grad():
            self.scale.copy_(torch.from_numpy(np.array(p["scale"], np.float32)))
            for i, c in enumerate(self.couplings):
                for j, layer in enumerate(c.dense):
                    _fill(layer, p[f"couplings_{i}"][f"Dense_{j}"])
        return self


def load_nice_checkpoint(path: str | Path, device=None):
    """(meta with its ``skip_centering`` flag, the NiceModel with the
    checkpoint's parameters) from a Flax msgpack {meta, params} file."""
    data = flax_msgpack.load(path)
    meta = {k: (v.item() if hasattr(v, "item") else v) for k, v in data["meta"].items()}
    model = NiceModel(**{k: v for k, v in meta.items() if k != "skip_centering"})
    model.load_flax_params(data["params"])
    return meta, model.to(resolve_device(device))


def save_nice_checkpoint(path: str | Path, meta: dict, model: NiceModel) -> None:
    """The JAX package's NICE checkpoint, {meta, params}, of ``model``: the
    same bytes ``sde_sampler_lrds_tpu.targets.nice.save_nice_checkpoint``
    writes for the same meta and parameters."""
    flax_msgpack.save(path, {"meta": dict(meta), "params": model.flax_params()})


class Nice(Target):
    """A trained NICE flow on 14×14 MNIST as a sampling target, from its
    checkpoint (or a NiceModel); the data mean ``mean_data_path`` is
    subtracted before the flow unless the checkpoint says ``skip_centering``."""

    def __init__(self, checkpoint: str | Path | None = None, model: NiceModel | None = None,
                 mean_data_path: str | Path = DATA_DIR / "mnist_mean_14.npy", dim: int = 196,
                 log_norm_const: float = 0.0, n_reference_samples: int = int(1e6),
                 device=None, **kwargs):
        super().__init__(dim=dim, log_norm_const=log_norm_const,
                         n_reference_samples=n_reference_samples, device=device, **kwargs)
        self.shape = (14, 14)
        if dim != math.prod(self.shape):
            raise ValueError(f"Dimension is {dim} but needs to be 196.")
        if (checkpoint is None) == (model is None):
            raise ValueError("Nice takes a checkpoint path or a model, one of them.")
        self.mean = torch.as_tensor(np.load(mean_data_path).reshape(1, dim),
                                    dtype=torch.float32, device=self.device)
        if model is None:
            meta, model = load_nice_checkpoint(checkpoint, device=self.device)
            if meta.get("skip_centering", False):
                self.mean = torch.zeros_like(self.mean)
        self.model = model.to(self.device)
        for p in self.model.parameters():
            p.requires_grad_(False)

    def log_prob_flow(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.log_prob(x)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob_flow(x.reshape(-1, self.dim)).reshape(x.shape[:-1]) \
            + self.log_norm_const

    def sample_latent(self, generator: torch.Generator, n: int) -> torch.Tensor:
        if self.model.latent == "normal":
            return torch.randn((n, self.dim), generator=generator, device=self.device)
        return logistic_sample(generator, (n, self.dim), device=self.device)

    @torch.no_grad()
    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        n = math.prod(shape) if shape else 1
        return self.model.g(self.sample_latent(generator, n)).reshape(*shape, self.dim)


class MixtureNice(ModeMetrics, Target):
    """Mixture of per-digit NICE flows: weights 3:1 alternating over the
    sorted digits (equal with ``equilibrated``), the data mapped to [−1, 1]
    with ``normalize`` (u = (x + 1)/2, hence −d·log 2), and the digit
    classification of samples (the mode metrics)."""

    def __init__(self, equilibrated: bool = False, normalize: bool = True,
                 digits=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9), nice_dists=None, checkpoints=None,
                 means_data_path=None, local_minimums=None, dim: int = 196,
                 log_norm_const: float = 0.0, n_reference_samples: int = 2048,
                 device=None, **kwargs):
        super().__init__(dim=dim, log_norm_const=log_norm_const,
                         n_reference_samples=n_reference_samples, device=device, **kwargs)
        self.digits = sorted(tuple(digits))
        self.n_digits = self.n_mixtures = len(self.digits)
        self.normalize = normalize
        if nice_dists is not None:
            self.nice_dists = list(nice_dists)
        else:
            if checkpoints is None:
                checkpoints = [DATA_DIR / f"nice_label_{d}.msgpack" for d in self.digits]
            if means_data_path is None:
                means_data_path = [DATA_DIR / f"mnist_mean_label_{d}.npy" for d in self.digits]
            self.nice_dists = [Nice(checkpoint=c, mean_data_path=m, dim=dim, device=self.device)
                               for c, m in zip(checkpoints, means_data_path)]
        if equilibrated:
            w = torch.ones(self.n_digits) / self.n_digits
        else:
            w = np.ones(self.n_digits)
            w[::2] = 3.0
            w = torch.as_tensor(w / w.sum(), dtype=torch.float32)
        self.mixture_weights = self._probs = w.to(self.device)
        self._log_weights = torch.log(self.mixture_weights)[:, None]
        if local_minimums is not None:
            self.local_minimums = torch.as_tensor(local_minimums, device=self.device)
        else:
            lm_path = DATA_DIR / "x_min_nf_mnist.npy"
            self.local_minimums = (torch.as_tensor(np.load(lm_path), device=self.device)[
                torch.as_tensor(self.digits)] if lm_path.exists() else None)

    def _maybe_unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x + 1.0) / 2.0 if self.normalize else x

    def _component_log_probs(self, x: torch.Tensor) -> torch.Tensor:
        """(K, B) per-flow log-probs at the unnormalized, per-flow-centred x."""
        u = self._maybe_unnormalize(x)
        return torch.stack([d.log_prob_flow(u - d.mean) for d in self.nice_dists], dim=0)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, self.dim)
        out = torch.logsumexp(self._component_log_probs(flat) + self._log_weights, dim=0)
        if self.normalize:
            out = out - x.shape[-1] * math.log(2.0)
        return out.reshape(x.shape[:-1])

    def log_prob_and_score(self, x: torch.Tensor):
        """(unnorm_log_prob, score) from one pass of the flows: the score is
        Σ_k softmax_k(log w_k + log p_k(u)) ∇_u log p_k(u), over 2 with
        ``normalize``, the per-flow gradients by autograd in one backward
        pass over a copy of u a flow."""
        flat = x.reshape(-1, self.dim)
        u = self._maybe_unnormalize(flat).detach()
        with torch.enable_grad():
            us = u.expand(self.n_digits, *u.shape).clone().requires_grad_(True)
            lps = torch.stack([d.log_prob_flow(us[k] - d.mean)
                               for k, d in enumerate(self.nice_dists)], dim=0)
            (grads,) = torch.autograd.grad(lps.sum(), us)
        logits = lps.detach() + self._log_weights
        grad = torch.sum(torch.softmax(logits, dim=0)[..., None] * grads, dim=0)
        lp = torch.logsumexp(logits, dim=0)
        if self.normalize:
            grad = grad / 2.0
            lp = lp - self.dim * math.log(2.0)
        return lp.reshape(x.shape[:-1]), grad.reshape(x.shape)

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_prob_and_score(x)[1]

    @torch.no_grad()
    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        """A digit by its weight, then a draw of every flow (mean added) and
        the chosen one kept, mapped to [−1, 1] with ``normalize``."""
        n = math.prod(shape) if shape else 1
        idx = torch.multinomial(self.mixture_weights, n, replacement=True, generator=generator)
        all_samples = torch.stack([d.sample(generator, (n,)) + d.mean for d in self.nice_dists])
        out = all_samples[idx, torch.arange(n, device=self.device)]
        if self.normalize:
            out = 2.0 * (out - 0.5)
        return out.reshape(*shape, self.dim)

    # -- digit-classification mode metrics ------------------------------------
    def has_entropy(self) -> bool:
        return True

    @torch.no_grad()
    def get_classes(self, samples: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self._component_log_probs(samples), dim=0)

    def compute_mode_count(self, samples: torch.Tensor) -> torch.Tensor:
        return torch.bincount(self.get_classes(samples), minlength=self.n_digits).float()

    def compute_mode_weight(self, samples: torch.Tensor) -> torch.Tensor:
        if self.n_digits == 2:
            counts = self.compute_mode_count(samples)
            return 100.0 * counts[0] / counts.sum()
        return torch.zeros(())

    def compute_stats_sampling(self, generator: torch.Generator, return_samples: bool = False):
        samples = super().compute_stats_sampling(generator, return_samples=True)
        self.expectations["mode_weight"] = float(self.compute_mode_weight(samples))
        if return_samples:
            return samples
