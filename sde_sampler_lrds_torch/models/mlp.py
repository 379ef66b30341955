"""Time-conditioned control networks as nn.Modules (counterpart of
sde_sampler_lrds_tpu/models/mlp.py: TimeEmbed, FourierMLP and the near-zero
output init), plus ``load_flax_params`` to carry a Flax parameter tree across.

Two numeric details follow the Flax modules exactly: the activation is the
tanh form of GELU (Flax ``nn.gelu`` defaults to it), and the time features
are [sin ‖ cos] of ``linspace(0.1, 100, H)·t + phase``.

``compute_dtype=torch.bfloat16`` follows Flax ``nn.Dense(dtype=bfloat16)``:
the parameters stay float32, each layer casts its input, kernel and bias to
bf16 and rounds the product and then the bias add to bf16 (``dense`` below,
not ``F.linear``, which would fuse the bias into the product and round once);
the activations and the sum with the time embedding run on bf16 values, and
FourierMLP casts its output back to float32. Autograd flows through the
casts, so the parameters' gradients are float32.

The near-zero last-layer init is load-bearing: the control must start ≈ 0 so
early trajectories follow the reference process.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INIT_WEIGHT_SCALE = 1e-6


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form (Flax ``nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer(x)``, or with a compute dtype Flax Dense's (x·W + b) with x,
    W and b cast to it and the product and the sum each rounded to it."""
    if dtype is None:
        return layer(x)
    return (x.to(dtype) @ layer.weight.to(dtype).t()) + layer.bias.to(dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """Flax's default Dense kernel init: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _init_dense(layer: nn.Linear, generator, zero_init: bool = False,
                bias_fan_in: int | None = None) -> None:
    """Flax Dense init (lecun-normal kernel, zero bias), or the near-zero
    Uniform(±s/√fan_in) init of ``zero_init_kernel`` / ``zero_init_bias``."""
    fan_in = layer.in_features
    with torch.no_grad():
        if zero_init:
            bound = INIT_WEIGHT_SCALE / math.sqrt(max(fan_in, 1))
            layer.weight.uniform_(-bound, bound, generator=generator)
            f = bias_fan_in if bias_fan_in is not None else max(layer.out_features, 1)
            bbound = INIT_WEIGHT_SCALE / math.sqrt(f)
            layer.bias.uniform_(-bbound, bbound, generator=generator)
        else:
            _lecun_normal_(layer.weight, fan_in, generator)
            layer.bias.zero_()


class TimeEmbed(nn.Module):
    """Sinusoidal time features (frequencies linspace 0.1..100 plus a
    learned phase) followed by a small MLP."""

    def __init__(self, dim_out: int, channels: int = 64, num_layers: int = 2,
                 activation: Callable = gelu_tanh,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.channels = channels
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.register_buffer(
            "coeff", torch.linspace(0.1, 100.0, channels, dtype=torch.float32)[None, :])
        self.timestep_phase = nn.Parameter(torch.zeros(1, channels))
        self.dense = nn.ModuleList(
            [nn.Linear(2 * channels, channels)]
            + [nn.Linear(channels, channels) for _ in range(num_layers - 2)])
        self.out = nn.Linear(channels, dim_out)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.timestep_phase.normal_(0.0, 1.0, generator=generator)
        for layer in [*self.dense, self.out]:
            _init_dense(layer, generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t of any shape -> (*t.shape, dim_out), in the compute dtype."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.coeff.device)
        ang = self.coeff * t.reshape(-1, 1) + self.timestep_phase
        embed = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        dt = self.compute_dtype
        for layer in self.dense:
            embed = self.activation(dense(layer, embed, dt))
        return dense(self.out, embed, dt).reshape(*t.shape, -1)


class FourierMLP(nn.Module):
    """x-embedding + t-embedding summed into a residual-free MLP;
    ``zero_init`` turns on the near-zero output init. ``num_layers`` counts
    the x-embedding and output layers, so there are num_layers - 2 hidden
    layers. ``compute_dtype`` (None or torch.bfloat16) is the layers'
    compute dtype; the output is float32 either way."""

    def __init__(self, dim: int, dim_out: int | None = None, channels: int = 64,
                 num_layers: int = 4, activation: Callable = gelu_tanh,
                 zero_init: bool = False, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.dim = dim
        self.dim_out = dim_out
        self.channels = channels
        self.num_layers = num_layers
        self.activation = activation
        self.zero_init = zero_init
        self.compute_dtype = compute_dtype
        self.x_embed = nn.Linear(dim, channels)
        self.time_embed = TimeEmbed(dim_out=channels, channels=channels,
                                    activation=activation, compute_dtype=compute_dtype)
        self.hidden = nn.ModuleList(
            [nn.Linear(channels, channels) for _ in range(num_layers - 2)])
        self.out = nn.Linear(channels, dim_out or dim)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _init_dense(self.x_embed, generator)
        self.time_embed.reset_parameters(generator)
        for layer in self.hidden:
            _init_dense(layer, generator)
        _init_dense(self.out, generator, zero_init=self.zero_init,
                    bias_fan_in=self.channels)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        """x (..., D); t holds one time (the batch-1 branch: the time MLP runs
        once and broadcasts) or a shape that broadcasts against
        x.shape[:-1] — per-row times (B,) for x (B, D), or per-step times
        (K, 1) for flat states x (K, B, D)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.numel() == 1:
            t = t.reshape(())
        elif not _broadcasts_to(t.shape, x.shape[:-1]):
            raise ValueError(f"time shape {tuple(t.shape)} does not broadcast "
                             f"against x batch shape {tuple(x.shape[:-1])}")
        dt = self.compute_dtype
        h = dense(self.x_embed, x, dt) + self.time_embed(t)
        for layer in self.hidden:
            h = dense(layer, self.activation(h), dt)
        return dense(self.out, self.activation(h), dt).float()


def _broadcasts_to(shape, target) -> bool:
    try:
        return torch.broadcast_shapes(shape, target) == target
    except RuntimeError:
        return False


def load_flax_params(ctrl: nn.Module, params: dict) -> nn.Module:
    """Fill a FourierMLP (optionally inside ClippedCtrl) from the Flax param
    tree given as nested dicts of numpy arrays:
    ``{"params": {"base_model": {"Dense_i": {"kernel", "bias"},
    "TimeEmbed_0": {"timestep_phase", "Dense_0", "Dense_1"}}}}``.
    A Flax ``kernel`` is (in, out); ``Linear.weight`` is (out, in)."""
    from .reparam import ClippedCtrl

    p = params.get("params", params)
    base = ctrl
    if isinstance(ctrl, ClippedCtrl):
        base = ctrl.base_model
        p = p["base_model"]
    if not isinstance(base, FourierMLP):
        raise TypeError(f"load_flax_params takes a FourierMLP, got {type(base).__name__}")

    def fill(layer: nn.Linear, tree: dict) -> None:
        kernel = np.array(tree["kernel"], np.float32)
        bias = np.array(tree["bias"], np.float32)
        if kernel.shape != (layer.in_features, layer.out_features):
            raise ValueError(f"kernel shape {kernel.shape} does not fit {layer}")
        layer.weight.copy_(torch.from_numpy(kernel.T))
        layer.bias.copy_(torch.from_numpy(bias))

    n = base.num_layers
    with torch.no_grad():
        fill(base.x_embed, p["Dense_0"])
        for i, layer in enumerate(base.hidden, start=1):
            fill(layer, p[f"Dense_{i}"])
        fill(base.out, p[f"Dense_{n - 1}"])
        te, te_p = base.time_embed, p["TimeEmbed_0"]
        te.timestep_phase.copy_(torch.from_numpy(
            np.array(te_p["timestep_phase"], np.float32)))
        layers = [*te.dense, te.out]
        for i, layer in enumerate(layers):
            fill(layer, te_p[f"Dense_{i}"])
    return ctrl
