"""Time-conditioned control networks as nn.Modules (counterpart of
sde_sampler_lrds_tpu/models/mlp.py: AngleEncoding, TimeEmbed, FourierMLP,
DenseNet and the near-zero output init), plus ``load_flax_params`` to carry
a Flax parameter tree across.

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


class AngleEncoding(nn.Module):
    """x -> [sin x, cos x]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class TimeEmbed(nn.Module):
    """Sinusoidal time features (frequencies linspace 0.1..100 plus a
    learned phase) followed by a small MLP. ``zero_init_last`` gives the last
    layer the near-zero init with its bias centred on ``last_bias_val``
    (the JAX package's ``last_kernel_init=zero_init_kernel()``,
    ``last_bias_init=zero_init_bias(fan_in=channels, val=...)``)."""

    def __init__(self, dim_out: int, channels: int = 64, num_layers: int = 2,
                 activation: Callable = gelu_tanh,
                 compute_dtype: torch.dtype | None = None, zero_init_last: bool = False,
                 last_bias_val: float = 0.0):
        super().__init__()
        self.channels = channels
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.zero_init_last = zero_init_last
        self.last_bias_val = last_bias_val
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
        for layer in self.dense:
            _init_dense(layer, generator)
        _init_dense(self.out, generator, zero_init=self.zero_init_last,
                    bias_fan_in=self.channels)
        if self.zero_init_last:
            with torch.no_grad():
                self.out.bias.add_(self.last_bias_val)

    def forward(self, t: torch.Tensor, *args) -> torch.Tensor:
        """t of any shape -> (*t.shape, dim_out), in the compute dtype; a
        state argument (the control signature t, x) is ignored."""
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
                 zero_init: bool = False, compute_dtype: torch.dtype | None = None,
                 use_angle_encoding: bool = False):
        super().__init__()
        self.dim = dim
        self.dim_out = dim_out
        self.channels = channels
        self.num_layers = num_layers
        self.activation = activation
        self.zero_init = zero_init
        self.compute_dtype = compute_dtype
        self.use_angle_encoding = use_angle_encoding
        self.angle_encoding = AngleEncoding() if use_angle_encoding else None
        self.x_embed = nn.Linear(2 * dim if use_angle_encoding else dim, channels)
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
        xe = self.angle_encoding(x) if self.use_angle_encoding else x
        h = dense(self.x_embed, xe, dt) + self.time_embed(t)
        for layer in self.hidden:
            h = dense(layer, self.activation(h), dt)
        return dense(self.out, self.activation(h), dt).float()


class DenseNet(nn.Module):
    """Concatenative DenseNet over [t, x]: each layer's activations are
    appended to its input; ``zero_init`` gives the output layer the
    near-zero init. t broadcasts against x's batch shape as in FourierMLP."""

    def __init__(self, dim: int, arch=(64, 64), dim_out: int | None = None,
                 activation: Callable = gelu_tanh, use_angle_encoding: bool = False,
                 zero_init: bool = False, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.dim = dim
        self.arch = tuple(arch)
        self.dim_out = dim_out
        self.activation = activation
        self.use_angle_encoding = use_angle_encoding
        self.zero_init = zero_init
        self.compute_dtype = compute_dtype
        self.angle_encoding = AngleEncoding() if use_angle_encoding else None
        width = (dim + 1) * (2 if use_angle_encoding else 1)
        layers = []
        for w in self.arch:
            layers.append(nn.Linear(width, w))
            width += w
        self.dense = nn.ModuleList(layers)
        self.out = nn.Linear(width, dim_out or dim)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.dense:
            _init_dense(layer, generator)
        _init_dense(self.out, generator, zero_init=self.zero_init,
                    bias_fan_in=self.out.in_features)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = torch.broadcast_to(t.reshape(()) if t.numel() == 1 else t, x.shape[:-1])
        h = torch.cat([t[..., None], x], dim=-1)
        if self.use_angle_encoding:
            h = self.angle_encoding(h)
        dt = self.compute_dtype
        for layer in self.dense:
            h = torch.cat([h, self.activation(dense(layer, h, dt)).to(h.dtype)], dim=-1)
        return dense(self.out, h, dt).float()


def _broadcasts_to(shape, target) -> bool:
    try:
        return torch.broadcast_shapes(shape, target) == target
    except RuntimeError:
        return False


def _fill(layer: nn.Linear, tree: dict) -> None:
    """A Flax Dense ``{"kernel" (in, out), "bias"}`` into ``layer``."""
    kernel = np.array(tree["kernel"], np.float32)
    bias = np.array(tree["bias"], np.float32)
    if kernel.shape != (layer.in_features, layer.out_features):
        raise ValueError(f"kernel shape {kernel.shape} does not fit {layer}")
    layer.weight.copy_(torch.from_numpy(kernel.T))
    layer.bias.copy_(torch.from_numpy(bias))


def _fill_time_embed(te: TimeEmbed, p: dict) -> None:
    te.timestep_phase.copy_(torch.from_numpy(np.array(p["timestep_phase"], np.float32)))
    for i, layer in enumerate([*te.dense, te.out]):
        _fill(layer, p[f"Dense_{i}"])


def _fill_module(module: nn.Module, p: dict) -> None:
    from .reparam import ClippedCtrl

    if isinstance(module, ClippedCtrl):   # and ScoreCtrl, CancelDriftCtrl, LerpCtrl
        _fill_module(module.base_model, p["base_model"])
        if getattr(module, "score_model", None) is not None:
            _fill_module(module.score_model, p["score_model"])
    elif isinstance(module, FourierMLP):
        _fill(module.x_embed, p["Dense_0"])
        for i, layer in enumerate(module.hidden, start=1):
            _fill(layer, p[f"Dense_{i}"])
        _fill(module.out, p[f"Dense_{module.num_layers - 1}"])
        _fill_time_embed(module.time_embed, p["TimeEmbed_0"])
    elif isinstance(module, DenseNet):
        for i, layer in enumerate([*module.dense, module.out]):
            _fill(layer, p[f"Dense_{i}"])
    elif isinstance(module, TimeEmbed):
        _fill_time_embed(module, p)
    elif hasattr(module, "load_flax_params"):   # Unet, MNISTEnergy
        module.load_flax_params(p)
    else:
        raise TypeError(f"load_flax_params cannot fill a {type(module).__name__}")


def load_flax_params(ctrl: nn.Module, params: dict) -> nn.Module:
    """Fill a control from the JAX package's Flax parameter tree, given as
    nested dicts of numpy arrays (``{"params": {...}}`` or the inner dict):
    a FourierMLP (angle-encoded or not), a DenseNet, a TimeEmbed or a net
    with its own ``load_flax_params`` (the MNIST Unet, MNISTEnergy), alone or
    inside ClippedCtrl, ScoreCtrl, CancelDriftCtrl or LerpCtrl (their
    ``base_model`` and ``score_model``). A Flax ``kernel`` is (in, out);
    ``Linear.weight`` is (out, in)."""
    with torch.no_grad():
        _fill_module(ctrl, params.get("params", params))
    return ctrl
