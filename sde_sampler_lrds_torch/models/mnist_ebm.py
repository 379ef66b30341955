"""The small convolutional energy of the 14×14 MNIST EBM references
(counterpart of sde_sampler_lrds_tpu/models/mnist_ebm.py): three
time-conditioned conv stages, 14 → 7 → 3 → 1, giving an (B, 8·n_f) feature
vector, and ``MNISTEnergy``'s near-zero scalar head on it, for the 'sum'
tilt of ``GMMTiltedPotential`` (at init the tilted potential is the fitted
GMM). Images are NCHW inside; the interface is flat (B, side²).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import TimeEmbed, _fill, _fill_time_embed, _init_dense
from .mnist_unet import _fill_conv, _init_conv


class MNISTNet(nn.Module):
    """3×3 conv to n_f, then three 4×4 stride-2 convs (padding 1) to 2, 4
    and 8·n_f channels, each preceded by the SiLU of the features plus a
    TimeEmbed of their width (hidden width twice that, SiLU)."""

    def __init__(self, n_f: int = 14, side: int = 14):
        super().__init__()
        self.side = side
        self.conv_in = nn.Conv2d(1, n_f, 3, padding=1)
        widths = (n_f, 2 * n_f, 4 * n_f)
        self.embeds = nn.ModuleList([TimeEmbed(dim_out=w, channels=2 * w, num_layers=2,
                                               activation=F.silu) for w in widths])
        self.convs = nn.ModuleList([nn.Conv2d(w, 2 * w, 4, stride=2, padding=1)
                                    for w in widths])
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _init_conv(self.conv_in, generator)
        for embed, conv in zip(self.embeds, self.convs):
            embed.reset_parameters(generator)
            _init_conv(conv, generator)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = t.reshape(1) if t.numel() == 1 else t.reshape(-1)
        h = self.conv_in(x.reshape(-1, 1, self.side, self.side))
        for embed, conv in zip(self.embeds, self.convs):
            h = conv(F.silu(h + embed(t)[:, :, None, None]))
        return h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    @torch.no_grad()
    def load_flax_params(self, p: dict) -> "MNISTNet":
        _fill_conv(self.conv_in, p["Conv_0"])
        for i, (embed, conv) in enumerate(zip(self.embeds, self.convs)):
            _fill_time_embed(embed, p[f"TimeEmbed_{i}"])
            _fill_conv(conv, p[f"Conv_{i + 1}"])
        return self


class MNISTEnergy(nn.Module):
    """MNISTNet features → a scalar head with the near-zero init
    (``zero_init_kernel`` / ``zero_init_bias(fan_in=8·n_f)``): (t, x) →
    (B, 1). Use with ``tilt_type='sum'``."""

    def __init__(self, n_f: int = 14, side: int = 14):
        super().__init__()
        self.net = MNISTNet(n_f=n_f, side=side)
        self.head = nn.Linear(8 * n_f, 1)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.net.reset_parameters(generator)
        _init_dense(self.head, generator, zero_init=True, bias_fan_in=self.head.in_features)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.net(t, x))

    @torch.no_grad()
    def load_flax_params(self, params: dict) -> "MNISTEnergy":
        """The JAX MNISTEnergy's Flax tree ({"MNISTNet_0": …, "Dense_0": …})."""
        p = params.get("params", params)
        self.net.load_flax_params(p["MNISTNet_0"])
        _fill(self.head, p["Dense_0"])
        return self
