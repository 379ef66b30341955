"""The 14×14 MNIST UNet control network (counterpart of
sde_sampler_lrds_tpu/models/mnist_unet.py): two resolutions (14 → 7),
residual blocks conditioned on time, single-head attention at 7×7, a
transposed-conv upsampling and the near-zero init of the output conv. The
interface is the flat (B, side²) one of every control net; inside, the
images are NCHW.

Where the Flax modules differ from torch's defaults, the port follows Flax:
conv kernels (kh, kw, in, out) become (out, in, kh, kw) weights; GroupNorm
has ε 1e-6 and min(16, C) groups; the attention applies no GroupNorm (the
reference's forward never did), its q, k, v come from one Dense reshaped to
(B, seq, heads, 3·d_k) and split on the last axis, and its softmax runs
over the keys; Flax's ``ConvTranspose(…, (4, 4), strides=(2, 2),
padding="SAME")`` convolves the stride-dilated input, padded by lax's
"SAME" rule for a transposed conv, with the kernel unflipped, which is
``conv_transpose2d`` of the flipped kernel at padding k − 1 − pad (see
``ConvTransposeSame``); dropout is never live (every JAX call is
deterministic), so it is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mlp import (INIT_WEIGHT_SCALE, TimeEmbed, _fill, _fill_time_embed, _init_dense,
                  _lecun_normal_)


def _init_conv(conv: nn.Module, generator, zero_init: bool = False,
               bias_fan_in: int | None = None) -> None:
    """Flax's conv init (lecun-normal kernel over kh·kw·in, zero bias), or
    ``zero_init_kernel`` / ``zero_init_bias(fan_in=bias_fan_in)``. Flax's
    ``zero_init_kernel`` reads the kernel's first axis as its fan-in, which
    for a (kh, kw, in, out) conv kernel is kh."""
    with torch.no_grad():
        if zero_init:
            bound = INIT_WEIGHT_SCALE / math.sqrt(conv.weight.shape[2])
            conv.weight.uniform_(-bound, bound, generator=generator)
            bbound = INIT_WEIGHT_SCALE / math.sqrt(bias_fan_in)
            conv.bias.uniform_(-bbound, bbound, generator=generator)
        else:
            _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            conv.bias.zero_()


def _fill_conv(conv: nn.Module, tree: dict) -> None:
    """A Flax conv {"kernel" (kh, kw, in, out), "bias"} into an (out, in,
    kh, kw) weight."""
    kernel = np.array(tree["kernel"], np.float32).transpose(3, 2, 0, 1)
    if kernel.shape != tuple(conv.weight.shape):
        raise ValueError(f"conv kernel {kernel.shape} does not fit {tuple(conv.weight.shape)}")
    conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel)))
    conv.bias.copy_(torch.from_numpy(np.array(tree["bias"], np.float32)))


def _fill_norm(norm: nn.GroupNorm, tree: dict) -> None:
    norm.weight.copy_(torch.from_numpy(np.array(tree["scale"], np.float32)))
    norm.bias.copy_(torch.from_numpy(np.array(tree["bias"], np.float32)))


def group_norm(channels: int, n_groups: int = 16) -> nn.GroupNorm:
    """Flax ``GroupNorm(num_groups=min(n_groups, C))`` (ε 1e-6)."""
    return nn.GroupNorm(min(n_groups, channels), channels, eps=1e-6)


def conv_transpose_same_padding(k: int, s: int) -> tuple[int, int]:
    """lax's "SAME" padding of a transposed conv of kernel k and stride s
    (``_conv_transpose_padding``): the padding (before, after) of the
    stride-dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


class ConvTransposeSame(nn.Module):
    """Flax ``nn.ConvTranspose(out, (k, k), strides=(s, s), padding="SAME")``
    (transpose_kernel False): the input dilated by s, padded by
    ``conv_transpose_same_padding`` and cross-correlated with the kernel as
    stored, giving s·H × s·W. The weight is kept in the conv layout (out,
    in, k, k); the forward is ``conv_transpose2d`` of its flip at padding
    k − 1 − pad."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 4, stride: int = 2):
        super().__init__()
        pad_a, pad_b = conv_transpose_same_padding(kernel, stride)
        if pad_a != pad_b:
            raise ValueError(f"kernel {kernel}, stride {stride}: uneven SAME padding")
        self.stride, self.padding = stride, kernel - 1 - pad_a
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.flip(self.weight, dims=(2, 3)).transpose(0, 1)
        return F.conv_transpose2d(x, w, self.bias, stride=self.stride, padding=self.padding)


class AttentionBlock(nn.Module):
    """Self-attention over the h·w tokens with a residual, no GroupNorm."""

    def __init__(self, n_channels: int, n_heads: int = 1, d_k: int | None = None):
        super().__init__()
        self.n_heads, self.d_k = n_heads, d_k or n_channels
        self.qkv = nn.Linear(n_channels, n_heads * self.d_k * 3)
        self.out = nn.Linear(n_heads * self.d_k, n_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)                            # (b, hw, c)
        qkv = self.qkv(seq).reshape(b, -1, self.n_heads, 3 * self.d_k).transpose(1, 2)
        q, k, v = torch.split(qkv, self.d_k, dim=-1)                  # (b, heads, hw, d_k)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.d_k**-0.5, dim=-1)
        res = (attn @ v).transpose(1, 2).reshape(b, -1, self.n_heads * self.d_k)
        res = self.out(res) + seq
        return res.transpose(1, 2).reshape(b, c, h, w)

    @torch.no_grad()
    def load_flax_params(self, p: dict) -> None:
        _fill(self.qkv, p["Dense_0"])
        _fill(self.out, p["Dense_1"])

    def reset_parameters(self, generator=None) -> None:
        _init_dense(self.qkv, generator)
        _init_dense(self.out, generator)


class ResidualBlock(nn.Module):
    """GroupNorm → SiLU → 3×3 conv, plus the time embedding's Dense(SiLU),
    then GroupNorm → SiLU → 3×3 conv, plus the input (a 1×1 conv where the
    channels change)."""

    def __init__(self, in_channels: int, out_channels: int, t_channels: int,
                 n_groups: int = 16):
        super().__init__()
        self.norm1 = group_norm(in_channels, n_groups)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time = nn.Linear(t_channels, out_channels)
        self.norm2 = group_norm(out_channels, n_groups)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time(F.silu(t_emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.shortcut is None else self.shortcut(x))

    @torch.no_grad()
    def load_flax_params(self, p: dict) -> None:
        _fill_norm(self.norm1, p["GroupNorm_0"])
        _fill_conv(self.conv1, p["Conv_0"])
        _fill(self.time, p["Dense_0"])
        _fill_norm(self.norm2, p["GroupNorm_1"])
        _fill_conv(self.conv2, p["Conv_1"])
        if self.shortcut is not None:
            _fill_conv(self.shortcut, p["Conv_2"])

    def reset_parameters(self, generator=None) -> None:
        for conv in (self.conv1, self.conv2, self.shortcut):
            if conv is not None:
                _init_conv(conv, generator)
        _init_dense(self.time, generator)
        for norm in (self.norm1, self.norm2):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)


class DownBlock(nn.Module):
    """A residual block, then attention where ``has_attn``."""

    def __init__(self, in_channels: int, out_channels: int, t_channels: int,
                 has_attn: bool = False):
        super().__init__()
        self.res = ResidualBlock(in_channels, out_channels, t_channels)
        self.attn = AttentionBlock(out_channels) if has_attn else None

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        x = self.res(x, t_emb)
        return x if self.attn is None else self.attn(x)

    @torch.no_grad()
    def load_flax_params(self, p: dict) -> None:
        self.res.load_flax_params(p["ResidualBlock_0"])
        if self.attn is not None:
            self.attn.load_flax_params(p["AttentionBlock_0"])

    def reset_parameters(self, generator=None) -> None:
        self.res.reset_parameters(generator)
        if self.attn is not None:
            self.attn.reset_parameters(generator)


class UpBlock(DownBlock):
    """As DownBlock, on the concatenation with the skip connection."""


class MiddleBlock(nn.Module):
    """Residual block, attention, residual block."""

    def __init__(self, n_channels: int, t_channels: int):
        super().__init__()
        self.res1 = ResidualBlock(n_channels, n_channels, t_channels)
        self.attn = AttentionBlock(n_channels)
        self.res2 = ResidualBlock(n_channels, n_channels, t_channels)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        return self.res2(self.attn(self.res1(x, t_emb)), t_emb)

    @torch.no_grad()
    def load_flax_params(self, p: dict) -> None:
        self.res1.load_flax_params(p["ResidualBlock_0"])
        self.attn.load_flax_params(p["AttentionBlock_0"])
        self.res2.load_flax_params(p["ResidualBlock_1"])

    def reset_parameters(self, generator=None) -> None:
        for block in (self.res1, self.attn, self.res2):
            block.reset_parameters(generator)


class Unet(nn.Module):
    """The 14×14 UNet: (t, x (..., side²)) → (..., side²), t one time or a
    shape that broadcasts against x.shape[:-1] (per-row times (B,), or
    per-step times (K, 1) for flat states (K, B, D)).
    ``rev_proj_channels`` deepens the output projection;
    ``init_last_layer_with_zeros`` gives its last conv the near-zero init."""

    def __init__(self, n_channels: int = 32, image_channels: int = 1,
                 rev_proj_channels=None, init_last_layer_with_zeros: bool = False,
                 side: int = 14):
        super().__init__()
        nc, tc = n_channels, 4 * n_channels
        self.side, self.image_channels = side, image_channels
        self.init_last_layer_with_zeros = init_last_layer_with_zeros
        self.time_embed = TimeEmbed(dim_out=tc, channels=nc, num_layers=2, activation=F.silu)
        self.conv_in = nn.Conv2d(image_channels, nc, 3, padding=1)
        self.down1 = DownBlock(nc, nc, tc)
        self.downsample = nn.Conv2d(nc, nc, 3, stride=2, padding=1)     # 14 → 7
        self.down2 = DownBlock(nc, 2 * nc, tc, has_attn=True)
        self.middle = MiddleBlock(2 * nc, tc)
        self.up1 = UpBlock(4 * nc, 2 * nc, tc, has_attn=True)
        self.upsample = ConvTransposeSame(2 * nc, 2 * nc)                 # 7 → 14
        self.up2 = UpBlock(3 * nc, nc, tc)
        channels = ([nc] + list(rev_proj_channels) + [image_channels]
                    if rev_proj_channels is not None else [nc, image_channels])
        self.proj_norms = nn.ModuleList([group_norm(c) for c in channels[:-1]])
        self.proj_convs = nn.ModuleList([nn.Conv2d(a, b, 3, padding=1)
                                         for a, b in zip(channels[:-1], channels[1:])])
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.time_embed.reset_parameters(generator)
        _init_conv(self.conv_in, generator)
        self.down1.reset_parameters(generator)
        _init_conv(self.downsample, generator)
        self.down2.reset_parameters(generator)
        self.middle.reset_parameters(generator)
        self.up1.reset_parameters(generator)
        _init_conv(self.upsample, generator)
        self.up2.reset_parameters(generator)
        for i, (norm, conv) in enumerate(zip(self.proj_norms, self.proj_convs)):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
            last = self.init_last_layer_with_zeros and i == len(self.proj_convs) - 1
            _init_conv(conv, generator, zero_init=last, bias_fan_in=9 * conv.in_channels)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        batch_shape = x.shape[:-1]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t_emb = self.time_embed(t.reshape(()) if t.numel() == 1 else t)
        t_emb = (t_emb.reshape(1, -1) if t.numel() == 1
                 else t_emb.expand(*batch_shape, t_emb.shape[-1]).reshape(-1, t_emb.shape[-1]))
        img = x.reshape(-1, self.side, self.side, self.image_channels).permute(0, 3, 1, 2)
        h = self.conv_in(img)
        h = skip1 = self.down1(h, t_emb)
        h = skip2 = self.down2(self.downsample(h), t_emb)
        h = self.middle(h, t_emb)
        h = self.up1(torch.cat([h, skip2], dim=1), t_emb)
        h = self.up2(torch.cat([self.upsample(h), skip1], dim=1), t_emb)
        for norm, conv in zip(self.proj_norms, self.proj_convs):
            h = conv(F.silu(norm(h)))
        return h.permute(0, 2, 3, 1).reshape(x.shape)

    def load_flax_params(self, params: dict) -> "Unet":
        """The JAX Unet's Flax tree (numpy arrays)."""
        p = params.get("params", params)
        with torch.no_grad():
            _fill_time_embed(self.time_embed, p["TimeEmbed_0"])
            _fill_conv(self.conv_in, p["Conv_0"])
            self.down1.load_flax_params(p["DownBlock_0"])
            _fill_conv(self.downsample, p["Conv_1"])
            self.down2.load_flax_params(p["DownBlock_1"])
            self.middle.load_flax_params(p["MiddleBlock_0"])
            self.up1.load_flax_params(p["UpBlock_0"])
            _fill_conv(self.upsample, p["ConvTranspose_0"])
            self.up2.load_flax_params(p["UpBlock_1"])
            for i, (norm, conv) in enumerate(zip(self.proj_norms, self.proj_convs)):
                _fill_norm(norm, p[f"GroupNorm_{i}"])
                _fill_conv(conv, p[f"Conv_{i + 2}"])
        return self
