"""The control's weights, made by the benchmark from the seed on the device
in one draw, and handed to the program and to the reference alike.

Every matrix or convolution kernel is N(0, 1/fan_in) (fan_in: all its axes
but the first), a bias 0.1·N(0, 1), a GroupNorm scale 1 + 0.1·N(0, 1),
TimeEmbed's phase N(0, 1); the output layer's weights and bias are scaled
by ``last_scale``, so the control is neither zero (as the near-zero init
would leave it) nor larger than a trained one."""
from __future__ import annotations

import math

import torch


def draw(shapes: dict, generator: torch.Generator, last: tuple, last_scale: float) -> dict:
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator, device=generator.device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].reshape(shape)
        off += n
        if name.endswith("timestep_phase"):
            pass
        elif len(shape) >= 2:
            v = v / math.sqrt(math.prod(shape[1:]))
        elif "norm" in name and name.endswith(".weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        if name in last:
            v = v * last_scale
        out[name] = v.contiguous()
    return out


def fourier_mlp_shapes(dim: int, channels: int, num_layers: int) -> dict:
    """FourierMLP's parameter shapes by name (Linear weights (out, in))."""
    h = channels
    shapes = {"x_embed.weight": (h, dim), "x_embed.bias": (h,),
              "time_embed.timestep_phase": (1, h),
              "time_embed.dense.0.weight": (h, 2 * h), "time_embed.dense.0.bias": (h,),
              "time_embed.out.weight": (h, h), "time_embed.out.bias": (h,)}
    for i in range(num_layers - 2):
        shapes.update({f"hidden.{i}.weight": (h, h), f"hidden.{i}.bias": (h,)})
    shapes.update({"out.weight": (dim, h), "out.bias": (dim,)})
    return shapes


def unet_shapes(nc: int = 16) -> dict:
    """The 14×14 UNet's parameter shapes by name, with ``nc`` channels."""
    tc = 4 * nc
    shapes = {"time_embed.timestep_phase": (1, nc), "time_embed.dense.0.weight": (nc, 2 * nc),
              "time_embed.dense.0.bias": (nc,), "time_embed.out.weight": (tc, nc),
              "time_embed.out.bias": (tc,), "conv_in.weight": (nc, 1, 3, 3), "conv_in.bias": (nc,),
              "downsample.weight": (nc, nc, 3, 3), "downsample.bias": (nc,),
              "upsample.weight": (2 * nc, 2 * nc, 4, 4), "upsample.bias": (2 * nc,),
              "proj_norms.0.weight": (nc,), "proj_norms.0.bias": (nc,),
              "proj_convs.0.weight": (1, nc, 3, 3), "proj_convs.0.bias": (1,)}

    def res(name, cin, cout):
        shapes.update({f"{name}.norm1.weight": (cin,), f"{name}.norm1.bias": (cin,),
                       f"{name}.conv1.weight": (cout, cin, 3, 3), f"{name}.conv1.bias": (cout,),
                       f"{name}.time.weight": (cout, tc), f"{name}.time.bias": (cout,),
                       f"{name}.norm2.weight": (cout,), f"{name}.norm2.bias": (cout,),
                       f"{name}.conv2.weight": (cout, cout, 3, 3), f"{name}.conv2.bias": (cout,)})
        if cin != cout:
            shapes.update({f"{name}.shortcut.weight": (cout, cin, 1, 1),
                           f"{name}.shortcut.bias": (cout,)})

    def attn(name, c):
        shapes.update({f"{name}.qkv.weight": (3 * c, c), f"{name}.qkv.bias": (3 * c,),
                       f"{name}.out.weight": (c, c), f"{name}.out.bias": (c,)})

    res("down1.res", nc, nc)
    res("down2.res", nc, 2 * nc)
    attn("down2.attn", 2 * nc)
    res("middle.res1", 2 * nc, 2 * nc)
    attn("middle.attn", 2 * nc)
    res("middle.res2", 2 * nc, 2 * nc)
    res("up1.res", 4 * nc, 2 * nc)
    attn("up1.attn", 2 * nc)
    res("up2.res", 3 * nc, nc)
    return shapes


@torch.no_grad()
def load_into(module: torch.nn.Module, W: dict) -> None:
    """Copy ``W`` into ``module``'s parameters in place; the names and
    shapes have to match the module's exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(W):
        raise ValueError(f"weights {sorted(set(W) ^ set(params))} do not match the module's")
    for name, p in params.items():
        if tuple(p.shape) != tuple(W[name].shape):
            raise ValueError(f"{name}: {tuple(W[name].shape)} for {tuple(p.shape)}")
        p.copy_(W[name])
