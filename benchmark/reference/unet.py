"""The 14×14 MNIST UNet control, plain, over a dict of weights named as the
module's parameters (convs (out, in, kh, kw), Linear (out, in)).

  TE(t) = Linear(SiLU(Linear([sin a, cos a]))), a = linspace(0.1, 100, nc)·t + φ
  Res(x) = conv2(SiLU(GN2(conv1(SiLU(GN1(x))) + Linear(SiLU(TE))))) + (x or conv1×1(x))
  Attn(x) = Linear_out(softmax(q kᵀ/√d) v) + x over the h·w tokens, q, k, v
            split from one Linear (no GroupNorm)
  x (B, 196) → image 1×14×14 → conv_in → down1 = Res → [skip1] → conv 3×3
  stride 2 → down2 = Res, Attn → [skip2] → Res, Attn, Res → up1 = Res, Attn
  on [h, skip2] → transposed conv 4×4 stride 2 ("SAME": the flipped kernel
  at padding 1) → up2 = Res on [h, skip1] → conv(SiLU(GN(h))) → (B, 196)

GroupNorm has min(16, C) groups and ε 1e-6."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Arith


def _gn(W, name, h):
    return F.group_norm(h, min(16, h.shape[1]), W[f"{name}.weight"], W[f"{name}.bias"], eps=1e-6)


def _conv(W, name, h, ar: Arith, stride=1):
    w = W[f"{name}.weight"]
    return ar.conv2d(h, w, W[f"{name}.bias"], stride=stride, padding=w.shape[-1] // 2)


def _res(W, name, x, t_emb, ar: Arith):
    h = _conv(W, f"{name}.conv1", F.silu(_gn(W, f"{name}.norm1", x)), ar)
    h = h + ar.linear(F.silu(t_emb), W[f"{name}.time.weight"], W[f"{name}.time.bias"])[:, :, None, None]
    h = _conv(W, f"{name}.conv2", F.silu(_gn(W, f"{name}.norm2", h)), ar)
    if f"{name}.shortcut.weight" in W:
        x = _conv(W, f"{name}.shortcut", x, ar)
    return h + x


def _attn(W, name, x, ar: Arith):
    b, c, hh, ww = x.shape
    seq = x.flatten(2).transpose(1, 2)                                   # (b, hw, c)
    qkv = ar.linear(seq, W[f"{name}.qkv.weight"], W[f"{name}.qkv.bias"])
    q, k, v = torch.split(qkv, c, dim=-1)
    a = torch.softmax(ar.mm(q, k.transpose(-1, -2)) * c**-0.5, dim=-1)
    res = ar.linear(ar.mm(a, v), W[f"{name}.out.weight"], W[f"{name}.out.bias"]) + seq
    return res.transpose(1, 2).reshape(b, c, hh, ww)


def time_embed(W, t_rows: torch.Tensor, ar: Arith) -> torch.Tensor:
    phase = W["time_embed.timestep_phase"]
    coeff = torch.linspace(0.1, 100.0, phase.shape[1], dtype=torch.float32,
                           device=phase.device).to(phase.dtype)
    ang = coeff[None] * t_rows.reshape(-1, 1) + phase
    e = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    e = F.silu(ar.linear(e, W["time_embed.dense.0.weight"], W["time_embed.dense.0.bias"]))
    return ar.linear(e, W["time_embed.out.weight"], W["time_embed.out.bias"])


def unet(W: dict, t_rows: torch.Tensor, x: torch.Tensor, ar: Arith, side: int = 14) -> torch.Tensor:
    """The control for rows x (N, side²) at per-row times t_rows (N,)."""
    t_emb = time_embed(W, t_rows, ar)
    h = _conv(W, "conv_in", x.reshape(-1, 1, side, side), ar)
    h = skip1 = _res(W, "down1.res", h, t_emb, ar)
    h = _conv(W, "downsample", h, ar, stride=2)
    h = _res(W, "down2.res", h, t_emb, ar)
    h = skip2 = _attn(W, "down2.attn", h, ar)
    h = _res(W, "middle.res1", h, t_emb, ar)
    h = _attn(W, "middle.attn", h, ar)
    h = _res(W, "middle.res2", h, t_emb, ar)
    h = _res(W, "up1.res", torch.cat([h, skip2], dim=1), t_emb, ar)
    h = _attn(W, "up1.attn", h, ar)
    w_up = torch.flip(W["upsample.weight"], dims=(2, 3)).transpose(0, 1)
    h = ar.conv_transpose2d(h, w_up, W["upsample.bias"], stride=2, padding=1)
    h = _res(W, "up2.res", torch.cat([h, skip1], dim=1), t_emb, ar)
    h = _conv(W, "proj_convs.0", F.silu(_gn(W, "proj_norms.0", h)), ar)
    return h.reshape(x.shape[0], side * side)
