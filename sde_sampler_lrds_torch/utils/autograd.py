"""Divergence and gradient estimators by autograd (counterpart of
sde_sampler_lrds_tpu/utils/autograd.py): the exact divergence as a sum of D
vector-Jacobian products against the basis vectors, the Hutchinson estimate
as one product against a Rademacher or Gaussian probe. The products keep
their graph when autograd records, so the loss's gradient flows through
the divergence term as it does through the JAX package's JVPs."""
from __future__ import annotations

from typing import Callable

import torch


def compute_divx(f: Callable, t, x: torch.Tensor, generator: torch.Generator | None = None,
                 noise_type: str | None = None, probe: torch.Tensor | None = None):
    """(div (B, 1), f(t, x) (B, D)) of x ↦ f(t, x). ``noise_type`` None is
    the exact divergence; 'rademacher' or 'gaussian' the Hutchinson
    estimate, its probe drawn from ``generator`` or fed as ``probe``."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        y = x if x.requires_grad else x.detach().requires_grad_(True)
        out = f(t, y)
        if noise_type is None:
            div = torch.zeros(x.shape[:-1], dtype=out.dtype, device=x.device)
            for i in range(x.shape[-1]):
                (g,) = torch.autograd.grad(out[..., i].sum(), y, create_graph=create,
                                           retain_graph=True)
                div = div + g[..., i]
            return _maybe_detach(create, div[..., None], out)
        if probe is None:
            if noise_type == "rademacher":
                probe = 2.0 * torch.randint(0, 2, x.shape, generator=generator,
                                            device=x.device).to(x.dtype) - 1.0
            elif noise_type in ("gaussian", "gauss"):
                probe = torch.randn(x.shape, generator=generator, device=x.device,
                                    dtype=x.dtype)
            else:
                raise ValueError(f"Unknown noise type {noise_type!r}.")
        elif noise_type not in ("rademacher", "gaussian", "gauss"):
            raise ValueError(f"Unknown noise type {noise_type!r}.")
        (g,) = torch.autograd.grad(torch.sum(out * probe), y, create_graph=create,
                                   retain_graph=create)
        return _maybe_detach(create, torch.sum(g * probe, dim=-1, keepdim=True), out)


def _maybe_detach(keep: bool, *ts):
    return ts if keep else tuple(t.detach() for t in ts)


def compute_gradx(f: Callable, t, x: torch.Tensor, **kwargs):
    """(∇ₓ Σ f, f) for a scalar-per-sample f."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        y = x if x.requires_grad else x.detach().requires_grad_(True)
        vals = f(t, y, **kwargs)
        (grad,) = torch.autograd.grad(vals.sum(), y, create_graph=create)
    return _maybe_detach(create, grad, vals)
