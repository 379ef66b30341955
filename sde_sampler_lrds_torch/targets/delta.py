"""Dirac prior, the start of the pinned Brownian motion's paths,
approximated as a narrow Gaussian (counterpart of
sde_sampler_lrds_tpu/targets/delta.py)."""
from __future__ import annotations

import torch

from .gauss import Gauss


class Delta(Gauss):
    """Dirac at ``loc``: the log-density of a Gaussian of scale
    ``approx_scale``, and ``sample`` returns ``loc``."""

    def __init__(self, dim: int = 1, loc=0.0, approx_scale: float = 1e-3,
                 domain_scale: float = 10.0, **kwargs):
        super().__init__(dim=dim, loc=loc, scale=approx_scale,
                         domain_scale=domain_scale, **kwargs)

    def sample(self, generator: torch.Generator | None, shape: tuple = ()) -> torch.Tensor:
        del generator
        return self.loc[0].expand(*shape, self.dim).clone()
