"""Control reparametrizations (counterpart of
sde_sampler_lrds_tpu/models/reparam.py; only ClippedCtrl is ported yet)."""
from __future__ import annotations

from torch import nn

from ..utils.common import clip_norm


class ClippedCtrl(nn.Module):
    """Clip the wrapped network's output to ±clip_model."""

    def __init__(self, base_model: nn.Module, clip_model: float | None = None):
        super().__init__()
        self.base_model = base_model
        self.clip_model = clip_model

    def reset_parameters(self, generator=None) -> None:
        self.base_model.reset_parameters(generator)

    def forward(self, t, x):
        return clip_norm(self.base_model(t, x), self.clip_model)
