"""Control reparametrizations (counterpart of
sde_sampler_lrds_tpu/models/reparam.py): the clip, the target-informed score
control, the Langevin initialization, the prior-to-target score
interpolation, and the removal of a reference score.

The external callables a control reads (the target's and the prior's
scores, the SDE) are held by reference: an EMA copy of the control
(``copy.deepcopy``) shares them instead of copying the target.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..utils.common import clip_norm, on_rows


class _Shared:
    """A callable or object the control uses but does not own."""

    def __init__(self, obj):
        self.obj = obj

    def __deepcopy__(self, memo):
        return self


def _t_col(t, x: torch.Tensor):
    """t as a column against x: one time as is, per-row or per-step times
    with a trailing axis of 1."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    return t[..., None] if t.ndim > 0 else t


class ClippedCtrl(nn.Module):
    """Clip the wrapped network's output to ±clip_model."""

    def __init__(self, base_model: nn.Module, clip_model: float | None = None):
        super().__init__()
        self.base_model = base_model
        self.clip_model = clip_model

    def reset_parameters(self, generator=None) -> None:
        self.base_model.reset_parameters(generator)

    def clipped_base_model(self, t, x):
        return clip_norm(self.base_model(t, x), self.clip_model)

    def forward(self, t, x):
        return self.clipped_base_model(t, x)


class ScoreCtrl(ClippedCtrl):
    """Target-informed control NN(t, x) + scale(t)·∇log ρ(x): ``score_model``
    (optional) is a small time net giving the scale; with ``detach_score``
    the target score takes no gradient through x."""

    def __init__(self, base_model: nn.Module, clip_model: float | None = None,
                 target_score: Callable | None = None, score_model: nn.Module | None = None,
                 detach_score: bool = True, scale_score: float = 1.0,
                 clip_score: float | None = None):
        super().__init__(base_model, clip_model)
        self._target_score = _Shared(target_score)
        self.score_model = score_model
        self.detach_score = detach_score
        self.scale_score = scale_score
        self.clip_score = clip_score

    @property
    def target_score(self):
        return self._target_score.obj

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters(generator)
        if self.score_model is not None:
            self.score_model.reset_parameters(generator)

    def clipped_target_score(self, t, x):
        if self.detach_score:
            x = x.detach()
        return clip_norm(on_rows(self.target_score, x), self.clip_score)

    def clipped_score_model(self, t, x):
        return clip_norm(self.score_model(t, x), self.clip_model)

    def _scaled_score(self, t, x, score):
        if self.score_model is not None:
            score = score * self.clipped_score_model(t, x)
        return score

    def forward(self, t, x):
        ctrl = self.clipped_base_model(t, x)
        score = self.scale_score * self.clipped_target_score(t, x)
        return ctrl + self._scaled_score(t, x, score)


class CancelDriftCtrl(ScoreCtrl):
    """Langevin initialization: adds drift/diff + ½·diff·score, so the
    zero-init network starts as an annealed Langevin sampler."""

    def __init__(self, *args, sde=None, use_rescaling: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self._sde = _Shared(sde)
        self.use_rescaling = use_rescaling

    @property
    def sde(self):
        return self._sde.obj

    def forward(self, t, x):
        ctrl = self.clipped_base_model(t, x)
        t_sde = _t_col(t, x)
        sde_diff = self.sde.diff(t_sde, x)
        sde_drift = self.sde.drift(t_sde, x)
        score = self._scaled_score(t, x, self.scale_score * self.clipped_target_score(t, x))
        if self.use_rescaling:
            return ctrl + sde_drift / sde_diff + 0.5 * sde_diff * score
        return ctrl + sde_drift / torch.square(sde_diff) + 0.5 * score


class LerpCtrl(ScoreCtrl):
    """Prior-to-target score interpolation for DIS: NN(t, x) +
    diff(t)·scale(t)·((1 − t/T)·∇log p₀ + (t/T)·∇log ρ). With
    ``hard_constrain`` the network and the scale are multiplied by
    4(T − t)t/T², with T the SDE's horizon."""

    def __init__(self, *args, sde=None, prior_score: Callable | None = None,
                 hard_constrain: bool = False, scale_lerp: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._sde = _Shared(sde)
        self._prior_score = _Shared(prior_score)
        self.hard_constrain = hard_constrain
        self.scale_lerp = scale_lerp

    @property
    def sde(self):
        return self._sde.obj

    @property
    def prior_score(self):
        return self._prior_score.obj

    def clipped_interpolated_score(self, t, x):
        if self.detach_score:
            x = x.detach()
        target = on_rows(self.target_score, x)
        prior = on_rows(self.prior_score, x)
        u = _t_col(t, x) / self.sde.terminal_t
        return clip_norm(prior + u * (target - prior), self.clip_score)

    def constrain(self, output, t):
        T = self.sde.terminal_t
        t = _t_col(t, output)
        return output * (4.0 * (T - t) * t / T**2)

    def forward(self, t, x):
        ctrl = self.clipped_base_model(t, x)
        if self.hard_constrain:
            ctrl = self.constrain(ctrl, t)
        score = self.scale_score * self.clipped_interpolated_score(t, x)
        if self.score_model is not None:
            sm = self.clipped_score_model(t, x)
            if self.hard_constrain:
                sm = self.constrain(sm, t)
            score = score * sm
        return ctrl + self.sde.diff(_t_col(t, x), x) * score


def remove_reference_ctrl(ctrl: Callable, ref_score: Callable,
                          use_rescaling: bool = True, sde=None) -> Callable:
    """A trained control minus the reference score (Langevin init under RDS:
    the generative control models only the deviation from the reference
    process). Per-step times (K, 1) meet flat states (K, B, D) as columns."""
    if use_rescaling:
        def wrapped(t, x):
            return ctrl(t, x) - sde.diff(_t_col(t, x), x) * ref_score(t, x)
    else:
        def wrapped(t, x):
            return ctrl(t, x) - ref_score(t, x)
    return wrapped
