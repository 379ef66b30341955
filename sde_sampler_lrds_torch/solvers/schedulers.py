"""Learning-rate and hyperparameter schedules (counterpart of
sde_sampler_lrds_tpu/solvers/schedulers.py).

  * the lr schedule factories of the JAX package (step / multi_step / pis),
    each a plain callable from the accepted-step count to the learning rate
    (``TrainConfig.lr_schedule``), equal to optax's staircase
    ``exponential_decay`` and ``piecewise_constant_schedule`` at every step,
    in their float32 arithmetic;
  * MultiStepParams, which decays dotted solver attributes (e.g.
    "generative_ctrl.clip_model") at milestones;
  * CombinedScheduler grouping several of them.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import logging
from bisect import bisect_right
from collections import Counter
from collections.abc import MutableMapping, MutableSequence
from functools import lru_cache
from typing import Any, Callable

import numpy as np

_F32 = np.float32
_TINY = np.finfo(np.float32).tiny


@lru_cache(maxsize=1)
def _powf() -> Callable[[float, float], float]:
    """The C library's float32 ``powf``. XLA's CPU ``pow`` calls it, and it
    is not correctly rounded: float64 pow rounded to float32 differs from it
    by an ulp at some steps (e.g. 0.95 ** 58)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return fn


def _ftz(v: np.float32) -> np.float32:
    """Flush a float32 subnormal to zero, as XLA's CPU arithmetic does."""
    return v if abs(v) >= _TINY else _F32(0.0) * v


def _exponential_staircase(init_value: float, transition_steps: int, decay_rate: float):
    """optax.exponential_decay(..., staircase=True): init · rate^⌊count /
    transition_steps⌋ in float32, init itself up to count 0."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    init, rate = _F32(init_value), _F32(decay_rate)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(init)
        p = _ftz(_F32(_powf()(float(rate), float(int(count) // transition_steps))))
        return float(_ftz(init * p))

    return schedule


def step_lr(base_lr: float, step_size: int = 100, gamma: float = 0.95):
    """lr · γ^(t // step_size)."""
    return _exponential_staircase(base_lr, step_size, gamma)


def multi_step_lr(base_lr: float, milestones: list[int], gamma: float = 0.1):
    """Decay by γ at each milestone (from the milestone's step on)."""
    boundaries = sorted({int(m): gamma for m in milestones}.items())
    if any(scale < 0.0 for _, scale in boundaries):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
    init = _F32(base_lr)

    def schedule(count: int) -> float:
        v = init
        for threshold, scale in boundaries:
            if count >= threshold:
                v = _ftz(_F32(scale) * v)
        return float(v)

    return schedule


def pis_lr(base_lr: float, train_steps: int, step_size: int = 100,
           final_factor: float = 0.02):
    """γ = final_factor^(step_size/train_steps) every step_size steps: a
    total decay of final_factor over the run."""
    gamma = final_factor ** (step_size / train_steps)
    return _exponential_staircase(base_lr, step_size, gamma)


def make_lr_schedule(name: str | None, base_lr: float, train_steps: int, **kwargs):
    if name is None:
        return None
    if name == "step":
        return step_lr(base_lr, **kwargs)
    if name == "multi_step":
        return multi_step_lr(base_lr, kwargs.pop("milestones", [train_steps // 2]),
                             **kwargs)
    if name == "pis":
        return pis_lr(base_lr, train_steps, **kwargs)
    raise ValueError(f"Unknown lr schedule {name!r}")


class MultiStepParams:
    """Decay dotted attributes of an object at milestones."""

    sep = "."

    def __init__(self, obj: Any, milestones: list[int], gammas: dict[str, float],
                 last_step: int = 0):
        self.obj = obj
        self.milestones = Counter(milestones)
        self.gammas = dict(gammas)
        self.base_values = {k: v for k, v in self.get().items() if v is not None}
        missing = set(self.gammas).difference(self.base_values)
        if missing:
            logging.warning("The keys %s are missing and cannot be scheduled.", missing)
            self.gammas = {k: self.gammas[k] for k in self.base_values}
        self.last_step = last_step
        self.update()

    def dotted_get(self, key: str, default=None):
        obj = self.obj
        for attr in key.split(self.sep):
            if isinstance(obj, MutableSequence):
                idx = int(attr)
                obj = obj[idx] if idx < len(obj) else default
            elif isinstance(obj, MutableMapping):
                obj = obj.get(attr, default)
            else:
                obj = getattr(obj, attr, default)
            if obj is default:
                return default
        return obj

    def get(self) -> dict[str, Any]:
        return {key: self.dotted_get(key) for key in self.gammas}

    def set(self, values: dict[str, Any]):
        for key in self.gammas:
            obj, attr = self.obj, key
            if self.sep in key:
                subkeys, attr = key.rsplit(self.sep, 1)
                obj = self.dotted_get(subkeys)
            if isinstance(obj, MutableSequence):
                obj[int(attr)] = values[key]
            elif isinstance(obj, MutableMapping):
                obj[attr] = values[key]
            else:
                setattr(obj, attr, values[key])

    def step(self):
        self.last_step += 1
        if self.last_step in self.milestones:
            values = {k: v * self.gammas[k] ** self.milestones[self.last_step]
                      for k, v in self.get().items()}
            self.set(values)

    def update(self):
        milestones = sorted(self.milestones.elements())
        values = {k: v * self.gammas[k] ** bisect_right(milestones, self.last_step)
                  for k, v in self.base_values.items()}
        self.set(values)

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k != "obj"}

    def load_state_dict(self, state_dict: dict):
        self.__dict__.update(state_dict)
        self.update()


class CombinedScheduler:
    """Group MultiStepParams / schedule objects."""

    def __init__(self, schedulers):
        self.schedulers = list(schedulers)

    def get(self) -> dict:
        output = {}
        for s in self.schedulers:
            if isinstance(s, MultiStepParams):
                output.update(s.get())
        return output

    def step(self):
        for s in self.schedulers:
            s.step()

    def state_dict(self) -> dict:
        return {i: s.state_dict() for i, s in enumerate(self.schedulers)}

    def load_state_dict(self, state_dict: dict):
        for i, s in enumerate(self.schedulers):
            s.load_state_dict(state_dict[i])
