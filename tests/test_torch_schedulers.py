"""The port's schedules held against the JAX package's
(sde_sampler_lrds_tpu/solvers/schedulers.py and the param-schedule wiring of
solvers/base.py): the lr schedules equal optax's staircase
``exponential_decay`` and ``piecewise_constant_schedule`` bit for bit at
every step, as Python ints and as optax's int32 count; the registry and its
error text; ``MultiStepParams`` / ``CombinedScheduler`` on the same dotted
paths (attributes, dicts, lists) step by step and through their state
dicts; and ``param_schedule`` in the port's ``Trainable.run``: the decay at
its milestones, the fast-forward on resume, a scheduled control attribute
taking effect with no rebuild, and the typo errors. Everything runs on the
CPU.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.solvers import schedulers as T
from sde_sampler_lrds_torch.solvers.base import Trainable as TTrainable
from sde_sampler_lrds_torch.solvers.base import TrainConfig as TTrainConfig
from sde_sampler_lrds_tpu.solvers import schedulers as J
from sde_sampler_lrds_tpu.solvers.base import Trainable, TrainConfig

SCHEDULES = {
    "step": ("step", {}),
    "step_10_half": ("step", {"step_size": 10, "gamma": 0.5}),
    "step_7": ("step", {"step_size": 7, "gamma": 0.93}),
    "multi_step": ("multi_step", {}),
    "multi_step_repeated": ("multi_step", {"milestones": [5, 15, 15, 300], "gamma": 0.1}),
    "pis": ("pis", {}),
    "pis_37": ("pis", {"step_size": 37, "final_factor": 0.1}),
}


@pytest.mark.parametrize("base_lr", [3e-4, 1.0])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_equals_optax_at_every_step(case, base_lr):
    name, kw = SCHEDULES[case]
    j = J.make_lr_schedule(name, base_lr, 3000, **dict(kw))
    t = T.make_lr_schedule(name, base_lr, 3000, **dict(kw))
    counts = np.arange(0, 4000)
    # optax's count inside the optimizer is an int32 array; the values run
    # into float32's subnormal range for the halving schedule (flushed to 0)
    want = np.asarray(jax.vmap(j)(jnp.asarray(counts, jnp.int32)), np.float32)
    got = np.array([t(int(c)) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    assert all(t(int(c)) == float(j(int(c))) for c in counts[::97])


def test_lr_schedule_registry():
    assert T.make_lr_schedule(None, 1e-3, 100) is None
    for name in ("step", "multi_step", "pis"):
        assert callable(T.make_lr_schedule(name, 1e-3, 100))
    with pytest.raises(ValueError) as want:
        J.make_lr_schedule("cosine", 1e-3, 100)
    with pytest.raises(ValueError) as got:
        T.make_lr_schedule("cosine", 1e-3, 100)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="non-negative"):
        T.multi_step_lr(1.0, [3], gamma=-0.5)


def _host():
    return SimpleNamespace(lr=1.0, loss=SimpleNamespace(sde_ctrl_noise=0.4),
                           d={"k": 3.0}, lst=[5.0, 7.0])


GAMMAS = {"lr": 0.1, "loss.sde_ctrl_noise": 0.5, "d.k": 0.25, "lst.1": 0.3}


def _values(obj):
    return (obj.lr, obj.loss.sde_ctrl_noise, obj.d["k"], obj.lst[0], obj.lst[1])


def test_multi_step_params_matches_jax():
    jo, to = _host(), _host()
    js = J.MultiStepParams(jo, [2, 4, 4], dict(GAMMAS))
    ts = T.MultiStepParams(to, [2, 4, 4], dict(GAMMAS))
    assert ts.get() == js.get()
    for _ in range(6):
        js.step()
        ts.step()
        assert _values(to) == _values(jo)
        assert ts.get() == js.get()
    # the state dict restores the position on a fresh object
    jo2, to2 = _host(), _host()
    js2 = J.MultiStepParams(jo2, [2, 4, 4], dict(GAMMAS))
    ts2 = T.MultiStepParams(to2, [2, 4, 4], dict(GAMMAS))
    js2.load_state_dict(js.state_dict())
    ts2.load_state_dict(ts.state_dict())
    assert _values(to2) == _values(jo2)
    np.testing.assert_allclose(_values(to2), _values(jo), rtol=1e-15)
    # a key that resolves to nothing is dropped, with a warning, in both
    assert set(T.MultiStepParams(_host(), [1], {"nope": 0.5, "lr": 0.5}).gammas) == \
        set(J.MultiStepParams(_host(), [1], {"nope": 0.5, "lr": 0.5}).gammas) == {"lr"}


def test_combined_scheduler_matches_jax():
    jo, to = _host(), _host()
    jc = J.CombinedScheduler([J.MultiStepParams(jo, [1], {"lr": 0.5}),
                              J.MultiStepParams(jo, [2], {"d.k": 0.1})])
    tc = T.CombinedScheduler([T.MultiStepParams(to, [1], {"lr": 0.5}),
                              T.MultiStepParams(to, [2], {"d.k": 0.1})])
    for _ in range(3):
        jc.step()
        tc.step()
        assert tc.get() == jc.get()
        assert _values(to) == _values(jo)
    state = tc.state_dict()
    to2 = _host()
    tc2 = T.CombinedScheduler([T.MultiStepParams(to2, [1], {"lr": 0.5}),
                               T.MultiStepParams(to2, [2], {"d.k": 0.1})])
    tc2.load_state_dict(state)
    assert _values(to2) == _values(to)


# ---------------------------------------------------------------------------
# param_schedule in the run loop, on a scalar solver in both packages
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(train_steps=6, train_batch_size=1, eval_batch_size=1, lr=0.5,
                optimizer="sgd", eval_interval=10**6, log_interval=2, steps_per_call=2,
                param_schedule={"loss.knob": {"milestones": [2, 4], "gamma": 0.5}})
    base.update(kw)
    return cls(**base)


class JaxScalar(Trainable):
    """The JAX package's own scalar solver (tests/test_schedulers.py)."""

    def __init__(self, cfg):
        super().__init__(SimpleNamespace(dim=1, compute_stats=lambda key=None: None), cfg=cfg)
        self.loss = SimpleNamespace(knob=8.0)

    def init_params(self, key):
        return {"w": jnp.zeros(())}

    def loss_fn(self, params, key):
        return (params["w"] - self.loss.knob) ** 2, {}

    def eval_metrics(self, key):
        return {}


class _W(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w.zero_()


class PortScalar(TTrainable):
    def __init__(self, cfg):
        super().__init__(SimpleNamespace(dim=1, compute_stats=lambda g=None: None), cfg=cfg,
                         device="cpu")
        self.loss = SimpleNamespace(knob=8.0)
        self._w = _W()

    @property
    def module(self):
        return self._w

    def loss_fn(self, generator, **fed):
        return (self._w.w - self.loss.knob) ** 2, {}

    def eval_metrics(self, generator):
        return {}


def _spy(solver):
    knobs, orig = [], solver.step

    def step(*a, **k):
        knobs.append(solver.loss.knob)
        return orig(*a, **k)

    solver.step = step
    return knobs


def test_param_schedule_decays_in_run_as_jax():
    j, t = JaxScalar(_cfg(TrainConfig)), PortScalar(_cfg(TTrainConfig))
    j.setup()
    t.setup()
    jk, tk = _spy(j), _spy(t)
    jm, tm = j.run(), t.run()
    assert tk == jk == [8.0, 4.0, 2.0]
    assert tm["sched/loss.knob"] == jm["sched/loss.knob"] == 2.0
    # each step lands on the knob of its chunk (SGD at lr 0.5 on (w - k)²)
    assert float(t.module.w.detach()) == float(j.state.params["w"]) == 2.0
    assert t.step_count == int(j.state.step) == 6


def test_param_schedule_fast_forwards_on_resume_as_jax():
    j, t = JaxScalar(_cfg(TrainConfig)), PortScalar(_cfg(TTrainConfig))
    j.setup()
    t.setup()
    j.state = j.state.replace(step=jnp.asarray(3))
    t.step_count = 3
    assert t.loss.knob == j.loss.knob == 8.0  # fresh objects: before the schedule
    jk, tk = _spy(j), _spy(t)
    j.run()
    t.run()
    # resumed at step 3, past milestone 2: the one chunk from step 4 sees 4.0
    assert tk == jk == [4.0]
    assert t.loss.knob == j.loss.knob == 2.0


@pytest.mark.parametrize("schedule,match", [
    ({"loss.knbo": {"milestones": [1]}}, "does not resolve"),
    ({"loss.knob": {"milestones": [1], "gammas": 0.1}}, "unknown spec field"),
    ({"loss.knob": {"gamma": 0.1}}, "milestones"),
])
def test_param_schedule_typo_raises_as_jax(schedule, match):
    with pytest.raises(ValueError, match=match) as want:
        JaxScalar(_cfg(TrainConfig, param_schedule=schedule)).setup()
    with pytest.raises(ValueError, match=match) as got:
        PortScalar(_cfg(TTrainConfig, param_schedule=schedule)).setup()
    assert str(got.value) == str(want.value)


def test_scheduled_control_attribute_takes_effect_with_no_rebuild():
    """A scheduled ``generative_ctrl.clip_model`` reaches the fused plan at
    the next step: the plan is built from the modules on every step, so
    nothing has to be invalidated."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan

    solver = make_model(
        "vp-ref", "default", "lv", "ei", "base_zero_init", "snr", {"sigma": 1.0},
        make_target_details("two_modes", dim=2),
        {"train_steps": 4, "train_batch_size": 16, "eval_batch_size": 16,
         "log_interval": 1,
         "param_schedule": {"generative_ctrl.clip_model": {"milestones": [2],
                                                           "gamma": 1e-6}}},
        n_steps=6, device="cpu", compute_samples_based_metrics=False)
    solver.setup()
    seen, orig = [], solver.step

    def step(*a, **k):
        seen.append(build_plan(solver.loss, solver.generative_ctrl, solver.train_ts)[0].clip)
        return orig(*a, **k)

    solver.step = step
    metrics = solver.run()
    np.testing.assert_allclose(seen, [1e4, 1e4, 1e-2, 1e-2], rtol=1e-12)
    np.testing.assert_allclose(metrics["sched/generative_ctrl.clip_model"], 1e-2, rtol=1e-12)
    assert solver.train_path() == "flat_lv_plain"
