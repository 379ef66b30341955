"""The port's training step held against the JAX package's: a learning-rate
schedule under skipped steps. The JAX package hands the schedule to optax,
whose step count lives in the optimizer state, and a step that fails the
guards restores that state, so the schedule is indexed by the accepted
steps; the port must index it the same way.

A quadratic loss on a fed batch stands in for a sampler's loss: the same
batches, made with numpy from a seed, go to both packages' ``Trainable``,
and the steps chosen to be skipped carry a batch whose loss is beyond
``max_loss``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.solvers.base import Trainable as TTrainable
from sde_sampler_lrds_torch.solvers.base import TrainConfig as TTrainConfig
from sde_sampler_lrds_tpu.solvers.base import Trainable as JTrainable
from sde_sampler_lrds_tpu.solvers.base import TrainConfig as JTrainConfig
from sde_sampler_lrds_tpu.solvers.schedulers import step_lr

BASE_LR, STEP_SIZE, GAMMA, MAX_LOSS = 0.1, 2, 0.5, 1e3


def _loss(batch, w):
    return ((batch - w) ** 2).sum(-1).mean()


class _JQuadratic(JTrainable):
    """One parameter vector; the step's key is its fed batch."""

    def __init__(self, cfg, w0):
        super().__init__(SimpleNamespace(dim=w0.shape[0], compute_stats=lambda key=None: None),
                         cfg=cfg)
        self.w0 = w0

    def init_params(self, key):
        return {"w": jnp.asarray(self.w0)}

    def loss_fn(self, params, batch):
        return _loss(batch, params["w"]), {}


class _TQuadratic(TTrainable):
    def __init__(self, cfg, w0):
        super().__init__(SimpleNamespace(dim=w0.shape[0]), cfg=cfg, device="cpu")
        self._module = torch.nn.Module()
        self._module.w = torch.nn.Parameter(torch.as_tensor(w0))

    @property
    def module(self):
        return self._module

    def loss_fn(self, generator, batch):
        return _loss(batch, self._module.w), {}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_lr_schedule_counts_accepted_steps_as_jax(optimizer):
    """A step schedule (lr·γ^(n // 2)) over 10 steps, of which steps 1, 2
    and 5 are skipped by max_loss: the port's learning rate at every
    accepted step equals the JAX package's (optax's count of accepted
    steps), and so do the parameters after every step."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=3).astype(np.float32)
    batches = rng.normal(size=(10, 16, 3)).astype(np.float32)
    skipped = {1, 2, 5}
    for i in skipped:
        batches[i] *= 1e3                       # loss ~ 3e6 > MAX_LOSS

    j_solver = _JQuadratic(JTrainConfig(lr=BASE_LR, optimizer=optimizer, max_loss=MAX_LOSS,
                                        lr_schedule=step_lr(BASE_LR, STEP_SIZE, GAMMA)), w0)
    j_solver.setup()
    t_solver = _TQuadratic(TTrainConfig(lr=BASE_LR, optimizer=optimizer, max_loss=MAX_LOSS,
                                        lr_schedule=lambda n: BASE_LR * GAMMA ** (n // STEP_SIZE)),
                           w0)
    t_solver.reset_optimizer()
    schedule = step_lr(BASE_LR, STEP_SIZE, GAMMA)
    for i, batch in enumerate(batches):
        count = int(j_solver.state.opt_state[-1].count)   # optax's schedule index
        j_solver.step(jnp.asarray(batch))
        t_solver.step(None, batch=torch.as_tensor(batch))
        assert int(j_solver.state.n_skipped) == t_solver.n_skipped
        if i not in skipped:
            np.testing.assert_allclose(t_solver.optimizer.param_groups[0]["lr"],
                                       float(schedule(count)), rtol=1e-6)
        np.testing.assert_allclose(t_solver.module.w.detach().numpy(),
                                   np.asarray(j_solver.state.params["w"]), rtol=1e-5, atol=1e-6)
    assert t_solver.n_skipped == len(skipped) and t_solver.step_count == len(batches)
    assert int(j_solver.state.opt_state[-1].count) == len(batches) - len(skipped)
