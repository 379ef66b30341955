"""Training step: Adam with gradient clipping, a guarded (masked-skip)
update, and EMA (counterpart of sde_sampler_lrds_tpu/solvers/base.py).

The JAX package fuses value_and_grad, the finite/magnitude guards, the
optax update and the EMA into one jitted step; here the same sequence runs
eagerly: backward, guard, then either the optimizer step or a skip counted
in ``n_skipped``. ``eval_metrics`` runs an evaluation pass and reduces it
with ``eval/metrics.get_metrics``, sample losses included. Checkpointing,
the host run loop and the hyperparameter schedules are not ported yet.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.common import Results, derive_generator, resolve_device


@dataclass
class TrainConfig:
    """Flat config for the training loop (same fields as the JAX package's)."""

    train_steps: int = 10_000
    train_batch_size: int = 512
    eval_batch_size: int = 6000
    lr: float = 3e-4
    optimizer: str = "adam"
    grad_clip: float | None = None
    max_loss: float | None = None
    max_grad: float | None = None
    scale_loss: float | None = None
    use_ema: bool = False
    ema_decay: float = 0.995
    eval_interval: int = 500
    log_interval: int = 50
    ckpt_interval: int | None = None
    seed: int = 0
    # accepted-step count -> learning rate, applied before each step
    lr_schedule: Callable | None = None
    # the JAX package fuses this many optimizer steps into one jitted call;
    # here each ``step`` call runs that many steps one after another
    steps_per_call: int = 1
    param_schedule: dict | None = None
    # flat LV training (losses/rds.py lv_flat_call): 'auto' | 'off'
    flat_lv: str = "auto"
    # fused whole-trajectory eval (ops/fused_traj): 'auto' | 'off'
    fused_eval: str = "auto"
    # fused KL training (losses/rds.py kl_fused_call through
    # ops/fused_traj.fused_kl_traj): 'auto' | 'off' | 'force'; 'auto' and
    # 'force' take it on either device (solvers/oc.py _fused_kl_fn)
    fused_kl: str = "auto"


class Trainable:
    """Gradient-trained solver: owns the target, the device, the trainable
    module, its optimizer and EMA copy. ``sample_losses`` maps a name to a
    ``(samples, target_draws) -> scalar`` distance that ``eval_metrics``
    reports as ``error/<name>``."""

    def __init__(self, target, cfg: TrainConfig | None = None, device=None,
                 eval_marginal_dims: tuple[int, ...] = (0,), sample_losses=None):
        self.target = target
        self.eval_marginal_dims = list(eval_marginal_dims)
        self.sample_losses = sample_losses or {}
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(device)
        if self.cfg.param_schedule:
            raise NotImplementedError("param_schedule is not ported yet")
        self.optimizer: torch.optim.Optimizer | None = None
        self.ema_module: torch.nn.Module | None = None
        self.step_count = 0
        self.n_skipped = 0

    # -- subclass surface --------------------------------------------------
    @property
    def module(self) -> torch.nn.Module:
        """The trainable nn.Module."""
        raise NotImplementedError

    def loss_fn(self, generator: torch.Generator, **fed):
        """(loss, metrics) for one batch."""
        raise NotImplementedError

    def evaluate(self, generator: torch.Generator, use_ema: bool = True) -> Results:
        raise NotImplementedError

    # -- optimizer ---------------------------------------------------------
    def make_optimizer(self) -> torch.optim.Optimizer:
        params = self.module.parameters()
        lr = self.cfg.lr
        if self.cfg.optimizer == "adam":
            return torch.optim.Adam(params, lr=lr)
        if self.cfg.optimizer == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if self.cfg.optimizer == "adamw":  # optax.adamw's default decay
            return torch.optim.AdamW(params, lr=lr, weight_decay=1e-4)
        raise ValueError(f"Unknown optimizer {self.cfg.optimizer}")

    def init_params(self, seed: int) -> None:
        """Re-initialize the module from ``seed`` (on the CPU, so the draw
        does not depend on the device) and move it to the device."""
        m = self.module.cpu()
        m.reset_parameters(torch.Generator().manual_seed(seed))
        m.to(self.device)

    # -- lifecycle ---------------------------------------------------------
    def setup(self, generator: torch.Generator | None = None) -> None:
        """Target statistics, fresh parameters, optimizer and EMA."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(self.cfg.seed)
        self.target.compute_stats(generator)
        self.init_params(self.cfg.seed)
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """Fresh optimizer state and EMA copy for the module's current
        parameters (e.g. after loading weights into it)."""
        self.optimizer = self.make_optimizer()
        self.ema_module = copy.deepcopy(self.module).requires_grad_(False)
        self.step_count = 0
        self.n_skipped = 0

    def eval_module(self, use_ema: bool = True) -> torch.nn.Module:
        return self.ema_module if (use_ema and self.cfg.use_ema) else self.module

    def _one_step(self, generator, **fed) -> dict:
        cfg = self.cfg
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(generator, **fed)
        if cfg.scale_loss is not None:
            loss = loss * cfg.scale_loss
        loss.backward()
        params = [p for p in self.module.parameters() if p.grad is not None]
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        # finite / magnitude guards: a failing step leaves parameters and
        # optimizer state untouched and counts as skipped
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if cfg.max_loss is not None:
            ok &= torch.abs(loss) < cfg.max_loss
        if cfg.max_grad is not None:
            ok &= gnorm < cfg.max_grad
        if bool(ok):
            if cfg.grad_clip is not None and float(gnorm) >= cfg.grad_clip:
                # optax.clip_by_global_norm: g · max_norm / ‖g‖ when ‖g‖ ≥ max_norm
                scale = cfg.grad_clip / gnorm
                for p in params:
                    p.grad.mul_(scale)
            if cfg.lr_schedule is not None:
                # indexed by the accepted steps, as optax's schedule count,
                # which a skipped step leaves where it was
                accepted = self.step_count - self.n_skipped
                for group in opt.param_groups:
                    group["lr"] = float(cfg.lr_schedule(accepted))
            opt.step()
        else:
            self.n_skipped += 1
        if cfg.use_ema:
            d = cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema_module.parameters(), self.module.parameters()):
                    e.mul_(d).add_(p.detach(), alpha=1.0 - d)
        self.step_count += 1
        return {"train/loss": loss.detach(), "train/grad_norm": gnorm, **metrics}

    def step(self, generator: torch.Generator, **fed) -> dict:
        """``cfg.steps_per_call`` optimizer steps; the last step's metrics.
        ``fed`` inputs (e.g. ``x0`` and ``noise``) replace the step's draws."""
        metrics = {}
        for _ in range(max(self.cfg.steps_per_call, 1)):
            metrics = self._one_step(generator, **fed)
        return metrics

    # -- evaluation metrics ------------------------------------------------
    def metrics_from_results(self, results: Results, generator: torch.Generator) -> dict:
        """``results.metrics`` plus every metric of its samples. The target
        draws of the sample losses come from a generator derived from
        ``generator`` (the counterpart of ``fold_in(key, 7)``)."""
        from ..eval.metrics import get_metrics

        metrics = dict(results.metrics)
        if results.samples is not None:
            metrics.update(get_metrics(
                self.target, results.samples, weights=results.weights,
                log_norm_const_preds=results.log_norm_const_preds,
                expectation_preds=results.expectation_preds,
                marginal_dims=self.eval_marginal_dims,
                sample_losses=self.sample_losses,
                sample_generator=derive_generator(generator, 7)))
        return metrics

    def eval_metrics(self, generator: torch.Generator) -> dict:
        """One evaluation pass and its metrics, with the wall time it took."""
        t0 = time.time()
        results = self.evaluate(generator)
        metrics = self.metrics_from_results(results, generator)
        metrics["eval/sample_time"] = time.time() - t0
        return metrics
