"""Training step: Adam with gradient clipping, a guarded (masked-skip)
update, and EMA; the host run loop with eval / log / checkpoint intervals
and hyperparameter schedules (counterpart of
sde_sampler_lrds_tpu/solvers/base.py).

The JAX package fuses value_and_grad, the finite/magnitude guards, the
optax update and the EMA into one jitted step; here the same sequence runs
eagerly: backward, guard, then either the optimizer step or a skip counted
in ``n_skipped``. ``eval_metrics`` runs an evaluation pass and reduces it
with ``eval/metrics.get_metrics``, sample losses included. ``run`` streams
metrics to ``{out_dir}/metrics.jsonl``; checkpoints are ``torch.save``
payloads of plain tensors, numbers, strings, lists and dicts under
``{out_dir}/ckpt/``, read back with ``weights_only=True``. A checkpoint the
JAX package wrote (``ckpt*.msgpack``, its solver's ``save_attrs``) loads
whole as well: the parameters, the EMA copy, Adam's moments and count, the
step and skip counts and the training time (``restore_jax_attrs``).
"""
from __future__ import annotations

import copy
import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from ..parallel.mesh import Mesh, get_mesh
from ..utils.common import Results, derive_generator, resolve_device
from ..utils.profiling import annotate, host_read

CKPT_DIR = "ckpt"


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
    # host-side hyperparameter schedule: dotted solver attribute -> decay
    # spec, e.g. {"generative_ctrl.clip_model": {"milestones": [5000],
    # "gamma": 0.1}}; the step reads the attribute when it runs (the fused
    # plan is rebuilt from the modules on every step), so a milestone takes
    # effect at the next step, or with steps_per_call > 1 at the next call
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
    reports as ``error/<name>``. ``mesh`` is the data-parallel mesh
    (``parallel/mesh.py``), by default the one-device mesh of the solver's
    device; the state lives on the mesh's first device, which is the
    solver's device (the counterpart of the JAX package's replicated
    state)."""

    def __init__(self, target, cfg: TrainConfig | None = None, device=None,
                 eval_marginal_dims: tuple[int, ...] = (0,), sample_losses=None,
                 out_dir: str | Path | None = None, mesh: Mesh | None = None):
        self.target = target
        self.eval_marginal_dims = list(eval_marginal_dims)
        self.sample_losses = sample_losses or {}
        self.cfg = cfg or TrainConfig()
        if mesh is not None and device is not None \
                and get_mesh(devices=[device]).device != mesh.device:
            raise ValueError(f"device {device} is not the mesh's first device {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh if mesh is not None else get_mesh(devices=[self.device])
        self.out_dir = Path(out_dir) if out_dir else None
        if self.out_dir:
            (self.out_dir / CKPT_DIR).mkdir(parents=True, exist_ok=True)
        self.optimizer: torch.optim.Optimizer | None = None
        self.ema_module: torch.nn.Module | None = None
        self.step_count = 0
        self.n_skipped = 0
        self.train_time = 0.0
        self._param_schedulers: list = []

    def log_metrics(self, metrics: dict, step: int) -> None:
        """Append ``{"step": step, **metrics}`` to ``{out_dir}/metrics.jsonl``
        (tensors read as floats) and log it."""
        record = {"step": step, **{k: _to_float(v) for k, v in metrics.items()}}
        if self.out_dir:
            with open(self.out_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")
        logging.info("step %d: %s", step,
                     {k: round(v, 5) for k, v in record.items() if isinstance(v, float)})

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
        self._param_schedulers = self._build_param_schedulers()

    def _build_param_schedulers(self) -> list:
        """One MultiStepParams per ``cfg.param_schedule`` entry; a typo'd key
        or spec field raises here, before any step."""
        if not self.cfg.param_schedule:
            return []
        from .schedulers import MultiStepParams

        out = []
        for dotted, spec in self.cfg.param_schedule.items():
            if not isinstance(spec, dict) or "milestones" not in spec:
                raise ValueError(
                    f"param_schedule[{dotted!r}] needs a dict with "
                    f"'milestones' (got {spec!r})")
            unknown = set(spec) - {"milestones", "gamma"}
            if unknown:
                raise ValueError(
                    f"param_schedule[{dotted!r}]: unknown spec field(s) "
                    f"{sorted(unknown)}; valid: milestones, gamma")
            s = MultiStepParams(self, list(spec["milestones"]),
                                {dotted: spec.get("gamma", 0.1)})
            if dotted not in s.gammas:
                raise ValueError(
                    f"param_schedule key {dotted!r} does not resolve to a "
                    f"non-None attribute on this solver")
            out.append(s)
        return out

    def _advance_param_schedule(self, step: int) -> None:
        """Fast-forward every hyperparameter schedule to ``step``. The port
        keeps no state built from a scheduled value across steps (the fused
        plan is rebuilt from the modules on every step), so nothing has to
        be rebuilt when a value changes."""
        for s in self._param_schedulers:
            s.last_step = step
            s.update()

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
        """One optimizer step in the region ``lrds.step`` and its children
        (``utils/profiling.py``); its host reads: the guard's, and the
        gradient norm's where ``grad_clip`` is set and the guard passes."""
        cfg = self.cfg
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        with annotate("lrds.step.loss"):
            loss, metrics = self.loss_fn(generator, **fed)
            if cfg.scale_loss is not None:
                loss = loss * cfg.scale_loss
        with annotate("lrds.step.backward"):
            loss.backward()
        with annotate("lrds.step.guard"):
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
            ok = host_read(ok)
        if ok:
            with annotate("lrds.step.update"):
                if cfg.grad_clip is not None and host_read(gnorm) >= cfg.grad_clip:
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
            with torch.no_grad(), annotate("lrds.step.ema"):
                for e, p in zip(self.ema_module.parameters(), self.module.parameters()):
                    e.mul_(d).add_(p.detach(), alpha=1.0 - d)
        self.step_count += 1
        return {"train/loss": loss.detach(), "train/grad_norm": gnorm, **metrics}

    def step(self, generator: torch.Generator, **fed) -> dict:
        """``cfg.steps_per_call`` optimizer steps; the last step's metrics.
        ``fed`` inputs (e.g. ``x0`` and ``noise``) replace the step's draws."""
        metrics = {}
        for _ in range(max(self.cfg.steps_per_call, 1)):
            with annotate("lrds.step"):
                metrics = self._one_step(generator, **fed)
        return metrics

    def run(self, eval_fn: Callable | None = None) -> dict:
        """Host loop: train to ``cfg.train_steps`` from ``step_count`` with a
        log record every ``log_interval`` steps, an evaluation every
        ``eval_interval`` and at the last step, and a checkpoint every
        ``ckpt_interval``. Like the JAX package's, the step generator
        restarts at ``cfg.seed + 1`` on every call, so a resumed run replays
        the noise of the first steps. Metrics are read to the host at the
        log and eval steps only."""
        if self.optimizer is None:
            raise RuntimeError("call setup() first")
        cfg = self.cfg
        generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        last_metrics: dict = {}
        start = time.time()
        start_step = self.step_count
        spc = max(cfg.steps_per_call, 1)
        # resume: apply the milestones already passed
        self._advance_param_schedule(start_step)
        for step_id in range(start_step + spc - 1, cfg.train_steps, spc):
            metrics = self.step(generator)
            self._advance_param_schedule(step_id + 1)
            if (step_id + 1) % cfg.log_interval == 0:
                metrics = {k: _to_float(v) for k, v in metrics.items()}
                for s in self._param_schedulers:
                    metrics.update({f"sched/{k}": v for k, v in s.get().items()})
                metrics["train/time_per_step"] = (time.time() - start) / max(
                    step_id + 1 - start_step, 1)
                metrics["train/n_skipped"] = self.n_skipped
                self.log_metrics(metrics, step_id + 1)
                last_metrics.update(metrics)
            if (step_id + 1) % cfg.eval_interval == 0 or step_id + 1 == cfg.train_steps:
                eval_metrics = (eval_fn or self.eval_metrics)(
                    derive_generator(generator, step_id + 1))
                self.log_metrics(eval_metrics, step_id + 1)
                last_metrics.update(eval_metrics)
            if cfg.ckpt_interval and (step_id + 1) % cfg.ckpt_interval == 0:
                self.store_checkpoint()
        self.train_time = time.time() - start
        last_metrics["train/time"] = self.train_time
        return last_metrics

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

    # -- checkpointing -----------------------------------------------------
    def save_attrs(self) -> dict:
        """The checkpoint payload; subclasses extend it. Only tensors,
        numbers, strings, lists and dicts, so ``weights_only`` loading reads
        it."""
        return {"module": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema_module.state_dict(),
                "step_count": self.step_count, "n_skipped": self.n_skipped,
                "train_time": self.train_time}

    def restore_attrs(self, raw: dict) -> None:
        """Load ``save_attrs``' payload (its tensors already on the device)
        into the set-up module, optimizer and EMA module."""
        self.module.load_state_dict(raw["module"])
        self.optimizer.load_state_dict(raw["optimizer"])
        # a fresh optimizer keeps its step counts on the CPU (unless
        # capturable), where reading them costs no device sync
        for state in self.optimizer.state.values():
            step = state.get("step")
            if isinstance(step, torch.Tensor) and step.device != torch.device("cpu") \
                    and not self.optimizer.defaults.get("capturable", False) \
                    and not self.optimizer.defaults.get("fused", False):
                state["step"] = step.cpu()
        self.ema_module.load_state_dict(raw["ema"])
        self.step_count = int(raw["step_count"])
        self.n_skipped = int(raw["n_skipped"])
        self.train_time = float(raw["train_time"])

    # -- the JAX package's checkpoints --------------------------------------
    def _load_flax_tree(self, module: torch.nn.Module, tree: dict) -> None:
        """Fill ``module`` (this solver's module or a copy of it) from the
        JAX solver's parameter tree (Flax layout, numpy arrays)."""
        raise NotImplementedError

    def restore_jax_attrs(self, raw: dict) -> None:
        """Load the JAX package's checkpoint payload (its ``save_attrs`` as
        ``flax.serialization.msgpack_restore`` gives it: ``TrainState``'s
        fields under 'state', and 'train_time') into the set-up module,
        optimizer and EMA module. optax's Adam state is the one node of the
        (chained, integer-keyed) optimizer state with 'count', 'mu' and 'nu';
        its moments, laid out as the parameters, become ``torch.optim.Adam``'s
        ``exp_avg`` / ``exp_avg_sq`` and its count the ``step`` (both count
        the accepted steps). The step and skip counts are the lr schedule's
        index (accepted = step − skipped)."""
        state = raw["state"]
        self._load_flax_tree(self.module, state["params"])
        self._load_flax_tree(self.ema_module, state["ema_params"])
        self.optimizer = self.make_optimizer()
        adam = _find_adam_state(state["opt_state"])
        if (adam is None) != (self.cfg.optimizer == "sgd"):
            raise ValueError(f"the checkpoint's optimizer state does not hold "
                             f"{self.cfg.optimizer}'s")
        if adam is not None:
            moments = []
            for key in ("mu", "nu"):
                copy_ = copy.deepcopy(self.module).requires_grad_(False)
                for p in copy_.parameters():
                    p.zero_()
                self._load_flax_tree(copy_, adam[key])
                moments.append(list(copy_.parameters()))
            step = torch.tensor(float(adam["count"]))
            for p, m, v in zip(self.module.parameters(), *moments):
                self.optimizer.state[p] = {"step": step.clone(), "exp_avg": m.clone(),
                                           "exp_avg_sq": v.clone()}
        self.step_count = int(state["step"])
        self.n_skipped = int(state["n_skipped"])
        self.train_time = float(raw["train_time"])

    def store_checkpoint(self, path: Path | None = None) -> Path:
        """Write the payload to ``path`` or ``{out_dir}/ckpt/ckpt{step:06d}.pt``."""
        if not (self.out_dir or path):
            raise ValueError("store_checkpoint needs an out_dir or a path")
        path = Path(path) if path else self.out_dir / CKPT_DIR / f"ckpt{self.step_count:06d}.pt"
        torch.save(self.save_attrs(), path)
        return path

    def latest_checkpoint(self) -> Path | None:
        """The newest ``{out_dir}/ckpt/ckpt*.pt`` or JAX ``ckpt*.msgpack`` by
        modification time."""
        if not self.out_dir:
            return None
        ckpts = [p for pattern in ("ckpt*.pt", "ckpt*.msgpack")
                 for p in (self.out_dir / CKPT_DIR).glob(pattern)]
        ckpts.sort(key=lambda p: (p.stat().st_mtime, p.name))
        return ckpts[-1] if ckpts else None

    def load_checkpoint(self, path: Path | None = None) -> bool:
        """Restore ``path`` or the latest checkpoint onto this solver's device;
        False when there is none. A ``.msgpack`` file is the JAX package's
        (``restore_jax_attrs``). Call ``setup()`` first."""
        path = path or self.latest_checkpoint()
        if path is None:
            return False
        if self.optimizer is None:
            raise RuntimeError("call setup() before load_checkpoint()")
        if Path(path).suffix == ".msgpack":
            from ..utils.flax_msgpack import load

            self.restore_jax_attrs(load(path))
        else:
            self.restore_attrs(torch.load(path, map_location=self.device, weights_only=True))
        return True


def _find_adam_state(tree):
    """The node of optax's optimizer state with 'count', 'mu' and 'nu'
    (``ScaleByAdamState``, nested under integer keys when chained), or
    None."""
    if not isinstance(tree, dict):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    found = [n for n in map(_find_adam_state, tree.values()) if n is not None]
    if len(found) > 1:
        raise ValueError("more than one Adam state in the optimizer state")
    return found[0] if found else None


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
