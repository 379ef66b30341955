"""Diffusion-based samplers (counterpart of sde_sampler_lrds_tpu/solvers/oc.py):
TrainableDiff and its algorithms

  PIS   : a Dirac prior; the reference is the SDE's marginal of the prior
          point; the analytic inference control is that marginal's score.
  DDS   : the Gaussian prior is the reference.
  Bridge: DIS / GBS, the time-reversal losses with an optional learned
          inference control.
  CMCD  : the annealed-Langevin SDE built from the prior's and the target's
          scores, with a refittable Gaussian prior.
  RDS   : the reference process switchable between 'default' (VP and
          PinnedBM), 'gaussian', 'gmm' and 'nn' (a trained EBM potential),
          each stored in and restored from RDS's checkpoints.

Routing, as in the JAX package: plain-LV training takes the flat path
(``lv_flat_call``), whose gradient-free simulation runs through
``ops/fused_traj`` when the (loss, control, reference) triple is in the
kernel's scope (outside it, on the card, the loss's own loop replayed as a
CUDA graph: 'flat_lv_graph'); KL training takes the fused KL path (``kl_fused_call``
through ``fused_kl_traj``) when the triple is in scope with a float32
control; an evaluation without trajectories runs through the fused
trajectory with its noise drawn in the kernel. ``fused_traj`` launches the
CUDA kernel for tensors on the card and runs its plain version for tensors
on the CPU, so the paths are named after the device: 'flat_lv_fused' /
'kl_fused' / 'fused' on CUDA, 'flat_lv_plain' / 'kl_plain' / 'plain' on the
CPU. The 'nn' reference has no precompute protocol, so it keeps B1 off:
its flat LV simulation is the graphed loop ('flat_lv_graph') on the card.
"""
from __future__ import annotations

import copy
import logging

import torch

from torch import nn

from ..losses.base import compute_results
from ..ops.fused_traj import build_plan, fused_kl_traj, fused_simulate, fused_traj_states
from ..sde.integrator import integrate_sde
from ..sde.langevin import ControlledLangevinSDE, ControlledSDE
from ..targets.base import Target, WrapperDistrNN
from ..targets.delta import Delta
from ..targets.gauss import (Gauss, GaussFull, score_gauss, score_gauss_full, score_mog,
                             score_mog_full)
from ..utils.common import Results, clip_norm
from .base import Trainable, TrainConfig

_CALL_ARGS = {"terminal_unnorm_log_prob", "reference_log_prob", "initial_log_prob"}


class TrainableDiff(Trainable):
    """Shared machinery for diffusion samplers. ``ctrl_wrapper``, when set,
    maps the control module to the callable the losses use (the JAX
    package's rebinding of ``ctrl_fn``: the Langevin-init control under RDS
    minus the reference score)."""

    eubo_available = True  # PIS and DDS have none
    ctrl_wrapper = None

    def __init__(self, target: Target, prior, sde, generative_ctrl,
                 loss_cls, loss_kwargs: dict | None = None,
                 train_ts=None, eval_ts=None, clip_target: float | None = None,
                 cfg: TrainConfig | None = None, device=None, out_dir=None):
        super().__init__(target, cfg=cfg, device=device, out_dir=out_dir)
        self.prior = prior
        self.sde = sde
        self.generative_ctrl = generative_ctrl.to(self.device)
        self.loss_cls = loss_cls
        self.loss_kwargs = dict(loss_kwargs or {})
        self.train_ts = train_ts
        self.eval_ts = eval_ts if eval_ts is not None else train_ts
        self.clip_target = clip_target
        self.loss = None
        self._graph = None
        self.setup_models()

    @property
    def module(self) -> torch.nn.Module:
        return self.generative_ctrl

    def _generative(self, module: nn.Module) -> nn.Module:
        """The generative control inside ``module`` (this solver's module or
        its EMA copy)."""
        return module

    def _bind(self, module: nn.Module):
        return module if self.ctrl_wrapper is None else self.ctrl_wrapper(module)

    def train_ctrl(self):
        """The control the training losses call."""
        return self._bind(self.generative_ctrl)

    def eval_ctrl(self, use_ema: bool = True):
        """The control the evaluation calls (the EMA copy's with ``use_ema``
        and ``cfg.use_ema``)."""
        return self._bind(self._generative(self.eval_module(use_ema)))

    def _eval_kwargs(self, use_ema: bool = True) -> dict:
        """Extra keyword arguments of the loss's eval (Bridge: its learned
        inference control)."""
        return {}

    # -- model / loss wiring ----------------------------------------------
    def setup_models(self):
        self.loss_kwargs.setdefault("filter_samples", getattr(self.target, "filter", None))
        self.loss = self.loss_cls(sde=self.sde, **self.loss_kwargs)

    def clipped_target_unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return clip_norm(self.target.unnorm_log_prob(x), self.clip_target)

    def loss_call_args(self, use_ema: bool = False) -> dict:
        """Terminal/initial/reference log-prob wiring per algorithm."""
        raise NotImplementedError

    # -- training ------------------------------------------------------------
    def loss_fn(self, generator, x0=None, noise=None):
        """(loss, metrics) for one batch of ``train_batch_size`` prior draws
        (or the fed ``x0``, with the fed per-step ``noise``)."""
        x = x0 if x0 is not None else self.prior.sample(
            generator, (self.cfg.train_batch_size,))
        ctrl = self.train_ctrl()
        if self._flat_lv_ok():
            return self.loss.lv_flat_call(
                generator, self.train_ts, x, ctrl,
                traj_fn=self._flat_traj_fn(), noise=noise, **self.loss_call_args())
        kl_fn = self._fused_kl_fn()
        if kl_fn is not None:
            return self.loss.kl_fused_call(
                generator, self.train_ts, x, ctrl,
                traj_rnd_fn=kl_fn, noise=noise, **self.loss_call_args())
        return self.loss(generator, self.train_ts, x, ctrl,
                         noise=noise, **self.loss_call_args())

    def _flat_lv_ok(self) -> bool:
        """Flat LV training path eligibility (``TrainConfig.flat_lv``)."""
        mode = self.cfg.flat_lv
        if mode not in ("auto", "off"):
            raise ValueError(f"train.flat_lv must be 'auto' or 'off', got {mode!r}")
        return (mode == "auto" and self.loss.is_lv
                and hasattr(self.loss, "lv_flat_call")
                and self.loss.sde_ctrl_noise is None and self.loss.sde_ctrl_dropout is None
                and self.loss.supports_flat_lv(self.train_ts,
                                               frozenset(self.loss_call_args())))

    def _flat_traj_fn(self):
        """The simulation of the flat LV path, ``(x0, zs) -> (xs, x_T)``: the
        fused trajectory when the triple is in the kernel's scope; outside
        it, on the card, the loss's own loop (``flat_states``) replayed as a
        CUDA graph; on the CPU None (lv_flat_call then runs the loop)."""
        plan = build_plan(self.loss, self.generative_ctrl, self.train_ts)
        if plan is not None:
            cfg, arrays = plan
            return lambda x0, zs: fused_traj_states(cfg, arrays, x0, zs)
        return self._graphed_states if self.device.type == "cuda" else None

    def _graphed_states(self, x0: torch.Tensor, zs: torch.Tensor):
        """``loss.flat_states`` through a CUDA graph captured at the first
        call and replayed after it; captured again when the loss, the
        shapes or a scheduled hyperparameter change (the graph holds the
        values read while capturing, and the parameters by address: the
        optimizer updates them in place)."""
        key = (id(self.loss), tuple(x0.shape), tuple(zs.shape),
               repr([s.get() for s in self._param_schedulers]))
        if self._graph is None or self._graph[0] != key:
            args, ctrl = self.loss_call_args(), self.train_ctrl()
            fn = lambda x, z: self.loss.flat_states(self.train_ts, x, ctrl, z, **args)
            self._graph = (key, GraphedCall(fn, x0, zs))
        return self._graph[1](x0, zs)

    def _fused_kl_fn(self):
        """The differentiable fused trajectory for KL training, ``(x0, zs)
        -> (x_T, rnd)``, or None (``TrainConfig.fused_kl``). Its plan is
        built from the live parameters with the MLP tables' graph kept, so
        the adjoint's table cotangents reach every parameter. Scope: a KL
        loss that ``supports_fused_kl``, the kernel's scope, a float32
        control (a bf16 plan returns None, as in the JAX package). The JAX
        package's 'auto' keeps this path off on a non-TPU backend and 'force'
        lifts that; here 'auto' and 'force' take it on either device, as the
        flat LV path does: on the CPU its forward is the plain version."""
        mode = self.cfg.fused_kl
        if mode not in ("auto", "off", "force"):
            raise ValueError(f"train.fused_kl must be 'auto', 'off' or 'force', got {mode!r}")
        loss = self.loss
        if (mode == "off" or not hasattr(loss, "kl_fused_call")
                or not loss.supports_fused_kl(self.train_ts, frozenset(self.loss_call_args()))):
            return None
        plan = build_plan(loss, self.generative_ctrl, self.train_ts, differentiable=True,
                          ito=getattr(loss, "fused_train_ito", True))
        if plan is None or plan[0].bf16:
            return None
        cfg, arrays = plan
        return lambda x0, zs: fused_kl_traj(cfg, arrays, x0, zs)

    def _fused_name(self, name: str) -> str:
        return name + ("fused" if self.device.type == "cuda" else "plain")

    @torch.no_grad()
    def train_path(self) -> str:
        """Which training path ``loss_fn`` takes for the current config:
        'flat_lv_fused' (CUDA kernel) / 'flat_lv_plain' (its plain version on
        the CPU), 'flat_lv_graph' / 'flat_lv_scan' (the loss's own loop, as a
        CUDA graph on the card / eagerly on the CPU), 'kl_fused' /
        'kl_plain' (the fused KL path, its forward the kernel / the plain
        version), or 'scan'."""
        if self._flat_lv_ok():
            if build_plan(self.loss, self.generative_ctrl, self.train_ts) is not None:
                return self._fused_name("flat_lv_")
            return "flat_lv_graph" if self.device.type == "cuda" else "flat_lv_scan"
        if self._fused_kl_fn() is not None:
            return self._fused_name("kl_")
        return "scan"

    # -- evaluation --------------------------------------------------------
    def _fused_eval_plan(self, use_ema: bool = True, ito: bool = True):
        """build_plan for the eval grid, or None when the fused eval is
        switched off or out of scope. ``ito`` is the evaluation's
        ``compute_weights`` (original DDS makes the RND's u·z term
        optional with it)."""
        mode = self.cfg.fused_eval
        if mode not in ("auto", "off"):
            raise ValueError(f"train.fused_eval must be 'auto' or 'off', got {mode!r}")
        args = set(self.loss_call_args())
        if mode == "off" or "terminal_unnorm_log_prob" not in args or not args <= _CALL_ARGS:
            return None
        return build_plan(self.loss, self._generative(self.eval_module(use_ema)),
                          self.eval_ts, ito=ito)

    def eval_path(self) -> str:
        """'fused' / 'plain' when evaluate() runs the fused trajectory, else 'scan'."""
        return self._fused_name("") if self._fused_eval_plan() is not None else "scan"

    @torch.no_grad()
    def evaluate(self, generator: torch.Generator, use_ema: bool = True,
                 compute_weights: bool = True, return_traj: bool = False) -> Results:
        """Evaluation pass over ``eval_batch_size`` prior draws. Without
        trajectories and in the kernel's scope it runs the fused trajectory
        (kernel noise on the card); otherwise the loss's own loop."""
        plan = None if return_traj else self._fused_eval_plan(use_ema, ito=compute_weights)
        x = self.prior.sample(generator, (self.cfg.eval_batch_size,))
        if plan is not None:
            cfg, arrays = plan
            samples, rnd = fused_simulate(cfg, arrays, generator, x,
                                          **self.loss_call_args(use_ema))
            return compute_results(rnd, compute_weights=compute_weights,
                                   ts=self.eval_ts, max_rnd=self.loss.max_rnd,
                                   samples=samples)
        return self.loss.eval(generator, self.eval_ts, x, self.eval_ctrl(use_ema),
                              compute_weights=compute_weights, return_traj=return_traj,
                              **self.loss_call_args(use_ema), **self._eval_kwargs(use_ema))

    def compute_eubo(self, generator: torch.Generator, x_target: torch.Tensor,
                     use_ema: bool = True, noise: torch.Tensor | None = None) -> torch.Tensor:
        """The per-sample log-ratio of the noising pass from target samples
        ``x_target`` (its mean is the EUBO); raises where the loss has no
        reverse pass (the DDPM-like integrator) or the solver has none (PIS,
        DDS)."""
        if not self.eubo_available or getattr(self.loss, "compute_eubo", None) is None:
            raise NotImplementedError(
                f"EUBO is not defined for {type(self).__name__} with "
                f"{type(self.loss).__name__} (e.g. the DDPM-like integrator "
                f"has no reverse pass)")
        return self.loss.compute_eubo(generator, self.eval_ts, x_target,
                                      self.eval_ctrl(use_ema), noise=noise,
                                      **self.loss_call_args(use_ema))

    @torch.no_grad()
    def sample_inference_traj(self, generator: torch.Generator, n: int,
                              noise: torch.Tensor | None = None) -> torch.Tensor:
        """Noising trajectories (K+1, n, D) from ``n`` target draws along the
        inference SDE (the plain SDE where the solver has no other)."""
        x = self.target.sample(generator, (n,))
        sde = getattr(self, "inference_sde", self.sde)
        return integrate_sde(sde, generator, self.eval_ts, x, return_traj=True, noise=noise)

    def load_flax_params(self, params: dict) -> None:
        """Load the Flax parameter tree of the JAX package's solver
        (``state.params``, as numpy arrays) into the control, with a fresh
        optimizer and EMA copy."""
        from ..models.mlp import load_flax_params

        load_flax_params(self.generative_ctrl, params)
        self.reset_optimizer()

    def fused_eval_sampler(self, use_ema: bool = True):
        """``generator -> (x_T, rnd)`` drawing ``eval_batch_size``
        trajectories through the fused trajectory, or None when out of
        scope. The plan is built here, so it sees the current parameters."""
        plan = self._fused_eval_plan(use_ema)
        if plan is None:
            return None
        cfg, arrays = plan
        args = self.loss_call_args(use_ema)

        @torch.no_grad()
        def sample(generator: torch.Generator):
            x0 = self.prior.sample(generator, (self.cfg.eval_batch_size,))
            return fused_simulate(cfg, arrays, generator, x0, **args)

        return sample


class GraphedCall:
    """``fn(x0, zs)`` without autograd, captured once as a CUDA graph on
    static copies of its inputs (after two warm-up calls on a side stream)
    and replayed for each new pair: the inputs are copied in and the
    outputs copied out. The tensors ``fn`` reads besides its inputs (the
    parameters, the time grid) are read by address at every replay. A score
    that ``fn`` takes by autograd inside is captured with its backward pass
    (bitwise equal to the eager call with cuDNN off; cuDNN's convolution
    backward is not bitwise repeatable, in eager calls either)."""

    def __init__(self, fn, x0: torch.Tensor, zs: torch.Tensor):
        self.x0, self.zs = x0.detach().clone(), zs.detach().clone()
        stream = torch.cuda.current_stream(x0.device)
        side = torch.cuda.Stream(x0.device)
        side.wait_stream(stream)
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                fn(self.x0, self.zs)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.out = fn(self.x0, self.zs)

    def __call__(self, x0: torch.Tensor, zs: torch.Tensor):
        self.x0.copy_(x0)
        self.zs.copy_(zs)
        self.graph.replay()
        return tuple(o.clone() for o in self.out)


class _BridgeModules(nn.Module):
    """Bridge's trainable module with a learned inference control: the
    generative and the inference control side by side (the JAX package's
    {"generative", "inference"} parameter tree)."""

    def __init__(self, generative: nn.Module, inference: nn.Module):
        super().__init__()
        self.generative = generative
        self.inference = inference

    def reset_parameters(self, generator=None) -> None:
        self.generative.reset_parameters(generator)
        self.inference.reset_parameters(generator)


class Bridge(TrainableDiff):
    """DIS / GBS: the time-reversal losses, with an optional learned
    inference control. With one, training keeps to the loss's own loop and
    the evaluation to the loss's eval, by the solver's rule: the fused
    trajectory has no inference control."""

    def __init__(self, *args, inference_ctrl: nn.Module | None = None, **kwargs):
        self.inference_ctrl_module = inference_ctrl
        self._both = None
        super().__init__(*args, **kwargs)

    def setup_models(self):
        super().setup_models()
        self.inference_sde = self.sde
        if self.inference_ctrl_module is None and not isinstance(self.prior, Gauss):
            raise ValueError("Can only be used with Gaussian prior.")
        if self.inference_ctrl_module is not None and self._both is None:
            self.inference_ctrl_module = self.inference_ctrl_module.to(self.device)
            self._both = _BridgeModules(self.generative_ctrl, self.inference_ctrl_module)

    @property
    def module(self) -> nn.Module:
        return self.generative_ctrl if self._both is None else self._both

    def _generative(self, module: nn.Module) -> nn.Module:
        return module.generative if isinstance(module, _BridgeModules) else module

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "initial_log_prob": self.prior.log_prob}

    def loss_fn(self, generator, x0=None, noise=None, div_probes=None):
        """As TrainableDiff's, and with a learned inference control the
        loss's own loop (``div_probes`` feeds its Hutchinson probes)."""
        if self._both is None:
            return super().loss_fn(generator, x0=x0, noise=noise)
        x = x0 if x0 is not None else self.prior.sample(
            generator, (self.cfg.train_batch_size,))
        return self.loss(generator, self.train_ts, x, self.train_ctrl(),
                         inference_ctrl=self._both.inference, noise=noise,
                         div_probes=div_probes, **self.loss_call_args())

    def _flat_lv_ok(self) -> bool:
        return self._both is None and super()._flat_lv_ok()

    def _fused_kl_fn(self):
        return None if self._both is not None else super()._fused_kl_fn()

    def _fused_eval_plan(self, use_ema: bool = True, ito: bool = True):
        if self._both is not None:
            return None
        return super()._fused_eval_plan(use_ema, ito=ito)

    def _eval_kwargs(self, use_ema: bool = True) -> dict:
        if self._both is None:
            return {}
        return {"inference_ctrl": self.eval_module(use_ema).inference}

    def load_flax_params(self, params: dict) -> None:
        """The JAX Bridge's {"generative", "inference"} parameter tree."""
        from ..models.mlp import load_flax_params

        load_flax_params(self.generative_ctrl, params["generative"])
        if self._both is not None:
            load_flax_params(self._both.inference, params["inference"])
        self.reset_optimizer()


class CMCD(TrainableDiff):
    """Controlled Monte Carlo diffusion over the tempering path. Its
    annealed-Langevin SDE is built here from the prior's and the target's
    scores (clip_score 1e5 where the given SDE sets none, as in the JAX
    package, whose LV training diverges without it); ``update_prior``
    refits the Gaussian prior, and the refit is part of the checkpoint."""

    def setup_models(self):
        if not isinstance(self.prior, (Gauss, GaussFull)):
            raise ValueError("Can only be used with gaussian prior.")
        if not isinstance(self.sde, ControlledLangevinSDE):
            self.sde = ControlledLangevinSDE(
                target_score=self.target.score, prior_score=self.prior.score,
                diff_coeff=getattr(self.sde, "diff_coeff", 1.0),
                terminal_t=getattr(self.sde, "terminal_t", 1.0),
                clip_score=getattr(self.sde, "clip_score", None) or 1e5)
        self.inference_sde = self.sde
        self.prior_fit = None
        super().setup_models()

    def update_prior(self, mean, var):
        """Refit the Gaussian prior: full covariance for a (D, D) ``var``,
        else diagonal variances."""
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        mean, var = as_t(mean), as_t(var)
        dim = mean.shape[0]
        if var.ndim == 2:
            self.prior = GaussFull(dim=dim, loc=mean, cov=var, device=self.device)
        else:
            self.prior = Gauss(dim=dim, loc=mean, scale=torch.sqrt(var), device=self.device)
        self.prior_fit = {"mean": mean, "var": var}
        self.sde = ControlledLangevinSDE(
            target_score=self.target.score, prior_score=self.prior.score,
            diff_coeff=self.sde.diff_coeff, terminal_t=self.sde.terminal_t,
            clip_score=self.sde.clip_score)
        self.inference_sde = self.sde
        self.loss = self.loss_cls(sde=self.sde, **self.loss_kwargs)

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "initial_log_prob": self.prior.log_prob}

    def save_attrs(self) -> dict:
        attrs = super().save_attrs()
        if self.prior_fit is not None:
            attrs["prior_fit"] = dict(self.prior_fit)
        return attrs

    def restore_attrs(self, raw: dict) -> None:
        super().restore_attrs(raw)
        if raw.get("prior_fit") is not None:
            self.update_prior(raw["prior_fit"]["mean"], raw["prior_fit"]["var"])


class PIS(TrainableDiff):
    """Path integral sampler: a Dirac prior; the reference is the SDE's
    marginal of the prior point."""

    eubo_available = False

    def setup_models(self):
        if not isinstance(self.prior, Delta):
            raise ValueError("Can only be used with dirac delta prior.")
        loc = self.prior.loc[0]
        T = torch.tensor(self.sde.terminal_t, device=self.device)
        self.reference_log_prob = lambda x: self.sde.marginal_log_prob(T, x, loc)
        self.inference_sde = ControlledSDE(self.sde, self.analytic_inference_ctrl)
        super().setup_models()

    def analytic_inference_ctrl(self, t, x):
        """g(t)·∇log of the noised prior point's marginal, clipped at 1e5."""
        score = self.sde.marginal_score(torch.as_tensor(t, device=x.device), x,
                                        self.prior.loc[0])
        return self.sde.diff(t, x) * torch.clamp(score, max=1e5)

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "reference_log_prob": self.reference_log_prob}


class DDS(TrainableDiff):
    """Denoising diffusion sampler: the Gaussian prior is the reference."""

    eubo_available = False

    def setup_models(self):
        if not isinstance(self.prior, Gauss):
            raise ValueError("Can only be used with Gaussian prior.")
        self.reference_log_prob = self.prior.log_prob
        super().setup_models()

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "reference_log_prob": self.reference_log_prob}


def _per_step(ctrl, t, x):
    """A reference score at per-step times over flat states (t (K, 1), x
    (K, B, D), as flat_ctrl_eval calls a control): one step at a time, so a
    full-covariance reference never forms a (K, B, C, D, D) tensor."""
    return torch.stack([ctrl(t_k, x_k) for t_k, x_k in zip(t.reshape(-1), x)])


class _Factored:
    """``factored()``: the reference's covariances with raw full matrices
    replaced by their (eig, P), from one torch.linalg.eigh kept on the
    object (diagonal and already factored ones unchanged). Its tables then
    need no factorization and so no host sync, which lets a CUDA graph
    capture the loss's loop; B1's plans take the same factors."""

    _full_ndim = 3

    def factored(self):
        var = self._covariances()
        if isinstance(var, tuple) or var is None or var.ndim != self._full_ndim:
            return var
        cached = getattr(self, "_eigh", None)
        if cached is None or cached[0] is not var:
            cached = self._eigh = (var, tuple(torch.linalg.eigh(var)))
        return cached[1]


class GaussianReferenceCtrl(_Factored):
    """Time-t score of a noised Gaussian reference (diagonal, full or
    eigen-factored (eig, P) covariance) with a precompute protocol:
    ``precompute(t_grid)`` evaluates the noised marginal's parameters for
    every grid time at once (a full covariance through its factors),
    ``apply`` takes one step's."""

    _full_ndim = 2

    def __init__(self, sde, x_init, var_init):
        self.sde = sde
        self.x_init = x_init
        self.var_init = var_init

    def _covariances(self):
        return self.var_init

    def __call__(self, t, x):
        if x.ndim == 3:
            return _per_step(self, t, x)
        return self.sde.marginal_score(torch.as_tensor(t).reshape(()), x, self.x_init,
                                       var_init=self.var_init)

    def precompute(self, t_grid):
        return self.sde.marginal_params(t_grid[:, None], self.x_init,
                                        var_init=self.factored())

    @staticmethod
    def apply(step_params, x):
        loc, var = step_params
        if isinstance(var, tuple):
            return score_gauss_full(x, loc, None, precisions=var[0])
        if var.ndim == 2:
            return score_gauss_full(x, loc, var)
        return score_gauss(x, loc, var)


class GMMReferenceCtrl(_Factored):
    """Time-t score of a noised GMM reference (diagonal, full or
    eigen-factored (eig, P) covariances) with a precompute protocol (full
    covariances through their factors)."""

    def __init__(self, sde, means, variances, weights):
        self.sde = sde
        self.means = means
        self.variances = variances
        self.weights = weights

    def _covariances(self):
        return self.variances

    def __call__(self, t, x):
        if x.ndim == 3:
            return _per_step(self, t, x)
        return self.sde.marginal_gmm_score(torch.as_tensor(t).reshape(()), x, self.means,
                                           self.variances, self.weights)

    def precompute(self, t_grid):
        w, m, v = self.sde.marginal_gmm_params(
            t_grid[:, None, None], self.means, self.factored(), self.weights)
        if not isinstance(v, tuple) and v.ndim < 4:        # scalar or diagonal
            v = torch.broadcast_to(v, m.shape)
        return torch.broadcast_to(w, m.shape[:2]), m, v

    @staticmethod
    def apply(step_params, x):
        w, m, v = step_params
        if isinstance(v, tuple):
            return score_mog_full(x, w, m, None, precisions=v[0], covariances_log_det=v[1])
        if v.ndim == 3:
            return score_mog_full(x, w, m, v)
        return score_mog(x, w, m, v)


class NNReferenceCtrl:
    """Time-t score of a trained EBM potential (``net(t, x)`` with one time
    a row): a time per step over (B, D) states, or per-step times (K, 1)
    over flat (K, B, D) states, evaluated as one (K·B) batch. No precompute
    protocol, so the fused trajectory does not take it."""

    def __init__(self, net):
        self.net = net

    def __call__(self, t, x):
        t = torch.as_tensor(t, device=x.device)
        t = t.reshape((-1,) + (1,) * (x.ndim - 2)) if t.numel() > 1 else t.reshape(())
        rows = torch.broadcast_to(t, x.shape[:-1]).reshape(-1)
        return self.net(rows, x.reshape(-1, x.shape[-1])).reshape(x.shape)


class RDS(TrainableDiff):
    """Learned reference-based diffusion sampler."""

    _nn_module = None
    _nn_eps = 1e-4

    def setup_models(self):
        self.change_reference_type(ref_type="default")
        self.loss_kwargs.setdefault("filter_samples", getattr(self.target, "filter", None))
        self._rebuild_loss()

    def _rebuild_loss(self):
        kwargs = dict(self.loss_kwargs)
        kwargs["reference_ctrl"] = self.reference_score_t
        self.loss = self.loss_cls(sde=self.sde, **kwargs)

    def change_reference_type(self, ref_type: str = "default", net=None, eps=None, mean=None,
                              var=None, means=None, variances=None, weights=None):
        """Install the reference process: 'default' (the prior's Gaussian
        for VP; N(prior loc, T·g²) for PinnedBM), 'gaussian' or 'gmm'
        (variances diagonal, full ((D, D) or (C, D, D)) or an
        eigendecomposition (eig, P), as tensors or numpy arrays), or 'nn': a
        trained EBM potential (an nn.Module whose call is its score and
        with ``unnorm_log_prob(t, x)``), frozen as a copy on this solver's
        device — its score at each step's time is the reference score and
        its log-density at ``eps`` (default 1e-4) the reference log-prob —
        or a (score(t, x), unnorm_log_prob(t, x)) pair of callables, which
        checkpoints cannot carry."""
        from ..sde.linear import VP, PinnedBM

        sde = self.sde

        def as_t(a):
            if isinstance(a, tuple):
                return tuple(as_t(v) for v in a)
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        zero = torch.zeros((), device=self.device)
        if ref_type == "default":
            loc = torch.reshape(self.prior.loc, (-1,))
            if isinstance(sde, VP):
                var0 = torch.reshape(torch.square(self.prior.scale), (-1,))
            elif isinstance(sde, PinnedBM):
                var0 = sde.terminal_t * sde.diff_coeff**2 * torch.ones_like(loc)
            else:
                raise ValueError(f"Default reference for SDE type {type(sde)} unsupported.")
            self.reference_distr_utils = {"x_init": loc, "var_init": var0}
            self.reference_log_prob = lambda x: sde.marginal_log_prob(
                zero, x, loc, var_init=var0)
            self.reference_score_t = GaussianReferenceCtrl(sde, loc, var0)
        elif ref_type == "gaussian":
            mean, var = as_t(mean), as_t(var)
            self.reference_distr_utils = {"x_init": mean, "var_init": var}
            self.reference_score_t = GaussianReferenceCtrl(sde, mean, var)
            # a full covariance through its factors: no solve in the loss's loop
            var_f = self.reference_score_t.factored()
            self.reference_log_prob = lambda x: sde.marginal_log_prob(
                zero, x, mean, var_init=var_f)
        elif ref_type == "gmm":
            means, variances, weights = as_t(means), as_t(variances), as_t(weights)
            self.reference_distr_utils = {"means_init": means,
                                          "variances_init": variances,
                                          "weights_init": weights}
            self.reference_score_t = GMMReferenceCtrl(sde, means, variances, weights)
            variances_f = self.reference_score_t.factored()
            self.reference_log_prob = lambda x: sde.marginal_gmm_log_prob(
                zero, x, means, variances_f, weights)
        elif ref_type == "nn":
            if isinstance(net, nn.Module):
                module = copy.deepcopy(net).to(self.device).requires_grad_(False)
                self._nn_module = module
                net_score, net_log_prob = module, module.unnorm_log_prob
            else:
                net_score, net_log_prob = net
                module = self._nn_module = None
            self._nn_eps = float(eps if eps is not None else 1e-4)
            self.reference_distr_utils = {"net": module if module is not None else net}
            wrapper = WrapperDistrNN(dim=self.target.dim, unnorm_log_prob_t=net_log_prob,
                                     t=self._nn_eps, device=self.device)
            self.reference_log_prob = wrapper.unnorm_log_prob
            self.reference_score_t = NNReferenceCtrl(net_score)
        else:
            raise NotImplementedError(f"Reference type {ref_type!r} is unknown.")
        self.ref_type = ref_type
        if self.loss is not None:
            self._rebuild_loss()

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "reference_log_prob": self.reference_log_prob}

    # -- checkpointing: the installed reference ------------------------------
    def save_attrs(self) -> dict:
        """The trainer's payload and the reference: its type and parameters,
        an eigen-factored (eig, P) variance as a two-entry list; for 'nn',
        ``eps`` and the potential's state_dict (none for a pair of
        callables)."""
        attrs = super().save_attrs()
        ref = {"ref_type": self.ref_type}
        for k, v in self.reference_distr_utils.items():
            if k == "net":
                continue
            ref[k] = list(v) if isinstance(v, tuple) else v
        if self.ref_type == "nn":
            ref["eps"] = self._nn_eps
            net = self.reference_distr_utils["net"]
            if isinstance(net, nn.Module):
                ref["net_state"] = net.state_dict()
        attrs["reference"] = ref
        return attrs

    def restore_attrs(self, raw: dict) -> None:
        """Restore the payload and install the stored reference through
        ``change_reference_type``, whatever reference this solver was built
        with."""
        super().restore_attrs(raw)
        ref = raw.get("reference")
        if ref is None:
            return
        ref_type = ref["ref_type"]
        if ref_type == "default":
            self.change_reference_type("default")
        elif ref_type == "gaussian":
            self.change_reference_type("gaussian", mean=ref["x_init"],
                                       var=_maybe_tuple(ref["var_init"]))
        elif ref_type == "gmm":
            self.change_reference_type("gmm", weights=ref["weights_init"],
                                       means=ref["means_init"],
                                       variances=_maybe_tuple(ref["variances_init"]))
        elif ref_type == "nn":
            if "net_state" not in ref:
                # saved from a pair of callables: keep an installed 'nn'
                # reference and restore the rest; raise when none is
                if self.ref_type == "nn":
                    logging.warning(
                        "Checkpoint has ref_type='nn' with no serialized "
                        "params (closure-form net); keeping the currently "
                        "installed 'nn' reference.")
                    return
                raise ValueError(
                    "Checkpoint has ref_type='nn' but no serialized params: it "
                    "was saved from a closure-form net. Re-install the EBM via "
                    "change_reference_type('nn', net=...) before loading, "
                    "or save with an nn.Module potential.")
            if self._nn_module is None:
                raise ValueError(
                    "Restoring an 'nn' reference needs the potential's architecture: "
                    "install the same EBM via change_reference_type('nn', net=module) "
                    "first, then load_checkpoint() to restore the trained params.")
            module = copy.deepcopy(self._nn_module)
            module.load_state_dict(ref["net_state"])
            self.change_reference_type("nn", net=module, eps=ref.get("eps"))
        else:
            raise NotImplementedError(f"Reference type {ref_type!r} in checkpoint.")


def _maybe_tuple(v):
    """A stored (eig, P) variance comes back as a list."""
    return tuple(v) if isinstance(v, (list, tuple)) else v
