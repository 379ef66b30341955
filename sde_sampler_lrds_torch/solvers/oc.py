"""Diffusion-based samplers (counterpart of sde_sampler_lrds_tpu/solvers/oc.py;
only TrainableDiff, the tabulated Gaussian / GMM reference controls and RDS
are ported yet, with reference types 'default' (VP and PinnedBM),
'gaussian' and 'gmm', each stored in and restored from RDS's checkpoints).

Routing, as in the JAX package: plain-LV training takes the flat path
(``lv_flat_call``), whose gradient-free simulation runs through
``ops/fused_traj`` when the (loss, control, reference) triple is in the
kernel's scope; KL training takes the fused KL path (``kl_fused_call``
through ``fused_kl_traj``) when the triple is in scope with a float32
control; an evaluation without trajectories runs through the fused
trajectory with its noise drawn in the kernel. ``fused_traj`` launches the
CUDA kernel for tensors on the card and runs its plain version for tensors
on the CPU, so the paths are named after the device: 'flat_lv_fused' /
'kl_fused' / 'fused' on CUDA, 'flat_lv_plain' / 'kl_plain' / 'plain' on the
CPU.
"""
from __future__ import annotations

import torch

from ..losses.base import compute_results
from ..ops.fused_traj import build_plan, fused_kl_traj, fused_simulate, fused_traj_states
from ..targets.base import Target
from ..targets.gauss import score_gauss, score_gauss_full, score_mog, score_mog_full
from ..utils.common import Results, clip_norm
from .base import Trainable, TrainConfig

_CALL_ARGS = {"terminal_unnorm_log_prob", "reference_log_prob", "initial_log_prob"}


class TrainableDiff(Trainable):
    """Shared machinery for diffusion samplers."""

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
        self.setup_models()

    @property
    def module(self) -> torch.nn.Module:
        return self.generative_ctrl

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
        if self._flat_lv_ok():
            return self.loss.lv_flat_call(
                generator, self.train_ts, x, self.generative_ctrl,
                traj_fn=self._flat_traj_fn(), noise=noise, **self.loss_call_args())
        kl_fn = self._fused_kl_fn()
        if kl_fn is not None:
            return self.loss.kl_fused_call(
                generator, self.train_ts, x, self.generative_ctrl,
                traj_rnd_fn=kl_fn, noise=noise, **self.loss_call_args())
        return self.loss(generator, self.train_ts, x, self.generative_ctrl,
                         noise=noise, **self.loss_call_args())

    def _flat_lv_ok(self) -> bool:
        """Flat LV training path eligibility (``TrainConfig.flat_lv``)."""
        mode = self.cfg.flat_lv
        if mode not in ("auto", "off"):
            raise ValueError(f"train.flat_lv must be 'auto' or 'off', got {mode!r}")
        return (mode == "auto" and self.loss.is_lv
                and hasattr(self.loss, "lv_flat_call")
                and self.loss.supports_flat_lv(self.train_ts,
                                               frozenset(self.loss_call_args())))

    def _flat_traj_fn(self):
        """The fused trajectory for the flat LV path, ``(x0, zs) -> (xs,
        x_T)``, or None (lv_flat_call then simulates with the loss's loop)
        when the triple is outside the kernel's scope."""
        plan = build_plan(self.loss, self.generative_ctrl, self.train_ts)
        if plan is None:
            return None
        cfg, arrays = plan
        return lambda x0, zs: fused_traj_states(cfg, arrays, x0, zs)

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
        plan = build_plan(loss, self.generative_ctrl, self.train_ts, differentiable=True)
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
        the CPU), 'flat_lv_scan' (the loss's own loop), 'kl_fused' /
        'kl_plain' (the fused KL path, its forward the kernel / the plain
        version), or 'scan'."""
        if self._flat_lv_ok():
            return (self._fused_name("flat_lv_") if self._flat_traj_fn() is not None
                    else "flat_lv_scan")
        if self._fused_kl_fn() is not None:
            return self._fused_name("kl_")
        return "scan"

    # -- evaluation --------------------------------------------------------
    def _fused_eval_plan(self, use_ema: bool = True):
        """build_plan for the eval grid, or None when the fused eval is
        switched off or out of scope."""
        mode = self.cfg.fused_eval
        if mode not in ("auto", "off"):
            raise ValueError(f"train.fused_eval must be 'auto' or 'off', got {mode!r}")
        args = set(self.loss_call_args())
        if mode == "off" or "terminal_unnorm_log_prob" not in args or not args <= _CALL_ARGS:
            return None
        return build_plan(self.loss, self.eval_module(use_ema), self.eval_ts)

    def eval_path(self) -> str:
        """'fused' / 'plain' when evaluate() runs the fused trajectory, else 'scan'."""
        return self._fused_name("") if self._fused_eval_plan() is not None else "scan"

    @torch.no_grad()
    def evaluate(self, generator: torch.Generator, use_ema: bool = True,
                 compute_weights: bool = True, return_traj: bool = False) -> Results:
        """Evaluation pass over ``eval_batch_size`` prior draws. Without
        trajectories and in the kernel's scope it runs the fused trajectory
        (kernel noise on the card); otherwise the loss's own loop."""
        plan = None if return_traj else self._fused_eval_plan(use_ema)
        x = self.prior.sample(generator, (self.cfg.eval_batch_size,))
        if plan is not None:
            cfg, arrays = plan
            samples, rnd = fused_simulate(cfg, arrays, generator, x,
                                          **self.loss_call_args(use_ema))
            return compute_results(rnd, compute_weights=compute_weights,
                                   ts=self.eval_ts, max_rnd=self.loss.max_rnd,
                                   samples=samples)
        return self.loss.eval(generator, self.eval_ts, x, self.eval_module(use_ema),
                              compute_weights=compute_weights, return_traj=return_traj,
                              **self.loss_call_args(use_ema))

    def compute_eubo(self, generator: torch.Generator, x_target: torch.Tensor,
                     use_ema: bool = True, noise: torch.Tensor | None = None) -> torch.Tensor:
        """The per-sample log-ratio of the noising pass from target samples
        ``x_target`` (its mean is the EUBO); raises where the loss has no
        reverse pass (the DDPM-like integrator)."""
        if getattr(self.loss, "compute_eubo", None) is None:
            raise NotImplementedError(
                f"EUBO is not defined for {type(self).__name__} with "
                f"{type(self.loss).__name__} (e.g. the DDPM-like integrator "
                f"has no reverse pass)")
        return self.loss.compute_eubo(generator, self.eval_ts, x_target,
                                      self.eval_module(use_ema), noise=noise,
                                      **self.loss_call_args(use_ema))

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


def _per_step(ctrl, t, x):
    """A reference score at per-step times over flat states (t (K, 1), x
    (K, B, D), as flat_ctrl_eval calls a control): one step at a time, so a
    full-covariance reference never forms a (K, B, C, D, D) tensor."""
    return torch.stack([ctrl(t_k, x_k) for t_k, x_k in zip(t.reshape(-1), x)])


class GaussianReferenceCtrl:
    """Time-t score of a noised Gaussian reference (diagonal, full or
    eigen-factored (eig, P) covariance) with a precompute protocol:
    ``precompute(t_grid)`` evaluates the noised marginal's parameters for
    every grid time at once, ``apply`` takes one step's."""

    def __init__(self, sde, x_init, var_init):
        self.sde = sde
        self.x_init = x_init
        self.var_init = var_init

    def __call__(self, t, x):
        if x.ndim == 3:
            return _per_step(self, t, x)
        return self.sde.marginal_score(torch.as_tensor(t).reshape(()), x, self.x_init,
                                       var_init=self.var_init)

    def precompute(self, t_grid):
        return self.sde.marginal_params(t_grid[:, None], self.x_init,
                                        var_init=self.var_init)

    @staticmethod
    def apply(step_params, x):
        loc, var = step_params
        if isinstance(var, tuple):
            return score_gauss_full(x, loc, None, precisions=var[0])
        if var.ndim == 2:
            return score_gauss_full(x, loc, var)
        return score_gauss(x, loc, var)


class GMMReferenceCtrl:
    """Time-t score of a noised GMM reference (diagonal, full or
    eigen-factored (eig, P) covariances) with a precompute protocol."""

    def __init__(self, sde, means, variances, weights):
        self.sde = sde
        self.means = means
        self.variances = variances
        self.weights = weights

    def __call__(self, t, x):
        if x.ndim == 3:
            return _per_step(self, t, x)
        return self.sde.marginal_gmm_score(torch.as_tensor(t).reshape(()), x, self.means,
                                           self.variances, self.weights)

    def precompute(self, t_grid):
        w, m, v = self.sde.marginal_gmm_params(
            t_grid[:, None, None], self.means, self.variances, self.weights)
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


class RDS(TrainableDiff):
    """Learned reference-based diffusion sampler."""

    def setup_models(self):
        self.change_reference_type(ref_type="default")
        self.loss_kwargs.setdefault("filter_samples", getattr(self.target, "filter", None))
        self._rebuild_loss()

    def _rebuild_loss(self):
        kwargs = dict(self.loss_kwargs)
        kwargs["reference_ctrl"] = self.reference_score_t
        self.loss = self.loss_cls(sde=self.sde, **kwargs)

    def change_reference_type(self, ref_type: str = "default", mean=None, var=None,
                              means=None, variances=None, weights=None):
        """Install the reference process: 'default' (the prior's Gaussian
        for VP; N(prior loc, T·g²) for PinnedBM), 'gaussian' or 'gmm'. Variances are diagonal, full ((D, D) or
        (C, D, D)) or an eigendecomposition (eig, P), given as tensors or
        numpy arrays. The 'nn' reference is not ported (ROADMAP A5)."""
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
            self.reference_log_prob = lambda x: sde.marginal_log_prob(
                zero, x, mean, var_init=var)
            self.reference_score_t = GaussianReferenceCtrl(sde, mean, var)
        elif ref_type == "gmm":
            means, variances, weights = as_t(means), as_t(variances), as_t(weights)
            self.reference_distr_utils = {"means_init": means,
                                          "variances_init": variances,
                                          "weights_init": weights}
            self.reference_log_prob = lambda x: sde.marginal_gmm_log_prob(
                zero, x, means, variances, weights)
            self.reference_score_t = GMMReferenceCtrl(sde, means, variances, weights)
        else:
            raise NotImplementedError(
                f"Reference type {ref_type!r} is not ported"
                + (" (ROADMAP A5, learned references)." if ref_type == "nn" else "."))
        self.ref_type = ref_type
        if self.loss is not None:
            self._rebuild_loss()

    def loss_call_args(self, use_ema: bool = False) -> dict:
        return {"terminal_unnorm_log_prob": self.clipped_target_unnorm_log_prob,
                "reference_log_prob": self.reference_log_prob}

    # -- checkpointing: the installed reference ------------------------------
    def save_attrs(self) -> dict:
        """The trainer's payload and the reference: its type and parameters,
        an eigen-factored (eig, P) variance as a two-entry list."""
        attrs = super().save_attrs()
        ref = {"ref_type": self.ref_type}
        for k, v in self.reference_distr_utils.items():
            ref[k] = list(v) if isinstance(v, tuple) else v
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
        else:  # 'nn' raises, naming its queue item
            self.change_reference_type(ref_type)


def _maybe_tuple(v):
    """A stored (eig, P) variance comes back as a list."""
    return tuple(v) if isinstance(v, (list, tuple)) else v
