"""Public programmatic API (counterpart of sde_sampler_lrds_tpu/api.py):
the target and model factories ``make_target_details``, ``make_target``,
``make_ctrl`` and ``make_model``, the dataset and reference-fitting pipeline
``mcmc_sample`` (MALA or RWMH) and ``fit_gmm``, and the SMC and
replica-exchange baselines on the tempering path.

``make_model`` takes the JAX package's six axes

    solver    ∈ {dds_orig, pis_orig, dis_orig, cmcd, vp-ref, pbm-ref}
    reference ∈ {default, gaussian, gmm, nn}
    loss      ∈ {kl, lv}
    integrator∈ {em, ei, ddpm_like}
    model     ∈ {target_informed_zero_init, target_informed_unet_zero_init,
                 target_informed_langevin_init, target_informed_lerp_tempering,
                 base_zero_init, unet_zero_init}
    time grid ∈ {uniform, snr}

and refuses every combination the JAX package refuses, with the same
messages. Ported: every solver — the RDS solvers 'vp-ref' and 'pbm-ref'
(VP, the cosine VP of ``force_vp_cosine``, vp_20, PinnedBM) with the
references 'default', 'gaussian', 'gmm' and 'nn' (a trained EBM potential,
``solver_details['net']``, read at ``eps = ts[0]``), and the VI samplers
'dds_orig', 'pis_orig', 'dis_orig' (with GBS's ``inference_ctrl_arch``) and
'cmcd' (with its refitted prior) — the controls of every model type, on
the FourierMLP or the DenseNet, the UNet ones on the 14×14 MNIST UNet, the
lr schedulers of ``optim_details['lr_scheduler']`` and checkpoints under
``out_dir``; the mesh raises NotImplementedError naming its ROADMAP queue
item. ``build_ebm`` makes the EBM trainers ('mle*', 'drl', 'daebm') of the
learned references. Every target is ported: 'two_modes',
'two_modes_full', 'bracket_two_modes', 'many_modes', 'rings',
'checkerboard', 'phi_four', the Bayesian logistic-regression posteriors
'cancer', 'credit', 'ionosphere' and 'sonar', and the NICE-flow mixtures
'mnist' (ten digits) and 'mnist_zero_one' (digits 0 and 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .eval.ks import compute_sliced_ks
from .eval.mmd import mmd_median
from .eval.sinkhorn import Sinkhorn
from .losses import (ControlledLangevinSDELoss, DDPMLikeReferenceSDELoss, EIReferenceSDELoss,
                     EMReferenceSDELoss, ExponentialIntegratorSDELoss, TimeReversalLoss)
from .mcmc.kernels import MCMCState, run_chain
from .mcmc.smc import re_sampler, smc_sampler
from .models import (CancelDriftCtrl, ClippedCtrl, DenseNet, FourierMLP, LerpCtrl, ScoreCtrl,
                     TimeEmbed, remove_reference_ctrl)
from .sde import VP, CosineVP, PinnedBM, ScaledBM, get_timesteps
from .solvers import CMCD, DDS, PIS, RDS, Bridge
from .solvers.base import TrainConfig
from .targets import (BracketTwoModes, Checkerboard, Delta, IsotropicGauss,
                      LogisticRegression, ManyModes, PhiFour, Rings, TwoModes, TwoModesFull)
from .targets.gauss import Gauss, GaussFull
from .utils.common import resolve_device
from .utils.gmm_fit import fit_gmm_em

SOLVER_TYPES = ("dds_orig", "pis_orig", "dis_orig", "cmcd", "vp-ref", "pbm-ref")
MODEL_TYPES = ("target_informed_zero_init", "target_informed_unet_zero_init",
               "target_informed_langevin_init", "target_informed_lerp_tempering",
               "base_zero_init", "unet_zero_init")
TARGET_NAMES = ("two_modes", "bracket_two_modes", "two_modes_full", "many_modes",
                "rings", "checkerboard", "phi_four", "mnist", "mnist_zero_one",
                "cancer", "credit", "ionosphere", "sonar")


def make_target_details(target_name: str, **kwargs) -> dict:
    """Default target hyperparameters. Keys beyond the per-target defaults
    pass through verbatim; unknown keys then fail in make_target."""
    if target_name not in TARGET_NAMES:
        raise ValueError(f"Unknown target {target_name!r}; one of {TARGET_NAMES}")
    details = _make_target_defaults(target_name, **kwargs)
    details.update({k: v for k, v in kwargs.items() if k not in details})
    return details


def _make_target_defaults(target_name: str, **kwargs) -> dict:
    if target_name in ("two_modes", "two_modes_full"):
        return {"name": target_name, "dim": kwargs.get("dim", 5),
                "ill_conditioned": kwargs.get(
                    "ill_conditioned", "not" if target_name == "two_modes" else "medium"),
                "a": kwargs.get("a", 1.0)}
    if target_name == "bracket_two_modes":
        return {"name": target_name, "dim": kwargs.get("dim", 5),
                "a": kwargs.get("a", 0.75)}
    if target_name == "many_modes":
        return {"name": "many_modes", "dim": kwargs.get("dim", 5),
                "n_modes": kwargs.get("n_modes", 4),
                "mixture_weight_factor": kwargs.get("mixture_weight_factor", 3.0),
                "var": kwargs.get("var", 0.5)}
    if target_name == "phi_four":
        return {"name": "phi_four", "dim": kwargs.get("dim", 100),
                "b": kwargs.get("b", 0.0)}
    return {"name": target_name}


def make_target(target_details: dict, device=None):
    """A target from its details dict, on ``device``."""
    name = target_details["name"]
    kw = {k: v for k, v in target_details.items() if k != "name"}
    device = resolve_device(device)
    if name == "two_modes":
        return TwoModes(n_reference_samples=16384, device=device, **kw)
    if name == "two_modes_full":
        return TwoModesFull(n_reference_samples=16384, device=device, **kw)
    if name == "bracket_two_modes":
        return BracketTwoModes(n_reference_samples=16384, device=device, **kw)
    if name == "many_modes":
        return ManyModes(n_reference_samples=10000, device=device, **kw)
    if name == "rings":
        return Rings(device=device, **kw)
    if name == "checkerboard":
        return Checkerboard(device=device, **kw)
    if name == "phi_four":
        return PhiFour(a=kw.pop("a", 0.1), b=kw.pop("b", 0.0), dim=kw.pop("dim", 100),
                       device=device, **kw)
    if name in ("cancer", "credit", "ionosphere", "sonar"):
        return LogisticRegression(data_type=name, device=device, **kw)
    if name in ("mnist", "mnist_zero_one"):
        from .targets.nice import MixtureNice

        digits = (0, 1) if name == "mnist_zero_one" else tuple(range(10))
        return MixtureNice(digits=digits, device=device, **kw)
    raise NotImplementedError(f"Target {name} not supported.")


def _time_embed_scale_model(val: float | None = None) -> TimeEmbed:
    """The TimeEmbed scale net of the target-informed controls: a near-zero
    output (score models) or ≈ ``val`` (the Langevin and lerp inits)."""
    return TimeEmbed(dim_out=1, num_layers=4, channels=64, zero_init_last=True,
                     last_bias_val=0.0 if val is None else val)


def make_ctrl(model_type: str, dim: int, target, prior, sde, compute_dtype=None,
              base_arch: str | None = None):
    """The control network of a model type on the FourierMLP ('fouriermlp',
    the default) or the DenseNet (``base_arch='densenet'``), in float32 or,
    with ``compute_dtype=torch.bfloat16``, with bf16 products; the
    '*unet_zero_init' types on the MNIST Unet (16 channels, side √dim, the
    last conv near zero), float32 only:
    'base_zero_init' is ClippedCtrl(net, clip_model=1e4);
    'target_informed_zero_init' ScoreCtrl, 'target_informed_langevin_init'
    CancelDriftCtrl and 'target_informed_lerp_tempering' LerpCtrl, each with
    a TimeEmbed scale net."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype!r}")
    if "unet" in model_type:
        from .models.mnist_unet import Unet

        if compute_dtype is not None:
            raise ValueError("compute_dtype is not supported for the UNet "
                             "model types yet (GroupNorm/attention numerics).")
        if base_arch not in (None, "fouriermlp"):
            raise ValueError(f"base_arch={base_arch!r} conflicts with the "
                             f"UNet model type {model_type!r}.")
        side = int(round(math.sqrt(dim)))
        if side * side != dim:
            raise ValueError(
                f"UNet model types need a square dim (got {dim}); the "
                "reference UNet is the 14x14=196 MNIST net (mnist_unet.py:238).")
        base = Unet(n_channels=16, side=side, init_last_layer_with_zeros=True)
    elif base_arch in (None, "fouriermlp"):
        base = FourierMLP(dim=dim, zero_init=True, compute_dtype=compute_dtype)
    elif base_arch == "densenet":
        base = DenseNet(dim=dim, arch=(64, 64), zero_init=True, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"Unknown base_arch {base_arch!r}")
    if model_type in ("base_zero_init", "unet_zero_init"):
        return ClippedCtrl(base_model=base, clip_model=1e4)
    if model_type in ("target_informed_zero_init", "target_informed_unet_zero_init"):
        return ScoreCtrl(base_model=base, clip_model=1e4, clip_score=1e4,
                         target_score=target.score, score_model=_time_embed_scale_model(),
                         detach_score=False, scale_score=1.0)
    if model_type == "target_informed_langevin_init":
        return CancelDriftCtrl(base_model=base, clip_model=1e4, clip_score=1e4,
                               target_score=target.score,
                               score_model=_time_embed_scale_model(val=1.0),
                               detach_score=False, sde=sde)
    if model_type == "target_informed_lerp_tempering":
        return LerpCtrl(base_model=base, clip_model=1e4, clip_score=1e4,
                        target_score=target.score, prior_score=prior.score,
                        score_model=_time_embed_scale_model(val=1.0),
                        detach_score=False, sde=sde, scale_lerp=1.0)
    raise ValueError(f"Unknown model type {model_type}")


def make_model(solver_type: str, ref_type: str, loss_type: str, integrator_type: str,
               model_type: str, time_type: str, solver_details: dict,
               target_details: dict, training_details: dict, optim_details: dict | None = None,
               n_steps: int = 100, force_base_zero_init: bool = False,
               use_ema: bool = False, force_vp20: bool = False,
               force_vp_cosine: bool = False, compute_samples_based_metrics: bool = True,
               force_T_cosine: float | None = None, out_dir=None, mesh=None,
               compute_dtype=None, base_arch: str | None = None,
               sde_details: dict | None = None, loss_details: dict | None = None,
               inference_ctrl_arch: str | None = None, device=None):
    """A fully configured sampler on ``device``. Extra ``training_details``
    keys set TrainConfig fields (an unknown key raises); ``sde_details``
    are merged into the SDE's constructor, ``loss_details`` into the loss's
    keyword arguments; ``optim_details['lr_scheduler']`` (a dict with a
    'name' and its arguments) becomes ``cfg.lr_schedule``; ``out_dir``
    holds ``metrics.jsonl`` and the checkpoints. ``inference_ctrl_arch``
    (DIS only) adds GBS's learned inference control, a second control of
    that model type; ``loss_details={'div_estimator': 'rademacher'}`` then
    estimates its divergence by Hutchinson instead of exactly.
    ``force_T_cosine`` moves the end of DDS's cosine grid from 6.4."""
    if solver_type not in SOLVER_TYPES:
        raise ValueError(f"Unknown solver_type {solver_type!r}")
    if ref_type not in ("default", "gaussian", "gmm", "nn"):
        raise ValueError(f"Unknown ref_type {ref_type!r}")
    if loss_type not in ("kl", "lv"):
        raise ValueError(f"Unknown loss_type {loss_type!r}")
    if integrator_type not in ("em", "ei", "ddpm_like"):
        raise ValueError(f"Unknown integrator_type {integrator_type!r}")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"Unknown model_type {model_type!r}")
    if time_type not in ("uniform", "snr"):
        raise ValueError(f"Unknown time_type {time_type!r}")
    if not isinstance(solver_details, dict):
        raise TypeError("solver_details must be a dict")
    if not (isinstance(target_details, dict) and "name" in target_details):
        raise TypeError("target_details must be a dict with a 'name'")
    if not isinstance(training_details, dict):
        raise TypeError("training_details must be a dict")

    # -- validation rules, as the JAX package's --------------------------
    if ("orig" in solver_type) or ("dis" in solver_type) or ("cmcd" in solver_type):
        if not (model_type == "base_zero_init" and force_base_zero_init):
            if solver_type in ("dds_orig", "pis_orig") and model_type not in (
                    "target_informed_zero_init", "target_informed_unet_zero_init"):
                raise ValueError("Only target_informed_zero_init model is supported.")
            if "dis" in solver_type and model_type == "base_zero_init":
                raise ValueError("Model base_zero_init is not supported.")
            # the check fires on base_zero_init despite its message, as in
            # the JAX package and its reference
            if solver_type == "cmcd" and model_type == "base_zero_init":
                raise ValueError("Only base_zero_init is supported for CMCD.")
        if solver_type == "cmcd" and model_type in (
                "target_informed_lerp_tempering",
                "target_informed_langevin_init"):
            raise ValueError(f"model_type {model_type!r} is not supported "
                             f"for CMCD (needs a static SDE object).")
        if time_type != "uniform":
            raise ValueError("Only uniform time discretisation is supported for orig/cmcd models.")
        if integrator_type != "em":
            raise ValueError("Can't use EI or DDPM-like discretization with orig models.")
        if force_vp20 and solver_type != "dis_orig":
            raise ValueError("Can't use vp_20 for orig models other than DIS.")
        if force_vp_cosine:
            raise ValueError("Can't use vp_cosine for orig models.")
    if "ref" in solver_type:
        if model_type == "target_informed_lerp_tempering":
            raise ValueError("Model target_informed_lerp_tempering is not supported.")
        if solver_type == "pbm-ref" and time_type == "uniform":
            raise ValueError("PBM schedule is unstable with uniform time discretization.")
        if integrator_type == "ddpm_like" and time_type == "uniform":
            raise ValueError("Using the integration scheme from DDPM with uniform times is unstable.")
    if force_vp20 and force_vp_cosine:
        raise ValueError("Can't use vp_20 and vp_cosine at the same time.")
    if solver_type == "pbm-ref" and (force_vp20 or force_vp_cosine):
        raise ValueError("Can't use vp_20 or vp_cosine with PBM.")
    if (ref_type != "default" and "ref" not in solver_type) and solver_type != "cmcd":
        raise ValueError("Only ref models can use a non-default ref.")
    if solver_type == "cmcd" and ref_type not in ("default", "gaussian"):
        raise ValueError("Can't use ref other than gaussian for CMCD.")
    if model_type == "target_informed_langevin_init" and integrator_type in ("ei", "ddpm_like"):
        raise ValueError("Can't use EI or DDPM-like with Langevin score.")
    if inference_ctrl_arch is not None:
        if solver_type != "dis_orig":
            raise ValueError("inference_ctrl_arch (GBS) is only supported for "
                             "dis_orig — the reference composes cfg.inference_ctrl "
                             "only in Bridge (solver/oc.py:194-208).")
        if inference_ctrl_arch not in MODEL_TYPES:
            raise ValueError(f"inference_ctrl_arch must be one of {MODEL_TYPES}; "
                             f"got {inference_ctrl_arch!r}")

    # -- what the port does not have yet ------------------------------------
    if mesh is not None:
        raise NotImplementedError("mesh (sharded solvers) is not ported yet (ROADMAP A7, "
                                  "parallel/mesh.py).")

    # -- target / prior / sde ---------------------------------------------
    device = resolve_device(device)
    target = make_target(target_details, device=device)
    dim = target.dim
    sigma = solver_details.get("sigma", 1.0)

    optim_details = dict(optim_details or {})
    # training_details wins over optim_details for the lr, and the schedule
    # starts from that lr
    lr = training_details.get("lr", optim_details.get("lr", 3e-4))
    lr_schedule = None
    if "lr_scheduler" in optim_details:
        from .solvers.schedulers import make_lr_schedule

        sched_cfg = dict(optim_details["lr_scheduler"])
        lr_schedule = make_lr_schedule(sched_cfg.pop("name"), lr,
                                       training_details["train_steps"], **sched_cfg)
    cfg_kwargs = dict(
        train_steps=training_details["train_steps"],
        train_batch_size=training_details["train_batch_size"],
        eval_batch_size=training_details["eval_batch_size"],
        lr=lr,
        lr_schedule=lr_schedule,
        use_ema=use_ema,
        eval_interval=training_details.get("eval_interval", 10**9),
        log_interval=training_details.get("log_interval", 50),
        grad_clip=training_details.get("grad_clip"),
        seed=training_details.get("seed", 0),
    )
    # any further training_details key sets a TrainConfig field directly
    cfg_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    _consumed = ("train_steps", "train_batch_size", "eval_batch_size",
                 "eval_interval", "log_interval", "grad_clip", "seed")
    extra_cfg = {k: v for k, v in training_details.items() if k not in _consumed}
    unknown = set(extra_cfg) - cfg_fields
    if unknown:
        raise ValueError(
            f"Unknown training_details keys {sorted(unknown)}; valid "
            f"TrainConfig fields: {sorted(cfg_fields)}")
    cfg_kwargs.update(extra_cfg)
    cfg = TrainConfig(**cfg_kwargs)

    sde_details = dict(sde_details or {})

    def _sde(cls, **kw):
        kw.update(sde_details)
        return cls(**kw)

    loss_kwargs = {"method": loss_type}
    if loss_type == "lv":
        loss_kwargs["max_rnd"] = 1e8
    loss_kwargs.update(loss_details or {})

    def ctrl(prior, sde):
        return make_ctrl(model_type, dim, target, prior, sde, compute_dtype=compute_dtype,
                         base_arch=base_arch)

    def make_vp():
        if force_vp_cosine:
            return _sde(CosineVP, scale_diff_coeff=sigma)
        return _sde(VP, diff_coeff_sq_min=0.1, diff_coeff_sq_max=20.0 if force_vp20 else 10.0,
                    scale_diff_coeff=sigma)

    t_eps = 1e-4
    common = dict(cfg=cfg, device=device, out_dir=out_dir)
    if solver_type == "dds_orig":
        prior = IsotropicGauss(dim=dim, scale=sigma, device=device)
        end = force_T_cosine if force_T_cosine is not None else 6.4
        ts = get_timesteps(0.0, end, dt=0.05, rescale_t="cosine", device=device)
        loss_kwargs.setdefault("alpha", solver_details.get("alpha", 1.0))
        loss_kwargs.setdefault("sigma", sigma)
        solver = DDS(target, prior, None, ctrl(prior, None), ExponentialIntegratorSDELoss,
                     loss_kwargs, train_ts=ts, **common)
    elif solver_type == "pis_orig":
        prior = Delta(dim=dim, loc=0.0, device=device)
        sde = _sde(ScaledBM, diff_coeff=sigma, terminal_t=solver_details.get("terminal_t", 5.0))
        ts = get_timesteps(0.0, sde.terminal_t, steps=n_steps, device=device)
        solver = PIS(target, prior, sde, ctrl(prior, sde), EMReferenceSDELoss, loss_kwargs,
                     train_ts=ts, **common)
    elif solver_type == "dis_orig":
        sde = make_vp()
        prior = IsotropicGauss(dim=dim, scale=sde.scale_diff_coeff, device=device)
        ts = get_timesteps(0.0, sde.terminal_t, steps=n_steps, device=device)
        inf_ctrl = None
        if inference_ctrl_arch is not None:
            inf_ctrl = make_ctrl(inference_ctrl_arch, dim, target, prior, sde,
                                 compute_dtype=compute_dtype, base_arch=base_arch)
        solver = Bridge(target, prior, sde, ctrl(prior, sde), TimeReversalLoss, loss_kwargs,
                        train_ts=ts, inference_ctrl=inf_ctrl, **common)
    elif solver_type == "cmcd":
        prior = IsotropicGauss(dim=dim, scale=solver_details.get("prior_scale", 5.0),
                               device=device)
        ts = get_timesteps(0.0, 1.0, steps=n_steps, device=device)
        solver = CMCD(target, prior, None, ctrl(prior, None), ControlledLangevinSDELoss,
                      loss_kwargs, train_ts=ts, **common)
    else:  # vp-ref / pbm-ref -> RDS
        if solver_type == "pbm-ref":
            sde = _sde(PinnedBM, diff_coeff=sigma if ref_type == "default" else math.sqrt(0.2),
                       terminal_t=5.0)
            prior = Delta(dim=dim, loc=0.0, device=device)
            # the uniform grid is refused for pbm-ref above
            ts = get_timesteps(t_eps, sde.terminal_t - t_eps, steps=n_steps, sde=sde,
                               device=device)
        else:
            sde = make_vp()
            prior = IsotropicGauss(dim=dim, scale=sde.scale_diff_coeff, device=device)
            if time_type == "snr":
                ts = get_timesteps(t_eps, sde.terminal_t - t_eps, steps=n_steps, sde=sde,
                                   device=device)
            elif force_vp_cosine:  # α(T) is infinite: start the uniform grid at 1e-3
                ts = get_timesteps(1e-3, sde.terminal_t, steps=n_steps, device=device)
            elif integrator_type == "ddpm_like":
                ts = get_timesteps(0.0, sde.terminal_t - 1e-4, steps=n_steps, device=device)
            else:
                ts = get_timesteps(0.0, sde.terminal_t, steps=n_steps, device=device)
        loss_cls = {"em": EMReferenceSDELoss, "ei": EIReferenceSDELoss,
                    "ddpm_like": DDPMLikeReferenceSDELoss}[integrator_type]
        solver = RDS(target, prior, sde, ctrl(prior, sde), loss_cls, loss_kwargs, train_ts=ts,
                     **common)

    # -- sample-based metrics ----------------------------------------------
    if compute_samples_based_metrics:
        solver.sample_losses = {"sinkhorn": Sinkhorn(), "mmd": mmd_median,
                                "ks": lambda a, b: compute_sliced_ks(a, b)}

    # -- reference install -------------------------------------------------
    if "ref" in solver_type:
        if ref_type == "gaussian":
            solver.change_reference_type(
                "gaussian", mean=solver_details["mean_ref"], var=solver_details["var_ref"])
        elif ref_type == "gmm":
            solver.change_reference_type(
                "gmm", weights=solver_details["weights_ref"],
                means=solver_details["means_ref"], variances=solver_details["variances_ref"])
        elif ref_type == "nn":
            solver.change_reference_type("nn", net=solver_details["net"], eps=float(ts[0]))
    if solver_type == "cmcd" and ref_type == "gaussian":
        solver.update_prior(mean=solver_details["mean"], var=solver_details["var"])

    # -- Langevin init under RDS: the control models only the deviation
    # from the reference process (the reference read at each call, so a
    # later change_reference_type is followed)
    if model_type == "target_informed_langevin_init" and "ref" in solver_type:
        solver.ctrl_wrapper = lambda module: remove_reference_ctrl(
            module, lambda t, x: solver.reference_score_t(t, x), use_rescaling=True,
            sde=solver.sde)
    return solver


def mcmc_sample(generator: torch.Generator, target, x_init, mcmc_type: str = "mala",
                step_size: float = 1e-3, n_chains_per_mode: int = 4,
                dataset_length: int = 50000, n_warmup_steps: int = 512,
                skip_chain_per_mode: bool = False,
                target_log_prob_and_grad: Callable | None = None,
                adapt_step_size: bool = True, shuffle: bool = True,
                device=None) -> torch.Tensor:
    """MALA dataset (RWMH for any ``mcmc_type`` other than 'mala', as in
    the JAX package): chains seeded at the given mode points, adaptive step
    sizes, post-warmup pooling. ``generator`` lives on ``device``."""
    device = resolve_device(device)
    kernel = "mala" if mcmc_type == "mala" else "rwmh"
    if target_log_prob_and_grad is None:
        target_log_prob_and_grad = target.log_prob_and_score
    x_init = torch.as_tensor(x_init, dtype=torch.float32, device=device)
    y_init = x_init if skip_chain_per_mode else torch.repeat_interleave(
        x_init, n_chains_per_mode, dim=0)
    n_mcmc_steps = int(dataset_length / y_init.shape[0])
    ta = 0.75 if adapt_step_size else 0.0
    state = MCMCState.init(y_init, target_log_prob_and_grad, step_size)
    state, _ = run_chain(generator, state, target_log_prob_and_grad, n_warmup_steps,
                         kernel=kernel, target_acceptance=ta, collect=False)
    state, samples = run_chain(generator, state, target_log_prob_and_grad,
                               n_mcmc_steps, kernel=kernel, target_acceptance=ta, collect=True)
    out = samples.reshape(-1, y_init.shape[-1])
    if shuffle:
        out = out[torch.randperm(out.shape[0], generator=generator, device=device)]
    return out


def fit_gmm(n_components: int, dataset, means_init=None, em_type: str = "diag",
            max_iter: int = 1000, device=None):
    """EM with an ascending reg_covar sweep; returns (weights, means,
    variances) on ``device``, the variances (K, D) for ``em_type`` 'diag' or
    full (K, D, D) covariances for 'full'. Each attempt seeds its own
    generator; after the strongest regularization fails, this raises."""
    device = resolve_device(device)
    data = torch.as_tensor(dataset, dtype=torch.float32, device=device)
    data = data.reshape(-1, data.shape[-1])
    last_err = None
    regs = (1e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2)
    for attempt_id, reg_covar in enumerate(regs):
        w, m, v, _ = fit_gmm_em(
            n_components, data, means_init=means_init, em_type=em_type,
            max_iter=max_iter, reg_covar=reg_covar,
            generator=torch.Generator(device).manual_seed(attempt_id))
        if not all(bool(torch.isfinite(a).all()) for a in (w, m, v)):
            last_err = "non-finite GMM parameters"
        elif bool((w < 1e-8).any()):
            last_err = "collapsed GMM component"
        else:
            return w, m, v
    raise ValueError(f"Couldn't fit a GMM on this dataset ({last_err}).")


def build_ebm(ebm_type: str, sde, prior, net, target_acceptance: float = 0.75,
              use_snr_adapted_disc: bool = False, perc_keep_mcmc: float = -1.0,
              start_eps: float = 1e-3, end_eps: float = 0.0, n_steps: int = 100, **kwargs):
    """The EBM trainer of ``ebm_type``: 'drl' (DiffusionRecoveryLikelihood),
    'daebm' (DAEBM) or any name holding 'mle' (MaximumLikelihoodEBM), on
    the device of ``net``'s parameters."""
    from .ebm import DAEBM, DiffusionRecoveryLikelihood, MaximumLikelihoodEBM

    if ebm_type == "drl":
        cls = DiffusionRecoveryLikelihood
    elif ebm_type == "daebm":
        cls = DAEBM
    elif "mle" in ebm_type:
        cls = MaximumLikelihoodEBM
    else:
        raise NotImplementedError(f"EBM type {ebm_type} not found.")
    return cls(sde=sde, prior=prior, net=net, target_acceptance=target_acceptance,
               use_snr_adapted_disc=use_snr_adapted_disc, perc_keep_mcmc=perc_keep_mcmc,
               start_eps=start_eps, end_eps=end_eps, n_steps=n_steps, **kwargs)


def score_with_reference_score(score_ref: Callable, score: Callable) -> Callable:
    """(t, x) ↦ score_ref(t, x) − score(t, x)."""
    def f(t, x):
        return score_ref(t, x) - score(t, x)
    return f


def define_tempering_utils(mean, var, target_log_prob: Callable,
                           target_score: Callable | None = None, device=None):
    """The geometric path t·log p₀ + (1 − t)·log ρ between a Gaussian p₀
    (``GaussFull`` when ``var`` is a (D, D) covariance, else the diagonal
    ``Gauss``) and the target. Returns (p₀, log_prob_and_grads(t, x)); t is
    a scalar or one time per row of x. Without ``target_score`` the target's
    score is taken by autograd."""
    device = resolve_device(device)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    var = torch.as_tensor(var, dtype=torch.float32, device=device)
    dim = mean.shape[0]
    if var.ndim == 2:
        prior = GaussFull(dim=dim, loc=mean, cov=var, device=device)
    else:
        prior = Gauss(dim=dim, loc=mean, scale=torch.sqrt(var), device=device)
    if target_score is None:
        def target_score(x):
            with torch.enable_grad():
                y = x.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(torch.sum(target_log_prob(y)), y)
            return g

    def log_prob_and_grads(t, x):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t_flat = t.reshape(-1) if t.ndim > 0 else t
        t_col = t_flat[:, None] if t.ndim > 0 else t
        lp = t_flat * prior.log_prob(x) + (1.0 - t_flat) * target_log_prob(x).reshape(-1)
        g = t_col * prior.score(x) + (1.0 - t_col) * target_score(x)
        return lp, g

    return prior, log_prob_and_grads


def run_smc_sampler(generator: torch.Generator, mean, var, n_steps: int, step_size: float,
                    n_particles: int, n_mcmc_steps: int, n_warmup_mcmc_steps: int,
                    target_log_prob: Callable, target_score: Callable | None = None,
                    reweight_threshold: float = 1.0, target_acceptance: float = 0.75,
                    return_diagnostics: bool = False, device=None):
    """SMC baseline on the tempering path from the Gaussian (mean, var) to
    the target, with systematic resampling. Returns the whole level-0 (the
    target's) block of shape (n_mcmc_steps, n_particles, dim), and with
    ``return_diagnostics`` also ``smc_sampler``'s per-level ESS and
    acceptance."""
    device = resolve_device(device)
    prior, lpg = define_tempering_utils(mean, var, target_log_prob, target_score,
                                        device=device)
    times = torch.linspace(0.0, 1.0, n_steps, device=device)
    x0 = prior.sample(generator, (n_particles,))
    samples, _, diags = smc_sampler(
        generator, x0, times, lpg, n_warmup_mcmc_steps=n_warmup_mcmc_steps,
        n_mcmc_steps=n_mcmc_steps,
        step_sizes_per_noise=torch.full((n_steps, n_particles, 1), step_size, device=device),
        reweight_threshold=reweight_threshold, target_acceptance=target_acceptance)
    return (samples[0], diags) if return_diagnostics else samples[0]


def run_re_sampler(generator: torch.Generator, mean, var, n_steps: int, step_size: float,
                   batch_size: int, swap_frequency: int, n_mcmc_steps: int,
                   n_warmup_mcmc_steps: int, target_log_prob: Callable,
                   target_score: Callable | None = None, target_acceptance: float = 0.75,
                   return_diagnostics: bool = False, device=None):
    """Replica-exchange baseline on the tempering path from the Gaussian
    (mean, var) to the target. Returns the whole level-0 (the target's)
    block of shape (n_mcmc_steps, batch_size, dim), and with
    ``return_diagnostics`` also ``re_sampler``'s per-step acceptance."""
    device = resolve_device(device)
    prior, lpg = define_tempering_utils(mean, var, target_log_prob, target_score,
                                        device=device)
    times = torch.linspace(0.0, 1.0, n_steps, device=device)
    x0 = prior.sample(generator, (batch_size,))
    samples, _, diags, _ = re_sampler(
        generator, x0, times, lpg, swap_frequency=swap_frequency,
        n_warmup_mcmc_steps=n_warmup_mcmc_steps, n_mcmc_steps=n_mcmc_steps,
        step_sizes_per_noise=torch.full((n_steps,), step_size, device=device),
        target_acceptance=target_acceptance)
    return (samples[0], diags) if return_diagnostics else samples[0]
