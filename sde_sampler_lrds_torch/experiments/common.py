"""Shared machinery of the experiment drivers (counterpart of the JAX
package's experiments/common.py: the dataset preamble,
``sigma_from_moments``, ``run_vi``, ``run_sampling_baseline``,
``lrds_run``, ``competing_run``, the learned references'
``train_ebm_reference`` and ``ebm_run``, and the result pickle).

One LRDS cell: build the target → MALA dataset → fit the reference
(Gaussian or GMM) → ``make_model`` → ``TrainableWrapper.run`` → evaluation
over several seeds → pickle {config, results}. An EBM cell fits a GMM,
tilts it with a neural energy trained by contrastive maximum likelihood,
and installs that potential as the 'nn' reference. A competing cell trains one
of the other VI samplers (PIS, DDS, DIS, CMCD) with its scale moment-matched
to the MALA dataset (CMCD: its prior fitted to it), or runs the SMC or
replica-exchange baseline on the tempering path from the dataset's Gaussian,
its pooled samples scored in ``eval_batch_size`` chunks. Every random draw comes
from generators derived from ``--seed``; every constructor gets
``--device``.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import pprint
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..api import (build_ebm, fit_gmm, make_model, make_target,  # noqa: F401
                   make_target_details, mcmc_sample, run_re_sampler, run_smc_sampler)
from ..eval import Sinkhorn, compute_sliced_ks, get_metrics, mmd_median
from ..solvers.wrappers import TrainableWrapper, list_of_dict_2_dict_of_list
from ..utils.common import derive_generator, resolve_device


def stage(msg: str):
    """An unbuffered stage-progress line on stderr."""
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def clock(device) -> float:
    """The host clock after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def build_dataset_and_gaussian(generator: torch.Generator, target, x_init, dataset_size: int,
                               step_size: float = 1e-3, device=None):
    """MALA dataset and its fitted Gaussian moments (mean, full covariance,
    per-coordinate variance), with the seconds each took."""
    device = resolve_device(device)
    t0 = clock(device)
    stage(f"building MALA dataset ({dataset_size} samples)")
    dataset = mcmc_sample(generator, target, x_init, step_size=step_size,
                          dataset_length=dataset_size, device=device)
    t_mcmc = clock(device) - t0
    stage(f"dataset done in {t_mcmc:.1f}s")
    t0 = clock(device)
    mean = dataset.mean(dim=0)
    var = torch.cov(dataset.T)
    var_diag = dataset.var(dim=0, correction=0)
    t_ref = clock(device) - t0
    return dataset, mean, var, var_diag, {"mcmc": t_mcmc, "ref": t_ref}


VI_SOLVERS = ("pis_orig", "dds_orig", "dis_orig", "cmcd", "vp-ref", "pbm-ref")
BASELINES = ("smc", "re")


def sigma_from_moments(mean, var_diag, dim: int, terminal_t: float | None = None) -> float:
    """σ_opt = sqrt((‖mean‖² + tr var)/d), divided by sqrt(T) for PIS."""
    sigma = math.sqrt(float(torch.sum(mean**2) + var_diag.sum()) / dim)
    if terminal_t is not None:
        sigma /= math.sqrt(terminal_t)
    return sigma


def run_vi(generator: torch.Generator, solver_type, target_details, solver_details,
           training_details, n_sampling_seeds: int = 16, ref_type: str = "default",
           loss_type: str = "lv", integrator_type: str = "em",
           model_type: str = "target_informed_zero_init", time_type: str = "uniform",
           n_steps: int = 100, keep_samples: bool = False,
           progress_file: str | Path | None = None, device=None, **make_model_kwargs):
    """Train a sampler and evaluate it over ``n_sampling_seeds`` passes.

    ``keep_samples`` stores the first pass's samples (host numpy) under
    ``"samples"``; ``progress_file`` gets each pass's scalar metrics as one
    JSON line as soon as the pass completes."""
    device = resolve_device(device)
    model = make_model(solver_type=solver_type, ref_type=ref_type, loss_type=loss_type,
                       integrator_type=integrator_type, model_type=model_type,
                       time_type=time_type, solver_details=solver_details,
                       target_details=target_details, training_details=training_details,
                       n_steps=n_steps, device=device, **make_model_kwargs)
    wrapper = TrainableWrapper(model)
    stage(f"training {solver_type} sampler "
          f"({training_details.get('train_steps', '?')} steps)")
    t0 = time.time()
    results = wrapper.run(derive_generator(generator, 0))
    stage(f"train+eval done in {time.time() - t0:.1f}s; "
          f"{n_sampling_seeds - 1} extra eval seeds")

    def record(metrics):
        if progress_file is not None:
            Path(progress_file).parent.mkdir(parents=True, exist_ok=True)
            with open(progress_file, "a") as f:
                f.write(json.dumps({k: v for k, v in metrics.items()
                                    if isinstance(v, (int, float))}) + "\n")

    record(results.metrics)
    all_metrics = [results.metrics]
    for s in range(n_sampling_seeds - 1):
        res = wrapper.evaluate(derive_generator(generator, s + 1))
        record(res.metrics)
        all_metrics.append(res.metrics)
    out = list_of_dict_2_dict_of_list(all_metrics)
    if keep_samples and results.samples is not None:
        out["samples"] = results.samples.detach().cpu().numpy()
    sk = getattr(model, "sample_losses", {}).get("sinkhorn")
    if sk is not None:
        out["sinkhorn_config"] = sk.config
    return model, out


def run_sampling_baseline(generator: torch.Generator, kind: str, target, mean, var,
                          eval_batch_size: int, n_sampling_seeds: int = 16, smc_kwargs=None,
                          re_kwargs=None, device=None) -> dict:
    """The SMC ('smc') or replica-exchange ('re') baseline on the tempering
    path from N(mean, var) to the target, run max(eval_batch_size ·
    n_sampling_seeds / samples a run, 1) times; each run's level-0 block
    (every MCMC slot of the whole population) is pooled and cut into
    ``eval_batch_size`` chunks, each scored by ``get_metrics`` and by the
    Sinkhorn, MMD and sliced KS against as many fresh target draws.
    ``eval/sample_time`` is the sampling seconds over ``n_sampling_seeds``."""
    device = resolve_device(device)
    sinkhorn = Sinkhorn()
    smc_kwargs = {**{"n_steps": 128, "step_size": 1e-4, "n_particles": 1024,
                     "n_mcmc_steps": 32, "n_warmup_mcmc_steps": 1024}, **(smc_kwargs or {})}
    re_kwargs = {**{"n_steps": 128, "step_size": 1e-4, "batch_size": 1024,
                    "swap_frequency": 8, "n_mcmc_steps": 32, "n_warmup_mcmc_steps": 4096},
                 **(re_kwargs or {})}
    if kind == "smc":
        per_run = smc_kwargs["n_particles"] * smc_kwargs["n_mcmc_steps"]
    else:
        per_run = re_kwargs["batch_size"] * re_kwargs["n_mcmc_steps"]
    n_runs = max(int((eval_batch_size * n_sampling_seeds) / per_run), 1)
    all_metrics, sampling_time = [], 0.0
    pooled = torch.empty((0, target.dim), device=device)
    for r in range(n_runs):
        g_run, g_gt = derive_generator(generator, 2 * r), derive_generator(generator, 2 * r + 1)
        t0 = clock(device)
        if kind == "smc":
            samples = run_smc_sampler(g_run, mean, var, target_log_prob=target.unnorm_log_prob,
                                      target_score=target.score, device=device, **smc_kwargs)
        else:
            samples = run_re_sampler(g_run, mean, var, target_log_prob=target.unnorm_log_prob,
                                     target_score=target.score, device=device, **re_kwargs)
        sampling_time += clock(device) - t0
        pooled = torch.cat([pooled, samples.reshape(-1, target.dim)])
        n_chunk = 0
        while pooled.shape[0] >= eval_batch_size:
            chunk, pooled = pooled[:eval_batch_size], pooled[eval_batch_size:]
            # a fresh ground-truth draw a chunk, so the chunks' metric noise
            # is independent
            gt = target.sample(derive_generator(g_gt, n_chunk), (chunk.shape[0],))
            n_chunk += 1
            metrics = get_metrics(target, chunk, marginal_dims=[0, 1])
            metrics["error/sinkhorn"] = float(sinkhorn(gt, chunk))
            metrics["error/mmd"] = float(mmd_median(gt, chunk))
            metrics["error/ks"] = float(compute_sliced_ks(gt, chunk))
            all_metrics.append(metrics)
    out = list_of_dict_2_dict_of_list(all_metrics) if all_metrics else {}
    out["eval/sample_time"] = sampling_time / max(n_sampling_seeds, 1)
    out["sinkhorn_config"] = sinkhorn.config
    return out


def dump_results(path: str | Path, filename: str, config: dict, results: list):
    """Pickle {config, results}, numpy and builtins only, atomically (a
    temporary file replaced in one step, so a run killed mid-write leaves the
    last good pickle in place)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (filename + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump({"config": clean_config(config), "results": _to_host(results)}, f)
    os.replace(tmp, path / filename)


def clean_config(config: dict) -> dict:
    return {k: v for k, v in config.items() if not callable(v)}


def _to_host(obj):
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def announce(config: dict):
    pprint.pprint({k: v for k, v in config.items() if not callable(v)})


def add_common_args(parser, dataset_size=40000, train_steps=4096,
                    train_batch=1024, eval_batch=8192):
    """The JAX drivers' flags and defaults; ``--device`` is 'cuda' (the
    default) or 'cpu'."""
    parser.add_argument("--results_path", type=str, default="results")
    for flag, kind, default in (
            ("smc_n_steps", int, 128), ("smc_n_particles", int, 1024),
            ("smc_n_mcmc_steps", int, 32), ("smc_n_warmup_mcmc_steps", int, 1024),
            ("re_n_steps", int, 128), ("re_batch_size", int, 1024),
            ("re_n_mcmc_steps", int, 32), ("re_n_warmup_mcmc_steps", int, 4096),
            ("re_swap_frequency", int, 8)):
        parser.add_argument(f"--{flag}", type=kind, default=default)
    parser.add_argument("--terminal_t_pis", type=float, default=5.0)
    parser.add_argument("--train_steps", type=int, default=train_steps)
    parser.add_argument("--train_batch_size", type=int, default=train_batch)
    parser.add_argument("--eval_batch_size", type=int, default=eval_batch)
    parser.add_argument("--dataset_size", type=int, default=dataset_size)
    parser.add_argument("--n_sampling_seeds", type=int, default=16)
    parser.add_argument("--n_steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser


def _progress_file(args):
    """Per-run incremental eval-metrics sidecar under results_path."""
    p = Path(args.results_path) / f"partial_seed{args.seed}.jsonl"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.unlink(missing_ok=True)
    return p


def lrds_run(args, target, target_details, x_init, ref_type, extra_params=None,
             solver_type="vp-ref", integrator_type="ei", time_type="snr",
             model_type="base_zero_init", n_gmm_components=None, em_type="diag",
             mcmc_step_size=1e-3, optim_details=None, prebuilt=None, net=None,
             **model_kwargs):
    """One cell of a *_mcmc_gmm.py driver: fit the requested reference
    ('gaussian' or 'gmm') from the MALA dataset, or install the trained
    potential ``net`` as the 'nn' reference, and train RDS on it.
    ``prebuilt`` takes a ``build_dataset_and_gaussian`` result, so sweeps
    over reference settings reuse one dataset (the VI generator is the same
    either way)."""
    if ref_type not in ("gaussian", "gmm", "nn"):
        raise ValueError(f"Unknown ref_type {ref_type!r}")
    device = resolve_device(args.device)
    base = torch.Generator(device).manual_seed(args.seed)
    g_data, g_vi = derive_generator(base, 1), derive_generator(base, 2)
    if prebuilt is None:
        prebuilt = build_dataset_and_gaussian(g_data, target, x_init, args.dataset_size,
                                              step_size=mcmc_step_size, device=device)
    dataset, mean, var, var_diag, times = prebuilt
    solver_details = {"sigma": 1.0}
    t0 = clock(device)
    if ref_type == "gaussian":
        solver_details.update(mean_ref=mean, var_ref=var if em_type == "full" else var_diag)
    elif ref_type == "nn":
        solver_details.update(net=net)
    else:
        w, m, v = fit_gmm(n_gmm_components or 2, dataset, em_type=em_type, device=device)
        solver_details.update(weights_ref=w, means_ref=m, variances_ref=v)
    times["ref_fit"] = clock(device) - t0
    extra_diag = {}
    if hasattr(target, "compute_phi_four_weight_rb"):
        extra_diag["dataset_weight_raw"] = float(target.compute_phi_four_weight(dataset))
        extra_diag["dataset_weight_rb"] = float(target.compute_phi_four_weight_rb(dataset))
    _, all_metrics = run_vi(
        g_vi, solver_type, target_details, solver_details,
        {"train_steps": args.train_steps,
         "train_batch_size": args.train_batch_size,
         "eval_batch_size": args.eval_batch_size},
        n_sampling_seeds=args.n_sampling_seeds, ref_type=ref_type,
        integrator_type=integrator_type, time_type=time_type,
        model_type=model_type, n_steps=args.n_steps, keep_samples=True,
        progress_file=_progress_file(args), device=device,
        **({"optim_details": optim_details} if optim_details else {}),
        **model_kwargs)
    return {"metrics": all_metrics, "times": times, "params": extra_params or {},
            **extra_diag,
            "gauss_params": {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}}


def competing_run(args, target, target_details, x_init, filename_stub, extra_params=None,
                  model_type="target_informed_zero_init", mcmc_step_size=1e-3,
                  dis_vp20=False):
    """One (target configuration, solver) cell of a *_competing.py driver:
    the MALA dataset's moments set the sampler's scale (σ, over √T for
    PIS, whose horizon follows ``--terminal_t_pis``) or CMCD's Gaussian
    prior; the sampler trains with the LV loss on the uniform grid and is
    evaluated over ``--n_sampling_seeds`` seeds. ``dis_vp20`` runs DIS on
    the vp_20 schedule (the ManyModes driver only). The 'smc' and 're'
    cells run ``run_sampling_baseline`` from the dataset's mean and full
    covariance, at the ``--smc_*`` / ``--re_*`` flags and step size 1e-4."""
    device = resolve_device(args.device)
    base = torch.Generator(device).manual_seed(args.seed)
    g_data, g_vi = derive_generator(base, 1), derive_generator(base, 2)
    dataset, mean, var, var_diag, times = build_dataset_and_gaussian(
        g_data, target, x_init, args.dataset_size, step_size=mcmc_step_size, device=device)
    gauss_params = {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}
    if args.solver_type in BASELINES:
        all_metrics = run_sampling_baseline(
            derive_generator(base, 3), args.solver_type, target, mean, var,
            args.eval_batch_size, n_sampling_seeds=args.n_sampling_seeds,
            smc_kwargs={"n_steps": args.smc_n_steps, "n_particles": args.smc_n_particles,
                        "n_mcmc_steps": args.smc_n_mcmc_steps,
                        "n_warmup_mcmc_steps": args.smc_n_warmup_mcmc_steps,
                        "step_size": 1e-4},
            re_kwargs={"n_steps": args.re_n_steps, "batch_size": args.re_batch_size,
                       "swap_frequency": args.re_swap_frequency,
                       "n_mcmc_steps": args.re_n_mcmc_steps,
                       "n_warmup_mcmc_steps": args.re_n_warmup_mcmc_steps, "step_size": 1e-4},
            device=device)
        return {"metrics": all_metrics, "times": times, "params": extra_params or {},
                "gauss_params": gauss_params}
    if args.solver_type == "cmcd":
        solver_details = {"mean": mean, "var": var}
    else:
        pis = args.solver_type == "pis_orig"
        solver_details = {"sigma": sigma_from_moments(
            mean, var_diag, target.dim, terminal_t=args.terminal_t_pis if pis else None)}
        if pis:   # the SDE's horizon follows the σ/√T scaling
            solver_details["terminal_t"] = args.terminal_t_pis
    _, all_metrics = run_vi(
        g_vi, args.solver_type, target_details, solver_details,
        {"train_steps": args.train_steps, "train_batch_size": args.train_batch_size,
         "eval_batch_size": args.eval_batch_size},
        n_sampling_seeds=args.n_sampling_seeds,
        ref_type="gaussian" if args.solver_type == "cmcd" else "default",
        model_type=model_type, n_steps=args.n_steps, device=device,
        force_vp20=dis_vp20 and args.solver_type == "dis_orig")
    return {"metrics": all_metrics, "times": times, "params": extra_params or {},
            "gauss_params": gauss_params}


def normalized_ess(log_w: torch.Tensor) -> torch.Tensor:
    """exp(2·lse(w) − lse(2w)) / n ∈ (0, 1] of unnormalized log-weights."""
    return torch.exp(2.0 * torch.logsumexp(log_w, 0)
                     - torch.logsumexp(2.0 * log_w, 0)) / log_w.shape[0]


def train_ebm_reference(generator: torch.Generator, dataset, mean, var_diag,
                        n_gmm_components=2, em_type="diag", ebm_type="mle_re", n_levels=32,
                        ebm_epochs=2, ebm_batch_size=64, step_size=1e-2, n_mcmc_steps=8,
                        sde=None, batches_per_call=16, net_layers=4, net_channels=64,
                        t_limit=0.0, lr=3e-4, decay=0.0, perc_keep_mcmc=-1.0,
                        swap_frequency=16, initial_n_warmup_mcmc_steps=64,
                        n_accumulation_steps=1, means_init=None, reg_val=0.0,
                        reweight_loss=False, use_ema=False, use_precond=False,
                        return_trainer=False, target=None, select_best=False,
                        select_size=4096, select_every=None, net_arch="mlp",
                        pretrained_params_path=None, device=None):
    """Fit a GMM on the dataset (full covariances eigendecomposed once),
    tilt it with a zero-init FourierMLP energy ('dot' tilt), and train the
    potential by contrastive MLE ('mle_re': replica exchange with persistent
    replicas, 'mle_smc', 'mle_cd'). ``use_precond`` preconditions the
    negatives' MALA by the per-level noised data covariance
    s²(t)(Σ_data + σ²(t)I); ``select_best`` (needs ``target``) keeps the
    checkpoint of the best forward ESS of the potential at t = 1e-4 against
    the target on the first ``select_size`` dataset points. ``net_arch``
    'mnist_conv' takes the conv energy ``MNISTEnergy`` with the 'sum' tilt
    instead (a square image dim). ``pretrained_params_path`` skips the
    training: the energy net's parameters are read from that file, a JAX
    ``.msgpack`` (the JAX potential's Flax tree) or the port's own
    ``torch.save`` of the energy net's state dict (``save_energy_params``),
    over the GMM fitted here. Returns (the trained potential, {"ebm_train":
    seconds, ...})."""
    from ..models import FourierMLP, MNISTEnergy
    from ..models.potentials import GMMTiltedPotential
    from ..sde import VP
    from ..targets.gauss import Gauss

    device = resolve_device(device)
    dataset = torch.as_tensor(dataset, dtype=torch.float32, device=device)
    dim = dataset.shape[-1]
    sde = sde or VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    w, m, v = fit_gmm(n_gmm_components, dataset, em_type=em_type, means_init=means_init,
                      device=device)
    if v.ndim == 3:
        # factored once: the noised marginals then need no per-row solve
        eig, p = np.linalg.eigh(v.cpu().numpy())
        v = (torch.as_tensor(np.maximum(eig, 1e-8), device=device),
             torch.as_tensor(p, device=device))
    if net_arch == "mnist_conv":
        side = int(round(dim**0.5))
        if side * side != dim:
            raise ValueError("mnist_conv needs a square image dim")
        base_net, tilt = MNISTEnergy(side=side), "sum"
    else:
        base_net = FourierMLP(dim=dim, num_layers=net_layers, channels=net_channels,
                              zero_init=True)
        tilt = "dot"
    base_net = base_net.to(device)
    base_net.reset_parameters(derive_generator(generator, 0))
    pot = GMMTiltedPotential(base_model=base_net, sde=sde, weights=w, means=m, variances=v,
                             t_limit=t_limit, tilt_type=tilt)
    if pretrained_params_path is not None:
        load_energy_params(pot, pretrained_params_path)
        stage(f"loaded pretrained EBM params from {pretrained_params_path}")
        return pot, {"ebm_train": 0.0}
    prior = Gauss(dim=dim, loc=mean, scale=torch.sqrt(var_diag), device=device)
    sampler = {"mle_re": "replica_exchange", "mle_smc": "smc",
               "mle_cd": "cd"}.get(ebm_type, "replica_exchange")
    trainer = build_ebm("mle", sde, prior, pot, sampler_type=sampler,
                        step_sizes_per_noise=step_size, n_steps=n_levels,
                        perc_keep_mcmc=perc_keep_mcmc, swap_frequency=swap_frequency)
    if use_precond:
        cov = np.cov(dataset.cpu().numpy().T) + 1e-6 * np.eye(dim)
        eig_c, p_c = np.linalg.eigh(cov)
        t_levels = trainer.times
        s2 = sde.s(t_levels).cpu().numpy().astype(np.float64) ** 2
        sig = sde.sigma_sq(t_levels).cpu().numpy().astype(np.float64)
        lam = s2[:, None] * (np.maximum(eig_c, 1e-8)[None] + sig[:, None])
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        trainer.precond_matrix_per_noise = as_t(np.einsum("de,le,fe->ldf", p_c, lam, p_c))
        trainer.precond_matrix_chol_per_noise = as_t(np.einsum("de,le->lde", p_c, np.sqrt(lam)))
        trainer.use_precond = True
    select_fn = None
    if select_best:
        assert target is not None, "select_best needs the target"
        n_sel = min(select_size, dataset.shape[0])
        xs_sel = dataset[:n_sel]
        ts_sel = torch.full((n_sel,), 1e-4, device=device)
        target_lp = target.unnorm_log_prob(xs_sel)

        @torch.no_grad()
        def select_fn(net):
            return normalized_ess(net.unnorm_log_prob(ts_sel, xs_sel) - target_lp)

    t0 = clock(device)
    stage(f"training EBM reference ({ebm_epochs} epochs, {n_levels} levels, "
          f"batch {ebm_batch_size} x acc {n_accumulation_steps}"
          + (", fwd-ESS selection" if select_best else "") + ")")
    losses, gnorms, _ = trainer.train(
        derive_generator(generator, 1), dataset, batch_size=ebm_batch_size,
        n_epochs=ebm_epochs, lr=lr, decay=decay,
        initial_n_warmup_mcmc_steps=initial_n_warmup_mcmc_steps, n_mcmc_steps=n_mcmc_steps,
        reg_val=reg_val, reweight_loss=reweight_loss, use_ema=use_ema,
        n_accumulation_steps=n_accumulation_steps, batches_per_call=batches_per_call,
        select_fn=select_fn, select_every=select_every)
    t_train = clock(device) - t0
    stage(f"EBM reference done in {t_train:.1f}s")
    net = trainer.ema_net
    extra = {"ebm_train": t_train}
    if select_best and trainer.best_params is not None:
        stage(f"selected checkpoint: step {trainer.best_step} "
              f"(fwd ESS {trainer.best_score:.4f})")
        net.load_state_dict(trainer.best_params)
        extra["ebm_select_step"] = trainer.best_step
        extra["ebm_select_fwd_ess"] = trainer.best_score
    if select_best:
        extra["ebm_select_history"] = list(trainer.select_history)
    if return_trainer:
        extra.update(trainer=trainer, losses=losses, grad_norms=gnorms)
    return net, extra


def save_energy_params(pot, path: str | Path) -> None:
    """The energy net's state dict of a tilted potential, by ``torch.save``."""
    torch.save(pot.base_model.state_dict(), path)


def load_energy_params(pot, path: str | Path) -> None:
    """The energy net's parameters into a tilted potential: from a JAX
    ``.msgpack`` (the JAX potential's Flax tree, ``{'params': {'base_model':
    ...}}``) through the port's reader, else from ``save_energy_params``'
    file."""
    if Path(path).suffix == ".msgpack":
        from ..utils import flax_msgpack

        pot.load_flax_params(flax_msgpack.load(path))
    else:
        device = next(pot.base_model.parameters()).device
        pot.base_model.load_state_dict(torch.load(path, map_location=device,
                                                  weights_only=True))


def ebm_run(args, target, target_details, x_init, extra_params=None, solver_type="vp-ref",
            integrator_type="ei", time_type="snr", n_gmm_components=2, em_type="diag",
            mcmc_step_size=1e-3, ebm_kwargs=None, **model_kwargs):
    """One cell of a *_ebm_mcmc.py driver: MALA dataset → GMM fit (its
    means seeded at the target's energy minima ``x_min`` where the target
    has a Laplace oracle, copies jittered by 5 % of the data's spread with
    ``np.random.default_rng(seed)``) → the EBM reference → its forward ESS
    on 8192 dataset points (and φ⁴'s dataset weights) → RDS with the 'nn'
    reference → evaluation over the seeds."""
    from ..targets.base import Target as _TargetBase

    device = resolve_device(args.device)
    base = torch.Generator(device).manual_seed(args.seed)
    g_data, g_vi, g_ebm = (derive_generator(base, i) for i in (1, 2, 3))
    dataset, mean, var, var_diag, times = build_dataset_and_gaussian(
        g_data, target, x_init, args.dataset_size, step_size=mcmc_step_size, device=device)
    ebm_kwargs = dict(ebm_kwargs or {})
    # seed the GMM's EM at the energy minima where the target knows them:
    # only targets that override compute_stats_integration are probed
    if getattr(target, "x_min", None) is None and \
            type(target).compute_stats_integration is not _TargetBase.compute_stats_integration:
        try:
            target.compute_stats_integration()
        except (ValueError, NotImplementedError):
            pass
    x_min = getattr(target, "x_min", None)
    if x_min is not None and n_gmm_components % x_min.shape[0] == 0:
        reps = n_gmm_components // x_min.shape[0]
        mi = np.repeat(x_min.cpu().numpy(), reps, axis=0)
        if reps > 1:
            # EM keeps identical means together: jitter the copies
            rng = np.random.default_rng(args.seed)
            scale = 0.05 * dataset.std(dim=0).cpu().numpy()
            mi = mi + rng.normal(size=mi.shape) * scale[None]
        ebm_kwargs.setdefault("means_init", mi)
    ebm_kwargs.setdefault("target", target)
    net, ebm_times = train_ebm_reference(
        g_ebm, dataset, mean, var_diag, n_gmm_components=n_gmm_components, em_type=em_type,
        device=device, **ebm_kwargs)
    ebm_times.pop("trainer", None)
    times.update({k: v for k, v in ebm_times.items() if isinstance(v, (int, float))})
    n_diag = min(8192, dataset.shape[0])
    xs_d = dataset[:n_diag]
    with torch.no_grad():
        lw = net.unnorm_log_prob(torch.full((n_diag,), 1e-4, device=device), xs_d) \
            - target.unnorm_log_prob(xs_d)
    fwd_ess = float(normalized_ess(lw))
    stage(f"EBM reference forward ESS on data: {fwd_ess:.4f}")
    extra_diag = {}
    if hasattr(target, "compute_phi_four_weight"):
        extra_diag["dataset_weight_raw"] = float(target.compute_phi_four_weight(dataset))
    if hasattr(target, "compute_phi_four_weight_rb"):
        extra_diag["dataset_weight_rb"] = float(target.compute_phi_four_weight_rb(dataset))
        stage(f"dataset weight: raw {extra_diag['dataset_weight_raw']:.3f} "
              f"rb {extra_diag['dataset_weight_rb']:.3f}")
    _, all_metrics = run_vi(
        g_vi, solver_type, target_details, {"sigma": 1.0, "net": net},
        {"train_steps": args.train_steps, "train_batch_size": args.train_batch_size,
         "eval_batch_size": args.eval_batch_size},
        n_sampling_seeds=args.n_sampling_seeds, ref_type="nn",
        integrator_type=integrator_type, time_type=time_type, model_type="base_zero_init",
        n_steps=args.n_steps, keep_samples=True, progress_file=_progress_file(args),
        device=device, **model_kwargs)
    return {"metrics": all_metrics, "times": times, "params": extra_params or {},
            "forward_ess_ebm": fwd_ess, **extra_diag,
            "gauss_params": {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}}
