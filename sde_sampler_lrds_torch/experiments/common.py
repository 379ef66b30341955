"""Shared machinery of the experiment drivers (counterpart of the JAX
package's experiments/common.py: the dataset preamble,
``sigma_from_moments``, ``run_vi``, ``lrds_run``, ``competing_run`` and the
result pickle; the competing drivers' SMC / replica-exchange cells and the
EBM references are not ported yet).

One LRDS cell: build the target → MALA dataset → fit the reference
(Gaussian or GMM) → ``make_model`` → ``TrainableWrapper.run`` → evaluation
over several seeds → pickle {config, results}. A competing cell trains one
of the other VI samplers (PIS, DDS, DIS, CMCD) with its scale moment-matched
to the MALA dataset (CMCD: its prior fitted to it). Every random draw comes
from generators derived from ``--seed``; every constructor gets
``--device``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import pprint
import sys
import time
from pathlib import Path

import torch

from ..api import fit_gmm, make_model, make_target, make_target_details, mcmc_sample  # noqa: F401
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


class _NotPorted(argparse.Action):
    """A JAX driver flag of a baseline the port's drivers do not run yet
    (SMC, replica exchange): its default is kept in the config, any other
    value raises."""

    def __call__(self, parser, namespace, values, option_string=None):
        if values != self.default:
            raise NotImplementedError(f"{option_string} is not ported yet (its baseline "
                                      f"is not); only its default {self.default} is taken.")
        setattr(namespace, self.dest, values)


def add_common_args(parser, dataset_size=40000, train_steps=4096,
                    train_batch=1024, eval_batch=8192):
    """The JAX drivers' flags and defaults; ``--device`` is 'cuda' (the
    default) or 'cpu'. The SMC / replica-exchange flags keep their defaults
    in the config; another value raises until the drivers run those
    baselines (ROADMAP A3)."""
    parser.add_argument("--results_path", type=str, default="results")
    for flag, kind, default in (
            ("smc_n_steps", int, 128), ("smc_n_particles", int, 1024),
            ("smc_n_mcmc_steps", int, 32), ("smc_n_warmup_mcmc_steps", int, 1024),
            ("re_n_steps", int, 128), ("re_batch_size", int, 1024),
            ("re_n_mcmc_steps", int, 32), ("re_n_warmup_mcmc_steps", int, 4096),
            ("re_swap_frequency", int, 8)):
        parser.add_argument(f"--{flag}", type=kind, default=default, action=_NotPorted)
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
             mcmc_step_size=1e-3, optim_details=None, prebuilt=None, **model_kwargs):
    """One cell of a *_mcmc_gmm.py driver: fit the requested reference
    ('gaussian' or 'gmm') from the MALA dataset and train RDS on it.
    ``prebuilt`` takes a ``build_dataset_and_gaussian`` result, so sweeps
    over reference settings reuse one dataset (the VI generator is the same
    either way)."""
    if ref_type not in ("gaussian", "gmm"):
        raise NotImplementedError(f"ref_type {ref_type!r} is not ported in lrds_run.")
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
    cells raise: the replica-exchange sampler is not ported, and both come
    with ROADMAP A3."""
    if args.solver_type in BASELINES:
        raise NotImplementedError(
            f"--solver_type {args.solver_type} is not ported in the competing drivers yet "
            f"(ROADMAP A3, the SMC / replica-exchange baselines).")
    device = resolve_device(args.device)
    base = torch.Generator(device).manual_seed(args.seed)
    g_data, g_vi = derive_generator(base, 1), derive_generator(base, 2)
    dataset, mean, var, var_diag, times = build_dataset_and_gaussian(
        g_data, target, x_init, args.dataset_size, step_size=mcmc_step_size, device=device)
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
            "gauss_params": {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}}
