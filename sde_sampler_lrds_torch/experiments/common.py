"""Shared machinery of the LRDS experiment drivers (counterpart of the
JAX package's experiments/common.py: the dataset preamble,
``sigma_from_moments``, ``run_vi``, ``lrds_run`` and the result pickle; the
SMC / replica-exchange baselines and the EBM references are not ported
yet).

One driver cell: build the target → MALA dataset → fit the reference
(Gaussian or GMM) → ``make_model`` → ``TrainableWrapper.run`` → evaluation
over several seeds → pickle {config, results}. Every random draw comes from
generators derived from ``--seed``; every constructor gets ``--device``.
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


def sigma_from_moments(mean, var_diag, dim: int) -> float:
    """σ_opt = sqrt((‖mean‖² + tr var)/d)."""
    return math.sqrt(float(torch.sum(mean**2) + var_diag.sum()) / dim)


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
    """A JAX driver flag of a baseline the port does not have yet (SMC,
    replica exchange, PIS): its default is kept in the config, any other
    value raises."""

    def __call__(self, parser, namespace, values, option_string=None):
        if values != self.default:
            raise NotImplementedError(f"{option_string} is not ported yet (its baseline "
                                      f"is not); only its default {self.default} is taken.")
        setattr(namespace, self.dest, values)


def add_common_args(parser, dataset_size=40000, train_steps=4096,
                    train_batch=1024, eval_batch=8192):
    """The JAX drivers' flags and defaults; ``--device`` is 'cuda' (the
    default) or 'cpu'. The SMC / replica-exchange / PIS flags keep their
    defaults in the config; another value raises until those baselines are
    ported."""
    parser.add_argument("--results_path", type=str, default="results")
    for flag, kind, default in (
            ("smc_n_steps", int, 128), ("smc_n_particles", int, 1024),
            ("smc_n_mcmc_steps", int, 32), ("smc_n_warmup_mcmc_steps", int, 1024),
            ("re_n_steps", int, 128), ("re_batch_size", int, 1024),
            ("re_n_mcmc_steps", int, 32), ("re_n_warmup_mcmc_steps", int, 4096),
            ("re_swap_frequency", int, 8), ("terminal_t_pis", float, 5.0)):
        parser.add_argument(f"--{flag}", type=kind, default=default, action=_NotPorted)
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
