"""Evaluation metrics: expectation errors, log-Z errors, ESS, mode coverage
and sample-based distances (counterpart of
sde_sampler_lrds_tpu/eval/metrics.py; same metric names and namespaces
eval/*, error/*, rel_error/*). Reductions are torch; the returned dict
holds host floats. Targets may add the φ⁴ weights, the mean test-set
predictive log-density (``compute_predictive_log_prob``) and an
``objective``."""
from __future__ import annotations

import logging
from numbers import Number
from typing import Callable

import torch

from ..targets.base import EXPECTATION_FNS, Target


def abs_and_rel_error(prediction: float, target: float, suffix: str = "",
                      eps: float = 1e-8) -> dict[str, float]:
    magnitude = abs(target) + eps
    error = abs(prediction - target)
    return {f"error{suffix}": error, f"rel_error{suffix}": error / magnitude}


def compute_errors(prediction, target=None, name: str = "error", weights=None,
                   eps: float = 1e-8) -> dict[str, float]:
    """Mean and IS-weighted mean of a per-sample metric, with absolute and
    relative errors against ``target`` where it is known."""
    output = {}
    if isinstance(prediction, Number) or torch.as_tensor(prediction).ndim == 0:
        output[f"eval/{name}"] = float(prediction)
    else:
        pred = torch.as_tensor(prediction).reshape(-1)
        output[f"eval/{name}"] = float(pred.mean())
        if weights is not None:
            w = torch.as_tensor(weights).reshape(-1)
            output[f"eval/{name}_is"] = float((pred * w).sum() / w.sum())
    if target is not None:
        target = float(target)
        for key_name, pred in list(output.items()):
            output.update(abs_and_rel_error(pred, target,
                                            suffix=key_name.replace("eval", ""), eps=eps))
    return output


def frac_inside_domain(samples: torch.Tensor, domain: torch.Tensor) -> float:
    inside = (domain[:, 0] <= samples) & (samples <= domain[:, 1])
    return float(inside.all(dim=-1).float().mean())


def get_metrics(distr: Target, samples: torch.Tensor, weights: torch.Tensor | None = None,
                log_norm_const_preds: dict | None = None,
                expectation_preds: dict | None = None,
                marginal_dims: list[int] | None = None,
                sample_losses: dict[str, Callable] | None = None,
                sample_generator: torch.Generator | None = None) -> dict[str, float]:
    """Every metric of a set of generated samples. The sample losses compare
    the samples with as many fresh target draws from ``sample_generator``."""
    marginal_dims = [d for d in (marginal_dims or []) if d < distr.dim]
    expectation_preds = expectation_preds or {}
    log_norm_const_preds = log_norm_const_preds or {}
    metrics: dict[str, float] = {}

    fns: dict[str, Callable] = {
        name: (lambda s, fn=fn: fn(s).reshape(-1, 1)) for name, fn in EXPECTATION_FNS.items()}
    if hasattr(distr, "compute_mode_weight"):
        fns["mode_weight"] = lambda s: float(distr.compute_mode_weight(s))
    if hasattr(distr, "compute_phi_four_weight"):
        fns["weight"] = lambda s: float(distr.compute_phi_four_weight(s))
    if hasattr(distr, "compute_phi_four_weight_rb"):
        fns["weight_rb"] = lambda s: float(distr.compute_phi_four_weight_rb(s))
    if distr.has_entropy():
        fns["emc"] = lambda s: float(distr.entropy(s))
        fns["kl_weights"] = lambda s: float(distr.kl_weights(s))
        fns["tv_weights"] = lambda s: float(distr.tv_weights(s))
        fns["num_forgotten_modes"] = lambda s: float(distr.compute_forgotten_modes(s))
    if hasattr(distr, "compute_predictive_log_prob"):
        fns["avg_predictive_log_prob"] = lambda s: float(distr.compute_predictive_log_prob(s))

    w_col = None if weights is None else weights.reshape(-1, 1)
    for name, fn in fns.items():
        target_val = distr.expectations.get(name)
        metrics.update(compute_errors(fn(samples), target=target_val, name=name,
                                      weights=w_col))
        if name in expectation_preds:
            metrics.update(compute_errors(expectation_preds[name], target=target_val,
                                          name=name + "_direct", weights=w_col))

    for name, pred in log_norm_const_preds.items():
        metrics.update(compute_errors(pred, target=distr.log_norm_const, name=name))

    if weights is not None:
        w = weights.reshape(-1)
        ess = float(w.sum() ** 2 / (w**2).sum())
        metrics["eval/effective_sample_size"] = ess
        metrics["eval/norm_effective_sample_size"] = ess / w.shape[0]

    stddevs = samples.std(dim=0, correction=0)
    means = samples.mean(dim=0)
    metrics["eval/avg_stddev"] = float(stddevs.mean())
    for dim in marginal_dims:
        metrics[f"eval/stddev_{dim}"] = float(stddevs[dim])
        metrics[f"eval/avg_{dim}"] = float(means[dim])
    if distr.stddevs is not None:
        metrics["error/avg_marginal_stddev"] = float(torch.abs(stddevs - distr.stddevs).mean())
        metrics.update(compute_errors(float(stddevs.mean()),
                                      target=float(distr.stddevs.mean()), name="avg_stddev"))

    if distr.domain is not None:
        metrics["eval/frac_pred_in_domain"] = frac_inside_domain(samples, distr.domain)

    if sample_losses:
        try:
            if sample_generator is None:
                sample_generator = torch.Generator(samples.device).manual_seed(1234)
            gt = distr.sample(sample_generator, (samples.shape[0],))
            if distr.domain is not None:
                metrics["eval/frac_groundtruth_in_domain"] = frac_inside_domain(
                    gt, distr.domain)
            for name, loss in sample_losses.items():
                metrics["error/" + name] = float(loss(samples, gt))
        except NotImplementedError:
            logging.warning("Sampling not implemented for %s.", type(distr).__name__)

    if hasattr(distr, "objective"):
        metrics["eval/obj_avg"] = float(distr.objective(samples.mean(dim=0, keepdim=True)))
        metrics["eval/avg_obj"] = float(distr.objective(samples).mean())
        metrics["eval/min_obj"] = float(distr.objective(samples).min())
    return metrics
