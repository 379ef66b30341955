"""The experiment drivers' train loop with an EUBO-augmented evaluation, and
its variant with evaluations during training (counterpart of
sde_sampler_lrds_tpu/solvers/wrappers.py).

``evaluate_eubo`` runs the loss's reverse (noising) pass on true target
samples: the EUBO upper bound, a forward log-Z estimate and a forward ESS.
"""
from __future__ import annotations

import logging
import math
import time

import torch

from ..utils.common import Results, derive_generator


def list_of_dict_2_dict_of_list(dicts: list[dict]) -> dict:
    return {k: [x[k] for x in dicts if k in x] for k in dicts[0].keys()}


@torch.no_grad()
def evaluate_eubo(trainable, results: Results, generator: torch.Generator,
                  use_ema: bool = True, x_target: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None) -> Results:
    """The EUBO metrics of ``trainable`` from ``eval_batch_size`` target
    draws (or the fed ``x_target``) and the noising pass (with the fed
    ``noise``), added to ``results.metrics``."""
    if x_target is None:
        x_target = trainable.target.sample(derive_generator(generator, 0),
                                           (trainable.cfg.eval_batch_size,))
    g_sim = derive_generator(generator, 1) if noise is None else None
    rnd_target = trainable.compute_eubo(g_sim, x_target, use_ema=use_ema, noise=noise)
    n = rnd_target.shape[0]
    # rnd = log(Q/P̄) along noising paths from target samples, so the
    # forward log-Z estimate uses E_P[exp(+rnd)] = 1/Z:
    # log Z_f = -(logsumexp(+rnd) - log N)
    results.metrics["eval/log_norm_const_is_f"] = float(
        -torch.logsumexp(rnd_target, 0) + math.log(n))
    results.metrics["eval/eubo"] = float((-rnd_target).mean())
    # forward-ESS weights w ∝ exp(+rnd) = Q/P̄ on target samples
    weights = torch.softmax(rnd_target, dim=0)
    ess = float(1.0 / torch.sum(weights**2))
    results.metrics["eval/effective_sample_size_f"] = ess
    results.metrics["eval/norm_effective_sample_size_f"] = ess / n
    return results


class TrainableWrapper:
    """The drivers' train loop and their final evaluation with the EUBO."""

    def __init__(self, trainable):
        self.trainable = trainable

    @property
    def eubo_available(self) -> bool:
        return (getattr(self.trainable.loss, "compute_eubo", None) is not None
                and getattr(self.trainable, "eubo_available", True))

    def compute_results_eubo(self, results: Results, generator: torch.Generator,
                             use_ema: bool = True) -> Results:
        """``results`` with the EUBO metrics where the target can be sampled
        and the loss has a reverse pass. The pass is supplementary: on the
        CPU a failure inside it is recorded as ``eval/eubo_error`` and the
        primary results are kept. On a CUDA device it is raised, so a kernel
        or launch fault never hides behind the key."""
        t = self.trainable
        try:
            t.target.sample(torch.Generator(t.device).manual_seed(0), (1,))
        except NotImplementedError:
            return results
        if not self.eubo_available:
            return results
        if t.device.type == "cuda":
            return evaluate_eubo(t, results, generator, use_ema=use_ema)
        try:
            return evaluate_eubo(t, results, generator, use_ema=use_ema)
        except Exception as e:  # noqa: BLE001 - the JAX package's resource gate
            logging.warning("EUBO evaluation failed (%r); primary results kept, "
                            "eval/*_f metrics skipped", e)
            results.metrics["eval/eubo_error"] = repr(e)[:200]
            return results

    def run(self, generator: torch.Generator | None = None,
            keep_training_metrics: bool = False):
        """Set up the trainable if it is not, take steps up to
        ``cfg.train_steps`` (hyperparameter schedules fast-forwarded to the
        start and advanced after each step), then evaluate once with the
        EUBO. The steps draw from ``generator``; the evaluation from
        generators derived from it. With ``keep_training_metrics`` also
        returns each step call's metrics as lists (read to the host every
        step)."""
        t = self.trainable
        if t.optimizer is None:
            t.setup()
        if generator is None:
            generator = torch.Generator(t.device).manual_seed(t.cfg.seed + 1)
        training_metrics = []
        spc = max(t.cfg.steps_per_call, 1)
        start = time.time()
        start_step = t.step_count
        t._advance_param_schedule(start_step)
        for i in range(start_step + spc - 1, t.cfg.train_steps, spc):
            metrics = t.step(generator)
            t._advance_param_schedule(i + 1)
            if keep_training_metrics:
                training_metrics.append({k: float(v) for k, v in metrics.items()})
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        training_time = time.time() - start
        results = self.evaluate(derive_generator(generator, 1), derive_generator(generator, 2))
        results.metrics["eval/training_time"] = training_time
        if keep_training_metrics:
            return results, list_of_dict_2_dict_of_list(training_metrics)
        return results

    def evaluate(self, generator: torch.Generator, g_eubo: torch.Generator | None = None,
                 use_ema: bool = True) -> Results:
        """One evaluation pass with its sample metrics and the EUBO."""
        t = self.trainable
        results = t.evaluate(generator, use_ema=use_ema)
        results.metrics.update(t.metrics_from_results(results, generator))
        if g_eubo is None:
            g_eubo = derive_generator(generator, 99)
        return self.compute_results_eubo(results, g_eubo, use_ema=use_ema)


class TrainableWrapperWithIntermediates(TrainableWrapper):
    """The train loop with an evaluation (sample metrics and EUBO) every
    ``results_freq`` steps, over ``n_seeds`` generators each."""

    def run(self, generator: torch.Generator | None = None, results_freq: int = 16,
            n_seeds: int = 1, bonus_metrics=None):
        """Returns (final results, each step call's metrics as lists, each
        snapshot's metrics as lists over its seeds, or {} when none was
        taken). ``bonus_metrics`` is a list of (name, samples -> float)."""
        t = self.trainable
        if t.optimizer is None:
            t.setup()
        if generator is None:
            generator = torch.Generator(t.device).manual_seed(t.cfg.seed + 1)
        inter_train, inter_eval = [], []
        spc = max(t.cfg.steps_per_call, 1)
        start = time.time()
        t._advance_param_schedule(t.step_count)
        for i in range(t.step_count + spc - 1, t.cfg.train_steps, spc):
            metrics = t.step(generator)
            t._advance_param_schedule(i + 1)
            inter_train.append({k: float(v) for k, v in metrics.items()})
            if (i + 1) % results_freq == 0:
                all_results = []
                for s in range(n_seeds):
                    results = self.evaluate(derive_generator(generator, 100 + 2 * s),
                                            derive_generator(generator, 101 + 2 * s))
                    for metric_name, metric in bonus_metrics or ():
                        results.metrics["eval/" + metric_name] = float(metric(results.samples))
                    all_results.append(dict(results.metrics))
                inter_eval.append(list_of_dict_2_dict_of_list(all_results))
        training_time = time.time() - start
        results = self.evaluate(derive_generator(generator, 1), derive_generator(generator, 2))
        results.metrics["eval/training_time"] = training_time
        return (results, list_of_dict_2_dict_of_list(inter_train),
                list_of_dict_2_dict_of_list(inter_eval) if inter_eval else {})
