"""Profiling and tracing hooks (counterpart of
sde_sampler_lrds_tpu/utils/profiling.py): a ``torch.profiler`` trace of the
host and the card around any block, named regions in it, and the counter of
the device-to-host reads of an evaluation pass and a training step.

The port's own regions (``annotate``), nested on the host, one pass or step
at a time:

  lrds.eval            TrainableDiff.evaluate, the whole pass
    lrds.eval.plan       the fused trajectory's plan (build_plan)
    lrds.eval.prior      the prior draw
    lrds.eval.simulate   the fused trajectory with its seed read and the
                         boundary log-densities, or the loss's eval
    lrds.eval.results    compute_results
  lrds.step            Trainable._one_step
    lrds.step.loss       loss_fn
      lrds.step.plan       the fused trajectory's plan of the flat LV or
                           fused KL path
      lrds.step.simulate   the flat LV path's gradient-free simulation (the
                           fused trajectory or the CUDA graph's replay), or
                           the fused KL trajectory
      lrds.step.ctrl_eval  flat_ctrl_eval, the cost and the reduction
    lrds.step.backward   loss.backward()
    lrds.step.guard      the finite and magnitude guard and its host read
    lrds.step.update     the clip, the learning rate and the optimizer step
    lrds.step.ema        the EMA update
  lrds.graph.capture   GraphedCall capturing the simulation

A region costs a check of whether a profiler records when none does.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    ones where a card is present), written into ``log_dir`` as a Chrome /
    TensorBoard trace (``<host>_<pid>.<time>.pt.trace.json``) when the block
    ends. Yields the profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace (``record_function``, category
    ``user_annotation``), entered only while a profiler records."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


def host_read(t: torch.Tensor):
    """The Python number of the one-element tensor ``t`` (a bool, int or
    float by its dtype), counted in ``host_read.count``: on the card each
    call waits for the work queued before it."""
    host_read.count += 1
    return t.item()


host_read.count = 0
