"""Profiling and tracing hooks (counterpart of
sde_sampler_lrds_tpu/utils/profiling.py): a ``torch.profiler`` trace of the
host and the card around any block, named regions in it, the cost of one
call of a function, and the wall-clock step timer of the training loop.
"""
from __future__ import annotations

import contextlib
import time
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
    """A named region in the trace (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


def compiled_cost(fn, *args, **kwargs) -> dict:
    """The cost of one call ``fn(*args, **kwargs)``, under the JAX package's
    keys: ``flops`` counted by ``torch.utils.flop_counter.FlopCounterMode``
    (the operators it knows: matrix products, convolutions, attention),
    ``bytes_accessed`` NaN (no counter of it), and ``memory_mb`` the peak
    device memory the call allocated beyond what was allocated before it,
    in MiB (NaN when no argument is on a card). The hand-written kernels
    (``ops/``) count no flops, as a ``pallas_call`` without a cost estimate
    counts none in XLA's analysis."""
    from torch.utils.flop_counter import FlopCounterMode

    tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    device = next((t.device for t in tensors if t.device.type == "cuda"), None)
    if device is not None:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    memory_mb = float("nan")
    if device is not None:
        torch.cuda.synchronize(device)
        memory_mb = (torch.cuda.max_memory_allocated(device) - before) / 2**20
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan"),
            "memory_mb": float(memory_mb)}


class StepTimer:
    """Rolling wall-clock timer matching the training loop's
    ``train/time_per_step`` bookkeeping."""

    def __init__(self):
        self.start = time.time()
        self.count = 0

    def tick(self) -> float:
        self.count += 1
        return (time.time() - self.start) / self.count
