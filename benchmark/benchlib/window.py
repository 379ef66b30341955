"""The one traffic generator: a traffic mix is a data file under
``traffic/`` whose ``loop`` says how operations are issued and whose other
keys (the operation and its sizes) the configuration's system reads.

``closed``: one client issues the next operation as soon as the previous
one returned (its results on the host), until ``seconds`` have passed;
every operation started before the deadline completes and counts. Each
record is (start, end, work, ok) in host seconds. With a profiler the
last ``trace_s`` seconds of the window are traced (the window's head stays
unprofiled, for the metrics a profiler would slow); the profiler's own
start is not part of either, so the deadline moves by the time it took."""
from __future__ import annotations

import time

from .trace import WINDOW

LOOPS = ("closed",)


class Window:
    def __init__(self):
        self.records: list[tuple] = []
        self.t0 = self.t_end = 0.0
        self.head_records: list[tuple] = []
        self.head_s = 0.0

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


def run(mix: dict, op, seconds: float, sync, profiler=None, trace_s: float = 0.0) -> Window:
    """Drive ``op(i) -> (work, ok)`` under ``mix`` for ``seconds``; ``sync``
    waits for the device's queued work. ``profiler``: a started-on-demand
    ``torch.profiler.profile`` for the window's last ``trace_s`` seconds."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop {mix.get('loop')!r}: one of {LOOPS}")
    import torch

    w = Window()
    span = None
    w.t0 = time.perf_counter()
    deadline = w.t0 + seconds
    i = 0
    while True:
        start = time.perf_counter()
        if start >= deadline:
            break
        if profiler is not None and span is None and start >= deadline - trace_s and w.records:
            w.head_records, w.head_s = list(w.records), start - w.t0
            profiler.start()
            deadline += time.perf_counter() - start
            span = torch.profiler.record_function(WINDOW)
            span.__enter__()
        work, ok = op(i)
        w.records.append((start, time.perf_counter(), work, ok))
        i += 1
    sync()
    w.t_end = time.perf_counter()
    if span is not None:
        span.__exit__(None, None, None)
        profiler.stop()
    return w
