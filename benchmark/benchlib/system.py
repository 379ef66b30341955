"""What a configuration's ``build`` returns: the program's solver set up
from the seed, its operations, and the check of what the window produced.

A subclass provides ``warm_up()``, ``operation(name) -> op(i) -> (work,
ok)``, ``counts()`` (the frozen counts its metrics read),
``expected_launches(n_ops)``, ``check() -> {name: (value, limit)}`` and
``plant(fault)``."""
from __future__ import annotations

import gc
import random

import torch

B1_COUNTERS = ("launches", "cluster_launches", "wide_launches", "full_cov_launches",
               "bf16_launches")


class System:
    def __init__(self, seed: int, device: torch.device):
        self.seed, self.device = seed, device
        self.solver = None

    def launch_counters(self) -> dict:
        """The port's B1 launch counters (``ops/fused_traj.py``)."""
        from sde_sampler_lrds_torch.ops.fused_traj import fused_traj

        return {f"fused_traj.{k}": getattr(fused_traj, k) for k in B1_COUNTERS}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.solver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def plant(self, fault: str) -> None:
        raise ValueError(f"{type(self).__name__} has no fault {fault!r}")


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (Algorithm R): which operations of the window are checked."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1
