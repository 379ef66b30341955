"""Entropy-regularized p-Wasserstein (Sinkhorn) distance (counterpart of
sde_sampler_lrds_tpu/eval/sinkhorn.py).

The log-domain scaling loop runs in Python; each iteration's two
log-sum-exp reductions and the final transport cost go through
``ops/sinkhorn_lse``, which launches its CUDA kernels for tensors on the
card and runs its plain versions for tensors on the CPU, so the n × m cost
matrix is never stored on the card. Past the kernels' width (d > 224) the
plain versions run on either device, and ``config`` records backend
'plain'. The JAX package's host C++ tier
(``eval/native``) has no counterpart here.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.sinkhorn_lse import MAX_DIM, lse, lse_plain, transport_cost, transport_cost_plain

KERNEL_OPS = (lse, transport_cost)
PLAIN_OPS = (lse_plain, transport_cost_plain)


class Sinkhorn:
    """Sinkhorn distance with uniform or importance weights: ε-scaled
    log-domain updates, a ``max_iters`` cap, ``stop_thresh`` on the dual
    increments, ``n_max`` truncation. With ``eps_annealing`` (the default)
    ε decays geometrically from ``eps_start`` over the first ⌊2/3·max_iters⌋
    iterations and the rest polish at ``eps``; the stopping rule is off while
    annealing."""

    def __init__(self, p: int = 2, eps: float = 1e-3, max_iters: int = 100,
                 stop_thresh: float = 1e-5, n_max: int | None = None,
                 eps_annealing: bool = True, eps_start: float = 1.0):
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"p must be an integer greater than 0, got {p}")
        if eps <= 0:
            raise ValueError("Entropy regularization term eps must be > 0")
        self.p = p
        self.eps = eps
        self.max_iters = max_iters
        self.stop_thresh = stop_thresh
        self.n_max = n_max
        self.eps_annealing = eps_annealing
        self.eps_start = eps_start
        self.backend: str | None = None     # which ops ran last: 'cuda' or 'plain'
        self.n_iters: int | None = None     # iterations the last call ran

    @property
    def config(self) -> dict:
        """Serializable settings. With ``eps_annealing`` the values are not
        comparable with the pykeops reference pipeline, which runs raw
        ε = 1e-3 updates (``reference_comparable``)."""
        return {"p": self.p, "eps": self.eps, "max_iters": self.max_iters,
                "stop_thresh": self.stop_thresh, "n_max": self.n_max,
                "eps_annealing": self.eps_annealing, "eps_start": self.eps_start,
                "backend": self.backend, "reference_comparable": not self.eps_annealing}

    def eps_schedule(self) -> np.ndarray:
        """The per-iteration ε, float32, computed as the JAX package does."""
        if self.eps_annealing and self.eps_start > self.eps:
            n_anneal = max(int(self.max_iters * 2 / 3), 1)
            decay = (self.eps / self.eps_start) ** (1.0 / n_anneal)
            sched = self.eps_start * torch.tensor(decay, dtype=torch.float32) ** \
                torch.arange(self.max_iters, dtype=torch.float32)
            return torch.clamp(sched, min=self.eps).numpy()
        return np.full((self.max_iters,), self.eps, np.float32)

    @torch.no_grad()
    def compute(self, x, y, w_x=None, w_y=None, ops=None) -> torch.Tensor:
        """The distance as a 0-d tensor. ``ops`` = (lse, transport_cost)
        defaults to the kernel wrappers up to the kernels' width ``MAX_DIM``
        and to ``PLAIN_OPS`` past it; ``PLAIN_OPS`` runs the plain versions
        on any device."""
        lse_fn, cost_fn = ops or (KERNEL_OPS if x.shape[-1] <= MAX_DIM else PLAIN_OPS)
        x, y = x.float(), y.float()
        n, m = x.shape[0], y.shape[0]
        w_x = torch.full((n,), 1.0 / n, device=x.device) if w_x is None \
            else w_x.float().reshape(-1)
        w_y = torch.full((m,), 1.0 / m, device=x.device) if w_y is None \
            else w_y.float().reshape(-1)
        log_a, log_b = torch.log(w_x), torch.log(w_y)
        u = torch.zeros_like(w_x)
        v = self.eps * log_b
        # float32 thresholds, as the JAX loop compares its float32 values
        target, stop = np.float32(self.eps), np.float32(self.stop_thresh)
        it = 0
        for e in self.eps_schedule():
            e_f = float(e)
            u_new = e_f * (log_a - lse_fn(x, y, v, e_f, self.p))
            v_new = e_f * (log_b - lse_fn(y, x, u_new, e_f, self.p))
            it += 1
            # never stop while annealing, and read nothing back then
            err = float("inf") if e > target else float(torch.maximum(
                torch.max(torch.abs(u - u_new)), torch.max(torch.abs(v - v_new))))
            u, v = u_new, v_new
            if not err > stop:
                break
        self.n_iters = it
        self.backend = "cuda" if (x.device.type == "cuda" and lse_fn is lse) else "plain"
        logging.info("Sinkhorn ran %d iterations (%s)", it, self.backend)
        return cost_fn(x, y, u, v, self.eps, self.p)

    def __call__(self, x, y, w_x=None, w_y=None) -> torch.Tensor:
        if self.n_max is not None:
            # balanced Sinkhorn needs equal marginal mass: renormalize
            # truncated weights
            x, y = x[: self.n_max], y[: self.n_max]
            if w_x is not None:
                w_x = w_x[: self.n_max]
                w_x = w_x / w_x.sum()
            if w_y is not None:
                w_y = w_y[: self.n_max]
                w_y = w_y / w_y.sum()
        return self.compute(x, y, w_x=w_x, w_y=w_y)
