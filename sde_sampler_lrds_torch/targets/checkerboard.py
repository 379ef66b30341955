"""2-D checkerboard: a mixture of uniform 2 × 2 squares with a zero score
(counterpart of sde_sampler_lrds_tpu/targets/checkerboard.py). The board
spans x ∈ [-4, -4 + 2·width], y ∈ [-4, 4]; with ``unequilibrated`` the
squares at even positions weigh 3 times the others."""
from __future__ import annotations

import math

import torch

from .base import ModeMetrics, Target


class Checkerboard(ModeMetrics, Target):
    def __init__(self, dim: int = 2, width: int = 4, unequilibrated: bool = True,
                 n_reference_samples: int = int(1e5), domain=None, device=None):
        if dim != 2:
            raise ValueError("The checkerboard should be two-dimensional.")
        super().__init__(dim=2, log_norm_const=0.0, n_reference_samples=n_reference_samples,
                         domain=domain, device=device)
        self.width = width
        x_min, y_max = self._extremal_points()
        self.n_mixtures = x_min.shape[0]
        self.low = torch.stack([x_min, y_max - 2], dim=-1)        # (K, 2)
        self.high = torch.stack([x_min + 2, y_max], dim=-1)       # (K, 2)
        self.loc = 0.5 * (self.low + self.high)
        weights = torch.ones(self.n_mixtures, device=self.device)
        if unequilibrated:
            weights[::2] *= 3
        self.mixture_weights = weights
        self._probs = weights / weights.sum()
        if self.domain is None:
            self.set_domain([[-4.0, -4.0 + 2 * self.width], [-4.0, 4.0]])

    def _extremal_points(self):
        """Each square's left x and top y, two rows of squares a y."""
        x_pos, y_pos = [], []
        for y in (4, 0):
            xs = list(range(-2, -4 + 2 * self.width, 4))
            x_pos += xs
            y_pos += [y] * len(xs)
            xs = list(range(-4, -4 + 2 * self.width, 4))
            x_pos += xs
            y_pos += [y - 2] * len(xs)
        as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        return as_t(x_pos), as_t(y_pos)

    def _inside(self, flat: torch.Tensor) -> torch.Tensor:
        """(B, K): whether each point lies in each (closed) square."""
        s = flat[:, None, :]
        return torch.all((s >= self.low[None]) & (s <= self.high[None]), dim=-1)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log of Σ_k p_k·1[x in square k]/4; exactly −inf off the board, so
        an off-board terminal sample gives rnd = +inf, which the isfinite
        leg of the max_rnd filter (compute_results, the training mask)
        removes. ``score`` is zeros, so no gradient passes through it."""
        dens = torch.sum(self._probs[None, :] * self._inside(x.reshape(-1, 2)) / 4.0, dim=-1)
        lp = torch.where(dens > 0, torch.log(torch.clamp(dens, min=1e-38)),
                         torch.full_like(dens, -math.inf))
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        idx = torch.multinomial(self._probs, math.prod(shape), replacement=True,
                                generator=generator).reshape(shape)
        u = torch.rand((*shape, 2), generator=generator, device=self.device)
        return self.low[idx] + u * (self.high[idx] - self.low[idx])

    # -- mode metrics, per square in the order of _extremal_points ----------
    def has_entropy(self) -> bool:
        return True

    def compute_mode_count(self, samples: torch.Tensor) -> torch.Tensor:
        """Samples in each square (float64), a sample on a shared edge
        counted in both."""
        return self._inside(samples).sum(dim=0).to(torch.float64)

    def _board_hist(self, counts: torch.Tensor) -> torch.Tensor:
        """The squares' shares of the on-board samples."""
        return self._hist(None, counts)

    def _entropy_norm(self) -> float:
        # log 4 normalizes as the reference's (4, width) histogram does
        return math.log(4.0)
