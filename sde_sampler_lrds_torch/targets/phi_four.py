"""φ⁴ lattice field theory target on a 1-D or 2-D grid (counterpart of
sde_sampler_lrds_tpu/targets/phi_four.py).

Energy U(φ) = a·d·Σ(∇φ)²/2 + Σ[(1-φ²)²/4 + b·φ]/(a·d), Gibbs density
e^{-β U}. The exact transfer-matrix oracle of the 1-D Dirichlet chain (log Z
and the centre-site inter-well weight) and its exact sampler (forward
filter, backward sampling) are host numpy/scipy float64 code, kept here as
their own copy. The Laplace oracle (``compute_stats_integration``) runs the
gradient-descent flow from ±1 to the two energy minima ``x_min`` on the
target's device and weighs the wells by their Laplace approximations.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F

from .base import Target, run_gdflow


class PhiFour(Target):
    def __init__(self, a: float, b: float, dim: int, dim_phys: int = 1,
                 beta: float = 1.0, bc=("dirichlet", 0.0), tilt=None,
                 grid_points: int = 1024, **kwargs):
        self.a = a
        self.b = b
        self.beta = beta
        self.dim_grid = dim
        self.dim_phys = dim_phys
        self.sum_dims = tuple(i + 1 for i in range(dim_phys))
        self.bc = bc
        self.tilt = tilt
        self.coef = a * dim
        super().__init__(dim=dim, grid_points=grid_points, **kwargs)
        ones = torch.ones(dim, device=self.device)
        self.set_domain(torch.stack([-1.5 * ones, 1.5 * ones], dim=1))

    def _reshape(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim_phys == 2:
            return x.reshape(-1, self.dim_grid, self.dim_grid)
        return x.reshape(-1, self.dim_grid)

    def V(self, x: torch.Tensor) -> torch.Tensor:
        x = self._reshape(x)
        v = ((1 - x**2) ** 2 / 4 + self.b * x).sum(self.sum_dims) / self.coef
        if self.tilt is not None:
            tilt = (self.tilt["val"] - x.mean(self.sum_dims)) ** 2
            v = v + self.tilt["lambda"] * tilt / (4 * self.dim_grid)
        return v

    def U(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim_phys > 2:
            raise NotImplementedError("only 1-d and 2-d lattices are implemented")
        x = self._reshape(x)
        if self.bc[0] == "dirichlet":
            x_ = F.pad(x, (1, 1) * self.dim_phys, value=float(self.bc[1]))
        elif self.bc[0] == "pbc":          # wrap: prepend the last row / column
            x_ = x
            for axis in range(1, self.dim_phys + 1):
                x_ = torch.cat([x_.narrow(axis, x_.shape[axis] - 1, 1), x_], dim=axis)
        else:
            raise NotImplementedError("Only dirichlet and periodic BC implemented.")
        if self.dim_phys == 2:
            grad_x = (x_[:, 1:, :-1] - x_[:, :-1, :-1]) ** 2 / 2
            grad_y = (x_[:, :-1, 1:] - x_[:, :-1, :-1]) ** 2 / 2
            grad_term = (grad_x + grad_y).sum(self.sum_dims)
        else:
            grad_term = ((x_[:, 1:] - x_[:, :-1]) ** 2 / 2).sum(self.sum_dims)
        return grad_term * self.coef + self.V(x)

    def grad_U(self, x: torch.Tensor) -> torch.Tensor:
        if self.bc != ("dirichlet", 0.0) or self.dim_phys != 1 or self.tilt is not None:
            raise NotImplementedError("the analytic gradient covers the 1-d chain with "
                                      "zero Dirichlet boundaries and no tilt")
        x = self._reshape(x)
        ret = (self.b - x * (1.0 - x**2)) / self.coef
        lap = 2.0 * x - F.pad(x[:, 1:], (0, 1)) - F.pad(x[:, :-1], (1, 0))
        return ret + self.coef * lap

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        lp = -self.beta * self.U(torch.atleast_2d(x))
        return lp.reshape(x.shape[:-1])

    def score(self, x: torch.Tensor) -> torch.Tensor:
        return -self.beta * self.grad_U(x)

    def compute_stats(self, generator: torch.Generator | None = None):
        """The exact transfer-matrix statistics where the chain allows them."""
        if self._tm_supported():
            self.compute_stats_transfer_matrix()
        else:
            logging.warning("Cannot compute statistics for %s", type(self).__name__)

    # -- Laplace-approximation oracle ------------------------------------------
    def hessian(self, x: torch.Tensor) -> torch.Tensor:
        """∇²U at one configuration x (dim,): on the 1-d chain the band
        2·coef + (3x² − 1)/coef on the diagonal and −coef beside it (each
        site sits in two Dirichlet bonds); on 2-d lattices the autograd
        Hessian of U."""
        if self.dim_phys != 1:
            return torch.autograd.functional.hessian(lambda y: self.U(y[None])[0], x)
        d = x.shape[-1]
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        off = torch.diag(torch.ones(d - 1, dtype=x.dtype, device=x.device), 1)
        return eye * (2 * self.coef + (3 * x**2 - 1) / self.coef) - self.coef * (off + off.T)

    def log_laplace(self, x: torch.Tensor):
        """(−βU(x), its Laplace approximation −βU(x) + (dim/2)·log(2π/β) −
        ½·log det ∇²U(x)) at a minimum x (dim,)."""
        log_l = -self.beta * self.U(x[None])[0]
        corr = (self.dim_grid / 2) * math.log(2 * math.pi / self.beta)
        corr = corr - 0.5 * torch.linalg.slogdet(self.hessian(x))[1]
        return log_l, log_l + corr

    def compute_stats_integration(self):
        """``compute_laplace_stats``, then the exact transfer-matrix
        statistics where the chain allows them."""
        self.compute_laplace_stats()
        if self._tm_supported():
            self.compute_stats_transfer_matrix()

    def compute_laplace_stats(self):
        """The gradient-descent flow (10 000 steps of 5e-3) from +1 and −1 to
        the two minima ``x_min`` (2, dim), and the wells' weight from their
        raw energies (``true_weight``) and from their Laplace approximations
        (``true_weight_cor``)."""
        ones = torch.ones(self.dim, device=self.device)
        x = run_gdflow(self.grad_U, torch.stack([ones, -ones]), 10000, 5e-3)
        self.x_min = x
        _, lap_pos = self.log_laplace(x[0])
        _, lap_neg = self.log_laplace(x[1])
        en_pos = -self.beta * self.U(x[0][None])[0]
        en_neg = -self.beta * self.U(x[1][None])[0]
        self.expectations["true_weight"] = float(torch.exp(en_neg - en_pos))
        self.expectations["true_weight_cor"] = float(torch.exp(lap_neg - lap_pos))

    # -- exact transfer-matrix oracle (1-d chain), host float64 --------------
    def _tm_supported(self) -> bool:
        return (self.dim_phys == 1 and self.tilt is None
                and self.bc[0] == "dirichlet" and float(self.bc[1]) == 0.0)

    def _tm_messages(self, grid_points: int = 1601, grid_limit: float = 3.0):
        """Forward messages of the site-factorized chain on a 1-d grid:
        p(φ) ∝ Π_i exp(site(φ_i)) · Π_bonds exp(bond(φ_i, φ_{i+1})) with two
        Dirichlet boundary bonds to 0; cached per (G, L)."""
        key = (grid_points, grid_limit)
        if getattr(self, "_tm_cache_key", None) == key:
            return self._tm_cache
        from scipy.special import logsumexp

        u = np.linspace(-grid_limit, grid_limit, grid_points)
        du = u[1] - u[0]
        site = -self.beta * ((1 - u**2) ** 2 / 4 + self.b * u) / self.coef
        bond = -self.beta * self.coef * (u[None, :] - u[:, None]) ** 2 / 2
        b0 = -self.beta * self.coef * u**2 / 2  # boundary bond to φ=0
        alphas = np.empty((self.dim, grid_points))
        alphas[0] = b0 + site + np.log(du)
        for i in range(1, self.dim):
            alphas[i] = logsumexp(alphas[i - 1][:, None] + bond, axis=0) \
                + site + np.log(du)
        self._tm_cache_key = key
        self._tm_cache = (u, du, site, bond, b0, alphas)
        return self._tm_cache

    def compute_stats_transfer_matrix(self, grid_points: int = 1601,
                                      grid_limit: float = 3.0):
        """Exact log Z and centre-site inter-well weight, stored as
        ``log_norm_const`` and ``expectations['weight']`` (and
        ``'weight_rb'``, ``'true_weight_tm'``)."""
        if not self._tm_supported():
            raise NotImplementedError("the transfer-matrix oracle covers the 1-d chain "
                                      "with zero Dirichlet boundaries and no tilt")
        from scipy.special import logsumexp

        u, du, site, bond, b0, alphas = self._tm_messages(grid_points, grid_limit)
        self.log_norm_const = float(logsumexp(alphas[-1] + b0))
        betas = b0.copy()
        c = self.dim // 2
        for i in range(self.dim - 2, c - 1, -1):
            betas = logsumexp(bond + (betas + site + np.log(du))[None, :], axis=1)
        marg = alphas[c] + betas
        w = float(np.exp(logsumexp(marg[u < 0]) - logsumexp(marg[u > 0])))
        self.expectations["true_weight_tm"] = w
        self.expectations["weight"] = w
        self.expectations["weight_rb"] = w
        return w

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        """Exact i.i.d. samples of the 1-d Dirichlet chain by forward-filter
        backward-sampling on the transfer-matrix grid, on the host; a numpy
        generator is seeded from one draw of ``generator``."""
        if not self._tm_supported():
            raise NotImplementedError("exact sampling needs the 1-d Dirichlet chain")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
        n = int(np.prod(shape)) if shape else 1
        out = self.ffbs_sample(np.random.default_rng(seed), n)
        return torch.as_tensor(out, dtype=torch.float32,
                               device=self.device).reshape(*shape, self.dim)

    def ffbs_sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` exact samples (n, dim) from ``rng``: the last site from its
        marginal, each earlier one from its conditional given the next by
        inverse CDF on a 601-point grid, then a uniform ±du/2 jitter, with
        the JAX package's arithmetic and draw order."""
        u, du, site, bond, b0, alphas = self._tm_messages(grid_points=601)
        out = np.empty((n, self.dim))
        logp = alphas[-1] + b0
        p = np.exp(logp - logp.max())
        idx = rng.choice(len(u), size=n, p=p / p.sum())
        out[:, self.dim - 1] = u[idx]
        for i in range(self.dim - 2, -1, -1):
            # p(u_i | u_{i+1} = u[c]) ∝ exp(alpha_i(u) + bond(u, c))
            m = alphas[i][:, None] + bond
            m -= m.max(axis=0, keepdims=True)
            cdf = np.cumsum(np.exp(m, dtype=np.float32), axis=0)
            cdf /= cdf[-1:, :]
            r = rng.random(n)
            idx = (cdf[:, idx] < r[None, :]).sum(axis=0)
            out[:, i] = u[idx]
        out += rng.uniform(-du / 2, du / 2, size=out.shape)
        return out.astype(np.float32)

    # -- inter-well weight estimators -----------------------------------------
    def compute_phi_four_weight(self, samples: torch.Tensor) -> torch.Tensor:
        frac = (samples[:, self.dim // 2] > 0).float().mean()
        return (1.0 - frac) / frac

    def compute_phi_four_weight_rb(self, samples: torch.Tensor) -> torch.Tensor:
        """Z2-antithetic Rao-Blackwellized inter-well weight: for every pair
        {x, −x} the negative-well member's conditional probability is
        sigmoid(log p̃(x⁻) − log p̃(x⁺)) = sigmoid(2βb·Σφ/coef), computed
        analytically (the even terms of U cancel; subtracting two float32
        log-probs would lose the ~0.2-nat tilt). Samples beyond 3× the domain
        box count as diverged and are dropped; none left gives NaN."""
        if self.tilt is not None:
            raise NotImplementedError("the tilt term is not odd: no analytic pair ratio")
        m = self._reshape(samples).sum(self.sum_dims)
        pos = samples[:, self.dim // 2] > 0
        m_pos_member = torch.where(pos, m, -m)
        sig_neg = torch.sigmoid(2.0 * self.beta * self.b * m_pos_member / self.coef)
        lo, hi = 3.0 * self.domain[:, 0], 3.0 * self.domain[:, 1]
        valid = torch.all((samples >= lo) & (samples <= hi), dim=-1)
        num = torch.where(valid, sig_neg, torch.zeros_like(sig_neg)).sum()
        den = torch.where(valid, 1.0 - sig_neg, torch.zeros_like(sig_neg)).sum()
        return torch.where(valid.any(), num / den, torch.full_like(num, float("nan")))
