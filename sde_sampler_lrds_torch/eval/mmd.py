"""Median-heuristic Gaussian-kernel Maximum Mean Discrepancy (counterpart of
sde_sampler_lrds_tpu/eval/mmd.py): pairwise squared distances through Gram
matrices, bandwidth = the median of all pairwise distances, the unbiased
MMD² estimate with a sqrt clamp."""
from __future__ import annotations

import torch


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)


def median(values: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor as ``jnp.median`` takes it: the mean of
    the two middle values when the length is even (``torch.median`` returns
    the lower one, and ``torch.quantile`` refuses more than 2^24 values)."""
    s = torch.sort(values).values
    k = s.shape[0]
    if k % 2:
        return s[k // 2]
    return 0.5 * (s[k // 2 - 1] + s[k // 2])


def mmd_median(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    n, m = x.shape[0], y.shape[0]
    if n != m or n < 2:
        raise ValueError(f"mmd_median needs two sets of the same size >= 2, got {n}, {m}")
    d_xx, d_yy, d_xy = _sq_dists(x, x), _sq_dists(y, y), _sq_dists(x, y)
    upper = torch.ones((n, n), dtype=torch.bool, device=x.device).triu_(1)
    bandwidth_sq = median(torch.cat([d_xx[upper], d_yy[upper], d_xy.reshape(-1)]))
    del upper
    k_xx = torch.exp(-d_xx / (2 * bandwidth_sq))
    k_yy = torch.exp(-d_yy / (2 * bandwidth_sq))
    k_xy = torch.exp(-d_xy / (2 * bandwidth_sq))
    mmd = (k_xx.sum() - n) / (n * (n - 1))
    mmd = mmd + (k_yy.sum() - m) / (m * (m - 1))
    mmd = mmd - 2.0 * k_xy.mean()
    return torch.sqrt(torch.clamp(mmd, min=1e-20))
