"""Sliced Kolmogorov-Smirnov distance through random 1-D projections
(counterpart of sde_sampler_lrds_tpu/eval/ks.py): both sample sets are
projected on shared random unit directions, binned into weighted histogram
CDFs on the first set's range, and the maximal CDF gap is averaged over the
directions."""
from __future__ import annotations

import torch


def _proj_cdf(samples, projs, n_bins, min_x, max_x, weights=None):
    """CDFs of the projected samples: (n_proj, n_bins)."""
    z = (samples @ projs.T).T                                   # (P, B)
    width = (max_x - min_x) / n_bins
    idx = torch.clamp(((z - min_x[:, None]) / width[:, None]).to(torch.int64),
                      0, n_bins - 1)
    w = torch.ones(z.shape[1], device=z.device) if weights is None \
        else weights.reshape(-1).to(z.dtype)
    in_range = (z >= min_x[:, None]) & (z <= max_x[:, None])
    wmat = w[None, :] * in_range
    hist = torch.zeros((z.shape[0], n_bins), dtype=z.dtype, device=z.device)
    hist.scatter_add_(1, idx, wmat)
    # out-of-range mass is dropped and each histogram renormalized over its
    # in-range sum; an all-out-of-range projection gives a zero CDF, not NaN
    hist = hist / torch.clamp(hist.sum(-1, keepdim=True), min=1e-30)
    return torch.cumsum(hist, dim=-1)


def compute_sliced_ks(samples1, samples2, generator: torch.Generator | None = None,
                      weights=None, n_random_projections: int = 128, n_bins: int = 256,
                      projs: torch.Tensor | None = None) -> torch.Tensor:
    """Mean (over projections) maximal CDF gap between the two sets. The
    directions are ``projs`` (normalized here) when given, else normal draws
    from ``generator`` (a fixed seed when that is None)."""
    if projs is None:
        if generator is None:
            generator = torch.Generator(samples1.device).manual_seed(0)
        projs = torch.randn((n_random_projections, samples1.shape[-1]),
                            generator=generator, device=samples1.device)
    projs = projs.to(samples1.device, torch.float32)
    projs = projs / torch.linalg.vector_norm(projs, dim=-1, keepdim=True)
    z1 = samples1 @ projs.T
    min_x, max_x = z1.min(dim=0).values, z1.max(dim=0).values
    cdf1 = _proj_cdf(samples1, projs, n_bins, min_x, max_x)
    cdf2 = _proj_cdf(samples2, projs, n_bins, min_x, max_x, weights=weights)
    return torch.max(torch.abs(cdf1 - cdf2), dim=-1).values.mean()
