"""Euler-Maruyama integration of an SDE over a time grid (counterpart of
sde_sampler_lrds_tpu/sde/integrator.py): a loop over the steps, the
Brownian increments drawn from a ``torch.Generator`` or fed."""
from __future__ import annotations

import torch


@torch.no_grad()
def integrate_sde(sde, generator, ts: torch.Tensor, x_init: torch.Tensor,
                  return_traj: bool = True, noise: torch.Tensor | None = None):
    """Integrate dX = drift dt + diff dW over the (K+1,) grid ``ts``: the
    trajectory (K+1, B, D) with ``return_traj``, else the terminal state.
    ``noise`` (K, B, D) standard normals replace the draws."""
    x = x_init
    traj = [x]
    for k in range(ts.shape[0] - 1):
        s, t = ts[k], ts[k + 1]
        z = noise[k] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = x + sde.drift(s, x) * (t - s) + sde.diff(s, x) * (torch.sqrt(t - s) * z)
        if return_traj:
            traj.append(x)
    return torch.stack(traj) if return_traj else x


def interpolate_traj(traj: torch.Tensor, grid: torch.Tensor, out_ts: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a (K+1, B, D) trajectory onto ``out_ts``."""
    idx = torch.clamp(torch.searchsorted(grid, out_ts, right=True) - 1, 0, grid.shape[0] - 2)
    t0, t1 = grid[idx], grid[idx + 1]
    w = ((out_ts - t0) / torch.clamp(t1 - t0, min=1e-12))[:, None, None]
    return traj[idx] * (1 - w) + traj[idx + 1] * w


class EulerIntegrator:
    """Integrate on an (optionally finer, ``sde_steps``) internal grid, then
    interpolate linearly onto the requested times."""

    def __init__(self, sde_steps: int | None = None):
        self.sde_steps = sde_steps

    def integrate(self, sde, generator, ts: torch.Tensor, x_init: torch.Tensor,
                  timesteps: torch.Tensor | None = None) -> torch.Tensor:
        grid = ts if timesteps is None else timesteps
        if self.sde_steps is not None and self.sde_steps + 1 != grid.shape[0]:
            grid = torch.linspace(float(ts[0]), float(ts[-1]), self.sde_steps + 1,
                                  device=ts.device)
        traj = integrate_sde(sde, generator, grid, x_init, return_traj=True)
        if timesteps is not None or grid.shape[0] != ts.shape[0]:
            return interpolate_traj(traj, grid, ts)
        return traj


def make_brownian_increments(generator, ts: torch.Tensor, shape: tuple) -> torch.Tensor:
    """All Brownian increments of a grid at once: (K, *shape)."""
    dts = ts[1:] - ts[:-1]
    z = torch.randn((dts.shape[0], *shape), generator=generator, device=ts.device)
    return z * torch.sqrt(dts).reshape(-1, *([1] * len(shape)))
