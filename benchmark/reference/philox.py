"""The Philox4x32-10 + Box–Muller normal of the port's trajectory kernel,
in torch int64: the normal for each (trajectory, dimension) pair at one
step from the kernel's 64-bit seed. A frozen copy of ``chip_smoke.py``'s
``philox_normals``, so the reference draws the same noise as the kernel
without running it."""
from __future__ import annotations

import torch


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m·a for 32-bit m and a held in int64: the
    product is split at a's 16th bit so nothing overflows."""
    p1, p0 = m * (a >> 16), m * (a & 0xFFFF)
    t = p1 + (p0 >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox_normals(seed: int, step: int, traj: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """The kernel's standard normal for each (trajectory, dimension) pair at
    one step, float64 from the same bits and float32 Box–Muller inputs."""
    mask = 0xFFFFFFFF
    c0, c2 = traj.to(torch.int64), dim.to(torch.int64)
    c1, c3 = torch.full_like(c0, step), torch.zeros_like(c0)
    k0, k1 = seed & mask, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
    f1 = (c0 >> 8).to(torch.float32) * 2.0**-24
    f2 = (c1 >> 8).to(torch.float32) * 2.0**-24
    angle = torch.tensor(6.2831855, dtype=torch.float32, device=f2.device) * f2
    return torch.sqrt(-2.0 * torch.log((1.0 - f1).double())) * torch.cos(angle.double())


def step_normals(seed: int, step: int, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """(len(rows), dim) float64 normals of step ``step`` for trajectories
    ``rows`` (their indices in the launch)."""
    traj = rows.repeat_interleave(dim)
    dims = torch.arange(dim, device=rows.device).repeat(rows.shape[0])
    return philox_normals(seed, step, traj, dims).reshape(rows.shape[0], dim)
