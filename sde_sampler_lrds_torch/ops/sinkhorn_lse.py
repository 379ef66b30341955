"""Sinkhorn log-sum-exp and transport-cost reductions (counterpart of
sde_sampler_lrds_tpu/ops/sinkhorn_lse.py).

With M_ij = ‖x_i − y_j‖_p:

    lse(x, y, dual, eps)[i]          = logsumexp_j[(dual_j − M_ij)/eps]
    transport_cost(x, y, u, v, eps)  = Σ_ij exp((u_i + v_j − M_ij)/eps)·M_ij

On a CUDA tensor each wrapper launches the hand-written kernel
``csrc/sinkhorn_lse.cu`` (the cost matrix never reaches device memory); on
a CPU tensor it runs its plain version, which builds the cost matrix a
block of rows at a time. p = 2 uses the |x|² + |y|² − 2x·y expansion in
both, as the JAX package does. A dual of −inf is legal: its term drops
out, and a row whose every logit is −inf gives −inf.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

# the kernel keeps 128 rows of x and 128 columns of y in shared memory;
# beyond this width a block would exceed the card's 227 KB
MAX_DIM = 224
_BLOCK_ELEMS = 1 << 24      # plain version: pair-cost elements per block


def pairwise_cost(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(na, nb) distances ‖a_i − b_j‖_p."""
    if p == 2:
        sq = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
        return torch.sqrt(torch.clamp(sq, min=0.0))
    diff = torch.abs(a[:, None, :] - b[None, :, :])
    if p == 1:
        return diff.sum(-1)
    # |Δ|^p: a signed power is NaN-prone for odd p
    return (diff**p).sum(-1) ** (1.0 / p)


def _row_blocks(x: torch.Tensor, y: torch.Tensor, p: int):
    per_row = y.shape[0] * (1 if p == 2 else max(x.shape[1], 1))
    bs = max(1, min(x.shape[0], _BLOCK_ELEMS // max(per_row, 1)))
    for i in range(0, x.shape[0], bs):
        yield i, pairwise_cost(x[i:i + bs], y, p)


def lse_plain(x, y, dual, eps: float, p: int = 2) -> torch.Tensor:
    """The lse kernel's plain version: (n,) float32."""
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    for i, cost in _row_blocks(x, y, p):
        out[i:i + cost.shape[0]] = torch.logsumexp((dual[None, :] - cost) / eps, dim=1)
    return out


def transport_cost_plain(x, y, u, v, eps: float, p: int = 2) -> torch.Tensor:
    """The transport-cost kernel's plain version: per-row sums, then their
    sum, as a 0-d float32 tensor."""
    rows = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    for i, cost in _row_blocks(x, y, p):
        r = slice(i, i + cost.shape[0])
        rows[r] = torch.sum(torch.exp((u[r, None] + v[None, :] - cost) / eps) * cost, dim=1)
    return torch.sum(rows)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("sinkhorn_lse")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sinkhorn_lse_launch.argtypes = [ptr, ptr, ptr, f32] + [i32] * 4 + [ptr] * 4
    lib.sinkhorn_lse_launch.restype = i32
    lib.sinkhorn_cost_launch.argtypes = [ptr] * 4 + [f32] + [i32] * 4 + [ptr] * 3
    lib.sinkhorn_cost_launch.restype = i32
    lib.sinkhorn_num_splits.argtypes = [i32, i32]
    lib.sinkhorn_num_splits.restype = i32
    lib.sinkhorn_error_string.argtypes = [i32]
    lib.sinkhorn_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, y, vectors: dict, p: int, name: str) -> None:
    if not isinstance(p, int) or p < 1:
        raise ValueError(f"{name}: p must be an integer >= 1, got {p!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"{name}: x (n, d) and y (m, d) must share d, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    for key, (t, length) in vectors.items():
        if t.shape != (length,):
            raise ValueError(f"{name}: {key} must have shape ({length},), got "
                             f"{tuple(t.shape)}")
    for t in (x, y, *(t for t, _ in vectors.values())):
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must lie on {x.device}")
        if x.device.type == "cuda" and t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32 inputs, got {t.dtype}")


def _launch_prep(x, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    if not 1 <= x.shape[1] <= MAX_DIM:
        raise ValueError(f"{name} kernel: d = {x.shape[1]} outside [1, {MAX_DIM}]")
    return _library(), torch.cuda.current_stream(x.device).cuda_stream


def lse(x: torch.Tensor, y: torch.Tensor, dual: torch.Tensor, eps: float,
        p: int = 2) -> torch.Tensor:
    """logsumexp_j[(dual_j − ‖x_i − y_j‖_p)/eps] for every row of x: (n,).
    On a CPU tensor this is ``lse_plain``; on a CUDA tensor it launches the
    kernel (counted in ``lse.launches``) or raises."""
    n, m = x.shape[0], y.shape[0]
    _check(x, y, {"dual": (dual, m)}, p, "lse")
    if x.device.type == "cpu":
        return lse_plain(x, y, dual, eps, p)
    lib, stream = _launch_prep(x, "lse")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    if m == 0:
        return out.fill_(float("-inf"))
    x, y, dual = x.contiguous(), y.contiguous(), dual.contiguous()
    splits = lib.sinkhorn_num_splits(n, m)
    part = torch.empty((2, splits, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sinkhorn_lse_launch(x.data_ptr(), y.data_ptr(), dual.data_ptr(),
                                      float(eps), p, n, m, x.shape[1],
                                      part[0].data_ptr(), part[1].data_ptr(),
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sinkhorn lse kernel launch failed: "
                           + lib.sinkhorn_error_string(err).decode())
    lse.launches += 1
    return out


lse.launches = 0


def transport_cost(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   eps: float, p: int = 2) -> torch.Tensor:
    """Σ_ij exp((u_i + v_j − ‖x_i − y_j‖_p)/eps)·‖x_i − y_j‖_p as a 0-d
    tensor. The kernel writes per-row sums, summed here with ``torch.sum``
    as the JAX package sums its kernel's rows. On a CPU tensor this is
    ``transport_cost_plain``; on a CUDA tensor it launches the kernel
    (counted in ``transport_cost.launches``) or raises."""
    n, m = x.shape[0], y.shape[0]
    _check(x, y, {"u": (u, n), "v": (v, m)}, p, "transport_cost")
    if x.device.type == "cpu":
        return transport_cost_plain(x, y, u, v, eps, p)
    lib, stream = _launch_prep(x, "transport_cost")
    rows = torch.zeros((n,), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return torch.sum(rows)
    x, y, u, v = x.contiguous(), y.contiguous(), u.contiguous(), v.contiguous()
    part = torch.empty((lib.sinkhorn_num_splits(n, m), n), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sinkhorn_cost_launch(x.data_ptr(), y.data_ptr(), u.data_ptr(),
                                       v.data_ptr(), float(eps), p, n, m, x.shape[1],
                                       part.data_ptr(), rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sinkhorn transport-cost kernel launch failed: "
                           + lib.sinkhorn_error_string(err).decode())
    transport_cost.launches += 1
    return torch.sum(rows)


transport_cost.launches = 0
