"""Particle resampling: systematic (inverse-CDF lookup kernel) and
multinomial (counterpart of sde_sampler_lrds_tpu/ops/resample.py).

Systematic resampling draws one uniform u₀, places positions (i + u₀)/N and
looks each up in the cumulative weights: idx_i = #{j : cdf_j < pos_i},
clipped to N − 1. ``systematic_lookup`` launches the hand-written kernel
``csrc/resample.cu`` on a CUDA tensor and runs its plain version on a CPU
tensor; the softmax and cumsum around it are PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

_CHUNK_ELEMS = 1 << 24      # plain version: compare-mask elements per chunk


def systematic_lookup_plain(cdf: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The lookup kernel's plain version, the TPU kernel's count itself:
    #{j : cdf_j < pos_i} clipped to N − 1, as int32 (N,)."""
    n = cdf.shape[0]
    out = torch.empty((positions.shape[0],), dtype=torch.int32, device=cdf.device)
    chunk = max(1, _CHUNK_ELEMS // max(n, 1))
    for i in range(0, positions.shape[0], chunk):
        cnt = (cdf[None, :] < positions[i:i + chunk, None]).sum(dim=1)
        out[i:i + chunk] = torch.clamp(cnt, max=n - 1).to(torch.int32)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("resample")
    ptr = ctypes.c_void_p
    lib.resample_lookup_launch.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr]
    lib.resample_lookup_launch.restype = ctypes.c_int
    lib.resample_empty_launch.argtypes = [ptr]
    lib.resample_empty_launch.restype = ctypes.c_int
    lib.resample_error_string.argtypes = [ctypes.c_int]
    lib.resample_error_string.restype = ctypes.c_char_p
    return lib


def systematic_lookup(cdf: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """#{j : cdf_j < pos_i} clipped to N − 1 for a non-decreasing cdf (N,)
    and positions (N,): int32 (N,). On a CPU tensor this is
    ``systematic_lookup_plain``; on a CUDA tensor it launches the kernel
    (counted in ``systematic_lookup.launches``) or raises."""
    n = cdf.shape[0]
    if cdf.ndim != 1 or positions.shape != (n,) or positions.device != cdf.device:
        raise ValueError("systematic_lookup: cdf and positions must be (N,) on one device")
    if cdf.device.type == "cpu":
        return systematic_lookup_plain(cdf, positions)
    if cdf.device.type != "cuda":
        raise ValueError(f"systematic_lookup runs on cpu or cuda, got {cdf.device}")
    if cdf.dtype != torch.float32 or positions.dtype != torch.float32:
        raise ValueError("systematic_lookup: the kernel takes float32 cdf and positions")
    out = torch.empty((n,), dtype=torch.int32, device=cdf.device)
    if n == 0:
        return out
    lib = _library()
    cdf, positions = cdf.contiguous(), positions.contiguous()
    with torch.cuda.device(cdf.device):
        err = lib.resample_lookup_launch(cdf.data_ptr(), positions.data_ptr(),
                                         out.data_ptr(), n,
                                         torch.cuda.current_stream(cdf.device).cuda_stream)
    if err != 0:
        raise RuntimeError("resample lookup kernel launch failed: "
                           + lib.resample_error_string(err).decode())
    systematic_lookup.launches += 1
    return out


systematic_lookup.launches = 0


def empty_launch(device: torch.device) -> None:
    """Launches a kernel that does nothing, on the current stream of
    ``device``: the card's launch floor, timed beside the lookup. No path
    runs it, and it is not counted."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.resample_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("empty kernel launch failed: "
                           + lib.resample_error_string(err).decode())


def weights_cdf(w: torch.Tensor) -> torch.Tensor:
    """The cumulative sum of non-negative weights (N,), made non-decreasing
    with a zero weight tied to the prefix before it. A parallel scan on the
    card rounds each prefix on its own, so a zero weight's prefix can land
    an ulp above its neighbour's (and be drawn) or one below (and break the
    order the lookup needs). The running max over the positive weights'
    prefixes only restores both properties; on the CPU's sequential cumsum
    it changes nothing but the leading zero weights, which become -inf."""
    prefix = torch.where(w > 0, torch.cumsum(w, dim=0), float("-inf"))
    return torch.cummax(prefix, dim=0).values


def systematic_resample(generator: torch.Generator, log_weights: torch.Tensor,
                        u0: torch.Tensor | float | None = None) -> torch.Tensor:
    """Indices (N,) int32 of the systematic resampling of softmax(log_weights).
    ``u0`` replaces the uniform draw when fed."""
    n = log_weights.shape[0]
    dev = log_weights.device
    cdf = weights_cdf(torch.softmax(log_weights.float(), dim=0))
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=dev)
    positions = (torch.arange(n, dtype=torch.float32, device=dev)
                 + torch.as_tensor(u0, dtype=torch.float32, device=dev)) / n
    return systematic_lookup(cdf, positions)


def multinomial_resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """N draws from the categorical distribution softmax(log_weights)."""
    n = log_weights.shape[0]
    return torch.multinomial(torch.softmax(log_weights.float(), dim=0), n,
                             replacement=True, generator=generator)
