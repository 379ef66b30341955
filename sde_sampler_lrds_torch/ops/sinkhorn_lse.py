"""Sinkhorn log-sum-exp and transport-cost reductions (counterpart of
sde_sampler_lrds_tpu/ops/sinkhorn_lse.py).

With M_ij = ‖x_i − y_j‖_p:

    lse(x, y, dual, eps)[i]          = logsumexp_j[(dual_j − M_ij)/eps]
    transport_cost(x, y, u, v, eps)  = Σ_ij exp((u_i + v_j − M_ij)/eps)·M_ij

On a CUDA tensor each wrapper launches the hand-written kernel
``csrc/sinkhorn_lse.cu`` at any d (the cost matrix never reaches device
memory; past d 16 the kernel walks d in chunks, so its shared memory does
not grow with d; at p = 2 there it takes the x·y products on the tensor
cores in 3×TF32) on the geometry ``sinkhorn_geometry`` picks, and merges
its per-split partials in a second pass; on a CPU tensor it runs its plain
version, which builds the cost matrix a block of rows at a time. p = 2
uses the |x|² + |y|² − 2x·y expansion in both, as the JAX package does. A
dual of −inf is legal: its term drops out, and a row whose every logit is
−inf gives −inf.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ._build import load_library

# the kernels' geometry (csrc/sinkhorn_lse.cu): 128 threads a block; at
# d ≤ 16 and p 1 or 2 four rows a thread in registers at a padded width of
# 4, 8 or 16 and tiles of 128 columns; past d 16 at p 2 the tensor-core
# body, 128 rows a block (4 warps of 32), tiles of 64 columns, d walked 32
# dimensions a stage at 40 floats a staged row; else (the stream body, any
# d) two rows a thread and tiles of 32 columns, d walked 16 dimensions a
# stage; a split's columns a multiple of 8 (the largest chunk), of 64 (a
# tile) in the tensor-core body
_THREADS, _ROWS_PER_THREAD, _TILE, _COL_ALIGN = 128, 4, 128, 8
_MMA_ROWS, _MMA_TILE, _MMA_CHUNK, _MMA_STRIDE = 128, 64, 32, 40
_WIDE_ROWS, _WIDE_TILE, _WIDE_CHUNK = 2, 32, 16
# resident blocks an SM the launch bounds ask for: narrow, tensor-core body,
# stream body (whose compensated sums take more registers)
_NARROW_BLOCKS, _MMA_BLOCKS, _SUM_BLOCKS = 4, 2, 2
MAX_SMEM_BYTES = 232_448        # shared memory a block may take
_SM_SMEM_BYTES = 233_472        # an SM's, of which 1 KB is reserved a block
# a block's fixed cost (its rows of x, the first tile's copy, the partial
# stores), in columns of work, when the splits are chosen
_BLOCK_OVERHEAD_COLS = 32
_BLOCK_ELEMS = 1 << 24      # plain version: pair-cost elements per block
# the kernels take logits in base 2: the scale log2(e)/eps, folded once
_LOG2E = 1.0 / math.log(2.0)


@dataclasses.dataclass(frozen=True)
class _Body:
    """One of the kernel's bodies (``body`` in the source)."""
    rows: int       # rows a block
    tile: int       # columns a tile
    chunk: int      # dimensions a stage; 0: d ≤ 16 in registers at a padded width
    align: int      # a split's columns are a multiple of this
    blocks: int     # resident blocks an SM the launch bounds ask for


_BODIES = {
    "narrow": _Body(_ROWS_PER_THREAD * _THREADS, _TILE, 0, _COL_ALIGN, _NARROW_BLOCKS),
    "mma": _Body(_MMA_ROWS, _MMA_TILE, _MMA_CHUNK, _MMA_TILE, _MMA_BLOCKS),
    "stream": _Body(_WIDE_ROWS * _THREADS, _WIDE_TILE, _WIDE_CHUNK, _COL_ALIGN, _SUM_BLOCKS),
}


def body(d: int, p: int) -> str:
    """The body that takes an (n, d) × (m, d) reduction at power p: 'narrow'
    at d ≤ 16 and p 1 or 2; 'mma' (x·y on the tensor cores) past d 16 at p
    2; 'stream' (d walked in stages on the float32 pipe) otherwise."""
    if d <= 16 and p in (1, 2):
        return "narrow"
    return "mma" if p == 2 else "stream"


@dataclasses.dataclass(frozen=True)
class SinkhornGeometry:
    """A launch of the Sinkhorn kernels: ``row_blocks`` × ``splits`` blocks
    of ``threads`` threads; block (i, k) owns rows [i·rows_per_block,
    (i + 1)·rows_per_block) and columns [k·cols_per_split,
    (k + 1)·cols_per_split) ∩ [0, m), staged ``tile_cols`` at a time."""
    body: str               # 'narrow', 'mma' or 'stream' (see ``body``)
    width: int              # padded width of a row: 4, 8, 16, or d rounded up to a stage
    rows_per_block: int
    threads: int
    row_blocks: int
    tile_cols: int
    cols_per_split: int
    splits: int
    smem_bytes: int
    blocks_per_sm: int      # resident blocks an SM the launch can count on


def smem_bytes(d: int, p: int, tile_cols: int) -> int:
    """Shared memory of a block (mirror of ``smem_bytes`` in the source).
    Narrow: two tiles of y at the padded width, the tile's (|y|², dual)
    pairs and two tiles of raw duals. Tensor-core body, the same at every
    d: two stages of the block's 128 rows of x and a tile's columns of y at
    40 floats a row, the tile's (|y|², dual) pairs and the rows' |x|².
    Stream body, the same at every d: two stages of a 16-dimension chunk of
    the block's rows of x and of a tile of y, and the tile's duals."""
    kind = body(d, p)
    if kind == "mma":
        return 4 * (2 * (_MMA_ROWS + tile_cols) * _MMA_STRIDE + 2 * tile_cols + _MMA_ROWS)
    if kind == "stream":
        return 4 * (2 * _WIDE_CHUNK * (_BODIES["stream"].rows + tile_cols) + tile_cols)
    return 4 * (2 * tile_cols * _padded_width(d, p) + 4 * tile_cols)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _padded_width(d: int, p: int) -> int:
    chunk = _BODIES[body(d, p)].chunk
    if chunk:
        return _ceil_div(d, chunk) * chunk
    return next(w for w in (4, 8, 16) if d <= w)


@functools.lru_cache(maxsize=None)
def sinkhorn_geometry(n: int, m: int, d: int, p: int, n_sms: int,
                      blocks_per_sm: int | None = None) -> SinkhornGeometry:
    """The kernels' geometry for an (n, d) × (m, d) reduction on a card of
    ``n_sms`` SMs. A wave is the blocks the card holds at once
    (``blocks_per_sm`` an SM: the body's launch bounds, fewer where shared
    memory binds; or the number given). Among the column splits that fill
    w whole waves, w = 1, 2, ..., it takes the one with the least waves ×
    (columns a split + a block's fixed cost), so each block walks one long
    range; a grid that reaches every SM comes first. At
    8192 × 8192 × 8 on 132 SMs: 16 row blocks × 32 splits of 256 columns;
    at 2048 × 2048 × 196: 16 row blocks × 16 splits of 128 columns."""
    if n < 1 or m < 1 or n_sms < 1 or d < 1 or p < 1:
        raise ValueError(f"sinkhorn_geometry: n {n}, m {m}, d {d}, p {p} and n_sms {n_sms} "
                         "out of range")
    kind = body(d, p)
    spec = _BODIES[kind]
    smem = smem_bytes(d, p, spec.tile)
    if blocks_per_sm is None:
        # the launch bounds' register budget, then shared memory
        blocks_per_sm = max(1, min(spec.blocks, _SM_SMEM_BYTES // (smem + 1024)))
    row_blocks = _ceil_div(n, spec.rows)
    slots = n_sms * blocks_per_sm
    fill = min(n_sms, row_blocks * _ceil_div(m, spec.align))
    best, waves, cols = None, 0, None
    while cols != spec.align:
        waves += 1
        max_splits = waves * slots // row_blocks
        if max_splits < 1:
            continue
        cols = _ceil_div(_ceil_div(m, max_splits), spec.align) * spec.align
        splits = _ceil_div(m, cols)
        blocks = row_blocks * splits
        key = (blocks < fill, _ceil_div(blocks, slots) * (cols + _BLOCK_OVERHEAD_COLS))
        if best is None or key < best[0]:
            best = (key, splits, cols)
    _, splits, cols = best
    return SinkhornGeometry(kind, _padded_width(d, p), spec.rows, _THREADS, row_blocks,
                            spec.tile, cols, splits, smem, blocks_per_sm)


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
    return declare(load_library("sinkhorn_lse"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of a built sinkhorn_lse library: every pointer and
    the stream as c_void_p, so none is cut to 32 bits."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sinkhorn_lse_launch.argtypes = [ptr, ptr, ptr, f32] + [i32] * 8 + [ptr] * 4
    lib.sinkhorn_lse_launch.restype = i32
    lib.sinkhorn_cost_launch.argtypes = [ptr] * 4 + [f32] + [i32] * 8 + [ptr] * 3
    lib.sinkhorn_cost_launch.restype = i32
    lib.sinkhorn_smem_bytes.argtypes = [i32, i32, i32]
    lib.sinkhorn_smem_bytes.restype = i32
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


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_prep(x, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    if x.shape[1] < 1:
        raise ValueError(f"{name} kernel: d = {x.shape[1]}, at least 1 needed")
    return _library(), torch.cuda.current_stream(x.device).cuda_stream


def _geometry_args(x, m: int, p: int):
    """The launch's geometry and its launch arguments (tile, columns a
    split, splits, shared memory)."""
    geom = sinkhorn_geometry(x.shape[0], m, x.shape[1], p, _sm_count(x.device))
    return geom, (geom.tile_cols, geom.cols_per_split, geom.splits, geom.smem_bytes)


def lse(x: torch.Tensor, y: torch.Tensor, dual: torch.Tensor, eps: float,
        p: int = 2) -> torch.Tensor:
    """logsumexp_j[(dual_j − ‖x_i − y_j‖_p)/eps] for every row of x: (n,).
    On a CPU tensor this is ``lse_plain``; on a CUDA tensor it launches the
    kernel (counted in ``lse.launches``, and those of the tensor-core body
    also in ``lse.mma_launches``) or raises."""
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
    geom, geom_args = _geometry_args(x, m, p)
    x, y, dual = x.contiguous(), y.contiguous(), dual.contiguous()
    part = torch.empty((2, geom.splits, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sinkhorn_lse_launch(x.data_ptr(), y.data_ptr(), dual.data_ptr(),
                                      _LOG2E / eps, p, n, m, x.shape[1], *geom_args,
                                      part[0].data_ptr(), part[1].data_ptr(),
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sinkhorn lse kernel launch failed: "
                           + lib.sinkhorn_error_string(err).decode())
    lse.launches += 1
    lse.mma_launches += int(geom.body == "mma")
    return out


lse.launches = lse.mma_launches = 0


def transport_cost(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   eps: float, p: int = 2) -> torch.Tensor:
    """Σ_ij exp((u_i + v_j − ‖x_i − y_j‖_p)/eps)·‖x_i − y_j‖_p as a 0-d
    tensor. The kernel writes per-row sums, summed here with ``torch.sum``
    as the JAX package sums its kernel's rows. On a CPU tensor this is
    ``transport_cost_plain``; on a CUDA tensor it launches the kernel
    (counted in ``transport_cost.launches``, and those of the tensor-core
    body also in ``transport_cost.mma_launches``) or raises."""
    n, m = x.shape[0], y.shape[0]
    _check(x, y, {"u": (u, n), "v": (v, m)}, p, "transport_cost")
    if x.device.type == "cpu":
        return transport_cost_plain(x, y, u, v, eps, p)
    lib, stream = _launch_prep(x, "transport_cost")
    rows = torch.zeros((n,), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return torch.sum(rows)
    geom, geom_args = _geometry_args(x, m, p)
    x, y, u, v = x.contiguous(), y.contiguous(), u.contiguous(), v.contiguous()
    part = torch.empty((geom.splits, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sinkhorn_cost_launch(x.data_ptr(), y.data_ptr(), u.data_ptr(),
                                       v.data_ptr(), _LOG2E / eps, p, n, m, x.shape[1],
                                       *geom_args, part.data_ptr(), rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sinkhorn transport-cost kernel launch failed: "
                           + lib.sinkhorn_error_string(err).decode())
    transport_cost.launches += 1
    transport_cost.mma_launches += int(geom.body == "mma")
    return torch.sum(rows)


transport_cost.launches = transport_cost.mma_launches = 0
