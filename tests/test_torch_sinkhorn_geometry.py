"""The Sinkhorn kernels' launch geometry and split merge, on the host
(sde_sampler_lrds_torch/ops/sinkhorn_lse.py ``sinkhorn_geometry``): every
column owned by exactly one split, every row by one row block, a grid that
covers the card at the eval path's 8192 × 8192, shared memory within the
card's limit and, past d 16, the same at every d (the wide bodies walk d
in chunks, so they take any width: at p 2 the tensor-core body, at other
p the stream body), the constants the CUDA source was built with; and the
kernels'
fixed-order merge of per-split partials (a second pass, no thread-block
cluster), mirrored in PyTorch from the plain versions and held against the
JAX package's Pallas kernels in interpret mode. Pure host arithmetic: no
card needed."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.ops import sinkhorn_lse as t_ops
from sde_sampler_lrds_tpu.ops.sinkhorn_lse import pallas_lse, pallas_transport_cost

SOURCE = Path(t_ops.__file__).resolve().parents[1] / "csrc" / "sinkhorn_lse.cu"
P_KINDS = (1, 2, 3)                    # p = 1, p = 2, a general integer p
SHAPES = ((8192, 8192), (1000, 3000), (37, 300), (1, 1))
SMS = 132
WIDEST = 2048                          # the mirror loop's widths: d 1 .. WIDEST
# the tensor-core body's shared memory at every d (csrc/sinkhorn_lse.cu
# smem_bytes): two stages of 128 rows of x and 64 columns of y at 40 floats
# a row, 64 (|y|², dual) pairs and 128 |x|²
MMA_SMEM = 4 * (2 * (128 + 64) * 40 + 2 * 64 + 128)


def _ranges(geom, m):
    return [range(k * geom.cols_per_split, min(m, (k + 1) * geom.cols_per_split))
            for k in range(geom.splits)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", P_KINDS)
def test_every_row_and_column_owned_once(p, shape):
    n, m = shape
    wide_smem = t_ops.smem_bytes(17, 1, t_ops._WIDE_TILE)
    for d in range(1, WIDEST + 1):
        geom = t_ops.sinkhorn_geometry(n, m, d, p, SMS)
        # the splits cover every column exactly once, none of them empty
        cols = np.concatenate([np.arange(r.start, r.stop) for r in _ranges(geom, m)])
        np.testing.assert_array_equal(cols, np.arange(m))
        assert all(len(r) > 0 for r in _ranges(geom, m))
        assert geom.cols_per_split % 8 == 0
        rows = geom.rows_per_block
        assert (geom.row_blocks - 1) * rows < n <= geom.row_blocks * rows
        assert geom.width >= d and geom.width % 4 == 0
        # p 2 past d 16 runs the tensor-core body (128 rows a block, 64-column
        # tiles, whole tiles a split, d in 32-dimension stages); p 1 past d 16
        # and p 3 at every d the stream body (256 rows, 32-column tiles, d in
        # 16-dimension stages); else the narrow one (512 rows, 128 columns)
        want = ("narrow" if d <= 16 and p != 3 else "mma" if p == 2 else "stream")
        assert geom.body == want == t_ops.body(d, p)
        assert (geom.rows_per_block, geom.tile_cols) == {
            "narrow": (512, 128), "mma": (128, 64), "stream": (256, 32)}[geom.body]
        if geom.body == "mma":
            assert geom.width % 32 == 0 and geom.cols_per_split % 64 == 0
        elif geom.body == "stream":
            assert geom.width % 16 == 0
        assert geom.smem_bytes == t_ops.smem_bytes(d, p, geom.tile_cols)
        assert geom.smem_bytes <= t_ops.MAX_SMEM_BYTES
        # past the chunk width shared memory no longer grows with d
        if geom.body != "narrow":
            assert geom.smem_bytes == (MMA_SMEM if geom.body == "mma" else wide_smem)
        if shape == (8192, 8192):
            assert geom.row_blocks * geom.splits >= SMS
    # the tensor-core body's geometry at the widths phase 2 and phase 7 time
    for d in (17, 196, 784, 2048):
        geom = t_ops.sinkhorn_geometry(n, m, d, p, SMS)
        assert geom.body == ("mma" if p == 2 else "stream")
        if geom.body == "mma":
            assert (geom.rows_per_block, geom.tile_cols, geom.smem_bytes) == (128, 64, MMA_SMEM)
            assert geom.row_blocks == -(-n // 128) and geom.blocks_per_sm == 2


def test_main_path_geometry():
    """The eval path's 8192 × 8192 × 8 fills one wave of 4 blocks an SM with
    long column ranges: 16 row blocks × 32 splits of 256 columns, 1 024
    pairs a thread (the first design: 256)."""
    geom = t_ops.sinkhorn_geometry(8192, 8192, 8, 2, SMS)
    assert (geom.body, geom.width, geom.rows_per_block, geom.row_blocks) == ("narrow", 8, 512, 16)
    assert (geom.cols_per_split, geom.splits, geom.blocks_per_sm) == (256, 32, 4)
    assert geom.row_blocks * geom.splits <= SMS * geom.blocks_per_sm
    assert geom.rows_per_block // geom.threads * geom.cols_per_split == 1024
    # the ragged shapes reach every SM too, at every width
    for d in (8, 37, 100, 224, 784, 2048):
        g = t_ops.sinkhorn_geometry(1000, 3000, d, 2, SMS)
        assert g.row_blocks * g.splits >= SMS - 4
    # MNIST's 2048 × 2048 past d 16 (the tensor-core body): one wave of 16
    # row blocks × 16 splits of two 64-column tiles, 2 blocks an SM on most SMs
    for d in (196, 784, 2048):
        g = t_ops.sinkhorn_geometry(2048, 2048, d, 2, SMS)
        assert (g.row_blocks, g.splits, g.cols_per_split, g.blocks_per_sm) == (16, 16, 128, 2)


def test_geometry_refuses_what_the_kernels_do_not_take():
    for args in ((0, 5, 8, 2), (5, 0, 8, 2), (5, 5, 0, 2), (5, 5, 8, 0)):
        with pytest.raises(ValueError):
            t_ops.sinkhorn_geometry(*args, SMS)
    # no width limit: past the first design's d 224 the wide bodies take
    # the reduction on the same shared memory as at d 17 (at p 2 the
    # tensor-core body, whose splits are whole 64-column tiles)
    for d in (225, 4096):
        geom = t_ops.sinkhorn_geometry(5, 5, d, 2, SMS)
        assert geom.body == "mma" and geom.width == -(-d // 32) * 32
        assert (geom.row_blocks, geom.splits, geom.cols_per_split) == (1, 1, 64)
        assert geom.smem_bytes == t_ops.smem_bytes(17, 2, geom.tile_cols) <= t_ops.MAX_SMEM_BYTES
        geom = t_ops.sinkhorn_geometry(5, 5, d, 1, SMS)
        assert geom.body == "stream" and geom.width == -(-d // 16) * 16
        assert (geom.row_blocks, geom.splits, geom.cols_per_split) == (1, 1, 8)
        assert geom.smem_bytes == t_ops.smem_bytes(17, 1, geom.tile_cols) <= t_ops.MAX_SMEM_BYTES


def test_geometry_constants_match_source():
    """The host's mirror uses the constants the kernels were built with."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("THREADS") == t_ops._THREADS
    assert const("RR") == t_ops._ROWS_PER_THREAD
    assert const("TILE") == t_ops._TILE
    assert const("WIDE_ROWS") == t_ops._WIDE_ROWS
    assert const("WIDE_TILE") == t_ops._WIDE_TILE
    assert const("WIDE_CHUNK") == t_ops._WIDE_CHUNK
    assert const("MMA_ROWS") == t_ops._MMA_ROWS == 128
    assert const("MMA_TILE") == t_ops._MMA_TILE == 64
    assert const("MMA_CHUNK") == t_ops._MMA_CHUNK == 32
    assert const("MMA_STRIDE") == t_ops._MMA_STRIDE == 40
    assert const("COL_ALIGN") == t_ops._COL_ALIGN
    assert const("MAX_SMEM") == t_ops.MAX_SMEM_BYTES
    # resident blocks the launch bounds ask for: the tensor-core body 2 (its
    # stage accumulators beside S), the stream body 2 (its compensated
    # sums), the narrow one 4
    assert const("MMA_BLOCKS") == t_ops._MMA_BLOCKS == 2
    assert const("SUM_BLOCKS") == t_ops._SUM_BLOCKS == 2
    assert const("NARROW_BLOCKS") == t_ops._NARROW_BLOCKS == 4
    assert "__launch_bounds__(THREADS, MMA_BLOCKS)\nmma_kernel(Args a)" in src
    assert "__launch_bounds__(THREADS, SUM_BLOCKS)\nstream_kernel(Args a)" in src
    # one table of the bodies on each side, in the source's Body order
    assert "constexpr int BODY_ROWS[] = {RR * THREADS, MMA_ROWS, WIDE_ROWS * THREADS};" in src
    assert "constexpr int BODY_TILE[] = {TILE, MMA_TILE, WIDE_TILE};" in src
    assert "enum Body { NARROW = 0, MMA = 1, STREAM = 2 };" in src
    assert [(k, b.rows, b.tile) for k, b in t_ops._BODIES.items()] == [
        ("narrow", 4 * 128, 128), ("mma", 128, 64), ("stream", 2 * 128, 32)]
    # 4 warps of 32 rows, 2 m-tiles of 16 a warp
    assert t_ops._MMA_ROWS == 4 * 32 == t_ops._THREADS
    for d, p, want in ((8, 2, 4), (8, 1, 4), (8, 3, 2), (37, 2, 2), (37, 1, 2), (224, 2, 2),
                       (2048, 2, 2), (2048, 1, 2), (17, 2, 2), (196, 2, 2), (784, 2, 2),
                       (784, 3, 2)):
        assert t_ops.sinkhorn_geometry(64, 64, d, p, SMS).blocks_per_sm == want
    # shared memory: the tensor-core body's at every d past 16 at p 2, and a
    # resident-block count the SM's shared memory allows
    for d in (17, 196, 784, 2048):
        assert t_ops.smem_bytes(d, 2, t_ops._MMA_TILE) == MMA_SMEM == 62_464
    assert 2 * (MMA_SMEM + 1024) <= t_ops._SM_SMEM_BYTES


# ---------------------------------------------------------------------------
# the fixed-order merge of per-split partials, mirrored from the plain versions
# ---------------------------------------------------------------------------

def merged_lse(x, y, dual, eps, p, geom):
    """The kernel's lse: a base-2 (max, sum) partial per (row, split) from
    lse_plain on the split's columns, merged over the splits in split order
    as merge_kernel does, in float32: M = max_k m_k, S = Σ_k s_k·2^(m_k − M),
    out = (M + log2 S)·ln 2, −inf where every split is −inf."""
    log2e = 1.0 / math.log(2.0)
    parts = []
    for r in _ranges(geom, y.shape[0]):
        c = slice(r.start, r.stop)
        m_k = t_ops.lse_plain(x, y[c], dual[c], eps, p) * log2e
        parts.append((m_k, torch.where(torch.isneginf(m_k), 0.0, 1.0)))
    mx = torch.stack([m_k for m_k, _ in parts]).max(dim=0).values
    shift = torch.where(torch.isneginf(mx), 0.0, mx)
    s = torch.zeros_like(mx)
    for m_k, s_k in parts:
        s = s + s_k * torch.exp2(m_k - shift)
    return torch.where(torch.isneginf(mx), mx, (mx + torch.log2(s)) * math.log(2.0))


def merged_cost(x, y, u, v, eps, p, geom):
    """The kernel's transport cost: a partial sum per (row, split) from
    transport_cost_plain on the row and the split's columns, summed over the
    splits in split order, then over the rows with torch.sum."""
    rows = torch.zeros(x.shape[0])
    for r in _ranges(geom, y.shape[0]):
        c = slice(r.start, r.stop)
        rows = rows + torch.stack([t_ops.transport_cost_plain(x[i:i + 1], y[c], u[i:i + 1],
                                                              v[c], eps, p)
                                   for i in range(x.shape[0])])
    return torch.sum(rows)


def _points(seed, n, m, d):
    rng = np.random.default_rng(seed)
    return (rng, rng.normal(size=(n, d)).astype(np.float32),
            (0.5 + 1.3 * rng.normal(size=(m, d))).astype(np.float32))


# (n, m, d, n_sms, eps): a width of each kernel kind, split counts from 1
# up, and a width past the first design's limit of d 224, with eps at its
# costs' scale (≈ 350 at p 1: at eps 0.1 the float32 rounding of the costs,
# summed in two orders, moves the plan's entries by ≈ 1e-4)
MERGE_CASES = ((37, 300, 3, 132, 0.1), (130, 129, 8, 8, 0.1), (20, 256, 21, 4, 0.1),
               (9, 40, 100, 1, 0.1), (6, 24, 300, 2, 1.0))


@pytest.mark.parametrize("p", P_KINDS)
@pytest.mark.parametrize("case", MERGE_CASES)
def test_split_merge_matches_jax(case, p):
    n, m, d, n_sms, eps = case
    geom = t_ops.sinkhorn_geometry(n, m, d, p, n_sms)
    rng, x, y = _points(100 + d + p, n, m, d)
    dual = (eps * rng.normal(size=(m,))).astype(np.float32)
    dual[::7] = -np.inf
    if geom.splits > 1:                          # one whole split of −inf duals
        dual[geom.cols_per_split:2 * geom.cols_per_split] = -np.inf
    got = merged_lse(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(dual), eps, p,
                     geom).numpy()
    want = np.asarray(pallas_lse(x, y, dual, eps, p=p, bn=8, bm=128, interpret=True))
    assert np.isfinite(got).all()
    # logits ~ 50 at eps = 0.1 (d 8): float32 cost sums in other orders differ by a
    # few ulps of the cost (1e-6 relative), i.e. ~1e-5 in the logits; the
    # base-2 round trip adds a few ulps of the result
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    # u, v from the first Sinkhorn half-steps, so the plan's entries are
    # normal float32 numbers at every width
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    v0 = torch.full((m,), -eps * math.log(m))
    u = (eps * (-math.log(n) - t_ops.lse_plain(tx, ty, v0, eps, p))).numpy()
    v = (eps * (-math.log(m) - t_ops.lse_plain(ty, tx, torch.as_tensor(u), eps, p))).numpy()
    u[1 % n] = -np.inf
    v[::11] = -np.inf
    if geom.splits > 1:
        v[:geom.cols_per_split] = -np.inf
    got_c = float(merged_cost(*(torch.as_tensor(a) for a in (x, y, u, v)), eps, p, geom))
    want_c = float(pallas_transport_cost(x, y, u, v, eps, p=p, bn=8, bm=128, interpret=True))
    assert np.isfinite(got_c)
    # a sum of n·m float32 terms in two orders
    np.testing.assert_allclose(got_c, want_c, rtol=2e-5)


def test_split_merge_all_minus_inf():
    """Rows whose every split is −inf give −inf, never NaN; a row block
    whose splits are all −inf but one gives that split's lse."""
    rng, x, y = _points(3, 20, 256, 4)
    geom = t_ops.sinkhorn_geometry(20, 256, 4, 2, 4)
    assert geom.splits > 2
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    all_inf = merged_lse(tx, ty, torch.full((256,), -math.inf), 0.5, 2, geom)
    assert torch.all(torch.isneginf(all_inf))
    dual = torch.full((256,), -math.inf)
    last = _ranges(geom, 256)[-1]
    dual[last.start:last.stop] = torch.as_tensor(rng.normal(size=(len(last),)),
                                                 dtype=torch.float32)
    got = merged_lse(tx, ty, dual, 0.5, 2, geom).numpy()
    want = np.asarray(pallas_lse(x, y, dual.numpy(), 0.5, p=2, bn=8, bm=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
