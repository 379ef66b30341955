"""The arithmetic of the Sinkhorn kernels' tensor-core body
(sde_sampler_lrds_torch/csrc/sinkhorn_lse.cu ``mma_kernel``: p = 2 past
d 16), emulated in numpy: the TF32 rounding of cvt.rna.tf32.f32, the
hi / lo split (hi on each k-step's grid: the 8 values of a row of x or a
column of y for a k-step rounded to a common step q = 2^(E − 10) below
their largest magnitude 2^E), and the x·y products as 3×TF32: hi·hi, 8
multiples of qx·qy below 2^23 of them, exact in a fresh accumulator each
k-step; lo·hi and hi·lo into an accumulator of their own each stage, each
MMA's sum truncated to float32 as the tensor cores do; both added to S
rounded to nearest. Beside it one TF32 product (hi·hi) and the
truncations the grid avoids. The lse from the emulated costs is held
against float64 and against the JAX package's Pallas kernel in interpret
mode, in the dual units ε·lse that phase 2 of chip_smoke.py gates on the
card, and the transport cost against the plain float32 version at its
COST_TOL_REL. Pure host arithmetic: no card needed."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.ops.sinkhorn_lse import pairwise_cost
from sde_sampler_lrds_tpu.ops.sinkhorn_lse import pallas_lse

SOURCE = Path(__file__).resolve().parents[1] / "sde_sampler_lrds_torch" / "csrc" / "sinkhorn_lse.cu"
# chip_smoke.py's gate on the lse kernels, in ε·lse units: LSE_TOL_ABS + LSE_TOL_REL ε|lse|
LSE_TOL_ABS, LSE_TOL_REL = 2e-4, 1e-5
COST_TOL_REL = 1e-3             # and on the transport cost, relative
K_STEP, CHUNK = 8, 32          # an MMA's depth, a stage's dimensions (MMA_CHUNK)


def tf32_rna(v):
    """cvt.rna.tf32.f32 on float32 values: to nearest with 10 mantissa bits,
    ties away from zero; a float32 whose low 13 mantissa bits are zero."""
    u = np.asarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    """v = hi + lo: hi = tf32(v), lo = tf32(v − hi) (v − hi exact in float32)."""
    v = np.asarray(v, dtype=np.float32)
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def grid_magic(m):
    """1.5·2^(E + 13) for the largest magnitude m < 2^E of a k-step's
    values (csrc/sinkhorn_lse.cu grid_magic): (v + M) − M rounds v to
    nearest on the step q = 2^(E − 10)."""
    b = np.asarray(m, dtype=np.float32).view(np.uint32)
    return (((b & np.uint32(0x7F800000)) + np.uint32(14 << 23))
            | np.uint32(0x00400000)).view(np.float32)


def split_grid(v):
    """Rows of 8 values (a row of x or a column of y for one k-step): hi on
    the row's grid, lo = tf32(v − hi)."""
    v = np.asarray(v, dtype=np.float32)
    magic = grid_magic(np.abs(v).max(axis=1))[:, None]
    hi = ((v + magic).astype(np.float32) - magic).astype(np.float32)
    return hi, tf32_rna((v - hi).astype(np.float32))


def round_toward_zero(v):
    """float64 to float32, truncated: an MMA's sum as the tensor cores round it."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def products(x, y, terms, mode="kernel"):
    """S = x·yᵀ as the kernel takes it, k-step by k-step (8 dimensions),
    each TF32 product exact in float64 and each MMA's sum truncated to
    float32. "kernel": hi on the k-step's grid; hi·hi in a fresh
    accumulator, exact, added to S rounded to nearest; lo·hi and hi·lo in
    an accumulator of their own added once a stage (32 dimensions).
    "fresh": hi = tf32(v), all three products (lo·hi, hi·lo, hi·hi) in a
    fresh accumulator a k-step; "into_s": the same truncated into S itself.
    terms: 3, or 1 (hi·hi alone, hi = tf32(v))."""
    pad = -x.shape[1] % K_STEP
    x = np.pad(x, ((0, 0), (0, pad)))
    y = np.pad(y, ((0, 0), (0, pad)))
    acc = np.zeros((x.shape[0], y.shape[0]), dtype=np.float32)
    small = np.zeros_like(acc)

    def dot(a, b):
        return a.astype(np.float64) @ b.T.astype(np.float64)

    for k in range(0, x.shape[1], K_STEP):
        xs, ys = x[:, k:k + K_STEP], y[:, k:k + K_STEP]
        if mode == "kernel" and terms == 3:
            (xh, xl), (yh, yl) = split_grid(xs), split_grid(ys)
            for a, b in ((xl, yh), (xh, yl)):
                small = round_toward_zero(small + dot(a, b))
            big = dot(xh, yh)
            assert np.array_equal(big.astype(np.float32), big), "hi·hi not exact"
            acc = (acc + big.astype(np.float32)).astype(np.float32)
            if (k + K_STEP) % CHUNK == 0 or k + K_STEP >= x.shape[1]:
                acc = (acc + small).astype(np.float32)
                small = np.zeros_like(acc)
            continue
        (xh, xl), (yh, yl) = split_tf32(xs), split_tf32(ys)
        pairs = [(xl, yh), (xh, yl), (xh, yh)] if terms == 3 else [(xh, yh)]
        part = acc if mode == "into_s" else np.zeros_like(acc)
        for a, b in pairs:
            part = round_toward_zero(part + dot(a, b))
        acc = part if mode == "into_s" else (acc + part).astype(np.float32)
    return acc


def fma_squares(v):
    """Σ_k v_k² in float32 FMAs, k in order (exact products, one rounding)."""
    s = np.zeros(v.shape[0], dtype=np.float32)
    for k in range(v.shape[1]):
        s = (s.astype(np.float64) + v[:, k].astype(np.float64) ** 2).astype(np.float32)
    return s


def kernel_costs(x, y, terms, mode="kernel"):
    """The body's pair costs: |x|² and |y|² summed in dimension order (the
    same for a row and a column), c = sqrt(max(|x|² + |y|² − 2 S, 0))."""
    xx, yy = fma_squares(x), fma_squares(y)
    s = products(x, y, terms, mode)
    sq = (-2.0 * s.astype(np.float64) + (xx[:, None] + yy[None, :]).astype(np.float32))
    return np.sqrt(np.maximum(sq.astype(np.float32), 0.0)).astype(np.float32)


def lse_from_costs(cost, dual, eps):
    z = (dual[None, :].astype(np.float64) - cost.astype(np.float64)) / eps
    mx = z.max(axis=1)
    return mx + np.log(np.exp(z - mx[:, None]).sum(axis=1))


def exact_costs(x, y):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    sq = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None, :] - 2.0 * x64 @ y64.T
    return np.sqrt(np.maximum(sq, 0.0))


def exact_lse(x, y, dual, eps):
    return lse_from_costs(exact_costs(x, y), dual, eps)


def points(seed, n, m, d, eps, offset=False):
    """Phase 2's draws past d 16: normal x, 0.5 + normal y, duals at the
    plan's scale with every ninth −inf. offset: both around one common
    point 2·N(0, I), as MNIST's draws share a large common part (|x|² ≈
    118 there), so every x·y is large and positive."""
    rng = np.random.default_rng(seed)
    if offset:
        base = 2.0 * rng.normal(size=d)
        x = (base + rng.normal(size=(n, d))).astype(np.float32)
        y = (base + rng.normal(size=(m, d))).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = (0.5 + rng.normal(size=(m, d))).astype(np.float32)
    dual = (eps * (-math.log(m) + 0.1 * rng.normal(size=m))).astype(np.float32)
    dual[::9] = -np.inf
    return x, y, dual


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    v = (rng.normal(size=4096) * np.exp2(rng.integers(-20, 20, size=4096))).astype(np.float32)
    hi = tf32_rna(v)
    assert not np.any(hi.view(np.uint32) & np.uint32(0x1FFF))
    # within half a TF32 ulp (2^-10 of the leading power of two) of v, and
    # no other TF32 value is nearer
    ulp = np.exp2(np.floor(np.log2(np.abs(v.astype(np.float64)))) - 10)
    err = np.abs(hi.astype(np.float64) - v)
    assert np.all(err <= ulp / 2)
    # ties (v exactly halfway between two TF32 values) go away from zero
    base = np.float32(1.0) + np.float32(2.0 ** -10)
    tie = np.array([base + np.float32(2.0 ** -11), -(base + np.float32(2.0 ** -11))],
                   dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(tie), [1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -9)])
    np.testing.assert_array_equal(tf32_rna(np.float32([0.0, -0.0, 1.0, -2.5])), [0, 0, 1, -2.5])


@pytest.mark.parametrize("d", [196, 784])
def test_split_keeps_float32_accuracy(d):
    """tf32 split: hi + lo within 2^-22 |v| of v. Grid split: hi a multiple
    of the k-step's step q, at most 2^10 of them, TF32-exact; hi + lo
    within 2^-12 q of v. The emulated body's dot product (which asserts
    every hi·hi sum exact) within a few float32 roundings of float64
    (relative to Σ|v_k w_k|), one TF32 product over 100× farther."""
    rng = np.random.default_rng(d)
    v = rng.normal(size=(64, d)).astype(np.float32)
    hi, lo = split_tf32(v)
    assert not np.any(lo.view(np.uint32) & np.uint32(0x1FFF))
    rel = np.abs(hi.astype(np.float64) + lo - v) / np.abs(v)
    assert rel.max() <= 2.0 ** -22
    rows = v.reshape(-1, K_STEP)
    hi, lo = split_grid(rows)
    top = np.abs(rows).max(axis=1)
    q = np.exp2(np.floor(np.log2(top)) + 1 - 10)[:, None]
    assert np.array_equal(hi / q, np.round(hi / q)) and np.abs(hi / q).max() <= 2 ** 10
    assert np.array_equal(tf32_rna(hi), hi) and not np.any(lo.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi.astype(np.float64) + lo - rows) <= q * 2.0 ** -12)
    w = (0.5 + rng.normal(size=(32, d))).astype(np.float32)
    exact = v.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(v).astype(np.float64) @ np.abs(w).astype(np.float64).T
    err3 = np.abs(products(v, w, 3) - exact) / scale
    err1 = np.abs(products(v, w, 1) - exact) / scale
    assert err3.max() < 5e-7 and err1.max() > 100 * err3.max()


@pytest.mark.parametrize("eps", [1e-2, 1e-3])
@pytest.mark.parametrize("d", [196, 784])
def test_three_products_hold_the_lse_gate_and_one_does_not(d, eps):
    """3×TF32 keeps ε·|Δlse| from float64 within LSE_TOL_ABS; one TF32
    product does not, which is why the body issues three."""
    x, y, dual = points(10 + d, 64, 256, d, eps)
    exact = exact_lse(x, y, dual, eps)
    err3 = eps * np.abs(lse_from_costs(kernel_costs(x, y, 3), dual, eps) - exact).max()
    err1 = eps * np.abs(lse_from_costs(kernel_costs(x, y, 1), dual, eps) - exact).max()
    assert err3 <= LSE_TOL_ABS / 10
    assert err1 > LSE_TOL_ABS


@pytest.mark.parametrize("d", [196, 784])
def test_three_products_match_jax_pallas(d):
    """The emulated body's lse against the JAX package's Pallas kernel in
    interpret mode on the same numpy inputs, at phase 2's gate."""
    eps = 1e-2
    x, y, dual = points(20 + d, 40, 256, d, eps)
    got = lse_from_costs(kernel_costs(x, y, 3), dual, eps)
    want = np.asarray(pallas_lse(x, y, dual, eps, p=2, bn=8, bm=128, interpret=True),
                      dtype=np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.all(eps * np.abs(got - want) <= LSE_TOL_ABS + LSE_TOL_REL * eps * np.abs(want))


@pytest.mark.parametrize("case", [(784, 1e-2, False), (196, 1e-3, True)])
def test_exact_high_products_keep_the_transport_cost(case):
    """B3 moves by ~C/ε relative for a shift C of every cost, and truncated
    MMA sums shift the costs one way: into S itself by ~1e-5 at d 784 (the
    card showed 1.12e-3 on B3 there against the plain version); on offset
    draws at ε 1e-3 even a fresh accumulator a k-step moves B3 past
    COST_TOL_REL (MNIST's d 196 on the card: 3.97e-3 with a fresh
    accumulator a stage). With hi·hi exact on the k-step's grid, B3 stays
    within COST_TOL_REL / 2 of the plain float32 version, as chip_smoke.py
    gates it."""
    d, eps, offset = case
    x, y, _ = points(30 + d, 256, 256, d, eps, offset)
    plain = pairwise_cost(torch.as_tensor(x), torch.as_tensor(y), 2).double().numpy()
    n, m = plain.shape
    v = np.full(m, -eps * math.log(m))
    u = eps * (-math.log(n) - lse_from_costs(plain, v, eps))
    v = eps * (-math.log(m) - lse_from_costs(plain.T, u, eps))

    def cost(c):
        c = c.astype(np.float64)
        return float((np.exp((u[:, None] + v[None, :] - c) / eps) * c).sum())

    want = cost(plain)
    errs = {mode: abs(cost(kernel_costs(x, y, 3, mode)) - want) / want
            for mode in ("kernel", "fresh", "into_s")}
    assert errs["kernel"] <= COST_TOL_REL / 2, errs
    assert errs["into_s"] > COST_TOL_REL, errs
    if offset:
        assert errs["fresh"] > COST_TOL_REL, errs


def test_source_uses_the_emulated_arithmetic():
    """The kernel rounds with the constants emulated here, issues TF32
    m16n8k8 products, sums lo·hi and hi·lo into the stage's own accumulator
    and hi·hi, on the k-step's grid, into a fresh one added to S."""
    src = SOURCE.read_text()
    assert "(__float_as_uint(v) + 0x1000u) & 0xffffe000u" in src
    assert "((__float_as_uint(m) & 0x7f800000u) + (14u << 23)) | 0x00400000u" in src
    assert "__fsub_rn(__fadd_rn(v, magic), magic)" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    body = src[src.index("mma_kernel(Args a)"):]
    assert re.findall(r"mma_tf32\(small\[mt\]\[j\], (\w+)\[mt\], (\w+)\)", body) == [
        ("al", "bh"), ("ah", "bl")]
    assert re.findall(r"mma_tf32\(big, (\w+)\[mt\], (\w+)\)", body) == [("ah", "bh")]
    stage, ksteps, fresh, add_big, add_small = (
        body.index("float small[2][NT][4] = {};"), body.index("for (int ks = 0; ks < BK / 8; ++ks)"),
        body.index("float big[4] = {};"), body.index("acc[mt][j][q] += big[q];"),
        body.index("acc[mt][j][q] += small[mt][j][q];"))
    assert stage < ksteps < fresh < add_big < add_small
    assert re.search(r"constexpr int MMA_CHUNK = (\d+);", src).group(1) == str(CHUNK)
