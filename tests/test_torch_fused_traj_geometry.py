"""The diagonal fused_traj kernel's launch geometry, on the host
(sde_sampler_lrds_torch/ops/fused_traj.py ``diag_geometry``): every
trajectory owned by exactly one (block, warp, slot), a grid that covers the
card, shared memory within the card's limit, and ``check_geometry``
refusing what the C side (``diag_geometry_ok`` in csrc/fused_traj.cu)
refuses. The deep tile (8 trajectories a warp) engages only where 4 a warp
overfill one wave of the card, and every smaller batch keeps the geometry
of the kernel without it. Pure host arithmetic: no card needed."""
import re
from pathlib import Path

import numpy as np
import pytest

from sde_sampler_lrds_torch.ops import fused_traj as ft

H, NH = 64, 2
LARGEST = ft.MAX_DIAG_DIM
BATCHES = (1, 31, 33, 1000, 1024, 8192, 100_000)
SMS = (132, 114)


def _cfg(dim, channels=H, n_hidden=NH):
    return ft.FusedTrajCfg(k_steps=100, dim=dim, channels=channels, n_hidden=n_hidden,
                           n_comp=4, clip=1e4)


def _admitted(dim, channels=H, n_hidden=NH):
    try:
        ft.check_limits(_cfg(dim, channels, n_hidden))
        return True
    except ValueError:
        return False


# the largest D check_limits admits at H = 64 with 2 hidden layers (shared
# memory binds there before the lanes' registers)
LARGEST_H64 = max(d for d in range(1, LARGEST + 1) if _admitted(d))
DIMS = (1, 8, 37, 100, 256, LARGEST_H64)


def _owners(geom, batch):
    """Trajectory index of every (block, warp, slot) the launch runs, in
    launch order, with the ones past the batch dropped."""
    idx = np.arange(geom.blocks * geom.warps_per_block * geom.traj_per_warp)
    return idx[idx < batch]


@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("batch", BATCHES)
def test_every_trajectory_owned_once(batch, dim, n_sms):
    geom = ft.diag_geometry(batch, dim, H, NH, n_sms)
    ft.check_geometry(_cfg(dim), batch, geom)
    assert geom.traj_per_warp in (1, 2, 4, 8)
    assert 1 <= geom.warps_per_block <= 8
    # warp w of block b owns (b·warps + w)·tw + slot: the decomposition of
    # each owner index is unique, and the owners are exactly 0..B-1
    owners = _owners(geom, batch)
    np.testing.assert_array_equal(owners, np.arange(batch))
    per_block = geom.warps_per_block * geom.traj_per_warp
    assert (geom.blocks - 1) * per_block < batch <= geom.blocks * per_block
    # a lane holds at most 8 dimensions of its trajectory, or at one
    # trajectory a warp 16 past D = 256; on the deep tile 2
    lanes = 32 // geom.traj_per_warp
    assert dim <= 8 * lanes or (geom.traj_per_warp == 1 and dim <= 16 * lanes)
    assert geom.traj_per_warp < 8 or dim <= 2 * lanes
    assert ft.smem_bytes(dim, H, NH, False, geom.warps_per_block,
                         geom.traj_per_warp) <= ft.MAX_SMEM_BYTES


@pytest.mark.parametrize("n_sms", SMS)
def test_train_batch_fills_the_card(n_sms):
    """At the training batch the grid covers (nearly) every SM; the
    eval batch packs 4 trajectories a warp into about one wave."""
    geom = ft.diag_geometry(1024, 8, H, NH, n_sms)
    assert (geom.traj_per_warp, geom.warps_per_block) == (1, 8)
    assert min(geom.blocks, n_sms) >= min(120, n_sms)
    if n_sms == 132:
        assert geom.blocks == 128
    geom = ft.diag_geometry(8192, 8, H, NH, n_sms)
    # on 114 SMs 4 a warp overfill one wave (7296 < 8192): the deep tile
    assert geom.traj_per_warp == (4 if n_sms == 132 else 8) and geom.blocks >= n_sms


def test_every_trajectories_per_warp_is_picked():
    picked = {ft.diag_geometry(b, 8, H, NH, 132).traj_per_warp for b in (1024, 4001, 8193)}
    assert picked == {1, 2, 4}
    # wide states keep to fewer trajectories a warp
    assert ft.diag_geometry(100_000, 100, H, NH, 132).traj_per_warp == 2
    assert ft.diag_geometry(100_000, 256, H, NH, 132).traj_per_warp == 1
    assert ft.diag_geometry(100_000, LARGEST_H64, H, NH, 132).traj_per_warp == 1


@pytest.mark.parametrize("channels, n_hidden", [(64, 2), (128, 2), (128, 1), (32, 4)])
def test_smem_limit_is_the_largest_admitted_dim(channels, n_hidden):
    """check_limits admits D while one warp of one trajectory fits the
    block's shared memory and D ≤ MAX_DIAG_DIM; one past, it raises."""
    largest = max(d for d in range(1, 2 * LARGEST) if _admitted(d, channels, n_hidden))
    assert not _admitted(largest + 1, channels, n_hidden)
    assert ft.smem_bytes(largest, channels, n_hidden, False) <= ft.MAX_SMEM_BYTES
    if largest < LARGEST:   # shared memory binds before the lanes' registers
        assert ft.smem_bytes(largest + 1, channels, n_hidden, False) > ft.MAX_SMEM_BYTES
    else:
        assert largest == LARGEST
    geom = ft.diag_geometry(8192, largest, channels, n_hidden, 132)
    ft.check_geometry(_cfg(largest, channels, n_hidden), 8192, geom)


def test_smem_formula():
    """The weight matrices transposed in rows padded to 16 bytes and 4 floats
    more (W0ᵀ: H rows of D, each Whᵀ: H rows of H, W_outᵀ: D rows of H), the
    biases padded to 16 bytes, and per warp and trajectory two hidden rows
    (padded so) and an input row (padded to 16 bytes)."""
    row = lambda n: (n + 3) // 4 * 4 + 4
    weights = 64 * row(8) + 64 + 2 * 64 * row(64) + 128 + 8 * row(64) + 8
    assert weights == 768 + 64 + 8704 + 128 + 544 + 8
    assert ft.smem_bytes(8, 64, 2, False) == 4 * (weights + 2 * 68 + 8)
    assert ft.smem_bytes(8, 64, 2, False, 8, 4) == 4 * (weights + 32 * (2 * 68 + 8))
    assert ft.smem_bytes(37, 64, 2, False, 2, 1) == 4 * (
        64 * 44 + 64 + 2 * 64 * 68 + 128 + 37 * 68 + 40 + 2 * (2 * 68 + 40))


@pytest.mark.parametrize("geom, why", [
    (ft.DiagGeometry(3, 8, 43), "trajectories a warp"),
    (ft.DiagGeometry(1, 0, 1), "warps a block"),
    (ft.DiagGeometry(1, 16, 64), "warps a block"),
    (ft.DiagGeometry(1, 8, 127), "blocks"),
    (ft.DiagGeometry(1, 8, 129), "blocks"),
    (ft.DiagGeometry(4, 8, 32), "dimensions a lane"),
])
def test_check_geometry_refuses(geom, why):
    dim = 200 if why == "dimensions a lane" else 8
    with pytest.raises(ValueError, match=why):
        ft.check_geometry(_cfg(dim), 1024, geom)


def test_check_geometry_refuses_too_much_shared_memory():
    cfg = _cfg(150, 128, 1)
    geom = ft.DiagGeometry(1, 8, 128)
    assert ft.smem_bytes(150, 128, 1, False, 8, 1) > ft.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        ft.check_geometry(cfg, 1024, geom)
    picked = ft.diag_geometry(1024, 150, 128, 1, 132)
    assert picked.warps_per_block < 8
    ft.check_geometry(cfg, 1024, picked)


def _first_design_smem_bytes(d, h, nh):
    """Shared memory of the diagonal mode's first design (a block of 32
    trajectories): the weights, 2·32·H hidden, 4·32·D state, control, noise
    and score, 3·32 softmax factors, each region padded to 16 bytes."""
    r4 = lambda n: (n + 3) // 4 * 4
    return 4 * (r4(d * h) + r4(h) + r4(nh * h * h) + r4(nh * h) + r4(h * d) + r4(d)
                + 2 * 32 * h + 4 * r4(32 * d) + 3 * 32)


@pytest.mark.parametrize("channels", [1, 3, 16, 64, 100, 256])
def test_check_limits_still_takes_every_old_diagonal_dim(channels):
    """Every (D, H, n_hidden) the first design's shared memory admitted
    (D ≤ 177 at H 64 with 2 hidden layers, up to 442 at H 1) is still
    taken, and gets a geometry."""
    for n_hidden in (0, 1, 2, 8):
        old = [d for d in range(1, 460)
               if _first_design_smem_bytes(d, channels, n_hidden) <= ft.MAX_SMEM_BYTES]
        for d in old:
            assert _admitted(d, channels, n_hidden), (d, channels, n_hidden)
        if old:
            ft.diag_geometry(8192, old[-1], channels, n_hidden, 132)


def _parent_geometry(batch, dim, channels, n_hidden, n_sms):
    """diag_geometry as it was before the deep tile: 1, 2 or 4 trajectories
    a warp."""
    allowed = ([tw for tw in (1, 2, 4) if dim <= 8 * (32 // tw)]
               or ([1] if dim <= ft.MAX_DIAG_DIM else []))
    tw = next((t for t in allowed if -(-batch // t) <= n_sms * 16), allowed[-1])
    warps = min(8, 1 << (-(-(-(-batch // tw)) // n_sms) - 1).bit_length())
    while ft.smem_bytes(dim, channels, n_hidden, False, warps, tw) > ft.MAX_SMEM_BYTES:
        if warps > 1:
            warps //= 2
        else:
            tw //= 2
    return ft.DiagGeometry(tw, warps, -(-batch // (warps * tw)))


@pytest.mark.parametrize("batch", [131_072, 8449, 100_000, 16_384])
def test_deep_tile_past_one_wave_at_d8(batch):
    """Past 4 × 132 × 16 = 8448 trajectories at D 8, 4 a warp overfill one
    wave of the H100's 132 SMs: the deep tile takes them, 8 warps a block."""
    geom = ft.diag_geometry(batch, 8, H, NH, 132)
    assert geom == ft.DiagGeometry(8, 8, -(-batch // 64))
    ft.check_geometry(_cfg(8), batch, geom)
    assert ft.diag_geometry(131_072, 8, H, NH, 132).blocks == 2048


@pytest.mark.parametrize("batch, dim, want", [
    (256, 8, (1, 2, 128)), (1024, 8, (1, 8, 128)), (8192, 8, (4, 8, 256)),
    (8448, 8, (4, 8, 264)), (100_000, 100, (2, 8, 6250)), (100_000, 196, (1, 8, 12500))])
def test_geometry_unchanged_up_to_one_wave(batch, dim, want):
    """The training batches, the evals of 8192, the largest batch 4 a warp
    hold in one wave, and the widths past the deep tile's keep their
    geometry."""
    geom = ft.diag_geometry(batch, dim, H, NH, 132)
    assert (geom.traj_per_warp, geom.warps_per_block, geom.blocks) == want
    assert geom == _parent_geometry(batch, dim, H, NH, 132)


@pytest.mark.parametrize("dim", [1, 2, 5, 8, 9, 16, 37, 100, 196])
@pytest.mark.parametrize("n_sms", SMS)
def test_geometry_of_the_parent_where_4_a_warp_fit(dim, n_sms):
    """Wherever 4 trajectories a warp fit one wave, or the deep tile does
    not take the plan, the geometry is the one before it."""
    for batch in (1, 33, 255, 1024, 4001, 8192, 4 * n_sms * 16, 50_000, 131_072):
        geom = ft.diag_geometry(batch, dim, H, NH, n_sms)
        if dim > 8 or batch <= 4 * n_sms * 16:
            assert geom == _parent_geometry(batch, dim, H, NH, n_sms), batch
        else:
            assert geom.traj_per_warp == 8, batch


@pytest.mark.parametrize("channels, n_hidden, bf16, deep", [
    (64, 2, False, True), (64, 0, False, True), (64, 4, False, True),
    (64, 2, True, False),        # the bf16 control keeps to 4 a warp
    (32, 2, False, False), (96, 2, False, False), (100, 2, False, False),
    # the 8-warp block leaves no room for two an SM
    (64, 5, False, False), (128, 1, False, False), (128, 2, False, False),
])
def test_deep_tile_only_where_it_holds_the_plan(channels, n_hidden, bf16, deep):
    geom = ft.diag_geometry(131_072, 8, channels, n_hidden, 132, bf16)
    assert (geom.traj_per_warp == 8) == deep
    assert ft.deep_fits(8, channels, n_hidden, bf16) == deep
    if deep:
        # two blocks of 8 warps an SM, each with its reserved kilobyte
        assert 2 * (ft.smem_bytes(8, channels, n_hidden, False, 8, 8) + 1024) <= 233_472
    else:
        assert geom.traj_per_warp == 4


def test_deep_tile_shared_memory():
    """The deep tile's block at D 8, H 64, 2 hidden layers: the weights as
    before and 8 warps of 8 trajectories' rows, 77 728 bytes, two a block
    in the SM's 228 KB."""
    row = lambda n: (n + 3) // 4 * 4 + 4
    weights = 64 * row(8) + 64 + 2 * 64 * row(64) + 128 + 8 * row(64) + 8
    assert ft.smem_bytes(8, 64, 2, False, 8, 8) == 4 * (weights + 64 * (2 * 68 + 8)) == 77_728
    assert 2 * (77_728 + 1024) <= 233_472


def _c_constants():
    """The deep tile's constants in csrc/fused_traj.cu."""
    src = (Path(ft.__file__).parent.parent / "csrc" / "fused_traj.cu").read_text()
    got = dict(re.findall(r"constexpr int (DEEP_\w+|DIAG_\w+) = ([^;]+);", src))
    tw, elems, units = int(got["DEEP_TW"]), int(got["DEEP_ELEMS"]), int(got["DEEP_UNITS"])
    assert got["DEEP_MAX_D"] == "DEEP_ELEMS * 32 / DEEP_TW"
    return dict(tw=tw, max_d=elems * 32 // tw, units=units, warps=int(got["DIAG_MAX_WARPS"]),
                elems=int(got["DIAG_ELEMS"]), diag_units=int(got["DIAG_UNITS"]))


def _c_side_ok(batch, dim, channels, tw, warps, blocks, bf16):
    """diag_geometry_ok of csrc/fused_traj.cu, transcribed."""
    c = _c_constants()
    deep = tw == c["tw"] and not bf16 and dim <= c["max_d"] and channels % c["units"] == 0
    if tw not in (1, 2, 4) and not deep:
        return False
    if not 1 <= warps <= c["warps"] or batch < 1 or dim < 1 or channels < 1:
        return False
    if dim > c["elems"] * (32 // tw) or channels > 32 * c["diag_units"]:
        return False
    return blocks == -(-batch // (warps * tw))


def test_c_constants_match_the_host():
    c = _c_constants()
    assert (c["tw"], c["max_d"], c["units"]) == (ft._DEEP_TW, ft._DEEP_MAX_DIM, ft._DEEP_UNITS)
    assert (c["warps"], c["elems"]) == (ft._DIAG_MAX_WARPS, ft._DIAG_ELEMS)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("channels", [32, 64, 96, 128])
@pytest.mark.parametrize("dim", [1, 4, 5, 8, 9, 16, 65])
def test_check_geometry_takes_what_the_c_side_takes(dim, channels, bf16):
    """check_geometry accepts and refuses, at every trajectories-a-warp up
    to 8 and 1 to 8 warps, what diag_geometry_ok does (where the block's
    shared memory fits, which the C side does not check)."""
    cfg = ft.FusedTrajCfg(k_steps=100, dim=dim, channels=channels, n_hidden=NH, n_comp=4,
                          clip=1e4, bf16=bf16)
    for tw in (1, 2, 3, 4, 8, 16):
        for warps in (1, 4, 8):
            for batch, extra in ((131_072, 0), (1000, 0), (1000, 1)):
                geom = ft.DiagGeometry(tw, warps, -(-batch // (warps * tw)) + extra)
                want = _c_side_ok(batch, dim, channels, tw, warps, geom.blocks, bf16)
                try:
                    ft.check_geometry(cfg, batch, geom)
                    took = True
                except ValueError as err:
                    took = False
                    assert "shared memory" not in str(err) or want
                    if "shared memory" in str(err):
                        continue
                assert took == want, (geom, batch)


@pytest.mark.parametrize("cfg_kw, why", [
    (dict(dim=9), "deep tile"), (dict(dim=8, channels=96), "deep tile"),
    (dict(dim=8, bf16=True), "deep tile")])
def test_check_geometry_refuses_the_deep_tile_beyond_its_shape(cfg_kw, why):
    cfg = ft.FusedTrajCfg(**{**dict(k_steps=100, dim=8, channels=H, n_hidden=NH, n_comp=4,
                                    clip=1e4), **cfg_kw})
    with pytest.raises(ValueError, match=why):
        ft.check_geometry(cfg, 131_072, ft.DiagGeometry(8, 8, 2048))
