"""Host arithmetic of B1's cluster kernel (``traj_kernel_cluster`` in
sde_sampler_lrds_torch/csrc/fused_traj.cu): which plans it takes, the
geometry the host picks for it and the host's mirror of its shared memory.
The kernel itself runs only on the card (chip_smoke.py phase 15 (f) holds it
against its plain version, ``fused_traj_plain``, and the mirror against the
kernel's own arithmetic); its plain version is the one every fused_traj
test already holds against the JAX package. No JAX here: plain arithmetic,
a few milliseconds.
"""
import pytest

from sde_sampler_lrds_torch.ops import fused_traj as ft

N_SMS = 132
# the clusters of each size an NVIDIA H100 80GB HBM3 held at once with a
# plan's largest tile (cudaOccupancyMaxActiveClusters on the card, D 129 to 365)
H100_ACTIVE = {2: 66, 4: 30, 8: 15}


def plan(dim, full, channels=64, n_hidden=2, n_comp=2, bf16=False):
    return ft.FusedTrajCfg(k_steps=100, dim=dim, channels=channels, n_hidden=n_hidden,
                           n_comp=n_comp, clip=1e4, full_cov=full, bf16=bf16)


CLUSTER_PLANS = {"d129_full": plan(129, True), "d196_full": plan(196, True),
                 "d365_diag": plan(365, False)}


@pytest.mark.parametrize("name", sorted(CLUSTER_PLANS))
@pytest.mark.parametrize("batch", [1, 33, 256, 1000, 1024, 2048, 4001, 8192])
def test_cluster_geometry_covers_the_batch(batch, name):
    """A portable cluster of 1–8 CTAs, tiles of a multiple of 4 up to 64
    trajectories, no more clusters than tiles nor than the card holds at
    once, every trajectory in one tile, the tiles spread over the clusters
    with at most one more a cluster than another, and each CTA within the
    card's shared memory."""
    cfg = CLUSTER_PLANS[name]
    geom = ft.cluster_geometry(batch, cfg, N_SMS, H100_ACTIVE)
    cl, tb, clusters = geom.cluster_size, geom.rows, geom.clusters
    tiles = -(-batch // tb)
    held = H100_ACTIVE[cl]
    assert cl in (1, 2, 4, 8) and tb % 4 == 0 and 4 <= tb <= 64
    assert 1 <= clusters <= min(tiles, held)
    assert (tiles - 1) * tb < batch <= tiles * tb
    assert ft.cluster_smem_bytes(cfg.dim, cfg.channels, cfg.n_hidden, cfg.n_comp, cfg.full_cov,
                                 cl, tb) <= ft.MAX_SMEM_BYTES
    # the batch over the fewest waves of the co-resident clusters
    tb_max = ft._cluster_rows_max(cfg, cl)
    assert tiles <= clusters * -(-batch // (tb_max * held))


def test_cluster_fills_the_card_at_the_train_batch():
    """MNIST's train batch, 256 trajectories at D 196 with a full
    covariance, keeps at least 96 of the 132 SMs busy in one wave."""
    geom = ft.cluster_geometry(256, CLUSTER_PLANS["d196_full"], N_SMS, H100_ACTIVE)
    assert geom.cluster_size == 8 and geom.clusters * geom.cluster_size >= 96
    assert geom.clusters * geom.rows >= 256


@pytest.mark.parametrize("name, batch, want", [
    ("d196_full", 256, (8, 20, 13)), ("d196_full", 2048, (8, 28, 15)),
    ("d129_full", 1024, (4, 36, 29)), ("d365_diag", 1024, (4, 36, 29))])
def test_cluster_geometry_at_the_paths_batches(name, batch, want):
    """The launches chip_smoke.py printed on the H100 (cluster size, tile,
    clusters): MNIST's train and eval batches at D 196, the C6 path's
    train batch at D 129 and phase 15 (f)'s at D 365."""
    geom = ft.cluster_geometry(batch, CLUSTER_PLANS[name], N_SMS, H100_ACTIVE)
    assert (geom.cluster_size, geom.rows, geom.clusters) == want


@pytest.mark.parametrize("case", [
    # (D, H, n_h, C, full, cl, tb)
    (196, 64, 2, 2, True, 8, 16),
    (365, 64, 2, 2, False, 4, 36),
])
def test_cluster_smem_mirror_is_the_note_formula(case):
    """The host's mirror equals the note's formula in csrc/fused_traj.cu,
    term by term: the table slices, two buffers of a step's rows, the full
    rows the products read, the tile's slices, the partial sums, the
    exchanged sums and the softmax factors; the full rows in strides of an
    odd number of quads."""
    d, h, nh, c, full, cl, tb = case
    dp, hp = -(-d // 4) * 4, -(-h // 4) * 4
    ldd = 4 * -(-(-(-d // 4)) // cl)
    ldh = 4 * -(-(-(-h // 4)) // cl)
    tables = (2 * c * dp * ldd if full else 0) + dp * ldh + nh * hp * ldh + hp * ldd \
        + ldh + nh * ldh + ldd
    step_rows = 2 * (c * dp + c * ldd + -(-c // 4) * 4 + ldh + 8)
    sd, sh = (w if (w // 4) % 2 else w + 4 for w in (dp, hp))
    full_rows = tb * sd + (c * tb * sd if full else 0) + 2 * tb * sh
    slices = c * tb * ldd + 2 * tb * ldd
    part = max(16 * 256, max(c, 2) * tb * ldd // 4)
    floats = tables + step_rows + full_rows + slices + part + (c + 2) * cl * tb + (2 * c + 1) * tb
    assert ft.cluster_smem_bytes(d, h, nh, c, full, cl, tb) == 4 * floats
    # the two cases worked by hand: D 196 full in clusters of 8, D 365
    # diagonal in clusters of 4
    assert 4 * floats == {196: 181_552, 365: 208_992}[d]


@pytest.mark.parametrize("cfg", [plan(129, True), plan(196, True), plan(365, False),
                                 plan(365, False, bf16=True), plan(196, True, bf16=True)],
                         ids=["d129_full", "d196_full", "d365_diag", "d365_diag_bf16",
                              "d196_full_bf16"])
def test_cluster_takes_the_plans_its_tables_fit(cfg):
    """Past the narrow kernels' limits, a plan whose tables a cluster of at
    most 8 CTAs holds runs on the cluster kernel."""
    assert ft.limit_error(cfg) is not None and ft.uses_wide(cfg)
    assert ft.uses_cluster(cfg)


@pytest.mark.parametrize("cfg", [plan(8, False, channels=320, n_hidden=9),
                                 plan(400, True)], ids=["h320_9_layers", "d400_full"])
def test_wide_keeps_the_plans_no_cluster_holds(cfg):
    """The 320-wide 9-layer control (an MLP of 3.7 MB) and a full D 400
    (2.6 MB of rotations) stay on the wide kernel, which takes them, and
    cluster_geometry refuses them."""
    assert ft.uses_wide(cfg) and not ft.uses_cluster(cfg)
    assert ft.wide_limit_error(cfg) is None
    with pytest.raises(ValueError, match="no cluster"):
        ft.cluster_geometry(256, cfg, N_SMS, H100_ACTIVE)


@pytest.mark.parametrize("cfg", [plan(8, False), plan(100, True), plan(128, True),
                                 plan(364, False), plan(100, False, bf16=True)],
                         ids=["d8_diag", "d100_full", "d128_full", "d364_diag", "d100_bf16"])
def test_narrow_plans_stay_narrow(cfg):
    assert ft.limit_error(cfg) is None
    assert not ft.uses_wide(cfg) and not ft.uses_cluster(cfg)


def test_cluster_geometry_refuses_a_card_that_holds_no_cluster():
    """Where the card holds no cluster of any size the plan fits (the
    occupancy query gave 0), the geometry raises: nothing falls back."""
    with pytest.raises(ValueError, match="no cluster"):
        ft.cluster_geometry(256, CLUSTER_PLANS["d196_full"], N_SMS, {4: 0, 8: 0})
    with pytest.raises(ValueError, match="positive"):
        ft.cluster_geometry(0, CLUSTER_PLANS["d196_full"], N_SMS, H100_ACTIVE)
