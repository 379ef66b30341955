"""The frozen counts against chip_smoke.py's formulas at the demo's shapes,
and the UNet's forward flops."""
import math

import pytest
import torch

from benchlib import weights, yardstick


def chip_smoke_counts(d, h, nh, c, k, b):
    """chip_smoke.py phase_timing's per-launch counts (eval shape: the
    kernel's own noise), written out as there."""
    mlp_flops = 2 * (d * h + nh * h * h + h * d)
    rest_flops = 6 * c * d + 8 * d
    n = b * k
    return n * (mlp_flops + rest_flops), n * ((nh + 1) * h + 2 * (c - 1) + 3 * d)


@pytest.mark.parametrize("batch", [8192, 131072])
def test_b1_counts_match_chip_smoke(batch):
    got = yardstick.b1_counts(8, 64, 2, 4, 100, batch)
    flops, trans = chip_smoke_counts(8, 64, 2, 4, 100, batch)
    assert got["flops"] == flops and got["transcendentals"] == trans
    if batch == 131072:      # 245 GFLOP: 3.66 ms at 67 TFLOP/s, flops-bound
        _, peaks, sfu = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
        t, what = yardstick.bound(got["flops"], got["transcendentals"], got["bytes"], peaks, sfu)
        assert what == "operations" and math.isclose(t, 3.6558e-3, rel_tol=1e-3)


def test_b1_bytes_are_the_tables_and_the_rows():
    d, h, nh, c, k, b = 8, 64, 2, 4, 100, 1000
    tables = {"coefs": (k, 6), "embed": (k, h), "w0": (d, h), "b0": (1, h), "wh": (nh, h, h),
              "bh": (nh, 1, h), "w_out": (h, d), "b_out": (1, d), "ref_const": (k, c),
              "ref_m": (k, c * d), "ref_iv": (k, c * d)}
    want = 4 * sum(math.prod(s) for s in tables.values()) + 4 * (2 * b * d + b)
    assert yardstick.b1_counts(d, h, nh, c, k, b)["bytes"] == want


def test_peaks_and_sfu_rate():
    key, peaks, sfu = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
    assert key == "SXM" and peaks[0] == 67e12 and peaks[1] == 3.35e12
    assert sfu == 16 * 132 * 1980e6
    assert yardstick.card_peaks("NVIDIA H100 PCIe")[0] == "PCIe"


def test_unet_forward_flops_per_sample():
    assert yardstick.unet_forward_flops() == pytest.approx(17.741952e6, rel=1e-9)


def test_unet_count_matches_the_ports_module():
    from torch.utils.flop_counter import FlopCounterMode

    from sde_sampler_lrds_torch.models.mnist_unet import Unet

    m = Unet(n_channels=16, side=14)
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == weights.unet_shapes(16)
    with FlopCounterMode(display=False) as fc:
        m(torch.zeros(1), torch.zeros(1, 196))
    assert fc.get_total_flops() == yardstick.unet_forward_flops()
