"""Frozen operation counts and the card's peaks: the numerators and
denominators of the roofline and MFU metrics, computed from the
configuration's shapes alone, whatever implements them.

Copied from ``chip_smoke.py`` (``PEAKS``, ``SFU_PER_CLOCK_PER_SM``,
``bound``, the counts of ``phase_timing``). Per trajectory-step of B1: the
control MLP's multiply-adds, 2(D·H + n_h·H² + H·D) flops; the reference
score and the update, 6·C·D + 8·D flops (a full covariance adds 4·C·D²);
the transcendentals, a tanh per unit of the n_h + 1 gelu layers, two
exponentials per component past the first and, with the kernel's own
noise, a log, a square root and a cosine per dimension. Bytes: the plan's
tables read once, x_0 read and x_K and the log-weight written once (fed
noise and saved states add 2·4·K·B·D).
"""
from __future__ import annotations

# float32 non-tensor-core peak, memory rate, dense bf16 and dense TF32
# tensor-core peaks of the H100 variants (NVIDIA data sheets: half the
# rates given with sparsity)
PEAKS = {"PCIe": (51.2e12, 2.0e12, 756e12, 378e12), "NVL": (60.0e12, 3.9e12, 835e12, 417.5e12),
         "SXM": (67.0e12, 3.35e12, 989e12, 494.7e12)}
# special-function unit results (expf, sqrtf, logf) per clock per SM on
# Hopper; times the SM count and the SM clock gives the transcendental rate
SFU_PER_CLOCK_PER_SM = 16
SM_CLOCK_HZ = {"PCIe": 1755e6, "NVL": 1785e6, "SXM": 1980e6}
N_SMS = {"PCIe": 114, "NVL": 132, "SXM": 132}


def card_peaks(name: str):
    """(variant, peaks, SFU results a second) of the H100 named ``name``;
    the SXM part's where the name says no other."""
    for key, peaks in PEAKS.items():
        if key in name:
            break
    else:
        key, peaks = "SXM", PEAKS["SXM"]
    return key, peaks, SFU_PER_CLOCK_PER_SM * N_SMS[key] * SM_CLOCK_HZ[key]


def bound(flops: float, transcendentals: float, nbytes: float, peaks, sfu_rate: float):
    """(bound seconds, what binds): the larger of the operations time (flops
    over the float32 peak, transcendentals over the SFU rate) and the bytes
    time."""
    t_ops = max(flops / peaks[0], transcendentals / sfu_rate)
    t_bytes = nbytes / peaks[1]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b1_counts(dim: int, channels: int, n_hidden: int, n_comp: int, k_steps: int, batch: int,
              full_cov: bool = False, kernel_noise: bool = True) -> dict:
    """B1's flops, transcendentals and bytes for one launch."""
    d, h, nh, c, k, b = dim, channels, n_hidden, n_comp, k_steps, batch
    mlp_flops = 2 * (d * h + nh * h * h + h * d)
    rest_flops = 6 * c * d + 8 * d + (4 * c * d * d if full_cov else 0)
    n = b * k
    table_floats = (k * 6 + k * h + d * h + h + nh * h * h + nh * h + h * d + d
                    + k * c + 2 * k * c * d + (2 * c * d * d if full_cov else 0))
    nbytes = 4 * table_floats + 4 * (2 * b * d + b) + (0 if kernel_noise else 2 * 4 * k * b * d)
    return {"flops": n * (mlp_flops + rest_flops), "mlp_flops": n * mlp_flops,
            "transcendentals": n * ((nh + 1) * h + 2 * (c - 1) + (3 * d if kernel_noise else 0)),
            "bytes": nbytes}


def unet_forward_flops(side: int = 14) -> float:
    """The UNet's forward flops for one sample (convolutions, matrix
    products, attention), counted by ``FlopCounterMode`` on the benchmark's
    plain reference at batch 1 with the configuration's widths."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.precision import Arith
    from reference.unet import unet

    from .weights import unet_shapes

    params = {k: torch.zeros(s) for k, s in unet_shapes().items()}
    with FlopCounterMode(display=False) as counter:
        unet(params, torch.zeros(1), torch.zeros(1, side * side), Arith("f32"), side=side)
    return float(counter.get_total_flops())
