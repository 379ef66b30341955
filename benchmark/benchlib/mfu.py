"""Shared arithmetic of the model-FLOP utilisation and idle-share readers."""
from __future__ import annotations


def mfu(ctx):
    """The configuration's model FLOPs an operation times the operations of
    the traced run's unprofiled head, over its seconds times the float32
    peak, in %; None without such a head or on the CPU."""
    flops = ctx.counts.get("model_flops_per_op")
    if not ctx.on_card or not flops or not ctx.head_records or ctx.head_s <= 0:
        return None
    return 100.0 * flops * len(ctx.head_records) / (ctx.head_s * ctx.peaks[0])


def idle(ctx):
    """100 × (1 − busy / window) of the traced window; None without a trace
    that saw the card."""
    t = ctx.trace
    if t is None or not ctx.on_card or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
