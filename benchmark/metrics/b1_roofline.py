"""B1's bound at the pass's shapes over B1's device time a launch, from the
profiler's trace (kernels named traj_kernel_*), in %. The bound is the
larger of flops over the float32 peak, transcendentals over the SFU rate
and bytes over the memory rate (benchlib/yardstick.py)."""
from benchlib.yardstick import bound


def read(ctx):
    if ctx.trace is None or "b1" not in ctx.counts:
        return None
    ops = [v for k, v in ctx.trace["ops"].items() if "traj_kernel" in k]
    n = sum(v["count"] for v in ops)
    if n == 0:
        return None
    b1 = ctx.counts["b1"]
    t_bound, _ = bound(b1["flops"], b1["transcendentals"], b1["bytes"], ctx.peaks, ctx.sfu_rate)
    return 100.0 * t_bound / (sum(v["seconds"] for v in ops) / n)
