"""The 95th percentile, by nearest rank, of every pass of the window, each
timed from its call to its results on the host (host clock), in ms."""
import math


def read(ctx):
    times = sorted(r[1] - r[0] for r in ctx.records)
    if not times:
        return None
    return 1e3 * times[max(math.ceil(0.95 * len(times)) - 1, 0)]
