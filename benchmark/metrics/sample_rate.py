"""Trajectory-steps of every sampling pass completed in the window, over
the window's host seconds (host clock; a pass is complete when its results
are on the host)."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r[2] for r in ctx.records) / ctx.window_s
