"""The window's host seconds over the optimizer steps completed in it
(skipped steps counted), in ms."""


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * ctx.window_s / len(ctx.records)
