"""Process start to the first timed operation (host clock): imports,
building the target, the weights and the solver, the kernels' build or
load, and the warm-up operations."""


def read(ctx):
    return ctx.setup_s
