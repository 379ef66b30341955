"""The model FLOPs of a sampling pass (B1's count: the control MLP at
every trajectory-step, the reference and update terms) over the pass time
times the float32 peak, in %. The pass time is the unprofiled head of the
traced run's window over the passes in it (host clock)."""
from benchlib.mfu import mfu


def read(ctx):
    return mfu(ctx)
