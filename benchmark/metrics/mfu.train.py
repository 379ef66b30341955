"""The model FLOPs of a training step (four UNet forwards a trajectory
and step: the simulation's, the flat evaluation's and its backward as two;
the checkpointed chunks' recomputation not counted) over the step time
times the float32 peak, in %. The step time is the unprofiled head of the
traced run's window over the steps in it (host clock)."""
from benchlib.mfu import mfu


def read(ctx):
    return mfu(ctx)
