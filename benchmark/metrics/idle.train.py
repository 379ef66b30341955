"""The share of the traced window in which no operation ran on the card,
in % (device trace)."""
from benchlib.mfu import idle


def read(ctx):
    return idle(ctx)
