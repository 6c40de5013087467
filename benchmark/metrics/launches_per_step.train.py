"""Device kernel launches per training step (the trace's kernel events over
the traced steps)."""
from benchmark.layers import launches_per


def read(ctx):
    return launches_per(ctx, "train")
