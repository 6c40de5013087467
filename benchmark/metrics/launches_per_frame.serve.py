"""Device kernel launches per served frame."""
from benchmark.layers import launches_per


def read(ctx):
    return launches_per(ctx, "render")
