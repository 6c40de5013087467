"""Share of the traced serving window in which no device operation ran."""
from benchmark.layers import idle_pct


def read(ctx):
    return idle_pct(ctx, "render")
