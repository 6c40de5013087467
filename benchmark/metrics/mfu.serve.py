"""The whole frame's counted operations over its time at the fp32 peak
(benchmark/work.py render_ops)."""
from benchmark import work as W
from benchmark.layers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "render", W.render_ops)
