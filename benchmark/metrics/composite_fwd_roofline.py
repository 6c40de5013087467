"""Kernel 3 (csrc/composite_fwd.cu) against the least time its inputs
need (benchmark/work.py), over the traced frames."""
from benchmark import work as W
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "render", "composite_fwd_kernel",
                        W.composite_fwd_bound_s)
