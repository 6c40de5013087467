"""Kernel 4 (csrc/composite_bwd.cu) against the least time its inputs
need (benchmark/work.py), over the traced steps."""
from benchmark import work as W
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", "composite_bwd_kernel",
                        W.composite_bwd_bound_s)
