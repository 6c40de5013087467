"""The whole training step's counted operations over its time at the fp32
peak (benchmark/work.py step_ops)."""
from benchmark import work as W
from benchmark.layers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train", W.step_ops)
