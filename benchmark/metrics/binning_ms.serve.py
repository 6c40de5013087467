"""Device ms a traced frame spends in binning: the kernels launched under
msgs.binning and its four children (benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "render", "msgs.binning")
