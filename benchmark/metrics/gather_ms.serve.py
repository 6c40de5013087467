"""Device ms a traced frame spends building and gathering the compositor's
payload: the kernels launched under msgs.gather (the feature table and the
row gather; benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "render", "msgs.gather")
