"""Device ms a traced training step spends in its update: the kernels
launched under msgs.update (learning rates, Adam, the MS records, the
overflow keep; benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "msgs.update")
