"""Device ms a traced training step spends in preprocess: the kernels
launched under the program's msgs.preprocess spans (the state's activations
and SH concat, projection, SH colour, MS selection; benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "msgs.preprocess")
