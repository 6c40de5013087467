"""Device ms a traced frame spends in preprocess: the kernels launched
under the program's msgs.preprocess spans (benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "render", "msgs.preprocess")
