"""Device ms a traced training step spends in its backward: the kernels
launched under msgs.backward, the compositor backward (msgs.composite_bwd)
and the gather VJP (msgs.gather_vjp) included, and those autograd's device
thread launches while the step is in msgs.backward (benchmark/spans.py)."""
from benchmark.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "msgs.backward", "msgs.composite_bwd",
                    "msgs.gather_vjp")
