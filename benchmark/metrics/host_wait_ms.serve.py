"""Host ms a traced frame waits on the device under the program's msgs.*
spans (the benchmark's own copy of the image to the host lies outside
them; benchmark/spans.py)."""
from benchmark.spans import host_wait_ms


def read(ctx):
    return host_wait_ms(ctx, "render")
