"""Host ms a traced training step waits on the device under the
program's msgs.* spans: stream, device and event synchronisations, and
copies to the host or from pageable host memory (benchmark/spans.py)."""
from benchmark.spans import host_wait_ms


def read(ctx):
    return host_wait_ms(ctx, "train")
