"""Named spans of the port's stages, for a torch.profiler trace.

    with span("msgs.binning"):
        ...

While a profiler runs, `span` is `torch.profiler.record_function(name)`:
the profiler keeps the span with the operations and kernel launches under
it and exports it in its Chrome trace, on the same clock as the device's
events. With no profiler running it returns one shared no-op context, so
a span costs one check of the profiler's state (an ungated
record_function costs its enter and exit even then). The spans of the main
path are named `msgs.<stage>`; `benchmark/spans.py` matches them to the
device events they launched.
"""
from __future__ import annotations

import contextlib

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in a running profiler's trace, or the
    shared no-op when no profiler runs."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF
