"""Arithmetic the per-layer metric readers (benchmark/metrics/*.py) share.
Each reader gets the traced window's context: `kind` ("train" or
"render"), `trace` (benchmark.trace.Trace), `busy_s`, `window_s`, and what
the kind's runner (benchmark/kinds/<kind>.py) adds: `steps`, `work` (the
reference's work count of each traced step or frame), `step_times`
(seconds of each on the device's clock, from CUDA events at each one's
dispatch), and for renders the program's counters `num_entries`,
`visible` (per frame) and `live`. A reader returns None where its cell
has nothing for it to read.
"""
from __future__ import annotations

from benchmark import work as W


def launches_per(ctx, kind):
    if ctx["kind"] != kind or not ctx["steps"]:
        return None
    n = ctx["trace"].launches()
    return n / ctx["steps"] if n else None


def idle_pct(ctx, kind):
    if ctx["kind"] != kind or ctx["busy_s"] <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def roofline_pct(ctx, kind, kernel, bound_fn):
    """Σ least time / Σ measured time of `kernel`, one launch a traced
    step or frame (None where the trace does not show exactly that)."""
    if ctx["kind"] != kind:
        return None
    ks = ctx["trace"].kernels(kernel)
    if not ks or len(ks) != len(ctx["work"]):
        return None
    return W.share_pct([bound_fn(w) for w in ctx["work"]],
                       [d for _, d in ks])


def mfu_pct(ctx, kind, ops_fn):
    """Counted operations of the traced steps or frames over their time at
    the fp32 peak."""
    times = ctx["step_times"]
    if ctx["kind"] != kind or not times or len(times) != len(ctx["work"]):
        return None
    return 100.0 * sum(ops_fn(w) for w in ctx["work"]) / (
        sum(times) * W.PEAK_FP32)
