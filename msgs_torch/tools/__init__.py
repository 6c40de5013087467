"""Experiment scripts of the port: the counterparts of the JAX package's
tools/exp_*.py, run as `python -m msgs_torch.tools.<name>`.

Shared here: the timing (CUDA events on the card, the host clock on the
CPU), the device's name, a profiler trace's events and the device's busy
time in it, and the bench scene; for the gather scripts, their command
line (`[N] [E] [--device cpu]`), the exact check every gather variant is
held to and the bytes a gather must move; for the difference histogram,
seeded band descriptors and the bytes they need read.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import tempfile
import time

import numpy as np
import torch

BENCH_N = 100_000   # Gaussians in the bench scene


def bench_scene(seed: int = 0):
    """bench.py:76-85, the same draws in the same order, as float32 numpy:
    (means, scales, quats, opacities, colours) of BENCH_N Gaussians."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-3.0, 3.0, (BENCH_N, 2)),
                            rng.uniform(2.0, 12.0, (BENCH_N, 1))], axis=1)
    scales = np.exp(rng.uniform(-4.5, -2.5, (BENCH_N, 3)))
    quats = rng.normal(size=(BENCH_N, 4))
    opac = rng.uniform(0.2, 0.9, BENCH_N)
    cols = rng.uniform(0, 1, (BENCH_N, 3))
    return tuple(np.asarray(a, np.float32)
                 for a in (means, scales, quats, opac, cols))


def parse_args(argv, doc: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("N", type=int, nargs="?", default=100_000,
                   help="table rows (the table has N + 1)")
    p.add_argument("E", type=int, nargs="?", default=1 << 21,
                   help="entries gathered")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def clock_name(dev: torch.device) -> str:
    return ("CUDA events" if dev.type == "cuda"
            else f"host clock, {dev.type}")


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def time_ms(fn, dev: torch.device, reps: int = 20) -> float:
    """Median ms of one call of fn after one warm-up call: CUDA events on
    a CUDA device, the host clock elsewhere."""
    fn()
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def trace_events(fn, reps: int = 5, pad_s: float = 0.0) -> list:
    """The chrome-trace events of a torch.profiler trace of `reps` calls
    of fn, after one untraced call. pad_s seconds of idle host time open
    the profiler's window before the first call and close it after the
    last call has finished on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _device_busy_ms(trace_path: str) -> float:
    """Union of the device's kernel / memcpy / memset intervals in a Chrome
    trace (the profiler's per-op tables count a kernel's time on both the
    op and the kernel row, so their sums overstate it)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def kernel_name(e: dict) -> str:
    """A device event's kernel as trace_ms names it: without its return
    type, namespace, template arguments and parameters; memsets are
    "memset"."""
    if e.get("cat") == "gpu_memset":
        return "memset"
    return re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::", "",
                                    e["name"]))[0].split("::")[-1]


def trace_ms(fn, reps: int = 5) -> dict:
    """The device side of fn from a torch.profiler trace of `reps` calls
    (trace_events): {kernel: {"ms": mean device ms of its events,
    "events": n}}, kernels named by kernel_name. A trace can lose events:
    n below reps × the launches of one call shows the loss."""
    total, count = {}, {}
    for e in trace_events(fn, reps):
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memset"):
            continue
        name = kernel_name(e)
        total[name] = total.get(name, 0.0) + e["dur"] / 1e3
        count[name] = count.get(name, 0) + 1
    return {k: {"ms": total[k] / count[k], "events": count[k]}
            for k in total}


def held_exact(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Raises unless got equals want bit for bit (then max|Δ| is 0)."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        err = float((got - want).abs().max())
        raise RuntimeError(f"{name}: differs from table[gid] (max|Δ| {err})")


def gather_bytes(gid: torch.Tensor, F: int) -> int:
    """Least bytes of an F-float row gather: E·F floats written, E int32 ids
    read, and each table row that gid references read once."""
    E = gid.shape[0]
    return E * F * 4 + E * 4 + int(torch.unique(gid).numel()) * F * 4


def band_rows(n: int, tiles_x: int, tiles_y: int, live_share: float,
              seed: int):
    """Band descriptors as binning's banded path forms them, for its
    difference histogram (kernels/binning.py:_band_histogram): rects of
    1-3 tile rows inside the frame, q1 = h // 4, q2 = h - q1, per band an
    integer column low and a width of 1-3 tiles (0 for an empty band), live
    at `live_share`. Dead rows carry such values too, which the histogram
    must not count. (rect_min, (q1, q2, h), txlos, ws, live) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    ri = lambda lo, hi: torch.randint(lo, hi, (n,), generator=g,
                                      dtype=torch.int32)
    ymin = ri(0, tiles_y)
    h = torch.minimum(ri(1, 4), tiles_y - ymin)
    rect_min = torch.stack([ri(0, tiles_x), ymin], 1)
    q1 = torch.div(h, 4, rounding_mode="floor")
    qs = (q1, h - q1, h)
    txlos, ws, qa = [], [], torch.zeros_like(h)
    for qb in qs:
        lo = ri(0, tiles_x).float()
        w = torch.minimum(ri(1, 4).float(), tiles_x - lo)
        txlos.append(lo)
        ws.append(torch.where(qb > qa, w, 0.0))
        qa = qb
    live = torch.rand(n, generator=g) < live_share
    return rect_min, qs, tuple(txlos), tuple(ws), live


def band_hist_bytes(live: torch.Tensor, cells: int) -> int:
    """Least bytes of the banded difference histogram: every row's live
    flag, the 40 descriptor bytes of each live row (its top row, three band
    boundaries, three column lows and widths, int32 and float32), and the
    int32 grid written once."""
    return live.numel() + 40 * int(live.sum()) + 4 * cells
