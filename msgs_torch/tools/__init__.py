"""Experiment scripts of the port: the counterparts of the JAX package's
tools/exp_*.py, run as `python -m msgs_torch.tools.<name>`.

Shared here: the timing (CUDA events on the card, the host clock on the
CPU) and the device's name; for the gather scripts, their command line
(`[N] [E] [--device cpu]`), the exact check every gather variant is held
to and the bytes a gather must move.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import tempfile
import time

import torch


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
