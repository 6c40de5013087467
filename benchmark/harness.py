"""One run of one cell: set-up, a measured (or traced) window, the check
of what the window produced against the reference, and the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration's file, its traffic mix in benchmark/traffic/<mix>.json,
the runner of the mix's `kind` in benchmark/kinds/<kind>.py (its
generator, window and check), its limits in benchmark/limits/<cell>.json
and each metric's reader, end-to-end and per-layer, in
benchmark/metrics/<metric>.py. `run` takes the device from its caller:
benchmark/run.py gives it the card and refuses to run without one; the
tests give it the CPU at a tiny size.
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import program as P
from benchmark import reference as ref

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msgs")


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, manifest_path=REPO / "BENCHMARK.json",
             config_override=None, mix_override=None, limits_override=None):
        man = load_json(manifest_path)
        wl = next((w for w in man["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in {manifest_path}")
        conf = next(c for c in man["configs"] if c["name"] == wl["config"])
        config = load_json(REPO / conf["file"])
        mix = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
        config.update(config_override or {})
        mix.update(mix_override or {})
        lim_path = HERE / "limits" / f"{name}.json"
        limits = load_json(lim_path) if lim_path.exists() else {}
        limits.update(limits_override or {})
        e2e = [m for m in man["end_to_end"]
               if name in m.get("workloads", [name])]
        pl = [m for m in man["per_layer"]
              if name in m.get("workloads", [name])]
        return cls(name, config, mix, limits, e2e, pl)


@dataclass
class Clock:
    """Set-up phases on the host clock, from the process's start."""
    start: float
    phases: dict = field(default_factory=dict)
    last: float = 0.0

    def __post_init__(self):
        self.last = self.start

    def mark(self, name, dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now
        return now


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


_LOADED = {}


def _load(folder: str, name: str):
    """The module benchmark/<folder>/<name>.py, loaded once."""
    key = (folder, name)
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_" + name.replace(".", "_").replace("-", "_"),
            HERE / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def _reader(metric: str):
    """`read(ctx)` of benchmark/metrics/<metric>.py."""
    return _load("metrics", metric).read


def kind(name: str):
    """The runner of a kind of traffic, benchmark/kinds/<name>.py: its
    `run(cell, seed, seconds, trace, dev, clock, trace_path, check_only)`
    returns `attempted`, `failed`, `window` (s), `peak` (bytes), `numbers`
    (each compared number, by the name its limit has), `check_s`, `notes`
    (lines for standard error), `ctx` (what the metric readers may read
    besides the harness's own keys) and, traced, `trace_path`."""
    return _load("kinds", name)


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

# A pixel-size record matches the reference's to rounding: one that a step
# set differently (seen or not, decayed or not) is off by 5% or more.
RECORD_RTOL = 1e-4


def leaf_gaps(prog: dict, refn: dict):
    """Worst leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's. Leaves whose reference
    norm is under a thousandth of the median leaf's are left out."""
    med = statistics.median(refn.values())
    keep = [k for k in refn if refn[k] >= 1e-3 * med]
    return max(abs(prog[k] - refn[k]) / max(refn[k], med) for k in keep)


def norms(d):
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def records_mismatch(prog: dict, refr: dict, live) -> float:
    """Share of live rows whose max or min pixel-size record differs from
    the reference's by more than RECORD_RTOL of it."""
    bad = torch.zeros_like(live)
    for k in ("max_pixel_sizes", "min_pixel_sizes"):
        p, r = prog[k].double(), refr[k].double()
        bad |= (p - r).abs() > RECORD_RTOL * r.abs()
    return float((bad & live).sum()) / max(int(live.sum()), 1)


def check_line(checks: dict) -> bool:
    """Correct when every compared number is within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


# --------------------------------------------------------------------------
# What the kinds of traffic share (benchmark/kinds/<kind>.py)
# --------------------------------------------------------------------------

def settings_for(cell, entry_cap, train: bool):
    ms = cell.config["method"] == "ms"
    if train:
        return P.settings(entry_cap, filter_small=ms, filter_large=ms,
                          image_grads_only=True)
    return P.settings(entry_cap, filter_small=cell.mix["filter_small"],
                      filter_large=cell.mix["filter_large"])


def ref_settings(cell, train: bool):
    ms = cell.config["method"] == "ms"
    if train:
        return dict(filter_small=ms, filter_large=ms, fade_size=0.0)
    return dict(filter_small=cell.mix["filter_small"],
                filter_large=cell.mix["filter_large"],
                fade_size=cell.mix["fade_size"])


def ref_cam(view, dev):
    return ref.make_cam(view.R, view.T, view.fovx, view.fovy, view.width,
                        view.height, dev)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def event(dev):
    """A CUDA event recorded now on the device's stream (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def event_times(events):
    """Seconds between consecutive recorded events; [] without them."""
    if not events or any(e is None for e in events):
        return []
    return [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]


def peak(dev):
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, dev,
        process_start: float, manifest_path=REPO / "BENCHMARK.json",
        config_override=None, mix_override=None, trace_dir=None,
        check_only=False, limits_override=None):
    """Run one cell: (cell, set-up clock, result). `check_only` (for
    reading the check's numbers, benchmark/check.py) runs no warm-up and
    no window beyond what the check compares."""
    cell = Cell.load(workload, manifest_path, config_override, mix_override,
                     limits_override)
    clock = Clock(process_start)
    if dev.type == "cuda":
        P.build()
    clock.mark("build", dev)
    trace_dir = Path(trace_dir or REPO / "build" / "benchmark")
    trace_path = None
    if trace:
        trace_dir.mkdir(parents=True, exist_ok=True)
        trace_path = trace_dir / f"{workload}.trace.json"
    res = kind(cell.mix["kind"]).run(cell, seed, seconds, trace, dev, clock,
                                     trace_path, check_only)
    return cell, clock, res


def e2e_metrics(cell: Cell, clock: Clock, res: dict, process_start):
    ctx = dict(res["ctx"], kind=cell.mix["kind"],
               setup_s=clock.last - process_start,
               attempted=res["attempted"], window_s=res["window"])
    return _read_all(cell.end_to_end, ctx)


def per_layer_metrics(cell: Cell, ctx: dict):
    return _read_all(cell.per_layer, ctx)


def _read_all(metrics, ctx):
    """Each metric's reader (benchmark/metrics/<name>.py) on ctx; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in metrics:
        v = _reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(workload: str, seed: int, seconds: float, trace: bool, dev,
                process_start: float, **kw) -> dict:
    """Run the cell and build its result line."""
    cell, clock, res = run(workload, seed, seconds, trace, dev,
                           process_start, **kw)
    phases = " ".join(f"{k} {v:.3f}" for k, v in clock.phases.items())
    print(f"setup_s {clock.last - process_start:.3f} ({phases}); window "
          f"{res['window']:.3f} s, {res['attempted']} done, "
          f"{res['failed']} failed; check {res['check_s']:.3f} s",
          file=sys.stderr)
    for note in res["notes"]:
        print(note, file=sys.stderr)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
              "count": 1, "memory_peak_bytes": res["peak"]}
    line = {"correct": None, "attempted": res["attempted"],
            "failed": res["failed"]}
    if trace:
        from benchmark.trace import Trace
        tr = Trace(str(res["trace_path"]))
        ctx = dict(res["ctx"], kind=cell.mix["kind"], trace=tr,
                   busy_s=tr.busy_s(), window_s=tr.window_s)
        line["metrics"] = per_layer_metrics(cell, ctx)
        device.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        line["device"] = device
        line["breakdown"] = tr.breakdown()
    else:
        line["metrics"] = e2e_metrics(cell, clock, res, process_start)
        line["device"] = device
    checks = {k: {"value": v, "limit": cell.limits.get(k, 0.0)}
              for k, v in res["numbers"].items()}
    line["correct"] = check_line(checks)
    line["checks"] = checks
    return line
