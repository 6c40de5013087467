"""The program's stage spans matched to the device trace.

msgs_torch marks its stages with `msgs.<stage>` spans (msgs_torch/trace.py),
which torch.profiler exports in its Chrome trace beside the runtime calls
and the device's kernel, copy and set events, all on one clock. For the
traced window (the `bench.window` span, or the whole trace without one)
this module matches every device event to the CUDA API call that launched
it, by the `correlation` arg both carry, and finds the launch's
span: the innermost `msgs.*` span on the launch's own thread that holds
the launch's start; failing that, the innermost one on any thread
(autograd's device thread launches backward kernels while the main thread
is in `msgs.backward`). A span's parent is found by the same rule, so the
backward's spans on autograd's thread nest in `msgs.backward`.

Per span name, over the window: calls; host ms (Σ durations) and self
host ms (less the part its child spans on its thread cover); device ms (Σ durations of
the device events launched under it or its children) and self device ms;
launches; host waits and their ms. A wait is a synchronising runtime call
under the span: cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize, or a cudaMemcpy* whose copy goes device to host or
comes from pageable host memory. Device time launched under no `msgs.*`
span is listed by the host operation that launched it and the device
operation; device events whose launch is missing from the trace (the
profiler drops events late in long processes) are counted apart.

    python3 -m benchmark.spans build/benchmark/<cell>.trace.json

prints the table, per step or frame (the calls of `msgs.train_step` and
`msgs.eval_render`). The per-layer metrics that read the spans
(benchmark/metrics/*_ms.*.py) get the table through `of_ctx`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PREFIX = "msgs."
ROOTS = ("msgs.train_step", "msgs.eval_render")
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def load_events(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _innermost_map(spans):
    """Breakpoints and, for each segment between consecutive ones, the
    innermost (shortest) of `spans` — (start, end, index) — holding it, or
    None."""
    edges = sorted({s[0] for s in spans} | {s[1] for s in spans})
    starts = sorted(spans, key=lambda s: s[0])
    active, j, out = [], 0, []
    for t in edges:
        while j < len(starts) and starts[j][0] <= t:
            active.append(starts[j])
            j += 1
        active = [s for s in active if s[1] > t]
        best = min(active, key=lambda s: (s[1] - s[0], -s[0]), default=None)
        out.append(None if best is None else best[2])
    return edges, out


def _lookup(m, t):
    edges, ids = m
    i = bisect.bisect_right(edges, t) - 1
    return ids[i] if i >= 0 else None


def _is_wait(name: str, copy) -> bool:
    if name in SYNCS:
        return True
    if not name.startswith("cudaMemcpy") or copy is None:
        return False
    return "DtoH" in copy or "Pageable" in copy


class Spans:
    """The window's `msgs.*` spans with what each launched and waited
    for. `rows` maps a span name to its sums over the window (ms, counts);
    `unattributed` maps (host op, device op) to the device ms launched
    under no span; `ops` maps (span name, device op) to the device ms it
    launched itself; `missing` / `missing_ms` count the device events whose
    launch is not in the trace; `device_events` / `device_ms` are the
    window's totals."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if win:
            t0 = float(win[0]["ts"])
            t1 = t0 + float(win[0]["dur"])
        else:
            t0, t1 = float("-inf"), float("inf")
        inside = lambda e: t0 <= float(e["ts"]) < t1
        ival = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        thread = lambda e: (e.get("pid"), e.get("tid"))

        # The spans: name, interval, thread, parent.
        spans = [e for e in xs if e.get("cat") == "user_annotation"
                 and e["name"].startswith(PREFIX) and inside(e)]
        self.names = [e["name"] for e in spans]
        self.iv = [ival(e) for e in spans]
        self.thread = [thread(e) for e in spans]
        by_thread = defaultdict(list)
        for i, (a, b) in enumerate(self.iv):
            by_thread[self.thread[i]].append((a, b, i))
        own = {t: _innermost_map(v) for t, v in by_thread.items()}
        anyt = _innermost_map([(a, b, i) for i, (a, b) in
                               enumerate(self.iv)])
        self.parent = [self._parent(i, by_thread) for i in range(len(spans))]

        def span_of(e):
            t = float(e["ts"])
            m = own.get(thread(e))
            s = _lookup(m, t) if m else None
            return s if s is not None else _lookup(anyt, t)

        # Launches and waits.
        launch = {}
        calls = []
        for e in xs:
            if e.get("cat") not in LAUNCH_CATS:
                continue
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e
            calls.append(e)
        n = len(spans)
        self.self_dev = [0.0] * n
        self.self_launches = [0] * n
        self.self_waits = [0] * n
        self.self_wait = [0.0] * n
        self.unattributed = defaultdict(float)
        self.ops = defaultdict(float)
        self.missing, self.missing_ms = 0, 0.0
        self.device_events, self.device_ms = 0, 0.0
        copy_of = {}
        host = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") == "gpu_memcpy" and corr is not None:
                copy_of[corr] = e["name"]
            if not inside(e):
                continue
            ms = float(e["dur"]) / 1e3
            self.device_events += 1
            self.device_ms += ms
            src = launch.get(corr)
            if src is None:
                self.missing += 1
                self.missing_ms += ms
                continue
            s = span_of(src)
            if s is None:
                if not host:
                    host = sorted(
                        (ival(h) + (h["name"], thread(h))) for h in xs
                        if h.get("cat") in ("cpu_op", "user_annotation"))
                op = _host_op(host, float(src["ts"]), thread(src))
                self.unattributed[(op, e["name"])] += ms
                continue
            self.self_dev[s] += ms
            self.self_launches[s] += 1
            self.ops[(self.names[s], e["name"])] += ms
        for e in calls:
            if not inside(e):
                continue
            corr = (e.get("args") or {}).get("correlation")
            if not _is_wait(e["name"], copy_of.get(corr)):
                continue
            s = span_of(e)
            if s is not None:
                self.self_waits[s] += 1
                self.self_wait[s] += float(e["dur"]) / 1e3
        self.rows = self._rows()

    def _parent(self, i, by_thread):
        """The innermost other span holding span i: on its own thread
        first, then on any thread."""
        a, b = self.iv[i]
        same = self.thread[i]

        def holds(j):
            a2, b2 = self.iv[j]
            # of two spans over one interval, the earlier holds the later
            return a2 <= a and b <= b2 and (b2 - a2 > b - a or j < i)

        def best(cands):
            c = [j for _, _, j in cands if j != i and holds(j)]
            return min(c, key=lambda j: (self.iv[j][1] - self.iv[j][0],
                                         -self.iv[j][0]), default=None)
        p = best(by_thread[same])
        if p is not None:
            return p
        return best([c for t, v in by_thread.items() if t != same
                     for c in v])

    def _rows(self):
        n = len(self.names)
        depth = [0] * n
        for i in range(n):
            j = self.parent[i]
            while j is not None:
                depth[i] += 1
                j = self.parent[j]
        self.incl = incl = {k: list(v) for k, v in (
            ("dev", self.self_dev), ("launches", self.self_launches),
            ("waits", self.self_waits), ("wait", self.self_wait))}
        child_iv = defaultdict(list)
        for i in sorted(range(n), key=lambda i: -depth[i]):
            p = self.parent[i]
            if p is None:
                continue
            for k in incl:
                incl[k][p] += incl[k][i]
            if self.thread[p] == self.thread[i]:
                child_iv[p].append(self.iv[i])
        rows = {}
        for i, name in enumerate(self.names):
            r = rows.setdefault(name, dict(
                calls=0, host_ms=0.0, self_host_ms=0.0, device_ms=0.0,
                self_device_ms=0.0, launches=0, waits=0,
                wait_ms=0.0, self_waits=0, self_wait_ms=0.0))
            a, b = self.iv[i]
            r["calls"] += 1
            r["host_ms"] += (b - a) / 1e3
            r["self_host_ms"] += (b - a - _covered(child_iv[i])) / 1e3
            r["device_ms"] += incl["dev"][i]
            r["self_device_ms"] += self.self_dev[i]
            r["launches"] += incl["launches"][i]
            r["waits"] += incl["waits"][i]
            r["wait_ms"] += incl["wait"][i]
            r["self_waits"] += self.self_waits[i]
            r["self_wait_ms"] += self.self_wait[i]
        return rows

    @property
    def steps(self) -> int:
        return sum(self.rows.get(r, {}).get("calls", 0) for r in ROOTS)

    def stage_ms(self, *names) -> float:
        """Device ms launched under the spans named, their children
        included, each counted once where one nests in another."""
        total = 0.0
        for i, name in enumerate(self.names):
            if name not in names:
                continue
            j = self.parent[i]
            while j is not None and self.names[j] not in names:
                j = self.parent[j]
            if j is None:
                total += self.incl["dev"][i]
        return total

    def wait_ms(self) -> float:
        """Host ms in waits under any span."""
        return sum(self.self_wait)


def _covered(ivs) -> float:
    """Length of the union of intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _host_op(host, t, thread):
    """The innermost host operation or annotation on `thread` running at
    t (the shortest of those holding it)."""
    i = bisect.bisect_right(host, (t, float("inf")))
    best = None
    for a, b, name, th in reversed(host[max(0, i - 512):i]):
        if th == thread and a <= t < b and (best is None
                                           or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "(no torch op: Python)"


# --------------------------------------------------------------------------
# The metric readers' side
# --------------------------------------------------------------------------

def _window_events(trace):
    """The events of the Chrome trace whose `bench.window` is `trace`'s (a
    benchmark.trace.Trace, which keeps no path): the newest trace under
    build/benchmark/, where the harness writes them, whose window
    matches. None where that folder holds no trace; a LookupError where
    it holds traces and none is the window's, so that the span metrics
    cannot fall silent unseen."""
    cands = sorted((REPO / "build" / "benchmark").glob("*.trace.json"),
                   key=lambda p: -p.stat().st_mtime)
    for p in cands:
        try:
            events = load_events(p)
        except (OSError, ValueError, KeyError):
            continue
        for e in events:
            if (e.get("ph") == "X" and e.get("name") == WINDOW
                    and e.get("cat") == "user_annotation"):
                if (float(e["ts"]) == trace.t0 and
                        float(e["ts"]) + float(e["dur"]) == trace.t1):
                    return events
                break
    if cands:
        raise LookupError(
            f"none of the {len(cands)} traces under build/benchmark/ holds "
            f"the window {trace.t0}..{trace.t1} µs")
    return None


def of_ctx(ctx):
    """The traced window's Spans, or None where the trace has no `msgs.*`
    span or no device event (the CPU, a program without spans). Read once
    a trace."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    if "_msgs_spans" not in vars(tr):
        events = _window_events(tr)
        has = events is not None and any(
            e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX) for e in events)
        sp = Spans(events) if has else None
        tr._msgs_spans = sp if sp is not None and sp.device_events else None
    return tr._msgs_spans


def stage_ms(ctx, kind, *names):
    """Device ms a traced step or frame spends under the spans named."""
    if ctx.get("kind") != kind or not ctx.get("steps"):
        return None
    sp = of_ctx(ctx)
    if sp is None or not any(n in sp.rows for n in names):
        return None
    return sp.stage_ms(*names) / ctx["steps"]


def host_wait_ms(ctx, kind):
    """Host ms a traced step or frame waits on the device under the
    program's spans."""
    if ctx.get("kind") != kind or not ctx.get("steps"):
        return None
    sp = of_ctx(ctx)
    if sp is None:
        return None
    return sp.wait_ms() / ctx["steps"]


# --------------------------------------------------------------------------
# The table
# --------------------------------------------------------------------------

COLUMNS = ("calls", "host_ms", "self_host_ms", "device_ms", "self_device_ms",
           "launches", "self_waits", "self_wait_ms")


def table(sp: Spans) -> dict:
    """Every span's row, the unattributed device time and the missing
    launches, per step or frame (the root spans' calls)."""
    steps = sp.steps or 1
    rows = {n: {k: v / steps for k, v in r.items()}
            for n, r in sorted(sp.rows.items())}
    un = sorted(sp.unattributed.items(), key=lambda kv: -kv[1])
    ops = defaultdict(list)
    for (name, op), ms in sorted(sp.ops.items(), key=lambda kv: -kv[1]):
        ops[name].append([op, ms / steps])
    return {
        "steps": steps, "rows": rows, "ops": dict(ops),
        "unattributed": [[h, d, ms / steps] for (h, d), ms in un],
        "device_ms": sp.device_ms / steps,
        "device_events": sp.device_events / steps,
        "missing": sp.missing, "missing_ms": sp.missing_ms / steps,
        "missing_share": sp.missing / max(sp.device_events, 1),
        "host_wait_ms": sp.wait_ms() / steps,
    }


def _short(op: str, n: int = 90) -> str:
    """A device op's name without `void ` and the common namespaces, cut
    to n characters."""
    for part in ("void ", "at::native::", "(anonymous namespace)::"):
        op = op.replace(part, "")
    return op[:n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The msgs.* spans of a "
                                "torch.profiler Chrome trace, per step")
    p.add_argument("trace")
    p.add_argument("--ops", type=int, default=4,
                   help="device ops listed for each span")
    args = p.parse_args(argv)
    sp = Spans(load_events(args.trace))
    t = table(sp)
    print(f"per step or frame, over {t['steps']} "
          f"(device events {t['device_events']:.1f}, "
          f"{t['device_ms']:.3f} ms; host waits under spans "
          f"{t['host_wait_ms']:.3f} ms)")
    print(f"{'span':<22}" + "".join(f"{c:>15}" for c in COLUMNS))
    for name, r in t["rows"].items():
        print(f"{name:<22}" + "".join(
            f"{r[c]:>15.3f}" for c in COLUMNS))
    print("each span's largest device ops (ms, launched by the span "
          "itself):")
    for name, ops in t["ops"].items():
        print(f"  {name}: " + "; ".join(
            f"{ms:.3f} {_short(op, 60)}" for op, ms in ops[:args.ops]))
    print("device ms launched under no msgs span, by host op -> device op:")
    for h, d, ms in t["unattributed"][:20]:
        print(f"  {ms:10.3f}  {h} -> {_short(d)}")
    print(f"device events with no launch in the trace: {t['missing']} "
          f"({100 * t['missing_share']:.3f}%), "
          f"{t['missing_ms']:.3f} ms a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
