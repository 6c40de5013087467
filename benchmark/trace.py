"""Reading a torch.profiler Chrome trace: the device's busy time as the
union of its kernel, copy and set intervals (msgs_torch/profile_render.py
`_device_busy_ms`'s arithmetic, copied so the yardstick stays put), the
kernels by name and start, and the breakdown the result line carries: the
device operations that took most time, and the device's idle gaps summed
by the host operation that was running when each began.
"""
from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"no {WINDOW} span in {path}")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        inside = lambda e: self.t0 <= float(e["ts"]) < self.t1
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e["cat"]) for e in xs if e.get("cat") in DEVICE_CATS
            and inside(e))
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW and float(e["ts"]) < self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, name_part: str = ""):
        """(start µs, duration s) of the kernels whose name holds
        `name_part`, in start order."""
        return [(a, (b - a) / 1e6) for a, b, n, c in self.device
                if c == "kernel" and name_part in n]

    def launches(self) -> int:
        return sum(1 for *_, c in self.device if c == "kernel")

    def _merged(self):
        out = []
        for a, b, *_ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def breakdown(self, n: int = 10) -> dict:
        by_op = defaultdict(float)
        for a, b, name, _ in self.device:
            by_op[name] += (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        merged = self._merged()
        gaps, last = [], self.t0
        for a, b in merged:
            if a > last:
                gaps.append((last, a))
            last = b
        if self.t1 > last:
            gaps.append((last, self.t1))
        by_host = defaultdict(float)
        for (a, b), label in zip(gaps, self._host_at([g[0] for g in gaps])):
            by_host[label] += (b - a) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def _host_at(self, times):
        """The innermost host operation (the shortest of those running)
        at each of the sorted `times`."""
        out, active, j = [], [], 0
        for t in times:
            while j < len(self.host) and self.host[j][0] <= t:
                active.append(self.host[j])
                j += 1
            active = [h for h in active if h[1] > t]
            best = min(active, key=lambda h: h[1] - h[0], default=None)
            out.append(best[2] if best else "(no torch op: Python)")
        return out
