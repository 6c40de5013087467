"""The trace arithmetic on a small hand-made Chrome trace: busy time is the
union of device intervals inside the window, idle gaps are summed by the
innermost host operation running when each began, and the metric readers
read it."""
import json

import pytest

from benchmark import layers
from benchmark.trace import Trace


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 0,
         "dur": 90},
        {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 38,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 95, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(p))


def test_busy_window_and_breakdown(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == 100e-6
    # [10, 40) ∪ [60, 70) ∪ [95, 100): 45 µs
    assert abs(t.busy_s() - 45e-6) < 1e-12
    assert t.launches() == 3
    assert [d for _, d in t.kernels("k_a")] == pytest.approx([20e-6, 10e-6])
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k_a"
    assert b["device_ops"][0][1] == pytest.approx(30e-6)
    idle = dict(b["idle_gaps"])
    # gaps [0,10) and [70,95) begin in aten::outer, [40,60) in aten::inner
    assert abs(idle["aten::outer"] - 35e-6) < 1e-12
    assert abs(idle["aten::inner"] - 20e-6) < 1e-12


def test_readers_on_the_trace(tmp_path):
    t = _trace(tmp_path)
    ctx = dict(kind="render", trace=t, steps=3, busy_s=t.busy_s(),
               window_s=t.window_s, step_times=[1.0, 1.0],
               work=[{"pairs": 10, "entries_read": 1, "pixels": 4,
                      "live": 2}] * 2)
    assert layers.launches_per(ctx, "render") == 1.0
    assert layers.launches_per(ctx, "train") is None
    assert abs(layers.idle_pct(ctx, "render") - 55.0) < 1e-9
    # two k_a launches for two frames
    assert layers.roofline_pct(ctx, "render", "k_a", lambda w: 1e-6) == \
        pytest.approx(100.0 * 2e-6 / 30e-6)
    assert layers.roofline_pct(ctx, "render", "k_b", lambda w: 1e-6) is None
