"""The span arithmetic (benchmark/spans.py) on a small hand-made Chrome
trace: two host threads, launches matched to device events by their
correlation ids, a kernel launched from autograd's thread outside any span
of its own, a pageable copy to the device and a stream synchronisation
(waits), a copy launched under no span, a kernel whose launch is missing,
and one past the window. Every number is exact; the readers of the span
metrics read it, and return None where their cell has nothing to read."""
import json
import os

import pytest

from benchmark import harness as H
from benchmark import spans as S
from benchmark.trace import Trace

MAIN, AUTOGRAD, STREAM = (1, 10), (1, 20), (0, 7)


def _x(cat, name, ts, dur, thread, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, thread=MAIN):
    return _x("user_annotation", name, ts, dur, thread)


def _launch(name, ts, corr, thread=MAIN, dur=5):
    return _x("cuda_runtime", name, ts, dur, thread, corr)


def _dev(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, STREAM, corr)


EVENTS = [
    _span("bench.window", 0, 1000),
    _span("msgs.train_step", 10, 890),
    _span("msgs.preprocess", 20, 80),
    _span("msgs.binning", 100, 200),
    _span("msgs.binning.hist", 150, 100),
    _span("msgs.backward", 400, 300),
    _span("msgs.composite_bwd", 450, 100, AUTOGRAD),
    _span("msgs.update", 700, 150),
    _x("cpu_op", "aten::clone", 905, 25, MAIN),
    _launch("cudaLaunchKernel", 30, 1),
    _dev("k_pre", 40, 50, 1),
    _launch("cudaMemcpyAsync", 60, 2, dur=20),
    _dev("Memcpy HtoD (Pageable -> Device)", 85, 2, 2, "gpu_memcpy"),
    _launch("cudaLaunchKernel", 160, 3),
    _dev("scatter", 170, 100, 3),
    _launch("cudaLaunchKernel", 260, 4),
    _dev("sort", 275, 30, 4),
    _launch("cudaStreamSynchronize", 280, 5, dur=15),
    _launch("cudaLaunchKernel", 460, 6, AUTOGRAD),
    _dev("k_bwd", 470, 60, 6),
    # autograd's thread, under no span of its own: msgs.backward's
    _launch("cudaLaunchKernel", 600, 7, AUTOGRAD),
    _dev("k_pre_bwd", 610, 40, 7),
    _launch("cudaLaunchKernel", 720, 8),
    _dev("k_adam", 730, 20, 8, "gpu_memset"),
    # the benchmark's own copy, under no span; device to device: no wait
    _launch("cudaMemcpyAsync", 910, 9, dur=4),
    _dev("Memcpy DtoD (Device -> Device)", 915, 10, 9, "gpu_memcpy"),
    # a kernel whose launch the trace lost, and one past the window
    _dev("orphan", 950, 5, 99),
    _launch("cudaLaunchKernel", 990, 10),
    _dev("late", 1500, 10, 10),
]


def _write(tmp_path, events, name="t.trace.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"traceEvents": events}))
    return p


@pytest.fixture
def traces(tmp_path, monkeypatch):
    """Where the readers look for the traced window's file:
    build/benchmark/ of a checkout rooted at tmp_path."""
    d = tmp_path / "build" / "benchmark"
    d.mkdir(parents=True)
    monkeypatch.setattr(S, "REPO", tmp_path)
    return d


def test_rows_are_exact(tmp_path):
    sp = S.Spans(S.load_events(_write(tmp_path, EVENTS)))
    assert sp.steps == 1
    r = sp.rows
    assert set(r) == {"msgs.train_step", "msgs.preprocess", "msgs.binning",
                      "msgs.binning.hist", "msgs.backward",
                      "msgs.composite_bwd", "msgs.update"}
    want = {  # host, self host, device, self device, launches, waits, wait
        "msgs.train_step": (0.890, 0.160, 0.302, 0.0, 7, 2, 0.035),
        "msgs.preprocess": (0.080, 0.080, 0.052, 0.052, 2, 1, 0.020),
        "msgs.binning": (0.200, 0.100, 0.130, 0.030, 2, 1, 0.015),
        "msgs.binning.hist": (0.100, 0.100, 0.100, 0.100, 1, 0, 0.0),
        # its child on autograd's thread covers none of its own host time
        "msgs.backward": (0.300, 0.300, 0.100, 0.040, 2, 0, 0.0),
        "msgs.composite_bwd": (0.100, 0.100, 0.060, 0.060, 1, 0, 0.0),
        "msgs.update": (0.150, 0.150, 0.020, 0.020, 1, 0, 0.0),
    }
    for name, (host, self_host, dev, self_dev, launches, waits,
               wait) in want.items():
        row = r[name]
        assert row["calls"] == 1
        assert row["host_ms"] == pytest.approx(host), name
        assert row["self_host_ms"] == pytest.approx(self_host), name
        assert row["device_ms"] == pytest.approx(dev), name
        assert row["self_device_ms"] == pytest.approx(self_dev), name
        assert row["launches"] == launches, name
        assert row["waits"] == waits, name
        assert row["wait_ms"] == pytest.approx(wait), name
    assert r["msgs.preprocess"]["self_waits"] == 1
    assert r["msgs.binning"]["self_wait_ms"] == pytest.approx(0.015)
    assert r["msgs.train_step"]["self_waits"] == 0
    assert sp.wait_ms() == pytest.approx(0.035)
    assert dict(sp.unattributed) == pytest.approx(
        {("aten::clone", "Memcpy DtoD (Device -> Device)"): 0.010})
    assert (sp.missing, sp.device_events) == (1, 9)
    assert sp.missing_ms == pytest.approx(0.005)
    assert sp.device_ms == pytest.approx(0.317)
    assert sp.stage_ms("msgs.backward", "msgs.composite_bwd") == \
        pytest.approx(0.100)
    assert sp.stage_ms("msgs.composite_bwd") == pytest.approx(0.060)
    assert sp.ops[("msgs.binning.hist", "scatter")] == pytest.approx(0.1)
    t = S.table(sp)
    assert [op for op, _ in t["ops"]["msgs.preprocess"]] == [
        "k_pre", "Memcpy HtoD (Pageable -> Device)"]
    assert t["missing_share"] == pytest.approx(1 / 9)
    assert t["rows"]["msgs.binning"]["device_ms"] == pytest.approx(0.130)


def _ctx(path, kind, steps=1):
    return dict(kind=kind, steps=steps, trace=Trace(str(path)))


TRAIN = {"preprocess_ms.train": 0.052, "binning_ms.train": 0.130,
         "backward_ms.train": 0.100, "update_ms.train": 0.020,
         "host_wait_ms.train": 0.035}
SERVE = {"preprocess_ms.serve": 0.052, "binning_ms.serve": 0.130,
         "gather_ms.serve": None, "host_wait_ms.serve": 0.035}


def test_readers(traces):
    p = _write(traces, EVENTS)
    train, render = _ctx(p, "train"), _ctx(p, "render", steps=2)
    for name, want in TRAIN.items():
        assert H._reader(name)(train) == pytest.approx(want), name
        assert H._reader(name)(render) is None, name
    for name, want in SERVE.items():
        got = H._reader(name)(render)
        assert (got is None if want is None
                else got == pytest.approx(want / 2)), name
        assert H._reader(name)(train) is None, name


def test_readers_find_nothing_without_spans_or_device_events(traces):
    no_spans = [e for e in EVENTS if not e["name"].startswith("msgs.")]
    no_device = [e for e in EVENTS if e["cat"] not in S.DEVICE_CATS]
    for i, events in enumerate((no_spans, no_device)):
        p = _write(traces, events, f"{i}.trace.json")
        for name in list(TRAIN) + list(SERVE):
            kind = "train" if name.endswith("train") else "render"
            assert H._reader(name)(_ctx(p, kind)) is None, name


def test_readers_find_the_window_s_file(traces):
    """The newest trace under build/benchmark/ whose window is the
    Trace's own."""
    p = _write(traces, EVENTS, "a.trace.json")
    other = [dict(e, ts=e["ts"] + 1) if e["name"] == "bench.window" else e
             for e in EVENTS]
    q = _write(traces, other, "b.trace.json")
    os.utime(q, (p.stat().st_mtime + 10,) * 2)
    ctx = dict(kind="train", steps=1, trace=Trace(str(p)))
    assert H._reader("binning_ms.train")(ctx) == pytest.approx(0.130)
    ctx = dict(kind="train", steps=1, trace=Trace(str(q)))
    assert H._reader("binning_ms.train")(ctx) is not None
    # a trace under build/benchmark/, none of them the window's: loud
    lost = dict(kind="train", steps=1, trace=Trace(str(p)))
    p.unlink()
    with pytest.raises(LookupError):
        H._reader("binning_ms.train")(lost)
    q.unlink()
    ctx = dict(kind="train", steps=1, trace=Trace.__new__(Trace))
    ctx["trace"].t0, ctx["trace"].t1 = 0.0, 1000.0
    assert H._reader("binning_ms.train")(ctx) is None


def test_the_table_prints(tmp_path, capsys):
    p = _write(tmp_path, EVENTS)
    assert S.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "msgs.binning.hist" in out and "aten::clone" in out
    assert "per step or frame, over 1 " in out
    assert "device events with no launch in the trace: 1 " in out
