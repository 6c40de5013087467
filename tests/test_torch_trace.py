"""The stage spans of msgs_torch (msgs_torch/trace.py) on the CPU: under
torch.profiler one `eval_render` and one `train_step` export a Chrome trace
holding every `msgs.*` span of the render and the step, nested as the
stages are; with no profiler running `span` is the shared no-op and no
record_function is entered. The scene is a tiny MS-GS model (64 Gaussians
at 48×40, SH degree 1) made with torch alone."""
import json

import numpy as np
import pytest
import torch

from msgs_torch import trace as T
from msgs_torch.core.camera import make_camera
from msgs_torch.core.sh import rgb2sh
from msgs_torch.core.transforms import inverse_sigmoid
from msgs_torch.kernels.rasterize import RasterSettings
from msgs_torch.model.gaussians import GaussianConfig, empty_state
from msgs_torch.train import loop
from msgs_torch.train.optimizer import OptimParams

W, H, N, CAP = 48, 40, 64, 128
CFG = GaussianConfig(sh_degree=1, reso_lvls=2, capacity=CAP)

RENDER_SPANS = {"msgs.eval_render", "msgs.preprocess", "msgs.binning",
                "msgs.binning.count", "msgs.binning.hist",
                "msgs.binning.emit", "msgs.binning.sort", "msgs.gather",
                "msgs.composite"}
STEP_SPANS = (RENDER_SPANS - {"msgs.eval_render"}) | {
    "msgs.train_step", "msgs.loss", "msgs.backward", "msgs.composite_bwd",
    "msgs.gather_vjp", "msgs.update", "msgs.adam"}
# child → parent, where the stage nests in another one
PARENT = {"msgs.binning.count": "msgs.binning",
          "msgs.binning.hist": "msgs.binning",
          "msgs.binning.emit": "msgs.binning",
          "msgs.binning.sort": "msgs.binning",
          "msgs.adam": "msgs.update"}


def _scene():
    g = torch.Generator().manual_seed(0)
    u = lambda *s: torch.rand(s, generator=g)
    st = empty_state(CFG, "cpu")
    xyz = torch.cat([u(N, 2) * 2.0 - 1.0, 3.0 + 2.0 * u(N, 1)], dim=1)
    fields = dict(xyz=xyz, features_dc=rgb2sh(u(N, 3))[:, None, :],
                  features_rest=0.05 * torch.randn((N, 3, 3), generator=g),
                  scaling=torch.log(0.03 + 0.05 * u(N, 3)),
                  rotation=torch.randn((N, 4), generator=g),
                  opacity=inverse_sigmoid(0.3 + 0.6 * u(N))[:, None])
    for k, v in fields.items():
        getattr(st, k)[:N] = v
    st.live[:N] = True
    st = st._replace(active_sh_degree=torch.tensor(1, dtype=torch.int32))
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.8, W, H, device="cpu")
    return st, cam


def _frame_and_step(st, cam):
    settings = RasterSettings(entry_cap=1 << 12)
    gt = loop.eval_render(st, cam, cfg=CFG, settings=settings).image
    state = loop.init_train_state(st._replace(
        features_dc=st.features_dc + 0.1))
    loop.train_step(state, cam, gt, cfg=CFG, op=OptimParams(),
                    settings=settings._replace(image_grads_only=True),
                    reso_lvl=0, spatial_lr_scale=1.0)


def _spans(path):
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in ev
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("msgs.")]


def _inside(child, parents):
    _, a, b, tid = child
    return any(p[1] <= a and b <= p[2] and p[3] == tid for p in parents)


def test_spans_in_a_traced_frame_and_step(tmp_path):
    st, cam = _scene()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame_and_step(st, cam)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(path)
    names = {s[0] for s in spans}
    assert RENDER_SPANS | STEP_SPANS <= names
    by = lambda n: [s for s in spans if s[0] == n]
    frame, step = by("msgs.eval_render"), by("msgs.train_step")
    assert len(frame) == 1 and len(step) == 1
    # Every stage of the frame lies in the frame, and every stage of the
    # step in the step, with no stage of one in the other.
    for n in RENDER_SPANS - {"msgs.eval_render"}:
        assert [s for s in by(n) if _inside(s, frame)], n
        assert [s for s in by(n) if _inside(s, step)], n
    for n in STEP_SPANS - RENDER_SPANS - {"msgs.train_step"}:
        assert by(n) and not [s for s in by(n) if _inside(s, frame)], n
    for child, parent in PARENT.items():
        assert all(_inside(s, by(parent)) for s in by(child)), child
    # The backward's stages run inside msgs.backward (on the CPU autograd
    # runs them on the calling thread).
    for n in ("msgs.composite_bwd", "msgs.gather_vjp"):
        assert all(_inside(s, by("msgs.backward")) for s in by(n)), n
    # The render's stages follow one another: none nests in another.
    stages = ("msgs.binning", "msgs.gather", "msgs.composite")
    for n in stages + ("msgs.preprocess",):
        for s in by(n):
            assert not any(_inside(s, by(m)) for m in stages if m != n), n


def test_no_record_function_without_a_profiler(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert T.span("msgs.binning") is T.span("msgs.train_step")
    with T.span("msgs.binning") as inner:
        assert inner is None
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    st, cam = _scene()
    _frame_and_step(st, cam)
    assert entered == []
    # The counter counts: under a profiler the same calls enter the spans.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _frame_and_step(st, cam)
    assert RENDER_SPANS | STEP_SPANS <= set(entered)


@pytest.mark.parametrize("row_tight", [False, True])
def test_other_binning_paths_take_the_child_names(tmp_path, row_tight):
    st, cam = _scene()
    settings = RasterSettings(entry_cap=1 << 12, row_tight=row_tight)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loop.eval_render(st, cam, cfg=CFG, settings=settings)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(path)
    binning = [s for s in spans if s[0] == "msgs.binning"]
    kids = {s[0] for s in spans if s[0].startswith("msgs.binning.")
            and _inside(s, binning)}
    assert kids == {"msgs.binning.count", "msgs.binning.hist",
                    "msgs.binning.emit", "msgs.binning.sort"}
