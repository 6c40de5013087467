"""The port's offline evaluation apps against the JAX package's, on the CPU.

One tiny model trained by each package on tests/test_apps.py's fixture
scene (6 views at 64×64, train split only; the port's run with a synthetic
LPIPS weight file in $MSGS_LPIPS_WEIGHTS, so its final evaluation logs
LPIPS), then:

- render: JAX's app (--backend reference) and the port's (--device cpu) on
  the same PLY, for both models. The decoded PNGs are equal, except by 1
  where JAX's value·255 lies within 1e-5·255 of an integer (the apps
  truncate, and renders agree to 1e-5);
- metrics: both apps on the same PNG folders, with synthetic LPIPS weights:
  the same keys; PSNR within 1e-4 dB, SSIM within 1e-6 (the standing SSIM
  budget), LPIPS within rtol 2e-4;
- eval_scales: both apps on the PLY and on the npz (--checkpoint): the same
  keys; l1 within 1e-6, PSNR within 1e-3 dB, SSIM within 1e-6;
- collect_result_images: the same CSV rows, PSNR within 1e-3 dB;
- collect_results on data/quality/: the same CSV and LaTeX bytes;
- full_eval and train_all with each package's train, render and metrics
  `main` replaced by a recorder: the same argv lists, scene for scene (the
  port's with `--device cpu` added);
- the supervisor: `latest_checkpoint`, the command it builds, and a CPU
  run under it that resumes from the port model's checkpoint and ends.
"""
import csv
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from msgs.apps import collect_result_images as j_cri
from msgs.apps import collect_results as j_cr
from msgs.apps import eval_scales as j_es
from msgs.apps import full_eval as j_fe
from msgs.apps import metrics as j_metrics
from msgs.apps import render as j_render
from msgs.apps import train as j_train
from msgs.apps import train_all as j_ta
from msgs_torch.apps import collect_result_images as t_cri
from msgs_torch.apps import collect_results as t_cr
from msgs_torch.apps import eval_scales as t_es
from msgs_torch.apps import full_eval as t_fe
from msgs_torch.apps import metrics as t_metrics
from msgs_torch.apps import render as t_render
from msgs_torch.apps import train as t_train
from msgs_torch.apps import train_all as t_ta
from msgs_torch.eval.lpips import WEIGHTS_ENV
from msgs_torch.tools import supervisor
from tests.test_lpips import _synthetic_weights
from tests.test_torch_data import fixture_scene  # noqa: F401 (fixture)
from tests.torch_parity import assert_pngs_match, one_torch_thread, \
    train_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 10


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_synth.npz")
    np.savez(path, **_synthetic_weights(np.random.default_rng(7)))
    return path


@pytest.fixture(scope="module")
def models(fixture_scene, lpips_weights, tmp_path_factory):  # noqa: F811
    """{"jax": model dir, "torch": model dir}, each trained ITERS
    iterations by its own package."""
    root, _ = fixture_scene
    base = tmp_path_factory.mktemp("models")
    out = {"jax": str(base / "jax"), "torch": str(base / "torch")}
    train_tiny("jax", root, out["jax"], ITERS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(WEIGHTS_ENV, lpips_weights)
        train_tiny("torch", root, out["torch"], ITERS)
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _jax_float_renders(model):
    """The [0, 1] images JAX's render app quantises, for the train split
    (msgs/apps/render.py's loading and settings, --entry_cap 4096)."""
    from msgs.apps.config import load_cfg
    from msgs.data.dataset import load_scene
    from msgs.data.ply import read_ply
    from msgs.kernels.rasterize import RasterSettings
    from msgs.model.gaussians import GaussianConfig
    from msgs.train import loop as L
    from msgs.train.checkpoint import load_ply_snapshot
    saved = load_cfg(model)
    ply = os.path.join(model, "point_cloud", f"iteration_{ITERS}",
                       "point_cloud.ply")
    n = len(read_ply(ply)["x"])
    cfg = GaussianConfig(sh_degree=int(saved["sh_degree"]), reso_lvls=8,
                         capacity=1 << max(int(n).bit_length(), 10))
    st = L.init_train_state(load_ply_snapshot(ply, cfg))
    scene = load_scene(saved["source_path"], eval_split=False)
    settings = RasterSettings(backend="reference", entry_cap=4096)
    return [np.asarray(L.eval_render(st, v.camera(1.0), cfg=cfg,
                                     settings=settings,
                                     bg=jnp.zeros((3,))).image)
            for v in scene.train_views]


def test_trainer_final_eval_logs_lpips(models):
    log = [json.loads(line) for line in
           open(os.path.join(models["torch"], "train_log.jsonl"))]
    ev = [r for r in log if "eval" in r][-1]
    assert ev["it"] == ITERS
    for m in ev["eval"].values():
        assert np.isfinite(m["lpips"]) and m["lpips"] > 0.0
    # Without a weight file the report has no LPIPS, as in JAX.
    jlog = [json.loads(line) for line in
            open(os.path.join(models["jax"], "train_log.jsonl"))]
    jev = [r for r in jlog if "eval" in r][-1]["eval"]
    assert set(jev) == set(ev["eval"])
    for k, m in jev.items():
        assert set(ev["eval"][k]) == set(m) | {"lpips"}


@pytest.mark.parametrize("trained_by", ["jax", "torch"])
def test_render_matches_jax(models, trained_by, tmp_path):
    a = _copy(models[trained_by], tmp_path / "a")
    b = _copy(models[trained_by], tmp_path / "b")
    j_render.main(["-m", a, "--skip_test", "--backend", "reference",
                   "--entry_cap", "4096"])
    with one_torch_thread():
        t_render.main(["-m", b, "--skip_test", "--device", "cpu",
                       "--entry_cap", "4096"])
    sub = os.path.join("train", f"ours_{ITERS}")
    assert_pngs_match(os.path.join(a, sub, "gt"), os.path.join(b, sub, "gt"))
    assert_pngs_match(os.path.join(a, sub, "renders"),
                      os.path.join(b, sub, "renders"),
                      floats_a=_jax_float_renders(a))


def test_metrics_match_jax(models, lpips_weights, tmp_path, monkeypatch):
    a = _copy(models["jax"], tmp_path / "a")
    j_render.main(["-m", a, "--skip_test", "--backend", "reference",
                   "--entry_cap", "4096"])
    b = _copy(a, tmp_path / "b")
    monkeypatch.setenv(WEIGHTS_ENV, lpips_weights)
    j_metrics.main(["-m", a, "--splits", "train"])
    with one_torch_thread():
        t_metrics.main(["-m", b, "--splits", "train", "--device", "cpu"])
    tol = {"PSNR": dict(atol=1e-4, rtol=0), "SSIM": dict(atol=1e-6, rtol=0),
           "LPIPS": dict(atol=0, rtol=2e-4)}
    for name in ("results.json", "per_view.json"):
        ja = json.load(open(os.path.join(a, name)))
        tb = json.load(open(os.path.join(b, name)))
        assert list(ja) == list(tb) == [f"ours_{ITERS}"]
        for method, entry in ja.items():
            assert list(entry) == list(tb[method]) == ["SSIM", "PSNR",
                                                       "LPIPS"]
            for key, v in entry.items():
                if isinstance(v, dict):
                    assert list(v) == list(tb[method][key])
                    np.testing.assert_allclose(
                        list(tb[method][key].values()), list(v.values()),
                        **tol[key])
                else:
                    np.testing.assert_allclose(tb[method][key], v,
                                               **tol[key])


@pytest.mark.parametrize("mode", ["ply", "checkpoint"])
def test_eval_scales_match_jax(models, mode, tmp_path):
    a = _copy(models["jax"], tmp_path / "a")
    b = _copy(models["jax"], tmp_path / "b")
    common = ["--scales", "1", "2", "--entry_cap", "4096",
              "--n_train_views", "2"]
    if mode == "checkpoint":
        ck = f"chkpnt{ITERS}.npz"
        ja = common + ["--checkpoint", os.path.join(a, ck)]
        tb = common + ["--checkpoint", os.path.join(b, ck)]
    else:
        ja = tb = common
    j_es.main(["-m", a, "--backend", "reference"] + ja)
    with one_torch_thread():
        t_es.main(["-m", b, "--device", "cpu"] + tb)
    name = f"eval_scales_{ITERS}.json"
    want = json.load(open(os.path.join(a, name)))
    got = json.load(open(os.path.join(b, name)))
    assert list(want) == list(got) == ["train_s1", "train_s2"]
    for k, w in want.items():
        g = got[k]
        assert list(w) == list(g)
        assert abs(g["l1"] - w["l1"]) <= 1e-6
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3
        assert abs(g["ssim"] - w["ssim"]) <= 1e-6


def test_collect_result_images_match_jax(models, tmp_path):
    root_a, root_b = tmp_path / "a", tmp_path / "b"
    for r in (root_a, root_b):
        for method, trained_by in (("base", "jax"), ("ms", "torch")):
            _copy(models[trained_by], r / method)
    common = ["--scales", "1", "4", "--views", "0", "--entry_cap", "4096"]
    j_cri.main(["-m", str(root_a), "--backend", "reference"] + common)
    with one_torch_thread():
        t_cri.main(["-m", str(root_b), "--device", "cpu"] + common)
    rows = []
    for r in (root_a, root_b):
        with open(r / "figures" / "per_image_psnr.csv") as f:
            rows.append(list(csv.reader(f)))
    ja, tb = rows
    assert ja[0] == tb[0] == ["view", "scale", "method", "psnr"]
    assert len(ja) == len(tb) == 1 + 4
    for x, y in zip(ja[1:], tb[1:]):
        assert x[:3] == y[:3]
        assert abs(float(x[3]) - float(y[3])) <= 1e-3
    from msgs_torch.data.image import read_png
    assert (read_png(str(root_a / "figures" / "view000.png")).shape
            == read_png(str(root_b / "figures" / "view000.png")).shape)


QUALITY = os.path.join(REPO, "data", "quality")


@pytest.mark.parametrize("run", [""] + sorted(os.listdir(QUALITY)))
def test_collect_results_match_jax(run, tmp_path):
    """Each run of data/quality/ and the folder as a whole: the same CSV
    bytes, and the same LaTeX bytes or the same error. The runs trained
    without --ms_train (base, base_r4, fast_grads12k) log their scales as
    floats ("test_s1.0"), on which both packages' LaTeX table stops at
    int("1.0"), so it does for the whole folder too."""
    out = {}
    for name, mod in (("jax", j_cr), ("torch", t_cr)):
        csv_p, tex_p = tmp_path / f"{name}.csv", tmp_path / f"{name}.tex"
        argv = ["-m", os.path.join(QUALITY, run), "--csv", str(csv_p)]
        mod.main(argv)
        try:
            mod.main(argv + ["--latex", str(tex_p)])
            tex = tex_p.read_bytes()
        except ValueError as e:
            tex = repr(e)
        out[name] = (csv_p.read_bytes(), tex)
    assert out["jax"] == out["torch"]
    assert out["jax"][0].count(b"\n") > 7


def _recorders(monkeypatch, package):
    calls = []
    mods = ((j_train, j_render, j_metrics) if package == "jax"
            else (t_train, t_render, t_metrics))
    for name, mod in zip(("train", "render", "metrics"), mods):
        monkeypatch.setattr(mod, "main",
                            lambda argv=None, _n=name: calls.append(
                                (_n, list(argv))))
    return calls


@pytest.mark.parametrize("flags", [["--ms", "--sh_degree", "1"],
                                   ["--skip_training"]])
def test_full_eval_runs_what_jax_runs(flags, tmp_path, monkeypatch):
    for d in ("m360/bicycle", "m360/room", "tat/truck", "db/drjohnson"):
        os.makedirs(tmp_path / d)
    argv = ["--mipnerf360", str(tmp_path / "m360"), "--tanksandtemples",
            str(tmp_path / "tat"), "--deepblending", str(tmp_path / "db"),
            "--output_path", str(tmp_path / "out")] + flags
    want = _recorders(monkeypatch, "jax")
    j_fe.main(argv)
    got = _recorders(monkeypatch, "torch")
    t_fe.main(argv + ["--device", "cpu"])
    assert len(want) == len(got) > 0
    assert [n for n, _ in want] == [n for n, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert g == w + ["--device", "cpu"]


def test_train_all_runs_what_jax_runs(tmp_path, monkeypatch):
    assert t_ta.METHOD_DICT == j_ta.METHOD_DICT
    assert t_ta.DATASET_MAX_SCALE == j_ta.DATASET_MAX_SCALE
    root = tmp_path / "tandt"
    for s in ("train", "truck"):
        os.makedirs(root / s)
    argv = ["-s", str(root), "-m", str(tmp_path / "out"), "--methods",
            *sorted(j_ta.METHOD_DICT), "--sh_degree", "1"]
    want = _recorders(monkeypatch, "jax")
    j_ta.main(argv)
    got = _recorders(monkeypatch, "torch")
    t_ta.main(argv + ["--device", "cpu"])
    assert len(want) == len(got) == 2 * len(j_ta.METHOD_DICT)
    for (_, w), (_, g) in zip(want, got):
        assert g == w + ["--device", "cpu"]


def test_supervisor_resumes_and_finishes(models, fixture_scene,  # noqa: F811
                                         tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    os.makedirs(ck)
    assert supervisor.latest_checkpoint(str(ck)) is None
    for it in (5, 30, 100):
        (ck / f"chkpnt{it}.npz").write_bytes(b"")
    assert supervisor.latest_checkpoint(str(ck)) == str(ck / "chkpnt100.npz")
    args = ["-s", "scene", "-m", str(ck), "--iterations", "7"]
    assert supervisor.train_command(args, str(ck)) == [
        sys.executable, "-m", "msgs_torch.apps.train", *args,
        "--start_checkpoint", str(ck / "chkpnt100.npz")]
    with pytest.raises(SystemExit):
        supervisor.model_path_of(["-s", "scene"])

    # A CPU run under the supervisor, from the port model's chkpnt10.
    model = _copy(models["torch"], tmp_path / "model")
    root, _ = fixture_scene
    monkeypatch.chdir(REPO)
    rc = supervisor.main([
        "--stall_sec", "120", "--max_restarts", "0", "--",
        "-s", root, "-m", model, "--iterations", "12", "--capacity", "256",
        "--entry_cap", "4096", "--sh_degree", "1", "--test_iterations", "-1",
        "--save_iterations", "12", "--quiet", "--device", "cpu",
        "--disable_gui", "--no_tensorboard"])
    assert rc == 0
    log = open(os.path.join(model, "supervisor_train.log")).read()
    assert f"Resumed from {os.path.join(model, 'chkpnt10.npz')} at 10" in log
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_12",
                                       "point_cloud.ply"))
