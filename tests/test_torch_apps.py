"""The msgs_torch trainer CLI on the CPU.

- `msgs_torch.apps.train` on tests/test_apps.py's fixture scene (as
  tests/test_apps.py:test_train_cli_end_to_end): PLY written, an eval
  record, PSNR > 10, and an npz checkpoint that resumes.
- One MS-GS run on a tiny synthetic scene that reaches all three insert
  episodes (iterations 1010, 1020, 1030 at levels 2, 4, 6) with the
  bf16 gradient variants on.
- `run_insert_episode` against the JAX trainer's from the same state: the
  same selection and number of inserted aggregates, exactly; the state
  within 1e-6·(1+|x|), except the values that come from renders — pixel
  sizes and the inserted log-scales made from them. The inserted
  log-scales move by log(2/clip(v, 0.25, 2)) of the pooled pixel size v,
  which the render parity budget 1e-5 (tests/torch_parity.py TOL_IMAGE)
  holds, so by ≤ 1e-5/0.25; the new rows' pixel-size records are
  footprints of those scales, so they get 1e-5 + 5e-5·max|x|.

The trainer runs use one torch thread: the suite runs several workers at
once, and torch's CPU thread pool slows down many-fold when its threads
contend for the cores with other processes.
"""
import argparse
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.apps import train as jtrain
from msgs.data import dataset as jds
from msgs.kernels.rasterize import RasterSettings as JSettings
from msgs.model.gaussians import GaussianConfig as JConfig
from msgs.model.gaussians import create_from_points as jax_create
from msgs.ms.schedule import MsSchedule as JSchedule
from msgs.train import loop as jloop
from msgs_torch.apps import train as ttrain
from msgs_torch.data import dataset as tds
from msgs_torch.kernels.rasterize import RasterSettings as TSettings
from msgs_torch.ms.schedule import MsSchedule as TSchedule
from msgs_torch.train import loop as tloop
from tests.test_torch_data import fixture_scene  # noqa: F401 (fixture)
from tests.test_torch_structural import assert_close, assert_states


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _log(model):
    return [json.loads(line) for line in
            open(os.path.join(model, "train_log.jsonl"))]


def test_train_cli_end_to_end(fixture_scene, tmp_path):  # noqa: F811
    root, _ = fixture_scene
    out = str(tmp_path / "model")
    common = ["-s", root, "--capacity", "256", "--entry_cap", "4096",
              "--test_interval", "0", "--sh_degree", "1", "--quiet",
              "--device", "cpu", "--disable_gui", "--no_tensorboard"]
    state = ttrain.main(common + [
        "-m", out, "--iterations", "40", "--test_iterations", "40",
        "--save_iterations", "40", "--checkpoint_iterations", "30"])
    assert os.path.exists(os.path.join(
        out, "point_cloud/iteration_40/point_cloud.ply"))
    assert int(state.iteration) == 40
    evals = [r for r in _log(out) if "eval" in r]
    assert evals, "no eval record written"
    psnr = evals[-1]["eval"]["train_s1"]["psnr"]
    assert np.isfinite(psnr) and psnr > 10.0, psnr
    cfg = json.load(open(os.path.join(out, "cfg_args.json")))
    assert cfg["iterations"] == 40 and cfg["sh_degree"] == 1
    # The JAX trainer's keys, and the port's --device and --dist_backend.
    assert set(cfg) == set(vars(jtrain.build_parser().parse_args([]))) | {
        "device", "dist_backend"}
    # Resume from the npz checkpoint.
    resumed = ttrain.main(common + [
        "-m", str(tmp_path / "resumed"), "--iterations", "35",
        "--start_checkpoint", os.path.join(out, "chkpnt30.npz"),
        "--test_iterations", "-1", "--save_iterations", "-1"])
    assert int(resumed.iteration) == 35


def test_train_cli_reaches_insert_episodes(tmp_path):
    """1,031 iterations at 24×24 with 4 views."""
    from msgs_torch.data.synthetic import make_scene
    scene = str(tmp_path / "scene")
    make_scene(scene, n_views=4, n_test=1, width=24, height=24,
               n_gaussians=500, device="cpu", quiet=True)
    out = str(tmp_path / "model")
    state = ttrain.main([
        "-s", scene, "-m", out, "--eval", "--ms_train",
        "--ms_train_max_scale", "6", "--filter_small", "--insert_large",
        "--bwd_bf16", "--fast_grads", "--capacity", "1024",
        "--entry_cap", "4096", "--sh_degree", "0",
        "--iterations", "1031", "--densify_from_iter", "100",
        "--densification_interval", "200",
        "--densify_until_iter", "600", "--opacity_reset_interval", "400",
        "--test_iterations", "1031", "--test_interval", "0",
        "--save_iterations", "-1", "--quiet", "--device", "cpu",
        "--disable_gui", "--no_tensorboard"])
    log = _log(out)
    events = [r for r in log if "event" in r]
    ins = [(r["it"], r["lvl"]) for r in events if r["event"] == "insert"]
    assert ins == [(1010, 2), (1020, 4), (1030, 6)], ins
    assert any(r["event"] == "insert" and r["n_inserted"] > 0
               for r in events)
    assert any(r["event"] == "densify" and r["live_after"] != r["live_before"]
               for r in events)
    assert any(r["event"] == "reset" for r in events)
    lvls = state.gaussians.target_reso_lvl[state.gaussians.live]
    assert int((lvls > 0).sum()) > 0
    for k, v in state.gaussians.params().items():
        assert torch.isfinite(v).all(), k
    ev = [r for r in log if "eval" in r][-1]["eval"]
    assert set(ev) >= {f"test_s{2 ** i}" for i in range(7)}


def test_run_insert_episode_matches_jax(fixture_scene):  # noqa: F811
    root, _ = fixture_scene
    rng = np.random.default_rng(4)
    n = 80
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(-0.3, 0.3, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    cfg = JConfig(sh_degree=0, reso_lvls=4, capacity=256)
    jst = jax_create(cfg, pts, cols)
    jstate = jloop.init_train_state(jst)
    arrays = {"gaussians": {k: np.asarray(v)
                            for k, v in jst._asdict().items()},
              "mu": {k: np.asarray(v) for k, v in jstate.adam.mu.items()},
              "nu": {k: np.asarray(v) for k, v in jstate.adam.nu.items()},
              "count": np.asarray(jstate.adam.count),
              "iteration": np.asarray(jstate.iteration)}
    tstate = tloop.train_state_from_numpy(arrays, device="cpu")
    jscene = jds.load_scene(root, eval_split=False)
    tscene = tds.load_scene(root, eval_split=False, device="cpu")
    args = argparse.Namespace()
    kw = dict(max_reso_pow=3, ms_train=True, insert_large=True)
    jsched, tsched = JSchedule(**kw), TSchedule(**kw)
    jset = JSettings(backend="pallas", entry_cap=1 << 13, filter_small=True,
                     filter_large=True, image_grads_only=True)
    tset = TSettings(entry_cap=1 << 13, filter_small=True, filter_large=True,
                     image_grads_only=True)

    jout = jtrain.run_insert_episode(jstate, jscene, jsched, 3, cfg, jset,
                                     jscene.cameras_extent, args)
    tout, n_ins, n_sel = ttrain.run_insert_episode(
        tstate, tscene, tsched, 3, cfg, tset, tscene.cameras_extent, args)
    jg, tg = jout.gaussians, tout.gaussians
    n_j = int(jnp.sum(jg.live)) - n
    assert n_ins == n_j > 1 and n_sel >= n_ins
    new = np.asarray(jg.target_reso_lvl) == 3
    assert int(new.sum()) == n_ins
    px_tol = 1e-5 + 5e-5 * float(np.abs(np.asarray(jg.max_pixel_sizes)).max())
    assert_states(jg, tg, extra={"max_pixel_sizes": px_tol,
                                 "min_pixel_sizes": px_tol,
                                 "scaling": 1e-5 / 0.25})
    for k in jout.adam.mu:
        assert_close(np.asarray(jout.adam.mu[k]) == 0,
                     tout.adam.mu[k] == 0, f"zeroed {k}")
