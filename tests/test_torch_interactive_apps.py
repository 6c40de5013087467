"""The port's interactive and conversion apps against the JAX package's, on
the CPU: viewer, traj, video_tools, network_gui (alone and in the trainer)
and convert.

One tiny model trained by the JAX trainer on tests/test_apps.py's fixture
scene (6 views at 64×64); the JAX apps render its PLY with --backend
reference, the port's with --device cpu. Decoded 8-bit outputs are equal,
except by 1 where JAX's value·255 lies within the field's budget·255 of an
integer (the apps truncate): image 1e-5, acc and depth 1e-4 over the
maximum they are normalised by. Poses, the nearest resize, the concat and
cut_and_stack outputs and convert's command lines are exactly equal.
There is no ffmpeg plugin here, so the traj runs replace imageio's
mimwrite with a recorder (and the port's writer check with a no-op), and
video_tools runs on .gif files.
"""
import json
import os
import socket
import struct
import sys
import threading
import types

import numpy as np
import pytest
import torch

from msgs.apps import convert as j_convert
from msgs.apps import network_gui as j_gui
from msgs.apps import train as j_train
from msgs.apps import traj as j_traj
from msgs.apps import video_tools as j_vt
from msgs.apps import viewer as j_viewer
from msgs.core.camera import make_camera as j_make_camera
from msgs.data.dataset import load_scene as j_load_scene
from msgs.train import loop as JL
from msgs_torch.apps import convert as t_convert
from msgs_torch.apps import network_gui as t_gui
from msgs_torch.apps import train as t_train
from msgs_torch.apps import traj as t_traj
from msgs_torch.apps import video_tools as t_vt
from msgs_torch.apps import viewer as t_viewer
from msgs_torch.data.dataset import load_scene as t_load_scene
from msgs_torch.data.image import read_png
from msgs_torch.train import loop as TL
from tests.test_torch_data import fixture_scene  # noqa: F401 (fixture)
from tests.torch_parity import TOL_DEPTH, TOL_IMAGE, assert_same, \
    assert_uint8_match, one_torch_thread, rotation, train_tiny

ITERS = 10
ENTRY_CAP = ["--entry_cap", "4096"]


@pytest.fixture(scope="module")
def model(fixture_scene, tmp_path_factory):  # noqa: F811
    """A model dir trained ITERS iterations by the JAX trainer."""
    root, _ = fixture_scene
    out = str(tmp_path_factory.mktemp("model") / "jax")
    train_tiny("jax", root, out, ITERS)
    return out


def _record_renders(monkeypatch, loop):
    """Every output of loop.eval_render from now on, in call order."""
    outs = []
    orig = loop.eval_render

    def rec(*a, **k):
        out = orig(*a, **k)
        outs.append(out)
        return out
    monkeypatch.setattr(loop, "eval_render", rec)
    return outs


def _normalised(x):
    x = np.asarray(x)
    return x / max(x.max(), 1e-6)


# --- traj --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["circle", "spiral"])
def test_trajectory_poses_match_jax(fixture_scene, kind):  # noqa: F811
    root, _ = fixture_scene
    jv = j_load_scene(root, eval_split=False).train_views
    tv = t_load_scene(root, eval_split=False, device="cpu").train_views
    gen = {"circle": (j_traj.circle_trajectory, t_traj.circle_trajectory),
           "spiral": (j_traj.spiral_trajectory, t_traj.spiral_trajectory)}
    jp, tp = gen[kind][0](jv, 7), gen[kind][1](tv, 7)
    assert len(jp) == len(tp) == 7
    for (jr, jt), (tr, tt) in zip(jp, tp):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("src, dst", [
    ((64, 64), (1920, 1080)), ((32, 48), (64, 64)), ((16, 16), (100, 37)),
    ((48, 112), (721, 1599)), ((7, 5), (3, 2)), ((240, 128), (253, 131))])
def test_nearest_resize_matches_cv2(src, dst):
    """Exactly cv2.INTER_NEAREST, at ratios whose src/dst in double
    precision differs from OpenCV's 1/(dst/src) in the last bit (an index
    computed from src/dst differs at some of these sizes)."""
    import cv2
    img = np.random.default_rng(0).random((*src[::-1], 3)).astype(np.float32)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(t_traj.nearest_resize(img, *dst), want)


def _record_videos(monkeypatch):
    """{path: (frames, fps)} of every imageio.v2.mimwrite from now on."""
    import imageio.v2 as imageio
    got = {}

    def mimwrite(path, frames, fps=None, **kw):
        got[path] = ([np.array(f) for f in frames], fps)
    monkeypatch.setattr(imageio, "mimwrite", mimwrite)
    return got


def test_traj_matches_jax(model, tmp_path, monkeypatch):
    videos = _record_videos(monkeypatch)
    monkeypatch.setattr(t_vt, "check_video_writer", lambda path: None)
    jouts = _record_renders(monkeypatch, JL)
    common = ["-m", model, "--n_frames", "6", "--max_scale", "4",
              "--anti_alias", *ENTRY_CAP]
    ja, tb = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_traj.main(common + ["--out_dir", ja, "--backend", "reference"])
    with one_torch_thread():
        t_traj.main(common + ["--out_dir", tb, "--device", "cpu"])
    jf, jfps = videos[os.path.join(ja, "trajectory.mp4")]
    tf, tfps = videos[os.path.join(tb, "trajectory.mp4")]
    assert jfps == tfps == 30 and len(jf) == len(tf) == len(jouts) == 6
    assert {o.image.shape[:2] for o in jouts} == {(64, 64), (32, 32),
                                                  (16, 16)}
    for i, (a, b, o) in enumerate(zip(jf, tf, jouts)):
        floats = t_traj.nearest_resize(np.clip(np.asarray(o.image), 0, 1),
                                       64, 64)
        assert_uint8_match(a, b, floats, TOL_IMAGE, f"frame {i}")
    for d in (ja, tb):
        lines = open(os.path.join(d, "frame_times.txt")).read().split()
        assert len(lines) == 6 and all(float(x) > 0 for x in lines)


def test_traj_stops_before_rendering_without_an_encoder(model, tmp_path,
                                                        monkeypatch):
    """No mp4 plugin imports: the app raises, naming imageio[ffmpeg],
    before the first frame (the JAX app fails after the last)."""
    for mod in ("imageio_ffmpeg", "av"):
        monkeypatch.setitem(sys.modules, mod, None)   # import raises
    for mod in ("imageio.plugins.ffmpeg", "imageio.plugins.pyav"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    outs = _record_renders(monkeypatch, TL)
    with pytest.raises(RuntimeError, match=r"imageio\[ffmpeg\]"):
        t_traj.main(["-m", model, "--n_frames", "3", "--device", "cpu",
                     "--out_dir", str(tmp_path / "t"), *ENTRY_CAP])
    assert outs == []
    t_vt.check_video_writer(str(tmp_path / "fine.gif"))   # pillow writes


# --- viewer ------------------------------------------------------------------

@pytest.mark.parametrize("reso", ["1", "2"])
def test_viewer_headless_matches_jax(model, reso, tmp_path, monkeypatch):
    jouts = _record_renders(monkeypatch, JL)
    common = ["-m", model, "--anti_alias", "--reso_scale", reso, *ENTRY_CAP]
    ja, tb = tmp_path / "jax", tmp_path / "torch"
    j_viewer.main(common + ["--out_dir", str(ja), "--backend", "reference"])
    with one_torch_thread():
        t_viewer.main(common + ["--out_dir", str(tb), "--device", "cpu"])
    (o,) = jouts
    acc, depth = np.asarray(o.acc_pixel_size), np.asarray(o.depth)
    floats = {"view.png": (np.asarray(o.image), TOL_IMAGE),
              "acc.png": (_normalised(acc), TOL_DEPTH / max(acc.max(), 1e-6)),
              "depth.png": (_normalised(depth),
                            TOL_DEPTH / max(depth.max(), 1e-6))}
    assert read_png(str(ja / "view.png")).shape[0] == 64 // int(reso)
    for name, (f, tol) in floats.items():
        assert_uint8_match(read_png(str(ja / name)), read_png(str(tb / name)),
                           f, tol, name)


def _stub_cv2(monkeypatch, keys):
    """A cv2 module in sys.modules whose waitKey plays back `keys` and whose
    imshow records (window, image)."""
    shown = []
    keys = iter(keys)
    cv2 = types.ModuleType("cv2")
    cv2.imshow = lambda name, a: shown.append((name, np.array(a)))
    cv2.waitKey = lambda delay: next(keys)
    cv2.destroyAllWindows = lambda: None
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    return shown


def test_viewer_key_loop_matches_jax(model, tmp_path, monkeypatch):
    """The --display loop through a scripted cv2: every step's three
    windows, and the frame saved by p."""
    keys = [ord(c) for c in "wi-;[p"] + [t_viewer.ESC]
    common = ["-m", model, "--display", "--anti_alias", *ENTRY_CAP]
    ja, tb = tmp_path / "jax", tmp_path / "torch"
    jshown = _stub_cv2(monkeypatch, keys)
    j_viewer.main(common + ["--out_dir", str(ja), "--backend", "reference"])
    tshown = _stub_cv2(monkeypatch, keys)
    with one_torch_thread():
        t_viewer.main(common + ["--out_dir", str(tb), "--device", "cpu"])
    assert len(jshown) == len(tshown) == 3 * len(keys)
    for (jn, ja_), (tn, ta) in zip(jshown, tshown):
        assert jn == tn
        assert_same(ja_, ta, TOL_IMAGE if jn == "render" else TOL_DEPTH, jn)
    assert jshown[3 * 3 + 0][1].shape[:2] == (32, 32)    # after '-'
    render_at_p = jshown[3 * keys.index(ord("p"))][1][..., ::-1]
    assert_uint8_match(read_png(str(ja / "frame.png")),
                       read_png(str(tb / "frame.png")), render_at_p,
                       TOL_IMAGE, "frame.png")


class _FakeOut:
    def __init__(self, h, w, lib):
        self.image = lib.zeros((h, w, 3)) + 0.5
        self.acc_pixel_size = lib.ones((h, w))
        self.depth = lib.ones((h, w))


def test_viewer_keys_match_jax(model, tmp_path, monkeypatch):
    """Every key's effect, renders stubbed: the pose and size of each
    camera and the fade and scale modifier of each render, in order, equal
    to the JAX loop's; the clamps of -, =, ;, ', [ reached."""
    import msgs.core.camera as jcam
    import msgs_torch.core.camera as tcam
    keys = "wsadqeikjlx" + "-" * 8 + "=" * 9 + ";" * 12 + "'" * 22 + \
        "[" * 11 + "]]" + "p"
    keys = [ord(c) for c in keys] + [255, t_viewer.ESC]
    calls = {"jax": [], "torch": []}

    def recorder(pkg, make):
        def rec_cam(R, T, fovx, fovy, w, h, **kw):
            calls[pkg].append(("cam", R.copy(), T.copy(), fovx, fovy, w, h))
            return (h, w)

        def rec_render(state, cam, *, fade_size, scale_modifier, **kw):
            calls[pkg].append(("render", fade_size, scale_modifier))
            return make(*cam)
        return rec_cam, rec_render

    args = ["-m", model, "--display", *ENTRY_CAP]
    for pkg, cam_mod, loop, make, main in (
            ("jax", jcam, JL, lambda h, w: _FakeOut(h, w, np),
             j_viewer.main),
            ("torch", tcam, TL, lambda h, w: _FakeOut(h, w, torch),
             t_viewer.main)):
        rec_cam, rec_render = recorder(pkg, make)
        monkeypatch.setattr(cam_mod, "make_camera", rec_cam)
        monkeypatch.setattr(loop, "eval_render", rec_render)
        _stub_cv2(monkeypatch, keys)
        extra = ["--device", "cpu"] if pkg == "torch" else []
        main(args + ["--out_dir", str(tmp_path / pkg)] + extra)
    j, t = calls["jax"], calls["torch"]
    assert len(j) == len(t) == 2 * len(keys)
    for a, b in zip(j, t):
        assert a[0] == b[0] and len(a) == len(b)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(y, x)
    sizes = {c[5] for c in j if c[0] == "cam"}
    fades = {c[1] for c in j if c[0] == "render"}
    mods = {c[2] for c in j if c[0] == "render"}
    assert 16 in sizes and 64 in sizes
    assert {0.0, 2.0} <= fades and 0.1 in mods
    assert_uint8_match(read_png(str(tmp_path / "jax" / "frame.png")),
                       read_png(str(tmp_path / "torch" / "frame.png")))


# --- video_tools -------------------------------------------------------------

def _images(rng, n=3):
    return [rng.integers(0, 256, (20 + 3 * i, 30 - 2 * i, 3), dtype=np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("ext", ["png", "gif"])
def test_concat_images_matches_jax(tmp_path, ext):
    import imageio.v2 as imageio
    paths = []
    for i, img in enumerate(_images(np.random.default_rng(1))):
        paths.append(str(tmp_path / f"in{i}.{ext}"))
        imageio.imwrite(paths[-1], img)
    for cols in (None, 2):
        ja, tb = (str(tmp_path / f"{p}{cols}.{ext}") for p in ("j", "t"))
        j_vt.concat_images(paths, ja, cols)
        t_vt.concat_images(paths, tb, cols)
        a, b = imageio.imread(ja), imageio.imread(tb)
        np.testing.assert_array_equal(b, a)
        if ext == "png":
            np.testing.assert_array_equal(read_png(tb), a)


def test_cut_and_stack_matches_jax(tmp_path):
    import imageio.v2 as imageio
    rng = np.random.default_rng(2)
    paths = []
    for i in range(2):
        frames = [rng.integers(0, 256, (18 + 2 * i, 24, 3), dtype=np.uint8)
                  for _ in range(8)]
        paths.append(str(tmp_path / f"clip{i}.gif"))
        imageio.mimwrite(paths[-1], frames, fps=10)
    for axis in ("h", "v"):
        ja, tb = (str(tmp_path / f"{p}_{axis}.gif") for p in ("j", "t"))
        j_vt.cut_and_stack(paths, ja, start=0.1, end=0.5, axis=axis, fps=10)
        t_vt.cut_and_stack(paths, tb, start=0.1, end=0.5, axis=axis, fps=10)
        a, b = imageio.mimread(ja), imageio.mimread(tb)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def test_visualize_cameras_matches_jax(fixture_scene, tmp_path):  # noqa: F811
    root, _ = fixture_scene
    ja, tb = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    j_vt.visualize_cameras(root, ja)
    t_vt.main(["visualize_cameras", "-s", root, "-o", tb, "--device", "cpu"])
    np.testing.assert_array_equal(read_png(tb), read_png(ja))


# --- network_gui -------------------------------------------------------------

def _request(width, height, view=None, proj=None, train=True):
    view = np.eye(4, dtype=np.float32) if view is None else view
    proj = np.eye(4, dtype=np.float32) if proj is None else proj
    return {
        "resolution_x": width, "resolution_y": height,
        "train": train, "fov_y": 0.8, "fov_x": 0.9,
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": np.asarray(view).reshape(-1).tolist(),
        "view_projection_matrix": np.asarray(proj).reshape(-1).tolist(),
    }


def _send(sock, msg):
    payload = json.dumps(msg).encode("utf-8")
    sock.sendall(struct.pack("I", len(payload)) + payload)


def _recv(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "server closed"
        out += chunk
    return out


def _client_frame(port, msg, result, connected=None):
    """Connect, send one request, read the frame and the source path."""
    cl = socket.create_connection(("127.0.0.1", port), timeout=60)
    if connected is not None:
        connected.set()
    _send(cl, msg)
    W, H = msg["resolution_x"], msg["resolution_y"]
    img = _recv(cl, W * H * 3)
    n = struct.unpack("I", _recv(cl, 4))[0]
    result["path"] = _recv(cl, n).decode("ascii")
    result["img"] = np.frombuffer(img, np.uint8).reshape(H, W, 3)
    cl.close()


@pytest.mark.parametrize("frame", ["numpy", "tensor"])
def test_serve_step_round_trip(frame):
    """tests/test_network_gui.py's round trip through the port's module,
    with the frame as an array or as a tensor."""
    import time
    W, H = 24, 16
    t_gui.init("127.0.0.1", 0)
    port = t_gui._listener.getsockname()[1]
    captured = {}

    def render_fn(cam, scale_mod):
        captured["cam"] = cam
        captured["scale_mod"] = scale_mod
        img = np.zeros((H, W, 3), np.float32)
        img[..., 0] = 1.0          # pure red frame
        img[0, 0] = [0.0, 1.0, 0.0]
        return torch.tensor(img) if frame == "tensor" else img

    result = {}
    t = threading.Thread(target=_client_frame,
                         args=(port, _request(W, H), result))
    t.start()
    deadline = time.time() + 10
    cont = False
    try:
        while not cont and time.time() < deadline:
            cont = t_gui.serve_step(render_fn, "/scene/path",
                                    keep_alive_training=True, device="cpu")
            if not cont:
                time.sleep(0.02)
        t.join(timeout=10)
    finally:
        t_gui.disconnect()
        t_gui._listener.close()
        t_gui._listener = None

    assert cont, "server never honoured the training request"
    assert result["path"] == "/scene/path"
    np.testing.assert_array_equal(result["img"][1, 1], [255, 0, 0])
    np.testing.assert_array_equal(result["img"][0, 0], [0, 255, 0])
    assert result["img"].shape == (H, W, 3)
    assert captured["scale_mod"] == 1.0
    wv = captured["cam"].world_view
    assert wv.device.type == "cpu"
    np.testing.assert_allclose(np.diag(wv.numpy()), [1.0, -1.0, -1.0, 1.0])


def _sibr_matrices(R, T, fovx, fovy, W, H):
    """The view and view-projection matrices a SIBR client sends for the
    camera (R, T): the camera's own with the columns the server negates
    negated."""
    cam = j_make_camera(R, T, fovx, fovy, W, H)
    view = np.array(cam.world_view)
    proj = np.array(cam.full_proj)
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    return view, proj


def test_receive_camera_matches_jax(monkeypatch):
    R = rotation(3, 0.7)
    view, proj = _sibr_matrices(R, np.array([0.3, -0.2, 2.5]), 0.9, 0.8,
                                40, 24)
    msg = _request(40, 24, view, proj)
    msg["scaling_modifier"] = 0.7
    got = {}
    for name, mod, kw in (("jax", j_gui, {}), ("torch", t_gui,
                                               {"device": "cpu"})):
        a, b = socket.socketpair()
        try:
            monkeypatch.setattr(mod, "conn", b)
            _send(a, msg)
            got[name] = mod.receive(**kw)
        finally:
            a.close()
            b.close()
    j, t = got["jax"], got["torch"]
    assert len(j) == len(t) == 6 and j[1:] == t[1:]
    for f in ("world_view", "full_proj", "cam_center", "tanfovx",
              "tanfovy"):
        assert_same(getattr(j[0], f), getattr(t[0], f), None, f)
    assert (t[0].width, t[0].height) == (j[0].width, j[0].height) == (40, 24)


def _trainer_frame(monkeypatch, gui, main, argv, msg):
    """Run a trainer whose network_gui.init also starts one client as soon
    as the listener is bound; returns (frame, source path) it received."""
    result, threads = {}, []
    orig = gui.init

    def init(host, port):
        orig(host, port)
        connected = threading.Event()
        t = threading.Thread(target=_client_frame, args=(
            gui._listener.getsockname()[1], msg, result, connected))
        t.start()
        threads.append(t)
        assert connected.wait(30)
    monkeypatch.setattr(gui, "init", init)
    try:
        main(argv)
    finally:
        gui.disconnect()
        if gui._listener is not None:
            gui._listener.close()
            gui._listener = None
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return result["img"], result["path"]


def test_trainer_serves_the_gui_like_jax(fixture_scene, tmp_path,  # noqa: F811
                                         monkeypatch, capfd):
    """Both trainers, 2 iterations without --disable_gui: the client that
    connects at start-up gets one frame of the live model at iteration 1
    and the scene path; the frames agree within 1 per channel."""
    root, _ = fixture_scene
    view = t_load_scene(root, eval_split=False, device="cpu").train_views[2]
    msg = _request(64, 48, *_sibr_matrices(view.R, view.T, view.fovx,
                                           view.fovy, 64, 48))
    argv = ["-s", root, "--iterations", "2", "--capacity", "256",
            "--entry_cap", "4096", "--sh_degree", "1", "--quiet",
            "--no_tensorboard", "--port", "0"]
    with one_torch_thread():
        timg, tpath = _trainer_frame(
            monkeypatch, t_gui, t_train.main,
            argv + ["-m", str(tmp_path / "t"), "--device", "cpu"], msg)
    out = capfd.readouterr().out
    assert "not ported" not in out and "Connected by" in out
    jimg, jpath = _trainer_frame(
        monkeypatch, j_gui, j_train.main,
        argv + ["-m", str(tmp_path / "j"), "--backend", "reference"], msg)
    assert tpath == jpath == root
    assert timg.shape == jimg.shape == (48, 64, 3)
    assert timg.max() > 0
    diff = np.abs(timg.astype(np.int32) - jimg.astype(np.int32))
    assert diff.max() <= 1, int((diff > 1).sum())


# --- convert -----------------------------------------------------------------

_FAKE_COLMAP = """#!{python}
import os, sys
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
args = dict(zip(sys.argv[2::2], sys.argv[3::2]))
if sys.argv[1] == "mapper":
    os.makedirs(os.path.join(args["--output_path"], "0"), exist_ok=True)
if sys.argv[1] == "image_undistorter":
    out = args["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "w").close()
"""


def _fake_colmap(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text(_FAKE_COLMAP.format(python=sys.executable))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_convert_refuses_without_colmap(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    msgs = []
    for mod in (j_convert, t_convert):
        with pytest.raises(SystemExit) as e:
            mod.main(["-s", str(tmp_path)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not found on PATH" in msgs[0]


@pytest.mark.parametrize("flags", [[], ["--no_gpu", "--camera", "PINHOLE"],
                                   ["--skip_matching"]])
def test_convert_runs_what_jax_runs(tmp_path, monkeypatch, flags):
    _fake_colmap(tmp_path, monkeypatch)
    logs, trees = [], []
    for name, mod in (("j", j_convert), ("t", t_convert)):
        src = tmp_path / name
        (src / "input").mkdir(parents=True)
        log = tmp_path / f"{name}.log"
        monkeypatch.setenv("COLMAP_LOG", str(log))
        mod.main(["-s", str(src)] + flags)
        logs.append(log.read_text().replace(str(src), "<src>"))
        trees.append(_tree(src))
    assert logs[0] == logs[1]
    assert len(logs[0].splitlines()) == (1 if flags == ["--skip_matching"]
                                         else 4)
    assert trees[0] == trees[1]
    assert "sparse/0/cameras.bin" in trees[0]


def test_convert_resize_matches_jax(tmp_path, monkeypatch):
    from PIL import Image
    _fake_colmap(tmp_path, monkeypatch)
    monkeypatch.setenv("COLMAP_LOG", str(tmp_path / "log"))
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (37 + 8 * i, 53 - 4 * i, 3),
                         dtype=np.uint8) for i in range(2)]
    for name, mod in (("j", j_convert), ("t", t_convert)):
        (tmp_path / name / "images").mkdir(parents=True)
        for i, img in enumerate(imgs):
            Image.fromarray(img).save(str(tmp_path / name / "images"
                                          / f"{i}.png"))
        mod.main(["-s", str(tmp_path / name), "--skip_matching", "--resize"])
    for sub in ("images_2", "images_4", "images_8"):
        for i in range(2):
            a = read_png(str(tmp_path / "j" / sub / f"{i}.png"))
            b = read_png(str(tmp_path / "t" / sub / f"{i}.png"))
            scale = int(sub.split("_")[1])
            assert a.shape[:2] == (imgs[i].shape[0] // scale,
                                   imgs[i].shape[1] // scale)
            np.testing.assert_array_equal(b, a)


# --- the card by default -----------------------------------------------------

@pytest.mark.parametrize("entry", ["viewer", "traj", "visualize_cameras",
                                   "receive"])
def test_default_device_is_the_card(model, fixture_scene,  # noqa: F811
                                    tmp_path, monkeypatch, entry):
    """With no device named, every new entry point asks for the card and
    raises without one; none moves to the CPU by itself."""
    root, _ = fixture_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    calls = {
        "viewer": lambda: t_viewer.main(["-m", model, "--out_dir", out]),
        "traj": lambda: t_traj.main(["-m", model, "--out_dir", out]),
        "visualize_cameras": lambda: t_vt.main(
            ["visualize_cameras", "-s", root, "-o", out + ".png"]),
    }
    if entry == "receive":
        a, b = socket.socketpair()
        monkeypatch.setattr(t_gui, "conn", b)
        _send(a, _request(8, 8))
        calls["receive"] = t_gui.receive
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
    finally:
        if entry == "receive":
            a.close()
            b.close()
    assert not os.path.exists(out) and not os.path.exists(out + ".png")
