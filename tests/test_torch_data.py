"""msgs_torch's data layer vs PIL and vs the JAX package, on the CPU.

- The PNG codec against PIL on PIL-written gray, LA, RGB and RGBA files
  (PIL's encoder picks a filter per row; the filter types each file holds
  are checked to cover more than one), and PIL decoding the port's
  encoder's output with all five filter types: exact.
- `resize` bit-exact against `Image.resize` at scales 2 to 64, RGB and
  RGBA (premultiplied), gray and gray+alpha.
- The Blender loader on tests/test_apps.py's fixture scene (JAX-rendered,
  imageio-written) and on an RGBA copy of it: the same R, T, fov, extent
  and pyramid images as msgs.data.dataset (exact: both resize with
  Pillow's arithmetic); and the port's synthetic scene read by both
  loaders.
- Train-state checkpoints written by either package load in the other,
  and `grow_capacity` matches the JAX package's: exact.
"""
import json
import math
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from msgs.data import dataset as jds
from msgs.train import checkpoint as jck
from msgs_torch.data import dataset as tds
from msgs_torch.data import image as timg
from msgs_torch.train import checkpoint as tck
from tests.test_torch_structural import _train_states, assert_train_states

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _test_image(mode, kind, rng, H=70, W=93):
    ch = MODES[mode]
    if kind == "noise":
        a = rng.integers(0, 256, (H, W, ch))
    else:
        yy, xx = np.mgrid[:H, :W]
        a = (np.sin(xx / 7.0)[..., None] * 100 + np.cos(yy / 5.0)[..., None]
             * 80 + 128 + rng.integers(0, 20, (H, W, ch)))
    a = np.clip(a, 0, 255).astype(np.uint8)
    if ch in (2, 4):
        u = rng.uniform(size=(H, W))
        a[..., -1] = np.where(u < 0.2, 0, np.where(u < 0.45, 255,
                                                    a[..., -1]))
    return a[..., 0] if ch == 1 else a


def _filter_types(path):
    raw = zlib.decompress(b"".join(
        body for kind, body in timg._chunks(open(path, "rb").read())
        if kind == b"IDAT"))
    with Image.open(path) as im:
        w, h = im.size
        ch = MODES[im.mode]
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * ch)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("mode", list(MODES))
def test_png_codec_matches_pil(mode, tmp_path):
    rng = np.random.default_rng(MODES[mode])
    seen = set()
    for kind in ("noise", "smooth"):
        a = _test_image(mode, kind, rng)
        p = str(tmp_path / f"{kind}.png")
        Image.fromarray(a, mode).save(p)
        seen |= _filter_types(p)
        got = timg.read_png(p)
        want = np.asarray(Image.open(p))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert timg.image_size(p) == Image.open(p).size
    assert len(seen) > 1, seen
    # The port's encoder, every filter type, read back by PIL and itself.
    a = _test_image(mode, "noise", rng)
    p = str(tmp_path / "mine.png")
    timg.write_png(p, a, filters=(0, 1, 2, 3, 4))
    assert _filter_types(p) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(Image.open(p)), a)
    np.testing.assert_array_equal(timg.read_png(p), a)


def test_png_rejects_unsupported(tmp_path):
    p = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(p)
    with pytest.raises(ValueError, match="unsupported PNG"):
        timg.read_png(p)


@pytest.mark.parametrize("mode", list(MODES))
def test_resize_matches_pil(mode):
    rng = np.random.default_rng(10 + MODES[mode])
    for kind in ("noise", "smooth"):
        a = _test_image(mode, kind, rng, H=130, W=171)
        im = Image.fromarray(a, mode)
        for s in (2, 3, 4, 8, 16, 32, 64):
            size = (max(round(171 / s), 1), max(round(130 / s), 1))
            np.testing.assert_array_equal(
                timg.resize(a, size), np.asarray(im.resize(size)),
                err_msg=f"{mode} {kind} /{s}")
        # Upscaling and one axis only.
        for size in ((200, 150), (171, 65)):
            np.testing.assert_array_equal(
                timg.resize(a, size), np.asarray(im.resize(size)))


@pytest.fixture(scope="module")
def fixture_scene(tmp_path_factory):
    """tests/test_apps.py's synthetic_scene (6 views of 80 Gaussians at
    64×64, rendered by the JAX reference backend, written by imageio), plus
    an RGBA copy whose alpha cuts out the dark background."""
    import imageio.v2 as imageio

    from msgs.core.camera import make_camera
    from msgs.kernels.rasterize import RasterSettings
    from msgs.model.gaussians import GaussianConfig, create_from_points
    from msgs.train import loop as JL

    root = tmp_path_factory.mktemp("scene")
    rgba = tmp_path_factory.mktemp("scene_rgba")
    for r in (root, rgba):
        (r / "train").mkdir()
    rng = np.random.default_rng(0)
    n = 80
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(-0.3, 0.3, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    cfg = GaussianConfig(sh_degree=0, reso_lvls=1, capacity=128)
    state = JL.init_train_state(create_from_points(cfg, pts, cols))
    settings = RasterSettings(backend="reference", entry_cap=1 << 12)
    fov, frames = 0.9, []
    for i in range(6):
        ang = 2 * math.pi * i / 6
        pos = np.array([4 * math.sin(ang), 0.0, -4 * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        T = -R.T @ pos
        out = JL.eval_render(state, make_camera(R, T, fov, fov, 64, 64),
                             cfg=cfg, settings=settings)
        img = (np.clip(np.asarray(out.image), 0, 1) * 255).astype(np.uint8)
        imageio.imwrite(str(root / f"train/r_{i}.png"), img)
        alpha = np.clip(img.max(-1).astype(np.int32) * 3, 0, 255)
        Image.fromarray(np.concatenate(
            [img, alpha[..., None].astype(np.uint8)], -1), "RGBA").save(
                str(rgba / f"train/r_{i}.png"))
        c2w = np.linalg.inv(np.block([[R.T, T[:, None]],
                                      [np.zeros((1, 3)), np.ones((1, 1))]]))
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for r in (root, rgba):
        with open(r / "transforms_train.json", "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)
    return str(root), str(rgba)


def _assert_scenes_match(path, white_background=False):
    kw = dict(eval_split=False, white_background=white_background)
    js = jds.load_scene(path, **kw)
    ts = tds.load_scene(path, **kw, device="cpu")
    assert ts.cameras_extent == js.cameras_extent
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    assert len(ts.train_views) == len(js.train_views)
    for jv, tv in zip(js.train_views + js.test_views,
                      ts.train_views + ts.test_views):
        np.testing.assert_array_equal(tv.R, jv.R)
        np.testing.assert_array_equal(tv.T, jv.T)
        assert (tv.fovx, tv.fovy, tv.width, tv.height) == \
            (jv.fovx, jv.fovy, jv.width, jv.height)
        for scale in (1, 2, 4, 8):
            np.testing.assert_array_equal(tv.image(scale), jv.image(scale))
            jc, tc = jv.camera(scale), tv.camera(scale)
            assert (tc.width, tc.height) == (jc.width, jc.height)
            np.testing.assert_allclose(tc.full_proj.numpy(),
                                       np.asarray(jc.full_proj), atol=1e-6)
    return ts


def test_blender_loader_matches_jax(fixture_scene):
    root, rgba = fixture_scene
    _assert_scenes_match(root)
    _assert_scenes_match(rgba, white_background=True)
    # The second load reads the port's own .npy pyramid cache.
    assert os.listdir(os.path.join(root, tds.CACHE_DIR))
    _assert_scenes_match(root)


def test_synthetic_scene_reads_in_both_loaders(tmp_path):
    from msgs_torch.data.synthetic import make_scene
    out = str(tmp_path / "synth")
    make_scene(out, n_views=3, n_test=2, width=40, height=32,
               n_gaussians=600, device="cpu", quiet=True)
    ts = _assert_scenes_match(out)
    js = jds.load_scene(out, eval_split=True)
    assert len(js.train_views) == 3 and len(js.test_views) == 2
    assert ts.train_views[0].image(1).max() > 0.1


def test_checkpoint_interop_both_ways(tmp_path):
    js, ts = _train_states()
    p_j, p_t = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_train_state(p_j, js)
    tck.save_train_state(p_t, ts)
    # JAX-written → port, port-written → JAX, and each into itself.
    assert_train_states(js, tck.load_train_state(p_j, ts))
    assert_train_states(jck.load_train_state(p_t, js), ts)
    with np.load(p_j) as a, np.load(p_t) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_grow_capacity_matches_jax():
    js, ts = _train_states()
    jg = jck.grow_capacity(js, 384)
    tg = tck.grow_capacity(ts, 384)
    assert tg.gaussians.xyz.shape[0] == 384
    assert_train_states(jg, tg)
