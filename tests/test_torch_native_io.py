"""msgs_torch.data.native_io and colmap.load_sparse against the JAX package's,
on the CPU.

The port's ctypes readers (its own copy of colmap_io.cpp, built with g++
into build/msgs_torch/native/) against msgs.data.native_io on the same
seeded files (tests/test_native_io.py's writers): every array equal, dtype
included. `load_sparse` against msgs.data.colmap.load_sparse on one model,
through both native libraries and with both forced unavailable (the struct
readers). Two processes that build the library into one empty directory at
once both load it; a source that does not compile leaves the reason in
`build_error` and every reader returns None.
"""
import os
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from msgs.data import colmap as jcolmap
from msgs.data import native_io as jnative
from msgs.data import ply as jply
from msgs_torch.data import colmap as tcolmap
from msgs_torch.data import native_io as tnative
from msgs_torch.data import ply as tply
from tests.test_native_io import _write_images_bin, _write_points3d_bin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.fixture(scope="module")
def libs():
    """Both native libraries; the port's must build here (g++ is present)."""
    assert tnative.get_lib() is not None, tnative.build_error
    assert jnative.get_lib() is not None


def test_native_points3d_matches_jax(tmp_path, libs):
    path = str(tmp_path / "points3D.bin")
    xyz, rgb, err = _write_points3d_bin(path, n=700, seed=4)
    want, got = jnative.read_points3d_bin(path), tnative.read_points3d_bin(path)
    for name, a, b in zip(("xyz", "rgb", "err"), want, got):
        equal(a, b, name)
    # float32-rounded, widened to float64, as the JAX module returns them.
    equal(got[0], xyz.astype(np.float32).astype(np.float64), "xyz rounding")
    equal(got[1], rgb, "rgb")
    equal(got[2], err.astype(np.float32).astype(np.float64), "err rounding")
    for a, b in zip(jcolmap.read_points3d_binary(path),
                    tcolmap.read_points3d_binary(path)):
        equal(a, b, "struct reader")


def test_native_images_matches_jax(tmp_path, libs):
    path = str(tmp_path / "images.bin")
    qs, ts = _write_images_bin(path, n=11, seed=5)
    want, got = jnative.read_images_bin(path), tnative.read_images_bin(path)
    assert sorted(want) == sorted(got)
    for k in ("qvec", "tvec", "camera_id", "image_id"):
        equal(want[k], got[k], k)
    assert want["names"] == got["names"] == [f"img_{i:03d}.jpg"
                                             for i in range(11)]
    equal(got["qvec"], qs, "qvec")
    equal(got["tvec"], ts, "tvec")


def test_native_ply_matches_jax(tmp_path, libs):
    path = str(tmp_path / "m.ply")
    rng = np.random.default_rng(6)
    fields = {"x": rng.normal(size=90).astype(np.float32),
              "opacity": rng.normal(size=90).astype(np.float32),
              "d": rng.normal(size=90).astype(np.float64),
              "flag": rng.integers(0, 256, 90).astype(np.uint8)}
    jply.write_ply(path, fields)
    want, got = jnative.read_ply_f32(path), tnative.read_ply_f32(path)
    assert list(want) == list(got) == list(fields)
    for k in fields:
        equal(want[k], got[k], k)
    plain = tply.read_ply(path)
    for k, v in fields.items():
        equal(got[k], plain[k].astype(np.float32), f"{k} vs read_ply")


def test_native_readers_refuse_malformed_files(tmp_path, libs):
    path = str(tmp_path / "points3D.bin")
    _write_points3d_bin(path, n=50, seed=7)
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.bin")
    open(cut, "wb").write(data[:len(data) // 2])
    assert jnative.read_points3d_bin(cut) is None
    assert tnative.read_points3d_bin(cut) is None
    assert tnative.read_images_bin(cut) is None
    assert tnative.read_ply_f32(cut) is None
    assert tnative.read_points3d_bin(str(tmp_path / "missing.bin")) is None


def write_sparse_model(d, seed=8):
    """cameras.bin (a PINHOLE and a SIMPLE_PINHOLE camera), images.bin and
    points3D.bin in `d`."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ4d", 1, 1, 640, 480, 500.0, 510.0, 320.0,
                            240.0))
        f.write(struct.pack("<iiQQ3d", 2, 0, 320, 240, 250.0, 160.0, 120.0))
    _write_images_bin(os.path.join(d, "images.bin"), n=9, seed=seed)
    _write_points3d_bin(os.path.join(d, "points3D.bin"), n=400,
                        seed=seed + 1)


@pytest.mark.parametrize("path", ["native", "struct"])
def test_load_sparse_matches_jax(tmp_path, monkeypatch, libs, path):
    d = str(tmp_path / "sparse")
    write_sparse_model(d)
    if path == "struct":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    jc, ji, jxyz, jrgb = jcolmap.load_sparse(d)
    tc, ti, txyz, trgb = tcolmap.load_sparse(d)
    assert sorted(jc) == sorted(tc) == [1, 2]
    for k in jc:
        assert (jc[k].id, jc[k].model, jc[k].width, jc[k].height) == \
            (tc[k].id, tc[k].model, tc[k].width, tc[k].height)
        equal(jc[k].params, tc[k].params, f"camera {k}")
    assert list(ji) == list(ti)
    for k in ji:
        assert (ji[k].id, ji[k].camera_id, ji[k].name) == \
            (ti[k].id, ti[k].camera_id, ti[k].name)
        equal(ji[k].qvec, ti[k].qvec, f"image {k} qvec")
        equal(ji[k].tvec, ti[k].tvec, f"image {k} tvec")
    equal(jxyz, txyz, "xyz")
    equal(jrgb, trgb, "rgb")
    # The path taken: the native points reader rounds xyz through float32.
    exact = tcolmap.read_points3d_binary(os.path.join(d, "points3D.bin"))[0]
    if path == "native":
        equal(txyz, exact.astype(np.float32).astype(np.float64), "rounded")
        assert not np.array_equal(txyz, exact)
    else:
        equal(txyz, exact, "struct xyz")


# Imports, says it is ready, waits for the go file, then builds.
BUILD_CHILD = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    from msgs_torch.data import native_io
    native_io.BUILD_DIR = Path(sys.argv[1])
    open(sys.argv[2] + f".{os.getpid()}", "w").close()
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.001)
    lib = native_io.get_lib()
    assert lib is not None, native_io.build_error
    out = native_io.read_ply_f32(sys.argv[3])
    print(native_io.library_path().name, len(out["x"]))
""")


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory at the same moment:
    both load a whole library, and one library file is left, no temporary."""
    build = tmp_path / "native"
    ply = str(tmp_path / "m.ply")
    jply.write_ply(ply, {"x": np.arange(7, dtype=np.float32)})
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, str(build), str(go), ply],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    t0 = time.time()
    while (len(list(tmp_path.glob("go.*"))) < 2
           and all(p.poll() is None for p in procs)
           and time.time() - t0 < 120):
        time.sleep(0.01)
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[0] for out, _ in outs}
    assert {out.split()[1] for out, _ in outs} == {"7"}
    assert sorted(os.listdir(build)) == sorted(names) and len(names) == 1


def test_build_error_is_kept(tmp_path, monkeypatch):
    bad = tmp_path / "colmap_io.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "build_error", None)
    assert tnative.get_lib() is None
    assert "g++ exited" in tnative.build_error
    assert "error" in tnative.build_error
    assert tnative.read_points3d_bin(str(tmp_path / "x.bin")) is None
    assert list((tmp_path / "build").iterdir()) == []
