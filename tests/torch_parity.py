"""Shared helpers for the msgs_torch parity tests: the same numpy inputs, made
from a seed, go through the JAX package and through msgs_torch on the CPU."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from msgs.core.camera import make_camera as jax_make_camera
from msgs_torch.core.camera import make_camera_from_matrices

# The JAX suite's own budgets (tests/test_rasterize.py).
TOL_IMAGE = 1e-5     # image, transmittance, pixel sizes
TOL_DEPTH = 1e-4     # depth, acc_pixel_size


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread for the duration. A test whose time
    goes into thousands of small ops runs them without OpenMP's fork and
    join, which, when the suite's workers share the cores, can take longer
    than the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rotation(seed: int, angle: float = 0.2) -> np.ndarray:
    """A rotation by `angle` radians about a seeded random axis (small, so a
    scene in front of the identity camera stays in view)."""
    k = np.random.default_rng(seed).normal(size=3)
    k /= np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def cameras(width, height, fovx=0.8, fovy=None, R=None, T=None):
    """(JAX camera, port camera on the CPU) with identical matrices. The
    port's camera is built from the JAX camera's matrices: XLA's float32
    `tan` and torch's can differ in the last bit (ROADMAP.md, Faults), and
    the parity tests compare the pipelines, not the tangent."""
    fovy = fovx if fovy is None else fovy
    R = np.eye(3) if R is None else R
    T = np.zeros(3) if T is None else T
    jcam = jax_make_camera(R, T, fovx, fovy, width, height)
    tcam = make_camera_from_matrices(
        np.asarray(jcam.world_view), np.asarray(jcam.full_proj), fovx, fovy,
        width, height, device="cpu")
    return jcam, tcam


def t(a) -> torch.Tensor:
    """numpy / JAX array → CPU tensor (copied)."""
    return torch.tensor(np.array(a))


def n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(jax_x, port_x, tol=None, what=""):
    """Exact equality (tol None) or max |Δ| ≤ tol."""
    a, b = n(jax_x), n(port_x)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if tol is None:
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        bad = np.argwhere(a != b)
        assert bad.size == 0, f"{what}: {len(bad)} mismatches, first {bad[:5]}"
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=what)


def tile_multisets(gauss_id, sub_tile, sub_valid, sub=32):
    """{tile: sorted gauss ids} over the valid sub-blocks."""
    gid = n(gauss_id).reshape(-1, sub)
    st, sv = n(sub_tile), n(sub_valid)
    out = {}
    for s in np.nonzero(sv == 1)[0]:
        out.setdefault(int(st[s]), []).extend(gid[s].tolist())
    return {k: sorted(v) for k, v in out.items()}


def train_tiny(package: str, scene: str, out: str, iterations: int = 10):
    """A tiny model trained on `scene` into `out` by the JAX trainer
    (package "jax", reference backend) or the port's ("torch", on the
    CPU), with a PLY snapshot and an npz checkpoint at the last iteration
    and its evaluation logged."""
    it = str(iterations)
    argv = ["-s", scene, "-m", out, "--iterations", it, "--capacity", "256",
            "--entry_cap", "4096", "--test_interval", "0",
            "--test_iterations", it, "--save_iterations", it,
            "--checkpoint_iterations", it, "--sh_degree", "1",
            "--quiet"]
    if package == "jax":
        from msgs.apps import train
        train.main(argv + ["--backend", "reference"])
    else:
        from msgs_torch.apps import train
        with one_torch_thread():
            train.main(argv + ["--device", "cpu", "--disable_gui",
                               "--no_tensorboard"])


def assert_uint8_match(a, b, floats_a=None, tol=1e-5, what=""):
    """Two uint8 images are equal, or, with `floats_a` (the [0, 1] image a
    was quantised from by truncation), differ by at most 1 and only where
    that value·255 lies within tol·255 of an integer, the truncation's
    boundary."""
    from msgs_torch.apps.render import truncation_mismatches
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if floats_a is None:
        diff = a != b
        assert not diff.any(), f"{what}: {int(diff.sum())} pixels"
        return
    bad = truncation_mismatches(a, b, floats_a, tol)
    assert not bad, f"{what}: {bad} pixels"


def assert_pngs_match(dir_a: str, dir_b: str, floats_a=None):
    """The PNGs of two folders decode equal, file for file. With
    `floats_a` (the [0, 1] images folder a was quantised from, in file
    order), a pixel may differ by 1 where that value·255 lies within
    1e-5·255 of an integer, the truncation's boundary."""
    import os

    from msgs_torch.data.image import read_png
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names
    for i, name in enumerate(names):
        assert_uint8_match(
            read_png(os.path.join(dir_a, name)),
            read_png(os.path.join(dir_b, name)),
            None if floats_a is None else floats_a[i], what=name)
