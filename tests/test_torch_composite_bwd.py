"""msgs_torch compositor backward vs the JAX package's, on the CPU.

The port's `composite` backward (its plain version on CPU tensors) and
`composite_reference` are held against `jax.vjp` of
msgs/kernels/composite.py:composite — the Pallas backward kernel in
interpret mode — for the same payload, sub-block structure and seeded
cotangent, per payload column, within the JAX suite's gradient budget
3e-5·max|g| + 1e-6 (tests/test_rasterize.py:120,152). The plain backward is
also held against torch autograd through the plain forward. The CUDA
kernel vs its plain version is in test_torch_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels import composite as jcomp
from msgs.kernels.binning import BLOCK, bin_gaussians
from msgs.kernels.preprocess import preprocess as jax_preprocess
from msgs_torch.core.camera import make_camera
from msgs_torch.kernels import binning as tbin
from msgs_torch.kernels import composite as tcomp
from msgs_torch.kernels.preprocess import preprocess as torch_preprocess
from msgs_torch.kernels.rasterize import gather_payload
from tests.helpers import make_scene
from tests.torch_parity import cameras, t

W = H = 64          # the JAX suite's rasterizer scene (test_rasterize.py)


def grad_budget(want):
    return 3e-5 * max(np.abs(want).max(), 1e-8) + 1e-6


def assert_grad_close(want, got, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=grad_budget(want),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _stream():
    """JAX preprocess + binning of test_rasterize.py's scene (200
    Gaussians, seed 1, colours from a seed) → (payload, binned) as numpy."""
    n = 200
    means, scales, quats, opac, _ = make_scene(n=n, seed=1)
    cols = np.random.default_rng(1).uniform(0, 1, (n, 3)).astype(np.float32)
    jcam, _ = cameras(W, H)
    pre = jax_preprocess(jcam, jnp.asarray(means), jnp.asarray(opac),
                         colors_precomp=jnp.asarray(cols),
                         scales=jnp.asarray(scales), quats=jnp.asarray(quats))
    b = bin_gaussians(pre, W, H, 1 << 15)
    p = pre
    feats = np.stack([
        p.means2d[:, 0], p.means2d[:, 1], p.conics[:, 0], p.conics[:, 1],
        p.conics[:, 2], p.opacities, p.colors[:, 0], p.colors[:, 1],
        p.colors[:, 2], p.depths, p.pixel_sizes] + [np.zeros(n)], axis=1)
    feats = np.concatenate([feats, np.zeros((1, 12))]).astype(np.float32)
    payload = feats[np.asarray(b.gauss_id)].reshape(-1, BLOCK, 12)
    return payload, {k: np.asarray(v) for k, v in b._asdict().items()}


def _static(b):
    tx = (W + 15) // 16
    return (tx * ((H + 15) // 16), tx, W, H)


@pytest.mark.parametrize("image_only", [False, True])
def test_composite_vjp_matches_jax(image_only):
    payload, b = _stream()
    T, tx, _, _ = _static(b)
    cot = np.random.default_rng(11).normal(
        size=(T, tcomp.NOUT, tcomp.NPIX)).astype(np.float32)
    structure = (b["sub_tile"], b["sub_valid"], b["tile_last_sub"])

    _, vjp = jax.vjp(
        lambda p: jcomp.composite(p, *map(jnp.asarray, structure),
                                  *_static(b), image_only, False),
        jnp.asarray(payload))
    want = np.asarray(vjp(jnp.asarray(cot))[0]).reshape(-1, 12)

    last = tcomp.F_B if image_only else tcomp.F_PSIZE
    live = np.abs(want[:, :last + 1]).max(axis=0)
    assert (live > 0).all(), "a payload column got no gradient"
    for fn in (tcomp.composite, tcomp.composite_reference):
        p = t(payload).requires_grad_()
        out = fn(p, *map(t, structure), *_static(b), image_only)
        out.backward(t(cot))
        got = p.grad.numpy().reshape(-1, 12)
        # Columns past `last` (and the pad column) are not computed by the
        # JAX kernel; the port writes zeros there.
        for c in range(last + 1):
            assert_grad_close(want[:, c], got[:, c], f"{fn.__name__} col {c}")
        assert (got[:, last + 1:] == 0).all()


@pytest.mark.parametrize("image_only", [False, True])
def test_plain_backward_matches_autograd(image_only):
    """The plain backward (the JAX kernel's closed form) vs torch autograd
    through the plain forward, at a tiny stream with multi-sub tiles."""
    rng = np.random.default_rng(4)
    n = 60
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    cam = make_camera(np.eye(3), np.zeros(3), 0.7, 0.7, 40, 24, device="cpu")
    pre = torch_preprocess(
        cam, f32(np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                                 rng.uniform(2, 5, (n, 1))], 1)),
        f32(rng.uniform(0.3, 0.99, n)),
        colors_precomp=f32(rng.uniform(0, 1, (n, 3))),
        scales=f32(np.exp(rng.uniform(-3.5, -2, (n, 3)))),
        quats=f32(rng.normal(size=(n, 4))))
    b = tbin.bin_gaussians(pre, 40, 24, 1 << 12)
    tiles, tx = 3 * 2, 3
    payload = gather_payload(pre, b.gauss_id, b.gid_starts).detach()
    first, n_sub = tcomp.tile_sub_ranges(b.sub_tile, b.sub_valid,
                                         b.tile_last_sub, tiles)
    assert int(n_sub.max()) >= 2
    cot = f32(np.random.default_rng(5).normal(
        size=(tiles, tcomp.NOUT, tcomp.NPIX)))
    if image_only:
        cot[:, tcomp.O_DEPTH:tcomp.O_ACC + 1] = 0.0

    p = payload.clone().requires_grad_()
    out = tcomp._composite_plain(p, first, n_sub, tiles, tx, 40, 24)[0]
    want = torch.autograd.grad(out, p, cot)[0].reshape(-1, 12).numpy()
    with torch.no_grad():
        res = tcomp._composite_plain(payload, first, n_sub, tiles, tx,
                                     40, 24)[0]
    got = tcomp.composite_bwd_reference(
        payload, first, n_sub, res, cot, tiles, tx, 40, 24,
        image_only).reshape(-1, 12).numpy()
    last = tcomp.F_B if image_only else tcomp.F_PSIZE
    for c in range(last + 1):
        assert np.abs(want[:, c]).max() > 0
        assert_grad_close(want[:, c], got[:, c], f"col {c}")
