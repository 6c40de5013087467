"""msgs_torch compositor vs msgs/kernels/composite.py:composite (the Pallas
kernel, in interpret mode on the CPU) on the same payload and sub-block
structure (the CUDA kernel vs its plain version is in test_torch_cuda.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from msgs.kernels import composite as jcomp
from msgs.kernels.binning import BLOCK, bin_gaussians
from msgs.kernels.preprocess import preprocess as jax_preprocess
from msgs_torch.kernels import composite as tcomp
from tests.helpers import make_scene
from tests.torch_parity import TOL_DEPTH, TOL_IMAGE, assert_same, cameras, \
    rotation, t

# Channel budgets, the JAX suite's own.
CHANNEL_TOL = {tcomp.O_R: TOL_IMAGE, tcomp.O_G: TOL_IMAGE,
               tcomp.O_B: TOL_IMAGE, tcomp.O_DEPTH: TOL_DEPTH,
               tcomp.O_ACC: TOL_DEPTH, tcomp.O_T: TOL_IMAGE,
               tcomp.O_DONE: 0.0}


@functools.lru_cache(maxsize=None)
def _stream(W, H, n, seed):
    """JAX preprocess + binning → (payload, binned) as numpy (read-only)."""
    means, scales, quats, opac, _ = make_scene(n=n, seed=seed, spread=1.2,
                                               z_range=(2.0, 8.0))
    cols = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    jcam, _ = cameras(W, H, fovx=0.9, R=rotation(seed))
    pre = jax_preprocess(jcam, jnp.asarray(means), jnp.asarray(opac),
                         colors_precomp=jnp.asarray(cols, jnp.float32),
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


def _args(payload, b, W, H, conv):
    tx = (W + 15) // 16
    T = tx * ((H + 15) // 16)
    return (conv(payload), conv(b["sub_tile"]), conv(b["sub_valid"]),
            conv(b["tile_last_sub"]), T, tx, W, H)


def test_composite_matches_jax():
    W, H, n = 88, 72, 500
    payload, b = _stream(W, H, n, seed=W)
    want = np.asarray(jcomp.composite(*_args(payload, b, W, H, jnp.asarray)))
    ne = b["tile_nonempty"]
    assert ne.sum() > 0
    for fn in (tcomp.composite, tcomp.composite_reference):
        got = fn(*_args(payload, b, W, H, t)).numpy()
        # The Pallas kernel leaves empty tiles undefined (the pipeline masks
        # them); the port writes their fresh state.
        for ch, tol in CHANNEL_TOL.items():
            assert_same(want[ne, ch], got[ne, ch], tol=tol, what=f"ch {ch}")
        assert (got[~ne, tcomp.O_T] == 1.0).all()
        assert (got[~ne, :tcomp.O_T] == 0.0).all()


def test_tile_sub_ranges():
    W, H = 88, 72
    _, b = _stream(W, H, 500, seed=W)
    T = ((W + 15) // 16) * ((H + 15) // 16)
    first, nsub = tcomp.tile_sub_ranges(t(b["sub_tile"]), t(b["sub_valid"]),
                                        t(b["tile_last_sub"]), T)
    first, nsub = first.numpy(), nsub.numpy()
    ne = b["tile_nonempty"]
    assert ((nsub > 0) == ne).all()
    for tile in np.nonzero(ne)[0]:
        subs = np.arange(first[tile], first[tile] + nsub[tile])
        assert (b["sub_tile"][subs] == tile).all()
        assert (b["sub_valid"][subs] == 1).all()
        assert subs[-1] == b["tile_last_sub"][tile]
    assert nsub.sum() == b["sub_valid"].sum()


def test_saturation_work_counts():
    """chip_smoke.py's one-pass count of the compositor's work, which its
    bounds for kernels 3, 4 and 4b are made of, against the plain forward:
    the tiles' sub-blocks before saturation are _composite_plain's n_work,
    and the warp-sub-blocks sum, at each depth k, the 32-pixel strips still
    open in the plain forward cut after k sub-blocks. 5,000 splats, so
    that tiles and strips saturate before their last sub-block."""
    W, H = 88, 72
    payload, b = _stream(W, H, 5000, seed=W)
    tx = (W + 15) // 16
    T = tx * ((H + 15) // 16)
    first, nsub = tcomp.tile_sub_ranges(t(b["sub_tile"]), t(b["sub_valid"]),
                                        t(b["tile_last_sub"]), T)
    pay = t(payload)
    n_tile, n_strip = chip_smoke.saturation_work((pay, first, nsub, T, tx),
                                                 W, H)
    assert n_tile == int(tcomp._composite_plain(pay, first, nsub, T, tx, W,
                                                H)[1])
    want = 0
    for k in range(int(nsub.max())):
        st = tcomp._composite_plain(pay, first, torch.clamp(nsub, max=k), T,
                                    tx, W, H)[0]
        open_ = st[:, tcomp.O_DONE].reshape(T, -1, 32).amin(-1) == 0
        want += int((open_ & (nsub > k)[:, None]).sum())
    assert n_strip == want
    assert n_tile < int(nsub.sum())
    assert 0 < n_strip < 8 * n_tile
