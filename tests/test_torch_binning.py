"""msgs_torch binning vs msgs/kernels/binning.py on identical preprocess
outputs: banded and rect paths, and an overflowing entry_cap. Integer
outputs match exactly; gauss_id per tile as a multiset (real entries of one
tile in one depth quantum may come out of either unstable sort in either
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels import binning as jbin
from msgs.kernels.preprocess import preprocess as jax_preprocess
from msgs_torch.kernels import binning as tbin
from msgs_torch.kernels.preprocess import PreprocessOut
from tests.helpers import make_scene
from tests.torch_parity import assert_same, cameras, rotation, t, \
    tile_multisets

FIELDS_EXACT = ("sub_tile", "sub_valid", "tile_nonempty", "tile_last_sub",
                "num_entries", "overflow", "gid_starts")


def _pre(W, H, n, seed):
    means, scales, quats, opac, _ = make_scene(n=n, seed=seed, spread=1.3,
                                               z_range=(1.0, 8.0))
    cols = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    jcam, _ = cameras(W, H, fovx=0.9, R=rotation(seed),
                      T=np.array([0.0, 0.1, 0.3]))
    return jax_preprocess(jcam, jnp.asarray(means), jnp.asarray(opac),
                          colors_precomp=jnp.asarray(cols, jnp.float32),
                          scales=jnp.asarray(scales), quats=jnp.asarray(quats))


@pytest.mark.parametrize("size,row_tight,entry_cap", [
    ((88, 72), None, 1 << 15), ((88, 72), None, 1000),
    ((64, 64), False, 1 << 15)],
    ids=["bands-88x72", "bands-88x72-overflow", "rect-64x64"])
def test_binning_matches_jax(size, row_tight, entry_cap):
    W, H = size
    pre = _pre(W, H, n=800, seed=W)
    a = jbin.bin_gaussians(pre, W, H, entry_cap, row_tight=row_tight)
    b = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, entry_cap,
                           row_tight=row_tight)
    for f in FIELDS_EXACT:
        assert_same(getattr(a, f), getattr(b, f), what=f)
    assert (int(a.overflow) > 0) == (entry_cap == 1000)
    assert int(a.num_entries) > 0
    assert_same(np.asarray(a.gauss_id).shape, np.asarray(b.gauss_id.shape))
    ma = tile_multisets(a.gauss_id, a.sub_tile, a.sub_valid)
    mb = tile_multisets(b.gauss_id, b.sub_tile, b.sub_valid)
    assert ma == mb


def test_capacity_layout_at_bench_shapes():
    """The static layout at 1920×1080, entry_cap 1,417,216 (bench.py)."""
    T = 120 * 68
    cap = 1_417_216
    for mod in (jbin, tbin):
        assert mod.entry_capacity(cap, T) == 1_687_552
        assert mod.block_capacity(cap, T) == 13_184
        assert mod._depth_bits(T) == 18
        assert mod.entry_capacity(cap, T) - mod._pad_ecap(cap) == 270_336
    widths = [17, 21, 7, 18, 7, 7, 7, 7, 7, 7, 7, 7]   # banded, N = 100k
    assert sum(widths) == 119
    assert tbin._pack_planes(widths) == jbin._pack_planes(widths)
    assert tbin._pack_planes(widths)[0] == 4



@pytest.mark.parametrize("ny,nx,seed", [(54, 80, 0), (3, 4, 1), (257, 257, 2)],
                         ids=["m360-x1-grid", "coarse-zoom-grid",
                              "grid-past-shared-memory"])
def test_empty_rectangles_leave_the_histogram_unchanged(ny, nx, seed):
    """csrc/diff_hist.cu skips every rectangle with y0 == y1 or x0 == x1:
    adding such rectangles (on the grid, off it, inverted) to the plain
    corner scatter leaves its grid bit-identical."""
    rng = np.random.default_rng(seed)
    n = 3000
    ys = lambda k: rng.integers(-3, ny + 3, k)
    xs = lambda k: rng.integers(-3, nx + 3, k)
    rects = np.stack([ys(n), ys(n), xs(n), xs(n)])            # any order
    flat_y, flat_x = ys(n), xs(n)
    empty = np.concatenate([np.stack([flat_y, flat_y, xs(n), xs(n)]),
                            np.stack([ys(n), ys(n), flat_x, flat_x])], 1)
    both = np.concatenate([rects, empty], 1)[:, rng.permutation(3 * n)]

    def hist(r):
        r = torch.tensor(r, dtype=torch.int32)
        return tbin._onehot_diff_histogram(r[0], r[1], r[2], r[3], ny, nx)

    want = hist(rects)
    assert want.dtype == torch.int32 and bool((want != 0).any())
    assert torch.equal(hist(both), want)
    assert not bool((hist(empty) != 0).any())
