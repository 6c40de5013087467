"""msgs_torch's row-tight binning (`bin_gaussians(row_tight=True)`) against
msgs/kernels/binning.py on identical preprocess outputs, and on its own:

- every integer output equal to JAX's, `gauss_id` equal per tile as a
  multiset (ties in one depth quantum may come out of either unstable sort
  in either order): tests/test_binning_rowtight.py's `normal` seeds 1 and 7
  and `faint` seed 3 at 64×64; tests/test_torch_binning.py's 88×72 scene at
  entry_cap 2^15 and at 1000 (overflow); the bench.py scene at 1920×1080
  (1,156,045 entries in both packages, fewer than the banded path's
  1,287,252);
- the JAX reference's f32 delta scan rounds the depth-quantum plane at the
  88×72 scene (a standing difference, pinned below with its example), so
  that case is held against JAX with the same deltas scanned in int32;
- the port's row-tight render equals its rect render, and its entry stream
  covers every (Gaussian, tile) pair with a pixel at α ≥ 1/255 in float64,
  as tests/test_binning_rowtight.py:58 and :91 check the JAX path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels import binning as jbin
from msgs.kernels import scan as jscan
from msgs.kernels.preprocess import preprocess as jax_preprocess
from msgs_torch.kernels import binning as tbin
from msgs_torch.kernels.preprocess import ALPHA_MIN, TILE, PreprocessOut
from msgs_torch.kernels.preprocess import preprocess as torch_preprocess
from msgs_torch.kernels.rasterize import RasterSettings, rasterize
from msgs_torch.profile_render import bench_scene
from tests.helpers import make_scene
from tests.torch_parity import assert_same, cameras, rotation, t, \
    tile_multisets

FIELDS_EXACT = ("sub_tile", "sub_valid", "tile_nonempty", "tile_last_sub",
                "num_entries", "overflow", "gid_starts")
BENCH_ENTRIES = 1_156_045      # row-tight, JAX on the CPU and msgs_torch
BANDS_ENTRIES = 1_287_252      # the default banded path, the same scene


def _scene(kind, seed):
    """tests/test_binning_rowtight.py:26-43: (means, scales, quats, opac,
    shs) with SH degree 0."""
    if kind == "normal":
        return make_scene(n=200, seed=seed, sh_degree=0)
    rng = np.random.default_rng(seed)
    n = 64
    means = np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)),
         rng.uniform(3.0, 8.0, (n, 1))], axis=1).astype(np.float32)
    scales = np.exp(rng.uniform(-1.5, -0.2, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.006, 0.08, (n,)).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 1, 3)).astype(np.float32) + 0.8
    return means, scales, quats, opac, shs


def _jax_pre(case):
    """(JAX preprocess output, width, height) of a named case."""
    if case == "88x72":
        # tests/test_torch_binning.py:_pre at 88×72.
        means, scales, quats, opac, _ = make_scene(
            n=800, seed=88, spread=1.3, z_range=(1.0, 8.0))
        cols = np.random.default_rng(88).uniform(0, 1, (800, 3))
        jcam, _ = cameras(88, 72, fovx=0.9, R=rotation(88),
                          T=np.array([0.0, 0.1, 0.3]))
        return jax_preprocess(
            jcam, jnp.asarray(means), jnp.asarray(opac),
            colors_precomp=jnp.asarray(cols, jnp.float32),
            scales=jnp.asarray(scales), quats=jnp.asarray(quats)), 88, 72
    kind, seed = case.split("-")
    means, scales, quats, opac, shs = _scene(kind, int(seed))
    jcam, _ = cameras(64, 64, fovx=0.8)
    return jax_preprocess(
        jcam, jnp.asarray(means), jnp.asarray(opac), shs=jnp.asarray(shs),
        scales=jnp.asarray(scales), quats=jnp.asarray(quats),
        active_sh_degree=0), 64, 64


def _int32_scan(orig):
    """JAX's scan with float32 planes scanned as int32: the planes hold
    integer-valued deltas whose every prefix is an integer below 2^24, so
    this is their exact prefix sum."""
    def scan(x):
        if x.dtype == jnp.float32:
            return orig(x.astype(jnp.int32)).astype(jnp.float32)
        return orig(x)
    return scan


def _assert_binned_equal(a, b):
    for f in FIELDS_EXACT:
        assert_same(getattr(a, f), getattr(b, f), what=f)
    assert_same(np.asarray(a.gauss_id).shape, np.asarray(b.gauss_id.shape))
    assert (tile_multisets(a.gauss_id, a.sub_tile, a.sub_valid)
            == tile_multisets(b.gauss_id, b.sub_tile, b.sub_valid))


@pytest.mark.parametrize("case,entry_cap,jax_scan", [
    ("normal-1", 1 << 15, "own"), ("normal-7", 1 << 15, "own"),
    ("faint-3", 1 << 15, "own"), ("88x72", 1 << 15, "int32"),
    ("88x72", 1000, "own")],
    ids=["normal-1", "normal-7", "faint-3", "88x72", "88x72-overflow"])
def test_rowtight_matches_jax(case, entry_cap, jax_scan, monkeypatch):
    pre, W, H = _jax_pre(case)
    if jax_scan == "int32":
        monkeypatch.setattr(jscan, "cumsum_perm",
                            _int32_scan(jscan.cumsum_perm))
    a = jbin.bin_gaussians(pre, W, H, entry_cap, row_tight=True)
    b = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, entry_cap,
                           row_tight=True)
    _assert_binned_equal(a, b)
    assert (int(a.overflow) > 0) == (entry_cap == 1000)
    rect = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, 1 << 15,
                              row_tight=False)
    assert 0 < int(b.num_entries) <= int(rect.num_entries)


def test_jax_f32_scan_rounds_the_depth_plane_at_88x72():
    """Standing difference. At 30 tiles the depth quantum takes 23 bits, so
    the row-tight delta scan's depth plane carries values up to 2^23 − 2.
    Every prefix of its deltas is an integer below 2^23, exact in f32, yet
    JAX's f32 scan (msgs/kernels/scan.py, interpreted on the CPU) returns
    the plane 2 low from element 1024 on, the first element of its second
    1024-element tile. A quantum of −2 borrows from the tile field of the
    fused key: Gaussian 742, whose rect is tile columns [5, 6) × rows
    [0, 3), lands in tiles 4, 10 and 16 instead of 5, 11 and 17, which
    disagrees with JAX's own per-tile counts. The port's scan is exact and
    gives 5, 11 and 17; so does JAX with the plane scanned in int32
    (test_rowtight_matches_jax[88x72])."""
    pre, W, H = _jax_pre("88x72")
    a = jbin.bin_gaussians(pre, W, H, 1 << 15, row_tight=True)
    b = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, 1 << 15,
                           row_tight=True)
    for f in FIELDS_EXACT:
        if f != "sub_tile":
            assert_same(getattr(a, f), getattr(b, f), what=f)
    diff = np.nonzero(np.asarray(a.sub_tile) != b.sub_tile.numpy())[0]
    assert diff.tolist() == [13, 40, 67]
    assert np.asarray(pre.rect_min)[742].tolist() == [5, 0]
    assert np.asarray(pre.rect_max)[742].tolist() == [6, 3]

    def tiles_of(binned, g):
        gid = np.asarray(binned.gauss_id).reshape(-1, tbin.SUB)
        st = np.asarray(binned.sub_tile)
        sv = np.asarray(binned.sub_valid)
        return sorted(int(st[s]) for s in np.nonzero(sv == 1)[0]
                      for x in gid[s] if x == g)

    assert tiles_of(a, 742) == [4, 10, 16]
    assert tiles_of(b, 742) == [5, 11, 17]


def test_bench_scene_rowtight_matches_jax(monkeypatch):
    """bench.py's scene through JAX's preprocess, binned row-tight by both
    packages (~5 s). Every prefix of the port's 5 f32 delta planes is an
    integer below 2^24, so any association order (the card's scan kernel,
    the plain version) gives the same bits."""
    W, H, cap = 1920, 1080, 1_417_216
    means, scales, quats, opac, cols = bench_scene(0)
    jcam, _ = cameras(W, H, fovx=1.2, fovy=0.8)
    pre = jax.jit(lambda *x: jax_preprocess(
        jcam, x[0], x[1], colors_precomp=x[2], scales=x[3], quats=x[4]))(
            *map(jnp.asarray, (means, opac, cols, scales, quats)))
    a = jax.jit(lambda p: jbin.bin_gaussians(p, W, H, cap,
                                             row_tight=True))(pre)
    scans = []
    plain = tbin.cumsum_rows
    monkeypatch.setattr(tbin, "cumsum_rows",
                        lambda x: scans.append(x) or plain(x))
    b = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, cap,
                           row_tight=True)
    planes = [x for x in scans if tuple(x.shape) == (5, cap)]
    assert len(planes) == 1 and planes[0].dtype == torch.float32
    exact = torch.cumsum(planes[0].double(), dim=1)
    assert float(exact.abs().max()) < 2 ** 24
    assert torch.equal(exact.float(), plain(planes[0]))
    assert int(a.num_entries) == int(b.num_entries) == BENCH_ENTRIES
    assert int(b.overflow) == 0
    _assert_binned_equal(a, b)
    bands = tbin.bin_gaussians(PreprocessOut(*map(t, pre)), W, H, cap)
    assert int(bands.num_entries) == BANDS_ENTRIES > BENCH_ENTRIES


def _port_scene(kind, seed):
    means, scales, quats, opac, shs = _scene(kind, seed)
    _, tcam = cameras(64, 64, fovx=0.8)
    return tcam, (t(means), t(scales), t(quats), t(opac), t(shs))


def _render(cam, scene, row_tight):
    means, scales, quats, opac, shs = scene
    return rasterize(cam, means, opac, shs=shs, scales=scales, quats=quats,
                     active_sh_degree=0, bg=torch.tensor([0.2, 0.3, 0.4]),
                     settings=RasterSettings(backend="reference",
                                             entry_cap=1 << 15,
                                             row_tight=row_tight))


@pytest.mark.parametrize("tight", [True, "bands"])
@pytest.mark.parametrize("kind,seed", [("normal", 1), ("normal", 7),
                                       ("faint", 3)])
def test_rowtight_image_parity(kind, seed, tight):
    """tests/test_binning_rowtight.py:58 on the port."""
    cam, scene = _port_scene(kind, seed)
    rect = _render(cam, scene, row_tight=False)
    rowt = _render(cam, scene, row_tight=tight)
    assert int(rect.overflow) == 0 and int(rowt.overflow) == 0
    assert int(rowt.num_entries) <= int(rect.num_entries)
    for f, tol in (("image", 1e-6), ("depth", 1e-5),
                   ("transmittance", 1e-6), ("pixel_sizes", 1e-6)):
        np.testing.assert_allclose(getattr(rowt, f).numpy(),
                                   getattr(rect, f).numpy(), atol=tol,
                                   err_msg=f)


@pytest.mark.parametrize("tight", [True, "bands"])
@pytest.mark.parametrize("kind,seed", [("normal", 1), ("faint", 3)])
def test_rowtight_coverage_superset_and_invariants(kind, seed, tight):
    """tests/test_binning_rowtight.py:91 on the port: gid_starts' segment
    widths are the per-Gaussian entry counts, and every (Gaussian, tile)
    pair with a pixel at α ≥ 1/255 (float64) is in the entry stream."""
    W = H = 64
    cam, (means, scales, quats, opac, shs) = _port_scene(kind, seed)
    pre = torch_preprocess(cam, means, opac, shs=shs, scales=scales,
                           quats=quats, active_sh_degree=0)
    binned = tbin.bin_gaussians(pre, W, H, 1 << 15, row_tight=tight)
    n = means.shape[0]
    gid = binned.gauss_id.numpy()
    e_tile = np.repeat(binned.sub_tile.numpy(), tbin.SUB)
    e_live = np.repeat(binned.sub_valid.numpy(), tbin.SUB).astype(bool) \
        & (gid < n)
    pairs = set(zip(gid[e_live].tolist(), e_tile[e_live].tolist()))
    counts = np.bincount(gid[e_live], minlength=n)
    np.testing.assert_array_equal(np.diff(binned.gid_starts.numpy()), counts)
    assert int(binned.num_entries) == int(counts.sum())

    m2d = pre.means2d.numpy().astype(np.float64)
    con = pre.conics.numpy().astype(np.float64)
    op = pre.opacities.numpy().astype(np.float64)
    vis = pre.visible.numpy()
    rmin, rmax = pre.rect_min.numpy(), pre.rect_max.numpy()
    tiles_x = (W + TILE - 1) // TILE
    pys, pxs = np.mgrid[0:H, 0:W].astype(np.float64)
    txp = (pxs // TILE).astype(int)
    typ = (pys // TILE).astype(int)
    missing = []
    for g in np.nonzero(vis)[0]:
        dx = pxs - m2d[g, 0]
        dy = pys - m2d[g, 1]
        power = (-0.5 * (con[g, 0] * dx * dx + con[g, 2] * dy * dy)
                 - con[g, 1] * dx * dy)
        alpha = op[g] * np.exp(power)
        in_rect = ((txp >= rmin[g, 0]) & (txp < rmax[g, 0])
                   & (typ >= rmin[g, 1]) & (typ < rmax[g, 1]))
        live = in_rect & (alpha >= ALPHA_MIN) & (power <= 0)
        for tl in np.unique(typ[live] * tiles_x + txp[live]):
            if (int(g), int(tl)) not in pairs:
                missing.append((int(g), int(tl)))
    assert not missing, f"dropped live (gaussian, tile): {missing[:10]}"
