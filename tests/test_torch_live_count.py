"""msgs_torch.tools.live_count on the CPU.

- `reference_flags` turns data/quality/ms/cfg_args.json into the port
  trainer's flags: parsed back, every training setting of the JAX run is
  the one the file records.
- `composite_contributed`, the contribution test the JAX package used when
  that run's log was made (a Gaussian contributes when one of its entries
  has a nonzero blend weight α·T at some pixel), against every pixel
  walking its tile's entries one at a time in the binning's order (T
  updated step by step, where the tool takes one cumulative product over
  the tile), on scenes where an opaque front layer hides most Gaussians
  behind it; and against the test the port uses (an emitted entry), which
  it must narrow, not widen.
"""
import json
import os

import numpy as np
import pytest
import torch

from msgs_torch.apps.train import build_parser
from msgs_torch.core.camera import make_camera
from msgs_torch.kernels import composite as comp
from msgs_torch.kernels import rasterize as R
from msgs_torch.kernels.preprocess import ALPHA_MAX, ALPHA_MIN, T_EPS, \
    TILE, preprocess
from msgs_torch.tools import live_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reference_flags_give_the_jax_runs_settings():
    cfg = json.load(open(os.path.join(ROOT, "data", "quality", "ms",
                                      "cfg_args.json")))
    flags = live_count.reference_flags()
    args = vars(build_parser().parse_args(flags + ["-s", "x", "-m", "y"]))
    checked = 0
    for k, v in cfg.items():
        if k in live_count.SKIP or k not in args:
            continue
        assert args[k] == v, (k, args[k], v)
        checked += 1
    assert checked >= 30 and "--insert_large" in flags


def _scene(seed, n=2500, n_front=500):
    rng = np.random.default_rng(seed)
    m = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                        rng.uniform(2.0, 6.0, (n, 1))], 1).astype(np.float32)
    sc = np.exp(rng.uniform(-4, -1.5, (n, 3))).astype(np.float32)
    op = rng.uniform(0.3, 0.99, n).astype(np.float32)
    # An opaque front layer of large splats.
    m[:n_front, 2] = rng.uniform(1.5, 1.8, n_front)
    sc[:n_front] = np.exp(rng.uniform(-2.2, -1.6, (n_front, 3)))
    op[:n_front] = 0.99
    q = rng.normal(size=(n, 4)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return [torch.tensor(a) for a in (m, op, sc, q, col)]


def brute_force_contributed(pre, width, height, binned):
    """Every pixel walks its tile's entries one at a time, in the order the
    binning sorted them (by depth quantum; within a quantum the sort's), as
    a sequential product of (1 − α); an entry whose step would take T
    below T_EPS ends the pixel's walk."""
    tiles_x = (width + TILE - 1) // TILE
    tiles = tiles_x * ((height + TILE - 1) // TILE)
    first, n_sub = comp.tile_sub_ranges(binned.sub_tile, binned.sub_valid,
                                        binned.tile_last_sub, tiles)
    gid = binned.gauss_id.reshape(-1, comp.SUB)
    n = pre.depths.shape[0]
    out = torch.zeros(n, dtype=torch.bool)
    for tile in range(tiles):
        ys, xs = torch.meshgrid(
            torch.arange(TILE, dtype=torch.float32) + tile // tiles_x * TILE,
            torch.arange(TILE, dtype=torch.float32) + tile % tiles_x * TILE,
            indexing="ij")
        inside = (xs < width) & (ys < height)
        xs, ys = xs[inside], ys[inside]
        t = torch.ones_like(xs)
        alive = torch.ones_like(xs, dtype=torch.bool)
        f = int(first[tile])
        for g in gid[f:f + int(n_sub[tile])].reshape(-1).tolist():
            if g == n:
                continue
            dx = xs - pre.means2d[g, 0]
            dy = ys - pre.means2d[g, 1]
            cxx, cxy, cyy = pre.conics[g]
            power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
            a_raw = pre.opacities[g] * torch.exp(power)
            a = torch.where((a_raw >= ALPHA_MIN) & (power <= 0),
                            torch.clamp(a_raw, max=ALPHA_MAX), 0.0)
            t_after = t * (1 - a)
            alive = alive & (t_after >= T_EPS)
            out[g] |= bool(((a * t) * alive > 0).any())
            t = torch.where(alive, t_after, t)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_contribution_matches_brute_force(seed, monkeypatch):
    W, H = 96, 80
    m, op, sc, q, col = _scene(seed)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.8, W, H, device="cpu")
    settings = R.RasterSettings(entry_cap=1 << 18)
    kw = dict(colors_precomp=col, scales=sc, quats=q, settings=settings)
    entries = R.rasterize(cam, m, op, **kw).pixel_sizes > 0
    monkeypatch.setattr(R, "composite_pipeline", R.composite_pipeline)
    live_count.use_composite_contribution()
    composite = R.rasterize(cam, m, op, **kw).pixel_sizes > 0
    pre = preprocess(cam, m, op, colors_precomp=col, scales=sc, quats=q)
    binned = R.bin_gaussians(pre, W, H, settings.entry_cap)
    want = brute_force_contributed(pre, W, H, binned)
    assert torch.equal(composite, want), int((composite != want).sum())
    # One tile a chunk gives the same flags.
    assert torch.equal(live_count.composite_contributed(
        pre, W, H, binned, chunk_elems=1), want)
    # Occlusion narrows the set: most Gaussians behind the front layer
    # have an entry but no weight.
    assert bool((composite <= entries).all())
    assert int(composite.sum()) < 0.5 * int(entries.sum())
