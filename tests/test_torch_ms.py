"""msgs_torch's multi-scale subsystem vs the JAX package's, on the CPU.

- `MsSchedule`: the same levels (the same `random.Random` consumption),
  unlocks and insert targets for max_reso_pow 5, 6 and 7, with and without
  insert_large, ms_from_iter and fine_tail_from — exactly.
- `insert_large_gaussians`: the voxel count, the slots and every integer
  and boolean field exactly; pooled values within 1e-6·(1+|x|).
- A port of tests/test_ms.py:test_ms_training_with_insert_smoke.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.model.gaussians import GaussianConfig as JConfig
from msgs.model.gaussians import create_from_points as jax_create
from msgs.ms.schedule import MsSchedule as JSchedule
from msgs.ms.voxel import _voxel_keys as jax_voxel_keys
from msgs.ms.voxel import insert_large_gaussians as jax_insert
from msgs_torch.core.camera import make_camera
from msgs_torch.kernels.rasterize import RasterSettings
from msgs_torch.model.gaussians import GaussianConfig, create_from_points
from msgs_torch.ms.schedule import MsSchedule as TSchedule
from msgs_torch.ms.schedule import loss_weight, train_scales
from msgs_torch.ms.voxel import _voxel_keys as torch_voxel_keys
from msgs_torch.ms.voxel import insert_large_gaussians as torch_insert
from msgs_torch.train import loop as L
from msgs_torch.train.optimizer import OptimParams
from tests.test_torch_structural import assert_states, to_torch


@pytest.mark.parametrize("max_pow", [5, 6, 7])
@pytest.mark.parametrize("insert_large", [False, True])
@pytest.mark.parametrize("ms_from,tail", [(1, 0), (400, 0), (1, 1500)])
def test_schedule_matches_jax(max_pow, insert_large, ms_from, tail):
    kw = dict(max_reso_pow=max_pow, ms_train=True, insert_large=insert_large,
              ms_from_iter=ms_from, fine_tail_from=tail)
    js = JSchedule(**kw, rng=random.Random(3))
    ts = TSchedule(**kw, rng=random.Random(3))
    assert ts.scales == js.scales and ts.reso_lvls == js.reso_lvls
    assert ts.inc_reso_at == js.inc_reso_at
    assert ts.unlock_groups == js.unlock_groups
    # The trainer's pattern: a level per epoch of 6 views.
    stack, lvl_j, lvl_t = 0, 0, 0
    for it in range(1, 2200):
        if stack == 0:
            lvl_j, lvl_t = js.sample_level(it), ts.sample_level(it)
            stack = 6
        stack -= 1
        assert lvl_t == lvl_j, it
        js.count_iteration(lvl_j)
        ts.count_iteration(lvl_t)
        assert ts.insert_target_for(it) == js.insert_target_for(it), it
        assert ts._unlocked_levels(it) == js._unlocked_levels(it), it
    assert ts.reso_iterations == js.reso_iterations
    assert train_scales(max_pow) == [2 ** i for i in range(max_pow + 1)]
    assert loss_weight(0) == 1.0 and loss_weight(2) == 0.1


def _insert_inputs(seed):
    rng = np.random.default_rng(seed)
    n, C = 96, 256
    pts = np.concatenate([rng.normal(0, 0.8, (n - 16, 3)),
                          rng.normal(0, 4.0, (16, 3))]).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = jax_create(JConfig(sh_degree=1, reso_lvls=4, capacity=C), pts, cols)
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    st = st._replace(
        rotation=st.rotation + f(rng.normal(0, 0.3, (C, 4))),
        opacity=f(rng.normal(0, 2, (C, 1))),
        occ_multiplier=f(rng.normal(1, 0.2, (C, 4))),
        dc_delta=f(rng.normal(0, 0.1, (C, 4, 3))),
        min_pixel_sizes=f(rng.uniform(0.1, 3, C)))
    mask = rng.uniform(size=C) < 0.8
    cur = rng.uniform(0.05, 3.0, C).astype(np.float32)
    return st, mask, cur


@pytest.mark.parametrize("seed,lvl,reso", [(0, 2, 0.1), (1, 4, 0.02),
                                           (2, 6, 0.3)])
def test_insert_large_matches_jax(seed, lvl, reso):
    st, mask, cur = _insert_inputs(seed)
    extent = 2.5
    jk = jax_voxel_keys(st.xyz, jnp.asarray(mask), extent, reso)
    tk = torch_voxel_keys(torch.tensor(np.asarray(st.xyz)),
                          torch.tensor(mask), extent, reso)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jst, jt, jn = jax_insert(st, jnp.asarray(mask), jnp.asarray(cur), lvl,
                             extent, reso)
    tst, tt, tn = torch_insert(to_torch(st), torch.tensor(mask),
                               torch.tensor(cur), lvl, extent, reso)
    assert int(jn) > 1 and int(tn) == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_states(jst, tst)


def test_insert_drops_past_capacity_like_jax():
    """More voxels than free slots: both keep the first ones in key
    order."""
    st, mask, cur = _insert_inputs(3)
    live = np.asarray(st.live).copy()
    live[:250] = True
    st = st._replace(live=jnp.asarray(live))
    jst, jt, jn = jax_insert(st, jnp.asarray(mask), jnp.asarray(cur), 2,
                             2.5, 0.02)
    tst, tt, tn = torch_insert(to_torch(st), torch.tensor(mask),
                               torch.tensor(cur), 2, 2.5, 0.02)
    assert int(jn) == 6 and int(tn) == 6
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_states(jst, tst)


def _setup():
    rng = np.random.default_rng(0)
    n = 64
    pts = np.concatenate([
        rng.uniform(-1, 1, (n, 2)), rng.uniform(3, 6, (n, 1))],
        axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cfg = GaussianConfig(sh_degree=0, reso_lvls=3, capacity=128)
    st = create_from_points(cfg, pts, cols, device="cpu")
    settings = RasterSettings(backend="reference", entry_cap=1 << 12,
                              filter_small=True)
    return cfg, st, settings


def test_ms_training_with_insert_smoke():
    """tests/test_ms.py:137 on the port: levels 0/1/2, pixel statistics
    accumulate per home level, an insert episode adds level-2 aggregates,
    and training continues finite."""
    cfg, st, settings = _setup()
    state = L.init_train_state(st)
    op = OptimParams()
    cams = {lvl: make_camera(np.eye(3), np.zeros(3), 0.9, 0.9,
                             64 // (2 ** lvl), 64 // (2 ** lvl),
                             device="cpu")
            for lvl in range(3)}
    rng = np.random.default_rng(0)
    gt = {lvl: torch.tensor(rng.uniform(
        0, 1, (64 // 2 ** lvl, 64 // 2 ** lvl, 3)).astype(np.float32))
        for lvl in range(3)}
    for it in range(12):
        lvl = [0, 0, 0, 1, 0, 2, 0, 1, 0, 2, 0, 0][it]
        state, m = L.train_step(
            state, cams[lvl], gt[lvl], cfg=cfg, op=op, settings=settings,
            reso_lvl=lvl, spatial_lr_scale=1.0,
            loss_mult=1.0 if lvl == 0 else 0.1)
        assert np.isfinite(float(m["loss"]))

    st = state.gaussians
    assert (st.min_pixel_sizes >= 0).any()
    assert not (st.max_pixel_sizes >= 0).any()

    out2 = L.eval_render(state, cams[2], cfg=cfg, settings=settings,
                         reso_lvl=2)
    px = torch.where(out2.pixel_sizes > 0, out2.pixel_sizes, torch.inf)
    sel = (px < 4.0) & state.gaussians.live
    assert int(sel.sum()) > 0
    n_before = int(state.gaussians.num_live)
    state, n_ins = L.insert_large_step(
        state, sel, torch.where(torch.isfinite(px), px, 0.0), 2,
        scene_extent=6.0, voxel_reso=0.01)
    assert int(n_ins) > 0
    assert int(state.gaussians.num_live) == n_before + int(n_ins)
    assert int((state.gaussians.target_reso_lvl == 2).sum()) == int(n_ins)

    state, m = L.train_step(
        state, cams[0], gt[0], cfg=cfg, op=op, settings=settings,
        reso_lvl=0, spatial_lr_scale=1.0)
    assert np.isfinite(float(m["loss"]))
