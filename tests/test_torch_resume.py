"""Checkpoint resume proofs for msgs_torch, ports of
tests/test_interop.py:194 and :207 on the CPU: `save_train_state` then
`load_train_state` continues training bit for bit against the run that
never stopped, also after `grow_capacity` and when the loader's template
still has the original capacity."""
import os

import numpy as np
import torch

from msgs_torch.core.camera import make_camera
from msgs_torch.kernels.rasterize import RasterSettings
from msgs_torch.model.gaussians import GaussianConfig, create_from_points
from msgs_torch.train import loop as L
from msgs_torch.train.checkpoint import _leaves, grow_capacity, \
    load_train_state, save_train_state
from msgs_torch.train.optimizer import OptimParams
from tests.torch_parity import one_torch_thread


def _tiny_setup():
    """tests/test_interop.py:_tiny_setup on the port."""
    rng = np.random.default_rng(0)
    n = 60
    cfg = GaussianConfig(sh_degree=1, reso_lvls=2, capacity=128)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(2.5, 6.0, (n, 1))], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = L.init_train_state(create_from_points(cfg, pts, cols,
                                                  device="cpu"))
    cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 32, 32, device="cpu")
    gt = torch.as_tensor(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    settings = RasterSettings(backend="reference", entry_cap=1 << 12)
    return cfg, state, cam, gt, OptimParams(), settings


def _steps(state, k, cfg, cam, gt, op, settings):
    with one_torch_thread():
        for _ in range(k):
            state, _ = L.train_step(state, cam, gt, cfg=cfg, op=op,
                                    settings=settings, reso_lvl=0,
                                    spatial_lr_scale=1.0)
    return state


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y), i


def test_checkpoint_resume_bit_identical(tmp_path):
    cfg, state, cam, gt, op, settings = _tiny_setup()
    state = _steps(state, 3, cfg, cam, gt, op, settings)
    path = os.path.join(tmp_path, "ck.npz")
    save_train_state(path, state)

    cont = _steps(state, 5, cfg, cam, gt, op, settings)
    resumed = load_train_state(path, state)
    _assert_states_equal(resumed, state)
    resumed = _steps(resumed, 5, cfg, cam, gt, op, settings)
    assert int(resumed.iteration) == 8
    _assert_states_equal(cont, resumed)


def test_checkpoint_resume_across_capacity_growth(tmp_path):
    cfg, state, cam, gt, op, settings = _tiny_setup()
    state = _steps(state, 2, cfg, cam, gt, op, settings)
    state = grow_capacity(state, 256)
    cfg2 = cfg._replace(capacity=256)
    state = _steps(state, 2, cfg2, cam, gt, op, settings)
    path = os.path.join(tmp_path, "ck_grown.npz")
    save_train_state(path, state)

    cont = _steps(state, 3, cfg2, cam, gt, op, settings)
    # A fresh template at the original capacity: the loader adopts the
    # checkpoint's grown shapes (the trainer then takes cfg's capacity from
    # them, as msgs_torch/apps/train.py does on resume).
    _, fresh, *_ = _tiny_setup()
    resumed = load_train_state(path, fresh)
    assert int(resumed.gaussians.xyz.shape[0]) == 256
    resumed = _steps(resumed, 3, cfg2, cam, gt, op, settings)
    _assert_states_equal(cont, resumed)
