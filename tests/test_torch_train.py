"""The training slice end to end: one msgs_torch `train_step` against the
JAX package's from the same TrainState (carried across with
`train_state_from_numpy`), the overflow discard, and a 60-step smoke run
whose loss must fall below 0.6× its start, as tests/test_train.py requires
of JAX. The model is tests/test_train.py's: 96 Gaussians at 64×64, SH
degree 1, capacity 256; JAX runs its Pallas kernels in interpret mode."""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from msgs.kernels.rasterize import RasterSettings as JSettings
from msgs.model.gaussians import GaussianConfig as JConfig
from msgs.model.gaussians import GaussianState as JGaussianState
from msgs.model.gaussians import create_from_points
from msgs.train import loop as jloop
from msgs.train.optimizer import AdamState as JAdamState
from msgs.train.optimizer import OptimParams as JOptim
from msgs_torch.kernels.rasterize import RasterSettings as TSettings
from msgs_torch.model.gaussians import GaussianConfig as TConfig
from msgs_torch.train import loop as tloop
from msgs_torch.train.optimizer import OptimParams as TOptim
from msgs_torch.train.optimizer import group_lrs
from tests.torch_parity import assert_same, cameras, one_torch_thread

CAP, H, W, N = 256, 64, 64, 96
OPTIM = dict(position_lr_init=1.6e-3, position_lr_final=1.6e-4)
GRAD_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity", "occ_multiplier", "dc_delta")
B1, B2 = 0.9, 0.999


def grad_budget(g):
    return 3e-5 * max(np.abs(g).max(), 1e-8) + 1e-6


def _as_numpy(ts) -> dict:
    """A JAX TrainState as train_state_from_numpy takes it."""
    return {"gaussians": {k: np.asarray(v)
                          for k, v in ts.gaussians._asdict().items()},
            "mu": {k: np.asarray(v) for k, v in ts.adam.mu.items()},
            "nu": {k: np.asarray(v) for k, v in ts.adam.nu.items()},
            "count": np.asarray(ts.adam.count),
            "iteration": np.asarray(ts.iteration)}


def _jax_train_state(arrays):
    """The numpy dict of `_as_numpy` back as a JAX TrainState."""
    j = jnp.asarray
    return jloop.TrainState(
        gaussians=JGaussianState(**{k: j(v) for k, v in
                                    arrays["gaussians"].items()}),
        adam=JAdamState(mu={k: j(v) for k, v in arrays["mu"].items()},
                        nu={k: j(v) for k, v in arrays["nu"].items()},
                        count=j(arrays["count"])),
        iteration=j(arrays["iteration"]))


@functools.lru_cache(maxsize=None)
def _model():
    """(true state, perturbed TrainState) of tests/test_train.py, as numpy
    dicts built by the JAX package (create_from_points' kNN is not ported
    yet)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          rng.uniform(3, 6, (N, 1))], axis=1).astype(
                              np.float32)
    cols = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cfg = JConfig(sh_degree=1, reso_lvls=1, capacity=CAP)
    st_true = create_from_points(cfg, pts, cols)
    pts2 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    cols2 = np.clip(cols + rng.normal(0, 0.2, cols.shape), 0, 1).astype(
        np.float32)
    start = jloop.init_train_state(create_from_points(cfg, pts2, cols2))
    return _as_numpy(jloop.init_train_state(st_true)), _as_numpy(start)


def _targets(cams):
    """Renders of the true model by the port (CPU), one per camera."""
    true, _ = _model()
    st = tloop.train_state_from_numpy(true, device="cpu")
    return [tloop.eval_render(st, c, cfg=TConfig(sh_degree=1, capacity=CAP),
                              settings=TSettings(entry_cap=1 << 12)).image
            for c in cams]


def test_train_step_matches_jax():
    _, start = _model()
    jcam, tcam = cameras(W, H, fovx=0.9)
    gt = _targets([tcam])[0]
    kw = dict(reso_lvl=0, spatial_lr_scale=1.0)
    jstate, jm = jloop.train_step(
        _jax_train_state(start), jcam,
        jnp.asarray(gt.numpy()), cfg=JConfig(sh_degree=1, capacity=CAP),
        op=JOptim(**OPTIM), settings=JSettings(backend="pallas",
                                               entry_cap=1 << 12), **kw)
    tstate, tm = tloop.train_step(
        tloop.train_state_from_numpy(start, device="cpu"), tcam, gt,
        cfg=TConfig(sh_degree=1, capacity=CAP), op=TOptim(**OPTIM),
        settings=TSettings(entry_cap=1 << 12), **kw)
    assert int(tm["overflow"]) == 0 and int(tm["num_entries"]) > 0
    for k in ("num_entries", "overflow", "num_live"):
        assert_same(jm[k], tm[k], what=k)
    for k in ("loss", "l1"):
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= 3e-5 * abs(want) + 1e-6, k

    # The gradients, read back through Adam's first-step moments:
    # mu = (1−b1)·g and nu = (1−b2)·g².
    lrs = {k: float(v) for k, v in group_lrs(
        TOptim(**OPTIM), 1.0, torch.tensor(0)).items()}
    for k in GRAD_FIELDS:
        g_j = np.asarray(jstate.adam.mu[k]) / (1 - B1)
        g_t = tstate.adam.mu[k].numpy() / (1 - B1)
        budget = grad_budget(g_j)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=budget,
                                   err_msg=f"grad {k}")
        np.testing.assert_allclose(
            np.sqrt(tstate.adam.nu[k].numpy() / (1 - B2)),
            np.sqrt(np.asarray(jstate.adam.nu[k]) / (1 - B2)), rtol=0,
            atol=budget, err_msg=f"|grad| {k}")
        # At Adam's first step the update is g/|g|: where |g| lies within
        # the budget of 0 the two packages may step in opposite directions,
        # so there the parameters agree to 2·lr of the group; elsewhere
        # they take the same step and agree to rounding.
        p_j = np.asarray(getattr(jstate.gaussians, k))
        p_t = getattr(tstate.gaussians, k).numpy()
        loose = np.abs(g_j) <= budget
        atol = np.where(loose, 2 * lrs[k] + 1e-6, 1e-6 + 1e-6 * np.abs(p_j))
        assert (np.abs(p_t - p_j) <= atol).all(), f"param {k}"
    assert np.abs(np.asarray(jstate.adam.mu["xyz"])).max() > 0
    assert np.abs(np.asarray(jstate.gaussians.xyz_grad_accum)).max() > 0

    for k in ("max_radii2d", "max_pixel_sizes", "min_pixel_sizes",
              "xyz_grad_accum", "denom"):
        want = np.asarray(getattr(jstate.gaussians, k))
        np.testing.assert_allclose(getattr(tstate.gaussians, k).numpy(),
                                   want, rtol=0, atol=grad_budget(want),
                                   err_msg=k)
    for k in ("live", "base_mask", "target_reso_lvl", "active_sh_degree"):
        assert_same(getattr(jstate.gaussians, k),
                    getattr(tstate.gaussians, k), what=k)
    assert_same(jstate.adam.count, tstate.adam.count, what="count")
    assert_same(jstate.iteration, tstate.iteration, what="iteration")


def test_overflow_step_is_discarded():
    _, start = _model()
    _, tcam = cameras(W, H, fovx=0.9)
    gt = _targets([tcam])[0]
    state = tloop.train_state_from_numpy(start, device="cpu")
    # Larger splats, so the entries pass the smallest capacity (1024).
    state = state._replace(gaussians=state.gaussians._replace(
        scaling=state.gaussians.scaling + 1.5))
    new, m = tloop.train_step(
        state, tcam, gt, cfg=TConfig(sh_degree=1, capacity=CAP),
        op=TOptim(**OPTIM), settings=TSettings(entry_cap=1024), reso_lvl=0,
        spatial_lr_scale=1.0)
    assert int(m["overflow"]) > 0
    assert int(new.iteration) == int(state.iteration) + 1
    for a, b in zip(new.gaussians, state.gaussians):
        assert torch.equal(a, b)
    for k in GRAD_FIELDS:
        assert torch.equal(new.adam.mu[k], state.adam.mu[k])
        assert torch.equal(new.adam.nu[k], state.adam.nu[k])
    assert torch.equal(new.adam.count, state.adam.count)


def test_training_reduces_loss():
    _, start = _model()
    cams = [cameras(W, H, fovx=0.9, T=np.array([dx, 0, 0]))[1]
            for dx in (-0.3, 0.0, 0.3)]
    gts = _targets(cams)
    state = tloop.train_state_from_numpy(start, device="cpu")
    losses = []
    # 60 steps of small ops: torch on one thread (one_torch_thread).
    with one_torch_thread():
        for it in range(60):
            state, m = tloop.train_step(
                state, cams[it % 3], gts[it % 3],
                cfg=TConfig(sh_degree=1, capacity=CAP), op=TOptim(**OPTIM),
                settings=TSettings(entry_cap=1 << 12), reso_lvl=0,
                spatial_lr_scale=1.0)
            losses.append(float(m["loss"]))
    first, last = np.mean(losses[:6]), np.mean(losses[-6:])
    assert np.isfinite(last)
    assert last < 0.6 * first, (first, last)
