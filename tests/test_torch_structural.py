"""msgs_torch structural mutations vs the JAX package's, on the CPU.

kNN, create_from_points, _alloc_slots, clone / split / prune /
densify_and_prune / grow / opacity reset, and the TrainState steps that
zero Adam moments at the touched rows. The same numpy inputs go through
both packages; the split's normal draws are JAX's own, passed to the port
as `noise`. Budgets: boolean and integer fields (live, target_reso_lvl, the
touched masks, which Adam rows are zeroed) exactly; floats within
1e-6·(1+|x|). The one exception is kNN: d² = |a|² + |b|² − 2a·b cancels,
and XLA and torch sum the three-term |a|² in different orders (measured:
22% of rows differ in the last bit), so kNN, and the log-scales made from
it, get the f32 rounding of those terms, 8·2⁻²⁴·max|p|², on top."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels.knn import knn_mean_sq_dist as jax_knn
from msgs.model import gaussians as JG
from msgs.train import loop as jloop
from msgs.train.optimizer import OptimParams as JOptim
from msgs_torch.kernels.knn import knn_mean_sq_dist as torch_knn
from msgs_torch.model import gaussians as TG
from msgs_torch.train import loop as tloop
from msgs_torch.train.optimizer import OptimParams as TOptim

CFG = dict(sh_degree=2, reso_lvls=3, capacity=256)


def knn_budget(pts):
    return 8 * 2.0 ** -24 * float((pts.astype(np.float64) ** 2).sum(1).max())


def assert_close(want, got, what, extra=0.0):
    """Exact for bool / int, 1e-6·(1+|x|) (+ extra) for floats."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind in "biu":
        bad = np.argwhere(want != got)
        assert bad.size == 0, f"{what}: {len(bad)} mismatches, first {bad[:5]}"
    else:
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all(), what
        err = (np.abs(got[fin] - want[fin]) - 1e-6 * (1 + np.abs(want[fin]))
               - extra)
        assert (err <= 0).all(), f"{what}: max excess {err.max()}"


def assert_states(jst, tst, what="", extra=None):
    extra = extra or {}
    for k in JG.GaussianState._fields:
        assert_close(getattr(jst, k), getattr(tst, k), f"{what}{k}",
                     extra.get(k, 0.0))


def to_torch(jst):
    return TG.state_from_numpy({k: np.asarray(v)
                                for k, v in jst._asdict().items()},
                               device="cpu")


@functools.lru_cache(maxsize=None)
def _points(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _jstate(n=64, seed=0):
    """A JAX state with varied scales, opacities, levels and statistics."""
    pts, cols = _points(n, seed)
    st = JG.create_from_points(JG.GaussianConfig(**CFG), pts, cols)
    rng = np.random.default_rng(seed + 1)
    C = CFG["capacity"]
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    lvl = np.zeros(C, np.int32)
    lvl[:n] = rng.choice([0, 0, 0, 1, 2], n)
    return st._replace(
        scaling=st.scaling + f(np.where(np.arange(C)[:, None] < n,
                                        rng.uniform(-1, 2.5, (C, 3)), 0)),
        rotation=st.rotation + f(np.where(np.arange(C)[:, None] < n,
                                          rng.normal(0, 0.5, (C, 4)), 0)),
        opacity=f(rng.normal(-1, 3, (C, 1))),
        target_reso_lvl=jnp.asarray(lvl),
        max_radii2d=f(rng.uniform(0, 40, C)),
        max_pixel_sizes=f(np.where(rng.uniform(size=C) < 0.5, -1,
                                   rng.uniform(0.5, 5, C))),
        min_pixel_sizes=f(np.where(rng.uniform(size=C) < 0.5, -1,
                                   rng.uniform(0.5, 5, C))),
        xyz_grad_accum=f(rng.uniform(0, 6e-3, (C, 3))),
        denom=f(rng.integers(0, 4, (C, 3))))


def test_knn_matches_jax():
    pts = np.random.default_rng(0).normal(0, 1, (1500, 3)).astype(np.float32)
    want = np.asarray(jax_knn(jnp.asarray(pts), k=3))
    got = torch_knn(torch.tensor(pts), k=3)
    assert_close(want, got, "knn", knn_budget(pts))


def test_create_from_points_matches_jax():
    pts, cols = _points()
    jst = JG.create_from_points(JG.GaussianConfig(**CFG), pts, cols)
    tst = TG.create_from_points(TG.GaussianConfig(**CFG), pts, cols,
                                device="cpu")
    # log √d² moves by |Δd²| / (2·d²).
    d2 = np.asarray(jax_knn(jnp.asarray(pts), k=3))
    assert_states(jst, tst, extra={
        "scaling": knn_budget(pts) / (2 * d2.min())})


@pytest.mark.parametrize("copies", [1, 2])
def test_alloc_slots_matches_jax(copies):
    rng = np.random.default_rng(copies)
    C = 96
    for live_frac in (0.3, 0.8):
        live = rng.uniform(size=C) < live_frac
        want = rng.uniform(size=C) < 0.5
        js, jok = JG._alloc_slots(jnp.asarray(live), jnp.asarray(want), copies)
        ts, tok = TG._alloc_slots(torch.tensor(live), torch.tensor(want),
                                  copies)
        assert_close(js, ts, "slots")
        assert_close(jok, tok, "ok")


def _grads(seed=3):
    return np.random.default_rng(seed).uniform(
        0, 4e-4, CFG["capacity"]).astype(np.float32)


def _split_noise(key):
    C = CFG["capacity"]
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (C, 3))) for i in range(2)])


@pytest.mark.parametrize("op", ["clone", "split", "prune", "reset",
                                "grow1", "grow2"])
def test_mutation_matches_jax(op):
    jst = _jstate()
    tst = to_torch(jst)
    g = _grads()
    key = jax.random.PRNGKey(7)
    if op == "clone":
        jo, jt = JG.densify_clone(jst, jnp.asarray(g), 2e-4, 0.1, 30.0)
        to, tt = TG.densify_clone(tst, torch.tensor(g), 2e-4, 0.1, 30.0)
    elif op == "split":
        jo, jt = JG.densify_split(jst, jnp.asarray(g), 2e-4, 0.1, 30.0, key)
        to, tt = TG.densify_split(tst, torch.tensor(g), 2e-4, 0.1, 30.0,
                                  noise=torch.tensor(_split_noise(key)))
    elif op == "prune":
        m = np.random.default_rng(4).uniform(size=CFG["capacity"]) < 0.3
        jo, jt = JG.prune(jst, jnp.asarray(m)), jst.live
        to, tt = TG.prune(tst, torch.tensor(m)), tst.live
    elif op == "reset":
        jo, jt = JG.reset_opacity(jst)
        to, tt = TG.reset_opacity(tst)
    else:
        lvl = int(op[-1])
        jo, jt = JG.grow_large_gaussians(jst, lvl, grad_threshold=2e-4)
        to, tt = TG.grow_large_gaussians(tst, lvl, grad_threshold=2e-4)
    assert np.asarray(jt).any()
    assert_close(jt, tt, "touched")
    assert_states(jo, to)


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0])
def test_densify_and_prune_matches_jax(max_screen_size):
    jst = _jstate()
    key = jax.random.PRNGKey(11)
    kw = dict(grad_threshold=2e-4, min_opacity=0.005, scene_extent=30.0,
              max_screen_size=max_screen_size, percent_dense=0.1)
    jo, jt = JG.densify_and_prune(jst, key, **kw)
    to, tt = TG.densify_and_prune(to_torch(jst), None, **kw,
                                  noise=torch.tensor(_split_noise(key)))
    assert int(jo.num_live) != int(jst.num_live)
    assert_close(jt, tt, "touched")
    assert_states(jo, to)


def test_filter_center_and_prune_small():
    jst = _jstate()
    jo = JG.filter_center(jst, [0.2, -0.1, 0.3], 1.0)
    to = TG.filter_center(to_torch(jst), [0.2, -0.1, 0.3], 1.0)
    assert 0 < int(jo.num_live) < int(jst.num_live)
    assert_states(jo, to)
    with pytest.raises(NotImplementedError):
        TG.prune_small_points(to)


def _train_states():
    """A JAX TrainState with nonzero moments, and the port's copy of it."""
    jst = _jstate()
    rng = np.random.default_rng(5)
    params = jst.params()
    mu = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
          for k, v in params.items()}
    nu = {k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
          for k, v in params.items()}
    js = jloop.init_train_state(jst)
    js = js._replace(adam=js.adam._replace(mu=mu, nu=nu,
                                           count=jnp.int32(9)),
                     iteration=jnp.int32(9))
    arrays = {"gaussians": {k: np.asarray(v)
                            for k, v in jst._asdict().items()},
              "mu": {k: np.asarray(v) for k, v in mu.items()},
              "nu": {k: np.asarray(v) for k, v in nu.items()},
              "count": np.int32(9), "iteration": np.int32(9)}
    return js, tloop.train_state_from_numpy(arrays, device="cpu")


def assert_train_states(js, ts):
    assert_states(js.gaussians, ts.gaussians)
    for k in js.adam.mu:
        assert_close(js.adam.mu[k], ts.adam.mu[k], f"mu {k}")
        assert_close(js.adam.nu[k], ts.adam.nu[k], f"nu {k}")
        # Which rows were zeroed, exactly.
        assert_close(np.asarray(js.adam.mu[k]) == 0, ts.adam.mu[k] == 0,
                     f"zeroed mu rows {k}")
    assert_close(js.adam.count, ts.adam.count, "count")
    assert_close(js.iteration, ts.iteration, "iteration")


@pytest.mark.parametrize("step", ["densify", "grow", "reset", "insert"])
def test_train_state_steps_match_jax(step):
    js, ts = _train_states()
    op = dict(densify_grad_threshold=2e-4, percent_dense=0.1)
    if step == "densify":
        key = jax.random.PRNGKey(3)
        jo = jloop.densify_step(js, key, op=JOptim(**op), scene_extent=30.0,
                                max_screen_size=20.0)
        to = tloop.densify_step(ts, None, op=TOptim(**op), scene_extent=30.0,
                                max_screen_size=20.0,
                                noise=torch.tensor(_split_noise(key)))
    elif step == "grow":
        jo = jloop.grow_step(js, 1, op=JOptim(**op))
        to = tloop.grow_step(ts, 1, op=TOptim(**op))
    elif step == "reset":
        jo = jloop.reset_opacity_step(js)
        to = tloop.reset_opacity_step(ts)
    else:
        rng = np.random.default_rng(8)
        C = CFG["capacity"]
        sel = (rng.uniform(size=C) < 0.6) & np.asarray(js.gaussians.live)
        cur = rng.uniform(0.1, 3.0, C).astype(np.float32)
        jo, jn = jloop.insert_large_step(
            js, jnp.asarray(sel), jnp.asarray(cur), 2, scene_extent=1.5,
            voxel_reso=0.3)
        to, tn = tloop.insert_large_step(
            ts, torch.tensor(sel), torch.tensor(cur), 2, scene_extent=1.5,
            voxel_reso=0.3)
        assert int(jn) > 0
        assert_close(jn, tn, "n_inserted")
    assert_train_states(jo, to)
