"""msgs_torch.ms.backproject against msgs.ms.backproject on the CPU.

The same numpy footprint map, depth, image, camera and state go through
both packages' `add_large_gaussians_backproject`, in the three capacity
cases: fewer blocks than slots (the candidate list padded), at least as
many (cut to the capacity), and fewer free slots than wanted blocks (the
allocator drops the rest). `touched`, `n_inserted`, `live`,
`target_reso_lvl`, `base_mask` and the pixel-size records must be equal;
every float field within 1e-6·max|x| + 1e-7 of JAX's.

A block whose pooled coverage lies within 4 ulp of the threshold may come
out on either side: the two packages sum a block's mean in different
orders. Such blocks are counted from the inputs in float64
(`chip_smoke.near_threshold_blocks`, which [io] uses too); where there
are none the results must agree exactly as above, and where there are some
`n_inserted` may differ by at most their count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.ms.backproject import add_large_gaussians_backproject as jax_bp
from msgs.model import gaussians as JG
from msgs_torch.ms.backproject import add_large_gaussians_backproject as t_bp
from msgs_torch.model import gaussians as TG
from chip_smoke import near_threshold_blocks
from tests.torch_parity import cameras, rotation

EXACT = ("live", "target_reso_lvl", "base_mask", "max_pixel_sizes",
         "min_pixel_sizes")
THRESHOLD = 1.0
BLOCK = 4


def _state(capacity, n_live, seed):
    """A JAX state with `n_live` rows scattered over the capacity and
    varied side state, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n_live, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_live, 3)).astype(np.float32)
    cfg = JG.GaussianConfig(sh_degree=2, reso_lvls=4, capacity=capacity)
    st = JG.create_from_points(cfg, pts, cols)
    # Move the live rows to random places, so free slots are interleaved.
    perm = rng.permutation(capacity)
    f = lambda a: jnp.asarray(np.asarray(a)[perm])
    st = st._replace(**{k: f(getattr(st, k)) for k in st._fields
                        if k != "active_sh_degree"})
    st = st._replace(
        max_pixel_sizes=jnp.asarray(rng.uniform(0.5, 5, capacity)
                                    .astype(np.float32)),
        min_pixel_sizes=jnp.asarray(rng.uniform(0.5, 5, capacity)
                                    .astype(np.float32)),
        base_mask=jnp.asarray(rng.uniform(size=capacity) < 0.5),
        target_reso_lvl=jnp.asarray(rng.integers(0, 4, capacity)
                                    .astype(np.int32)))
    tst = TG.state_from_numpy({k: np.asarray(v)
                               for k, v in st._asdict().items()},
                              device="cpu")
    return st, tst


def _maps(width, height, seed):
    """Footprint map around the threshold, depth with empty blocks, image."""
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0, 2 * THRESHOLD, (height, width)).astype(np.float32)
    depth = rng.uniform(0.5, 6.0, (height, width)).astype(np.float32)
    empty = rng.uniform(size=(height // BLOCK, width // BLOCK)) < 0.15
    depth[:empty.shape[0] * BLOCK, :empty.shape[1] * BLOCK] *= ~np.kron(
        empty, np.ones((BLOCK, BLOCK), bool))
    image = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    return acc, depth, image


def _close(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if what in EXACT or want.dtype.kind in "biu":
        assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
        bad = np.argwhere(want != got)
        assert bad.size == 0, f"{what}: {len(bad)} differ, first {bad[:5]}"
    else:
        tol = 1e-6 * float(np.abs(want).max(initial=0.0)) + 1e-7
        err = float(np.abs(got - want).max(initial=0.0))
        assert err <= tol, f"{what}: max |Δ| {err} > {tol}"


# (width, height, capacity, live rows): blocks M = (W/4)·(H/4).
CASES = {
    "blocks_below_capacity": (36, 30, 256, 64),      # M = 63 < C
    "blocks_cut_to_capacity": (80, 72, 256, 16),     # M = 360 ≥ C
    "few_free_slots": (40, 32, 256, 248),            # 8 free, ~30 wanted
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backproject_matches_jax(case):
    width, height, capacity, n_live = CASES[case]
    seed = sorted(CASES).index(case)
    jst, tst = _state(capacity, n_live, seed)
    acc, depth, image = _maps(width, height, seed + 10)
    jcam, tcam = cameras(width, height, fovx=0.9, fovy=0.8,
                         R=rotation(seed + 20), T=np.array([0.3, -0.2, 1.5]))
    lvl = 3
    jout, jtouched, jn = jax_bp(jst, jcam, jnp.asarray(acc),
                                jnp.asarray(depth), jnp.asarray(image), lvl,
                                block=BLOCK, coverage_threshold=THRESHOLD)
    tout, ttouched, tn = t_bp(tst, tcam, torch.tensor(acc),
                              torch.tensor(depth), torch.tensor(image), lvl,
                              block=BLOCK, coverage_threshold=THRESHOLD)
    ties = near_threshold_blocks(acc, BLOCK, THRESHOLD)
    print(f"{case}: n_inserted JAX {int(jn)}, port {int(tn)}; "
          f"{ties} block(s) within 4 ulp of the threshold")
    if ties and not np.array_equal(np.asarray(jtouched), ttouched.numpy()):
        assert abs(int(jn) - int(tn)) <= ties
        return
    assert int(jn) == int(tn) and tn.dtype == torch.int32
    _close(jtouched, ttouched, "touched")
    for k in JG.GaussianState._fields:
        _close(getattr(jout, k), getattr(tout, k), k)
    free = capacity - n_live
    blocks = (width // BLOCK) * (height // BLOCK)
    # The case is what its name says.
    if case == "blocks_below_capacity":
        assert blocks < capacity and 0 < int(tn) < free
    elif case == "blocks_cut_to_capacity":
        assert blocks >= capacity and 0 < int(tn)
    else:
        assert int(tn) == free      # more blocks wanted than free slots
    assert int(tout.num_live) == n_live + int(tn)
    lv = tout.target_reso_lvl[ttouched]
    assert lv.dtype == torch.int32 and bool((lv == lvl).all())


def test_backproject_cut_keeps_the_first_blocks():
    """Truncation keeps the first C blocks in row-major order: a map whose
    only under-covered blocks lie past the first C inserts nothing."""
    width, height, capacity = 80, 72, 256
    jst, tst = _state(capacity, 16, 5)
    acc = np.full((height, width), 2.0, np.float32)
    acc[-BLOCK:, :] = 0.0          # the last row of blocks: M − 20 ≥ C
    depth = np.full((height, width), 2.0, np.float32)
    image = np.full((height, width, 3), 0.5, np.float32)
    jcam, tcam = cameras(width, height)
    _, _, jn = jax_bp(jst, jcam, jnp.asarray(acc), jnp.asarray(depth),
                      jnp.asarray(image), 2)
    _, touched, tn = t_bp(tst, tcam, torch.tensor(acc), torch.tensor(depth),
                          torch.tensor(image), 2)
    assert int(jn) == int(tn) == 0 and not bool(touched.any())
