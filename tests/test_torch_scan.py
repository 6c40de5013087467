"""msgs_torch prefix scan vs msgs/kernels/scan.py:cumsum_perm, and the
bit-packed delta-scan planes of binning (the CUDA kernel vs its plain version
is in test_torch_cuda.py).

The JAX kernel scans a sublane-major permuted layout; the test maps logical
rows into it as tests/test_scan_kernel.py does. float32 rows are integer
valued with partial sums below 2^24; int32 rows carry negative deltas and
running sums up to ±(2^31 − 1), where any reordering of the adds would wrap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels import binning as jbin
from msgs.kernels.scan import SUBL, TILE_E, cumsum_perm, perm_shape
from msgs_torch.kernels import binning as tbin
from msgs_torch.kernels import scan as tscan
from tests.torch_parity import assert_same, t

I32_MAX = 2**31 - 1


def _rows(dtype, R, E, seed):
    """Logical (R, E) rows whose inclusive prefix sums are exact."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.integers(-6, 9, (R, E)).astype(np.float32)
    # A clipped random walk through the whole int32 range (down, up, down):
    # steps ≤ 2^30, so every delta fits in int32 and the sums touch both
    # ends of the range.
    steps = rng.integers(-2**29, 2**29, (R, E)).astype(np.int64)
    drift = np.where((np.arange(E) * 3 // E) == 1, 2**29, -2**29)
    steps += drift
    walk = np.clip(np.cumsum(steps, axis=1), -I32_MAX, I32_MAX)
    deltas = np.diff(walk, axis=1, prepend=0)
    assert np.abs(deltas).max() < 2**31
    assert walk.max() == I32_MAX and walk.min() == -I32_MAX
    return deltas.astype(np.int32)


def _to_perm(logical):
    R, E = logical.shape
    x = np.zeros((R,) + perm_shape(E), logical.dtype)
    idx = np.arange(E)
    x[:, idx % SUBL, idx // SUBL] = logical
    return x, (idx % SUBL, idx // SUBL)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_cumsum_rows_matches_jax(dtype):
    R, E = 3, 4 * TILE_E
    logical = _rows(dtype, R, E, seed=11)
    x, (s, l) = _to_perm(logical)
    want = np.asarray(cumsum_perm(jnp.asarray(x)))[:, s, l]
    got = tscan.cumsum_rows(t(logical))
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.int32)
    assert_same(want, got, what=f"cumsum {dtype}")
    if dtype == np.int32:
        assert want.max() == I32_MAX and want.min() == -I32_MAX


def test_pack_planes_roundtrip():
    """Fields split across planes survive pack → delta scan → unpack: every
    slot of a Gaussian's segment reads back that Gaussian's fields."""
    widths = [17, 20, 23, 18, 9, 14, 5]
    n_planes, chunks = tbin._pack_planes(widths)
    assert (n_planes, chunks) == jbin._pack_planes(widths)
    assert any(len(c) > 1 for c in chunks), "no cross-plane split exercised"
    rng = np.random.default_rng(3)
    G = 300
    fields = [rng.integers(0, 1 << w, G).astype(np.int32) for w in widths]
    packed = tbin._pack_fields([t(f) for f in fields], widths, chunks,
                               n_planes)
    assert_same(jbin._pack_fields([jnp.asarray(f) for f in fields], widths,
                                  chunks, n_planes), packed, what="planes")
    counts = rng.integers(0, 5, G).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    cap = int(counts.sum()) - 7               # the tail is dropped
    cums, iota = tbin._delta_scan(packed, t(offsets), cap)
    owner = np.repeat(np.arange(G), counts)[:cap]
    for i, f in enumerate(fields):
        assert_same(f[owner], tbin._unpack_field(cums, chunks[i]),
                    what=f"field {i}")
    assert_same(np.arange(cap, dtype=np.int32), iota)


def test_lookback_state_epochs():
    """The scan's per-stream scratch (scan.cu's tickets and status words):
    a new epoch every call; tickets and words each grown, zeroed, when a
    shape needs more and kept otherwise; at the epoch limit the words are
    zeroed once and the epochs restart at 1 (the kernel never sees epoch 0
    or the limit). Tickets are never cleared by the host: the kernel leaves
    them at 0."""
    st = tscan.LookbackState("cpu", limit=4)
    tk, words, e = st.take(4, 5000)            # 4 rows · 2 chunks
    assert e == 1 and tk.numel() == 4 and words.numel() == 8
    assert (tk == 0).all() and (words == 0).all()
    words.fill_(7)                             # what a kernel leaves behind
    tk2, words2, e = st.take(7, 4096)          # more rows, fewer words
    assert e == 2 and tk2.numel() == 7 and (tk2 == 0).all()
    assert words2 is words and (words2 == 7).all()
    tk3, words3, e = st.take(3, 20_000)        # 3 · 5 words: new
    assert e == 3 and tk3 is tk2 and words3.numel() == 15
    assert (words3 == 0).all()
    words3.fill_(7)
    _, words4, e = st.take(3, 20_000)          # epoch 4 is the limit: wrap
    assert e == 1 and words4 is words3 and (words4 == 0).all()
    assert st.take(1, 1)[2] == 2
