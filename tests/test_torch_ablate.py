"""msgs_torch compositor ablations (kernels/ablate.py) and the ported tool
(msgs_torch/tools/exp_fwd_ablate.py) vs the JAX package's
tools/exp_fwd_ablate.py, on the CPU.

The JAX script runs in-process, unedited, on its own 1080p scene. Its
`pallas_call` is replaced by a recorder: the script's own kernels (the 9
forward and 6 backward variants) are kept with their grid specs, and they
and the compositor's forward at :234 return zeros of their output shape,
so the script's 1080p timing loops cost nothing; binning's scan kernels
run as they are (interpret mode). Its persistent-cache settings are
dropped, and the shim it writes into msgs.kernels.composite
(`_local_basis_t`, `_dot`) is taken out again when the module's tests end.

Each recorded kernel body then runs again on a small stream under the
Pallas TPU interpreter with zero-initialised memory: the function the
kernels compute on the TPU, whose scratch starts at 0 (plain
`interpret=True` starts it, and the variants that never write their state
rows read it, as NaN). The stream is a clustered, opaque 1080p scene cut
to its first 16 blocks (two grid steps); the tests assert that a tile's
run crosses a block and a grid-step boundary, that a block holds subs of
two tiles, and that a tile saturates so the forward's skip fires. Budgets,
per variant:
  forward state slots (the slots the variant writes): r g b and acc ≤
  1e-5, depth ≤ 1e-4, T ≤ 1e-5, done equal. T is not held equal: XLA's f32
  exp on the CPU and torch's differ in the last bit for about a tenth of
  arguments, as in tests/test_torch_composite.py.
  running sums (no_states, pairs_*): ≤ 1e-5·max|row| per row.
  backward columns: ≤ 3e-5·max|column| + 1e-6 (tests/test_rasterize.py:
  120); the bf16 geometry columns, in addition, no farther from a float64
  sum of the port's bf16-rounded moment products than JAX's are.
The CUDA kernels against the plain versions are in test_torch_cuda.py.
"""
import contextlib
import importlib.util
import io
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from msgs.kernels import composite as jcomp
from msgs_torch.kernels import ablate
from msgs_torch.kernels import composite as tcomp
from msgs_torch.tools import exp_fwd_ablate as port_tool
from tests.torch_parity import one_torch_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1920, 1080
TILES_X = (W + 15) // 16
TILES = TILES_X * ((H + 15) // 16)
K = 16                     # blocks of the small stream: two grid steps
SCRIPT_B = 14336           # the script's blocks (entry_cap 1,572,864)
FWD = list(ablate.FWD_VARIANTS)
BWD = list(ablate.BWD_VARIANTS)
ZERO = pltpu.InterpretParams(uninitialized_memory="zero")
SHIM = ("_local_basis_t", "_dot")


def small_stream():
    """(payload, sub_tile, sub_valid, tile_last_sub) of the clustered
    scene, cut to its first K blocks, and its compositor output."""
    payload, st, sv, tls = port_tool.clustered_stream("cpu", K)
    assert int(sv.sum()) < 4 * K
    res = tcomp.composite_reference(payload, st, sv, tls, TILES, TILES_X, W,
                                    H)
    return payload, st, sv, tls, res


@pytest.fixture(scope="module")
def jax_script():
    """Runs tools/exp_fwd_ablate.py with the recorder; returns its printed
    lines and the recorded kernels as {"fwd/<v>" or "bwd/<v>": (kernel,
    grid_spec, out_shape)}, in the script's order."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_fwd_ablate", os.path.join(ROOT, "tools",
                                           "exp_fwd_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    real_call, real_update = pl.pallas_call, jax.config.update

    def recorder(kernel, *args, **kw):
        src = getattr(kernel, "func", kernel).__code__.co_filename
        if src.endswith(os.path.join("kernels", "scan.py")):
            return real_call(kernel, *args, **kw)
        if src.endswith("exp_fwd_ablate.py"):
            calls.append((kernel, kw["grid_spec"], kw["out_shape"]))
        out_shape = kw["out_shape"]
        return lambda *a: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    def update(name, value):
        if name not in ("jax_compilation_cache_dir",
                        "jax_persistent_cache_min_compile_time_secs"):
            real_update(name, value)

    mp = pytest.MonkeyPatch()
    # Record the shim's names as absent, so that undo removes what the
    # script adds.
    for name in SHIM:
        assert not hasattr(jcomp, name)
        mp.setattr(jcomp, name, None, raising=False)
        mp.delattr(jcomp, name)
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp2:
            mp2.setattr(pl, "pallas_call", recorder)
            mp2.setattr(jax.config, "update", update)
            mp2.setattr(sys, "argv", ["exp_fwd_ablate.py", "all"])
            with contextlib.redirect_stdout(buf):
                mod.main()
        lines = buf.getvalue().splitlines()
        names = [m.group(1) for m in map(
            re.compile(r"((?:fwd|bwd)/\w+)\s*:").match, lines) if m]
        yield types.SimpleNamespace(lines=lines,
                                    kernels=dict(zip(names, calls)),
                                    n_calls=len(calls))
    finally:
        mp.undo()
    for name in SHIM:
        assert not hasattr(jcomp, name)


@pytest.fixture(scope="module")
def stream():
    payload, st, sv, tls, res = small_stream()
    return types.SimpleNamespace(payload=payload, st=st, sv=sv, tls=tls,
                                 res=res, cst=port_tool.make_cst(res))


def run_jax(rec, s, *extra, interpret=ZERO):
    """A recorded kernel body on the small stream (K blocks)."""
    kernel, gs, out_shape = rec
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(K // ablate.GROUP,),
        in_specs=gs.in_specs, out_specs=gs.out_specs,
        scratch_shapes=gs.scratch_shapes)
    o = out_shape[0]
    shape = (o.shape[0] * K // SCRIPT_B,) + o.shape[1:]
    f = pl.pallas_call(kernel, grid_spec=grid_spec,
                       out_shape=[jax.ShapeDtypeStruct(shape, o.dtype)],
                       interpret=interpret)
    out = f(jnp.asarray(s.st.numpy()), jnp.asarray(s.sv.numpy()),
            jnp.asarray(s.payload.numpy()), *extra)[0]
    return np.asarray(out)


def test_jax_script_runs_every_variant_in_order(jax_script):
    assert not any("FAILED" in ln for ln in jax_script.lines), \
        jax_script.lines
    assert list(jax_script.kernels) == ([f"fwd/{v}" for v in FWD]
                                        + [f"bwd/{v}" for v in BWD])
    assert jax_script.n_calls == len(FWD) + len(BWD)
    # The script's stream: 14,336 blocks.
    _, _, out_shape = jax_script.kernels["fwd/full"]
    assert out_shape[0].shape == (SCRIPT_B * 4, 8, 256)


def test_small_stream_crosses_boundaries_and_saturates(stream):
    st = stream.st.numpy()
    sv = stream.sv.numpy()
    nb = int((sv[::4] == 1).sum())
    assert nb > ablate.GROUP and (sv[::4][:nb] == 1).all()
    s = st[:4 * nb]
    # A tile's run crosses a block boundary (sub 4b−1 and sub 4b) and a
    # grid-step boundary (sub 31 and sub 32).
    assert (s[3::4][:-1] == s[4::4]).any()
    assert s[31] == s[32]
    # A block holds subs of two tiles.
    assert any(len(set(s[4 * b:4 * b + 4])) > 1 for b in range(nb))
    # A tile saturates and the forward's skip fires.
    args = (stream.payload, stream.st, stream.sv)
    _, written = ablate.fwd_ablate_plain(*args, "dump_last", TILES_X, W, H)
    states = ablate.fwd_ablate_plain(*args, "full", TILES_X, W, H)[0]
    skip = ablate.skipped_blocks(stream.st, stream.sv, states)
    assert skip.any()
    b = int(skip.nonzero()[0, 0])
    assert written[4 * b:4 * b + 4].all()


FWD_TOL = {0: 1e-5, 1: 1e-5, 2: 1e-5, 3: 1e-4, 4: 1e-5, 5: 1e-5, 6: 0.0,
           7: 0.0}


def hold_states(got, want, what):
    for r, tol in FWD_TOL.items():
        d = np.abs(got[:, r] - want[:, r]).max()
        assert d <= tol, (what, r, d)


@pytest.mark.parametrize("variant", FWD)
def test_fwd_plain_matches_jax(jax_script, stream, variant):
    want = run_jax(jax_script.kernels[f"fwd/{variant}"], stream)
    got, written = ablate.fwd_ablate_plain(stream.payload, stream.st,
                                           stream.sv, variant, TILES_X, W,
                                           H)
    got, written = got.numpy(), written.numpy()
    assert got.shape == want.shape
    nb = int((stream.sv.numpy()[::4] == 1).sum())
    if variant in ablate.TILE_VARIANTS:
        n_written = {"full": 4 * nb, "no_dump": 0,
                     "small_out": K // ablate.GROUP}
        if variant in n_written:
            assert written.sum() == n_written[variant]
        if written.any():
            hold_states(got[written], want[written], variant)
        # Unwritten slots stay as allocated.
        assert not got[~written].any()
        return
    # Running sums: slot 4b of every computed block.
    assert (np.flatnonzero(written) == np.arange(nb) * 4).all()
    g, w = got[written], want[written]
    assert not g[:, 5:].any() and not w[:, 5:].any()
    for r in range(5):
        tol = 1e-5 * np.abs(w[:, r]).max()
        assert np.abs(g[:, r] - w[:, r]).max() <= tol, (variant, r)
    rows = 1 if variant in ("pairs_alpha", "pairs_noaccs") else 5
    assert all(np.abs(w[:, r]).max() > 0 for r in range(rows))
    assert not g[:, rows:].any()


def test_fwd_dump_last_writes_the_slots_jax_writes(jax_script, stream):
    """Plain interpret mode starts every output slot as NaN, so the slots
    the JAX kernel writes show; dump_last's differ block by block."""
    want = run_jax(jax_script.kernels["fwd/dump_last"], stream,
                   interpret=True)
    _, written = ablate.fwd_ablate_plain(stream.payload, stream.st,
                                         stream.sv, "dump_last", TILES_X,
                                         W, H)
    assert (~np.isnan(want).any(axis=(1, 2)) == written.numpy()).all()


def test_fwd_full_matches_real_composite(stream):
    """fwd/full's slot at each tile's last sub is the real compositor's
    output (_composite_fwd_call, interpret mode; its grid needs whole
    groups of 32 blocks, so the stream is padded with blocks that do not
    compute)."""
    got, written = ablate.fwd_ablate_plain(stream.payload, stream.st,
                                           stream.sv, "full", TILES_X, W,
                                           H)
    pad = 32 - K
    payload = np.concatenate([stream.payload.numpy(),
                              np.zeros((pad, 128, 12), np.float32)])
    st = np.concatenate([stream.st.numpy(),
                         np.full(4 * pad, stream.st[-1], np.int32)])
    sv = np.concatenate([stream.sv.numpy(), np.zeros(4 * pad, np.int32)])
    tls = stream.tls.numpy()
    want = np.asarray(jcomp._composite_fwd_call(
        jnp.asarray(payload), jnp.asarray(st), jnp.asarray(sv),
        jnp.asarray(tls), TILES, TILES_X, W, H))
    tiles = np.unique(stream.st.numpy()[stream.sv.numpy() == 1])
    assert written[tls[tiles]].all()
    hold_states(got.numpy()[tls[tiles]], want[tiles], "full vs kernel 3")
    # T and done are those of the port's compositor, bit for bit (the same
    # per-sub arithmetic; its colour sums take another order).
    res = stream.res.numpy()[tiles]
    last = got.numpy()[tls[tiles]]
    assert np.array_equal(last[:, 5:], res[:, 5:])
    hold_states(last, res, "full vs the port's compositor")


def f64_moments(d_power):
    """ablate.bf16_moments summed in float64."""
    pxl, pyl = (x.double() for x in tcomp._local_pix(d_power.device))
    dpb = ablate._bf16(d_power).double()
    return tuple((dpb * m).sum(-1) for m in (
        pxl * pxl, pxl * pyl, pyl * pyl, pxl, pyl, torch.ones_like(pxl)))


# Columns each backward variant writes, and those from the bf16 moments.
BWD_COLS = {"full": range(9), "geom_concat": range(9), "no_prefix": range(9),
            "geom_nostore": [0], "no_geom": [0, 6, 7, 8],
            "recompute_only": [0]}
BF16_COLS = {"full": range(6), "geom_concat": range(6),
             "no_prefix": range(6), "geom_nostore": [0]}


# JAX's bf16-moment columns against the exact sum of the port's bf16
# products, relative to the column's largest value: the rounding flips of
# dpower's bf16 that the two sides' last-bit differences cause. Measured on
# the small stream: at most 4.4e-5 (no_prefix, d_my), 2e-6 for full.
BF16_FLIP_ROOM = 1e-4


def grad_budget(want):
    return 3e-5 * max(np.abs(want).max(), 1e-8) + 1e-6


@pytest.mark.parametrize("variant", BWD)
def test_bwd_plain_matches_jax(jax_script, stream, variant):
    """Columns of f32 sums: the gradient budget. Columns from the bf16
    moments: JAX's dpower and the port's differ in the last bits, and where
    that flips a bf16 rounding a moment term moves by 2⁻⁸ of itself, so
    both are held to the float64 sum of the port's own bf16 products and
    chain rules: the port within the gradient budget of it and no farther
    from it than JAX, and JAX within BF16_FLIP_ROOM·max|column| + 1e-6 of
    it."""
    # The JAX kernel gathers rows at sub_tile only: it gets the rows up to
    # the last tile, 32 times.
    cst = jnp.asarray(stream.cst[:int(stream.st.max()) + 1].numpy())
    want = run_jax(jax_script.kernels[f"bwd/{variant}"], stream,
                   *([cst] * 32))
    args = (stream.payload, stream.st, stream.sv, stream.cst, variant,
            TILES_X, W, H)
    got = ablate.bwd_ablate_plain(*args).numpy()
    assert got.shape == want.shape == (K, 128, 12)
    g, w = got.reshape(-1, 12), want.reshape(-1, 12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ablate, "bf16_moments", f64_moments)
        exact = ablate.bwd_ablate_plain(*args).numpy().reshape(-1, 12)
    for c in range(12):
        if c not in BWD_COLS[variant]:
            assert not g[:, c].any() and not w[:, c].any(), (variant, c)
            continue
        assert np.abs(w[:, c]).max() > 0, (variant, c)
        d = np.abs(g[:, c] - w[:, c]).max()
        if c not in BF16_COLS.get(variant, ()):
            assert d <= grad_budget(w[:, c]), (variant, c, d)
            continue
        e_port = np.abs(g[:, c] - exact[:, c]).max()
        e_jax = np.abs(w[:, c] - exact[:, c]).max()
        assert e_port <= grad_budget(exact[:, c]), (variant, c, e_port)
        assert e_port <= e_jax, (variant, c, e_port, e_jax)
        room = BF16_FLIP_ROOM * np.abs(exact[:, c]).max() + 1e-6
        assert e_jax <= room, (variant, c, e_jax, room)


def test_make_cst_matches_the_script(stream):
    """The port's constant rows are the script's expression
    (tools/exp_fwd_ablate.py:257-264) on the same res."""
    res = jnp.asarray(stream.res.numpy())
    cot = jnp.ones_like(res) * 0.1
    g_c = cot[:, 0:3, :]
    total_phi = jnp.sum(res[:, 0:3, :] * g_c, axis=1, keepdims=True)
    tf_gt = res[:, 5:6, :] * cot[:, 5:6, :]
    want = jnp.concatenate([g_c, cot[:, 3:4, :], cot[:, 4:5, :], total_phi,
                            tf_gt, jnp.zeros_like(tf_gt)], axis=1)
    np.testing.assert_allclose(stream.cst.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_port_tool_on_cpu(jax_script):
    """The ported tool on the CPU, its stream cut to its first 64 blocks:
    the JAX script's variants in its order, each held to its plain version
    (on the CPU the wrapper is the plain version: exact, never launched),
    and a bound from this run's work. torch runs on one thread here (the
    tool's thousands of small CPU ops)."""
    with one_torch_thread():
        recs = port_tool.main(["all", "--device", "cpu"], n_blocks=64)
    assert [r["name"] for r in recs] == list(jax_script.kernels)
    for r in recs:
        assert r["launches"] == 0 and r["max_abs_err"] == 0.0 and r["exact"]
        for k in ("ms", "plain_ms", "bound_ms"):
            assert np.isfinite(r[k]) and r[k] > 0, (r, k)
        assert r["bound_by"] in ("bytes", "operations")
    # 64 blocks of the bench stream, all computed: full writes every sub's
    # slot and evaluates at most its 256 subs' pairs.
    full = recs[0]
    assert full["written"] == 256 and 0 < full["pairs"] <= 256 * 32 * 256


@pytest.mark.parametrize("bad", ["variant", "f64", "blocks", "ids",
                                 "device", "cst", "order"])
def test_wrappers_refuse(stream, bad):
    pay, st, sv = stream.payload, stream.st, stream.sv
    kw = dict(variant="full", tiles_x=TILES_X, width=W, height=H)
    fn = ablate.fwd_ablate
    if bad == "variant":
        kw["variant"] = "geom_nostore"
    elif bad == "f64":
        pay = pay.double()
    elif bad == "blocks":
        pay, st, sv = pay[:12], st[:48], sv[:48]
    elif bad == "ids":
        st = st.long()
    elif bad == "device":
        pay = pay.to("meta")
    elif bad == "cst":
        fn = lambda *a, **k: ablate.bwd_ablate(*a[:3], stream.cst[:10],
                                               **k)
    else:
        st = st.flip(0).contiguous()
    with pytest.raises((TypeError, ValueError)):
        fn(pay, st, sv, **kw)
