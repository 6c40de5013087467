"""msgs_torch's horner forward and backward forms (kernels/ablate.py) and the
ported tools (msgs_torch/tools/exp_bwd2.py, exp_bwd3.py) vs the JAX
package's tools/exp_bwd2.py and tools/exp_bwd3.py, on the CPU.

Each JAX script runs in-process, unedited, with its preprocess and binning
stubbed to small arrays of the right dtypes (32 blocks; none of the
scripts' kernels lies there) and `pallas_call` replaced by a recorder: the
script's own kernels (exp_bwd2's fwd/horner and 4 backward runs, exp_bwd3's
5 runs) are kept with their grid specs, and every call returns zeros of
its output shape. Their persistent-cache settings are dropped.

Each recorded kernel body then runs again, its grid rebuilt, on the
clustered 1080p check stream (tools/exp_fwd_ablate.clustered_stream) cut
to its first 16 blocks, 32 for g16 so that its grid has two steps, under
the Pallas TPU interpreter with zero-initialised memory: the function the
kernels compute on the TPU (plain `interpret=True` starts the scratch as
NaN). exp_bwd2's backward calls `comp._local_basis_t` and, off the
geom_vpu path, `comp._dot` (:186, :253), which msgs/kernels/composite.py
no longer has; the replays install the r3 design's HIGHEST contraction
(composite.py:641-646) over tools/exp_fwd_ablate.py:242-254's raw-monomial
basis with monkeypatch, and a test shows the body does not trace without
it. Budgets: the horner running sum ≤ 1e-5·max|row| per row; backward
columns ≤ 3e-5·max|column| + 1e-6 (tests/test_rasterize.py:120), against
the JAX body and, for every backward run, against the port's kernel-4
reference (composite_bwd_reference, image-only, under a cotangent with
zero depth and acc rows, whose suffix is the constant rows' r g b one).
The CUDA kernels against the plain versions are in test_torch_cuda.py.
"""
import contextlib
import functools
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

from msgs.kernels import binning as jbin
from msgs.kernels import composite as jcomp
from msgs.kernels import preprocess as jpre
from msgs_torch.kernels import ablate
from msgs_torch.kernels import composite as tcomp
from msgs_torch.tools import exp_bwd2 as port_bwd2
from msgs_torch.tools import exp_bwd3 as port_bwd3
from msgs_torch.tools import exp_fwd_ablate as fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1920, 1080
TILES_X = (W + 15) // 16
TILES = TILES_X * ((H + 15) // 16)
B_STUB = 32                # blocks of the stubbed binning
N_STUB = 4                 # Gaussians of the stubbed preprocess
ZERO = pltpu.InterpretParams(uninitialized_memory="zero")
FORMS = port_bwd2.BWD_RUNS
RUNS = ["fwd/horner"] + list(FORMS)
SCRIPTS = {"exp_bwd2": RUNS[:5], "exp_bwd3": RUNS[5:]}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one CPU thread: the suite runs several workers at once, and
    the ported tools' 1080p preprocess and binning on every core of each
    worker oversubscribe the machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def blocks_of(run):
    return 32 if FORMS.get(run) and FORMS[run].group == 16 else 16


def stub_preprocess(camera, means3d, opacities, **kw):
    z = jnp.zeros((N_STUB,), jnp.float32)
    z2 = jnp.zeros((N_STUB, 2), jnp.float32)
    z3 = jnp.zeros((N_STUB, 3), jnp.float32)
    i2 = jnp.zeros((N_STUB, 2), jnp.int32)
    return jpre.PreprocessOut(
        means2d=z2, depths=z, conics=z3, colors=z3, opacities=z,
        radii=jnp.zeros((N_STUB,), jnp.int32), pixel_sizes=z, rect_min=i2,
        rect_max=i2, visible=jnp.zeros((N_STUB,), bool))


def stub_bin_gaussians(pre, width, height, entry_cap, row_tight=None):
    s_cap = 4 * B_STUB
    return jbin.Binned(
        gauss_id=jnp.full((B_STUB * 128,), N_STUB, jnp.int32),
        sub_tile=jnp.zeros((s_cap,), jnp.int32),
        sub_valid=jnp.zeros((s_cap,), jnp.int32),
        tile_nonempty=jnp.zeros((TILES,), bool),
        tile_last_sub=jnp.zeros((TILES,), jnp.int32),
        num_entries=jnp.int32(0), overflow=jnp.int32(0),
        gid_starts=jnp.zeros((N_STUB + 1,), jnp.int32))


def run_script(name):
    """Runs tools/<name>.py with the recorder and the stubs: its printed
    lines and {run: (kernel, grid_spec, out_shape)} in its order."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    real_update = jax.config.update

    def recorder(kernel, *args, **kw):
        src = getattr(kernel, "func", kernel).__code__.co_filename
        if src.endswith(f"{name}.py"):
            calls.append((kernel, kw["grid_spec"], kw["out_shape"]))
        out_shape = kw["out_shape"]
        return lambda *a: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    def update(key, value):
        if key not in ("jax_compilation_cache_dir",
                       "jax_persistent_cache_min_compile_time_secs"):
            real_update(key, value)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recorder)
        mp.setattr(jax.config, "update", update)
        mp.setattr(jpre, "preprocess", stub_preprocess)
        mp.setattr(jbin, "bin_gaussians", stub_bin_gaussians)
        mp.setattr(sys, "argv", [f"{name}.py"])
        with contextlib.redirect_stdout(buf):
            mod.main()
    lines = buf.getvalue().splitlines()
    names = [m.group(1) for m in map(
        re.compile(r"([\w/+]+)\s*:\s").match, lines) if m]
    return types.SimpleNamespace(lines=lines, kernels=dict(zip(names, calls)),
                                 n_calls=len(calls))


@pytest.fixture(scope="module")
def scripts():
    return {name: run_script(name) for name in SCRIPTS}


@pytest.fixture(scope="module")
def streams():
    """The clustered stream cut to 16 and to 32 blocks, with its compositor
    output, constant rows and image-only kernel-4 reference."""
    out = {}
    for k in (16, 32):
        payload, st, sv, tls = fa.clustered_stream("cpu", k)
        res = tcomp.composite_reference(payload, st, sv, tls, TILES,
                                        TILES_X, W, H)
        cot = torch.full_like(res, fa.COT)
        cot[:, tcomp.O_DEPTH:tcomp.O_ACC + 1] = 0.0
        first, n_sub = tcomp.tile_sub_ranges(st, sv, tls, TILES)
        ref = tcomp.composite_bwd_reference(payload, first, n_sub, res, cot,
                                            TILES, TILES_X, W, H, True)
        out[k] = types.SimpleNamespace(payload=payload, st=st, sv=sv,
                                       tls=tls, res=res, cst=fa.make_cst(res),
                                       ref=ref.numpy().reshape(-1, 12))
    return out


def local_basis_t():
    """The raw monomials [x², xy, y², x, y, 1, 0, 0] per tile-local pixel,
    (NPIX, 8), as tools/exp_fwd_ablate.py:242-254 builds them."""
    p = jax.lax.broadcasted_iota(jnp.int32, (jcomp.NPIX, 8), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (jcomp.NPIX, 8), 1)
    x = (p % 16).astype(jnp.float32)
    y = (p // 16).astype(jnp.float32)
    out = jnp.zeros((jcomp.NPIX, 8), jnp.float32)
    for i, v in enumerate([x * x, x * y, y * y, x, y, jnp.ones_like(x)]):
        out = jnp.where(c == i, v, out)
    return out


def highest_dot(a, b):
    """The package's HIGHEST f32 contraction (composite.py:641-646)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)


def replay(rec, s, shim=True):
    """A recorded kernel body on stream s, its grid rebuilt for the
    stream's blocks; the backward's constants as its specs take them. A
    fresh partial of the body, so that no earlier trace is reused."""
    kernel, gs, out_shape = rec
    body = (functools.partial(kernel.func, **kernel.keywords)
            if isinstance(kernel, functools.partial)
            else functools.partial(kernel))
    group = gs.in_specs[0].block_shape[0]
    K = s.payload.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(K // group,), in_specs=gs.in_specs,
        out_specs=gs.out_specs, scratch_shapes=gs.scratch_shapes)
    o = out_shape[0]
    shape = (o.shape[0] * K // B_STUB,) + o.shape[1:]
    f = pl.pallas_call(body, grid_spec=grid_spec,
                       out_shape=[jax.ShapeDtypeStruct(shape, o.dtype)],
                       interpret=ZERO)
    extra = []
    if len(gs.in_specs) == 2:            # cst_dense: cst_t[sub_tile]
        extra = [jnp.asarray(s.cst.numpy()[s.st.numpy()])]
    elif len(gs.in_specs) > 2:           # a (1, 8, 256) block per sub
        rows = jnp.asarray(s.cst[:int(s.st.max()) + 1].numpy())
        extra = [rows] * (len(gs.in_specs) - 1)
    with pytest.MonkeyPatch.context() as mp:
        if shim:
            mp.setattr(jcomp, "_local_basis_t", local_basis_t, raising=False)
            mp.setattr(jcomp, "_dot", highest_dot, raising=False)
        out = f(jnp.asarray(s.st.numpy()), jnp.asarray(s.sv.numpy()),
                jnp.asarray(s.payload.numpy()), *extra)[0]
        return np.asarray(out)


_JAX = {}


def jax_run(scripts, streams, run):
    """The JAX body of `run` on its stream (replayed once per module)."""
    if run not in _JAX:
        script = next(k for k, v in SCRIPTS.items() if run in v)
        _JAX[run] = replay(scripts[script].kernels[run],
                           streams[blocks_of(run)])
    return _JAX[run]


def port_run(s, run):
    if run == "fwd/horner":
        return ablate.fwd_ablate_plain(s.payload, s.st, s.sv, "horner",
                                       TILES_X, W, H)
    form = FORMS[run]
    cst = (ablate.dense_cst(s.cst, s.st) if form.constants == "dense"
           else s.cst)
    return ablate.bwd_ablate_plain(s.payload, s.st, s.sv, cst, "full",
                                   TILES_X, W, H, form=form)


def grad_budget(want):
    return 3e-5 * max(np.abs(want).max(), 1e-8) + 1e-6


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_jax_script_runs_every_run_in_order(scripts, script):
    rec = scripts[script]
    assert not any("FAILED" in ln for ln in rec.lines), rec.lines
    assert list(rec.kernels) == SCRIPTS[script]
    assert rec.n_calls == len(SCRIPTS[script])


def test_small_streams_cross_boundaries_and_saturate(streams):
    s = streams[16]
    st, sv = s.st.numpy(), s.sv.numpy()
    nb = int((sv[::4] == 1).sum())
    assert nb > ablate.GROUP and (sv[::4][:nb] == 1).all()
    t = st[:4 * nb]
    # A tile's run crosses a block boundary and a grid step's (sub 31 to
    # sub 32 at 8 blocks a step).
    assert (t[3::4][:-1] == t[4::4]).any()
    assert t[31] == t[32]
    # A tile saturates and the TPU's skip rule fires.
    states = ablate.fwd_ablate_plain(s.payload, s.st, s.sv, "full", TILES_X,
                                     W, H)[0]
    assert ablate.skipped_blocks(s.st, s.sv, states).any()
    # g16's stream: two grid steps of 16 blocks, the same computed blocks.
    assert streams[32].payload.shape[0] == 2 * 16
    assert torch.equal(streams[32].st[:4 * nb], s.st[:4 * nb])


@pytest.mark.parametrize("run", RUNS)
def test_run_matches_jax(scripts, streams, run):
    s = streams[blocks_of(run)]
    want = jax_run(scripts, streams, run)
    if run == "fwd/horner":
        got, written = port_run(s, run)
        got, written = got.numpy(), written.numpy()
        assert got.shape == want.shape
        nb = int((s.sv.numpy()[::4] == 1).sum())
        # Slot 4b of every computed block holds the running sum, and the
        # port writes nothing else. The JAX body never writes slots
        # 4b+1..4b+3; slot 4b of a block that does not compute holds
        # whatever the step's reused output buffer held (under the
        # interpreter, an earlier step's slot), which is not part of the
        # function.
        assert (np.flatnonzero(written) == np.arange(nb) * 4).all()
        assert not got[~written].any()
        assert not want.reshape(-1, 4, *want.shape[1:])[:, 1:].any()
        g, w = got[written], want[written]
        assert not g[:, 5:].any() and not w[:, 5:].any()
        for r in range(ablate.NACC):
            peak = np.abs(w[:, r]).max()
            assert peak > 0, r          # the stream has a nonzero sum
            assert np.abs(g[:, r] - w[:, r]).max() <= 1e-5 * peak, r
        return
    got = port_run(s, run).numpy()
    assert got.shape == want.shape == (s.payload.shape[0], 128, 12)
    g, w = got.reshape(-1, 12), want.reshape(-1, 12)
    for c in range(12):
        if c >= tcomp.F_R + ablate.NPHI:
            assert not g[:, c].any() and not w[:, c].any(), (run, c)
            continue
        assert np.abs(w[:, c]).max() > 0, (run, c)
        d = np.abs(g[:, c] - w[:, c]).max()
        assert d <= grad_budget(w[:, c]), (run, c, d)


@pytest.mark.parametrize("run", list(FORMS))
def test_bwd_run_is_kernel_4s_function(scripts, streams, run):
    """Every backward run, the port's plain version and the JAX body, is
    the image-only compositor backward: within the gradient budget of
    composite_bwd_reference on the same stream."""
    s = streams[blocks_of(run)]
    got = port_run(s, run).numpy().reshape(-1, 12)
    want = jax_run(scripts, streams, run).reshape(-1, 12)
    for c in range(tcomp.F_R + ablate.NPHI):
        tol = grad_budget(s.ref[:, c])
        assert np.abs(got[:, c] - s.ref[:, c]).max() <= tol, (run, c)
        assert np.abs(want[:, c] - s.ref[:, c]).max() <= tol, (run, c)


def test_bwd2_body_needs_the_shim(scripts, streams, monkeypatch):
    """Without `_local_basis_t` in msgs.kernels.composite the script's
    backward does not trace (exp_bwd2.py:186)."""
    for name in ("_local_basis_t", "_dot"):
        monkeypatch.delattr(jcomp, name, raising=False)
    rec = scripts["exp_bwd2"].kernels["bwd/geom_vpu"]
    with pytest.raises(AttributeError, match="_local_basis_t"):
        replay(rec, streams[16], shim=False)


def test_dense_cst_is_the_script_gather(streams):
    """dense_cst is exp_bwd2.py:334's cst_t[clip(sub_tile, 0, tiles − 1)]
    (binning keeps sub_tile in range, so the clip changes nothing)."""
    s = streams[16]
    st = s.st.numpy()
    assert st.min() >= 0 and st.max() < TILES
    cst = jnp.asarray(s.cst.numpy())
    want = np.asarray(cst[jnp.clip(jnp.asarray(st), 0, TILES - 1)])
    assert np.array_equal(ablate.dense_cst(s.cst, s.st).numpy(), want)


@pytest.mark.parametrize("tool", [port_bwd2, port_bwd3],
                         ids=["exp_bwd2", "exp_bwd3"])
def test_port_tool_on_cpu(scripts, tool):
    """A ported tool on the CPU, its stream cut to 64 blocks: the JAX
    script's runs in its order, each held to its plain version (on the CPU
    the wrapper is the plain version: exact, never launched), with a bound
    from this run's work."""
    recs = tool.main(["--device", "cpu", "--blocks", "64"])
    name = tool.__name__.rsplit(".", 1)[1]
    assert [r["name"] for r in recs] == list(scripts[name].kernels)
    for r in recs:
        assert r["launches"] == 0 and r["max_abs_err"] == 0.0 and r["exact"]
        for k in ("ms", "plain_ms", "bound_ms"):
            assert np.isfinite(r[k]) and r[k] > 0, (r, k)
        assert r["bound_by"] in ("bytes", "operations")
    if name == "exp_bwd2":
        assert recs[0]["max_abs_sum"] > 0 and recs[0]["written"] == 64


@pytest.mark.parametrize("bad", ["form", "moments", "group", "dense_rows",
                                 "gathered_rows", "device", "variant"])
def test_bwd_form_refuses(streams, bad):
    s = streams[16]
    form, variant, pay = ablate.BWD2_RUNS["cst_dense"], "full", s.payload
    cst = ablate.dense_cst(s.cst, s.st)
    if bad == "form":
        form = "cst_dense"
    elif bad == "moments":
        form = form._replace(moments="dot_f16")
    elif bad == "variant":
        variant = "no_prefix"       # only `full` takes a form
    elif bad == "group":
        form = form._replace(group=4)
    elif bad == "dense_rows":
        cst = s.cst
    elif bad == "gathered_rows":
        form = form._replace(constants="gathered")
    else:
        pay = pay.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ablate.bwd_ablate(pay, s.st, s.sv, cst, variant, TILES_X, W, H,
                          form=form)
