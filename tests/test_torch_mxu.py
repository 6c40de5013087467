"""msgs_torch pair-math probe (kernels/mxu_probe.py) and the ported tool
(msgs_torch/tools/exp_mxu.py) vs the JAX package's tools/exp_mxu.py, on
the CPU.

The JAX script runs in-process at B = 8 blocks, unedited: `pallas_call`
is wrapped to run in interpret mode and to record each kernel it builds,
and the script's persistent-cache settings are dropped, so the run writes
nothing into the tree and leaves no global setting behind. Each recorded
kernel is then run again on the script's seeded payload for its (8, 256)
output, which the port's plain version must match within 1e-6·max|want|
per run. dfeat_nt's JAX output is identically zero (its g_rows is its own
accumulator, which starts at 0), so its df is also held, on a seeded
nonzero g_rows, against a float64 numpy expression. The CUDA kernel
against the plain version is in test_torch_cuda.py.
"""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msgs_torch.kernels.mxu_probe import (NDF, NPIX, pair_block_probe,
                                          pair_block_probe_plain)
from msgs_torch.tools import exp_mxu as port_mxu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
RUNS = list(port_mxu.RUNS)


def _payload(n=B):
    """The script's draw (tools/exp_mxu.py:47-49)."""
    rng = np.random.default_rng(0)
    payload = rng.uniform(0.1, 1.0, (n, 128, 16)).astype(np.float32)
    payload[:, :, 5] *= 0.5
    return payload


@pytest.fixture(scope="module")
def jax_runs():
    """Runs tools/exp_mxu.py at B = 8 in interpret mode; returns its
    printed lines and each run's (8, 256) output, in the script's order."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_mxu", os.path.join(ROOT, "tools", "exp_mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    real_call, real_update = pl.pallas_call, jax.config.update

    def interpreted(*args, **kw):
        f = real_call(*args, interpret=True, **kw)
        calls.append(f)
        return f

    def update(name, value):
        if name not in ("jax_compilation_cache_dir",
                        "jax_persistent_cache_min_compile_time_secs"):
            real_update(name, value)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        mp.setattr(jax.config, "update", update)
        mp.setattr(sys, "argv", ["exp_mxu.py", str(B)])
        with contextlib.redirect_stdout(buf):
            mod.main()
    pay = _payload()
    outs = [np.asarray(f(pay)) for f in calls]
    return buf.getvalue().splitlines(), outs


def _printed_runs(lines):
    """(variant, precision) of each line the JAX script printed."""
    runs = []
    for ln in lines:
        m = re.match(r"(\w+)\s+\(([\w.]+)\):", ln)
        assert m, ln
        prec = None if m.group(2) == "None" else m.group(2).split(".")[-1]
        runs.append((m.group(1), prec))
    return runs


def test_jax_script_runs_in_order(jax_runs):
    lines, outs = jax_runs
    assert not any("FAILED" in ln for ln in lines), lines
    # The port's runs are the script's, in its order.
    assert _printed_runs(lines) == RUNS
    assert len(outs) == len(RUNS)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"{v}-{p}" for v, p in RUNS])
def test_plain_matches_jax(jax_runs, i):
    variant, precision = RUNS[i]
    want = jax_runs[1][i]
    got = pair_block_probe_plain(torch.as_tensor(_payload()), variant,
                                 precision).numpy()
    assert got.shape == want.shape == (8, NPIX)
    tol = 1e-6 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (variant, precision)
    if variant == "dfeat_nt":
        assert not want.any() and not got.any()
    else:
        # Rows 5-7 are never written.
        assert not got[5:].any() and not want[5:].any()
        assert np.abs(want).max() > 0


def _w_f64(payload):
    """w (B, 128, 256) of base in float64 (tools/exp_mxu.py:75-80,
    :89-94, :112-120)."""
    f = payload.astype(np.float64)
    p = np.arange(NPIX)
    px, py = p % 16, p // 16
    col = lambda k: f[:, :, k:k + 1]
    dx, dy = px - col(0), py - col(1)
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    ar = col(5) * np.exp(power)
    alpha = np.where((ar >= 1 / 255) & (power <= 0), np.minimum(ar, 0.99),
                     0.0)
    seg = (1 - alpha).reshape(len(f), 4, 32, NPIX)
    cum = np.cumprod(seg, axis=2)
    excl = np.concatenate([np.ones_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
    w = alpha.reshape(seg.shape) * excl * (cum >= 1e-4)
    return w.reshape(len(f), 128, NPIX)


@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH"])
def test_dfeat_nt_on_nonzero_g_rows(precision):
    """df = w @ g_rowsᵀ (tools/exp_mxu.py:154-158) on a seeded nonzero
    g_rows, per block, against float64 numpy; and zero g_rows give 0."""
    pay = _payload()
    g = np.random.default_rng(1).normal(size=(NDF, NPIX)).astype(np.float32)
    df = pair_block_probe(torch.as_tensor(pay), "dfeat_nt", precision,
                          g_rows=torch.as_tensor(g), per_block=True).numpy()
    want = _w_f64(pay) @ g.astype(np.float64).T
    assert df.shape == (B, 128, NDF)
    assert np.abs(df - want).max() <= 1e-6 * np.abs(want).max()
    zero = pair_block_probe(torch.as_tensor(pay), "dfeat_nt", precision)
    assert not zero.any()
    # The accumulator term of the nonzero g_rows is that df's rows 0-4
    # times the monomial basis, times 1e-6.
    out = pair_block_probe(torch.as_tensor(pay), "dfeat_nt", precision,
                           g_rows=torch.as_tensor(g)).numpy()
    x, y = np.arange(NPIX) % 16, np.arange(NPIX) // 16
    basis = np.stack([x * x, x * y, y * y, x, y, np.ones(NPIX),
                      np.zeros(NPIX), np.zeros(NPIX)])
    acc = (want[:, :5] @ basis).sum(0) * 1e-6
    assert np.abs(out[:5] - acc).max() <= 1e-6 * np.abs(acc).max()
    assert not out[5:].any()


def test_per_block_sums_to_output():
    pay = torch.as_tensor(_payload())
    for variant, precision in RUNS[1:3] + RUNS[4:6]:
        per = pair_block_probe(pay, variant, precision, per_block=True)
        assert per.shape == (B, 8, NPIX)
        tot = pair_block_probe(pay, variant, precision)
        assert torch.equal(per.sum(0), tot)


def test_port_tool_on_cpu(jax_runs):
    recs = port_mxu.main([str(B), "--device", "cpu"])
    assert [(r["variant"], r["precision"]) for r in recs] == _printed_runs(
        jax_runs[0])
    # The bound is the larger of the bytes and the operations (the CPU run
    # has no HIGH tensor-core part to count beside them).
    base = recs[1]
    assert base["bound_by"] == "operations" and np.isclose(
        base["bound_ms"], B * 128 * 256 * 38 / 67e12 * 1e3)
    for r in recs:
        for k in ("ms", "plain_ms", "max_abs_err", "budget", "bound_ms"):
            assert np.isfinite(r[k]) and r[k] >= 0, (r, k)
        # On the CPU the kernel is the plain version, and never launched.
        assert r["max_abs_err"] == 0.0 and r["launches"] == 0, r


@pytest.mark.parametrize("bad", ["f64", "shape", "empty_batch", "variant",
                                 "precision_missing", "precision_extra",
                                 "g_rows_on_base", "g_rows_shape"])
def test_pair_block_probe_refuses(bad):
    pay = torch.zeros((2, 128, 16))
    kw = dict(variant="dfeat_nt", precision="HIGH")
    if bad == "f64":
        pay = pay.double()
    elif bad == "shape":
        pay = torch.zeros((2, 128, 12))
    elif bad == "empty_batch":
        pay = torch.zeros((0, 128, 16))
    elif bad == "variant":
        kw = dict(variant="pow_mxu_x", precision="HIGH")
    elif bad == "precision_missing":
        kw = dict(variant="acc_tn")
    elif bad == "precision_extra":
        kw = dict(variant="base", precision="HIGHEST")
    elif bad == "g_rows_on_base":
        kw = dict(variant="base", g_rows=torch.zeros((NDF, NPIX)))
    else:
        kw["g_rows"] = torch.zeros((NDF, NPIX - 1))
    with pytest.raises((TypeError, ValueError)):
        pair_block_probe(pay, **kw)


# A fresh process: the package's import, then its first large CPU exp on 32
# threads; prints the largest relative error against float64.
_FIRST_EXP = """
import numpy as np, torch
import msgs_torch
torch.set_num_threads(32)
x = np.random.default_rng(0).uniform(-20, 0, 1 << 18).astype(np.float32)
got = torch.exp(torch.from_numpy(x)).numpy()
want = np.exp(x.astype(np.float64))
print(float((np.abs(got - want) / want).max()))
"""


def test_first_cpu_exp_after_import_is_right():
    """The first large, multi-threaded CPU exp of a process that imported
    msgs_torch is right to f32 rounding. Without the package's single-thread
    first call, MKL's vector exp has returned one thread's share with
    ~1.5e-4 relative error in about 3% of fresh processes; four processes
    here, so that a lost first call shows now and then rather than never."""
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP], cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    errs = [float(p.communicate()[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert max(errs) <= 1e-6, errs
