"""msgs_torch CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor the msgs package, so it also runs on a GPU
machine that has no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from msgs_torch.core.camera import make_camera
from msgs_torch.kernels import _build
from msgs_torch.kernels import ablate
from msgs_torch.kernels import composite as comp
from msgs_torch.kernels import scan
from msgs_torch.kernels.gather import (GATHER_INSTANCES, gather_rows,
                                       gather_rows_plain)
from msgs_torch.kernels.mxu_probe import (NDF, NPIX, PROBE_INSTANCES,
                                          instance_index, pair_block_probe,
                                          pair_block_probe_plain)
from msgs_torch.tools import band_rows, exp_bwd2, exp_fwd_ablate
from msgs_torch.tools.exp_mxu import REL_BUDGET, RUNS, held_rows, \
    make_payload
from msgs_torch.kernels import binning
from msgs_torch.kernels.binning import DIFF_HIST_PATHS, bin_gaussians
from msgs_torch.kernels.preprocess import preprocess
from msgs_torch.kernels.rasterize import RasterSettings, gather_payload, \
    rasterize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(dtype, R, E, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        return torch.tensor(rng.integers(-6, 9, (R, E)), dtype=dtype)
    # Negative deltas whose running sums reach ±(2^31 − 1).
    steps = rng.integers(-2**29, 2**29, (R, E)).astype(np.int64)
    steps += np.where((np.arange(E) * 3 // E) == 1, 2**29, -2**29)
    walk = np.clip(np.cumsum(steps, axis=1), -2**31 + 1, 2**31 - 1)
    return torch.tensor(np.diff(walk, axis=1, prepend=0).astype(np.int32))


@pytest.mark.parametrize("dtype,R,E", [
    (torch.float32, 1, 270_336), (torch.float32, 5, 1_417_216),
    (torch.int32, 4, 1_417_216), (torch.int32, 3, 5000),
    (torch.float32, 2, 1)])
def test_scan_kernel_matches_plain(dev, dtype, R, E):
    x = _rows(dtype, R, E, seed=R).to(dev)
    got = scan.cumsum_rows(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, scan.cumsum_rows_plain(x))


def _stream(dev, W, H, n, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    means = f32(np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                                rng.uniform(2, 8, (n, 1))], 1))
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, W, H, device=dev)
    pre = preprocess(cam, means, f32(rng.uniform(0.2, 0.95, n)),
                     colors_precomp=f32(rng.uniform(0, 1, (n, 3))),
                     scales=f32(np.exp(rng.uniform(-4, -2, (n, 3)))),
                     quats=f32(rng.normal(size=(n, 4))))
    b = bin_gaussians(pre, W, H, 1 << 17)
    tx = (W + 15) // 16
    return (gather_payload(pre, b.gauss_id, b.gid_starts), b.sub_tile, b.sub_valid,
            b.tile_last_sub, tx * ((H + 15) // 16), tx, W, H)


@pytest.mark.parametrize("W,H,n", [(64, 64, 300), (256, 200, 3000)])
def test_composite_kernel_matches_plain(dev, W, H, n):
    args = _stream(dev, W, H, n, seed=W)
    got = comp.composite(*args)
    torch.cuda.synchronize()
    want = comp.composite_reference(*args)
    for ch, tol in ((comp.O_R, 1e-5), (comp.O_G, 1e-5), (comp.O_B, 1e-5),
                    (comp.O_T, 0.0), (comp.O_DONE, 0.0),
                    (comp.O_DEPTH, 1e-4), (comp.O_ACC, 1e-4)):
        assert (got[:, ch] - want[:, ch]).abs().max().item() <= tol, ch


def _grad_budget(want):
    return 3e-5 * max(want.abs().max().item(), 1e-8) + 1e-6


def _bwd_args(dev, W, H, n, image_only):
    payload, st, sv, tls, tiles, tx, W, H = _stream(dev, W, H, n, seed=W)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    res = comp.composite(payload, st, sv, tls, tiles, tx, W, H)
    g = torch.Generator().manual_seed(W)
    cot = torch.randn(res.shape, generator=g).to(dev)
    return (payload, first, n_sub, res, cot, tiles, tx, W, H, image_only)


@pytest.mark.parametrize("image_only", [False, True])
@pytest.mark.parametrize("W,H,n", [(64, 64, 300), (256, 200, 3000)])
def test_composite_bwd_kernel_matches_plain(dev, W, H, n, image_only):
    args = _bwd_args(dev, W, H, n, image_only)
    got = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
    torch.cuda.synchronize()
    want = comp.composite_bwd_reference(*args).reshape(-1, comp.NFEAT)
    last = comp.F_B if image_only else comp.F_PSIZE
    for c in range(last + 1):
        assert want[:, c].abs().max() > 0, c
        err = (got[:, c] - want[:, c]).abs().max().item()
        assert err <= _grad_budget(want[:, c]), (c, err)
    assert (got[:, last + 1:] == 0).all()


def test_composite_bwd_kernel_is_deterministic(dev):
    args = _bwd_args(dev, 256, 200, 3000, False)
    a = comp._composite_bwd_cuda(*args)
    b = comp._composite_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _bf16_budget(want):
    """The bf16 kernel vs its plain version: they differ in the order of
    f32 sums (the tensor cores' accumulation) and in the rare bf16 rounding
    flip of a w·φ or dpower operand that such a difference causes; 2e-3 of
    the column's largest value, ten times tighter than the JAX suite's bf16
    criterion (2e-2, tests/test_rasterize.py:157)."""
    return 2e-3 * max(want.abs().max().item(), 1e-8) + 1e-6


@pytest.mark.parametrize("image_only", [False, True])
@pytest.mark.parametrize("W,H,n", [(64, 64, 300), (256, 200, 3000)])
def test_composite_bwd_bf16_kernel_matches_plain(dev, W, H, n, image_only):
    args = _bwd_args(dev, W, H, n, image_only)
    got = comp._composite_bwd_bf16_cuda(*args).reshape(-1, comp.NFEAT)
    torch.cuda.synchronize()
    want = comp.composite_bwd_bf16_reference(*args).reshape(-1, comp.NFEAT)
    last = comp.F_B if image_only else comp.F_PSIZE
    for c in range(last + 1):
        assert want[:, c].abs().max() > 0, c
        err = (got[:, c] - want[:, c]).abs().max().item()
        assert err <= _bf16_budget(want[:, c]), (c, err)
    assert (got[:, last + 1:] == 0).all()


def test_composite_bwd_bf16_kernel_is_deterministic(dev):
    args = _bwd_args(dev, 256, 200, 3000, False)
    a = comp._composite_bwd_bf16_cuda(*args)
    b = comp._composite_bwd_bf16_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("image_only", [False, True])
def test_rasterize_grads_on_card_match_cpu(dev, image_only):
    """Gradients of a render on the card (both compositor kernels, the
    gather VJP) vs on the CPU (plain versions), including means2d_probe."""
    rng = np.random.default_rng(9)
    n = 400
    arrs = [np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(3, 8, (n, 1))], 1),
            np.exp(rng.uniform(-3.5, -1.5, (n, 3))), rng.normal(size=(n, 4)),
            rng.uniform(0.2, 0.95, n), rng.normal(0, 0.3, (n, 16, 3)),
            np.zeros((n, 2))]
    grads = []
    for d in (dev, "cpu"):
        leaves = [torch.tensor(np.asarray(a, np.float32), device=d,
                               requires_grad=True) for a in arrs]
        m, s, q, o, sh, probe = leaves
        cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 88, 72, device=d)
        out = rasterize(cam, m, o, shs=sh, scales=s, quats=q,
                        means2d_probe=probe,
                        bg=torch.tensor([0.2, 0.3, 0.4], device=d),
                        settings=RasterSettings(entry_cap=1 << 15,
                                                image_grads_only=image_only))
        loss = torch.mean(out.image ** 2)
        if not image_only:
            loss = loss + 0.1 * torch.mean(out.depth) \
                + 0.1 * torch.mean(out.acc_pixel_size)
        grads.append(torch.autograd.grad(loss, leaves))
    for name, a, b in zip(("means", "scales", "quats", "opac", "shs",
                           "probe"), *grads):
        assert b.abs().max() > 0, name
        err = (a.cpu() - b).abs().max().item()
        assert err <= _grad_budget(b), (name, err)


def test_render_on_card_matches_cpu(dev):
    """The whole forward path on the card vs on the CPU (plain versions)."""
    rng = np.random.default_rng(7)
    n = 400
    arrs = [np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(3, 8, (n, 1))], 1),
            np.exp(rng.uniform(-3.5, -1.5, (n, 3))), rng.normal(size=(n, 4)),
            rng.uniform(0.2, 0.95, n), rng.normal(0, 0.3, (n, 16, 3))]
    outs = []
    for d in (dev, "cpu"):
        m, s, q, o, sh = (torch.tensor(np.asarray(a, np.float32), device=d)
                          for a in arrs)
        cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 88, 72, device=d)
        outs.append(rasterize(cam, m, o, shs=sh, scales=s, quats=q,
                              settings=RasterSettings(entry_cap=1 << 15)))
    a, b = outs
    for f, tol in (("image", 1e-5), ("transmittance", 1e-5),
                   ("depth", 1e-4), ("pixel_sizes", 1e-5)):
        assert (getattr(a, f).cpu() - getattr(b, f)).abs().max() <= tol, f
    for f in ("radii", "num_entries", "overflow"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.parametrize("entry_cap", [1 << 15, 1000])
def test_rowtight_binning_on_card_matches_plain(dev, entry_cap):
    """Row-tight binning on the card (kernels 1 and 2) against the plain
    path on the same preprocess output: every integer field equal, and
    gauss_id per tile as a multiset; 1000 overflows."""
    from msgs_torch.kernels.preprocess import PreprocessOut
    rng = np.random.default_rng(88)
    n = 800
    m, s, q, o, c = (torch.tensor(np.asarray(a, np.float32), device=dev)
                     for a in (np.concatenate([rng.uniform(-1.3, 1.3, (n, 2)),
                                               rng.uniform(1, 8, (n, 1))], 1),
                               np.exp(rng.uniform(-3.5, -1.5, (n, 3))),
                               rng.normal(size=(n, 4)),
                               rng.uniform(0.2, 0.95, n),
                               rng.uniform(0, 1, (n, 3))))
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, 88, 72, device=dev)
    pre = preprocess(cam, m, o, colors_precomp=c, scales=s, quats=q)
    a = bin_gaussians(pre, 88, 72, entry_cap, row_tight=True)
    b = bin_gaussians(PreprocessOut(*(x.cpu() for x in pre)), 88, 72,
                      entry_cap, row_tight=True)
    for f in ("sub_tile", "sub_valid", "tile_nonempty", "tile_last_sub",
              "num_entries", "overflow", "gid_starts"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert (int(b.overflow) > 0) == (entry_cap == 1000)

    def pairs(x):
        sv = x.sub_valid.cpu().bool()
        tile = x.sub_tile.cpu().long()[sv].repeat_interleave(32)
        gid = x.gauss_id.cpu().long().view(-1, 32)[sv].reshape(-1)
        return torch.sort(tile * (n + 1) + gid).values

    assert torch.equal(pairs(a), pairs(b))


def test_wrappers_refuse_other_dtypes(dev):
    with pytest.raises(TypeError):
        scan.cumsum_rows(torch.zeros(4, dtype=torch.int64, device=dev))


def _gather_inputs(dev, F, table_layout, rows=1001, E=2997, seed=0):
    rng = np.random.default_rng(seed + F)
    table = torch.tensor(rng.normal(size=(rows, F)).astype(np.float32),
                         device=dev)
    if table_layout == "features":
        table = table.t().contiguous()
    gid = torch.tensor(rng.integers(0, rows, E).astype(np.int32), device=dev)
    return table, gid


@pytest.mark.parametrize("out_layout", ["entry", "feature", "blocked"])
@pytest.mark.parametrize("table_layout", ["rows", "features"])
@pytest.mark.parametrize("F", [12, 16])
def test_gather_kernel_matches_plain(dev, F, table_layout, out_layout):
    # E = 2997 is no multiple of the kernel's 256-thread blocks; 111
    # divides it.
    table, gid = _gather_inputs(dev, F, table_layout)
    block = 111 if out_layout == "blocked" else None
    before = _build.launch_counts["gather_rows"]
    got = gather_rows(table, gid, table_layout, out_layout, block)
    torch.cuda.synchronize()
    # A feature table is transposed first: two launches.
    assert _build.launch_counts["gather_rows"] == before + (
        2 if table_layout == "features" else 1)
    want = gather_rows_plain(table, gid, table_layout, out_layout, block)
    assert got.shape == want.shape
    # Exact: every bit, not only every value.
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("table_layout", ["rows", "features"])
def test_gather_kernel_clamps_ids(dev, table_layout):
    """Ids outside [0, rows) read the nearest row, as XLA's gather does."""
    table, gid = _gather_inputs(dev, 16, table_layout, rows=50, E=640)
    gid[::7] = -3
    gid[3::7] = 50 + 9
    got = gather_rows(table, gid, table_layout, "entry")
    want = gather_rows_plain(table, gid.clamp(0, 49), table_layout, "entry")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_gather_kernel_refuses_unaligned_width(dev):
    table, gid = _gather_inputs(dev, 6, "rows")
    with pytest.raises(ValueError):
        gather_rows(table, gid)


# Edges of the redesigned gather: one entry; E not a multiple of a warp's 64
# entries or a thread's 4; rows not a multiple of the transpose's 128-row
# tile; F = 4 (the any-width instances); blocks of 4 and not of 4.
@pytest.mark.parametrize("F,rows,E,table_layout,out_layout,block", [
    (16, 1001, 1, "rows", "entry", None),
    (16, 1001, 1, "features", "feature", None),
    (12, 1001, 1, "features", "blocked", 1),
    (16, 1001, 65, "rows", "entry", None),
    (12, 1001, 4 * 64 + 3, "features", "entry", None),
    (16, 1001, 4 * 64 + 3, "rows", "feature", None),
    (12, 257, 1000, "features", "feature", None),
    (16, 129, 999, "features", "blocked", 111),
    (4, 300, 1999, "rows", "entry", None),
    (4, 300, 1999, "features", "feature", None),
    (4, 300, 2000, "features", "blocked", 8),
    (8, 300, 2000, "rows", "blocked", 500),
    (12, 1001, 2000, "rows", "blocked", 250),
    (16, 1001, 4096, "features", "blocked", 2048)])
def test_gather_kernel_edges(dev, F, rows, E, table_layout, out_layout,
                             block):
    table, gid = _gather_inputs(dev, F, table_layout, rows=rows, E=E,
                                seed=E)
    got = gather_rows(table, gid, table_layout, out_layout, block)
    torch.cuda.synchronize()
    want = gather_rows_plain(table, gid, table_layout, out_layout, block)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("out_layout", ["entry", "feature", "blocked"])
def test_gather_kernel_clamps_ids_of_feature_tables(dev, out_layout):
    """The transposed feature table clamps as the row table does, in every
    output layout (rows = 130 is no multiple of the transpose's tile)."""
    table, gid = _gather_inputs(dev, 12, "features", rows=130, E=1000)
    gid[::5] = -7
    gid[2::5] = 130 + 4
    block = 8 if out_layout == "blocked" else None
    got = gather_rows(table, gid, "features", out_layout, block)
    want = gather_rows_plain(table, gid.clamp(0, 129), "features",
                             out_layout, block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("i", range(len(GATHER_INSTANCES)))
def test_gather_builds_fit(dev, i):
    """No stack frame and at least 4 CTAs of 256 threads an SM for every
    instance (the grid is sized from the CTAs an SM holds)."""
    info = _build.kernel_info("msgs_gather_rows_info", i)
    assert info["stack_bytes"] == 0, (GATHER_INSTANCES[i], info)
    assert info["ctas_per_sm"] >= 4, (GATHER_INSTANCES[i], info)


# The JAX script's 11 distinct (variant, precision) pairs.
_MXU_RUNS = sorted(set(RUNS), key=RUNS.index)


def _g_rows(dev):
    rng = np.random.default_rng(1)
    return torch.tensor(rng.normal(size=(NDF, NPIX)).astype(np.float32),
                        device=dev)


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("variant,precision", _MXU_RUNS)
def test_mxu_probe_kernel_matches_plain(dev, variant, precision, per_block):
    """Every formulation at both precisions, summed and per block, within
    the tool's row budget; dfeat_nt on a nonzero g_rows (per block: its
    df)."""
    pay = make_payload(64, dev)
    kw = {"g_rows": _g_rows(dev)} if variant == "dfeat_nt" else {}
    before = _build.launch_counts["mxu_probe"]
    got = pair_block_probe(pay, variant, precision, per_block=per_block,
                           **kw)
    torch.cuda.synchronize()
    # One launch, the summed output's sum of partials included.
    assert _build.launch_counts["mxu_probe"] == before + 1
    want = pair_block_probe_plain(pay, variant, precision,
                                  per_block=per_block, **kw)
    dim = (2 if variant == "dfeat_nt" else 1) if per_block else 0
    held_rows(f"{variant} ({precision})", got, want, REL_BUDGET, dim)
    assert want.abs().max() > 0


@pytest.mark.parametrize("variant,precision", _MXU_RUNS)
def test_mxu_probe_kernel_ragged_grid(dev, variant, precision):
    """B = 61 leaves the last CTA 5 of its 8 blocks; dfeat_nt on zero
    g_rows is 0, as in the JAX script."""
    pay = make_payload(61, dev)
    got = pair_block_probe(pay, variant, precision)
    want = pair_block_probe_plain(pay, variant, precision)
    torch.cuda.synchronize()
    held_rows(variant, got, want, REL_BUDGET, 0)
    if variant == "dfeat_nt":
        assert not got.any()


@pytest.mark.parametrize("variant,precision", [
    r for r in _MXU_RUNS if r[1] != "HIGH"])
def test_mxu_probe_fp32_runs_are_bit_exact_per_block(dev, variant,
                                                     precision):
    """The f32 runs sum in the plain version's order under -fmad=false:
    every per-block term (dfeat_nt: its df on a nonzero g_rows) equals it
    to the bit."""
    pay = make_payload(96, dev)
    kw = {"g_rows": _g_rows(dev)} if variant == "dfeat_nt" else {}
    got = pair_block_probe(pay, variant, precision, per_block=True, **kw)
    torch.cuda.synchronize()
    want = pair_block_probe_plain(pay, variant, precision, per_block=True,
                                  **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 31, 33, 1000, 5000])
def test_mxu_probe_summed_grid_and_groups(dev, B):
    """Grids of one CTA, of fewer CTAs than blocks, and of more than one
    group of 32 CTAs (the second ticket level): the summed output within
    budget of the plain version, and bit-identical over launches (the
    tickets are left at 0 by each launch)."""
    pay = make_payload(B, dev)
    got = pair_block_probe(pay, "base")
    want = pair_block_probe_plain(pay, "base")
    torch.cuda.synchronize()
    held_rows("base", got, want, REL_BUDGET, 0)
    for _ in range(3):
        again = pair_block_probe(pay, "base")
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("i", range(len(PROBE_INSTANCES)))
def test_mxu_probe_builds_fit(dev, i):
    """Every instance builds with no stack frame and fits on an SM."""
    idx = instance_index(*PROBE_INSTANCES[i])
    info = _build.kernel_info("msgs_mxu_probe_info", idx)
    assert info["stack_bytes"] == 0, (PROBE_INSTANCES[i], info)
    assert info["ctas_per_sm"] >= 1, (PROBE_INSTANCES[i], info)


def test_mxu_probe_kernel_is_deterministic(dev):
    pay = make_payload(300, dev)
    for variant, precision in (("base", None), ("scan_mxu", "HIGH"),
                               ("acc_tn", "HIGH")):
        a = pair_block_probe(pay, variant, precision)
        b = pair_block_probe(pay, variant, precision)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    g = _g_rows(dev)
    a = pair_block_probe(pay, "dfeat_nt", "HIGH", g_rows=g)
    b = pair_block_probe(pay, "dfeat_nt", "HIGH", g_rows=g)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# The ablation kernels (csrc/fwd_ablate.cu, csrc/bwd_ablate.cu): every sum
# runs in the plain version's order and the build has -fmad=false, so each
# variant equals its plain version bit for bit (torch.equal: up to the sign
# of a zero), the bf16 moments included (their products are exact in f32).
_AW, _AH, _ATX = exp_fwd_ablate.W, exp_fwd_ablate.H, 120


def _ablate_stream(dev):
    """The clustered check stream, 16 blocks: skips, boundary crossings."""
    return exp_fwd_ablate.clustered_stream(dev, 16)


def _pairs_stream(dev, n_blocks=16, seed=5):
    """A seeded payload whose means lie in tile 0, where the pairs
    variants (tile-local pixels, no tile origin) see their splats; the
    last block does not compute."""
    rng = np.random.default_rng(seed)
    pay = np.zeros((n_blocks, 128, 12), np.float32)
    pay[..., 0:2] = rng.uniform(0, 16, (n_blocks, 128, 2))
    pay[..., 2] = rng.uniform(0.02, 0.4, (n_blocks, 128))
    pay[..., 3] = rng.uniform(-0.01, 0.01, (n_blocks, 128))
    pay[..., 4] = rng.uniform(0.02, 0.4, (n_blocks, 128))
    pay[..., 5] = rng.uniform(0.1, 0.99, (n_blocks, 128))
    pay[..., 6:11] = rng.uniform(0, 1, (n_blocks, 128, 5))
    st = np.sort(rng.integers(0, 40, 4 * n_blocks)).astype(np.int32)
    sv = (np.arange(4 * n_blocks) < 4 * (n_blocks - 1) - 2).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(pay), t(st), t(sv)


@pytest.mark.parametrize("variant", ablate.FWD_VARIANTS)
def test_fwd_ablate_kernel_matches_plain(dev, variant):
    streams = [_ablate_stream(dev)[:3]]
    if variant.startswith("pairs") or variant == "no_states":
        streams.append(_pairs_stream(dev))
    for pay, st, sv in streams:
        before = _build.launch_counts["fwd_ablate"]
        got, written = ablate.fwd_ablate(pay, st, sv, variant, _ATX, _AW,
                                         _AH)
        torch.cuda.synchronize()
        assert _build.launch_counts["fwd_ablate"] == before + (
            1 if variant in ablate.TILE_VARIANTS else 2)
        want, want_written = ablate.fwd_ablate_plain(pay, st, sv, variant,
                                                     _ATX, _AW, _AH)
        assert torch.equal(written, want_written), variant
        assert torch.equal(got, want), (variant, float(
            (got - want).abs().max()))
        if variant != "no_dump":
            assert want[written][:, :5].abs().max() > 0


@pytest.mark.parametrize("variant", ablate.BWD_VARIANTS)
def test_bwd_ablate_kernel_matches_plain(dev, variant):
    pay, st, sv, tls = _ablate_stream(dev)
    tiles = ablate.n_tiles(_ATX, _AH)
    res = comp.composite(pay, st, sv, tls, tiles, _ATX, _AW, _AH)
    cst = exp_fwd_ablate.make_cst(res)
    got = ablate.bwd_ablate(pay, st, sv, cst, variant, _ATX, _AW, _AH)
    torch.cuda.synchronize()
    want = ablate.bwd_ablate_plain(pay, st, sv, cst, variant, _ATX, _AW,
                                   _AH)
    assert torch.equal(got, want), (variant, float(
        (got - want).abs().max()))
    assert want.abs().max() > 0
    again = ablate.bwd_ablate(pay, st, sv, cst, variant, _ATX, _AW, _AH)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_ablate_full_equals_kernels_3_and_4(dev):
    """fwd/full at each tile's last sub is composite_fwd.cu's output, and
    bwd/full's colour columns composite_bwd.cu's image-only ones, bit for
    bit (the same per-sub arithmetic and pixel-sum order)."""
    pay, st, sv, tls = _ablate_stream(dev)
    tiles = ablate.n_tiles(_ATX, _AH)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    k3 = comp._composite_cuda(pay, first, n_sub, tiles, _ATX, _AW, _AH)
    out, written = ablate.fwd_ablate(pay, st, sv, "full", _ATX, _AW, _AH)
    used = (n_sub > 0).nonzero()[:, 0]
    assert written[tls[used].long()].all()
    assert torch.equal(out[tls[used].long()], k3[used])
    cot = torch.full_like(k3, 0.1)
    k4 = comp._composite_bwd_cuda(pay, first, n_sub, k3, cot, tiles, _ATX,
                                  _AW, _AH, True)
    dpay = ablate.bwd_ablate(pay, st, sv, exp_fwd_ablate.make_cst(k3),
                             "full", _ATX, _AW, _AH)
    assert torch.equal(dpay[..., 6:9], k4[..., 6:9])


# The kernels of tools/exp_bwd2.py and exp_bwd3.py: horner (fwd_ablate.cu)
# and the backward forms (bwd_ablate.cu), bit for bit against their plain
# versions, as the ablation variants above.
_BWD_FORMS = exp_bwd2.BWD_RUNS


def test_fwd_horner_kernel_matches_plain(dev):
    for pay, st, sv in (_ablate_stream(dev)[:3], _pairs_stream(dev)):
        before = _build.launch_counts["fwd_ablate"]
        got, written = ablate.fwd_ablate(pay, st, sv, "horner", _ATX, _AW,
                                         _AH)
        torch.cuda.synchronize()
        assert _build.launch_counts["fwd_ablate"] == before + 2
        want, want_written = ablate.fwd_ablate_plain(pay, st, sv, "horner",
                                                     _ATX, _AW, _AH)
        assert torch.equal(written, want_written)
        assert torch.equal(got, want), float((got - want).abs().max())
        assert want[written][:, :5].abs().max() > 0


@pytest.mark.parametrize("run", list(_BWD_FORMS))
def test_bwd_form_kernel_matches_plain(dev, run):
    """Each run's form against its plain version; a form that zeroes in
    the kernel writes into a torch.empty buffer filled with NaN first, so
    an unwritten row shows."""
    form = _BWD_FORMS[run]
    pay, st, sv, tls = _ablate_stream(dev)
    tiles = ablate.n_tiles(_ATX, _AH)
    res = comp.composite(pay, st, sv, tls, tiles, _ATX, _AW, _AH)
    cst = exp_fwd_ablate.make_cst(res)
    if form.constants == "dense":
        cst = ablate.dense_cst(cst, st)
    out = None
    if form.zeroing == "kernel":
        out = torch.empty_like(pay).fill_(float("nan"))
    before = _build.launch_counts["bwd_ablate"]
    got = ablate.bwd_ablate(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                            out=out, form=form)
    torch.cuda.synchronize()
    assert _build.launch_counts["bwd_ablate"] == before + 1
    assert not got.isnan().any(), run
    want = ablate.bwd_ablate_plain(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                                   form=form)
    assert torch.equal(got, want), (run, float((got - want).abs().max()))
    assert want.abs().max() > 0
    again = ablate.bwd_ablate(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                              out=out, form=form)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_bwd_forms_match_kernel_4(dev):
    """Every form's colour columns, and the vpu forms' geometry columns,
    equal composite_bwd.cu's image-only backward bit for bit under a
    cotangent whose depth and acc rows are 0 (the image-only suffix);
    the dot_f32 forms' geometry is within the gradient budget."""
    pay, st, sv, tls = _ablate_stream(dev)
    tiles = ablate.n_tiles(_ATX, _AH)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    k3 = comp._composite_cuda(pay, first, n_sub, tiles, _ATX, _AW, _AH)
    cot = torch.full_like(k3, 0.1)
    cot[:, comp.O_DEPTH:comp.O_ACC + 1] = 0.0
    k4 = comp._composite_bwd_cuda(pay, first, n_sub, k3, cot, tiles, _ATX,
                                  _AW, _AH, True).reshape(-1, 12)
    cst = exp_fwd_ablate.make_cst(k3)
    for run, form in _BWD_FORMS.items():
        c = ablate.dense_cst(cst, st) if form.constants == "dense" else cst
        got = ablate.bwd_ablate(pay, st, sv, c, "full", _ATX, _AW, _AH,
                                form=form).reshape(-1, 12)
        assert torch.equal(got[:, 6:], k4[:, 6:]), run
        if form.moments == "vpu":
            assert torch.equal(got[:, :6], k4[:, :6]), run
        for col in range(6):
            tol = 3e-5 * float(k4[:, col].abs().max()) + 1e-6
            assert float((got[:, col] - k4[:, col]).abs().max()) <= tol, \
                (run, col)


def test_bwd_ablate_unbuilt_form_raises(dev):
    """A form the plain version takes but bwd_ablate.cu does not build is
    refused on the card, not run as another form."""
    pay, st, sv, tls = _ablate_stream(dev)
    cst = ablate.dense_cst(torch.zeros((ablate.n_tiles(_ATX, _AH), 8, 256),
                                       device=dev), st)
    form = ablate.BwdForm(constants="dense")      # bf16 moments, dense
    assert form not in ablate.BUILT_FORMS
    with pytest.raises(ValueError, match="not built"):
        ablate.bwd_ablate(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                          form=form)


# The redesigned ablation kernels: kernel 3's layout for the forward tile
# variants (a warp per strip walking alone, dump_last's 8 strips in one CTA
# deciding its skipped blocks after they stop), kernel 4's for the
# backward (early stop, the non-advancing variants walk their run's first
# block), on exp_fwd_ablate.staggered_stream: strips finish at chosen subs
# on both sides of a block boundary and tile 0 saturates before its run's
# last block.

def _staggered(dev):
    pay, st, sv, tls = exp_fwd_ablate.staggered_stream(dev)
    res = comp.composite(pay, st, sv, tls, ablate.n_tiles(_ATX, _AH), _ATX,
                         _AW, _AH)
    return pay, st, sv, exp_fwd_ablate.make_cst(res)


@pytest.mark.parametrize("variant", ablate.TILE_VARIANTS)
def test_fwd_tile_variants_on_staggered_strips(dev, variant):
    """Each strip stops at its own sub; written slots and values equal the
    plain version's, dump_last's deferred slots of the skipped blocks 2
    and 3 included."""
    pay, st, sv, _ = _staggered(dev)
    got, written = ablate.fwd_ablate(pay, st, sv, variant, _ATX, _AW, _AH)
    torch.cuda.synchronize()
    want, want_written = ablate.fwd_ablate_plain(pay, st, sv, variant, _ATX,
                                                 _AW, _AH)
    assert torch.equal(written, want_written), variant
    assert torch.equal(got, want), (variant, float(
        (got - want).abs().max()))
    if variant == "dump_last":
        assert bool(written[8:16].all())


@pytest.mark.parametrize("run", ["nozero", "all"])
def test_bwd_kernel_zeroing_forms_write_every_row(dev, run):
    """Over a NaN-filled out, the kernel-zeroing forms write every row of
    the covered blocks: the rows after tile 0 saturates (subs 7-15), which
    the kernel does not compute, and block 7, which does not compute, as
    zeros."""
    pay, st, sv, cst = _staggered(dev)
    out = torch.full_like(pay, float("nan"))
    form = ablate.BWD3_RUNS[run]
    got = ablate.bwd_ablate(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                            out=out, form=form)
    torch.cuda.synchronize()
    assert not got.isnan().any(), run
    want = ablate.bwd_ablate_plain(pay, st, sv, cst, "full", _ATX, _AW, _AH,
                                   form=form)
    assert torch.equal(got, want), (run, float((got - want).abs().max()))
    rows = got.reshape(32, 32, comp.NFEAT)
    assert bool((rows[7:16] == 0).all()) and bool((rows[28:] == 0).all())
    assert bool((rows[:7, :, 9:] == 0).all())


@pytest.mark.parametrize("variant", [v for v in ablate.BWD_VARIANTS
                                     if v not in ablate.ADVANCING])
def test_bwd_non_advancing_variants_at_carried_subs(dev, variant):
    """The variants that never advance the state read the zero state at
    the subs after their run's first block (tile 0's subs 4-15, tile 1's
    20-21, tile 2's 24-27): their rows are 0, the first blocks' are not,
    and all equal the plain version's."""
    pay, st, sv, cst = _staggered(dev)
    got = ablate.bwd_ablate(pay, st, sv, cst, variant, _ATX, _AW, _AH)
    torch.cuda.synchronize()
    want = ablate.bwd_ablate_plain(pay, st, sv, cst, variant, _ATX, _AW,
                                   _AH)
    assert torch.equal(got, want), (variant, float(
        (got - want).abs().max()))
    rows = got.reshape(32, 32, comp.NFEAT)
    carried = [*range(4, 16), 20, 21, *range(24, 28)]
    assert bool((rows[carried] == 0).all())
    assert bool((rows[:4] != 0).any()) and bool((rows[16:20] != 0).any())


@pytest.mark.parametrize("i", range(len(ablate.BWD_INSTANCES)))
def test_bwd_ablate_builds_fit(dev, i):
    """Kernel 4's layout: no stack frame and 3 CTAs per SM for every
    instance (the first port's built to 254-255 registers, one CTA)."""
    info = _build.kernel_info("msgs_bwd_ablate_info", i)
    assert info["stack_bytes"] == 0, (ablate.BWD_INSTANCES[i], info)
    assert info["ctas_per_sm"] >= 3, (ablate.BWD_INSTANCES[i], info)


@pytest.mark.parametrize("i", range(len(ablate.ALL_FWD) + 1))
def test_fwd_ablate_builds_fit(dev, i):
    """No stack frame anywhere; the tile variants at most 96 registers, 16
    warps per SM (2-warp CTAs, dump_last's 8-warp ones); the block kernel
    3 CTAs per SM (1 for no_states and pairs_only, whose chains spill at
    80 and 128 registers). i = len(ALL_FWD) is the running sum."""
    info = _build.kernel_info("msgs_fwd_ablate_info", i)
    name = (ablate.ALL_FWD + ("running_sum",))[i]
    assert info["stack_bytes"] == 0, (name, info)
    if name in ablate.TILE_VARIANTS:
        assert info["registers"] <= 96, (name, info)
        assert info["ctas_per_sm"] >= (2 if name == "dump_last" else 8), \
            (name, info)
    elif name != "running_sum":
        want = 1 if name in ("no_states", "pairs_only") else 3
        assert info["ctas_per_sm"] >= want, (name, info)


@pytest.mark.parametrize("variant", ablate.ALL_FWD)
def test_fwd_ablate_kernel_is_deterministic(dev, variant):
    pay, st, sv, _ = _ablate_stream(dev)
    a, wa = ablate.fwd_ablate(pay, st, sv, variant, _ATX, _AW, _AH)
    b, wb = ablate.fwd_ablate(pay, st, sv, variant, _ATX, _AW, _AH)
    assert torch.equal(wa, wb)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# The single-pass scan (kernels 1 and 2): one launch per call, status words
# and tickets kept per device and stream from call to call.

@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("R", [1, 7, 4])
@pytest.mark.parametrize("E", [1, 4_095, 4_096, 4_097, 999_983])
def test_scan_lookback_matches_plain(dev, dtype, R, E):
    """Lengths around a chunk (4096 elements) and a prime near 10^6 (rows
    off 16-byte boundaries); int32 rows walk up to ±(2^31 − 1) and back, so
    chunk totals wrap."""
    x = _rows(dtype, R, E, seed=E + R).to(dev)
    got = scan.cumsum_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(got, scan.cumsum_rows_plain(x))


def test_scan_many_calls_no_stale_status(dev):
    """Calls of shrinking and growing shapes in a row, and calls left in
    flight on two streams at once: each equals its plain version."""
    xs = [_rows(dt, R, E, seed=i).to(dev) for i, (dt, R, E) in enumerate(
        [(torch.int32, 4, 300_000), (torch.float32, 1, 5_000),
         (torch.int32, 2, 700_001), (torch.float32, 3, 2_049),
         (torch.int32, 4, 300_000)])]
    outs = [scan.cumsum_rows(x) for _ in range(6) for x in xs]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, scan.cumsum_rows_plain(xs[i % len(xs)])), i
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    pending = []
    for _ in range(8):
        for s, x in zip(streams, (xs[0], xs[2])):
            with torch.cuda.stream(s):
                pending.append((x, scan.cumsum_rows(x)))
    torch.cuda.synchronize()
    for x, got in pending:
        assert torch.equal(got, scan.cumsum_rows_plain(x))


def test_scan_epoch_wrap(dev):
    """Past the epoch limit the state's buffer is zeroed once and the
    epochs start again at 1; the scan stays exact across the wrap. Before
    every launch no status word (epoch | flag | value, the epoch in the top
    30 bits) may carry the call's epoch, and the kernel must have left
    every ticket at 0: the look-back reads a word of its own epoch as
    ready. Long and short calls alternate, so a long call after a wrap
    meets words of its epoch from the long call two before it unless the
    wrap zeroed them; every call scans other values."""
    xs = [_rows(torch.int32, *((3, 300_000) if i % 2 == 0 else (1, 5_000)),
                seed=30 + i).to(dev) for i in range(7)]
    key = (xs[0].device.index, torch.cuda.current_stream(dev).cuda_stream)
    old = scan._states.get(key)
    state = scan._states[key] = scan.LookbackState(dev, limit=3)
    take = state.take

    def checked_take(rows, length):
        tickets, status, epoch = take(rows, length)
        assert not bool((((status >> 34) & (2**30 - 1)) == epoch).any())
        assert not bool(tickets.any())
        return tickets, status, epoch

    state.take = checked_take
    try:
        for i, x in enumerate(xs):
            assert torch.equal(scan.cumsum_rows(x),
                               scan.cumsum_rows_plain(x)), i
        assert state.epoch < 3
    finally:
        if old is None:
            del scan._states[key]
        else:
            scan._states[key] = old


def test_scan_refuses_graph_capture(dev):
    """A captured graph would replay one epoch: the wrapper raises."""
    x = _rows(torch.float32, 2, 5_000, seed=4).to(dev)
    scan.cumsum_rows(x)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            scan.cumsum_rows(x)


def test_scan_refuses_too_many_rows(dev):
    with pytest.raises(RuntimeError, match="scan_f32"):
        scan.cumsum_rows(torch.zeros((65_536, 3), device=dev))


# The redesigned bwd_bf16 backward (kernel 4b) on hand-made streams.

def _gauss_rows(rng, n, cx, cy, sig, op):
    """n payload rows of Gaussians centred at (cx, cy) (pixels, absolute)
    with standard deviations in `sig` and opacities in `op` (ranges)."""
    s = rng.uniform(*sig, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, si = np.cos(th), np.sin(th)
    # Conic = inverse covariance of R diag(s²) Rᵀ.
    a, b = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    rows = np.zeros((n, comp.NFEAT), np.float32)
    rows[:, comp.F_MX] = cx
    rows[:, comp.F_MY] = cy
    rows[:, comp.F_CXX] = a * c * c + b * si * si
    rows[:, comp.F_CXY] = (a - b) * c * si
    rows[:, comp.F_CYY] = a * si * si + b * c * c
    rows[:, comp.F_OP] = rng.uniform(*op, n)
    rows[:, comp.F_R:comp.F_PSIZE + 1] = rng.uniform(0.1, 4.0, (n, 5))
    return rows


def _handmade_args(dev, width, height, subs, image_only, seed=0):
    """A stream of hand-made sub-blocks: subs[t] lists tile t's sub-blocks
    (each 32 payload rows); two unowned sub-blocks follow. Returns the
    backward's arguments with the kernel forward's output and a seeded
    cotangent."""
    tx = (width + 15) // 16
    tiles = tx * ((height + 15) // 16)
    assert len(subs) == tiles
    rng = np.random.default_rng(seed)
    blocks = [b for t in subs for b in t]
    blocks += [_gauss_rows(rng, 32, 8.0, 8.0, (2, 4), (0.5, 0.9))] * 2
    payload = torch.tensor(np.concatenate(blocks), device=dev)
    n_sub = torch.tensor([len(t) for t in subs], dtype=torch.int32,
                         device=dev)
    first = (torch.cumsum(n_sub, 0) - n_sub).to(torch.int32)
    res = comp._composite_cuda(payload, first, n_sub, tiles, tx, width,
                               height)
    g = torch.Generator().manual_seed(seed)
    cot = torch.randn(res.shape, generator=g).to(dev)
    return (payload, first, n_sub, res, cot, tiles, tx, width, height,
            image_only)


def _bf16_held(args):
    """The kernel against its plain version per column; the uncomputed
    columns and the two unowned sub-blocks at the end 0. Returns the
    kernel's dpay as rows."""
    got = comp._composite_bwd_bf16_cuda(*args).reshape(-1, comp.NFEAT)
    torch.cuda.synchronize()
    want = comp.composite_bwd_bf16_reference(*args).reshape(-1, comp.NFEAT)
    last = comp.F_B if args[9] else comp.F_PSIZE
    for c in range(last + 1):
        assert want[:, c].abs().max() > 0, c
        err = (got[:, c] - want[:, c]).abs().max().item()
        assert err <= _bf16_budget(want[:, c]), (c, err)
    assert bool((got[:, last + 1:] == 0).all())
    assert bool((got[-64:] == 0).all())
    return got


def _edge_subs():
    """40 × 24 pixels (3 × 2 tiles): the last tile column and row are
    partial (8 of 16 pixels); tiles 1 and 4 have no sub-blocks; tile 2
    saturates in its first sub-block (opaque, wide Gaussians), so its
    other three sub-blocks are never reached. Sub-blocks per tile."""
    rng = np.random.default_rng(1)
    rand = lambda t, k: [_gauss_rows(
        rng, 32, 16 * (t % 3) + rng.uniform(-4, 20, 32),
        16 * (t // 3) + rng.uniform(-4, 20, 32), (1.5, 6), (0.1, 0.95))
        for _ in range(k)]
    opaque = [_gauss_rows(rng, 32, 36.0, 8.0, (60, 80), (0.99, 0.99))]
    return [rand(0, 3), [], opaque + rand(2, 3), rand(3, 1), [],
            rand(5, 4)]


def _staggered_subs():
    """One 16 × 16 tile, 258 sub-blocks: sub-block k holds 28 faint
    Gaussians and 4 opaque ones on pixel k alone, so pixel k saturates in
    sub-block k and the tile in sub-block 255."""
    rng = np.random.default_rng(4)
    subs = []
    for k in range(258):
        px, py = (k % 16) + 0.0, (k // 16) % 16 + 0.0
        faint = _gauss_rows(rng, 28, rng.uniform(0, 16, 28),
                            rng.uniform(0, 16, 28), (1.0, 3.0),
                            (0.004, 0.008))
        sharp = _gauss_rows(rng, 4, px, py, (0.25, 0.25), (0.99, 0.99))
        subs.append(np.concatenate([faint, sharp]))
    return [subs]


@pytest.mark.parametrize("image_only", [False, True])
def test_bwd_bf16_edges_and_empty_tiles(dev, image_only):
    """_edge_subs: partial edge tiles, empty tiles, and a tile that
    saturates in its first sub-block, whose later sub-blocks the kernel
    must not reach."""
    args = _handmade_args(dev, 40, 24, _edge_subs(), image_only, seed=2)
    got = _bf16_held(args)
    # Tile 2 (the opaque one) saturates in its first sub-block: its other
    # three sub-blocks stay 0, as in the plain version.
    res = args[3]
    assert bool((res[2, comp.O_DONE] == 1).all())
    first = int(args[1][2])
    assert bool((got[(first + 1) * 32:(first + 4) * 32] == 0).all())
    assert bool((got[first * 32:(first + 1) * 32] != 0).any())


def test_bwd_bf16_pixels_saturate_at_different_subs(dev):
    """_staggered_subs: the kernel matches its plain version, is
    bit-identical on a second launch, and stops where the forward stopped:
    sub-block 255 has gradients, 256 and 257 none."""
    args = _handmade_args(dev, 16, 16, _staggered_subs(), True, seed=5)
    assert bool((args[3][0, comp.O_DONE] == 1).all())
    got = _bf16_held(args)
    assert bool((got[255 * 32:256 * 32] != 0).any())
    assert bool((got[256 * 32:258 * 32] == 0).all())
    again = comp._composite_bwd_bf16_cuda(*args).reshape(-1, comp.NFEAT)
    assert torch.equal(got, again)


def test_bwd_bf16_build_fits_two_ctas(dev):
    """The redesign's point: no stack frame and at least two CTAs per SM
    (the first port had 255 registers, a stack frame and one CTA)."""
    for image_only in (0, 1):
        info = _build.kernel_info("msgs_composite_bwd_bf16_info", image_only)
        assert info["stack_bytes"] == 0, info
        assert info["ctas_per_sm"] >= 2, info


# The redesigned compositor forward (kernel 3) and exact backward (kernel
# 4) on the same hand-made streams.

def _fwd_held(args):
    """Kernel 3 against its plain version within the forward budgets of
    test_composite_kernel_matches_plain (T and done exact). Returns the
    kernel's output."""
    payload, first, n_sub, _, _, tiles, tx, width, height, _ = args
    got = comp._composite_cuda(payload, first, n_sub, tiles, tx, width,
                               height)
    torch.cuda.synchronize()
    want = comp._composite_plain(payload, first, n_sub, tiles, tx, width,
                                 height)[0]
    for ch, tol in ((comp.O_R, 1e-5), (comp.O_G, 1e-5), (comp.O_B, 1e-5),
                    (comp.O_T, 0.0), (comp.O_DONE, 0.0),
                    (comp.O_DEPTH, 1e-4), (comp.O_ACC, 1e-4)):
        assert (got[:, ch] - want[:, ch]).abs().max().item() <= tol, ch
    return got


def _exact_held(args):
    """Kernel 4 against its plain version per column (the gradient
    budget); the uncomputed columns and the two unowned sub-blocks at the
    end 0. Returns the kernel's dpay as rows."""
    got = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
    torch.cuda.synchronize()
    want = comp.composite_bwd_reference(*args).reshape(-1, comp.NFEAT)
    last = comp.F_B if args[9] else comp.F_PSIZE
    for c in range(last + 1):
        assert want[:, c].abs().max() > 0, c
        err = (got[:, c] - want[:, c]).abs().max().item()
        assert err <= _grad_budget(want[:, c]), (c, err)
    assert bool((got[:, last + 1:] == 0).all())
    assert bool((got[-64:] == 0).all())
    return got


@pytest.mark.parametrize("image_only", [False, True])
def test_composite_edges_and_empty_tiles(dev, image_only):
    """_edge_subs through kernels 3 and 4: partial edge tiles, empty
    tiles, and a tile that saturates in its first sub-block, whose later
    sub-blocks neither kernel may reach; two launches are bit-identical."""
    args = _handmade_args(dev, 40, 24, _edge_subs(), image_only, seed=2)
    res = _fwd_held(args)
    assert bool((res[2, comp.O_DONE] == 1).all())
    got = _exact_held(args)
    first = int(args[1][2])
    assert bool((got[(first + 1) * 32:(first + 4) * 32] == 0).all())
    assert bool((got[first * 32:(first + 1) * 32] != 0).any())
    assert torch.equal(_fwd_held(args), res)
    again = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_composite_pixels_saturate_at_different_subs(dev):
    """_staggered_subs through kernels 3 and 4: each pixel saturates in
    its own sub-block, so kernel 3's warps stop at different sub-blocks;
    kernel 4 stops where the forward stopped: sub-block 255 has
    gradients, 256 and 257 none. Two launches are bit-identical."""
    args = _handmade_args(dev, 16, 16, _staggered_subs(), True, seed=5)
    res = _fwd_held(args)
    assert bool((res[0, comp.O_DONE] == 1).all())
    got = _exact_held(args)
    assert bool((got[255 * 32:256 * 32] != 0).any())
    assert bool((got[256 * 32:258 * 32] == 0).all())
    assert torch.equal(_fwd_held(args), res)
    again = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("entry,arg,ctas", [
    ("msgs_composite_fwd_info", 0, 8),    # 2-warp CTAs, 16 warps per SM
    ("msgs_composite_bwd_info", 1, 3),    # image_only
    ("msgs_composite_bwd_info", 0, 3)])
def test_composite_builds_fit(dev, entry, arg, ctas):
    """The redesign's point: no stack frame, and the CTAs per SM the
    designs state (the first port built kernel 3 to ~186 registers and
    kernel 4 to 255, one CTA per SM)."""
    info = _build.kernel_info(entry, arg)
    assert info["stack_bytes"] == 0, info
    assert info["ctas_per_sm"] >= ctas, info


@pytest.fixture
def viewing_model(dev, tmp_path):
    """A model dir whose PLY is the initial cloud of a small synthetic
    scene (4 + 1 views at 64×48, 500 Gaussians), rendered on the card."""
    import argparse

    from msgs_torch.apps.config import save_cfg
    from msgs_torch.data.dataset import load_scene
    from msgs_torch.data.synthetic import make_scene
    from msgs_torch.model.gaussians import GaussianConfig, create_from_points
    from msgs_torch.train.checkpoint import save_ply_snapshot
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_scene(scene, n_views=4, n_test=1, width=64, height=48,
               n_gaussians=500, device=dev, quiet=True)
    sc = load_scene(scene, eval_split=False, device="cpu")
    st = create_from_points(GaussianConfig(sh_degree=3, capacity=1024),
                            sc.points, sc.colors, device="cpu")
    ply = tmp_path / "model" / "point_cloud" / "iteration_1"
    ply.mkdir(parents=True)
    save_ply_snapshot(str(ply / "point_cloud.ply"), st)
    save_cfg(model, argparse.Namespace(source_path=scene, sh_degree=3,
                                       resolution=-1))
    return model


def test_viewer_headless_on_card_matches_cpu(dev, viewing_model, tmp_path,
                                             monkeypatch):
    """viewer.main headless on the card and on the CPU: view.png decodes
    equal, but for 1 at the truncation boundary."""
    from msgs_torch.apps import viewer
    from msgs_torch.apps.render import truncation_mismatches
    from msgs_torch.data.image import read_png
    from msgs_torch.train import loop as L
    outs = []
    orig = L.eval_render

    def recorded(*a, **k):
        outs.append(orig(*a, **k))
        return outs[-1]
    monkeypatch.setattr(L, "eval_render", recorded)
    pngs = []
    for d in ("cuda", "cpu"):
        out = str(tmp_path / d)
        viewer.main(["-m", viewing_model, "--anti_alias", "--out_dir", out,
                     "--device", d])
        pngs.append(read_png(out + "/view.png"))
    assert outs[0].image.is_cuda and pngs[0].shape == (48, 64, 3)
    assert pngs[0].max() > 0
    assert truncation_mismatches(pngs[1], pngs[0],
                                 outs[1].image.numpy()) == 0


def test_gui_frame_on_card_is_eval_render(dev, viewing_model):
    """One SIBR request served from the card through serve_step: the bytes
    are eval_render's image of the camera the request made, quantised."""
    import json
    import socket
    import struct
    import threading

    from msgs_torch.apps import network_gui as gui
    from msgs_torch.apps.render import load_viewing_model
    from msgs_torch.train import loop as L
    st, cfg, scene = load_viewing_model(viewing_model, None, -1, dev)
    settings = RasterSettings(entry_cap=1 << 16)
    view = scene.train_views[1]
    cam = make_camera(view.R, view.T, view.fovx, view.fovy, 64, 48,
                      device=dev)
    wv = cam.world_view.cpu().numpy().copy()
    fp = cam.full_proj.cpu().numpy().copy()
    wv[:, 1:3] *= -1
    fp[:, 1] *= -1
    msg = json.dumps({
        "resolution_x": 64, "resolution_y": 48, "train": True,
        "fov_y": view.fovy, "fov_x": view.fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": wv.reshape(-1).tolist(),
        "view_projection_matrix": fp.reshape(-1).tolist()}).encode()
    got, cams = {}, []

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            c.sendall(struct.pack("I", len(msg)) + msg)
            buf = b""
            while len(buf) < 64 * 48 * 3 + 4:
                buf += c.recv(1 << 16)
            got["img"] = buf[:64 * 48 * 3]

    def render_fn(c, scale_mod):
        cams.append(c)
        return L.eval_render(st, c, cfg=cfg, settings=settings).image

    gui.init("127.0.0.1", 0)
    t = threading.Thread(target=client,
                         args=(gui._listener.getsockname()[1],))
    t.start()
    try:
        ok = False
        for _ in range(500):
            ok = gui.serve_step(render_fn, "/scene", True, device=dev)
            if ok:
                break
            t.join(timeout=0.02)
        t.join(timeout=60)
    finally:
        gui.disconnect()
        gui._listener.close()
        gui._listener = None
    assert ok and not t.is_alive() and cams[0].world_view.is_cuda
    want = gui.frame_bytes(L.eval_render(st, cams[0], cfg=cfg,
                                         settings=settings).image)
    assert got["img"] == want and max(want) > 0


def _to(dev, args):
    return tuple(_to(dev, a) if isinstance(a, tuple) else a.to(dev)
                 for a in args)


def _path_launches(fn):
    """fn()'s result and its diff_hist launches by path."""
    before = {k: _build.launch_counts[k] for k in DIFF_HIST_PATHS}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _build.launch_counts[k] - before[k]
                 for k in DIFF_HIST_PATHS}


@pytest.mark.parametrize("W,H,n,live_share,path", [
    (1237, 822, 4_194_304, 0.9, "diff_hist_smem"),
    (1328, 864, 4_194_304, 0.65, "diff_hist_smem"),
    (32, 16, 4_194_304, 0.15, "diff_hist_smem"),
    (4080, 4080, 1_000_000, 0.9, "diff_hist_global")],
    ids=["msgs-m360-x1", "3dgs-db-x1", "coarse-zoom-85pct-empty",
         "257x257-past-shared-memory"])
def test_band_histogram_kernel_matches_plain(dev, W, H, n, live_share, path):
    """The banded path's histogram (K = 3) on the card, bit for bit against
    the plain corner scatter, one launch on the path the grid's size
    picks."""
    tx, ty = (W + 15) // 16, (H + 15) // 16
    args = _to(dev, band_rows(n, tx, ty, live_share, seed=W))
    got, launches = _path_launches(
        lambda: binning._band_histogram(*args, ty + 2, tx + 2))
    assert launches == {k: int(k == path) for k in DIFF_HIST_PATHS}
    want = binning._band_histogram_plain(*args, ty + 2, tx + 2)
    assert got.dtype == torch.int32 and bool((want != 0).any())
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["rect", "rowtight"])
def test_corner_histogram_kernel_matches_plain(dev, form):
    """K = 1: the rect path's and the row-tight path's corner arrays (as
    _bin_gaussians_rect and _bin_gaussians_rowtight form them) on the
    msgs-m360 ×1 grid, bit for bit, on the shared-memory path."""
    tx, ty = 78, 52
    rect_min, qs, txlos, ws, live = band_rows(1 << 20, tx, ty, 0.7, seed=7)
    if form == "rect":
        drop = torch.full_like(qs[2], ty + 1)
        corners = (torch.where(live, rect_min[:, 1], drop),
                   torch.where(live, rect_min[:, 1] + qs[2], drop),
                   rect_min[:, 0], rect_min[:, 0] + 2)
        ny, nx = ty + 2, tx + 2
    else:
        row = torch.where(ws[1] > 0, rect_min[:, 1], ty)
        corners = (row, torch.full_like(row, ty + 1), txlos[1].int(),
                   (txlos[1] + ws[1]).int())
        ny, nx = ty + 1, tx + 1
    corners = _to(dev, corners)
    got, launches = _path_launches(
        lambda: binning._diff_histogram(*corners, ny, nx))
    assert launches == {"diff_hist_smem": 1, "diff_hist_global": 0}
    want = binning._onehot_diff_histogram(*corners, ny, nx)
    assert bool((want != 0).any()) and torch.equal(got, want)


@pytest.mark.parametrize("ny,nx,path", [(54, 80, "diff_hist_smem"),
                                        (257, 257, "diff_hist_global")])
def test_diff_histogram_kernel_inverted_and_off_grid(dev, ny, nx, path):
    """Inverted rectangles and corners off the grid, in both forms: every
    corner the plain scatter keeps, the kernel keeps."""
    g = torch.Generator().manual_seed(ny)
    n = 200_000
    ri = lambda lo, hi: torch.randint(lo, hi, (n,), generator=g,
                                      dtype=torch.int32)
    corners = _to(dev, (ri(-5, ny + 5), ri(-5, ny + 5), ri(-5, nx + 5),
                        ri(-5, nx + 5)))
    got, launches = _path_launches(
        lambda: binning._diff_histogram(*corners, ny, nx))
    assert launches == {k: int(k == path) for k in DIFF_HIST_PATHS}
    assert torch.equal(got, binning._onehot_diff_histogram(*corners, ny, nx))
    # Bands: boundaries out of order, lows and widths past either edge.
    rect_min = torch.stack([ri(0, 1), ri(-3, ny + 3)], 1)
    qs = tuple(ri(-3, 7) for _ in range(3))
    txlos = tuple(ri(-6, nx + 6).float() for _ in range(3))
    ws = tuple(ri(0, 6).float() for _ in range(3))
    live = torch.rand(n, generator=g) < 0.7
    args = _to(dev, (rect_min, qs, txlos, ws, live))
    got, launches = _path_launches(
        lambda: binning._band_histogram(*args, ny, nx))
    assert launches == {k: int(k == path) for k in DIFF_HIST_PATHS}
    want = binning._band_histogram_plain(*args, ny, nx)
    assert bool((want != 0).any()) and torch.equal(got, want)


def test_diff_histogram_kernel_empty_and_refusals(dev):
    """No rows: a zero grid and no launch. Corner arrays of another dtype
    or length are refused."""
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    got, launches = _path_launches(
        lambda: binning._diff_histogram(z, z, z, z, 5, 6))
    assert launches == {k: 0 for k in DIFF_HIST_PATHS}
    assert got.shape == (5, 6) and not bool(got.any())
    a = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        binning._diff_histogram(a, a, a.float(), a, 5, 6)
    with pytest.raises(ValueError):
        binning._diff_histogram(a, a, a[:3], a, 5, 6)


@pytest.mark.parametrize("i,cells", [(0, 54 * 80), (1, 54 * 80), (2, 0),
                                     (3, 0)])
def test_diff_hist_builds_fit(dev, i, cells):
    """No stack frame, and at least 3 CTAs of 512 threads an SM (the
    shared instances at the msgs-m360 ×1 grid, 17,280 bytes)."""
    info = _build.kernel_info("msgs_diff_hist_info", i, cells)
    assert info["stack_bytes"] == 0, info
    assert info["dynamic_smem"] == 4 * cells, info
    assert info["ctas_per_sm"] >= 3, info
