"""The compositor with single pieces switched off: the port of
tools/exp_fwd_ablate.py.

    python -m msgs_torch.tools.exp_fwd_ablate [fwd|bwd|all] [--device cpu]

The JAX script runs the real compositor kernels with one piece disabled at
a time, at bench shapes, to find where their time goes. Here each variant
is the CUDA kernel of msgs_torch/kernels/ablate.py (fwd_ablate, bwd_ablate)
in that variant; see that module for what each computes.

The same scene: N = 100,000 Gaussians from numpy `default_rng(0)` (the
bench draws), 1920×1080, fov 1.2 × 0.8, `entry_cap` 1,572,864, through the
port's preprocess, binning and payload gather; the backward's constant rows
from the port's compositor output with a cotangent of 0.1 everywhere. The
same variants in the same order, printed as the script prints them
(`fwd/<variant>: <ms> ms`). Every variant is held to its plain version
(fwd_ablate_plain, bwd_ablate_plain) on the same inputs and the same
written slots: state slots at the compositor budgets (colour, T and acc ≤
1e-5, depth ≤ 1e-4, done equal), running sums ≤ 1e-5·max|row|, backward
columns ≤ 3e-5·max|column| + 1e-6; a mismatch raises. Times are medians
of one call with its output allocated once beforehand: CUDA events on the
card, the host clock on the CPU. `main` returns one record per variant:
name, ms, launches (of the CUDA kernels over the check and the timed
calls: 0 on the CPU), plain_ms,
max_abs_err (to the plain version), exact (bit for bit, up to the sign of
a zero), kernel_ms (on the card: device ms per call of each kernel and
the events it kept, from a profiler trace) and the bound: bound_ms,
bound_by ("bytes" or "operations"), with the pairs, operations and bytes
it counts on this run's stream (msgs_torch/tools/work.py: the operations
per pair of each variant, and the pairs before each 32-pixel strip is
done, of the subs in their run's first block, or of every computed block,
as the variant's function needs them).
`main(..., n_blocks=K)` cuts the stream to its first K blocks.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.core.camera import make_camera
from msgs_torch.kernels import _build, ablate
from msgs_torch.kernels import composite as comp
from msgs_torch.kernels.binning import bin_gaussians
from msgs_torch.kernels.preprocess import preprocess
from msgs_torch.kernels.rasterize import gather_payload
from msgs_torch.profile_render import bench_scene
from msgs_torch.tools import clock_name, device_name, time_ms, trace_ms, work

W, H, N, ENTRY_CAP = 1920, 1080, 100_000, 1_572_864
COT = 0.1
FWD_TOL = {comp.O_R: 1e-5, comp.O_G: 1e-5, comp.O_B: 1e-5,
           comp.O_DEPTH: 1e-4, comp.O_ACC: 1e-5, comp.O_T: 1e-5,
           comp.O_DONE: 0.0, 7: 0.0}
REL_BUDGET = 1e-5


def scene_stream(dev, scene, width: int, height: int, entry_cap: int):
    """A colors_precomp scene (means, scales, quats, opacities, colours as
    float32 numpy) seen by the script's camera (identity pose, fov 1.2 ×
    0.8) through the port's preprocess, binning and payload gather:
    (payload, sub_tile, sub_valid, tile_last_sub)."""
    means, scales, quats, opac, cols = (torch.as_tensor(a, device=dev)
                                        for a in scene)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, width, height,
                      device=dev)
    with torch.no_grad():
        pre = preprocess(cam, means, opac, colors_precomp=cols,
                         scales=scales, quats=quats)
        b = bin_gaussians(pre, width, height, entry_cap)
        payload = gather_payload(pre, b.gauss_id, b.gid_starts)
    if int(b.overflow):
        raise RuntimeError("exp_fwd_ablate: binning overflowed")
    return payload, b.sub_tile, b.sub_valid, b.tile_last_sub


def _cut(stream, n_blocks):
    payload, st, sv, tls = stream
    if n_blocks is not None:
        payload, st, sv = (payload[:n_blocks], st[:4 * n_blocks],
                           sv[:4 * n_blocks])
    return payload.contiguous(), st.contiguous(), sv.contiguous(), tls


def make_stream(dev, n_blocks=None):
    """The script's stream (tools/exp_fwd_ablate.py:38-67: the bench.py
    draws, 1920×1080, entry_cap 1,572,864), cut to its first n_blocks
    blocks if given."""
    return _cut(scene_stream(dev, bench_scene(0), W, H, ENTRY_CAP),
                n_blocks)


def clustered_stream(dev, n_blocks: int = 16, m: int = 300, seed: int = 0):
    """A dense check stream at the script's camera: m opaque Gaussians of
    about 6 px projecting around pixel (8, 8), binned with entry_cap 2048
    and cut to the first n_blocks blocks. At the defaults, tiles 0, 1, 120
    and 121 hold ten subs each and tiles 2 and 122 one: a run crosses
    block boundaries and the grid step's (sub 31 to 32), a block holds two
    tiles, and tile 0 saturates in its first block, so the kernels' skip
    rule fires."""
    rng = np.random.default_rng(seed)
    fx, fy = W / (2 * np.tan(0.6)), H / (2 * np.tan(0.4))
    z = rng.uniform(4, 6, m)
    px, py = 8 + rng.normal(0, 1, m), 8 + rng.normal(0, 1, m)
    means = np.stack([(px - (W - 1) / 2) * z / fx,
                      (py - (H - 1) / 2) * z / fy, z], 1)
    scales = np.repeat((6.0 * z / fx)[:, None], 3, 1) * np.exp(
        rng.uniform(-0.1, 0.1, (m, 3)))
    quats = np.tile([1.0, 0, 0, 0], (m, 1)) + rng.normal(0, 0.05, (m, 4))
    opac = rng.uniform(0.85, 0.99, m)
    cols = rng.uniform(0, 1, (m, 3))
    scene = tuple(a.astype(np.float32)
                  for a in (means, scales, quats, opac, cols))
    return _cut(scene_stream(dev, scene, W, H, 2048), n_blocks)


# staggered_stream: the sub of tile 0's run that saturates each strip.
DONE_AT = (1, 2, 3, 3, 4, 4, 5, 6)


def staggered_stream(dev):
    """A hand-made check stream of 8 blocks at the script's camera. Tile 0's
    run holds subs 0-15; strip u of it (pixels 32u..32u+31, rows 2u and
    2u+1) is saturated by 13 opaque splats in sub DONE_AT[u] and touched by
    nothing else but faint wide splats, so its strips finish at different
    subs on both sides of the boundary between blocks 0 and 1, and the
    tile saturates in sub 6, before its run's last block: blocks 2 and 3
    are skipped. Tiles 1 and 2 hold subs 16-21 and 22-27 of faint splats
    (runs that cross blocks 4-5 and 5-6); block 7 does not compute.
    Returns (payload, sub_tile, sub_valid, tile_last_sub)."""
    rng = np.random.default_rng(7)
    pay = np.zeros((8 * 4, 32, comp.NFEAT), np.float32)

    def faint(n, ox):
        rows = np.zeros((n, comp.NFEAT), np.float32)
        rows[:, 0] = ox + rng.uniform(6, 10, n)
        rows[:, 1] = rng.uniform(6, 10, n)
        rows[:, 2] = rows[:, 4] = rng.uniform(0.015, 0.025, n)
        rows[:, 3] = rng.uniform(-0.002, 0.002, n)
        rows[:, 5] = rng.uniform(0.03, 0.06, n)
        rows[:, 6:11] = rng.uniform(0.1, 1.0, (n, 5))
        return rows

    def strip(u):
        # α ≈ 0.53 on rows 2u and 2u+1, masked (below 1/255) beyond them.
        rows = np.zeros((13, comp.NFEAT), np.float32)
        rows[:, 0] = rng.uniform(6, 10, 13)
        rows[:, 1] = 2 * u + 0.5
        rows[:, 4] = 5.0
        rows[:, 5] = 0.99
        rows[:, 6:11] = rng.uniform(0.1, 1.0, (13, 5))
        return rows

    for k in range(16):
        rows = [strip(u) for u in range(8) if DONE_AT[u] == k]
        n = sum(len(r) for r in rows)
        pay[k] = np.concatenate(rows + [faint(32 - n, 0.0)])
    for k in range(16, 28):
        pay[k] = faint(32, 16.0 if k < 22 else 32.0)
    st = np.array([0] * 16 + [1] * 6 + [2] * 10, np.int32)
    sv = (np.arange(32) < 28).astype(np.int32)
    tiles = ablate.n_tiles((W + 15) // 16, H)
    tls = np.full(tiles, -1, np.int32)
    tls[:3] = (15, 21, 27)
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(pay.reshape(8, 128, comp.NFEAT)), t(st), t(sv), t(tls)


def make_cst(res, cot: float = COT):
    """The backward's constant rows (tools/exp_fwd_ablate.py:257-264) from
    the compositor output res (tiles, 8, 256) and a constant cotangent:
    [g_r, g_g, g_b, g_depth, g_acc, Σ_rgb res·g, res_T·g_T, 0]."""
    g = torch.full_like(res[:, :comp.O_ACC + 1], cot)
    total_phi = (res[:, :comp.O_B + 1] * g[:, :comp.O_B + 1]).sum(
        1, keepdim=True)
    tf_gt = res[:, comp.O_T:comp.O_T + 1] * cot
    return torch.cat([g, total_phi, tf_gt, torch.zeros_like(tf_gt)], 1)


def held(name, got, want, tols) -> tuple[float, bool]:
    """Raises unless got is within tols of want: {row: absolute} on dim 1,
    or a float relative to each row's max|want|. Returns (max|Δ|, exact)."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0, True
    other = [d for d in range(want.dim()) if d != 1]
    err = (got - want).abs().amax(dim=other)
    if isinstance(tols, dict):
        allow = torch.tensor([tols[r] for r in range(want.shape[1])],
                             device=want.device)
    else:
        allow = tols * want.abs().amax(dim=other)
    bad = ~(err <= allow)
    if bool(bad.any()):
        r = int(bad.nonzero()[0, 0])
        raise RuntimeError(f"{name}: row {r} max|Δ| {float(err[r])} > "
                           f"{float(allow[r])}")
    return float(err.max()), bool(torch.equal(got, want))


def grad_tols(want):
    """{column: 3e-5·max|column| + 1e-6} of want (rows, columns)."""
    return {c: 3e-5 * max(float(want[:, c].abs().max()), 1e-8) + 1e-6
            for c in range(want.shape[1])}


KERNELS = ("fwd_tile_kernel", "fwd_block_kernel", "running_sum_kernel",
           "bwd_ablate_kernel")


def kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel fn launches, from a profiler
    trace of `reps` calls (`trace_ms`): {kernel: {"ms": ms, "events": n}},
    the ablation kernels by name, the rest (the written mask's zeroing,
    dpay's zeroing, the dense constants' gather) together as "other". fn
    launches each ablation kernel once per call; the trace can lose events,
    so such a kernel's ms is the mean of the n events it kept (n < reps
    shows a loss). "other" is its total over reps, per call."""
    out, other, n_other = {}, 0.0, 0
    for name, r in trace_ms(fn, reps).items():
        if name in KERNELS:
            out[name] = r
        else:
            other += r["ms"] * r["events"]
            n_other += r["events"]
    if n_other:
        out["other"] = {"ms": other / reps, "events": n_other}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("which", nargs="?", default="all",
                   choices=("fwd", "bwd", "all"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None, n_blocks=None) -> list:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    payload, st, sv, tls = make_stream(dev, n_blocks)
    tiles_x = (W + 15) // 16
    tiles = ablate.n_tiles(tiles_x, H)
    B = payload.shape[0]
    clock = clock_name(dev)
    reps = 20 if dev.type == "cuda" else 1
    sargs = (payload, st, sv)
    print(f"exp_fwd_ablate: {B} blocks, {int(sv.sum())} valid subs, "
          f"{int((sv[::4] == 1).sum())} computed blocks on {dev} "
          f"({device_name(dev)})", flush=True)
    # The tile states of `full` give the work each function needs.
    needs = work.stream_work(st, sv, ablate.fwd_ablate_plain(
        *sargs, "full", tiles_x, W, H)[0], tiles_x, W, H)
    records = []
    if args.which in ("fwd", "all"):
        print("=== forward ablations ===", flush=True)
        for v in ablate.FWD_VARIANTS:
            out = ablate.fwd_out(payload, v)
            call = lambda: ablate.fwd_ablate(*sargs, v, tiles_x, W, H,
                                             out=out)
            before = _build.launch_counts["fwd_ablate"]
            got, written = call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            want, want_written = ablate.fwd_ablate_plain(*sargs, v, tiles_x,
                                                         W, H)
            if not torch.equal(written, want_written):
                raise RuntimeError(f"fwd/{v}: written slots differ from the "
                                   f"plain version's")
            tols = (FWD_TOL if v in ablate.TILE_VARIANTS else REL_BUDGET)
            err, exact = held(f"fwd/{v}", got[written], want[written], tols)
            ms = time_ms(call, dev, reps)
            split = kernel_ms(call) if dev.type == "cuda" else None
            launches = _build.launch_counts["fwd_ablate"] - before
            rec = {"name": f"fwd/{v}", "ms": ms, "launches": launches,
                   "plain_ms": time_ms(lambda: ablate.fwd_ablate_plain(
                       *sargs, v, tiles_x, W, H), dev, min(reps, 3)),
                   "max_abs_err": err, "exact": exact,
                   "written": int(written.sum()),
                   "kernel_ms": split,
                   **work.bound(work.FWD_OPS[v], *work.pairs_and_bytes(
                       needs[work.FWD_NEEDS[v]],
                       int(written.sum()) * work.SLOT_BYTES, st))}
            records.append(rec)
            print(f"fwd/{v:24s}: {ms:7.4f} ms ({clock}); plain "
                  f"{rec['plain_ms']:.4f} ms; max|Δ| {err:.3e}"
                  f"{' (exact)' if exact else ''}; bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})",
                  flush=True)
    if args.which in ("bwd", "all"):
        print("=== backward ablations ===", flush=True)
        res = comp.composite(payload, st, sv, tls, tiles, tiles_x, W, H)
        cst = make_cst(res.detach())
        nb = int((sv[::4] == 1).sum())
        # The rows g_r g_g g_b, total_phi and T_final·g_T of each tile read.
        cst_bytes = int(torch.unique(st[:4 * nb]).numel()) * 5 * comp.NPIX * 4
        for v in ablate.BWD_VARIANTS:
            out = torch.zeros_like(payload)
            call = lambda: ablate.bwd_ablate(*sargs, cst, v, tiles_x, W, H,
                                             out=out)
            before = _build.launch_counts["bwd_ablate"]
            got = call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            want = ablate.bwd_ablate_plain(*sargs, cst, v, tiles_x, W, H)
            g2, w2 = got.reshape(-1, comp.NFEAT), want.reshape(-1, comp.NFEAT)
            err, exact = held(f"bwd/{v}", g2, w2, grad_tols(w2))
            ms = time_ms(call, dev, reps)
            split = kernel_ms(call) if dev.type == "cuda" else None
            launches = _build.launch_counts["bwd_ablate"] - before
            need = needs[work.BWD_NEEDS[v]]
            rec = {"name": f"bwd/{v}", "ms": ms, "launches": launches,
                   "plain_ms": time_ms(lambda: ablate.bwd_ablate_plain(
                       *sargs, cst, v, tiles_x, W, H), dev, min(reps, 3)),
                   "max_abs_err": err, "exact": exact,
                   "kernel_ms": split,
                   **work.bound(work.bwd_ops(v), *work.pairs_and_bytes(
                       need, need[1] * work.SUB_BYTES + cst_bytes, st))}
            records.append(rec)
            print(f"bwd/{v:24s}: {ms:7.4f} ms ({clock}); plain "
                  f"{rec['plain_ms']:.4f} ms; max|Δ| {err:.3e}"
                  f"{' (exact)' if exact else ''}; bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})",
                  flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
