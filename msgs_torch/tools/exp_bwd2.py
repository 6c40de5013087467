"""Follow-up A/Bs of the compositor: the port of tools/exp_bwd2.py.

    python -m msgs_torch.tools.exp_bwd2 [--device cpu] [--blocks K]

The JAX script times, at bench shapes, a forward that evaluates the power
from per-entry Horner coefficients (fwd/horner) and four forms of the
image-only backward: geom_vpu (the moments by multiplies and sums instead
of a matmul), cst_dense (the per-sub constants gathered into one dense
buffer first), both, and g16 (GROUP = 16). Here fwd/horner is
csrc/fwd_ablate.cu's `horner` instance and each backward csrc/
bwd_ablate.cu's `full` in its form (msgs_torch/kernels/ablate.py:
fwd_ablate, bwd_ablate, BWD2_RUNS; the module says what each computes).
The scene, the stream and the constant rows are tools/exp_fwd_ablate.py's:
the bench draws, 1920×1080, `entry_cap` 1,572,864, a cotangent of 0.1.
The runs come in the script's order and print as it prints them
(`<name>: <ms> ms`). cst_dense's gather of the constants
(exp_bwd2.py:333-335) is part of its timed call, and so is the zeroing of
dpay in a form that leaves it to the caller (the JAX kernel zeroes each
grid step's dpay block before its stores; exp_bwd3's nozero measures that
double write). Each backward's dpay is filled with NaN before its first
call, so a row that no call writes fails the check. Every run is held to
its plain version on the same inputs (the running sum ≤ 1e-5·max|row|,
backward columns ≤ 3e-5·max|column| + 1e-6) and a mismatch raises, where
the script prints FAILED. Times are medians of one call with its outputs
allocated once beforehand: CUDA events on the card, the host clock on the
CPU. `main` returns one record per run with the fields of
exp_fwd_ablate's: name, ms, launches, plain_ms, max_abs_err, exact (bit
for bit, up to the sign of a zero), kernel_ms (on the card, device ms per
call of each kernel and the events the profiler trace kept) and the bound
(bound_ms, bound_by, and the pairs, operations and bytes it counts on
this run's stream). `--blocks K` cuts the stream to its first K blocks (a
multiple of 16), for a quick run on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from msgs_torch import resolve_device
from msgs_torch.kernels import _build, ablate
from msgs_torch.kernels import composite as comp
from msgs_torch.tools import clock_name, device_name, time_ms, work
from msgs_torch.tools import exp_fwd_ablate as fa

W, H, ENTRY_CAP = fa.W, fa.H, fa.ENTRY_CAP
TILES_X = (W + 15) // 16
# Both scripts' backward runs under the names they print.
BWD_RUNS = {**{f"bwd/{k}": v for k, v in ablate.BWD2_RUNS.items()},
            **ablate.BWD3_RUNS}


def parse_args(argv, doc: str):
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--blocks", type=int, default=None,
                   help="cut the stream to its first K blocks")
    return p.parse_args(argv)


def setup(argv, doc: str):
    """The device, the script's stream (cut if asked), its constant rows
    and the work each function needs; prints the stream's size."""
    args = parse_args(argv, doc)
    dev = resolve_device(args.device)
    if args.blocks is not None and (args.blocks <= 0 or args.blocks % 16):
        raise ValueError(f"--blocks {args.blocks}: a positive multiple of "
                         f"16 (g16's grid step)")
    payload, st, sv, tls = fa.make_stream(dev, args.blocks)
    tiles = ablate.n_tiles(TILES_X, H)
    nb = int((sv[::4] == 1).sum())
    print(f"{payload.shape[0]} blocks, {int(sv.sum())} valid subs, {nb} "
          f"computed blocks on {dev} ({device_name(dev)})", flush=True)
    needs = work.stream_work(st, sv, ablate.fwd_ablate_plain(
        payload, st, sv, "full", TILES_X, W, H)[0], TILES_X, W, H)
    res = comp.composite(payload, st, sv, tls, tiles, TILES_X, W, H)
    cst = fa.make_cst(res.detach())
    # The rows g_r g_g g_b, total_phi and T_final·g_T of each tile read.
    cst_bytes = int(torch.unique(st[:4 * nb]).numel()) * 5 * comp.NPIX * 4
    return dict(dev=dev, stream=(payload, st, sv), needs=needs, cst=cst,
                cst_bytes=cst_bytes, reps=20 if dev.type == "cuda" else 2)


def _show(rec, clock):
    print(f"{rec['name']:24s}: {rec['ms']:7.4f} ms ({clock}); plain "
          f"{rec['plain_ms']:.4f} ms; max|Δ| {rec['max_abs_err']:.3e}"
          f"{' (exact)' if rec['exact'] else ''}; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)


def horner_record(env) -> dict:
    """fwd/horner against its plain version, timed."""
    dev, (payload, st, sv) = env["dev"], env["stream"]
    out = ablate.fwd_out(payload, "horner")
    call = lambda: ablate.fwd_ablate(payload, st, sv, "horner", TILES_X, W,
                                     H, out=out)
    before = _build.launch_counts["fwd_ablate"]
    got, written = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    want, want_written = ablate.fwd_ablate_plain(payload, st, sv, "horner",
                                                 TILES_X, W, H)
    if not torch.equal(written, want_written):
        raise RuntimeError("fwd/horner: written slots differ from the plain "
                           "version's")
    err, exact = fa.held("fwd/horner", got[written], want[written],
                         fa.REL_BUDGET)
    sums = want[written][:, :ablate.NACC]
    ms = time_ms(call, dev, env["reps"])
    rec = {"name": "fwd/horner", "ms": ms,
           "plain_ms": time_ms(lambda: ablate.fwd_ablate_plain(
               payload, st, sv, "horner", TILES_X, W, H), dev,
               min(env["reps"], 3)),
           "max_abs_err": err, "exact": exact,
           "written": int(written.sum()),
           "max_abs_sum": float(sums.abs().max()) if sums.numel() else 0.0,
           "kernel_ms": fa.kernel_ms(call) if dev.type == "cuda" else None,
           **work.bound(work.FWD_OPS["horner"], *work.pairs_and_bytes(
               env["needs"][work.FWD_NEEDS["horner"]],
               int(written.sum()) * work.SLOT_BYTES, st))}
    rec["launches"] = _build.launch_counts["fwd_ablate"] - before
    return rec


def bwd_records(env, runs: dict, prefix: str = "") -> list:
    """Each backward form of `runs` ({name: BwdForm}) against its plain
    version, timed; records named prefix + name."""
    dev, (payload, st, sv) = env["dev"], env["stream"]
    cst = env["cst"]
    recs = []
    for name, form in runs.items():
        dense = form.constants == "dense"
        buf = (torch.empty((st.shape[0],) + cst.shape[1:], dtype=cst.dtype,
                           device=dev) if dense else None)
        out = torch.full_like(payload, float("nan"))

        def call():
            if form.zeroing == "caller":
                out.zero_()
            c = ablate.dense_cst(cst, st, out=buf) if dense else cst
            return ablate.bwd_ablate(payload, st, sv, c, "full", TILES_X, W,
                                     H, out=out, form=form)

        before = _build.launch_counts["bwd_ablate"]
        got = call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        c = buf if dense else cst
        want = ablate.bwd_ablate_plain(payload, st, sv, c, "full", TILES_X,
                                       W, H, form=form)
        g2, w2 = got.reshape(-1, comp.NFEAT), want.reshape(-1, comp.NFEAT)
        err, exact = fa.held(prefix + name, g2, w2, fa.grad_tols(w2))
        ms = time_ms(call, dev, env["reps"])
        need = env["needs"][work.BWD_NEEDS["full"]]
        # dpay is written once in every form: the covered blocks' rows.
        n_cover = payload.shape[0] // form.group * form.group
        rec = {"name": prefix + name, "ms": ms,
               "plain_ms": time_ms(lambda: ablate.bwd_ablate_plain(
                   payload, st, sv, c, "full", TILES_X, W, H, form=form),
                   dev, min(env["reps"], 3)),
               "max_abs_err": err, "exact": exact, "form": form._asdict(),
               "kernel_ms": fa.kernel_ms(call) if dev.type == "cuda"
               else None,
               **work.bound(work.bwd_ops("full", form.moments),
                            *work.pairs_and_bytes(
                                need, n_cover * 4 * work.SUB_BYTES
                                + env["cst_bytes"], st))}
        rec["launches"] = _build.launch_counts["bwd_ablate"] - before
        recs.append(rec)
        _show(rec, clock_name(dev))
        del buf, out     # the next run allocates its own (dense: 470 MB)
    return recs


def main(argv=None) -> list:
    env = setup(argv, __doc__.splitlines()[0])
    clock = clock_name(env["dev"])
    print("=== forward power form ===", flush=True)
    records = [horner_record(env)]
    _show(records[0], clock)
    print("=== backward variants ===", flush=True)
    records += bwd_records(env, ablate.BWD2_RUNS, "bwd/")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
