"""Formulations of the compositor's pair math: the port of tools/exp_mxu.py.

    python -m msgs_torch.tools.exp_mxu [n_blocks] [--device cpu]

The JAX script times, at the real kernel's block shape (128 entries × a
16×16 pixel tile, 14,336 blocks like the 1080p bench), what each candidate
formulation of the forward's pair math costs, and whether moving a part of
it onto the matrix unit pays. Here the matrix unit is the H100's tensor
cores and every run is the CUDA probe kernel
(msgs_torch/kernels/mxu_probe.py:pair_block_probe) in that run's variant
and precision; see that module for what each variant computes and how
HIGHEST and HIGH map onto the card.

The same inputs (numpy `default_rng(0)`, a (B, 128, 16) float32 payload
uniform on [0.1, 1), column 5 halved) and the same 12 runs in the same
order. Each run's summed (8, 256) output is held against its plain version
(pair_block_probe_plain) row by row, within REL_BUDGET·max|want| of the
row at either precision; a mismatch raises. dfeat_nt runs, as in the JAX
script, on zero g_rows, so its output is 0. Times are medians after a
warm-up: CUDA events on the card, the host clock on the CPU. `main` returns
one record per run: variant, precision, ms, launches (of the CUDA kernels:
0 on the CPU), plain_ms, max_abs_err (to the plain version),
budget (the largest row's allowance) and bound_ms (the larger of the
bytes, fp32-operations and tensor-core bounds, from the one operation
table, msgs_torch/tools/work.py:probe_bound; bound_by names it, tc_ms is
the tensor-core work alone).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.kernels import _build
from msgs_torch.kernels.mxu_probe import (BLOCK, NDF, NFEAT, NPIX,
                                          pair_block_probe,
                                          pair_block_probe_plain)
from msgs_torch.tools import clock_name, device_name, time_ms, work

DEFAULT_BLOCKS = 14336
# The JAX script's runs (tools/exp_mxu.py:240-251).
RUNS = (("empty", None), ("base", None), ("base", None), ("exp2", None),
        ("pow_mxu", "HIGHEST"), ("pow_mxu", "HIGH"),
        ("scan_mxu", "HIGHEST"), ("scan_mxu", "HIGH"),
        ("acc_tn", "HIGHEST"), ("acc_tn", "HIGH"),
        ("dfeat_nt", "HIGHEST"), ("dfeat_nt", "HIGH"))
# Allowance per output row against the plain version, × max|want| of the
# row, at every precision: 3×TF32 keeps each operand to ~2⁻²² where f32
# keeps 2⁻²⁴, so it fits the f32 budget, and 1×TF32 (2⁻¹¹) does not.
REL_BUDGET = 1e-5

def make_payload(n_blocks: int, dev) -> torch.Tensor:
    """The JAX script's draw (tools/exp_mxu.py:47-49)."""
    rng = np.random.default_rng(0)
    payload = rng.uniform(0.1, 1.0, (n_blocks, BLOCK, NFEAT)).astype(
        np.float32)
    payload[:, :, 5] *= 0.5
    return torch.as_tensor(payload, device=dev)


def held_rows(name: str, got: torch.Tensor, want: torch.Tensor, rel: float,
              dim: int) -> tuple[float, float]:
    """Raises unless every row (index along `dim`) of got is within
    rel·max|want of that row| of want; returns (max|Δ|, the largest row's
    allowance)."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)}, want "
                           f"{tuple(want.shape)}")
    other = [d for d in range(want.dim()) if d != dim % want.dim()]
    err = (got - want).abs().amax(dim=other)
    allow = rel * want.abs().amax(dim=other)
    bad = ~(err <= allow)
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise RuntimeError(f"{name}: row {i} max|Δ| {float(err[i])} > "
                           f"{float(allow[i])} ({rel}·max|want|)")
    return float(err.max()), float(allow.max())


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_blocks", type=int, nargs="?", default=DEFAULT_BLOCKS,
                   help="blocks of 128 entries × a 16×16 tile")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B = args.n_blocks
    pay = make_payload(B, dev)
    g0 = torch.zeros((NDF, NPIX), dtype=torch.float32, device=dev)
    clock = clock_name(dev)
    # On the CPU both sides are the plain version, timed on the host clock
    # only to show the script runs.
    reps = 20 if dev.type == "cuda" else 2
    print(f"exp_mxu: B={B} blocks of {BLOCK}x{NPIX} pairs on {dev} "
          f"({device_name(dev)})", flush=True)
    records = []
    for variant, precision in RUNS:
        kw = {"g_rows": g0} if variant == "dfeat_nt" else {}
        kernel = lambda: pair_block_probe(pay, variant, precision, **kw)
        plain = lambda: pair_block_probe_plain(pay, variant, precision,
                                               **kw)
        before = _build.launch_counts["mxu_probe"]
        got = kernel()
        ms = time_ms(kernel, dev, reps)
        launches = _build.launch_counts["mxu_probe"] - before
        want = plain()
        err, budget = held_rows(f"{variant} ({precision})", got, want,
                                REL_BUDGET, 0)
        rec = {"variant": variant, "precision": precision,
               "ms": ms, "launches": launches,
               "plain_ms": time_ms(plain, dev, min(reps, 3)),
               "max_abs_err": err, "budget": budget,
               **work.probe_bound(variant, precision, B)}
        records.append(rec)
        print(f"{variant:12s} ({precision}): {rec['ms']:8.4f} ms ({clock}); "
              f"plain {rec['plain_ms']:.4f} ms; max|Δ| {err:.3e} (budget "
              f"{budget:.3e}); bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
