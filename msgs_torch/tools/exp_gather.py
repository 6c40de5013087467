"""Payload row-gather strategies: the port of tools/exp_gather.py.

    python -m msgs_torch.tools.exp_gather [N] [E] [--device cpu]

The same inputs (numpy `default_rng(0)`: an (N+1, 16) float32 normal table,
the same table padded to a multiple of 8 rows, E int32 ids in [0, N)) and
the same variant names as the JAX script, which keeps the table in a TPU
core's VMEM. Here each Pallas variant is the CUDA gather kernel
(msgs_torch/kernels/gather.py:gather_rows) in that variant's layouts:

  xla_row_gather            table[gid], the PyTorch index (the yardstick)
  pallas_vmem_take_sublane  row table (padded), entry-major (E, F) out
  pallas_vmem_take_lane     feature table (F, N+1), feature-major (F, E)
  pallas_vmem_take_lane_T   feature table, entry-major (E, F)
  pallas_lane_plus_xla_T    feature-major kernel, then `.t().contiguous()`
  sort_3payload             torch.sort of the ids carrying 3 payload
                            columns (a reference point, not a gather)

Every gather variant, and its plain version (gather_rows_plain in the same
layouts), must equal table[gid] in its layout bit for bit, over the whole
output; a mismatch raises. Times are medians of 20 calls after a warm-up:
CUDA events on the card, the host clock on the CPU. `main` returns
{variant: {"ms", "max_abs_err", "plain_ms", "bytes"}}: max|Δ| to table[gid]
(0; None for the sort), the plain version's ms (None for the yardstick and
the sort) and the least bytes the gather moves (tools.gather_bytes).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.kernels.gather import gather_rows, gather_rows_plain
from msgs_torch.tools import (clock_name, device_name, gather_bytes,
                               held_exact, parse_args, time_ms)

F = 16   # table width of the JAX script (lane-friendly there)


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__.splitlines()[0])
    dev = resolve_device(args.device)
    N, E = args.N, args.E
    rng = np.random.default_rng(0)
    table_np = rng.normal(size=(N + 1, F)).astype(np.float32)
    npad = (-(N + 1)) % 8
    table = torch.as_tensor(table_np, device=dev)
    table_p = torch.as_tensor(np.pad(table_np, ((0, npad), (0, 0))),
                              device=dev)
    table_t = torch.as_tensor(table_np.T.copy(), device=dev)   # (F, N+1)
    gid = torch.as_tensor(rng.integers(0, N, E).astype(np.int32), device=dev)
    ref = table[gid.long()]
    clock = clock_name(dev)
    print(f"exp_gather: N={N} E={E} F={F} on {dev} "
          f"({device_name(dev)})", flush=True)

    results = {}
    nbytes = gather_bytes(gid, F)

    def variant(name, fn, want, plain=None):
        held_exact(name, fn(), want)
        r = {"ms": time_ms(fn, dev), "max_abs_err": 0.0, "plain_ms": None,
             "bytes": nbytes}
        if plain is not None:
            held_exact(f"{name} (plain version)", plain(), want)
            r["plain_ms"] = time_ms(plain, dev)
        results[name] = r
        print(f"{name}: {r['ms']:.4f} ms ({clock}); match: True", flush=True)

    def lane_T(gather):
        return lambda: gather(table_t, gid, "features",
                              "feature").t().contiguous()

    variant("xla_row_gather", lambda: table[gid], ref)
    variant("pallas_vmem_take_sublane", lambda: gather_rows(table_p, gid),
            ref, lambda: gather_rows_plain(table_p, gid))
    variant("pallas_vmem_take_lane",
            lambda: gather_rows(table_t, gid, "features", "feature"), ref.t(),
            lambda: gather_rows_plain(table_t, gid, "features", "feature"))
    variant("pallas_vmem_take_lane_T",
            lambda: gather_rows(table_t, gid, "features", "entry"), ref,
            lambda: gather_rows_plain(table_t, gid, "features", "entry"))
    variant("pallas_lane_plus_xla_T", lane_T(gather_rows), ref,
            lane_T(gather_rows_plain))

    # What the VJP's sort pays per payload operand, for comparison.
    pay = ref[:, :3].contiguous()
    ms = time_ms(lambda: pay[torch.sort(gid).indices], dev)
    results["sort_3payload"] = {"ms": ms, "max_abs_err": None,
                                "plain_ms": None, "bytes": None}
    print(f"sort_3payload: {ms:.4f} ms ({clock})", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
