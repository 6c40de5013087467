"""Payload row-gather strategies, second harness: the port of
tools/exp_gather2.py.

    python -m msgs_torch.tools.exp_gather2 [N] [E] [--device cpu]

The same inputs as the JAX script (numpy `default_rng(0)`: an (N+1, 16)
float32 normal table padded to a multiple of 8 rows, its (16, TP)
transpose, E int32 ids in [0, N)) and the same variants and output shapes;
E must be a multiple of BLK = 2048. Each Pallas variant is the CUDA gather
kernel (msgs_torch/kernels/gather.py:gather_rows):

  xla_row_gather            table_p[gid], the PyTorch index (the yardstick)
  pallas_vmem_take_sublane  row table, entry-major, viewed as the JAX
                            script's (E/BLK, 8, BLK/8, F)
  pallas_vmem_take_lane     feature table, blocked feature-major
                            (E/BLK, F, BLK), viewed as (E/BLK, F, 8, BLK/8)
  sort_1payload             torch.sort of the ids carrying one payload
                            column (a reference point, not a gather)

The JAX script's (8, BLK/8) id blocks exist for the TPU's tiling; here ids
are flat and only the output layouts are kept. Every gather variant, and
its plain version (gather_rows_plain in the same layouts), must equal
table_p[gid] bit for bit over the whole output; a mismatch raises. `main`
returns {variant: {"ms", "max_abs_err", "plain_ms", "bytes"}} as
exp_gather does.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.kernels.gather import gather_rows, gather_rows_plain
from msgs_torch.tools import (clock_name, device_name, gather_bytes,
                               held_exact, parse_args, time_ms)

F = 16
BLK = 2048


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__.splitlines()[0])
    dev = resolve_device(args.device)
    N, E = args.N, args.E
    if E % BLK != 0:
        raise ValueError(f"exp_gather2: E ({E}) must be a multiple of {BLK}")
    rng = np.random.default_rng(0)
    table_np = rng.normal(size=(N + 1, F)).astype(np.float32)
    npad = (-(N + 1)) % 8
    table_p_np = np.pad(table_np, ((0, npad), (0, 0)))
    table_p = torch.as_tensor(table_p_np, device=dev)              # (TP, F)
    table_t = torch.as_tensor(table_p_np.T.copy(), device=dev)     # (F, TP)
    gid = torch.as_tensor(rng.integers(0, N, E).astype(np.int32), device=dev)
    ref = table_p[gid.long()]
    clock = clock_name(dev)
    print(f"exp_gather2: N={N} E={E} F={F} BLK={BLK} on {dev} "
          f"({device_name(dev)})", flush=True)

    results = {}
    nbytes = gather_bytes(gid, F)

    def variant(name, fn, as_entry_major, plain=None):
        held_exact(name, as_entry_major(fn()), ref)
        r = {"ms": time_ms(fn, dev), "max_abs_err": 0.0, "plain_ms": None,
             "bytes": nbytes}
        if plain is not None:
            held_exact(f"{name} (plain version)", as_entry_major(plain()),
                       ref)
            r["plain_ms"] = time_ms(plain, dev)
        results[name] = r
        print(f"{name}: {r['ms']:.4f} ms ({clock}); match: True", flush=True)

    def sublane(gather):
        return lambda: gather(table_p, gid).reshape(E // BLK, 8, BLK // 8, F)

    def lane(gather):
        return lambda: gather(table_t, gid, "features", "blocked",
                              block=BLK).reshape(E // BLK, F, 8, BLK // 8)

    variant("xla_row_gather", lambda: table_p[gid], lambda r: r)
    variant("pallas_vmem_take_sublane", sublane(gather_rows),
            lambda r: r.reshape(E, F), sublane(gather_rows_plain))
    variant("pallas_vmem_take_lane", lane(gather_rows),
            lambda r: r.permute(0, 2, 3, 1).reshape(E, F),
            lane(gather_rows_plain))

    col = ref[:, 0].contiguous()
    ms = time_ms(lambda: col[torch.sort(gid).indices], dev)
    results["sort_1payload"] = {"ms": ms, "max_abs_err": None,
                                "plain_ms": None, "bytes": None}
    print(f"sort_1payload: {ms:.4f} ms ({clock})", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
