"""Row gather `table[gid]` in three output layouts: the CUDA gather kernel
and its plain version.

Port of the Pallas row gathers of the experiment scripts
(tools/exp_gather.py, tools/exp_gather2.py), which write one function in
several memory layouts. The table is row-major (rows, F) or feature-major
(F, rows); the output is entry-major (E, F), feature-major (F, E) or
blocked feature-major (E/B, F, B) with `out[e // B, f, e % B] =
table[gid[e], f]`. The kernel is msgs_torch/csrc/gather.cu; a gather is
exact, so it equals the plain version bit for bit. A feature table takes two
launches: a transpose into a row-major workspace made for the call, then
the gather (both counted in `launch_counts["gather_rows"]`).

The render path's payload gather (kernels/rasterize.py:_GatherPayload)
stays a `torch` row index, as the JAX package's stays XLA's.
"""
from __future__ import annotations

import torch

from msgs_torch.kernels import _build

TABLE_LAYOUTS = ("rows", "features")
OUT_LAYOUTS = ("entry", "feature", "blocked")
# The kernel's instances, by the index of msgs_gather_rows_info: the
# transpose of a feature table, then the gathers from a row table with F/4
# float4s a row (3, 4, or any), entry-major or blocked (through a shared
# tile where the block is a multiple of 4, else with scalar stores).
GATHER_INSTANCES = ("transpose", "entry Q=3", "entry Q=4", "entry Q=any",
                    "blocked Q=3 tile", "blocked Q=4 tile",
                    "blocked Q=any tile", "blocked Q=3 scalar",
                    "blocked Q=4 scalar", "blocked Q=any scalar")


def _check(table, gid, table_layout, out_layout, block):
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(f"gather_rows: table must be a 2-D float32 tensor, "
                        f"not {table.dtype} of shape {tuple(table.shape)}")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"gather_rows: gid must be a 1-D int32 tensor, not "
                        f"{gid.dtype} of shape {tuple(gid.shape)}")
    if gid.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device}, gid on "
                         f"{gid.device}")
    if table_layout not in TABLE_LAYOUTS:
        raise ValueError(f"gather_rows: table_layout {table_layout!r} not in "
                         f"{TABLE_LAYOUTS}")
    if out_layout not in OUT_LAYOUTS:
        raise ValueError(f"gather_rows: out_layout {out_layout!r} not in "
                         f"{OUT_LAYOUTS}")
    E = gid.shape[0]
    if out_layout == "blocked":
        if block is None or block <= 0 or E % block != 0:
            raise ValueError(f"gather_rows: the blocked layout needs a block "
                             f"that divides E = {E}, not {block}")
    elif block is not None:
        raise ValueError(f"gather_rows: block is for the blocked layout, "
                         f"not {out_layout!r}")


def gather_rows_plain(table: torch.Tensor, gid: torch.Tensor,
                      table_layout: str = "rows", out_layout: str = "entry",
                      block: int | None = None) -> torch.Tensor:
    """Plain version: `table[gid]` or `table[:, gid]`, then the output
    layout's reshape and permute."""
    idx = gid.long()
    rows = table[idx] if table_layout == "rows" else table[:, idx].t()
    if out_layout == "entry":
        return rows.contiguous()
    if out_layout == "feature":
        return rows.t().contiguous()
    E, F = rows.shape
    return rows.reshape(E // block, block, F).permute(0, 2, 1).contiguous()


def _gather_cuda(table, gid, table_layout, out_layout, block):
    if not (table.is_contiguous() and gid.is_contiguous()):
        raise ValueError("gather_rows: table and gid must be contiguous")
    n_rows, F = table.shape if table_layout == "rows" else table.shape[::-1]
    if F % 4 != 0 or table.data_ptr() % 16 != 0:
        raise ValueError(f"gather_rows: the kernel reads float4s: F ({F}) "
                         f"must be a multiple of 4 and the table 16-byte "
                         f"aligned")
    E = gid.shape[0]
    # The kernel's `block`: 0 for entry-major, E for feature-major.
    if out_layout == "entry":
        shape, b = (E, F), 0
    elif out_layout == "feature":
        shape, b = (F, E), E
    else:
        shape, b = (E // block, F, block), block
    out = torch.empty(shape, dtype=torch.float32, device=table.device)
    if E == 0:
        return out
    # A feature table is transposed into this row-major scratch first.
    feat = table_layout == "features"
    work = torch.empty((n_rows, F), dtype=torch.float32,
                       device=table.device) if feat else None
    lib = _build.load()
    err = lib.msgs_gather_rows(table.data_ptr(), gid.data_ptr(),
                               out.data_ptr(),
                               work.data_ptr() if feat else None, n_rows, F,
                               E, int(feat), b, _build.stream_ptr(table))
    _build.check(err, "gather_rows")
    _build.launch_counts["gather_rows"] += 2 if feat else 1
    return out


def gather_rows(table: torch.Tensor, gid: torch.Tensor,
                table_layout: str = "rows", out_layout: str = "entry",
                block: int | None = None) -> torch.Tensor:
    """Rows `gid` (int32, (E,)) of a float32 table, row-major (rows, F) for
    table_layout="rows" or feature-major (F, rows) for "features", written
    entry-major (E, F), feature-major (F, E) or, for "blocked", as
    (E/block, F, block). A CUDA tensor goes through the CUDA kernel, a CPU
    tensor through the plain version. Ids lie in [0, rows)."""
    _check(table, gid, table_layout, out_layout, block)
    if table.device.type == "cuda":
        return _gather_cuda(table, gid, table_layout, out_layout, block)
    if table.device.type == "cpu":
        return gather_rows_plain(table, gid, table_layout, out_layout, block)
    raise ValueError(f"gather_rows: unsupported device {table.device}")
