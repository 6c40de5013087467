"""The compositor with single pieces switched off: the CUDA kernels of the
ablation tool and their plain versions.

Port of the two Pallas kernels of tools/exp_fwd_ablate.py: `fwd_kernel_var`
(:97, called at :216) and `bwd_var` (:268, called at :428), which run the
real compositor forward (msgs/kernels/composite.py:_fwd_kernel) and backward
(_bwd_kernel, image-only) with one piece removed, to find where their time
goes. Both walk the payload stream in grid order: block b holds subs
4b..4b+3, a grid step holds 8 blocks, and a running state (zero at the
start) lives in scratch between blocks.

The stream is binning's (msgs_torch/kernels/binning.py): a block computes
when its first sub is valid, and those blocks are a prefix of the stream;
`sub_tile` is nondecreasing over the whole stream (the invalid subs after
the valid ones carry the last valid tile). A run is a maximal group of
consecutive subs of one tile inside the computed blocks. Per sub the
arithmetic is that of composite_fwd.cu / composite_bwd.cu (α in tile-local
offsets, each sub chained from the transmittance T and done flag the
previous sub left), so `fwd_ablate(..., "full")` at a tile's last sub is
kernel 3's output bit for bit, and the colour columns of
`bwd_ablate(..., "full")` are kernel 4's.

Block rules, as the TPU kernels apply them:
  skip      a block all of whose subs continue the tile of the sub before
            it, when that tile is saturated (all 256 pixels done). The
            forward then dumps the state (it is unchanged) instead of
            computing; the backward writes zero rows.
  carried   a sub of a block after its run's first block. A variant that
            advances the state continues the run's T, done and wφ prefix
            there; one that does not (forward `no_states`, backward
            `geom_nostore`, `geom_concat`, `no_geom`, `recompute_only`)
            reads the never-written zero state, T = done = prefix = 0, so
            the rest of the run contributes nothing. Inside a block, runs
            still chain sub to sub.

Forward variants, output (4·B, 8, 256) state slots (rows r g b depth acc T
done pad), or (B/8, 8, 256) for small_out:
  full          every sub's slot holds the tile state after that sub
  dump_last     slot 4b holds the state after sub 4b+3; a skipped block
                dumps all four slots
  no_dump       writes no slot
  small_out     slot s holds the state after the last computed block of
                grid step s
  no_states     slot 4b: rows 0-4 the running sum, over every computed
                block of the stream, of the block's colour sums (no
                per-sub state chain across blocks)
  pairs_*       α of each of the block's 128 rows at tile-local pixel
                coordinates with no tile origin (absolute means):
                pairs_alpha adds max_rows α to row 0; pairs_noscan adds
                Σ_rows feat[6+c]·α to rows 0-4; pairs_noaccs adds max_rows
                w, pairs_only Σ_rows feat[6+c]·w, with w = α·T_excl·[T ≥
                1e-4] and T the product of (1 − α) within each 32-row sub.
                Slot 4b holds the running state.
Slots a variant does not write are not part of its function: the wrappers
return a mask of the written ones and leave the others as the caller
allocated them (zeros by default).

Backward variants, dpay (B, 128, 12) from `cst` (tiles, 8, 256), the rows
[g_r, g_g, g_b, g_depth, g_acc, total_phi, T_final·g_T, 0] read at each
sub's tile (tools/exp_fwd_ablate.py:257-264), colour terms r g b only:
  full          d{mean2D, conic, opacity} from the six moments Σ_p
                bf16(dpower)·[x², xy, y², x, y, 1] (the script's shim
                contracts dpower with that basis as a bf16 dot; every
                product is exact in f32), and Σ_p w·g_c in columns 6-8
  geom_nostore  column 0: d_mx + d_my + d_cxx + d_cxy + d_cyy + d_op +
                Σ_c dfeat_c
  geom_concat   columns 0-8 as full
  no_geom       column 0: Σ_p dpower (f32); columns 6-8 as full
  no_prefix     full, with the wφ prefix replaced by w·φ of the row
  recompute_only  column 0: Σ_p w
Unwritten columns are 0.

The later experiments, tools/exp_bwd2.py and tools/exp_bwd3.py, over the
same grid and state:
  horner        (fwd_ablate, HORNER_VARIANTS; exp_bwd2.py:92
                `fwd_horner_kernel`) pairs_only with the power from
                per-entry Horner coefficients, in the script's order
                (:112-120): a = −½cxx, b = −cxy, c = −½cyy, d = cxx·mx +
                cxy·my, e = cyy·my + cxy·mx, f0 = −½(cxx·mx·mx + cyy·my·my)
                − cxy·mx·my, u = a·x + d, v = c·y + e, power = (u + b·y)·x
                + v·y + f0, at tile-local pixels with absolute means. With
                means ~10³ pixels from the origin the form cancels (f0 ≈
                −½cxx·mx²); that rounding is part of its function.
  backward forms  (bwd_ablate's `full` with `form`; exp_bwd2.py:177
                `bwd_kernel_var`, exp_bwd3.py:101 `bwd_kernel`) bwd/full's
                function with other moments, on five axes (BwdForm):
                moments `dot_bf16` (bwd/full's), `dot_f32` or `vpu`;
                constants `gathered` (each sub reads cst at its tile) or
                `dense` (the caller gathers cst[sub_tile] into one (4·B, 8,
                256) buffer, dense_cst, and sub j reads row j); group 8 or
                16 (the grid covers (B // group)·group blocks; later blocks
                are not computed); store `columns` (nine column stores) or
                `row` (one 48-byte row store); zeroing `caller` (the caller
                zeroes dpay, live rows are written) or `kernel` (every row
                of the covered blocks is written once, zeros included).
                BWD2_RUNS and BWD3_RUNS name the scripts' runs. exp_bwd3's
                nogrows (the TPU kernel's implicit broadcast of the per-sub
                constants) has no axis: a thread per pixel holds them in
                registers in every form, so nogrows is colstore's form.
The moments. `vpu` forms dp_x = dpower·x and dp_y = dpower·y and sums
dp_x·x, dp_x·y, dp_y·y, dp_x, dp_y and dpower (exp_bwd2.py:239-251), which
is kernel 4's arithmetic (composite_bwd.cu). `dot_f32` is `comp._dot(
d_power, comp._local_basis_t())` (exp_bwd2.py:186, :253), two helpers
msgs/kernels/composite.py no longer has: its comment at :641-646 says the
r3 design contracted d_power with a static (NPIX, 8) basis on the MXU
under the package's HIGHEST default, a 6-pass f32 product. So `dot_f32`
sums dpower·m for m in the raw monomials [x², xy, y², x, y, 1] (each
exact in f32: tools/exp_fwd_ablate.py:242-254's basis), each product
rounded once.

Every sum over a sub's 32 rows runs in row order, and every sum over a
tile's 256 pixels in the kernels' order: a pairwise tree over each warp's
32 lanes (lane l with l + 16, then + 8, + 4, + 2, + 1), then the 8 warps
in order. So the kernels, built with -fmad=false, equal their plain
versions bit for bit (up to the sign of a zero). The kernels are
msgs_torch/csrc/fwd_ablate.cu and msgs_torch/csrc/bwd_ablate.cu.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msgs_torch.kernels import _build
from msgs_torch.kernels.binning import BLOCK, SUB
from msgs_torch.kernels.composite import (F_R, NFEAT, NOUT, NPIX, O_DONE,
                                          O_T, _local_pix, _sub_forward)
from msgs_torch.kernels.preprocess import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE

NSUB = BLOCK // SUB          # subs per block
GROUP = 8                    # blocks per grid step
NACC = 5                     # accumulated rows r g b depth acc
NPHI = 3                     # colour terms of the image-only backward
FWD_VARIANTS = ("full", "dump_last", "no_dump", "no_states", "pairs_only",
                "pairs_noaccs", "pairs_noscan", "pairs_alpha", "small_out")
BWD_VARIANTS = ("full", "geom_nostore", "geom_concat", "no_geom",
                "no_prefix", "recompute_only")
TILE_VARIANTS = ("full", "dump_last", "no_dump", "small_out")
HORNER_VARIANTS = ("horner",)
ALL_FWD = FWD_VARIANTS + HORNER_VARIANTS   # fwd_ablate.cu's order
# Backward variants that advance the (T, done, prefix) state.
ADVANCING = ("full", "no_prefix")


# bwd_ablate.cu's moment forms, in order.
MOMENTS = ("dot_bf16", "dot_f32", "vpu")


class BwdForm(NamedTuple):
    """A form of the `full` backward (see the module docstring); the
    default is bwd/full's, the only one the other variants take."""
    moments: str = "dot_bf16"       # dot_bf16 | dot_f32 | vpu
    constants: str = "gathered"     # gathered | dense
    group: int = 8                  # 8 | 16
    store: str = "columns"          # columns | row
    zeroing: str = "caller"         # caller | kernel


# The scripts' runs, in their order (exp_bwd2.py:341-348, exp_bwd3.py:
# 271-279).
BWD2_RUNS = {
    "geom_vpu": BwdForm("vpu"),
    "cst_dense": BwdForm("dot_f32", constants="dense"),
    "geom_vpu+cst_dense": BwdForm("vpu", constants="dense"),
    "g16": BwdForm("dot_f32", group=16),
}
BWD3_RUNS = {
    "colstore": BwdForm("vpu"),
    "catstore": BwdForm("vpu", store="row"),
    "nozero": BwdForm("vpu", zeroing="kernel"),
    "nogrows": BwdForm("vpu"),
    "all": BwdForm("vpu", store="row", zeroing="kernel"),
}
_AXES = {"moments": MOMENTS, "constants": ("gathered", "dense"),
         "group": (8, 16), "store": ("columns", "row"),
         "zeroing": ("caller", "kernel")}
# The instances csrc/bwd_ablate.cu builds, in its order (the `instance` of
# msgs_bwd_ablate and msgs_bwd_ablate_info): bwd/full's form and the forms
# the scripts' runs take (group is not a kernel parameter), then the other
# variants in the default form.
BWD_INSTANCES = (
    ("full", BwdForm()), ("full", BwdForm("vpu")),
    ("full", BwdForm("dot_f32", constants="dense")),
    ("full", BwdForm("vpu", constants="dense")),
    ("full", BwdForm("dot_f32")), ("full", BwdForm("vpu", store="row")),
    ("full", BwdForm("vpu", zeroing="kernel")),
    ("full", BwdForm("vpu", store="row", zeroing="kernel")),
    *((v, BwdForm()) for v in BWD_VARIANTS[1:]))
BUILT_FORMS = {f for v, f in BWD_INSTANCES if v == "full"}
# Blocks per chunk of the plain versions' block-wise passes: bounds their
# (chunk, 128, 256) intermediates. Blocks are independent there, so the
# chunking changes no value.
PLAIN_CHUNK = 1024


def _check(payload, sub_tile, sub_valid, variant, variants, what):
    if variant not in variants:
        raise ValueError(f"{what}: variant {variant!r} not in {variants}")
    if (payload.dtype != torch.float32 or payload.dim() != 3
            or tuple(payload.shape[1:]) != (BLOCK, NFEAT)):
        raise TypeError(f"{what}: payload must be a (B, {BLOCK}, {NFEAT}) "
                        f"float32 tensor, not {payload.dtype} of shape "
                        f"{tuple(payload.shape)}")
    B = payload.shape[0]
    if B == 0 or B % GROUP:
        raise ValueError(f"{what}: {B} blocks; the grid takes whole steps "
                         f"of {GROUP}")
    for name, x in (("sub_tile", sub_tile), ("sub_valid", sub_valid)):
        if x.dtype != torch.int32 or tuple(x.shape) != (B * NSUB,):
            raise TypeError(f"{what}: {name} must be int32 ({B * NSUB},), "
                            f"not {x.dtype} of shape {tuple(x.shape)}")
        if x.device != payload.device:
            raise ValueError(f"{what}: payload on {payload.device}, {name} "
                             f"on {x.device}")


def _n_compute(sub_tile, sub_valid) -> int:
    """Blocks that compute (first sub valid); raises unless they are a
    prefix of the stream and sub_tile is nondecreasing."""
    comp = sub_valid[::NSUB] == 1
    nb = int(comp.sum())
    if bool(comp[nb:].any()) or bool((sub_tile[1:] < sub_tile[:-1]).any()):
        raise ValueError("ablate: the computed blocks must be a prefix of "
                         "the stream and sub_tile nondecreasing (binning's "
                         "order)")
    return nb


def _seq_sum(terms):
    """Left-to-right sum of an iterable of tensors, from its first term."""
    it = iter(terms)
    acc = next(it)
    for t in it:
        acc = acc + t
    return acc


def pixel_tree_sum(x):
    """Σ over the last dim (256 pixels) in the kernels' order: a pairwise
    tree over each warp's 32 lanes, then the 8 warps in order."""
    y = x.reshape(x.shape[:-1] + (NPIX // 32, 32))
    h = 16
    while h:
        y = y[..., :h] + y[..., h:2 * h]
        h //= 2
    return _seq_sum(y[..., w, 0] for w in range(NPIX // 32))


def _bf16(x):
    """Round f32 → bf16 (round to nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _outside(tile, tiles_x: int, width: int, height: int):
    """(A, NPIX) 1.0 where the pixel of the tile lies off the image."""
    pxl, pyl = _local_pix(tile.device)
    ox = (tile % tiles_x).to(torch.float32)[:, None] * TILE
    oy = (tile // tiles_x).to(torch.float32)[:, None] * TILE
    return (((pxl + ox) >= width) | ((pyl + oy) >= height)).to(torch.float32)


def _runs(sub_tile, nb: int):
    """Runs of the computed subs: (start, length, tile), int64 tensors, in
    decreasing length (each depth's active runs are a prefix)."""
    st = sub_tile[:nb * NSUB]
    S = st.shape[0]
    head = torch.ones(S, dtype=torch.bool, device=st.device)
    head[1:] = st[1:] != st[:-1]
    start = head.nonzero()[:, 0]
    length = torch.diff(start, append=start.new_tensor([S]))
    order = torch.argsort(length, descending=True, stable=True)
    return start[order], length[order], st[start[order]].long()


def _active_counts(length) -> list:
    """Runs longer than d, for each depth d (length in decreasing order)."""
    depth = int(length[0]) if length.numel() else 0
    return torch.searchsorted(-length.cpu(), -torch.arange(depth)).tolist()


def _sub_step(feats, j, tile, t_in, done, tiles_x: int):
    """One sub of each active run: sub = _sub_forward's recompute, with
    feats (S, 32, NFEAT), j (A,) sub indices, t_in and done (A, NPIX)."""
    ox = (tile % tiles_x).to(torch.float32) * TILE
    oy = (tile // tiles_x).to(torch.float32) * TILE
    return _sub_forward(feats[j], ox, oy, t_in[:, None], done[:, None])


def _sub_colour_sums(feat, w):
    """(A, 5, NPIX): Σ over the sub's 32 rows of feat[6 + c]·w, in row
    order."""
    return _seq_sum(feat[:, i, F_R:F_R + NACC, None] * w[:, i, None, :]
                    for i in range(SUB))


def _advance(sub, t_in, done):
    """T and done after the sub: (A, NPIX) each."""
    t_new = torch.where(sub.alive > 0.0, sub.t_after,
                        t_in[:, None]).amin(dim=1)
    done_new = torch.maximum(done,
                             (sub.t_after[:, -1] < T_EPS).to(torch.float32))
    return t_new, done_new


def _tile_states(payload, sub_tile, nb: int, tiles_x: int, width: int,
                 height: int):
    """The tile state after each computed sub, (4·nb, NOUT, NPIX), every
    run starting from r g b depth acc = 0, T = 1, done = off-image."""
    dev = payload.device
    feats = payload.reshape(-1, SUB, NFEAT)
    S = nb * NSUB
    states = torch.zeros((S, NOUT, NPIX), dtype=torch.float32, device=dev)
    start, length, tile = _runs(sub_tile, nb)
    acc = torch.zeros((start.shape[0], NACC, NPIX), dtype=torch.float32,
                      device=dev)
    t_run = torch.ones((start.shape[0], NPIX), dtype=torch.float32,
                       device=dev)
    done_run = _outside(tile, tiles_x, width, height)
    for d, n in enumerate(_active_counts(length)):
        j = start[:n] + d
        t_in, done = t_run[:n], done_run[:n]
        sub = _sub_step(feats, j, tile[:n], t_in, done, tiles_x)
        acc[:n] = acc[:n] + _sub_colour_sums(feats[j], sub.w)
        t_run[:n], done_run[:n] = _advance(sub, t_in, done)
        states[j, :NACC] = acc[:n]
        states[j, O_T] = t_run[:n]
        states[j, O_DONE] = done_run[:n]
    return states


def _skipped(sub_tile, states, nb: int):
    """(nb,) bool: block b continues the tile of sub 4b − 1 in all its subs
    and that tile is saturated after it."""
    st = sub_tile[:nb * NSUB].reshape(nb, NSUB)
    skip = torch.zeros(nb, dtype=torch.bool, device=sub_tile.device)
    if nb > 1:
        prev = st[:-1, -1]
        sat = states[NSUB - 1:nb * NSUB - 1:NSUB, O_DONE].sum(-1) >= NPIX
        skip[1:] = (st[1:] == prev[:, None]).all(1) & sat
    return skip


def skipped_blocks(sub_tile, sub_valid, states):
    """(nb,) bool over the computed blocks: those the TPU kernels skip,
    from the forward's `full` state slots."""
    return _skipped(sub_tile, states, _n_compute(sub_tile, sub_valid))


def _fwd_tile_plain(payload, sub_tile, nb, variant, tiles_x, width, height,
                    out, written):
    states = _tile_states(payload, sub_tile, nb, tiles_x, width, height)
    if variant == "no_dump" or nb == 0:
        return
    skip = _skipped(sub_tile, states, nb)
    if variant == "full":
        out[:nb * NSUB] = states
        written[:nb * NSUB] = True
    elif variant == "dump_last":
        last = states[NSUB - 1::NSUB]                     # (nb, 8, 256)
        out[:nb * NSUB:NSUB] = last
        written[:nb * NSUB:NSUB] = True
        js = (skip.nonzero()[:, 0, None] * NSUB
              + torch.arange(NSUB, device=skip.device)).reshape(-1)
        out[js] = states[js]
        written[js] = True
    else:                                                 # small_out
        steps = -(-nb // GROUP)
        b_last = torch.clamp(torch.arange(steps, device=payload.device)
                             * GROUP + GROUP - 1, max=nb - 1)
        out[:steps] = states[b_last * NSUB + NSUB - 1]
        written[:steps] = True


def _pair_alpha(feat):
    """α of the pairs variants: (b, 128, NPIX) at tile-local pixel
    coordinates with no tile origin."""
    pxl, pyl = _local_pix(feat.device)
    dx = pxl - feat[..., 0, None]
    dy = pyl - feat[..., 1, None]
    cxx, cxy, cyy = (feat[..., c, None] for c in (2, 3, 4))
    power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
    alpha_raw = feat[..., 5, None] * torch.exp(power)
    mask = (alpha_raw >= ALPHA_MIN) & (power <= 0.0)
    return torch.where(mask, torch.clamp(alpha_raw, max=ALPHA_MAX), 0.0)


def _horner_alpha(feat):
    """α of horner: _pair_alpha's with the power from per-entry Horner
    coefficients, operation for operation as tools/exp_bwd2.py:112-120."""
    pxl, pyl = _local_pix(feat.device)
    mx, my = feat[..., 0, None], feat[..., 1, None]
    cxx, cxy, cyy = (feat[..., c, None] for c in (2, 3, 4))
    a = -0.5 * cxx
    bq = -cxy
    c = -0.5 * cyy
    d = cxx * mx + cxy * my
    e = cyy * my + cxy * mx
    f0 = -0.5 * (cxx * mx * mx + cyy * my * my) - cxy * mx * my
    u = a * pxl + d
    v = c * pyl + e
    power = (u + bq * pyl) * pxl + v * pyl + f0
    alpha_raw = feat[..., 5, None] * torch.exp(power)
    mask = (alpha_raw >= ALPHA_MIN) & (power <= 0.0)
    return torch.where(mask, torch.clamp(alpha_raw, max=ALPHA_MAX), 0.0)


def _pairs_partials(feat, variant):
    """(b, 5, NPIX) per-block terms of a pairs variant or horner (rows past
    the variant's are 0)."""
    alpha = _horner_alpha(feat) if variant == "horner" else _pair_alpha(feat)
    part = torch.zeros((feat.shape[0], NACC, NPIX), dtype=torch.float32,
                       device=feat.device)
    if variant == "pairs_alpha":
        part[:, 0] = alpha.amax(dim=1)
        return part
    if variant == "pairs_noscan":
        w = alpha
    else:
        b = feat.shape[0]
        cum = (1.0 - alpha).reshape(b, NSUB, SUB, NPIX)
        k = 1
        while k < SUB:
            cum = torch.cat([cum[:, :, :k], cum[:, :, k:] * cum[:, :, :-k]],
                            dim=2)
            k *= 2
        excl = torch.cat([torch.ones_like(cum[:, :, :1]), cum[:, :, :-1]],
                         dim=2)
        alive = (cum >= T_EPS).to(torch.float32)
        w = alpha * excl.reshape(b, BLOCK, NPIX) * alive.reshape(b, BLOCK,
                                                                 NPIX)
    if variant == "pairs_noaccs":
        part[:, 0] = w.amax(dim=1)
        return part
    part[:] = _seq_sum(feat[:, i, F_R:F_R + NACC, None] * w[:, i, None, :]
                       for i in range(BLOCK))
    return part


def _no_states_partials(payload, sub_tile, nb: int, tiles_x: int,
                        width: int, height: int):
    """(nb, 5, NPIX): per computed block, ((a0 + a1) + a2) + a3 of its
    subs' colour sums, runs chained inside the block only (a sub that
    continues the tile of the block's previous sub starts from T = done =
    0 and adds 0)."""
    dev = payload.device
    feats = payload.reshape(-1, SUB, NFEAT)
    st = sub_tile.long()
    b = torch.arange(nb, device=dev)
    prev = st[torch.clamp(b * NSUB - 1, min=0)]
    part = None
    t_run = done_run = None
    for k in range(NSUB):
        j = b * NSUB + k
        tile = st[j]
        carried = (b > 0) & (tile == prev)
        fresh = ~carried
        if k:
            fresh &= tile != st[j - 1]
        t_in = torch.where(fresh[:, None], 1.0,
                           t_run if k else torch.zeros((nb, NPIX),
                                                       device=dev))
        done = torch.where(fresh[:, None],
                           _outside(tile, tiles_x, width, height),
                           done_run if k else torch.zeros((nb, NPIX),
                                                          device=dev))
        sub = _sub_step(feats, j, tile, t_in, done, tiles_x)
        a = _sub_colour_sums(feats[j], sub.w)
        part = a if part is None else part + a
        t_run, done_run = _advance(sub, t_in, done)
    return part


def _running_sum(out, written, partials):
    """out[4b] rows 0-4 = Σ_{b' ≤ b} partials[b'] in block order."""
    acc = torch.zeros_like(partials[0])
    for b in range(partials.shape[0]):
        acc = acc + partials[b]
        out[b * NSUB, :NACC] = acc
    written[:partials.shape[0] * NSUB:NSUB] = True


def fwd_ablate_plain(payload, sub_tile, sub_valid, variant: str,
                     tiles_x: int, width: int, height: int, out=None):
    """Plain version of fwd_ablate (same arguments and results)."""
    _check(payload, sub_tile, sub_valid, variant, ALL_FWD, "fwd_ablate")
    out = fwd_out(payload, variant, out)
    written = torch.zeros(out.shape[0], dtype=torch.bool,
                          device=payload.device)
    nb = _n_compute(sub_tile, sub_valid)
    if variant in TILE_VARIANTS:
        _fwd_tile_plain(payload, sub_tile, nb, variant, tiles_x, width,
                        height, out, written)
    elif variant == "no_states":
        if nb:
            _running_sum(out, written, _no_states_partials(
                payload, sub_tile, nb, tiles_x, width, height))
    elif nb:
        parts = torch.cat([_pairs_partials(c, variant)
                           for c in payload[:nb].split(PLAIN_CHUNK)])
        _running_sum(out, written, parts)
    return out, written


def fwd_out(payload, variant, out=None):
    """The forward's output: `out` checked, or zeros of its shape."""
    B = payload.shape[0]
    shape = ((B // GROUP if variant == "small_out" else B * NSUB), NOUT,
             NPIX)
    if out is None:
        return torch.zeros(shape, dtype=torch.float32, device=payload.device)
    if (out.dtype != torch.float32 or tuple(out.shape) != shape
            or out.device != payload.device or not out.is_contiguous()):
        raise TypeError(f"fwd_ablate: out must be a contiguous float32 "
                        f"{shape} tensor on {payload.device}")
    return out


def bf16_moments(d_power):
    """The six moments Σ_p bf16(dpower)·[x², xy, y², x, y, 1] in tile-local
    pixel coordinates, (…, 32) each; every product is exact in f32."""
    pxl, pyl = _local_pix(d_power.device)
    dpb = _bf16(d_power)
    return (pixel_tree_sum(dpb * pxl * pxl), pixel_tree_sum(dpb * pxl * pyl),
            pixel_tree_sum(dpb * pyl * pyl), pixel_tree_sum(dpb * pxl),
            pixel_tree_sum(dpb * pyl), pixel_tree_sum(dpb))


def f32_moments(d_power):
    """`dot_f32`: the six moments Σ_p dpower·m, m in [x², xy, y², x, y, 1]
    (each m exact, each product rounded once)."""
    pxl, pyl = _local_pix(d_power.device)
    return (pixel_tree_sum(d_power * (pxl * pxl)),
            pixel_tree_sum(d_power * (pxl * pyl)),
            pixel_tree_sum(d_power * (pyl * pyl)),
            pixel_tree_sum(d_power * pxl), pixel_tree_sum(d_power * pyl),
            pixel_tree_sum(d_power))


def vpu_moments(d_power):
    """`vpu`: the six moments from dp_x = dpower·x and dp_y = dpower·y, as
    tools/exp_bwd2.py:244-251 and kernel 4 form them."""
    pxl, pyl = _local_pix(d_power.device)
    dp_x = d_power * pxl
    dp_y = d_power * pyl
    return (pixel_tree_sum(dp_x * pxl), pixel_tree_sum(dp_x * pyl),
            pixel_tree_sum(dp_y * pyl), pixel_tree_sum(dp_x),
            pixel_tree_sum(dp_y), pixel_tree_sum(d_power))


def _moments(form, d_power):
    if form == "dot_bf16":
        return bf16_moments(d_power)
    return f32_moments(d_power) if form == "dot_f32" else vpu_moments(
        d_power)


def _bwd_sub_rows(variant, feat, sub, t_in, g, sfx, P, moments="dot_bf16"):
    """dpay rows (A, 32, NFEAT) of one sub of each active run and the wφ
    prefix at its last row, in composite_bwd.cu's arithmetic with the
    given moments."""
    w = sub.w
    rows = torch.zeros_like(feat)
    if variant == "recompute_only":
        rows[..., 0] = pixel_tree_sum(w)
        return rows, P
    phi = g[:, None, 0] * feat[..., F_R, None]
    for c in range(1, NPHI):
        phi = phi + g[:, None, c] * feat[..., F_R + c, None]
    wphi = w * phi
    if variant == "no_prefix":
        prefix = wphi
    else:
        k = 1
        loc = wphi
        while k < SUB:
            loc = torch.cat([loc[:, :k], loc[:, k:] + loc[:, :-k]], dim=1)
            k *= 2
        prefix = P[:, None] + loc
    suffix = sfx[:, None] - prefix
    t_i = t_in[:, None] * sub.cum_excl
    d_alpha = (t_i * phi - suffix / (1.0 - sub.alpha)) * sub.alive * \
        sub.mask.to(torch.float32)
    unclamped = (sub.alpha_raw < ALPHA_MAX).to(torch.float32)
    d_power = d_alpha * sub.alpha * unclamped
    dfeat = [pixel_tree_sum(w * g[:, None, c]) for c in range(NPHI)]
    if variant == "no_geom":
        rows[..., 0] = pixel_tree_sum(d_power)
        for c in range(NPHI):
            rows[..., F_R + c] = dfeat[c]
        return rows, prefix[:, -1]
    q20, q11, q02, q10, q01, q00 = _moments(moments, d_power)
    mxl, myl = sub.mxl, sub.myl
    cxx, cxy, cyy = feat[..., 2], feat[..., 3], feat[..., 4]
    op = feat[..., 5]
    d_cxx = -0.5 * (q20 - 2.0 * mxl * q10 + mxl * mxl * q00)
    d_cyy = -0.5 * (q02 - 2.0 * myl * q01 + myl * myl * q00)
    d_cxy = -(q11 - myl * q10 - mxl * q01 + mxl * myl * q00)
    d_mx = cxx * (q10 - mxl * q00) + cxy * (q01 - myl * q00)
    d_my = cyy * (q01 - myl * q00) + cxy * (q10 - mxl * q00)
    d_op = torch.where(op > 0.0, q00 / torch.clamp(op, min=1e-30), 0.0)
    if variant == "geom_nostore":
        rows[..., 0] = (d_mx + d_my + d_cxx + d_cxy + d_cyy + d_op
                        + _seq_sum([torch.zeros_like(dfeat[0])] + dfeat))
        return rows, prefix[:, -1]
    for c, v in enumerate((d_mx, d_my, d_cxx, d_cxy, d_cyy, d_op)):
        rows[..., c] = v
    for c in range(NPHI):
        rows[..., F_R + c] = dfeat[c]
    return rows, (P if variant == "no_prefix" else prefix[:, -1])


def bwd_ablate_plain(payload, sub_tile, sub_valid, cst, variant: str,
                     tiles_x: int, width: int, height: int, out=None,
                     form: BwdForm = BwdForm()):
    """Plain version of bwd_ablate (same arguments and result)."""
    n_cover = _check_bwd(payload, sub_tile, sub_valid, cst, variant, form,
                         n_tiles(tiles_x, height))
    dpay = _bwd_out(payload, out)
    if form.zeroing == "kernel":
        dpay[:n_cover] = 0.0
    nb = min(_n_compute(sub_tile, sub_valid), n_cover)
    _bwd_walk(payload, sub_tile, nb, cst, form.constants == "dense", variant,
              form.moments, tiles_x, width, height, dpay)
    return dpay


def _bwd_walk(payload, sub_tile, nb: int, cst, dense: bool, variant: str,
              moments: str, tiles_x: int, width: int, height: int, dpay):
    """Writes the dpay rows of the first nb blocks' subs: per tile run, the
    backward of each sub in order. cst is per tile, or per sub (dense)."""
    if nb == 0:
        return
    dev = payload.device
    feats = payload.reshape(-1, SUB, NFEAT)
    rows_out = dpay.view(-1, SUB, NFEAT)
    # The runs cover every computed sub, so each of their rows is written.
    start, length, tile = _runs(sub_tile, nb)
    if not dense:
        g_all = cst[tile, 0:NPHI]                            # (R, 3, NPIX)
        sfx_all = cst[tile, 5] + cst[tile, 6]                # (R, NPIX)
    t_run = torch.ones((start.shape[0], NPIX), dtype=torch.float32,
                       device=dev)
    done_run = _outside(tile, tiles_x, width, height)
    p_run = torch.zeros_like(t_run)
    for d, n in enumerate(_active_counts(length)):
        j = start[:n] + d
        if variant not in ADVANCING and d:
            # A block boundary inside the run: the state reads 0.
            new_block = (j % NSUB == 0)[:, None]
            t_run[:n] = torch.where(new_block, 0.0, t_run[:n])
            done_run[:n] = torch.where(new_block, 0.0, done_run[:n])
            p_run[:n] = torch.where(new_block, 0.0, p_run[:n])
        if dense:
            g, sfx = cst[j, 0:NPHI], cst[j, 5] + cst[j, 6]
        else:
            g, sfx = g_all[:n], sfx_all[:n]
        t_in, done = t_run[:n], done_run[:n]
        sub = _sub_step(feats, j, tile[:n], t_in, done, tiles_x)
        rows, p_run[:n] = _bwd_sub_rows(variant, feats[j], sub, t_in, g,
                                        sfx, p_run[:n], moments)
        rows_out[j] = rows
        t_run[:n], done_run[:n] = _advance(sub, t_in, done)


def _check_bwd(payload, sub_tile, sub_valid, cst, variant, form,
               tiles: int):
    """Checks bwd_ablate's arguments; returns the blocks the grid covers."""
    _check(payload, sub_tile, sub_valid, variant, BWD_VARIANTS,
           "bwd_ablate")
    if not isinstance(form, BwdForm):
        raise TypeError(f"bwd_ablate: form must be a BwdForm, not {form!r}")
    for axis, allowed in _AXES.items():
        if getattr(form, axis) not in allowed:
            raise ValueError(f"bwd_ablate: {axis} {getattr(form, axis)!r} "
                             f"not in {allowed}")
    if variant != "full" and form != BwdForm():
        raise ValueError(f"bwd_ablate: {variant} takes only the default "
                         f"form, not {form}")
    dense = form.constants == "dense"
    _check_cst(cst, payload, sub_tile.shape[0] if dense else tiles)
    return payload.shape[0] // form.group * form.group


def dense_cst(cst, sub_tile, out=None):
    """The `dense` constants: cst (tiles, 8, 256) gathered at every sub's
    tile, (4·B, 8, 256) (tools/exp_bwd2.py:333-335; binning keeps sub_tile
    inside [0, tiles), so the script's clip changes nothing)."""
    return torch.index_select(cst, 0, sub_tile, out=out)


def n_tiles(tiles_x: int, height: int) -> int:
    return tiles_x * (-(-height // TILE))


def _check_cst(cst, payload, rows: int):
    if (cst.dtype != torch.float32
            or tuple(cst.shape) != (rows, NOUT, NPIX)):
        raise TypeError(f"bwd_ablate: cst must be a ({rows}, {NOUT}, "
                        f"{NPIX}) float32 tensor, not {cst.dtype} of shape "
                        f"{tuple(cst.shape)}")
    if cst.device != payload.device:
        raise ValueError(f"bwd_ablate: payload on {payload.device}, cst on "
                         f"{cst.device}")


def _bwd_out(payload, out):
    if out is None:
        return torch.zeros_like(payload)
    if (out.dtype != torch.float32 or out.shape != payload.shape
            or out.device != payload.device or not out.is_contiguous()):
        raise TypeError(f"bwd_ablate: out must be a contiguous float32 "
                        f"{tuple(payload.shape)} tensor on {payload.device}")
    return out


def _cuda_args(payload, sub_tile, sub_valid, what):
    if not payload.is_contiguous() or payload.data_ptr() % 16:
        raise ValueError(f"{what}: payload must be contiguous and 16-byte "
                         f"aligned (the kernels read float4s)")
    return payload, sub_tile.contiguous(), sub_valid.contiguous()


def _fwd_cuda(payload, sub_tile, sub_valid, variant, tiles_x, width, height,
              out):
    payload, sub_tile, sub_valid = _cuda_args(payload, sub_tile, sub_valid,
                                              "fwd_ablate")
    out = fwd_out(payload, variant, out)
    written = torch.zeros(out.shape[0], dtype=torch.bool,
                          device=payload.device)
    B = payload.shape[0]
    block = variant not in TILE_VARIANTS
    partial = (torch.empty((B, NACC, NPIX), dtype=torch.float32,
                           device=payload.device) if block else None)
    lib = _build.load()
    err = lib.msgs_fwd_ablate(
        payload.data_ptr(), sub_tile.data_ptr(), sub_valid.data_ptr(),
        out.data_ptr(), written.data_ptr(),
        None if partial is None else partial.data_ptr(), B,
        ALL_FWD.index(variant), n_tiles(tiles_x, height), tiles_x,
        width, height, _build.stream_ptr(payload))
    _build.check(err, f"fwd_ablate {variant}")
    # One per kernel launched: the block terms and their running sum, or
    # the tile kernel.
    _build.launch_counts["fwd_ablate"] += 2 if block else 1
    return out, written


def _bwd_cuda(payload, sub_tile, sub_valid, cst, variant, form, tiles_x,
              width, height, out):
    payload, sub_tile, sub_valid = _cuda_args(payload, sub_tile, sub_valid,
                                              "bwd_ablate")
    tiles = n_tiles(tiles_x, height)
    n_cover = _check_bwd(payload, sub_tile, sub_valid, cst, variant, form,
                         tiles)
    key = (variant, form._replace(group=8))
    if key not in BWD_INSTANCES:
        raise ValueError(f"bwd_ablate: {form} is not built in "
                         f"csrc/bwd_ablate.cu (ablate.BUILT_FORMS)")
    cst = cst.contiguous()
    dpay = _bwd_out(payload, out)
    if dpay.data_ptr() % 16:
        raise ValueError("bwd_ablate: out must be 16-byte aligned (row "
                         "stores write float4s)")
    lib = _build.load()
    err = lib.msgs_bwd_ablate(
        payload.data_ptr(), sub_tile.data_ptr(), sub_valid.data_ptr(),
        cst.data_ptr(), dpay.data_ptr(), n_cover, BWD_INSTANCES.index(key),
        tiles, tiles_x, width, height, _build.stream_ptr(payload))
    _build.check(err, f"bwd_ablate {variant} {form}")
    _build.launch_counts["bwd_ablate"] += 1
    return dpay


def fwd_ablate(payload, sub_tile, sub_valid, variant: str, tiles_x: int,
               width: int, height: int, out=None):
    """The forward variant `variant` over the stream: (out, written), out
    the (4·B, 8, 256) state slots ((B/8, 8, 256) for small_out) and
    written a bool mask of the slots the variant wrote. `out`, if given,
    is used in place (zeros by default); its unwritten slots keep their
    values. payload (B, 128, 12) float32 with B a multiple of 8, sub_tile
    and sub_valid (4·B,) int32, as binning gives them. A CUDA tensor goes
    through csrc/fwd_ablate.cu, a CPU tensor through fwd_ablate_plain.
    `variant` is one of FWD_VARIANTS or HORNER_VARIANTS."""
    _check(payload, sub_tile, sub_valid, variant, ALL_FWD, "fwd_ablate")
    if payload.device.type == "cuda":
        return _fwd_cuda(payload, sub_tile, sub_valid, variant, tiles_x,
                         width, height, out)
    if payload.device.type == "cpu":
        return fwd_ablate_plain(payload, sub_tile, sub_valid, variant,
                                tiles_x, width, height, out)
    raise ValueError(f"fwd_ablate: unsupported device {payload.device}")


def bwd_ablate(payload, sub_tile, sub_valid, cst, variant: str,
               tiles_x: int, width: int, height: int, out=None,
               form: BwdForm = BwdForm()):
    """The backward variant `variant` over the stream: dpay (B, 128, 12).
    cst (tiles, 8, 256) float32 holds each tile's constant rows (see the
    module docstring). `full` takes any form (a BwdForm; BWD2_RUNS and
    BWD3_RUNS hold the forms of tools/exp_bwd2.py and exp_bwd3.py), the
    other variants only the default; for constants "dense" cst is the
    (4·B, 8, 256) gather dense_cst(cst, sub_tile). `out`, if given, is
    used in place: under zeroing "caller" it must be zero (zeros by
    default), and the kernel writes columns 0-8 of the live rows; under
    "kernel" every row of the covered blocks is written, so it may come
    from torch.empty. A CUDA tensor goes through csrc/bwd_ablate.cu, a CPU
    tensor through bwd_ablate_plain."""
    if payload.device.type == "cuda":
        return _bwd_cuda(payload, sub_tile, sub_valid, cst, variant, form,
                         tiles_x, width, height, out)
    if payload.device.type == "cpu":
        return bwd_ablate_plain(payload, sub_tile, sub_valid, cst, variant,
                                tiles_x, width, height, out, form)
    raise ValueError(f"bwd_ablate: unsupported device {payload.device}")
