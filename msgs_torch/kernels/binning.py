"""Tile binning: duplicate visible Gaussians into (tile, depth)-sorted,
sub-block-aligned entry streams for the compositor.

Port of msgs/kernels/binning.py (see its docstring for the design): per-
Gaussian counts → offsets with whole-Gaussian truncation at `entry_cap`,
per-tile counts from a 2-D difference histogram, per-tile dummy padding to
SUB=32 injected before one fused-key sort, and the sub-block structure read
off the sorted keys. The key layout is the reference's exactly (`_depth_bits`,
`dqb`, the depth quantisation, the reserved `dq_max` quantum for dummies), so
every tile's entries come out in the same depth order; only real entries of
one tile that share a depth quantum may swap, as the unstable sort lets them
in the reference too.

Differences in mechanism, not in output:
  - delta scans scatter at logical positions and run on `scan.cumsum_rows`
    (no sublane-major permutation);
  - the difference histogram is an exact int32 corner scatter-add instead of
    one-hot f32 matmuls;
  - every prefix sum here, including the ones XLA computed, goes through
    `scan.cumsum_rows`, and all integer math stays int32 as in JAX.

All three emission paths of the reference are here: "bands" (the default),
plain rects (`row_tight=False`) and per-row spans (`row_tight=True`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msgs_torch.kernels.preprocess import ALPHA_MIN, TILE, PreprocessOut
from msgs_torch.kernels.scan import cumsum_rows
from msgs_torch.trace import span

BLOCK = 128  # entries per compositor payload block
SUB = 32     # tile-alignment granularity: entries per compositor sub-block
SCAN_TILE = 1024   # the TPU scan's tile; entry capacities stay aligned to it
NULL_KEY = 2**31 - 1
ROW_TIGHT_DEFAULT = "bands"

_I32 = torch.int32
_F32 = torch.float32


def _pad_ecap(entry_cap: int) -> int:
    """Entry capacity aligned to 1024 (a no-op for power-of-two caps)."""
    return -(-entry_cap // SCAN_TILE) * SCAN_TILE


class Binned(NamedTuple):
    gauss_id: torch.Tensor      # (E_cap,) int32 — Gaussian per packed entry,
                                #   N = sentinel (dummy / null / truncated)
    sub_tile: torch.Tensor      # (S_cap,) int32 — owning tile per sub-block
    sub_valid: torch.Tensor     # (S_cap,) int32 — 1 if sub-block holds entries
    tile_nonempty: torch.Tensor # (T,) bool — tile has ≥1 entry
    tile_last_sub: torch.Tensor # (T,) int32 — index of the tile's last sub-block
    num_entries: torch.Tensor   # () int32 — duplicated entries (pre-truncation)
    overflow: torch.Tensor      # () int32 — entries dropped due to capacity
    gid_starts: torch.Tensor    # (N+1,) int32 — per-Gaussian segment starts


def entry_capacity(entry_cap: int, tiles: int) -> int:
    """Total packed-entry capacity: duplicates + worst-case per-tile padding,
    rounded up to 128 blocks of 128 entries (as the reference)."""
    cap = _pad_ecap(entry_cap) + SUB * tiles + BLOCK
    group = 128 * BLOCK
    return ((cap + group - 1) // group) * group


def block_capacity(entry_cap: int, tiles: int) -> int:
    return entry_capacity(entry_cap, tiles) // BLOCK


def _depth_bits(tiles: int) -> int:
    """Fused-key split: key = tile << db | depth_q, with the null sentinel
    INT32_MAX reserved. db = 31 − bits(tiles)."""
    tb = max(int(tiles + 1).bit_length(), 1)
    db = 31 - tb
    assert db >= 8, f"too many tiles ({tiles}) for a 31-bit fused sort key"
    return db


def _excl_cumsum(x):
    """Exclusive prefix sum of a 1-D int32 tensor, and its total."""
    incl = cumsum_rows(x)
    return incl - x, incl[-1]


def _delta_scan(fields, positions, entry_cap: int):
    """Per-slot constants from per-segment deltas: scatter Δfields at the
    (monotone) segment-start `positions` (positions ≥ entry_cap are
    dropped; colliding starts accumulate, their deltas telescope), then one
    batched inclusive prefix sum. Returns (cums (K, entry_cap), iota) in the
    fields' dtype: float32 (exact to 2^24) or int32 (exact mod 2^32)."""
    K = fields.shape[0]
    dt = fields.dtype
    deltas = torch.diff(fields, dim=1,
                        prepend=torch.zeros((K, 1), dtype=dt,
                                            device=fields.device))
    # Slot entry_cap is the drop slot for positions past the capacity.
    pos = torch.clamp(positions, max=entry_cap).long().expand(K, -1)
    starts = torch.zeros((K, entry_cap + 1), dtype=dt, device=fields.device)
    starts.scatter_add_(1, pos, deltas)
    starts = starts[:, :entry_cap].contiguous()
    cums = cumsum_rows(starts)
    iota = torch.arange(entry_cap, dtype=dt, device=fields.device)
    return cums, iota


def _pack_planes(bit_widths):
    """Static first-fit-decreasing packing of bit fields into ≤31-bit int32
    delta-scan planes, splitting fields across planes' spare capacity when no
    whole slot fits. Returns (n_planes, chunks): chunks[i] is a list of
    (plane, shift_in_plane, field_lo_bit, nbits) for field i."""
    order = sorted(range(len(bit_widths)), key=lambda i: -bit_widths[i])
    planes = []
    chunks = [[] for _ in bit_widths]
    for i in order:
        b = bit_widths[i]
        placed = False
        for p, used in enumerate(planes):
            if used + b <= 31:
                chunks[i].append((p, used, 0, b))
                planes[p] = used + b
                placed = True
                break
        if placed:
            continue
        lo = 0
        for p in range(len(planes)):
            spare = 31 - planes[p]
            if spare <= 0 or lo >= b:
                continue
            take = min(spare, b - lo)
            chunks[i].append((p, planes[p], lo, take))
            planes[p] += take
            lo += take
        while lo < b:
            take = min(31, b - lo)
            chunks[i].append((len(planes), 0, lo, take))
            planes.append(take)
            lo += take
    return len(planes), chunks


def _pack_fields(fields_i32, bit_widths, chunks, n_planes):
    """(n_fields, N) int32 fields → (n_planes, N) packed planes."""
    N = fields_i32[0].shape[0]
    dev = fields_i32[0].device
    planes = [torch.zeros((N,), dtype=_I32, device=dev)
              for _ in range(n_planes)]
    for f, cks in zip(fields_i32, chunks):
        for (p, shift, lo, nb) in cks:
            part = (f >> lo) & ((1 << nb) - 1)
            planes[p] = planes[p] | (part << shift)
    return torch.stack(planes)


def _unpack_field(cums, chunks_i):
    """Reassemble field i from the scanned planes (elementwise int ops)."""
    out = None
    for (p, shift, lo, nb) in chunks_i:
        part = (cums[p] >> shift) & ((1 << nb) - 1)
        v = part << lo
        out = v if out is None else out | v
    return out


def _onehot_diff_histogram(ylo, yhi, xlo, xhi, ny: int, nx: int):
    """Σ_n outer(1[y=ylo_n] − 1[y=yhi_n], 1[x=xlo_n] − 1[x=xhi_n]) on an
    (ny, nx) grid, as an exact int32 corner scatter-add (a one-hot of an
    index outside the grid is zero, so such corners go to a drop slot)."""
    idx, vals = [], []
    for ys, xs, sign in ((ylo, xlo, 1), (ylo, xhi, -1), (yhi, xlo, -1),
                         (yhi, xhi, 1)):
        ok = (ys >= 0) & (ys < ny) & (xs >= 0) & (xs < nx)
        idx.append(torch.where(ok, ys.long() * nx + xs.long(), ny * nx))
        vals.append(torch.full(ys.shape, sign, dtype=_I32, device=ys.device))
    # int32 atomics: exact, so the sum does not depend on their order.
    hist = torch.zeros((ny * nx + 1,), dtype=_I32, device=ylo.device)
    hist.scatter_add_(0, torch.cat(idx), torch.cat(vals))
    hist = hist[:ny * nx]
    return hist.reshape(ny, nx)


def _cover(diff, tiles_y: int, tiles_x: int):
    """2-D inclusive prefix of a difference histogram → per-tile counts."""
    c = cumsum_rows(diff.T.contiguous()).T.contiguous()   # along y
    c = cumsum_rows(c)                                    # along x
    return c[:tiles_y, :tiles_x].reshape(-1)


def bin_gaussians(pre: PreprocessOut, width: int, height: int,
                  entry_cap: int, row_tight=None) -> Binned:
    if row_tight is None:
        row_tight = ROW_TIGHT_DEFAULT
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    if row_tight == "bands":
        # The packed band descriptors budget 8 bits per count; beyond a
        # 255-tile axis (> 4080 px) fall back to plain rects.
        if tiles_x <= 255 and tiles_y <= 255:
            return _bin_gaussians_banded(pre, width, height, entry_cap)
        return _bin_gaussians_rect(pre, width, height, entry_cap)
    if row_tight:
        return _bin_gaussians_rowtight(pre, width, height, entry_cap)
    return _bin_gaussians_rect(pre, width, height, entry_cap)


def _depth_quanta(pre: PreprocessOut, dqb: int):
    """Per-Gaussian depth quantum in [0, 2^dqb − 2] (f32, integer-valued);
    the top quantum 2^dqb − 1 stays reserved for dummies."""
    inf = torch.tensor(float("inf"), dtype=_F32, device=pre.depths.device)
    dmin = torch.where(pre.visible, pre.depths, inf).min()
    dmax = torch.where(pre.visible, pre.depths, -inf).max()
    dspan = torch.clamp(dmax - dmin, min=1e-9)
    return torch.floor(torch.clamp(
        (pre.depths - dmin) / dspan * (2.0**dqb - 2.0), 0.0, 2.0**dqb - 2.0))


def _bin_gaussians_rect(pre: PreprocessOut, width: int, height: int,
                        entry_cap: int) -> Binned:
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    T = tiles_x * tiles_y
    N = pre.depths.shape[0]
    dev = pre.depths.device
    E_cap = entry_capacity(entry_cap, T)
    entry_cap = _pad_ecap(entry_cap)
    pad_cap = E_cap - entry_cap
    db = _depth_bits(T)

    with span("msgs.binning.count"):
        rect_w = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0], min=0)
        rect_h = torch.clamp(pre.rect_max[:, 1] - pre.rect_min[:, 1], min=0)
        counts = torch.where(pre.visible, rect_w * rect_h, 0).to(_I32)
        offsets, total = _excl_cumsum(counts)
        overflow = torch.clamp(total - entry_cap, min=0)
        # Clean truncation: a Gaussian whose emission range crosses
        # entry_cap is dropped whole.
        kept = counts * (offsets + counts <= entry_cap)

    with span("msgs.binning.hist"):
        live = kept > 0
        y0 = torch.where(live, pre.rect_min[:, 1], tiles_y + 1)
        y1 = torch.where(live, pre.rect_max[:, 1], tiles_y + 1)
        x0 = pre.rect_min[:, 0]
        x1 = pre.rect_max[:, 0]
        diff = _onehot_diff_histogram(y0, y1, x0, x1, tiles_y + 2, tiles_x + 2)
        tcounts = _cover(diff, tiles_y, tiles_x)

    with span("msgs.binning.emit"):
        # Per-slot fields by delta scatter + prefix sum, f32-exact (< 2^24):
        #   gidp1 = g+1, off, end = off + kept, rm = rmin_y·2^xb + rmin_x,
        #   wdq = w·2^dqb + dq.
        xb = max(int(tiles_x).bit_length(), 1)
        yb = max(int(tiles_y).bit_length(), 1)
        dqb = min(db, 24 - (xb + 1))
        assert xb + yb <= 24 and dqb >= 8

        dq_g = _depth_quanta(pre, dqb)
        fields = torch.stack([
            torch.arange(N, dtype=_F32, device=dev) + 1.0,
            offsets.to(_F32),
            (offsets + kept).to(_F32),
            (pre.rect_min[:, 1] * (1 << xb) + pre.rect_min[:, 0]).to(_F32),
            torch.clamp(rect_w, min=1).to(_F32) * (2.0**dqb) + dq_g,
        ], dim=0)                                        # (5, N)
        cums, iota_f = _delta_scan(fields, offsets, entry_cap)
        gid = (cums[0] - 1.0).to(_I32)
        off_f, end_f, rm_f, wdq_f = cums[1], cums[2], cums[3], cums[4]
        valid = iota_f < end_f

        w_f = torch.floor(wdq_f * (0.5**dqb))
        dq_e = wdq_f - w_f * (2.0**dqb)
        rmin_y_f = torch.floor(rm_f * (0.5**xb))
        rmin_x_f = rm_f - rmin_y_f * (1 << xb)

        # slot → (row, col) of the rect: exact f32 division after the two
        # standard floor corrections.
        slot_f = iota_f - off_f
        q = torch.floor(slot_f / w_f)
        r = slot_f - q * w_f
        q = q - (r < 0.0).to(_F32) + (r >= w_f).to(_F32)
        r = slot_f - q * w_f
        tx_f = rmin_x_f + r
        ty_f = rmin_y_f + q
        tile_e = (ty_f * tiles_x + tx_f).to(_I32)

        key_e = torch.where(
            valid, tile_e * (1 << db) + (dq_e.to(_I32) << (db - dqb)),
            NULL_KEY)
        gid_e = torch.where(valid, gid, N)

        gid_starts = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                                cumsum_rows(kept)])
    return _finalize(key_e, gid_e, tcounts, total, overflow, gid_starts,
                     T, E_cap, pad_cap, db, N)


def _inflated_k2(opacities):
    """α ≥ 1/255 level set, inflated to cover the compositor's own f32 error
    in evaluating `power` plus the span formula's cancellation."""
    op = torch.clamp(opacities, min=1e-12)
    return 2.0 * torch.log(op / ALPHA_MIN) * (1.0 + 1e-4) + 1e-3


def _band_span(a, b, c, det_s, k2p, dy_lo, dy_hi, ymax):
    """Exact x-extent (pixels, relative to the mean) of the ellipse
    dᵀΣ⁻¹d ≤ k² over the row band dy ∈ [dy_lo, dy_hi], with the magnitude-
    scaled roundoff margin. Returns (dxlo, dxhi, nonempty)."""
    a_s = torch.clamp(a, min=1e-12)
    lo_b = torch.maximum(dy_lo, -ymax)
    hi_b = torch.minimum(dy_hi, ymax)
    dystar = -b * torch.sqrt(k2p / (det_s * torch.clamp(c, min=1e-12)))

    def _ext(dyc):
        s2 = torch.clamp(a * k2p - det_s * dyc * dyc, min=0.0)
        return -b * dyc / a_s, torch.sqrt(s2) / a_s

    def _clipt(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    lin_hi, rad_hi = _ext(_clipt(dystar, lo_b, hi_b))
    lin_lo, rad_lo = _ext(_clipt(-dystar, lo_b, hi_b))
    m_hi = 1e-2 + 4e-6 * (torch.abs(lin_hi) + rad_hi)
    m_lo = 1e-2 + 4e-6 * (torch.abs(lin_lo) + rad_lo)
    return lin_lo - rad_lo - m_lo, lin_hi + rad_hi + m_hi, hi_b >= lo_b


def _bin_gaussians_banded(pre: PreprocessOut, width: int, height: int,
                          entry_cap: int) -> Binned:
    """Banded emission: each Gaussian's tile rect splits into ≤3 row bands
    (top quarter / middle half / bottom quarter of its rows), each emitted
    at the exact ellipse x-extent over that band; the band geometry rides
    bit-packed int32 delta-scan planes (msgs/kernels/binning.py:402)."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    T = tiles_x * tiles_y
    N = pre.depths.shape[0]
    dev = pre.depths.device
    E_cap = entry_capacity(entry_cap, T)
    entry_cap = _pad_ecap(entry_cap)
    pad_cap = E_cap - entry_cap
    db = _depth_bits(T)

    with span("msgs.binning.count"):
        rect_w = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0], min=0)
        rect_h = torch.clamp(pre.rect_max[:, 1] - pre.rect_min[:, 1], min=0)
        live0 = pre.visible & (rect_w > 0) & (rect_h > 0)

        # --- band geometry (per Gaussian, exact ints + f32 span math) ---
        q1 = torch.div(rect_h, 4, rounding_mode="floor")
        q2 = rect_h - q1
        mx, my = pre.means2d[:, 0], pre.means2d[:, 1]
        a, b, c = pre.conics[:, 0], pre.conics[:, 1], pre.conics[:, 2]
        # Culled rows may carry non-finite projections; NaN reaching any
        # delta-scan field would poison the telescoping prefix.
        mx = torch.where(live0, mx, 0.0)
        my = torch.where(live0, my, 0.0)
        a = torch.where(live0, a, 1.0)
        b = torch.where(live0, b, 0.0)
        c = torch.where(live0, c, 1.0)
        k2p = torch.clamp(torch.where(live0, _inflated_k2(pre.opacities), 1.0),
                          min=0.0)
        det = a * c - b * b
        degen = det <= 1e-12
        det_s = torch.clamp(det, min=1e-12)
        ymax = torch.sqrt(k2p * torch.clamp(a, min=0.0) / det_s)

        rminx_f = pre.rect_min[:, 0].to(_F32)
        rmaxx_f = pre.rect_max[:, 0].to(_F32)
        rminy_f = pre.rect_min[:, 1].to(_F32)

        def band_cols(qa, qb):
            """(txlo, w) for rows [qa, qb) — full rect width on any
            degenerate fallback (a safe superset)."""
            dy_lo = (rminy_f + qa.to(_F32)) * TILE - my
            dy_hi = (rminy_f + qb.to(_F32)) * TILE - 1.0 - my
            dxlo, dxhi, nonempty = _band_span(a, b, c, det_s, k2p,
                                              dy_lo, dy_hi, ymax)
            ok = nonempty & ~degen
            hi_x = rmaxx_f - 1.0
            txlo = torch.minimum(torch.maximum(
                torch.floor((mx + dxlo) / TILE), rminx_f), hi_x)
            txhi = torch.minimum(torch.maximum(
                torch.floor((mx + dxhi) / TILE), rminx_f), hi_x)
            txlo = torch.where(ok, txlo, rminx_f)
            txhi = torch.where(ok, txhi, hi_x)
            w = torch.clamp(txhi - txlo + 1.0, min=0.0)
            empty = qb <= qa
            return (torch.where(empty, rminx_f, txlo),
                    torch.where(empty, 0.0, w))

        zero = torch.zeros_like(rect_h)
        txlo1, w1 = band_cols(zero, q1)
        txlo2, w2 = band_cols(q1, q2)
        txlo3, w3 = band_cols(q2, rect_h)
        h1 = q1
        h2 = q2 - q1
        h3 = rect_h - q2

        counts = torch.where(
            live0,
            (h1.to(_F32) * w1 + h2.to(_F32) * w2 + h3.to(_F32) * w3),
            0.0).to(_I32)
        offsets, total = _excl_cumsum(counts)
        overflow = torch.clamp(total - entry_cap, min=0)
        kept = counts * (offsets + counts <= entry_cap)
        live = kept > 0

    # --- per-tile entry counts: one difference histogram per band ---
    with span("msgs.binning.hist"):
        def band_hist(qa, qb, txlo, w):
            on = live & (w > 0)
            y0 = torch.where(on, pre.rect_min[:, 1] + qa, tiles_y + 1)
            y1 = torch.where(on, pre.rect_min[:, 1] + qb, tiles_y + 1)
            x0 = txlo.to(_I32)
            x1 = (txlo + w).to(_I32)
            return _onehot_diff_histogram(y0, y1, x0, x1,
                                          tiles_y + 2, tiles_x + 2)

        diff = (band_hist(zero, q1, txlo1, w1)
                + band_hist(q1, q2, txlo2, w2)
                + band_hist(q2, rect_h, txlo3, w3))
        tcounts = _cover(diff, tiles_y, tiles_x)

    # --- entry stream: bit-packed int32 delta-scan planes, then band select
    # and exact-f32 row/col division within the band. Kept segments form a
    # prefix of the slot range, so validity is one compare against
    # sum(kept). ---
    with span("msgs.binning.emit"):
        dqb = min(db, 23)
        dq_g = torch.where(live0, _depth_quanta(pre, dqb), 0.0).to(_I32)

        gb = max(int(N).bit_length(), 1)             # iota+1 ∈ [1, N]
        ob = max(int(entry_cap - 1).bit_length(), 1)  # kept offsets < cap
        hb = max(int(tiles_y).bit_length(), 1)    # h1, h2 ≤ rect_h ≤ tiles_y
        wb = max(int(tiles_x).bit_length(), 1)       # band widths ≤ tiles_x
        xb = max(int(tiles_x - 1).bit_length(), 1)   # absolute tile-x lows
        yb = max(int(tiles_y - 1).bit_length(), 1)
        widths = [gb, ob, yb, dqb, hb, hb, wb, wb, wb, xb, xb, xb]
        n_planes, chunks = _pack_planes(widths)
        fields = _pack_fields([
            torch.arange(N, dtype=_I32, device=dev) + 1,
            offsets,
            pre.rect_min[:, 1],
            dq_g,
            h1, h2,
            w1.to(_I32), w2.to(_I32), w3.to(_I32),
            txlo1.to(_I32), txlo2.to(_I32), txlo3.to(_I32),
        ], widths, chunks, n_planes)                 # (n_planes, N) < 2^31
        cums, iota_i = _delta_scan(fields, offsets, entry_cap)
        gid = _unpack_field(cums, chunks[0]) - 1
        off_i = _unpack_field(cums, chunks[1])
        rminy_e = _unpack_field(cums, chunks[2]).to(_F32)
        dq_e = _unpack_field(cums, chunks[3])
        h1f, h2f, w1f, w2f, w3f, x1f, x2f, x3f = (
            _unpack_field(cums, chunks[i]).to(_F32) for i in range(4, 12))
        valid = iota_i < kept.sum(dtype=_I32)

        slot = (iota_i - off_i).to(_F32)
        A1 = h1f * w1f
        A2 = h2f * w2f
        in2 = (slot >= A1).to(_F32)
        in3 = (slot >= A1 + A2).to(_F32)
        u = slot - in2 * A1 - in3 * A2
        wk = torch.clamp(w1f + in2 * (w2f - w1f) + in3 * (w3f - w2f), min=1.0)
        xk = x1f + in2 * (x2f - x1f) + in3 * (x3f - x2f)
        qb0 = in2 * h1f + in3 * h2f
        q = torch.floor(u / wk)
        r = u - q * wk
        q = q - (r < 0.0).to(_F32) + (r >= wk).to(_F32)
        r = u - q * wk
        ty = rminy_e + qb0 + q
        tx = xk + r
        tile_e = (ty * tiles_x + tx).to(_I32)

        key_e = torch.where(valid, tile_e * (1 << db) + (dq_e << (db - dqb)),
                            NULL_KEY)
        gid_e = torch.where(valid, gid, N)

        gid_starts = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                                cumsum_rows(kept)])
    return _finalize(key_e, gid_e, tcounts, total, overflow, gid_starts,
                     T, E_cap, pad_cap, db, N)


def seg_capacity(entry_cap: int) -> int:
    """Static row-segment capacity of the row-tight path: one segment per
    (Gaussian, touched tile row); half the entry budget, as the reference
    (msgs/kernels/binning.py:588)."""
    return max(_pad_ecap(entry_cap) // 2, 16384)


def _marker_cumsum(offsets, length: int):
    """gid per slot: slot s ∈ [offsets[g], offsets[g+1]) ↦ g, by a marker
    scatter and a prefix sum (values < 2^24, exact in f32). A Gaussian with
    no slots puts its marker on the next one's start slot, which the sum
    then skips in one step; markers at or past `length` are dropped."""
    markers = torch.zeros((length + 1,), dtype=_F32, device=offsets.device)
    idx = torch.clamp(offsets, max=length).long()
    markers.index_add_(0, idx, torch.ones(idx.shape, dtype=_F32,
                                          device=idx.device))
    return (cumsum_rows(markers[:length].contiguous()) - 1.0).to(_I32)


def _bin_gaussians_rowtight(pre: PreprocessOut, width: int, height: int,
                            entry_cap: int) -> Binned:
    """Row-tight emission (msgs/kernels/binning.py:596): every Gaussian is
    expanded into one segment per touched tile row, and each segment emits
    the tiles of the ellipse's exact x-extent over its 16-pixel row band,
    with the banded path's margins (`_band_span`). Segments are gid-major,
    so each Gaussian's entries stay contiguous for `gid_starts`. The
    segment and entry streams ride the same f32 delta scan as the rect
    path; the entry offsets are an exact int32 prefix sum, and their f32
    views round as the reference's do, so truncation keeps the same
    Gaussians."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    T = tiles_x * tiles_y
    N = pre.depths.shape[0]
    dev = pre.depths.device
    E_cap = entry_capacity(entry_cap, T)
    entry_cap = _pad_ecap(entry_cap)
    pad_cap = E_cap - entry_cap
    db = _depth_bits(T)
    R = seg_capacity(entry_cap)

    with span("msgs.binning.count"):
        # --- one segment per (Gaussian, touched tile row) ---
        rect_h = torch.clamp(pre.rect_max[:, 1] - pre.rect_min[:, 1], min=0)
        n_rows_raw = torch.where(pre.visible, rect_h, 0).to(_I32)
        s_off, total_rows = _excl_cumsum(n_rows_raw)
        seg_overflow = torch.clamp(total_rows - R, min=0)
        kept_seg_g = s_off + n_rows_raw <= R            # prefix-closed
        n_rows = n_rows_raw * kept_seg_g
        total_kept_rows = n_rows.sum(dtype=_I32)

        gid_seg = _marker_cumsum(s_off, R)           # (R,) slot → Gaussian
        gid_c = torch.clamp(gid_seg, 0, N - 1).long()
        valid_seg = torch.arange(R, dtype=_I32, device=dev) < total_kept_rows

        # Per-Gaussian constants, gathered into the segment stream. A culled
        # row's values may be non-finite: they are zeroed, since a NaN in any
        # delta field would poison the whole prefix.
        dqb = min(db, 23)
        gtab = torch.stack([
            pre.means2d[:, 0], pre.means2d[:, 1],
            pre.conics[:, 0], pre.conics[:, 1], pre.conics[:, 2],
            _inflated_k2(pre.opacities),
            pre.rect_min[:, 0].to(_F32),
            pre.rect_max[:, 0].to(_F32),
            pre.rect_min[:, 1].to(_F32),
            _depth_quanta(pre, dqb),
            s_off.to(_F32)], dim=1)                     # (N, 11)
        gtab = torch.where(pre.visible[:, None], gtab, 0.0)
        gtab[:, 10] = s_off.to(_F32)
        sg = gtab[gid_c]                                # (R, 11)
        mx, my = sg[:, 0], sg[:, 1]
        a, b, c = sg[:, 2], sg[:, 3], sg[:, 4]
        k2s = sg[:, 5]
        rminx, rmaxx, rminy = sg[:, 6], sg[:, 7], sg[:, 8]
        dq_s, s_off_s = sg[:, 9], sg[:, 10]

        # row in the rect
        q = torch.arange(R, dtype=_F32, device=dev) - s_off_s
        ty = rminy + q                                  # tile row
        dy0 = ty * TILE - my                            # band [dy0, dy1]
        dy1 = dy0 + (TILE - 1)

        det = a * c - b * b
        degen = det <= 1e-12
        det_s = torch.clamp(det, min=1e-12)
        k2p = torch.clamp(k2s, min=0.0)
        ymax = torch.sqrt(k2p * torch.clamp(a, min=0.0) / det_s)
        dxlo, dxhi, nonempty = _band_span(a, b, c, det_s, k2p, dy0, dy1, ymax)

        row_live = valid_seg & nonempty & ~degen
        hi_x = rmaxx - 1.0
        txlo = torch.minimum(torch.maximum(torch.floor((mx + dxlo) / TILE),
                                           rminx), hi_x)
        txhi = torch.minimum(torch.maximum(torch.floor((mx + dxhi) / TILE),
                                           rminx), hi_x)
        # Degenerate conics fall back to the full rect row.
        degen_v = degen & valid_seg
        txlo = torch.where(degen_v, rminx, txlo)
        txhi = torch.where(degen_v, hi_x, txhi)
        use_row = valid_seg & (row_live | degen_v)
        w_seg = torch.clamp(torch.where(use_row, txhi - txlo + 1.0, 0.0),
                            min=0.0)

        # --- entry offsets: exact int32; the f32 views round as JAX's do ---
        w_i = w_seg.to(_I32)
        c_incl_i = cumsum_rows(w_i)
        e_off_i = c_incl_i - w_i
        c_incl = c_incl_i.to(_F32)
        e_off = e_off_i.to(_F32)
        total_e = c_incl_i[-1]
        # Overflow in entry units; a dropped tile row counts as 2 entries.
        overflow = torch.maximum(torch.clamp(total_e - entry_cap, min=0),
                                 2 * seg_overflow)

        # Whole-Gaussian truncation at the entry level (prefix-closed).
        g_first = torch.clamp(s_off, 0, R - 1).long()
        g_last = torch.clamp(s_off + n_rows_raw - 1, 0, R - 1).long()
        base_g = e_off[g_first]
        tot_g = torch.where(n_rows > 0, c_incl[g_last] - base_g, 0.0)
        kept_g = (kept_seg_g & (base_g + tot_g <= float(entry_cap))
                  & (n_rows > 0))
        tot_kept_g = torch.where(kept_g, tot_g, 0.0)
        w_eff = w_seg * kept_g[gid_c]
        end_seg = e_off + w_eff

    with span("msgs.binning.hist"):
        # --- per-tile counts: each segment's x-interval on its row, one
        # difference per row (its y corner lies outside the grid), summed
        # along x ---
        ty_i = torch.where(w_eff > 0, ty, float(tiles_y)).to(_I32)
        diffx = _onehot_diff_histogram(
            ty_i, torch.full_like(ty_i, tiles_y + 1), txlo.to(_I32),
            txhi.to(_I32) + 1, tiles_y + 1, tiles_x + 1)
        tcounts = cumsum_rows(diffx)[:tiles_y, :tiles_x].reshape(-1)

    with span("msgs.binning.emit"):
        # --- entry stream: 5-field f32 delta scan, division-free decode ---
        # Segments past the kept rows emit nothing; their tile base is 0, as
        # their ty grows with the slot index (past 2^24 at the bench scene)
        # and would make the plane's prefix inexact past the last entry.
        fields = torch.stack([
            (gid_seg + 1).to(_F32),
            e_off,
            end_seg,
            # column 0's tile
            torch.where(valid_seg, ty * tiles_x + txlo, 0.0),
            dq_s], dim=0)                               # (5, R)
        cums, iota_f = _delta_scan(fields, torch.clamp(e_off_i, max=entry_cap),
                                   entry_cap)
        gid = (cums[0] - 1.0).to(_I32)
        off_f, end_f, txb_f, dq_e = cums[1], cums[2], cums[3], cums[4]
        valid = iota_f < end_f
        tile_e = (txb_f + (iota_f - off_f)).to(_I32)
        key_e = torch.where(
            valid, tile_e * (1 << db) + (dq_e.to(_I32) << (db - dqb)),
            NULL_KEY)
        gid_e = torch.where(valid, gid, N)

        gid_starts = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                                cumsum_rows(tot_kept_g).to(_I32)])
    return _finalize(key_e, gid_e, tcounts, total_e, overflow, gid_starts,
                     T, E_cap, pad_cap, db, N)


def _finalize(key_e, gid_e, tcounts, total, overflow, gid_starts,
              T: int, E_cap: int, pad_cap: int, db: int, N: int) -> Binned:
    """Shared binning tail: pre-sort per-tile dummy padding, the one fused-
    key sort, and the sub-block structure read off the sorted keys."""
    with span("msgs.binning.sort"):
        dev = key_e.device
        dq_max = (1 << db) - 1
        padded = (tcounts + (SUB - 1)) // SUB * SUB      # (T,) int32
        n_dummy = padded - tcounts                       # (T,) in [0, SUB)
        padded_start, total_padded = _excl_cumsum(padded)

        # --- dummy stream: n_dummy[t] entries keyed to the end of tile t, slot
        # → tile by the same f32 delta scan as the reference ---
        d_off, total_d = _excl_cumsum(n_dummy)
        fields_d = (torch.arange(T, dtype=_F32, device=dev) + 1.0)[None, :]
        cums_d, iota_d = _delta_scan(fields_d, torch.clamp(d_off, max=pad_cap),
                                     pad_cap)
        tile_d = (cums_d[0] - 1.0).to(_I32)
        dvalid = iota_d < total_d.to(_F32)
        # Dummies own the reserved dq_max quantum, strictly after every real
        # entry of their tile — no tie, so an unstable sort is safe.
        key_d = torch.where(dvalid,
                            torch.clamp(tile_d, 0, T - 1) * (1 << db) + dq_max,
                            NULL_KEY)

        keys = torch.cat([key_e, key_d])
        gids = torch.cat([gid_e, torch.full((pad_cap,), N, dtype=_I32,
                                            device=dev)])
        keys_s, order = torch.sort(keys, stable=False)
        gauss_id = gids[order]

        # --- sub-block structure straight from the sorted keys ---
        first_key = keys_s[::SUB]                        # (S_cap,)
        raw_tile = first_key >> db
        sub_valid = (first_key != NULL_KEY).to(_I32)
        last_idx = torch.clamp(total_padded // SUB - 1,
                               min=0).reshape(1).long()
        last_tile = torch.clamp(raw_tile.gather(0, last_idx), 0, T - 1)
        sub_tile = torch.where(sub_valid == 1, torch.clamp(raw_tile, 0, T - 1),
                               last_tile).to(_I32)

        tile_last_sub = torch.clamp((padded_start + padded) // SUB - 1, min=0)

        return Binned(
            gauss_id=gauss_id,
            sub_tile=sub_tile,
            sub_valid=sub_valid,
            tile_nonempty=tcounts > 0,
            tile_last_sub=tile_last_sub.to(_I32),
            num_entries=total,
            overflow=overflow,
            gid_starts=gid_starts,
        )
