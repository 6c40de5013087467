"""Tile compositor, forward and backward: the CUDA kernels and their plain
versions.

Port of msgs/kernels/composite.py. The payload layout, the column indices
`F_*` and the (T, NOUT, 256) channel-major output rows `O_*` are the
reference's. `_composite_plain` is the plain PyTorch version of
`composite_reference`/`_block_forward`, vectorised over tiles and looped
over sub-block depth; `composite_bwd_reference` is the plain version of
`_bwd_kernel`, looped the same way, and `composite_bwd_bf16_reference` the
plain version of its `bwd_bf16=True` variant.

`composite` is differentiable (a torch.autograd.Function, the counterpart
of the JAX custom_vjp pair): for a CUDA payload its forward launches
msgs_torch/csrc/composite_fwd.cu and its backward
msgs_torch/csrc/composite_bwd.cu (msgs_torch/csrc/composite_bwd_bf16.cu
under `bwd_bf16`); for a CPU payload both are the plain versions. `composite_reference` runs the plain forward and backward on any
device.

Every version evaluates α in tile-local pixel offsets (dx = px_local −
(mx − tile_x0)), as the Pallas kernel's _BlockCtx does, and chains each
32-entry sub-block's Hillis-Steele prefix product of (1 − α) from the
transmittance the sub-block starts with, as _block_forward does. The
backward recomputes α, T and done with the forward's arithmetic, so it
stops exactly where the forward stopped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msgs_torch.kernels import _build
from msgs_torch.kernels.binning import SUB
from msgs_torch.kernels.preprocess import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE
from msgs_torch.trace import span

NPIX = TILE * TILE     # 256 pixels per tile
NFEAT = 12             # payload feature columns (11 used + pad)
NOUT = 8               # output channels: r g b depth acc T done pad

F_MX, F_MY, F_CXX, F_CXY, F_CYY, F_OP = 0, 1, 2, 3, 4, 5
F_R, F_G, F_B, F_DEPTH, F_PSIZE = 6, 7, 8, 9, 10
O_R, O_G, O_B, O_DEPTH, O_ACC, O_T, O_DONE = 0, 1, 2, 3, 4, 5, 6


def _local_pix(device):
    """Tile-local pixel coordinates, row-major within the tile: (NPIX,)."""
    p = torch.arange(NPIX, device=device)
    return (p % TILE).to(torch.float32), (p // TILE).to(torch.float32)


def _tile_origin(tiles: int, tiles_x: int, device):
    t = torch.arange(tiles, device=device)
    return ((t % tiles_x).to(torch.float32) * TILE,
            (t // tiles_x).to(torch.float32) * TILE)


def _init_state(tiles: int, tiles_x: int, width: int, height: int, device):
    """Fresh per-tile state (T, NOUT, NPIX): T=1, done=1 for off-image
    pixels (the reference kernel's `inside` mask)."""
    pxl, pyl = _local_pix(device)
    ox, oy = _tile_origin(tiles, tiles_x, device)
    outside = (((pxl[None] + ox[:, None]) >= width)
               | ((pyl[None] + oy[:, None]) >= height)).to(torch.float32)
    state = torch.zeros((tiles, NOUT, NPIX), dtype=torch.float32,
                        device=device)
    state[:, O_T] = 1.0
    state[:, O_DONE] = outside
    return state


def _active_tiles(n_sub, tiles: int):
    """The tiles still active at each sub-block depth d (those with more
    than d sub-blocks), as index tensors: tiles in decreasing sub count, so
    each depth's set is a prefix of one order."""
    order = torch.argsort(n_sub.long(), descending=True, stable=True)
    counts = n_sub.long()[order]
    depth = int(counts[0]) if tiles else 0
    n_active = torch.searchsorted(-counts.cpu(), -torch.arange(depth)).tolist()
    return [order[:n] for n in n_active]


class _Sub(NamedTuple):
    """One sub-block of the active tiles, recomputed as the forward does:
    (A, SUB) entry values and (A, SUB, NPIX) pair values."""
    mxl: torch.Tensor
    myl: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    alpha_raw: torch.Tensor
    mask: torch.Tensor
    alpha: torch.Tensor
    cum: torch.Tensor          # inclusive prefix product of (1 − α)
    cum_excl: torch.Tensor
    t_after: torch.Tensor
    alive: torch.Tensor
    w: torch.Tensor            # α·T_i·alive


def _sub_forward(feat, ox, oy, t_in, done) -> _Sub:
    """α in tile-local pixel offsets and the 5-round Hillis-Steele prefix
    product of (1 − α) (the multiply tree of _sub_cumprod_static), chained
    from the transmittance t_in the sub-block starts with. feat (A, SUB,
    NFEAT); ox, oy (A,) tile origins; t_in, done (A, 1, NPIX)."""
    pxl, pyl = _local_pix(feat.device)
    mxl = feat[..., F_MX] - ox[:, None]               # (A, SUB)
    myl = feat[..., F_MY] - oy[:, None]
    dx = pxl - mxl[..., None]                         # (A, SUB, NPIX)
    dy = pyl - myl[..., None]
    cxx = feat[..., F_CXX, None]
    cxy = feat[..., F_CXY, None]
    cyy = feat[..., F_CYY, None]
    power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
    alpha_raw = feat[..., F_OP, None] * torch.exp(power)
    mask = (alpha_raw >= ALPHA_MIN) & (power <= 0.0)
    alpha = torch.where(mask, torch.clamp(alpha_raw, max=ALPHA_MAX), 0.0)
    cum = 1.0 - alpha
    k = 1
    while k < SUB:
        cum = torch.cat([cum[:, :k], cum[:, k:] * cum[:, :-k]], dim=1)
        k *= 2
    cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    t_after = t_in * cum
    alive = (t_after >= T_EPS).to(torch.float32) * (1.0 - done)
    w = alpha * t_in * cum_excl * alive
    return _Sub(mxl, myl, dx, dy, alpha_raw, mask, alpha, cum, cum_excl,
                t_after, alive, w)


def _advance(sub: _Sub, t_in, done):
    """The tile's T and done after a sub-block, as the forward leaves them:
    (A, NPIX) each."""
    t_new = torch.where(sub.alive > 0.0, sub.t_after, t_in).amin(dim=1)
    done_new = torch.maximum(done[:, 0],
                             (sub.t_after[:, -1] < T_EPS).to(torch.float32))
    return t_new, done_new


def _bwd_constants(res, cot):
    """The cotangent's colour rows g (T, 5, NPIX) and each pixel's suffix
    base total_phi + T_final·g_T (T, NPIX), in _composite_bwd_call's
    order."""
    total_phi = ((res[:, O_R] * cot[:, O_R] + res[:, O_G] * cot[:, O_G]
                  + res[:, O_B] * cot[:, O_B])
                 + res[:, O_DEPTH] * cot[:, O_DEPTH]
                 + res[:, O_ACC] * cot[:, O_ACC])
    return cot[:, O_R:O_ACC + 1], total_phi + res[:, O_T] * cot[:, O_T]


def tile_sub_ranges(sub_tile, sub_valid, tile_last_sub, tiles: int):
    """(first_sub, n_sub) per tile, int32. Valid sub-blocks are a prefix of
    the stream and their tiles are nondecreasing (the keys are sorted), so a
    tile's first sub-block is a searchsorted over them (invalid ones keyed
    past every tile); its last is `tile_last_sub`. Empty tiles get n_sub 0."""
    key = torch.where(sub_valid == 1, sub_tile, tiles).contiguous()
    t = torch.arange(tiles, dtype=key.dtype, device=key.device)
    first = torch.searchsorted(key, t).to(torch.int32)
    s_cap = key.shape[0]
    owns = key[torch.clamp(first, max=s_cap - 1).long()] == t
    n = torch.where(owns & (first < s_cap),
                    torch.clamp(tile_last_sub + 1 - first, min=0), 0)
    return first, n.to(torch.int32)


def _composite_plain(payload, first, n_sub, tiles: int, tiles_x: int,
                     width: int, height: int):
    """Plain forward over per-tile sub ranges. Returns (tiles_out, n_work):
    n_work counts the sub-blocks a per-tile early exit (all 256 pixels done)
    would still evaluate — the work the CUDA kernel does on these inputs."""
    dev = payload.device
    feats = payload.reshape(-1, SUB, NFEAT)
    state = _init_state(tiles, tiles_x, width, height, dev)
    ox_all, oy_all = _tile_origin(tiles, tiles_x, dev)
    n_work = torch.zeros((), dtype=torch.long, device=dev)
    for d, tid in enumerate(_active_tiles(n_sub, tiles)):
        st = state[tid]                               # (A, NOUT, NPIX)
        n_work = n_work + (st[:, O_DONE].amin(dim=1) == 0).sum()
        feat = feats[first[tid].long() + d]           # (A, SUB, NFEAT)
        t_in = st[:, O_T][:, None, :]                 # (A, 1, NPIX)
        done = st[:, O_DONE][:, None, :]
        sub = _sub_forward(feat, ox_all[tid], oy_all[tid], t_in, done)
        acc = torch.einsum("asc,asp->acp", feat[..., F_R:F_PSIZE + 1], sub.w)
        new = st.clone()
        new[:, O_R:O_ACC + 1] = st[:, O_R:O_ACC + 1] + acc
        new[:, O_T], new[:, O_DONE] = _advance(sub, t_in, done)
        state[tid] = new
    return state, n_work


def _hs_prefix_sum(loc):
    """Inclusive prefix along the sub: the Hillis-Steele tree of
    _sub_cumsum_static."""
    k = 1
    while k < SUB:
        loc = torch.cat([loc[:, :k], loc[:, k:] + loc[:, :-k]], dim=1)
        k *= 2
    return loc


def composite_bwd_reference(payload, first, n_sub, res, cot, tiles: int,
                            tiles_x: int, width: int, height: int,
                            image_only: bool = False) -> torch.Tensor:
    """Plain backward of the compositor: dL/dpayload (B_cap, BLOCK, NFEAT)
    from the forward output `res` and its cotangent `cot` (tiles, NOUT,
    NPIX), in the arithmetic of msgs/kernels/composite.py:_bwd_kernel.

    With φ_i = Σ_c g_c·f_c over the colour columns (r g b, plus depth and
    psize unless image_only), prefix_i the running Σ_{j≤i} w_j·φ_j of the
    tile and S_i = (total_phi + T_final·g_T) − prefix_i:
    dα_i = T_i·φ_i − S_i/(1 − α_i) on alive, unmasked pairs; d{mean2D,
    conic, opacity} follow from the six pixel-monomial moments of
    dpower = dα·α·[α_raw < 0.99], d{colour column c} = Σ_p w·g_c. Columns
    past the computed ones, and the rows of sub-blocks after a tile
    saturated or outside every tile, are 0."""
    dev = payload.device
    nf = 3 if image_only else 5
    feats = payload.reshape(-1, SUB, NFEAT)
    dpay = torch.zeros_like(feats)
    pxl, pyl = _local_pix(dev)
    ox_all, oy_all = _tile_origin(tiles, tiles_x, dev)
    g_all, sfx_all = _bwd_constants(res, cot)
    state = _init_state(tiles, tiles_x, width, height, dev)
    t_run = state[:, O_T].clone()                     # (T, NPIX)
    done_run = state[:, O_DONE].clone()
    p_run = torch.zeros_like(t_run)                   # running Σ w·φ

    for d, tid in enumerate(_active_tiles(n_sub, tiles)):
        feat = feats[first[tid].long() + d]           # (A, SUB, NFEAT)
        t_in = t_run[tid][:, None, :]                 # (A, 1, NPIX)
        done = done_run[tid][:, None, :]
        g = g_all[tid]                                # (A, 5, NPIX)
        sub = _sub_forward(feat, ox_all[tid], oy_all[tid], t_in, done)
        mxl, myl, alpha, w = sub.mxl, sub.myl, sub.alpha, sub.w
        t_i = t_in * sub.cum_excl

        phi = g[:, None, 0] * feat[..., F_R, None]
        for c in range(1, nf):
            phi = phi + g[:, None, c] * feat[..., F_R + c, None]
        # Offset by the tile's earlier sub-blocks.
        prefix = p_run[tid][:, None, :] + _hs_prefix_sum(w * phi)
        suffix = sfx_all[tid][:, None, :] - prefix
        d_alpha = (t_i * phi - suffix / (1.0 - alpha)) * sub.alive * \
            sub.mask.to(torch.float32)
        unclamped = (sub.alpha_raw < ALPHA_MAX).to(torch.float32)
        d_power = d_alpha * alpha * unclamped

        dp_x = d_power * pxl
        dp_y = d_power * pyl
        d_q20 = (dp_x * pxl).sum(-1)                  # (A, SUB)
        d_q11 = (dp_x * pyl).sum(-1)
        d_q02 = (dp_y * pyl).sum(-1)
        d_q10 = dp_x.sum(-1)
        d_q01 = dp_y.sum(-1)
        d_q00 = d_power.sum(-1)
        cxx, cxy, cyy = feat[..., F_CXX], feat[..., F_CXY], feat[..., F_CYY]
        op = feat[..., F_OP]
        rows = torch.zeros_like(feat)
        rows[..., F_CXX] = -0.5 * (d_q20 - 2.0 * mxl * d_q10
                                   + mxl * mxl * d_q00)
        rows[..., F_CYY] = -0.5 * (d_q02 - 2.0 * myl * d_q01
                                   + myl * myl * d_q00)
        rows[..., F_CXY] = -(d_q11 - myl * d_q10 - mxl * d_q01
                             + mxl * myl * d_q00)
        rows[..., F_MX] = cxx * (d_q10 - mxl * d_q00) + \
            cxy * (d_q01 - myl * d_q00)
        rows[..., F_MY] = cyy * (d_q01 - myl * d_q00) + \
            cxy * (d_q10 - mxl * d_q00)
        rows[..., F_OP] = torch.where(
            op > 0.0, d_q00 / torch.clamp(op, min=1e-30), 0.0)
        for c in range(nf):
            rows[..., F_R + c] = (w * g[:, None, c]).sum(-1)
        # Sub-blocks past a saturated tile: the CUDA kernel stops there and
        # leaves the zeros; here they compute to zero (alive ≡ 0).
        dpay[first[tid].long() + d] = rows

        # Advance T and done exactly as the forward does.
        t_run[tid], done_run[tid] = _advance(sub, t_in, done)
        p_run[tid] = prefix[:, -1]
    return dpay.reshape(payload.shape)


def _bf16(x):
    """Round f32 → bf16 (round to nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def composite_bwd_bf16_reference(payload, first, n_sub, res, cot,
                                 tiles: int, tiles_x: int, width: int,
                                 height: int,
                                 image_only: bool = False) -> torch.Tensor:
    """Plain backward of the compositor under `bwd_bf16`, in the arithmetic
    of msgs/kernels/composite.py:_bwd_kernel with bwd_bf16=True
    (:502-519, :602-606, :624-639, :706-760). The forward recompute (α, T,
    alive, done) is `composite_bwd_reference`'s; what differs:

      φ = Σ_c bf16(f_c)·bf16(g_c)       (f32 sums of exact products)
      prefix = P + per-sub inclusive prefix of bf16(w·φ)
      the moments of the mean-centred dpower, dx = x − mxl, dy = y − myl:
        q00 = Σ bf16(dp), and with the basis [x, y, 1] (exact in bf16)
        m1 = Σ bf16(dp·dx)·[x, y, 1], m2 = Σ bf16(dp·dy)·[x, y, 1],
        q10 = m1[2], q01 = m2[2], q20 = m1[0] − mxl·q10,
        q11 = m1[1] − myl·q10, q02 = m2[1] − myl·q01,
        d_mx = cxx·q10 + cxy·q01, d_my = cyy·q01 + cxy·q10,
        d_cxx = −q20/2, d_cxy = −q11, d_cyy = −q02/2, d_op = q00/op;
      dfeat_c = Σ_p bf16(w)·bf16(g_c).
    Every product of two bf16 values (or of one and a basis value ≤ 15) is
    exact in f32, so versions of this function differ only in the order of
    f32 sums."""
    dev = payload.device
    nf = 3 if image_only else 5
    feats = payload.reshape(-1, SUB, NFEAT)
    dpay = torch.zeros_like(feats)
    pxl, pyl = _local_pix(dev)
    ox_all, oy_all = _tile_origin(tiles, tiles_x, dev)
    g_all, sfx_all = _bwd_constants(res, cot)
    state = _init_state(tiles, tiles_x, width, height, dev)
    t_run = state[:, O_T].clone()
    done_run = state[:, O_DONE].clone()
    p_run = torch.zeros_like(t_run)                   # running Σ bf16(w·φ)

    for d, tid in enumerate(_active_tiles(n_sub, tiles)):
        feat = feats[first[tid].long() + d]           # (A, SUB, NFEAT)
        t_in = t_run[tid][:, None, :]
        done = done_run[tid][:, None, :]
        g = _bf16(g_all[tid])                         # (A, 5, NPIX)
        sub = _sub_forward(feat, ox_all[tid], oy_all[tid], t_in, done)
        mxl, myl, alpha, w = sub.mxl, sub.myl, sub.alpha, sub.w
        t_i = t_in * sub.cum_excl

        fb = _bf16(feat[..., F_R:F_R + nf])           # (A, SUB, nf)
        phi = g[:, None, 0] * fb[..., 0, None]
        for c in range(1, nf):
            phi = phi + g[:, None, c] * fb[..., c, None]
        prefix = p_run[tid][:, None, :] + _hs_prefix_sum(_bf16(w * phi))
        suffix = sfx_all[tid][:, None, :] - prefix
        d_alpha = (t_i * phi - suffix / (1.0 - alpha)) * sub.alive * \
            sub.mask.to(torch.float32)
        unclamped = (sub.alpha_raw < ALPHA_MAX).to(torch.float32)
        d_power = d_alpha * alpha * unclamped

        m_dx = _bf16(d_power * sub.dx)
        m_dy = _bf16(d_power * sub.dy)
        q00 = _bf16(d_power).sum(-1)                  # (A, SUB)
        q10 = m_dx.sum(-1)
        q01 = m_dy.sum(-1)
        q20 = (m_dx * pxl).sum(-1) - mxl * q10
        q11 = (m_dx * pyl).sum(-1) - myl * q10
        q02 = (m_dy * pyl).sum(-1) - myl * q01
        cxx, cxy, cyy = feat[..., F_CXX], feat[..., F_CXY], feat[..., F_CYY]
        op = feat[..., F_OP]
        rows = torch.zeros_like(feat)
        rows[..., F_MX] = cxx * q10 + cxy * q01
        rows[..., F_MY] = cyy * q01 + cxy * q10
        rows[..., F_CXX] = -0.5 * q20
        rows[..., F_CXY] = -q11
        rows[..., F_CYY] = -0.5 * q02
        rows[..., F_OP] = torch.where(
            op > 0.0, q00 / torch.clamp(op, min=1e-30), 0.0)
        wb = _bf16(w)
        for c in range(nf):
            rows[..., F_R + c] = (wb * g[:, None, c]).sum(-1)
        dpay[first[tid].long() + d] = rows

        t_run[tid], done_run[tid] = _advance(sub, t_in, done)
        p_run[tid] = prefix[:, -1]
    return dpay.reshape(payload.shape)


def _check_payload(payload):
    if payload.dtype != torch.float32 or payload.shape[-1] != NFEAT:
        raise TypeError("composite: payload must be float32 (..., 12)")


def _composite_cuda(payload, first, n_sub, tiles: int, tiles_x: int,
                    width: int, height: int) -> torch.Tensor:
    _check_payload(payload)
    lib = _build.load()
    payload = payload.contiguous()
    first = first.to(torch.int32).contiguous()
    n_sub = n_sub.to(torch.int32).contiguous()
    out = torch.empty((tiles, NOUT, NPIX), dtype=torch.float32,
                      device=payload.device)
    err = lib.msgs_composite_fwd(payload.data_ptr(), first.data_ptr(),
                                 n_sub.data_ptr(), out.data_ptr(), tiles,
                                 tiles_x, width, height,
                                 _build.stream_ptr(payload))
    _build.check(err, "composite_fwd")
    _build.launch_counts["composite_fwd"] += 1
    return out


def _bwd_launch(name, payload, first, n_sub, res, cot, tiles: int,
                tiles_x: int, width: int, height: int,
                image_only: bool) -> torch.Tensor:
    """Launch the backward kernel `name` (composite_bwd or
    composite_bwd_bf16); both take the same arguments."""
    _check_payload(payload)
    for arg, x in (("res", res), ("cot", cot)):
        if x.dtype != torch.float32 or tuple(x.shape) != (tiles, NOUT, NPIX):
            raise TypeError(f"composite backward: {arg} must be float32 "
                            f"({tiles}, {NOUT}, {NPIX})")
    lib = _build.load()
    payload = payload.contiguous()
    first = first.to(torch.int32).contiguous()
    n_sub = n_sub.to(torch.int32).contiguous()
    res = res.contiguous()
    cot = cot.contiguous()
    dpay = torch.zeros_like(payload)
    err = getattr(lib, "msgs_" + name)(
        payload.data_ptr(), first.data_ptr(), n_sub.data_ptr(),
        res.data_ptr(), cot.data_ptr(), dpay.data_ptr(), tiles, tiles_x,
        width, height, int(image_only), _build.stream_ptr(payload))
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return dpay


def _composite_bwd_cuda(*args) -> torch.Tensor:
    """The exact backward kernel (composite_bwd.cu)."""
    return _bwd_launch("composite_bwd", *args)


def _composite_bwd_bf16_cuda(*args) -> torch.Tensor:
    """The bwd_bf16 backward kernel (composite_bwd_bf16.cu)."""
    return _bwd_launch("composite_bwd_bf16", *args)


def _on(payload, cuda_fn, plain_fn, *args):
    """The kernel for a CUDA payload, the plain version for a CPU one."""
    if payload.device.type == "cuda":
        return cuda_fn(payload, *args)
    if payload.device.type == "cpu":
        return plain_fn(payload, *args)
    raise ValueError(f"composite: unsupported device {payload.device}")


class _Composite(torch.autograd.Function):
    """The compositor with its backward. Residuals are the payload, the
    tile ranges and the forward output, as _composite_fwd saves them."""

    @staticmethod
    def forward(ctx, payload, first, n_sub, tiles, tiles_x, width, height,
                image_only, bwd_bf16, plain):
        args = (first, n_sub, tiles, tiles_x, width, height)
        if plain:
            out = _composite_plain(payload, *args)[0]
        else:
            out = _on(payload, _composite_cuda,
                      lambda *a: _composite_plain(*a)[0], *args)
        ctx.save_for_backward(payload, first, n_sub, out)
        ctx.static = (tiles, tiles_x, width, height, image_only, bwd_bf16,
                      plain)
        return out

    @staticmethod
    def backward(ctx, g_out):
        with span("msgs.composite_bwd"):
            payload, first, n_sub, out = ctx.saved_tensors
            tiles, tiles_x, width, height, image_only, bwd_bf16, plain = \
                ctx.static
            args = (first, n_sub, out, g_out.contiguous(), tiles, tiles_x,
                    width, height, image_only)
            ref, cuda = ((composite_bwd_bf16_reference,
                          _composite_bwd_bf16_cuda) if bwd_bf16 else
                         (composite_bwd_reference, _composite_bwd_cuda))
            dpay = ref(payload, *args) if plain else _on(payload, cuda, ref,
                                                         *args)
            return (dpay,) + (None,) * 9


def _apply(payload, sub_tile, sub_valid, tile_last_sub, tiles, tiles_x,
           width, height, image_only, bwd_bf16, plain):
    first, n_sub = tile_sub_ranges(sub_tile, sub_valid, tile_last_sub, tiles)
    return _Composite.apply(payload, first, n_sub, tiles, tiles_x, width,
                            height, bool(image_only), bool(bwd_bf16), plain)


def composite_reference(payload, sub_tile, sub_valid, tile_last_sub,
                        tiles: int, tiles_x: int, width: int, height: int,
                        image_only: bool = False,
                        bwd_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch compositor on any device: payload (B_cap, BLOCK, NFEAT)
    float32 → tiles_out (tiles, NOUT, NPIX), differentiable through the
    plain backward. With `image_only`, the depth and acc cotangents are
    taken as structurally zero in the backward, as in the JAX package; with
    `bwd_bf16` the backward is composite_bwd_bf16_reference."""
    return _apply(payload, sub_tile, sub_valid, tile_last_sub, tiles,
                  tiles_x, width, height, image_only, bwd_bf16, plain=True)


def composite(payload, sub_tile, sub_valid, tile_last_sub, tiles: int,
              tiles_x: int, width: int, height: int,
              image_only: bool = False, bwd_bf16: bool = False
              ) -> torch.Tensor:
    """Composite packed splat blocks into per-tile states (tiles, NOUT,
    NPIX), differentiable: the CUDA kernels (forward and backward) for a
    CUDA payload, the plain versions for a CPU payload."""
    return _apply(payload, sub_tile, sub_valid, tile_last_sub, tiles,
                  tiles_x, width, height, image_only, bwd_bf16, plain=False)
