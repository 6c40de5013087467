"""Sharded differentiable rendering and the sharded training step over the
gauss × tile mesh.

Port of msgs/dist/shard.py, on torch.distributed: every mesh cell is a
rank (mesh.py), and what JAX's shard_map does inside one program each rank
does for itself, with the collectives of collectives.py where JAX's sit.

  - Parameters, Adam moments and per-Gaussian side state are sharded on
    the capacity axis over **gauss** and replicated over **tile**.
    Preprocess runs on the local shard.
  - The image is cut into row stripes over **both** axes (n_stripes =
    n_gauss·n_tile); rank r composites stripe r.
  - **Bounded splat exchange**: each rank culls its shard per destination
    stripe and packs the compositor features of the survivors into
    fixed-capacity packets (`packet_cap` rows per source → stripe), moved
    by one all-to-all over the gauss axis. The tile-peers of a shard hold
    the same rows, so each serves only the stripes of its own tile column.
    Rows past the cap are counted (exch_overflow), like binning overflow.
    The receiver bins and depth-sorts the merged packets as the
    single-device path does. The packing is torch ops, as JAX's is XLA ops
    outside any Pallas kernel.
  - Binning and the compositor run per rank on the stripe-local frame, on
    the port's kernels (kernels/rasterize.py composite_pipeline).
  - SSIM runs on stripes extended by a 5-row halo, all-gathered over the
    world; edge stripes pad with zeros as the single-device convolution
    does. The halo's all-gather carries the halo rows' gradients back to
    their stripes.
  - Gradients: each rank backpropagates only its own terms of the loss
    (its stripe's L1 sum, its SSIM sum, its share of the loss multiplier);
    the all-to-all's backward returns packet gradients to their sources.
    A shard is replicated over the tile axis, and the transpose of that
    replication is a sum: the parameter and probe gradients are summed
    over the tile group before Adam, so tile-peers stay bit-identical.
  - The loss, L1, entry and overflow counts are summed over the world
    without autograd, so every rank reports (and the overflow guard
    decides on) the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from msgs_torch.dist import collectives as X
from msgs_torch.dist.mesh import Mesh
from msgs_torch.eval.metrics import ssim_map
from msgs_torch.kernels.preprocess import TILE, PreprocessOut, preprocess
from msgs_torch.kernels.rasterize import RasterSettings, composite_pipeline
from msgs_torch.model import gaussians as G
from msgs_torch.model.gaussians import GaussianConfig, GaussianState
from msgs_torch.train.loop import TrainState
from msgs_torch.train.optimizer import AdamState, OptimParams, \
    adam_update, group_lrs

# Packet column layout of the exchange (16 f32: everything the compositor
# pipeline consumes; radii stay local).
PKT = 16
(_PK_MX, _PK_MY, _PK_DEPTH, _PK_CXX, _PK_CXY, _PK_CYY, _PK_R, _PK_G, _PK_B,
 _PK_OP, _PK_PS, _PK_RMINX, _PK_RMINY, _PK_RMAXX, _PK_RMAXY,
 _PK_VALID) = range(PKT)

_SSIM_PAD = 5   # 11×11 window ⇒ 5-row halo

_I32 = torch.int32
_F32 = torch.float32


def _pack_features(pre) -> torch.Tensor:
    """(C_local, PKT) f32 packet rows of the local preprocess outputs."""
    f = lambda x: x.to(_F32)
    return torch.stack([
        pre.means2d[:, 0], pre.means2d[:, 1], pre.depths,
        pre.conics[:, 0], pre.conics[:, 1], pre.conics[:, 2],
        pre.colors[:, 0], pre.colors[:, 1], pre.colors[:, 2],
        pre.opacities, pre.pixel_sizes,
        f(pre.rect_min[:, 0]), f(pre.rect_min[:, 1]),
        f(pre.rect_max[:, 0]), f(pre.rect_max[:, 1]),
        f(pre.visible)], dim=1)


def _exchange_splats(pre, t_idx: int, n_gauss: int, n_tile: int,
                     tiles_y_local: int, packet_cap: int, axis):
    """Bounded all-to-all splat exchange over the gauss `axis` (module
    docstring). This rank (g', t) packs packets only for the n_gauss
    stripes of its tile column t, and one all-to-all delivers every
    shard's packet to its stripe's owner exactly once.

    Returns (pre_merged, gid_table, exch_overflow): a PreprocessOut of
    n_gauss·packet_cap rows in GLOBAL image coordinates (the receiver
    shifts them to its stripe), the send slot → local row map (for routing
    contribution flags back; C marks an empty slot), and the number of
    packet rows dropped to the cap.

    The per-(Gaussian, destination) rank is an O(C_local·n_gauss) cumsum
    and the slot scatter is the same size: fine to a few hundred shards."""
    C = pre.depths.shape[0]
    K = packet_cap
    dev = pre.depths.device
    # Destination stripe of gauss row g'' (at this rank's tile column).
    dstripes = (torch.arange(n_gauss, dtype=_I32, device=dev) * n_tile
                + t_idx)[None, :]                        # (1, n_gauss)
    s0 = torch.div(pre.rect_min[:, 1], tiles_y_local, rounding_mode="floor")
    s1 = -torch.div(-pre.rect_max[:, 1], tiles_y_local,
                    rounding_mode="floor")               # ceil div
    cover = (pre.visible[:, None] & (dstripes >= s0[:, None])
             & (dstripes < s1[:, None]))                 # (C, n_gauss)
    ci = cover.to(_I32)
    # The rows' running count per destination, scanned along the rows of
    # the (n_gauss, C) transpose: on CUDA torch's scan over the outer
    # dimension of a (C, n_gauss) tensor is far slower.
    rank = torch.cumsum(ci.t().contiguous(), dim=1, dtype=_I32).t() - ci
    ok = cover & (rank < K)
    exch_overflow = torch.clamp(ci.sum(dim=0, dtype=_I32) - K, min=0).sum(
        dtype=_I32)

    # Unique destination slots: an integer scatter builds slot → row (each
    # (row, destination) pair past the cap or not covering lands on a
    # sentinel slot of its own past the n_gauss·K real ones, sliced off:
    # no two writes meet); the feature move is one differentiable row
    # gather.
    M = n_gauss * K
    jvec = torch.arange(n_gauss, dtype=_I32, device=dev)[None, :]
    gids = torch.arange(C, dtype=_I32, device=dev)[:, None].expand_as(cover)
    dest = torch.where(ok, jvec * K + rank, M + gids * n_gauss + jvec)
    gid_table = torch.full((M + C * n_gauss,), C, dtype=_I32, device=dev)
    gid_table[dest.reshape(-1).long()] = gids.reshape(-1)
    gid_table = gid_table[:M]

    # Every empty slot reads a zero row of its own. The gather's backward
    # accumulates each row's slots in series: with one zero row shared by
    # every empty slot it ran serially over all of them.
    slot_rows = torch.where(
        gid_table < C, gid_table,
        C + torch.arange(M, dtype=_I32, device=dev)).long()
    feats = torch.cat([_pack_features(pre),
                       torch.zeros((M, PKT), dtype=_F32, device=dev)], dim=0)
    send = feats[slot_rows].reshape(n_gauss, K, PKT)
    recv = X.all_to_all(send, axis).reshape(M, PKT)

    i32 = lambda x: x.to(_I32)
    pre_merged = PreprocessOut(
        means2d=recv[:, _PK_MX:_PK_MY + 1],
        depths=recv[:, _PK_DEPTH],
        conics=recv[:, _PK_CXX:_PK_CYY + 1],
        colors=recv[:, _PK_R:_PK_B + 1],
        opacities=recv[:, _PK_OP],
        radii=torch.zeros((M,), dtype=_I32, device=dev),
        pixel_sizes=recv[:, _PK_PS],
        rect_min=i32(recv[:, _PK_RMINX:_PK_RMINY + 1].detach()),
        rect_max=i32(recv[:, _PK_RMAXX:_PK_RMAXY + 1].detach()),
        visible=recv[:, _PK_VALID].detach() > 0.5,
    )
    return pre_merged, gid_table, exch_overflow


def _striped_ssim(image, gt, stripe_idx: int, n_gauss: int, n_tile: int,
                  height: int, width: int, axis, row_mask=None):
    """This stripe's share of the image's mean SSIM, exact over stripes
    through a 5-row halo all-gathered over the world `axis`: interior
    stripe boundaries see their true neighbour rows, the image's top and
    bottom keep the zero padding of the single-device convolution. The
    shares of all stripes sum to the mean. `row_mask` (h_local, 1, 1)
    leaves the height-padding rows out of the mean (the rows themselves
    are zero already, which is the zero padding at the true bottom)."""
    n_stripes = n_gauss * n_tile
    pad = _SSIM_PAD
    h_local = image.shape[0]
    halos = torch.stack([image[:pad], image[-pad:], gt[:pad], gt[-pad:]])
    gathered = X.all_gather(halos, axis)    # (n_stripes, 4, pad, W, 3)
    zero = torch.zeros((pad,) + tuple(image.shape[1:]), dtype=image.dtype,
                       device=image.device)
    first = stripe_idx == 0
    last = stripe_idx == n_stripes - 1
    prev = gathered[max(stripe_idx - 1, 0)]
    nxt = gathered[min(stripe_idx + 1, n_stripes - 1)]
    img_ext = torch.cat([zero if first else prev[1], image,
                         zero if last else nxt[0]], dim=0)
    gt_ext = torch.cat([zero if first else prev[3], gt,
                        zero if last else nxt[2]], dim=0)
    smap = ssim_map(img_ext, gt_ext)[pad:pad + h_local]
    if row_mask is not None:
        smap = smap * row_mask
    return torch.sum(smap) / (height * width * image.shape[-1])


def padded_height(height: int, n_stripes: int) -> int:
    """Smallest stripe-divisible render height ≥ the true image height.
    Ground truth must arrive zero-padded to this height (pad_gt)."""
    unit = n_stripes * TILE
    return -(-height // unit) * unit


def auto_packet_cap(capacity: int, n_gauss: int, n_tile: int) -> int:
    """Default per-(source, stripe) splat-packet capacity: 4× the mean
    local load, rounded to 128. THE single definition — the trainer's
    overflow-doubling path (apps/train.py) must grow from this same base,
    or its 'growth' could rebuild to a bound ≤ build_sharded_loss's own
    and the overflow/discard loop would never converge."""
    c_local = capacity // n_gauss
    n_stripes = n_gauss * n_tile
    return max(128, -(-4 * c_local // n_stripes // 128) * 128)


def pad_gt(gt: torch.Tensor, height_padded: int) -> torch.Tensor:
    """Zero-pad a (H, W, 3) ground-truth image to the sharded render height
    (zero rows reproduce the single-device SSIM's zero padding at the
    bottom edge; the padding is masked out of every loss mean)."""
    extra = torch.zeros((height_padded - gt.shape[0],) + tuple(gt.shape[1:]),
                        dtype=gt.dtype, device=gt.device)
    return torch.cat([gt, extra], dim=0)


def _shift_stripe(pre, stripe_idx: int, tiles_y_local: int, h_local: int):
    """Re-express preprocess outputs in the stripe-local frame."""
    off = torch.tensor([0.0, float(stripe_idx * h_local)], dtype=_F32,
                       device=pre.means2d.device)
    means2d = pre.means2d - off[None, :]
    rmin_y = torch.clamp(pre.rect_min[:, 1] - stripe_idx * tiles_y_local,
                         0, tiles_y_local)
    rmax_y = torch.clamp(pre.rect_max[:, 1] - stripe_idx * tiles_y_local,
                         0, tiles_y_local)
    visible = pre.visible & (rmax_y > rmin_y)
    return pre._replace(
        means2d=means2d,
        rect_min=torch.stack([pre.rect_min[:, 0], rmin_y], dim=1),
        rect_max=torch.stack([pre.rect_max[:, 0], rmax_y], dim=1),
        visible=visible)


class _Reported(torch.autograd.Function):
    """`value` forward, the gradient of `local` backward: the whole loss
    as every rank reports it, differentiated as this rank's own terms."""

    @staticmethod
    def forward(ctx, local, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class ShardedAux(NamedTuple):
    l1: torch.Tensor            # () the image's L1, summed over the world
    radii: torch.Tensor         # (C_local,) this rank's gauss shard
    pixel_sizes_raw: torch.Tensor
    contributed: torch.Tensor   # (C_local,) OR over the tile-peers
    num_entries: torch.Tensor   # () over the world
    overflow: torch.Tensor      # binning overflow (grow entry_cap)
    exch_overflow: torch.Tensor # packet-exchange overflow (grow packet_cap)


def build_sharded_loss(mesh: Mesh, cfg: GaussianConfig,
                       settings: RasterSettings, height: int, width: int,
                       *, lambda_dssim: float = 0.2, loss_mult: float = 1.0,
                       reso_lvl: int = 0, fade_size: float = 0.0,
                       packet_cap: int = 0):
    """Returns loss_fn(params, side, probe, camera, gt_stripe) →
    (loss, ShardedAux) for this rank: params, side and probe are its gauss
    shard, gt_stripe its stripe of the padded ground truth (pad_gt).

    `loss` holds the whole image's loss (the same on every rank), and its
    gradient is this rank's own terms: backpropagated on every rank, with
    the parameter gradients then summed over the tile axis
    (`sharded_value_and_grad`), it gives the gradient of the whole loss.

    packet_cap bounds the per-(source, stripe) splat packets of the
    exchange (0 → auto_packet_cap); overflow surfaces in
    aux.exch_overflow."""
    n_gauss, n_tile = mesh.n_gauss, mesh.n_tile
    n_stripes = n_gauss * n_tile
    # Render at the stripe-divisible padded height; the padding rows carry
    # no splats (preprocess clips rects to the true height), are zeroed
    # before the loss and left out of every mean, so losses and gradients
    # match the single-device path at any image size.
    h_pad = padded_height(height, n_stripes)
    h_local = h_pad // n_stripes
    tiles_y_local = h_local // TILE
    if packet_cap <= 0:
        packet_cap = auto_packet_cap(cfg.capacity, n_gauss, n_tile)
    stripe_idx, t_idx = mesh.stripe_idx, mesh.t
    n_px = height * width * 3

    def loss_fn(params, side, probe, camera, gt_stripe):
        st = GaussianState(**params, **side)
        dev = st.xyz.device
        pre = preprocess(
            camera, st.xyz, st.act_opacity(),
            shs=st.shs(), scales=st.act_scales(), quats=st.act_rotation(),
            active_sh_degree=st.active_sh_degree,
            live_mask=st.live, means2d_probe=probe,
            filter_small=settings.filter_small,
            filter_large=settings.filter_large,
            fade_ungated=settings.fade_ungated,
            fade_size=fade_size,
            max_pixel_sizes=st.max_pixel_sizes,
            min_pixel_sizes=st.min_pixel_sizes,
            base_mask=st.base_mask,
            occ_multiplier=st.act_occ(cfg.multi_occ),
            dc_delta=st.dc_delta if cfg.multi_dc else None,
            reso_lvl=reso_lvl)

        pre_merged, gid_table, exch_overflow = _exchange_splats(
            pre, t_idx, n_gauss, n_tile, tiles_y_local, packet_cap,
            mesh.gauss)
        pre_stripe = _shift_stripe(pre_merged, stripe_idx, tiles_y_local,
                                   h_local)
        res = composite_pipeline(pre_stripe, width, h_local, settings)

        # Zero the height-padding rows (and, when height % TILE != 0, the
        # last tile row's pixels past `height`): masked pixels carry no
        # gradient, like pixels the single-device compositor never writes.
        g_rows = stripe_idx * h_local + torch.arange(h_local, device=dev)
        row_mask = (g_rows < height).to(_F32)[:, None, None]
        image = res.image * row_mask   # bg is zero in training
        l1_sum = torch.sum(torch.abs(image - gt_stripe))
        local = (1.0 - lambda_dssim) * l1_sum / n_px
        ssim_part = None
        if lambda_dssim != 0.0:
            ssim_part = _striped_ssim(image, gt_stripe, stripe_idx,
                                      n_gauss, n_tile, height, width,
                                      mesh.world, row_mask=row_mask)
            local = local - lambda_dssim * ssim_part
        local = local * loss_mult

        # The world's sums, in one collective (float64 holds the counts
        # exactly).
        sums = X.psum(torch.stack([
            l1_sum.detach().double(),
            (ssim_part.detach().double() if ssim_part is not None
             else torch.zeros((), dtype=torch.float64, device=dev)),
            res.num_entries.double(), res.overflow.double(),
            exch_overflow.double()]), mesh.world)
        l1 = (sums[0] / n_px).to(_F32)
        if lambda_dssim != 0.0:
            loss_val = ((1.0 - lambda_dssim) * l1
                        + lambda_dssim * (1.0 - sums[1].to(_F32)))
        else:
            loss_val = l1
        loss = _Reported.apply(local, loss_val * loss_mult)

        # Contribution flags go back through the all-to-all to each
        # packet's source, fold onto local rows, then OR over the
        # tile-peers (each served a different set of stripes).
        cback = X.all_to_all_raw(
            res.contributed.detach().to(_F32).reshape(n_gauss, packet_cap),
            mesh.gauss).reshape(-1)
        C = pre.depths.shape[0]
        contributed = torch.zeros((C + 1,), dtype=_F32, device=dev)
        contributed.index_add_(0, gid_table.long(), cback)
        contributed = X.psum(contributed[:C], mesh.tile) > 0

        aux = ShardedAux(
            l1=l1,
            radii=pre.radii,
            pixel_sizes_raw=pre.pixel_sizes.detach(),
            contributed=contributed,
            num_entries=sums[2].to(_I32),
            overflow=sums[3].to(_I32),
            exch_overflow=sums[4].to(_I32),
        )
        return loss, aux

    return loss_fn


def sharded_value_and_grad(mesh: Mesh, loss_fn, params: dict, side: dict,
                           probe: torch.Tensor, camera, gt_stripe):
    """((loss, aux), (grads, probe_grad)) of a build_sharded_loss loss_fn
    on this rank: jax.value_and_grad(loss_fn, argnums=(0, 2),
    has_aux=True) over the mesh. The gradients are of the whole loss with
    respect to this rank's shard, the same on every tile-peer. A parameter
    the render does not use gets zeros, as in JAX."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    probe = probe.detach().requires_grad_()
    xs = list(leaves.values()) + [probe]
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, side, probe, camera, gt_stripe)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    # The shard is replicated over the tile axis: the transpose of that
    # replication sums the gradients over it, in one collective. The
    # unused leaves are the same on every rank and skip it.
    used = [g for g in gs if g is not None]
    flat = X.psum(torch.cat([g.reshape(-1) for g in used]), mesh.tile)
    out, at = [], 0
    for g, x in zip(gs, xs):
        if g is None:
            out.append(torch.zeros_like(x))
        else:
            out.append(flat[at:at + g.numel()].reshape(g.shape))
            at += g.numel()
    *grads, probe_grad = out
    return (loss.detach(), aux), (dict(zip(leaves, grads)), probe_grad)


def _capacity_leading(x: torch.Tensor, capacity: int) -> bool:
    return x.dim() >= 1 and x.shape[0] == capacity


def _map_state(fn, state: TrainState) -> TrainState:
    return TrainState(
        gaussians=GaussianState(*(fn(x) for x in state.gaussians)),
        adam=AdamState(mu={k: fn(v) for k, v in state.adam.mu.items()},
                       nu={k: fn(v) for k, v in state.adam.nu.items()},
                       count=fn(state.adam.count)),
        iteration=fn(state.iteration))


def shard_train_state(state: TrainState, mesh: Mesh,
                      capacity: int) -> TrainState:
    """This rank's shard of a whole TrainState: every capacity-leading
    tensor (parameters, Adam moments, side state) sliced to the rank's
    gauss rows, scalars kept, all on the mesh's device. The inverse (for
    the structural steps and checkpoints) is `fetch_train_state`."""
    rows = mesh.gauss_rows(capacity)

    def place(x):
        x = x[rows] if _capacity_leading(x, capacity) else x
        return x.to(mesh.device).clone()

    return _map_state(place, state)


def fetch_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole TrainState on every rank, all-gathered over the gauss
    axis from the rank shards: the cold path's bridge for structural
    steps (run on the whole state at their every-100-iterations cadence,
    then resharded by shard_train_state)."""
    c_local = int(state.gaussians.xyz.shape[0])

    def fetch(x):
        if not _capacity_leading(x, c_local):
            return x
        return X.gather(x, mesh.gauss).reshape((-1,) + tuple(x.shape[1:]))

    return _map_state(fetch, state)


def broadcast_train_state(state: TrainState, mesh: Mesh,
                          src: int = 0) -> TrainState:
    """Rank `src`'s whole TrainState on every rank (the others pass a
    state of the same shapes): the cold path's structural steps run on one
    rank and reach the others bit for bit."""
    return _map_state(lambda x: X.broadcast(x, mesh.world, src), state)


def state_as_dicts(st: GaussianState):
    params = st.params()
    side = {
        "live": st.live, "max_radii2d": st.max_radii2d,
        "max_pixel_sizes": st.max_pixel_sizes,
        "min_pixel_sizes": st.min_pixel_sizes,
        "base_mask": st.base_mask, "target_reso_lvl": st.target_reso_lvl,
        "xyz_grad_accum": st.xyz_grad_accum, "denom": st.denom,
        "active_sh_degree": st.active_sh_degree,
    }
    return params, side


def build_sharded_train_step(mesh: Mesh, cfg: GaussianConfig,
                             op: OptimParams, settings: RasterSettings,
                             height: int, width: int, *,
                             spatial_lr_scale: float = 1.0,
                             reso_lvl: int = 0, loss_mult: float = 1.0,
                             lambda_dssim: float = 0.2,
                             fade_size: float = 0.0,
                             packet_cap: int = 0):
    """The sharded train step on this rank: sharded render and loss,
    backward (gradients land on the rank's shard, summed over the tile
    axis), Adam, side-state updates. Returns step(state, camera,
    gt_stripe, do_px_update, do_densify_stats, do_base_mask,
    ms_lr_active) → (new state, metrics), `state` the rank's shard
    (shard_train_state).

    `gt_stripe` is the rank's stripe of the ground truth zero-padded to
    `padded_height(height, n_stripes)` (pad_gt). The semantics are the
    single-device `train_step`'s (train/loop.py), the overflow-discard
    guard and the statistic gates included; the guard tests binning and
    exchange overflow summed over the mesh, so every rank keeps or
    discards the same step."""
    loss_fn = build_sharded_loss(
        mesh, cfg, settings, height, width, reso_lvl=reso_lvl,
        loss_mult=loss_mult, lambda_dssim=lambda_dssim, fade_size=fade_size,
        packet_cap=packet_cap)

    def step(state: TrainState, camera, gt, do_px_update=True,
             do_densify_stats=True, do_base_mask=False,
             ms_lr_active=False):
        st = state.gaussians
        dev = st.xyz.device
        params, side = state_as_dicts(st)
        probe = torch.zeros((st.xyz.shape[0], 2), dtype=_F32, device=dev)
        (loss, aux), (grads, probe_grad) = sharded_value_and_grad(
            mesh, loss_fn, params, side, probe, camera, gt)

        with torch.no_grad():
            lrs = group_lrs(op, spatial_lr_scale, state.iteration,
                            ms_lr_active=ms_lr_active)
            new_params, new_adam = adam_update(params, grads, state.adam,
                                               lrs)
            new = st.with_params(new_params)

            gate = lambda b: torch.as_tensor(b, device=dev)
            vis = aux.radii > 0
            px = torch.where(aux.contributed & gate(do_px_update),
                             aux.pixel_sizes_raw, 0.0)
            new = G.update_pixel_sizes(new, px, reso_lvl, cfg.reso_lvls)
            ds = gate(do_densify_stats)
            new = G.update_max_radii(new, aux.radii, vis & ds)
            new = G.add_densification_stats(new, probe_grad * ds, vis & ds,
                                            reso_lvl)
            new = G.update_base_mask(new, vis & gate(do_base_mask))

            # Overflow safety, as in the single-device step: a step whose
            # binning or packet exchange truncated entries rendered a
            # wrong image; every rank discards it (the host grows
            # entry_cap / packet_cap and the schedule moves on).
            ok = (aux.overflow + aux.exch_overflow) == 0
            keep = lambda a, b: torch.where(ok, a, b)
            new = GaussianState(*(keep(a, b) for a, b in zip(new, st)))
            new_adam = AdamState(
                mu={k: keep(v, state.adam.mu[k])
                    for k, v in new_adam.mu.items()},
                nu={k: keep(v, state.adam.nu[k])
                    for k, v in new_adam.nu.items()},
                count=keep(new_adam.count, state.adam.count))

            # The tile-peers hold the same rows: count one shard each.
            num_live = X.psum(new.num_live, mesh.gauss)
            metrics = {"loss": loss, "l1": aux.l1,
                       "num_entries": aux.num_entries,
                       "overflow": aux.overflow,
                       "exch_overflow": aux.exch_overflow,
                       "num_live": num_live}
        return TrainState(gaussians=new, adam=new_adam,
                          iteration=state.iteration + 1), metrics

    return step
