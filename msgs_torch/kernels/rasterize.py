"""Top-level differentiable rasterizer: preprocess → bin → gather →
composite → unpack.

Port of msgs/kernels/rasterize.py. Preprocess is torch ops (autograd gives
its backward); binning runs on detached inputs and yields integer
structure; the per-entry payload is a row gather from the small
per-Gaussian feature table whose backward sorts the entry gradients by
Gaussian id and sums each Gaussian's segment (`_GatherPayload`); the
compositor is a torch.autograd.Function over the CUDA kernels
(composite.py). Images are channels-last (H, W, 3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from msgs_torch.kernels import composite as comp
from msgs_torch.kernels.binning import BLOCK, bin_gaussians
from msgs_torch.kernels.preprocess import TILE, PreprocessOut, preprocess
from msgs_torch.trace import span


class RasterSettings(NamedTuple):
    """Static rasterizer configuration (fields as in the JAX package)."""
    filter_small: bool = False
    filter_large: bool = False
    entry_cap: int = 1 << 20
    # "auto" / "pallas": the CUDA compositor kernel for CUDA tensors (the
    # plain version for CPU tensors); "reference": the plain version on any
    # device. ("pallas" keeps the JAX package's name for its kernel path.)
    backend: str = "auto"
    # Only the image carries gradients: depth and acc_pixel_size are
    # detached, and the backward skips their cotangents (the trainer's
    # setting, as in the JAX package).
    image_grads_only: bool = False
    # None → binning.ROW_TIGHT_DEFAULT ("bands"); False → plain rects.
    row_tight: object = None
    # The JAX package's opt-in bf16 gradient variants (--fast_grads and
    # --bwd_bf16): the gather VJP's gradient columns rounded to bf16 before
    # the id sort and the segment sums; the compositor backward's φ, w·φ
    # prefix, moments and colour sums as bf16 contractions with f32
    # accumulation (composite_bwd_bf16.cu). Forward values are unchanged.
    grad_pack_bf16: bool = False
    bwd_bf16: bool = False
    # filter_small probe: fade on the current footprint alone.
    fade_ungated: bool = False


class RenderOutput(NamedTuple):
    image: torch.Tensor          # (H, W, 3)
    depth: torch.Tensor          # (H, W) alpha-weighted depth
    acc_pixel_size: torch.Tensor # (H, W) alpha-weighted splat footprint
    transmittance: torch.Tensor  # (H, W) final T (1 - alpha coverage)
    radii: torch.Tensor          # (N,) int32 screen radius, 0 if culled
    pixel_sizes: torch.Tensor    # (N,) current footprint; >0 iff contributing
    visible: torch.Tensor        # (N,) bool = radii > 0
    num_entries: torch.Tensor    # () int32 duplicated entries
    overflow: torch.Tensor       # () int32 entries dropped (grow entry_cap!)


class CompositeResult(NamedTuple):
    image: torch.Tensor          # (H, W, 3) without bg
    depth: torch.Tensor
    acc_pixel_size: torch.Tensor
    transmittance: torch.Tensor
    contributed: torch.Tensor    # (N,) bool
    num_entries: torch.Tensor
    overflow: torch.Tensor


def _sort_by_gid(gid, values):
    """(E, F) rows in order of their Gaussian id. Stable, so the order and
    every sum taken over it are deterministic."""
    return values[torch.argsort(gid, stable=True)]


def _segmented_sums(values, gid_starts):
    """Per-Gaussian sums of gid-sorted per-entry values: values (E, F) with
    Gaussian g's entries at [gid_starts[g], gid_starts[g+1]); returns
    (N, F). A segmented reduction in a fixed order, with no atomics and no
    differences of a global prefix (the JAX package's two-level triangular
    matmul prefix is a TPU mechanism; the contract is the sums)."""
    # Entries past gid_starts[N] (dummies, truncated) belong to no segment.
    # They must not form one: segment_reduce sums each segment serially
    # on one thread, and that tail holds hundreds of thousands of entries.
    return torch.segment_reduce(values, "sum", offsets=gid_starts.long(),
                                axis=0)


def gather_payload_vjp(g, gid, gid_starts, n_rows: int,
                       image_only: bool,
                       pack_bf16: bool = False) -> torch.Tensor:
    """Backward of the payload gather: per-entry cotangents g (E, NFEAT) →
    the feature table's gradient (n_rows, NFEAT). Only columns [0, F_B]
    (image_only) or [0, F_PSIZE] are differentiable; the pad columns and
    the sentinel row N get zeros. With `pack_bf16` (grad_pack_bf16) the
    columns are rounded to bf16, round to nearest even, before the sort
    and the f32 sums, as the JAX package's bf16-pair packing rounds them
    (msgs/kernels/rasterize.py:157-220)."""
    last = comp.F_B if image_only else comp.F_PSIZE
    cols = g[:, :last + 1]
    if pack_bf16:
        cols = cols.to(torch.bfloat16).to(g.dtype)
    g_sorted = _sort_by_gid(gid, cols)
    d_table = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                          device=g.device)
    d_table[:n_rows - 1, :last + 1] = _segmented_sums(g_sorted, gid_starts)
    return d_table


class _GatherPayload(torch.autograd.Function):
    """table[gid] whose backward is `gather_payload_vjp` (the JAX package's
    `_gather_payload` custom VJP): never an E-row scatter-add."""

    @staticmethod
    def forward(ctx, table, gid, gid_starts, image_only, pack_bf16=False):
        ctx.save_for_backward(gid, gid_starts)
        ctx.static = (table.shape[0], image_only, pack_bf16)
        return table[gid.long()]

    @staticmethod
    def backward(ctx, g):
        with span("msgs.gather_vjp"):
            gid, gid_starts = ctx.saved_tensors
            n_rows, image_only, pack_bf16 = ctx.static
            return (gather_payload_vjp(g.contiguous(), gid, gid_starts,
                                       n_rows, image_only, pack_bf16),
                    None, None, None, None)


def feature_table(pre) -> torch.Tensor:
    """The per-Gaussian feature table (N+1, NFEAT) in the comp.F_* column
    order. Row N is a zero sentinel whose opacity 0 fails the α ≥ 1/255
    test (dummy / truncated entries)."""
    N = pre.depths.shape[0]
    dev = pre.depths.device
    zeros = torch.zeros((N,), dtype=torch.float32, device=dev)
    cols = torch.stack([
        pre.means2d[:, 0], pre.means2d[:, 1],
        pre.conics[:, 0], pre.conics[:, 1], pre.conics[:, 2],
        pre.opacities,
        pre.colors[:, 0], pre.colors[:, 1], pre.colors[:, 2],
        pre.depths, pre.pixel_sizes,
    ] + [zeros] * (comp.NFEAT - comp.F_PSIZE - 1), dim=1)
    return torch.cat(
        [cols, torch.zeros((1, comp.NFEAT), dtype=torch.float32,
                           device=dev)], dim=0)


def gather_payload(pre, gauss_id, gid_starts, image_only: bool = False,
                   pack_bf16: bool = False) -> torch.Tensor:
    """Per-entry compositor payload (E_cap/BLOCK, BLOCK, NFEAT): rows of
    the feature table gathered by gauss_id, differentiable through
    `gather_payload_vjp`."""
    with span("msgs.gather"):
        rows = _GatherPayload.apply(feature_table(pre), gauss_id, gid_starts,
                                    bool(image_only), bool(pack_bf16))
        return rows.reshape(-1, BLOCK, comp.NFEAT)


def composite_pipeline(pre, width: int, height: int,
                       settings: RasterSettings) -> CompositeResult:
    """Everything after preprocess: bin → gather payload → composite →
    unpack."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    tiles = tiles_x * tiles_y
    dev = pre.depths.device

    # Binning yields integer structure only: it sees detached inputs.
    with span("msgs.binning"):
        binned = bin_gaussians(PreprocessOut(*(f.detach() for f in pre)),
                               width, height, settings.entry_cap,
                               row_tight=settings.row_tight)

    payload = gather_payload(pre, binned.gauss_id, binned.gid_starts,
                             settings.image_grads_only,
                             settings.grad_pack_bf16)

    with span("msgs.composite"):
        if settings.backend == "reference":
            fn = comp.composite_reference
        elif settings.backend in ("auto", "pallas"):
            fn = comp.composite
        else:
            raise ValueError(f"unknown backend {settings.backend!r}")
        tiles_out = fn(payload, binned.sub_tile, binned.sub_valid,
                       binned.tile_last_sub, tiles, tiles_x, width, height,
                       settings.image_grads_only, settings.bwd_bf16)

        # tiles_out: (T, NOUT, 256) channel-major → (H, W, NOUT); empty tiles
        # read as T=1 and nothing else.
        empty_init = torch.zeros((comp.NOUT,), dtype=torch.float32, device=dev)
        empty_init[comp.O_T] = 1.0
        tiles_out = torch.where(binned.tile_nonempty[:, None, None], tiles_out,
                                empty_init[:, None])
        full = tiles_out.reshape(tiles_y, tiles_x, comp.NOUT, TILE, TILE)
        full = full.permute(0, 3, 1, 4, 2).reshape(
            tiles_y * TILE, tiles_x * TILE, comp.NOUT)[:height, :width]

        # Contribution flags at the reference's preprocess-level semantics:
        # survived culling/filters and emitted ≥1 packed entry.
        contributed = torch.diff(binned.gid_starts) > 0

    return CompositeResult(
        image=full[..., comp.O_R:comp.O_B + 1],
        depth=full[..., comp.O_DEPTH],
        acc_pixel_size=full[..., comp.O_ACC],
        transmittance=full[..., comp.O_T],
        contributed=contributed,
        num_entries=binned.num_entries,
        overflow=binned.overflow,
    )


def rasterize(
    camera,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    *,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    quats: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_sh_degree=3,
    scale_modifier: float = 1.0,
    bg: Optional[torch.Tensor] = None,
    live_mask: Optional[torch.Tensor] = None,
    means2d_probe: Optional[torch.Tensor] = None,
    fade_size: float = 0.0,
    max_pixel_sizes: Optional[torch.Tensor] = None,
    min_pixel_sizes: Optional[torch.Tensor] = None,
    base_mask: Optional[torch.Tensor] = None,
    occ_multiplier: Optional[torch.Tensor] = None,
    dc_delta: Optional[torch.Tensor] = None,
    reso_lvl: int = 0,
    settings: RasterSettings = RasterSettings(),
) -> RenderOutput:
    """Render Gaussians on the device their tensors live on,
    differentiably: gradients reach every float input that requires them,
    `means2d_probe` (the screen-space densification gradient) included."""
    H, W = camera.height, camera.width

    with span("msgs.preprocess"):
        pre = preprocess(
            camera, means3d, opacities,
            shs=shs, colors_precomp=colors_precomp,
            scales=scales, quats=quats, cov3d_precomp=cov3d_precomp,
            active_sh_degree=active_sh_degree, scale_modifier=scale_modifier,
            live_mask=live_mask, means2d_probe=means2d_probe,
            filter_small=settings.filter_small,
            filter_large=settings.filter_large,
            fade_ungated=settings.fade_ungated,
            fade_size=fade_size, max_pixel_sizes=max_pixel_sizes,
            min_pixel_sizes=min_pixel_sizes, base_mask=base_mask,
            occ_multiplier=occ_multiplier, dc_delta=dc_delta,
            reso_lvl=reso_lvl)

    res = composite_pipeline(pre, W, H, settings)

    if settings.image_grads_only:
        # Only the image differentiates; the transmittance stays
        # differentiable for the T·bg background term below.
        res = res._replace(depth=res.depth.detach(),
                           acc_pixel_size=res.acc_pixel_size.detach())

    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=means3d.device)
    image = res.image + res.transmittance[..., None] * bg
    pixel_sizes = torch.where(res.contributed, pre.pixel_sizes, 0.0)

    return RenderOutput(
        image=image,
        depth=res.depth,
        acc_pixel_size=res.acc_pixel_size,
        transmittance=res.transmittance,
        radii=pre.radii,
        pixel_sizes=pixel_sizes,
        visible=pre.radii > 0,
        num_entries=res.num_entries,
        overflow=res.overflow,
    )
