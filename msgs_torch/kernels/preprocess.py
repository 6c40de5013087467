"""Per-Gaussian preprocessing: projection, EWA 2D covariance, SH color,
multi-scale splat selection and the tile rectangle, as plain torch ops.

Port of msgs/kernels/preprocess.py:144 `preprocess`. The arithmetic follows
the JAX version expression by expression (same operand order), so the
integer outputs (radii, tile rects) land on the same values. Autograd gives
the backward; the gradient path uses `torch.maximum` where JAX has
`jnp.maximum` (a tie splits the gradient in both) and detaches what JAX
stops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from msgs_torch.core.camera import Camera
from msgs_torch.core.sh import eval_sh

TILE = 16
NEAR_CULL = 0.2           # view-space z culling threshold (reference CUDA: 0.2)
LOWPASS = 0.3             # screen-space dilation added to cov2d diagonal
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
N_APP_LEVELS = 4          # occ_multiplier / dc_delta level buckets (scales 2/4/8/16)


def _build_cov6(scales, quats, modifier):
    """Packed symmetric 3-D covariance (xx, xy, xz, yy, yz, zz):
    Σ = R diag((m·s)²) Rᵀ, componentwise."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = (modifier * scales[:, 0]) ** 2
    s1 = (modifier * scales[:, 1]) ** 2
    s2 = (modifier * scales[:, 2]) ** 2
    sxx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    sxy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    sxz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    syy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    syz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    szz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([sxx, sxy, sxz, syy, syz, szz], dim=1)


class PreprocessOut(NamedTuple):
    means2d: torch.Tensor      # (N, 2) pixel coords
    depths: torch.Tensor       # (N,)  view-space z
    conics: torch.Tensor       # (N, 3) inverse 2D covariance (xx, xy, yy)
    colors: torch.Tensor       # (N, 3) RGB after SH + clamp
    opacities: torch.Tensor    # (N,)  effective opacity (after MS weights)
    radii: torch.Tensor        # (N,)  int32 screen radius, 0 if culled
    pixel_sizes: torch.Tensor  # (N,)  current footprint in pixels (2σ diameter)
    rect_min: torch.Tensor     # (N, 2) int32 inclusive tile bounds (x, y)
    rect_max: torch.Tensor     # (N, 2) int32 exclusive tile bounds (x, y)
    visible: torch.Tensor      # (N,)  bool — survives culling + MS selection


def _max(x, lo):
    """jnp.maximum semantics, gradient included: at a tie x == lo each side
    gets half (torch.clamp would pass all of it to x)."""
    return torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                            device=x.device))


def _clip(x, lo, hi):
    """jnp.clip semantics: min(max(x, lo), hi), bounds may be tensors."""
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(_max(x, lo), hi)


def _ewa_project(cov6, means3d, world_view_t, tanfovx, tanfovy, focal_x,
                 focal_y):
    """EWA splatting: screen-space 2D covariance of each 3D Gaussian, with
    and without the +0.3 px low-pass dilation, and the view-space means.
    Rows behind the near-cull plane get a safe unit depth (they are culled
    downstream)."""
    W = world_view_t[:3, :3].T                      # (3,3) view rotation
    t = means3d @ world_view_t[:3, :3] + world_view_t[3, :3]

    tz_real = t[:, 2]
    tz = torch.where(tz_real >= NEAR_CULL, tz_real, 1.0)
    lim_x = 1.3 * tanfovx
    lim_y = 1.3 * tanfovy
    txz = _clip(t[:, 0] / tz, -lim_x, lim_x) * tz
    tyz = _clip(t[:, 1] / tz, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txz * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tyz * inv_z2

    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]

    sxx, sxy, sxz, syy, syz, szz = cov6.unbind(1)
    v0x = sxx * m00 + sxy * m01 + sxz * m02
    v0y = sxy * m00 + syy * m01 + syz * m02
    v0z = sxz * m00 + syz * m01 + szz * m02
    v1x = sxx * m10 + sxy * m11 + sxz * m12
    v1y = sxy * m10 + syy * m11 + syz * m12
    v1z = sxz * m10 + syz * m11 + szz * m12
    cxx0 = m00 * v0x + m01 * v0y + m02 * v0z
    cxy = m00 * v1x + m01 * v1y + m02 * v1z
    cyy0 = m10 * v1x + m11 * v1y + m12 * v1z
    return cxx0 + LOWPASS, cxy, cyy0 + LOWPASS, cxx0, cyy0, t


def _to_i32(x):
    """float → int32 with XLA's NaN → 0 (torch leaves NaN casts undefined)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def preprocess(
    camera: Camera,
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
    live_mask: Optional[torch.Tensor] = None,
    means2d_probe: Optional[torch.Tensor] = None,
    # --- MS-GS extensions ---
    filter_small: bool = False,
    filter_large: bool = False,
    fade_ungated: bool = False,
    fade_size: float = 0.0,
    max_pixel_sizes: Optional[torch.Tensor] = None,
    min_pixel_sizes: Optional[torch.Tensor] = None,
    base_mask: Optional[torch.Tensor] = None,
    occ_multiplier: Optional[torch.Tensor] = None,   # (N, 4) in (0,1]
    dc_delta: Optional[torch.Tensor] = None,          # (N, 4, 3)
    reso_lvl: int = 0,
) -> PreprocessOut:
    """Project Gaussians to screen and build compositor inputs, with the
    MS-GS selection (see msgs/kernels/preprocess.py for the semantics of
    filter_small / filter_large / fade_size and the level buckets)."""
    N = means3d.shape[0]
    H, W_img = camera.height, camera.width
    dev = means3d.device

    if cov3d_precomp is not None:
        cov6 = cov3d_precomp
    else:
        cov6 = _build_cov6(scales, quats, scale_modifier)

    # Projection (row-vector convention: p_row @ M_T).
    hom = torch.cat([means3d, torch.ones((N, 1), dtype=means3d.dtype,
                                         device=dev)], dim=1)
    p_hom = hom @ camera.full_proj
    denom = torch.where(p_hom[:, 3] >= NEAR_CULL, p_hom[:, 3] + 1e-7, 1.0)
    p_w = 1.0 / denom
    ndc = p_hom[:, :3] * p_w[:, None]
    if means2d_probe is not None:
        ndc = torch.cat([ndc[:, :2] + means2d_probe, ndc[:, 2:]], dim=1)
    mean_px = torch.stack(
        [((ndc[:, 0] + 1.0) * W_img - 1.0) * 0.5,
         ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5], dim=1)

    focal_x = W_img / (2.0 * camera.tanfovx)
    focal_y = H / (2.0 * camera.tanfovy)
    cxx, cxy, cyy, cxx0, cyy0, t_view = _ewa_project(
        cov6, means3d, camera.world_view, camera.tanfovx, camera.tanfovy,
        focal_x, focal_y)
    depths = t_view[:, 2]

    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det > 0, det, 1.0)
    inv_det = 1.0 / det_safe
    conics = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(_max(mid * mid - det, 0.1))
    lam_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))

    # Footprint statistic from the undilated covariance.
    det0 = cxx0 * cyy0 - cxy * cxy
    mid0 = 0.5 * (cxx0 + cyy0)
    disc0 = torch.sqrt(_max(mid0 * mid0 - det0, 1e-8))
    pixel_size = 2.0 * torch.sqrt(_max(mid0 + disc0, 1e-8))

    visible = (depths > NEAR_CULL) & (det > 0)
    if live_mask is not None:
        visible = visible & live_mask

    # Color.
    if colors_precomp is not None:
        colors = colors_precomp
    else:
        sh = shs
        if dc_delta is not None and reso_lvl >= 1:
            bucket = min(max(int(reso_lvl) - 1, 0), N_APP_LEVELS - 1)
            sh = sh.clone()
            sh[:, 0, :] += dc_delta[:, bucket, :]
        dirs = means3d - camera.cam_center[None, :]
        dirs = dirs / torch.sqrt(
            torch.sum(dirs * dirs, dim=1, keepdim=True) + 1e-12)
        colors = _max(eval_sh(sh, dirs, active_sh_degree) + 0.5, 0.0)

    # Effective opacity: MS selection weights fold in multiplicatively.
    op = opacities
    if occ_multiplier is not None and reso_lvl >= 1:
        bucket = min(max(int(reso_lvl) - 1, 0), N_APP_LEVELS - 1)
        op = op * occ_multiplier[:, bucket]

    def _fade_weight(arg_num):
        """Linear ramp over `fade_size` pixels, or a hard step at 0 (a
        comparison, so it carries no gradient, as JAX's stop_gradient)."""
        if fade_size <= 0.0:
            return (arg_num >= 0.0).to(torch.float32)
        return _clip(arg_num / fade_size, 0.0, 1.0)

    if filter_small:
        if fade_ungated:
            applies = torch.ones((N,), dtype=torch.bool, device=dev)
        elif max_pixel_sizes is not None:
            applies = max_pixel_sizes >= 1.0
        else:
            applies = torch.zeros((N,), dtype=torch.bool, device=dev)
        w_small = torch.where(
            applies, _fade_weight(pixel_size - 1.0 + fade_size), 1.0)
        op = op * w_small
        visible = visible & (w_small > 0)
    if filter_large and min_pixel_sizes is not None:
        exempt = (base_mask if base_mask is not None
                  else torch.zeros((N,), dtype=torch.bool, device=dev))
        applies = (~exempt) & (min_pixel_sizes >= 0.0)
        thresh = 2.0 * min_pixel_sizes
        w_large = torch.where(
            applies, _fade_weight(thresh - pixel_size + fade_size), 1.0)
        op = op * w_large
        visible = visible & (w_large > 0)

    # Tile rectangle: the intersection of the tile-rects of the α ≥ 1/255
    # ellipse bbox and of the reference's square ceil(3σ) box.
    # The rectangle is integer structure: opacity, mean and radius enter it
    # detached, as JAX stops their gradients.
    k2 = 2.0 * torch.log(torch.clamp(op.detach(), min=1e-12) / ALPHA_MIN)
    k = torch.sqrt(torch.clamp(k2, min=0.0))
    ext_x = k * torch.sqrt(torch.clamp(cxx, min=0.0))
    ext_y = k * torch.sqrt(torch.clamp(cyy, min=0.0))
    tiles_x = (W_img + TILE - 1) // TILE
    tiles_y = (H + TILE - 1) // TILE
    mx = mean_px[:, 0].detach()
    my = mean_px[:, 1].detach()
    rad = radius.detach()
    top = float(tiles_x + tiles_y)

    def lo(m, e):
        return _to_i32(torch.clamp(torch.floor(
            torch.maximum(m - e, m - rad) / TILE), 0.0, top))

    def hi(m, e):
        return _to_i32(torch.clamp(torch.minimum(
            torch.floor((m + e) / TILE) + 1.0,
            torch.floor((m + rad + TILE - 1) / TILE)), 0.0, top))

    rmin_x = torch.clamp(lo(mx, ext_x), max=tiles_x)
    rmin_y = torch.clamp(lo(my, ext_y), max=tiles_y)
    rmax_x = torch.clamp(hi(mx, ext_x), max=tiles_x)
    rmax_y = torch.clamp(hi(my, ext_y), max=tiles_y)
    n_touched = (torch.clamp(rmax_x - rmin_x, min=0)
                 * torch.clamp(rmax_y - rmin_y, min=0))
    visible = visible & (n_touched > 0) & (k2 > 0)

    radii = _to_i32(torch.where(visible, radius, 0.0))
    return PreprocessOut(
        means2d=mean_px,
        depths=depths,
        conics=conics,
        colors=colors,
        opacities=op,
        radii=radii,
        pixel_sizes=torch.where(visible, pixel_size, 0.0),
        rect_min=torch.stack([rmin_x, rmin_y], dim=1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=1),
        visible=visible,
    )
