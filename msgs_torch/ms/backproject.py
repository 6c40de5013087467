"""Screen-space back-projection insertion heuristic.

Port of msgs/ms/backproject.py, the functional equivalent of the reference's
`add_large_gaussian` (gaussian_model.py:707-787): the older large-Gaussian
creation path that pre-dates the voxel insert (ms/voxel.py). The reference's
current flow never calls it (only a commented block, train.py:389-413), and
neither trainer does; it is kept as part of the capability surface. It
average-pools the per-pixel accumulated splat-footprint map, finds the
blocks whose coverage is below a threshold, back-projects the block centres
at the pooled rendered depth into world space, and emits one Gaussian per
under-covered block, sized to the block's world extent.
"""
from __future__ import annotations

from typing import Tuple

import torch

from msgs_torch.core.sh import rgb2sh
from msgs_torch.core.transforms import inverse_sigmoid
from msgs_torch.model.gaussians import GaussianState, _alloc_slots, _put


def add_large_gaussians_backproject(
        st: GaussianState, camera, acc_pixel_size, depth, image, lvl, *,
        block: int = 4, coverage_threshold: float = 1.0
) -> Tuple[GaussianState, torch.Tensor, torch.Tensor]:
    """Insert one Gaussian per `block`×`block` pixel block whose mean
    accumulated splat footprint is below `coverage_threshold`.

    acc_pixel_size, depth: (H, W); image: (H, W, 3), the new rows' colour.
    Candidates are the blocks in row-major order, cut to the capacity C;
    they take free slots in that order while any are left. Returns (state,
    touched, n_inserted), n_inserted a 0-d int32 tensor."""
    H, W = acc_pixel_size.shape
    Hb, Wb = H // block, W // block
    C = st.live.shape[0]
    dev = st.live.device

    def pool(x):
        return x[:Hb * block, :Wb * block].reshape(
            Hb, block, Wb, block, -1).mean(dim=(1, 3))

    acc_b = pool(acc_pixel_size[..., None])[..., 0]
    depth_b = pool(depth[..., None])[..., 0]
    color_b = pool(image)

    under = (acc_b < coverage_threshold) & (depth_b > 0.0)

    # Back-project the block centres at the pooled depth: pixel → camera
    # ray by the tan-fov mapping; camera → world by the inverse view
    # transform (world_view is stored transposed, row-vector convention).
    ys = (torch.arange(Hb, device=dev) + 0.5) * block
    xs = (torch.arange(Wb, device=dev) + 0.5) * block
    px, py = torch.meshgrid(xs, ys, indexing="xy")
    ndc_x = (2.0 * px + 1.0) / W - 1.0
    ndc_y = (2.0 * py + 1.0) / H - 1.0
    cam_dir = torch.stack([ndc_x * camera.tanfovx, ndc_y * camera.tanfovy,
                           torch.ones_like(ndc_x)], dim=-1)
    cam_pos = cam_dir * depth_b[..., None]                     # (Hb, Wb, 3)
    R_wv = camera.world_view[:3, :3].T                         # world→view
    t_wv = camera.world_view[3, :3]
    world = (cam_pos - t_wv) @ R_wv                            # inverse map

    # World-space size of one block at that depth.
    pix_world = depth_b * (2.0 * camera.tanfovx) / W
    size = pix_world * block

    flat_mask = under.reshape(-1)
    flat_world = world.reshape(-1, 3)
    flat_color = color_b.reshape(-1, 3)
    flat_size = size.reshape(-1)
    M = flat_mask.shape[0]

    # One candidate row per capacity slot: the first C blocks, or every
    # block followed by rows that want nothing.
    if M >= C:
        want = flat_mask[:C]
        flat_world = flat_world[:C]
        flat_color = flat_color[:C]
        flat_size = flat_size[:C]
    else:
        want = torch.cat([flat_mask, flat_mask.new_zeros(C - M)])
        flat_world = torch.cat([flat_world, flat_world.new_zeros(C - M, 3)])
        flat_color = torch.cat([flat_color, flat_color.new_zeros(C - M, 3)])
        flat_size = torch.cat([flat_size, flat_size.new_zeros(C - M)])

    slots, ok = _alloc_slots(st.live, want, copies=1)
    dst = slots[:, 0]       # C: no slot (a row that is dropped)
    safe_size = torch.log(torch.clamp(flat_size, min=1e-6))
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    half = inverse_sigmoid(torch.tensor(0.5, device=dev))

    st = st._replace(
        xyz=_put(st.xyz, dst, flat_world),
        features_dc=_put(st.features_dc, dst, rgb2sh(flat_color)[:, None, :]),
        features_rest=_put(st.features_rest, dst, 0.0),
        scaling=_put(st.scaling, dst, safe_size[:, None].repeat(1, 3)),
        rotation=_put(st.rotation, dst, identity.expand(C, 4)),
        opacity=_put(st.opacity, dst, half.expand(C, 1)),
        max_pixel_sizes=_put(st.max_pixel_sizes, dst, -1.0),
        min_pixel_sizes=_put(st.min_pixel_sizes, dst, -1.0),
        base_mask=_put(st.base_mask, dst, False),
        target_reso_lvl=_put(st.target_reso_lvl, dst, int(lvl)),
        live=_put(st.live, dst, True),
    )
    touched = _put(torch.zeros_like(st.live), dst, True)
    return st, touched, torch.sum(ok, dtype=torch.int32)
