"""Insert-large-Gaussians: voxel-average aggregation of fine Gaussians into
coarse-level aggregates.

Port of msgs/ms/voxel.py. One pass on the device: contract the positions,
quantise them to voxel keys, sort the keys, average every attribute per
voxel, allocate capacity slots for the voxel means. The semantics are the
JAX package's:

  - contraction: rel = xyz/extent, then `2 − 1/rel` where rel > 1
  - voxel_reso on the contracted coordinates (the trainer passes
    0.02 · level/4)
  - every attribute (quaternions and logit opacities included) is averaged
    raw
  - merged scale ×= 2 / clip(pooled current-min-pixel-size, 0.25, 2), so
    the aggregate covers ≳2 px at the target resolution
  - new rows: pixel-size records −1, target_reso_lvl = level, base_mask
    False; every max screen radius is reset

The per-voxel sums run over the rows in key order (a stable sort, so each
voxel's rows in row order, as JAX's segment_sum adds them) with
`torch.segment_reduce`: a fixed order, no atomics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from msgs_torch.model.gaussians import GaussianState, _alloc_slots, _put

_GRID = 1024          # voxel coordinate range per axis after clipping (±512)
_INVALID = 2_147_000_000   # > the largest key, 1024³ − 1; < 2³¹


def _voxel_keys(xyz, mask, scene_extent, voxel_reso):
    rel = xyz / scene_extent
    rel = torch.where(rel > 1.0, 2.0 - 1.0 / rel, rel)
    coords = torch.floor(rel / voxel_reso).to(torch.int32)
    coords = torch.clamp(coords + _GRID // 2, 0, _GRID - 1)
    key = (coords[:, 0] * _GRID + coords[:, 1]) * _GRID + coords[:, 2]
    return torch.where(mask, key, _INVALID).to(torch.int32)


def insert_large_gaussians(st: GaussianState, mask: torch.Tensor,
                           cur_min_pixel_sizes: torch.Tensor, reso_lvl: int,
                           scene_extent: float, voxel_reso: float
                           ) -> Tuple[GaussianState, torch.Tensor,
                                      torch.Tensor]:
    """Aggregate the `mask`-selected live Gaussians into voxel means inserted
    as new rows tagged `reso_lvl`. Returns (state, touched, n_inserted),
    n_inserted a 0-d int32 tensor."""
    C = st.live.shape[0]
    dev = st.live.device
    mask = mask & st.live
    keys = _voxel_keys(st.xyz, mask, scene_extent, voxel_reso)

    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    valid = sk < _INVALID
    is_new = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        sk[1:] != sk[:-1]]) & valid
    n_voxels = torch.sum(is_new, dtype=torch.int32)
    # Voxel index per sorted row, nondecreasing; invalid rows (last) get C.
    vidx_sorted = torch.where(
        valid, torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1,
        C).to(torch.int32)
    # Segment v of the sorted rows is voxel v; segment C is the invalid
    # tail; voxels past n_voxels are empty segments.
    offsets = torch.cat([
        torch.searchsorted(vidx_sorted, torch.arange(
            C + 1, dtype=torch.int32, device=dev)),
        torch.full((1,), C, dtype=torch.int64, device=dev)])

    counts = torch.diff(offsets)[:C].to(torch.float32)
    denom = torch.clamp(counts, min=1.0)

    def pool(a):
        flat = a.reshape(C, -1)[order]
        s = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0)[:C]
        return (s / denom[:, None]).reshape((C,) + a.shape[1:])

    v_xyz = pool(st.xyz)
    v_dc = pool(st.features_dc)
    v_rest = pool(st.features_rest)
    v_op = pool(st.opacity)
    v_occ = pool(st.occ_multiplier)
    v_dcd = pool(st.dc_delta)
    v_rot = pool(st.rotation)
    v_scaling = pool(st.scaling)
    v_cur_min = pool(cur_min_pixel_sizes[:, None])[:, 0]

    # Grow each aggregate to ≳2 px at its target resolution.
    factor = 2.0 / torch.clamp(v_cur_min, 0.25, 2.0)
    v_scaling = v_scaling + torch.log(factor)[:, None]

    want = torch.arange(C, device=dev) < n_voxels
    slots, ok = _alloc_slots(st.live, want, copies=1)
    dst = slots[:, 0]
    st = st._replace(
        xyz=_put(st.xyz, dst, v_xyz),
        features_dc=_put(st.features_dc, dst, v_dc),
        features_rest=_put(st.features_rest, dst, v_rest),
        opacity=_put(st.opacity, dst, v_op),
        occ_multiplier=_put(st.occ_multiplier, dst, v_occ),
        dc_delta=_put(st.dc_delta, dst, v_dcd),
        rotation=_put(st.rotation, dst, v_rot),
        scaling=_put(st.scaling, dst, v_scaling),
        max_pixel_sizes=_put(st.max_pixel_sizes, dst, -1.0),
        min_pixel_sizes=_put(st.min_pixel_sizes, dst, -1.0),
        base_mask=_put(st.base_mask, dst, False),
        target_reso_lvl=_put(st.target_reso_lvl, dst, int(reso_lvl)),
        max_radii2d=torch.zeros_like(st.max_radii2d),
        xyz_grad_accum=_put(st.xyz_grad_accum, dst, 0.0),
        denom=_put(st.denom, dst, 0.0),
        live=_put(st.live, dst, True),
    )
    touched = _put(torch.zeros_like(st.live), dst, True)
    n_ins = torch.minimum(n_voxels, torch.sum(ok, dtype=torch.int32))
    return st, touched, n_ins
