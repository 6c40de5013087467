"""Fixed-capacity Gaussian model state: fields and activations.

Port of msgs/model/gaussians.py:37-130. State lives in capacity-`C` tensors
with a `live` mask; the parameter storage conventions are the reference's:
  scaling   — log-space (activation exp)
  rotation  — unnormalized quaternion wxyz (activation L2-normalize)
  opacity   — logit (activation sigmoid)
  occ_multiplier — logit if multi_occ else raw 1.0
Also here: initialisation from a point cloud (`create_from_points`, scales
from the 3-NN mean squared distance), the per-step side-state updates of the
train step (pixel-size records, max radii, densification statistics, base
mask) and the structural mutations (clone, split, prune, grow, opacity
reset, radial crop). Each mutation returns a new state (the inputs are not
modified) and, where rows were replaced, a `touched` mask whose Adam moments
the caller zeroes.

The JAX package writes allocated rows with `.at[dst].set(..., mode="drop")`,
`dst == C` meaning "dropped". Here `_put` scatters into a copy with one
spare row C that absorbs the dropped writes, so no index is ever out of
range and nothing waits on the device for a count.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.core.sh import num_sh_coeffs, rgb2sh
from msgs_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from msgs_torch.kernels.knn import knn_mean_sq_dist

N_APP_LEVELS = 4   # occ/dc appearance buckets (scales 2/4/8/16)


class GaussianConfig(NamedTuple):
    """Static model configuration (hashable)."""
    sh_degree: int = 3
    reso_lvls: int = 1
    multi_occ: bool = False
    multi_dc: bool = False
    capacity: int = 1 << 20


class GaussianState(NamedTuple):
    # --- learnable parameters (raw storage) ---
    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log
    rotation: torch.Tensor       # (C, 4) wxyz
    opacity: torch.Tensor        # (C, 1) logit
    occ_multiplier: torch.Tensor # (C, 4)
    dc_delta: torch.Tensor       # (C, 4, 3)
    # --- per-Gaussian side state ---
    live: torch.Tensor           # (C,) bool
    max_radii2d: torch.Tensor    # (C,) f32
    max_pixel_sizes: torch.Tensor  # (C,) f32, -1 = uninitialized
    min_pixel_sizes: torch.Tensor  # (C,) f32, -1 = uninitialized
    base_mask: torch.Tensor      # (C,) bool — visible at coarsest level
    target_reso_lvl: torch.Tensor  # (C,) int32
    xyz_grad_accum: torch.Tensor  # (C, L) per-level densification stats
    denom: torch.Tensor          # (C, L)
    # --- scalars ---
    active_sh_degree: torch.Tensor  # () int32

    @property
    def num_live(self):
        return torch.sum(self.live, dtype=torch.int32)

    def params(self) -> dict:
        """The optimized fields, as a dict keyed by field name."""
        return {k: getattr(self, k) for k in PARAM_FIELDS}

    def with_params(self, p: dict) -> "GaussianState":
        return self._replace(**p)

    # --- activations ---
    def act_scales(self, modifier: float = 1.0):
        return torch.exp(self.scaling) * modifier

    def act_rotation(self):
        return self.rotation / (torch.linalg.norm(
            self.rotation, dim=-1, keepdim=True) + 1e-12)

    def act_opacity(self):
        return torch.sigmoid(self.opacity)[:, 0]

    def act_occ(self, multi_occ: bool):
        if multi_occ:
            return torch.sigmoid(self.occ_multiplier)
        return torch.ones_like(self.occ_multiplier)

    def shs(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)


PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "occ_multiplier", "dc_delta")


def empty_state(cfg: GaussianConfig, device=None) -> GaussianState:
    dev = resolve_device(device)
    C, L = cfg.capacity, cfg.reso_lvls
    K = num_sh_coeffs(cfg.sh_degree)
    occ_init = (float(inverse_sigmoid(torch.tensor(0.99, dtype=torch.float32)))
                if cfg.multi_occ else 1.0)
    f32 = dict(dtype=torch.float32, device=dev)
    rotation = torch.zeros((C, 4), **f32)
    rotation[:, 0] = 1.0
    return GaussianState(
        xyz=torch.zeros((C, 3), **f32),
        features_dc=torch.zeros((C, 1, 3), **f32),
        features_rest=torch.zeros((C, K - 1, 3), **f32),
        scaling=torch.full((C, 3), -10.0, **f32),
        rotation=rotation,
        opacity=torch.zeros((C, 1), **f32),
        occ_multiplier=torch.full((C, N_APP_LEVELS), occ_init, **f32),
        dc_delta=torch.zeros((C, N_APP_LEVELS, 3), **f32),
        live=torch.zeros((C,), dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros((C,), **f32),
        max_pixel_sizes=torch.full((C,), -1.0, **f32),
        min_pixel_sizes=torch.full((C,), -1.0, **f32),
        base_mask=torch.zeros((C,), dtype=torch.bool, device=dev),
        target_reso_lvl=torch.zeros((C,), dtype=torch.int32, device=dev),
        xyz_grad_accum=torch.zeros((C, L), **f32),
        denom=torch.zeros((C, L), **f32),
        active_sh_degree=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_from_numpy(arrays: dict, device=None) -> GaussianState:
    """A GaussianState from numpy arrays keyed by field name — how weights
    carry across from the JAX package:
    `state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()})`.
    Every field must be present."""
    dev = resolve_device(device)
    missing = set(GaussianState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {sorted(missing)}")
    return GaussianState(**{
        k: torch.tensor(np.array(arrays[k]), device=dev)
        for k in GaussianState._fields})


def create_from_points(cfg: GaussianConfig, points: np.ndarray,
                       colors: np.ndarray, device=None) -> GaussianState:
    """Initialise from an SfM point cloud: colour → SH DC, scale from the
    3-NN mean squared distance, identity rotation, opacity logit(0.1)."""
    st = empty_state(cfg, device)
    dev = st.xyz.device
    n = points.shape[0]
    if n > cfg.capacity:
        raise ValueError(f"{n} points exceed capacity {cfg.capacity}")
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    d2 = torch.clamp(knn_mean_sq_dist(pts, k=3), min=1e-7)
    st.xyz[:n] = pts
    st.features_dc[:n, 0] = rgb2sh(cols)
    st.scaling[:n] = torch.log(torch.sqrt(d2))[:, None].expand(n, 3)
    st.opacity[:n] = inverse_sigmoid(
        torch.tensor(0.1, dtype=torch.float32, device=dev))
    st.live[:n] = True
    return st


def one_up_sh_degree(st: GaussianState, max_degree: int) -> GaussianState:
    return st._replace(active_sh_degree=torch.clamp(
        st.active_sh_degree + 1, max=max_degree))


def add_densification_stats(st: GaussianState, probe_grad: torch.Tensor,
                            update_mask: torch.Tensor, lvl) -> GaussianState:
    """Accumulate screen-space gradient norms per level."""
    pg = probe_grad[:, :2]
    norms = torch.sqrt(torch.sum(pg * pg, dim=1))
    m = update_mask & st.live
    lvl_oh = torch.nn.functional.one_hot(
        torch.as_tensor(lvl, device=st.denom.device).long(),
        st.denom.shape[1]).to(torch.float32)
    return st._replace(
        xyz_grad_accum=st.xyz_grad_accum
        + (m * norms)[:, None] * lvl_oh[None, :],
        denom=st.denom + m.to(torch.float32)[:, None] * lvl_oh[None, :],
    )


def update_max_radii(st: GaussianState, radii, visible) -> GaussianState:
    return st._replace(max_radii2d=torch.where(
        visible & st.live,
        torch.maximum(st.max_radii2d, radii.to(torch.float32)),
        st.max_radii2d))


def update_pixel_sizes(st: GaussianState, pixel_sizes, lvl: int,
                       reso_lvls: int) -> GaussianState:
    """Running screen-footprint extrema, for rows whose own target level is
    the rendered level only: the max side decays ×0.95 then takes the max
    (renders at lvl > 0), the min side inflates ×1.05 then takes the min
    (renders at lvl < L−1); uninitialised (−1) rows adopt the first value."""
    seen = (pixel_sizes > 0) & st.live & (st.target_reso_lvl == lvl)
    upd_max = seen & (lvl > 0)
    decayed = torch.where(st.max_pixel_sizes >= 0,
                          st.max_pixel_sizes * 0.95, st.max_pixel_sizes)
    new_max = torch.where(
        upd_max,
        torch.where(decayed >= 0, torch.maximum(decayed, pixel_sizes),
                    pixel_sizes),
        st.max_pixel_sizes)

    upd_min = seen & (lvl < reso_lvls - 1)
    inflated = torch.where(st.min_pixel_sizes >= 0,
                           st.min_pixel_sizes * 1.05, st.min_pixel_sizes)
    new_min = torch.where(
        upd_min,
        torch.where(inflated >= 0, torch.minimum(inflated, pixel_sizes),
                    pixel_sizes),
        st.min_pixel_sizes)
    return st._replace(max_pixel_sizes=new_max, min_pixel_sizes=new_min)


def update_base_mask(st: GaussianState, visible) -> GaussianState:
    """Record coarsest-level visibility (preserve_large)."""
    return st._replace(base_mask=st.base_mask | (visible & st.live))


# ---------------------------------------------------------------------------
# Structural mutations
# ---------------------------------------------------------------------------

def _put(arr: torch.Tensor, dst: torch.Tensor, vals) -> torch.Tensor:
    """A copy of `arr` with arr[dst[i]] = vals[i] wherever dst[i] < C; rows
    with dst[i] == C are dropped (JAX's mode="drop"). `vals` is (C, ...) or
    a scalar. Kept destinations are distinct, so the result is
    deterministic."""
    C = arr.shape[0]
    if not torch.is_tensor(vals) or vals.dim() == 0:
        vals = torch.full_like(arr, vals)
    out = torch.cat([arr, arr[:1]], dim=0)
    out.index_copy_(0, dst.long(), vals.to(arr.dtype))
    return out[:C]


def _alloc_slots(live: torch.Tensor, want_mask: torch.Tensor,
                 copies: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign `copies` free slots to each row selected by want_mask.

    Returns (slots (C, copies) int32, the destination row per (source,
    copy) with C = dropped, and ok (C,) bool, the candidate got its slots).
    Free slots go out in row order; candidates beyond the free capacity are
    dropped, also in row order."""
    C = live.shape[0]
    # Free rows first, in row order (stable), then the live ones.
    order = torch.argsort(live.to(torch.int8), stable=True)
    n_free = torch.sum(~live, dtype=torch.int32)
    idx = torch.arange(C, device=live.device)
    free = torch.where(idx < n_free, order, C).to(torch.int32)
    rank = torch.cumsum(want_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = want_mask & ((rank + 1) * copies <= n_free)
    base = rank * copies
    slots = torch.stack(
        [torch.where(ok, free[torch.clamp(base + i, 0, C - 1).long()], C)
         for i in range(copies)], dim=1).to(torch.int32)
    return slots, ok


def _copy_selected(st: GaussianState, src_mask: torch.Tensor,
                   slots: torch.Tensor, copy: int) -> GaussianState:
    """Copy every field of the rows holding a slot in column `copy` of
    `slots` to that slot; the new rows start with cleared statistics."""
    dst = slots[:, copy]
    cp = lambda a: _put(a, dst, a)
    return st._replace(
        xyz=cp(st.xyz), features_dc=cp(st.features_dc),
        features_rest=cp(st.features_rest), scaling=cp(st.scaling),
        rotation=cp(st.rotation), opacity=cp(st.opacity),
        occ_multiplier=cp(st.occ_multiplier), dc_delta=cp(st.dc_delta),
        max_radii2d=cp(st.max_radii2d),
        max_pixel_sizes=cp(st.max_pixel_sizes),
        min_pixel_sizes=cp(st.min_pixel_sizes),
        base_mask=_put(st.base_mask, dst, False),
        target_reso_lvl=cp(st.target_reso_lvl),
        xyz_grad_accum=_put(st.xyz_grad_accum, dst, 0.0),
        denom=_put(st.denom, dst, 0.0),
        live=_put(st.live, dst, True),
    )


def _touched(live: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    t = torch.zeros_like(live)
    for i in range(slots.shape[1]):
        t = _put(t, slots[:, i], True)
    return t


def densify_clone(st: GaussianState, grads, grad_threshold, percent_dense,
                  scene_extent) -> Tuple[GaussianState, torch.Tensor]:
    """Clone small under-reconstructed level-0 Gaussians. Returns (state,
    touched: the rows whose Adam moments must be zeroed)."""
    small = torch.amax(st.act_scales(), dim=1) <= percent_dense * scene_extent
    cand = (st.live & (grads >= grad_threshold) & small
            & (st.target_reso_lvl == 0))
    slots, _ = _alloc_slots(st.live, cand, copies=1)
    st = _copy_selected(st, cand, slots, 0)
    return st, _touched(st.live, slots)


def densify_split(st: GaussianState, grads, grad_threshold, percent_dense,
                  scene_extent, key: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[GaussianState, torch.Tensor]:
    """Split large over-reconstructed level-0 Gaussians into 2 children
    sampled from the parent distribution; child scale and pixel-size
    records ÷ 1.6; the parent is pruned.

    The child offsets are R·(n ⊙ scale) with n standard normal: drawn from
    the generator `key`, or taken from `noise` (2, C, 3), which is how the
    tests pass in JAX's own draws."""
    n_split = 2
    big = torch.amax(st.act_scales(), dim=1) > percent_dense * scene_extent
    cand = (st.live & (grads >= grad_threshold) & big
            & (st.target_reso_lvl == 0))
    slots, ok = _alloc_slots(st.live, cand, copies=n_split)

    C = st.live.shape[0]
    scales = st.act_scales()
    R = quat_to_rotmat(st.act_rotation())
    div = 0.8 * n_split
    for i in range(n_split):
        st = _copy_selected(st, cand, slots, i)
        n = (noise[i] if noise is not None else torch.randn(
            (C, 3), generator=key, device=scales.device))
        offset = torch.einsum("nij,nj->ni", R, n * scales)
        dst = slots[:, i]
        st = st._replace(
            xyz=_put(st.xyz, dst, st.xyz + offset),
            scaling=_put(st.scaling, dst, torch.log(scales / div)),
            max_pixel_sizes=_put(st.max_pixel_sizes, dst, torch.where(
                st.max_pixel_sizes >= 0, st.max_pixel_sizes / div,
                st.max_pixel_sizes)),
            min_pixel_sizes=_put(st.min_pixel_sizes, dst, torch.where(
                st.min_pixel_sizes >= 0, st.min_pixel_sizes / div,
                st.min_pixel_sizes)),
        )
    st = st._replace(live=st.live & ~ok)
    return st, _touched(st.live, slots)


def prune(st: GaussianState, prune_mask: torch.Tensor) -> GaussianState:
    return st._replace(live=st.live & ~prune_mask)


def densify_and_prune(st: GaussianState, key=None, *, grad_threshold: float,
                      min_opacity: float, scene_extent: float,
                      max_screen_size: float, percent_dense: float,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[GaussianState, torch.Tensor]:
    """Level-0 densify + prune: clone, split, prune by opacity (and, with
    max_screen_size > 0, screen and world size) among level-0 rows only;
    clears the level-0 gradient statistics and every max screen radius.
    Returns (state, touched)."""
    grads = st.xyz_grad_accum[:, 0] / torch.clamp(st.denom[:, 0], min=1.0)
    grads = torch.where((st.denom[:, 0] > 0) & (st.target_reso_lvl == 0),
                        grads, 0.0)

    st, touched_c = densify_clone(st, grads, grad_threshold, percent_dense,
                                  scene_extent)
    st, touched_s = densify_split(st, grads, grad_threshold, percent_dense,
                                  scene_extent, key, noise)

    prune_mask = st.act_opacity() < min_opacity
    lvl0 = st.target_reso_lvl == 0
    if max_screen_size > 0:
        big_screen = st.max_radii2d > max_screen_size
        big_world = torch.amax(st.act_scales(), dim=1) > 0.1 * scene_extent
        prune_mask = prune_mask | big_screen | big_world
    # Inserted coarse aggregates (level > 0) are never pruned here.
    st = prune(st, prune_mask & lvl0 & st.live)

    acc = st.xyz_grad_accum.clone()
    acc[:, 0] = 0.0
    den = st.denom.clone()
    den[:, 0] = 0.0
    st = st._replace(xyz_grad_accum=acc, denom=den,
                     max_radii2d=torch.zeros_like(st.max_radii2d))
    return st, touched_c | touched_s


def grow_large_gaussians(st: GaussianState, lvl: int, *,
                         grad_threshold: float
                         ) -> Tuple[GaussianState, torch.Tensor]:
    """Per-level creation of 2× larger, ½-opacity copies tagged to level
    `lvl` (`--grow_large`); their pixel-size records start at the parent's
    ×2. Returns (state, touched)."""
    grads = st.xyz_grad_accum[:, lvl] / torch.clamp(st.denom[:, lvl], min=1.0)
    grads = torch.where(st.denom[:, lvl] > 0, grads, 0.0)
    cand = st.live & (grads >= grad_threshold)
    slots, _ = _alloc_slots(st.live, cand, copies=1)
    st = _copy_selected(st, cand, slots, 0)
    dst = slots[:, 0]
    half_op = inverse_sigmoid(torch.clamp(st.act_opacity() * 0.5, 1e-4,
                                          1 - 1e-4))
    acc = st.xyz_grad_accum.clone()
    acc[:, lvl] = 0.0
    den = st.denom.clone()
    den[:, lvl] = 0.0
    st = st._replace(
        scaling=_put(st.scaling, dst, st.scaling + math.log(2.0)),
        opacity=_put(st.opacity, dst, half_op[:, None]),
        target_reso_lvl=_put(st.target_reso_lvl, dst, int(lvl)),
        max_pixel_sizes=_put(st.max_pixel_sizes, dst, torch.where(
            st.max_pixel_sizes >= 0, st.max_pixel_sizes * 2.0, -1.0)),
        min_pixel_sizes=_put(st.min_pixel_sizes, dst, torch.where(
            st.min_pixel_sizes >= 0, st.min_pixel_sizes * 2.0, -1.0)),
        xyz_grad_accum=acc, denom=den,
        max_radii2d=torch.zeros_like(st.max_radii2d),
    )
    return st, _touched(st.live, slots)


def reset_opacity(st: GaussianState) -> Tuple[GaussianState, torch.Tensor]:
    """Clamp opacity to ≤ 0.01, level-0 rows only. Returns (state,
    touched)."""
    lvl0 = (st.target_reso_lvl == 0) & st.live
    cap = inverse_sigmoid(torch.tensor(0.01, dtype=torch.float32,
                                       device=st.opacity.device))
    new_op = torch.minimum(st.opacity, cap)
    return st._replace(
        opacity=torch.where(lvl0[:, None], new_op, st.opacity)), lvl0


def prune_small_points(st: GaussianState):
    """The reference's prune_small_points raises NotImplementedError at its
    first line, so the --prune_small path is dead there too."""
    raise NotImplementedError(
        "prune_small_points is unimplemented in the reference "
        "(gaussian_model.py:689) and mirrored as such")


def filter_center(st: GaussianState, center, radius) -> GaussianState:
    """Radial crop for visualisation: keep only Gaussians within `radius` of
    `center`."""
    c = torch.as_tensor(np.asarray(center, np.float32), device=st.xyz.device)
    d = torch.linalg.norm(st.xyz - c[None, :], dim=1)
    return st._replace(live=st.live & (d <= radius))
