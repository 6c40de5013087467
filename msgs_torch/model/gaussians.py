"""Fixed-capacity Gaussian model state: fields and activations.

Port of msgs/model/gaussians.py:37-130. State lives in capacity-`C` tensors
with a `live` mask; the parameter storage conventions are the reference's:
  scaling   — log-space (activation exp)
  rotation  — unnormalized quaternion wxyz (activation L2-normalize)
  opacity   — logit (activation sigmoid)
  occ_multiplier — logit if multi_occ else raw 1.0
Ported so far: the fields, activations, the parameter dict the optimizer
sees, and the per-step side-state updates of the train step (pixel-size
records, max radii, densification statistics, base mask). Densify, prune,
grow and insert are still to port (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.core.sh import num_sh_coeffs
from msgs_torch.core.transforms import inverse_sigmoid

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
