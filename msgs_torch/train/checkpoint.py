"""Checkpoint and snapshot I/O.

Port of msgs/train/checkpoint.py. Two formats, each readable by either
package:
  (a) PLY model snapshots (reference-compatible schema incl. the MS extras);
  (b) the full training state as an .npz: `n_leaves` and `leaf_i` in JAX's
      tree-flatten order of TrainState — the GaussianState fields in
      declaration order, Adam's `mu` then `nu` with their keys sorted, then
      `count`, then `iteration`.
"""
from __future__ import annotations

import numpy as np
import torch

from msgs_torch.data.ply import load_gaussian_ply, save_gaussian_ply
from msgs_torch.model.gaussians import GaussianConfig, GaussianState, \
    empty_state
from msgs_torch.train.loop import TrainState
from msgs_torch.train.optimizer import AdamState


def save_ply_snapshot(path: str, st: GaussianState):
    live = st.live.cpu().numpy()
    pick = lambda t: t.cpu().numpy()[live]
    save_gaussian_ply(path, {
        "xyz": pick(st.xyz),
        "features_dc": pick(st.features_dc),
        "features_rest": pick(st.features_rest),
        "opacity": pick(st.opacity),
        "scaling": pick(st.scaling),
        "rotation": pick(st.rotation),
        "occ_multiplier": pick(st.occ_multiplier),
        "dc_delta": pick(st.dc_delta),
        "base_mask": pick(st.base_mask),
        "max_pixel_sizes": pick(st.max_pixel_sizes),
        "min_pixel_sizes": pick(st.min_pixel_sizes),
    })


def load_ply_snapshot(path: str, cfg: GaussianConfig,
                      device=None) -> GaussianState:
    f = load_gaussian_ply(path)
    n = len(f["xyz"])
    if n > cfg.capacity:
        raise ValueError(f"PLY has {n} Gaussians > capacity {cfg.capacity}")
    st = empty_state(cfg, device)

    def put(arr, key):
        v = f.get(key)
        if v is None:
            return arr
        arr[:n] = torch.as_tensor(np.asarray(v), device=arr.device)
        return arr

    live = st.live
    live[:n] = True
    return st._replace(
        xyz=put(st.xyz, "xyz"),
        features_dc=put(st.features_dc, "features_dc"),
        features_rest=put(st.features_rest, "features_rest"),
        opacity=put(st.opacity, "opacity"),
        scaling=put(st.scaling, "scaling"),
        rotation=put(st.rotation, "rotation"),
        occ_multiplier=put(st.occ_multiplier, "occ_multiplier"),
        dc_delta=put(st.dc_delta, "dc_delta"),
        base_mask=put(st.base_mask, "base_mask"),
        max_pixel_sizes=put(st.max_pixel_sizes, "max_pixel_sizes"),
        min_pixel_sizes=put(st.min_pixel_sizes, "min_pixel_sizes"),
        live=live,
        active_sh_degree=torch.tensor(cfg.sh_degree, dtype=torch.int32,
                                      device=st.live.device),
    )


def grow_capacity(state: TrainState, new_cap: int) -> TrainState:
    """Pad every capacity-leading tensor of a TrainState (parameters, Adam
    moments, side state) to a larger capacity. New rows are dead, with the
    pads self-consistent: pixel-size records −1 (uninitialised), rotation
    the identity quaternion."""
    old_cap = int(state.gaussians.xyz.shape[0])
    if new_cap < old_cap:
        raise ValueError(f"grow_capacity: {new_cap} < {old_cap}")

    def pad(x):
        if x.dim() >= 1 and x.shape[0] == old_cap:
            z = torch.zeros((new_cap - old_cap,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
            return torch.cat([x, z], dim=0)
        return x

    g = GaussianState(*(pad(x) for x in state.gaussians))
    g.max_pixel_sizes[old_cap:] = -1.0
    g.min_pixel_sizes[old_cap:] = -1.0
    g.rotation[old_cap:, 0] = 1.0
    adam = AdamState(mu={k: pad(v) for k, v in state.adam.mu.items()},
                     nu={k: pad(v) for k, v in state.adam.nu.items()},
                     count=pad(state.adam.count))
    return TrainState(gaussians=g, adam=adam,
                      iteration=pad(state.iteration))


def _leaves(state: TrainState):
    return (list(state.gaussians)
            + [state.adam.mu[k] for k in sorted(state.adam.mu)]
            + [state.adam.nu[k] for k in sorted(state.adam.nu)]
            + [state.adam.count, state.iteration])


def save_train_state(path: str, state: TrainState):
    flat = _leaves(state)
    np.savez_compressed(path, n_leaves=len(flat),
                        **{f"leaf_{i}": x.detach().cpu().numpy()
                           for i, x in enumerate(flat)})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """The TrainState of an .npz written by either package, on the
    template's device with the template's Adam groups. Shapes come from
    the file (a checkpoint may have grown past the template's capacity)."""
    dev = template.gaussians.xyz.device
    with np.load(path) as data:
        n = int(data["n_leaves"])
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=dev)
                  for i in range(n)]
    nf = len(GaussianState._fields)
    keys = sorted(template.adam.mu)
    if n != nf + 2 * len(keys) + 2:
        raise ValueError(f"{path}: {n} leaves, the TrainState has "
                         f"{nf + 2 * len(keys) + 2}")
    g = GaussianState(*leaves[:nf])
    mu = dict(zip(keys, leaves[nf:nf + len(keys)]))
    nu = dict(zip(keys, leaves[nf + len(keys):nf + 2 * len(keys)]))
    return TrainState(gaussians=g,
                      adam=AdamState(mu=mu, nu=nu, count=leaves[-2]),
                      iteration=leaves[-1])
