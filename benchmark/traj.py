"""The MS-GS reference's zoom traffic (render_traj.py): a circle around the
centroid of the training cameras with a resolution scale that sweeps
sinusoidally from min_scale to max_scale and back. A frozen copy of
msgs_torch/apps/traj.py's `circle_trajectory` and `sweep_scale`, so the
yardstick stays put when the program changes; the only change is a phase
offset (`phase`, in frames) so that a seed can start the circle elsewhere.
"""
from __future__ import annotations

import math

import numpy as np


def circle_trajectory(views, n_frames: int, radius_frac: float = 0.3,
                      phase: float = 0.0):
    """(R, T) poses on a circle around the centroid of the training cameras,
    each looking at that centroid."""
    centers = []
    for v in views:
        W2C = np.eye(4)
        W2C[:3, :3] = v.R.T
        W2C[:3, 3] = v.T
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3])
    centers = np.stack(centers)
    centroid = centers.mean(0)
    radius = np.linalg.norm(centers - centroid, axis=1).mean() * radius_frac
    base = views[0]
    up = base.R[:, 1]

    frames = []
    for i in range(n_frames):
        ang = 2 * math.pi * (i + phase) / n_frames
        offset = (math.cos(ang) * base.R[:, 0]
                  + math.sin(ang) * base.R[:, 2]) * radius
        pos = centroid + offset
        fwd = centroid - pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)
        T = -R.T @ pos
        frames.append((R, T))
    return frames


def sweep_scale(i: int, n_frames: int, min_scale: float,
                max_scale: float) -> float:
    """Frame i's resolution scale: min_scale at frame 0, max_scale halfway,
    geometric in between."""
    t = 0.5 - 0.5 * math.cos(2 * math.pi * i / n_frames)
    return min_scale * (max_scale / min_scale) ** t


def frame_size(width: int, height: int, scale: float):
    """traj.py's frame size at `scale`: rounded down to a multiple of 16,
    at least 16."""
    return (max(int(width / scale) // 16 * 16, 16),
            max(int(height / scale) // 16 * 16, 16))
