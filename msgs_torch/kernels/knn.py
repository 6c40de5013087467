"""k-nearest-neighbour mean squared distance for scale initialisation.

Port of msgs/kernels/knn.py (plain jnp there, not a Pallas kernel): an exact
blocked O(N²) pass, d² = |a|² + |b|² − 2a·b with the a·b term a matmul, self
pairs excluded and d² clamped at 0. Here each block of 1024 rows is held
against every point at once and reduced with `torch.topk`, so memory stays
O(1024·N). TF32 is off (msgs_torch/__init__.py), so the matmul is full f32.
"""
from __future__ import annotations

import torch

_BLOCK = 1024


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbours.

    points: (N, 3) float32. Returns (N,) float32 on the points' device
    (distCUDA2's contract: k=3, self excluded). With fewer than k other
    points the missing neighbours count as +inf, as in the JAX version."""
    N = points.shape[0]
    pts = points.to(torch.float32)
    sq = torch.sum(pts * pts, dim=1)
    out = torch.empty((N,), dtype=torch.float32, device=pts.device)
    for r0 in range(0, N, _BLOCK):
        r = pts[r0:r0 + _BLOCK]
        B = r.shape[0]
        d2 = sq[r0:r0 + B, None] + sq[None, :] - 2.0 * (r @ pts.T)
        rows = torch.arange(B, device=pts.device)
        d2[rows, rows + r0] = torch.inf
        d2 = torch.clamp(d2, min=0.0)
        # The JAX version merges each column block into k running +inf
        # slots; the same slots here make k > N − 1 well defined.
        d2 = torch.cat([d2, torch.full((B, k), torch.inf, device=pts.device)],
                       dim=1)
        best = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        out[r0:r0 + B] = torch.mean(best, dim=1)
    return out
