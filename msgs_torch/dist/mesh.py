"""The gauss × tile mesh of sharded training, one process a mesh cell.

Port of msgs/dist/mesh.py. The scaling axes are the JAX package's:
  - "gauss": Gaussian primitives — shards parameters, Adam moments,
    preprocess compute and per-Gaussian gradients;
  - "tile":  image row stripes — shards binning and compositing and the
    ground-truth images (the stripes run over both axes).

JAX drives every device of the mesh from one process through shard_map;
here every mesh cell is a process (a rank of torch.distributed), and a
rank's coordinate is `(g, t) = divmod(rank, n_tile)`, the layout of JAX's
`reshape(n_gauss, n_tile)`. So a rank's stripe index `g·n_tile + t` is its
rank. JAX's shardings become the rank's slices: `P(GAUSS_AXIS)` is the
rank's gauss shard of capacity-leading rows (`gauss_rows`), replicated over
the tile axis, and `P((GAUSS_AXIS, TILE_AXIS))` its stripe of image rows
(`stripe_rows`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

GAUSS_AXIS = "gauss"
TILE_AXIS = "tile"


def mesh_shape(n: int, n_gauss: Optional[int] = None,
               n_tile: Optional[int] = None) -> tuple:
    """(n_gauss, n_tile) for n ranks: msgs/dist/mesh.py's rule. Without
    either count, a gauss axis of 2 when n is even and above 2 (the tile
    axis is favoured: compositing dominates)."""
    if n_gauss is None and n_tile is None:
        n_gauss = 2 if n % 2 == 0 and n > 2 else 1
        n_tile = n // n_gauss
    elif n_gauss is None:
        n_gauss = n // n_tile
    elif n_tile is None:
        n_tile = n // n_gauss
    if n_gauss * n_tile != n:
        raise ValueError(f"mesh {n_gauss}x{n_tile} does not cover {n} ranks")
    return n_gauss, n_tile


class Axis:
    """A group of ranks that a collective runs over (a mesh axis, or the
    whole world), with this rank's index in it.

    `staged` is set when the backend is gloo and the mesh's tensors live on
    a CUDA device: gloo's CUDA support differs from collective to
    collective and from version to version, so every collective of such an
    axis copies its tensor to the host and back (collectives.py), and
    `stats["host_bytes"]` counts the bytes of those copies."""

    def __init__(self, name: str, group, size: int, index: int,
                 staged: bool, stats: dict):
        self.name, self.group = name, group
        self.size, self.index = size, index
        self.staged, self.stats = staged, stats


class Mesh:
    """This rank's view of the n_gauss × n_tile mesh: its coordinate, its
    device, and the gauss, tile and world axes."""

    def __init__(self, device_mesh, n_gauss: int, n_tile: int,
                 device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.n_gauss, self.n_tile = n_gauss, n_tile
        self.rank = dist.get_rank()
        self.g, self.t = divmod(self.rank, n_tile)
        self.device, self.backend = device, backend
        self.stats = {"host_bytes": 0}
        staged = backend == "gloo" and device.type == "cuda"
        self.gauss = Axis(GAUSS_AXIS, device_mesh.get_group(GAUSS_AXIS),
                          n_gauss, self.g, staged, self.stats)
        self.tile = Axis(TILE_AXIS, device_mesh.get_group(TILE_AXIS),
                         n_tile, self.t, staged, self.stats)
        self.world = Axis("world", dist.group.WORLD, n_gauss * n_tile,
                          self.rank, staged, self.stats)
        for ax in (self.gauss, self.tile):
            got = dist.get_rank(ax.group)
            if got != ax.index:
                raise RuntimeError(f"mesh: rank {self.rank} is {got} in its "
                                   f"{ax.name} group, want {ax.index}")

    @property
    def shape(self) -> dict:
        return {GAUSS_AXIS: self.n_gauss, TILE_AXIS: self.n_tile}

    @property
    def stripe_idx(self) -> int:
        return self.rank

    @property
    def n_stripes(self) -> int:
        return self.n_gauss * self.n_tile

    def gauss_rows(self, capacity: int) -> slice:
        """This rank's rows of a capacity-leading array (P(GAUSS_AXIS))."""
        c_local = capacity // self.n_gauss
        return slice(self.g * c_local, (self.g + 1) * c_local)

    def stripe_rows(self, height_padded: int) -> slice:
        """This rank's rows of a padded image (P((GAUSS_AXIS, TILE_AXIS)))."""
        h_local = height_padded // self.n_stripes
        return slice(self.rank * h_local, (self.rank + 1) * h_local)


def make_mesh(n_gauss: Optional[int] = None, n_tile: Optional[int] = None,
              device=None) -> Mesh:
    """The mesh over every rank of the initialised default process group
    (multihost.maybe_initialize, or launch.run_ranks), shaped by
    `mesh_shape`. `device` is this rank's device (default:
    multihost.current_rank_device, a CUDA device unless the CPU was
    named)."""
    from torch.distributed.device_mesh import init_device_mesh

    from msgs_torch.dist.multihost import current_rank_device

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(msgs_torch.dist.multihost.maybe_initialize)")
    n_gauss, n_tile = mesh_shape(dist.get_world_size(), n_gauss, n_tile)
    device = current_rank_device() if device is None else \
        torch.device(device)
    dm = init_device_mesh(device.type, (n_gauss, n_tile),
                          mesh_dim_names=(GAUSS_AXIS, TILE_AXIS))
    return Mesh(dm, n_gauss, n_tile, device, dist.get_backend())
