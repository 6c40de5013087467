"""Process-group initialisation for sharded (and multi-host) training.

Port of msgs/dist/multihost.py. JAX's `jax.distributed.initialize` wires
the hosts of a slice together, after which one process per host drives its
chips. Here every mesh cell is a process, so a mesh of any size needs a
process group, one host or many, and the environment contract is
torchrun's:

  MASTER_ADDR, MASTER_PORT   the rendezvous of rank 0
                             (JAX: JAX_COORDINATOR_ADDRESS, "host:port")
  WORLD_SIZE                 the number of ranks (JAX: JAX_NUM_PROCESSES,
                             which counts hosts, not chips)
  RANK                       this rank (JAX: JAX_PROCESS_ID, a host's id)
  LOCAL_RANK                 this rank on its host; picks the card under
                             --multihost (JAX has no counterpart: a JAX
                             process owns all of its host's chips)

or pass them explicitly; the arguments override the environment, as in
JAX. The backend is named by the caller and nothing switches it: NCCL
needs one card per rank, gloo lets ranks share a card (its collectives of
CUDA tensors are staged through the host, collectives.py).

Data contract, as in JAX: every rank loads the same scene and steps the
same camera schedule (the host schedule is deterministic given the seed);
each keeps only its gauss shard of the state and its stripe of each
ground-truth image.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from msgs_torch import resolve_device

# How long a rank waits in a collective for the others (the cold path runs
# evaluation and structural steps on rank 0 while the others wait).
TIMEOUT = datetime.timedelta(minutes=30)


def torchrun_env() -> bool:
    """Whether this process was started by torchrun (or a launcher that
    sets its variables)."""
    return all(k in os.environ for k in
               ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))


# This rank's device, as maybe_initialize set it (current_rank_device).
_RANK_DEVICE: Optional[torch.device] = None


def rank_device(device, backend: str, multihost: bool = False, *,
                rank: Optional[int] = None,
                ranks_here: Optional[int] = None) -> torch.device:
    """This rank's device: the package's one rule for which card a rank
    uses and whether it may share it. `device` "cpu" (or a CPU device)
    stays the CPU; a CUDA device with an index is that card, which ranks
    share (gloo only); "cuda" or None is card `rank` modulo the host's
    cards. `rank` and `ranks_here` (the ranks on this host) default to
    torchrun's RANK and WORLD_SIZE, or LOCAL_RANK and LOCAL_WORLD_SIZE
    under --multihost. NCCL needs a card per rank: it refuses the CPU and
    two ranks on a card."""
    if device is not None and torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; use "
                             "--dist_backend gloo on the CPU")
        return torch.device("cpu")
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK" if multihost else "RANK", 0))
    if ranks_here is None:
        ranks_here = int(os.environ.get(
            "LOCAL_WORLD_SIZE" if multihost else "WORLD_SIZE", 1))
    cards = torch.cuda.device_count()
    shared = dev.index is not None
    if backend == "nccl" and (ranks_here > cards
                              or (shared and ranks_here > 1)):
        raise ValueError(
            f"NCCL needs one card per rank: {ranks_here} ranks on "
            f"{dev if shared else f'{cards} card(s)'}. Run fewer ranks a "
            f"host, or --dist_backend gloo to let ranks share a card")
    return dev if shared else torch.device("cuda", rank % cards)


def current_rank_device() -> torch.device:
    """The device of this rank: the one maybe_initialize was given, else
    the current CUDA device (the CPU only when named to maybe_initialize;
    without a card this raises)."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(None)


def maybe_initialize(enabled: bool,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "gloo", device=None,
                     init_method: Optional[str] = None) -> bool:
    """Initialise torch.distributed when `enabled` (a no-op if it is
    already initialised). Returns True on rank 0, the process that writes
    logs and checkpoints, and True when not enabled. `device` (rank_device)
    becomes this rank's device (current_rank_device), and a CUDA device
    this process's current device, before the group forms.
    `init_method` replaces the tcp:// rendezvous (launch.run_ranks passes
    a file:// store)."""
    global _RANK_DEVICE
    if not enabled:
        return True
    if not dist.is_initialized():
        addr = coordinator_address or (
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
            if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ
            else None)
        world = num_processes or os.environ.get("WORLD_SIZE")
        rank = process_id if process_id is not None else \
            os.environ.get("RANK")
        if init_method is None and addr is not None:
            init_method = f"tcp://{addr}"
        if init_method is None or world is None or rank is None:
            raise RuntimeError(
                "maybe_initialize: no rendezvous; set MASTER_ADDR, "
                "MASTER_PORT, WORLD_SIZE and RANK (torchrun sets them) or "
                "pass them")
        if device is not None:
            _RANK_DEVICE = torch.device(device)
            if _RANK_DEVICE.type == "cuda":
                torch.cuda.set_device(_RANK_DEVICE)
                torch.zeros(1, device=_RANK_DEVICE)  # the context first
        dist.init_process_group(backend, init_method=init_method,
                                world_size=int(world), rank=int(rank),
                                timeout=TIMEOUT)
    return dist.get_rank() == 0
