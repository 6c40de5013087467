"""Start the ranks of a mesh as processes of this host and collect what
each returns.

`run_ranks(fn, world_size, args)` starts `world_size` processes with the
`spawn` method (never `fork`: the parent may hold a CUDA context and
threads), initialises torch.distributed in each through a FileStore, calls
`fn(rank, *args)` there and returns the ranks' results in rank order. A
rank that raises fails the call with its traceback, and every process is
stopped before the call returns. The trainer is started by torchrun
instead (msgs_torch.dist.multihost); this is for the dryrun, the tests and
the card smoke run, which drive the mesh from Python.

On CUDA the kernels are built (or found built) here, before any rank
starts; each rank then loads the library from `build/msgs_torch/`.

`args` reach the ranks through a pickle file beside the FileStore, not
through the spawn pipe: a spawned child reads its process object only
after it has imported the parent's main module, so the parent's write of
a pickle larger than the pipe's buffer blocks until then, and the ranks
would start one after another (chip_smoke.py [dist] prints the cost).
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from msgs_torch.dist.multihost import TIMEOUT, maybe_initialize, \
    rank_device


def _rank_main(fn, rank, world_size, store, backend, device, args_file,
               results):
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        # Ranks share the host's cores: one torch thread each.
        torch.set_num_threads(1)
        dev = rank_device(device, backend, rank=rank, ranks_here=world_size)
        maybe_initialize(True, num_processes=world_size, process_id=rank,
                         backend=backend, device=dev,
                         init_method=f"file://{store}")
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:   # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, args=(), *, backend: str = "gloo",
              device=None, store_dir=None) -> list:
    """[fn(0, *args), ..., fn(world_size − 1, *args)], each run in a rank
    process. `fn` must be importable (a module-level function); `device`
    places the ranks by multihost.rank_device: None or "cuda" is card
    `rank` (NCCL needs one card a rank), a CUDA device with an index is
    that card for every rank (gloo lets ranks share it), "cpu" the CPU.
    A rank reads its device with multihost.current_rank_device().
    `store_dir` holds the FileStore (default: a temporary directory). A
    rank gets one torch thread."""
    import torch.multiprocessing as mp

    # The rule every rank applies, checked here first so that a refused
    # placement fails before any process starts.
    dev = rank_device(device, backend, rank=0, ranks_here=world_size)
    if dev.type == "cuda":
        from msgs_torch.kernels import _build
        _build.load()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        args_file = os.path.join(tmp, "args.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, store, backend,
                                   device, args_file, results))
                 for r in range(world_size)]
        out = {}
        try:
            for p in procs:
                p.start()
            t_end = time.monotonic() + TIMEOUT.total_seconds()
            while len(out) < world_size:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in out]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"run_ranks: rank(s) {dead} exited without a "
                            f"result (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > t_end:
                        raise TimeoutError(f"run_ranks: no result from "
                                           f"every rank in {TIMEOUT}")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{val}")
                out[rank] = val
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world_size)]
