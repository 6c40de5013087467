"""A dry run of the sharded training step on an n-rank mesh.

Port of `dryrun_multichip` in the repository's __graft_entry__.py:
`dryrun_multichip(n)` starts n ranks (launch.run_ranks), lays them out as
a gauss × tile mesh (a gauss axis of 2 when n is even and above 1) and runs
30 sharded train steps on a toy scene of one 16-pixel tile row a stripe:

  - the splat-packet cap starts undersized and must grow at least once
    (an overflowing step is discarded and retried with the cap doubled,
    the trainer's loop);
  - a densify at step 10 and an insert-large episode at step 20 go through
    the trainer's cold path: gather the state on every rank, run the
    single-device structural step on rank 0, broadcast, reshard;
  - the run ends with a finite loss and no binning or exchange overflow.

    python -m msgs_torch.dist.dryrun [N] [--device cpu] [--backend gloo]

Each rank's kernel launch counts come back with its result.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

N_STEPS = 30


def _toy_scene(n=512, seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([
        rng.uniform(-1.2, 1.2, (n, 2)),
        rng.uniform(2.5, 7.0, (n, 1))], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, colors


def dryrun_rank(rank: int, n_devices: int) -> dict:
    """One rank of the dry run (a launch.run_ranks function), on
    multihost.current_rank_device(); returns its record."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.dist import collectives as X
    from msgs_torch.dist import shard as S
    from msgs_torch.dist.mesh import make_mesh
    from msgs_torch.dist.multihost import current_rank_device
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.preprocess import TILE
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig, create_from_points
    from msgs_torch.train.loop import densify_step, init_train_state, \
        insert_large_step
    from msgs_torch.train.optimizer import OptimParams

    n_gauss = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dev = current_rank_device()
    mesh = make_mesh(n_gauss=n_gauss, n_tile=n_devices // n_gauss,
                     device=dev)
    H = mesh.n_stripes * TILE          # one 16-px tile row per stripe
    W = 64

    cap = 256 * n_gauss
    cfg = GaussianConfig(sh_degree=1, reso_lvls=2, capacity=cap)
    means, colors = _toy_scene(n=cap // 2)
    st = create_from_points(cfg, means, colors, device=dev)
    state = S.shard_train_state(init_train_state(st), mesh, cap)
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9 * H / W, W, H,
                      device=dev)

    # The trainer's defaults: banded emission and the bf16-packed gather
    # gradients (--fast_grads).
    settings = RasterSettings(entry_cap=1 << 14, grad_pack_bf16=True)
    op = OptimParams()
    key = torch.Generator(device=dev).manual_seed(0)

    # The exchange's packet cap starts UNDERSIZED, so that the trainer's
    # growth loop (on exch_overflow, double and rebuild) runs on the mesh.
    packet_cap0 = packet_cap = max(cap // 8, 16)
    grown = 0

    def build(pc):
        return S.build_sharded_train_step(
            mesh, cfg, op, settings, H, W, spatial_lr_scale=1.0,
            packet_cap=pc)

    step = build(packet_cap)

    # Non-trivial ground truth so gradients and densification statistics
    # are nonzero.
    gy = torch.linspace(0.0, 1.0, H, device=dev)[:, None, None]
    gt = (gy.expand(H, W, 3) * 0.5)[mesh.stripe_rows(H)].contiguous()

    _build.reset_launch_counts()
    log = []
    metrics = None
    for i in range(1, N_STEPS + 1):
        state, metrics = step(state, cam, gt)
        while int(metrics["exch_overflow"]) > 0:
            packet_cap *= 2
            grown += 1
            log.append(f"packet_cap growth @step {i}: exchange overflow "
                       f"{int(metrics['exch_overflow'])} -> cap {packet_cap}")
            if grown > 8:
                raise RuntimeError("packet_cap growth did not converge")
            step = build(packet_cap)
            state, metrics = step(state, cam, gt)
        if i in (10, 20):
            # Through the trainer's cold path: gather → single-device
            # structural step on rank 0 → broadcast → reshard.
            full = S.fetch_train_state(state, mesh)
            if i == 10:
                n_before = int(full.gaussians.num_live)
                if rank == 0:
                    full = densify_step(full, key, op=op, scene_extent=4.0,
                                        max_screen_size=20.0)
                full = S.broadcast_train_state(full, mesh)
                log.append(f"densify @10: live {n_before} -> "
                           f"{int(full.gaussians.num_live)}")
                densified = (n_before, int(full.gaussians.num_live))
            else:
                n_ins = torch.zeros((), dtype=torch.int32, device=dev)
                if rank == 0:
                    g = full.gaussians
                    sel = (g.live & (g.target_reso_lvl == 0)
                           & (torch.arange(cap, device=dev) < 64))
                    cur_min = torch.full((cap,), 0.5, dtype=torch.float32,
                                         device=dev)
                    full, n_ins = insert_large_step(
                        full, sel, cur_min, 1, scene_extent=4.0,
                        voxel_reso=0.05)
                full = S.broadcast_train_state(full, mesh)
                inserted = int(X.broadcast(n_ins, mesh.world))
                log.append(f"insert_large @20: {inserted} aggregates")
            state = S.shard_train_state(full, mesh, cap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"loss": float(metrics["loss"]),
            "overflow": int(metrics["overflow"]),
            "exch_overflow": int(metrics["exch_overflow"]),
            "num_entries": int(metrics["num_entries"]),
            "num_live": int(metrics["num_live"]),
            "packet_cap": (packet_cap0, packet_cap), "grown": grown,
            "densified": densified, "inserted": inserted,
            "mesh": mesh.shape, "H": H, "W": W, "log": log,
            "host_bytes": mesh.stats["host_bytes"],
            "launch_counts": dict(_build.launch_counts)}


def check_records(recs: list) -> None:
    """Raise unless the ranks' records (rank order) show the dry run's
    outcome: the ranks agree, the loss is finite, nothing overflowed, the
    packet cap grew, densify changed the live count and the insert
    episode inserted."""
    r = recs[0]
    for other in recs[1:]:
        for k in ("loss", "num_entries", "num_live", "packet_cap"):
            if other[k] != r[k]:
                raise RuntimeError(f"dryrun: ranks disagree on {k}: "
                                   f"{r[k]} vs {other[k]}")
    if not np.isfinite(r["loss"]):
        raise RuntimeError(f"dryrun: non-finite sharded loss {r['loss']}")
    if r["overflow"] or r["exch_overflow"]:
        raise RuntimeError(f"dryrun: overflow {r['overflow']}, exchange "
                           f"overflow {r['exch_overflow']}")
    if r["grown"] < 1:
        raise RuntimeError("dryrun: the undersized packet_cap never "
                           "overflowed; the growth loop did not run")
    if r["densified"][1] == r["densified"][0]:
        raise RuntimeError(f"dryrun: densify left {r['densified'][0]} live")
    if r["inserted"] <= 0:
        raise RuntimeError("dryrun: the insert episode inserted nothing")


def dryrun_multichip(n_devices: int, *, device=None,
                     backend="gloo") -> list:
    """Run the dry run on `n_devices` ranks of this host, placed on
    `device` by launch.run_ranks (None: a card a rank; a CUDA device with
    an index: that card, shared under gloo; "cpu"), and check its outcome.
    Returns the ranks' records (rank order)."""
    from msgs_torch.dist.launch import run_ranks

    recs = run_ranks(dryrun_rank, n_devices, (n_devices,), backend=backend,
                     device=device)
    check_records(recs)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser("msgs_torch dryrun_multichip")
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default=None,
                   help="the ranks' device (default: a card a rank; "
                        "cuda:0 puts every rank on card 0, under gloo)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default="gloo")
    args = p.parse_args(argv)
    recs = dryrun_multichip(args.n, device=args.device, backend=args.backend)
    r = recs[0]
    for line in r["log"]:
        print(f"  {line}")
    print(f"dryrun_multichip({args.n}): mesh={r['mesh']} H={r['H']} "
          f"W={r['W']} steps={N_STEPS} loss={r['loss']:.5f} "
          f"entries={r['num_entries']} packet_cap {r['packet_cap'][0]}->"
          f"{r['packet_cap'][1]} ({r['grown']} growths) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
