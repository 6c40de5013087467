"""Training CLI on PyTorch + CUDA: port of msgs/apps/train.py.

Usage:
  python -m msgs_torch.apps.train -s <scene> -m <out> [--ms_train
      --filter_small --insert_large --ms_train_max_scale 7 ...]
      [--device cpu]

The flags, the sampling order and the per-iteration structure are the JAX
trainer's (SURVEY.md §2.5): level / viewpoint sampling (75% finest,
stack-per-epoch) → train_step (render, loss, Adam, pixel-size / densify
statistics) → evaluation and saves → cadenced structural steps (densify and
prune at level 0 per interval, grow_large at coarse levels, opacity reset
with the post-reset statistics blackout, insert-large episodes at the unlock
schedule). Entry capacity and Gaussian capacity grow on demand. Device
scalars (overflow, loss, live count) are read back once per 10 iterations,
so the host never waits on the card each step; ground-truth images are
cached on the device per (view, scale).

Beyond the JAX flags: `--device` (default: the CUDA device) and
`--dist_backend`. Without `--disable_gui` the trainer listens on
--ip/--port for the SIBR remote viewer (msgs_torch/apps/network_gui.py)
and serves it renders of the live model at the head of an iteration
(every iteration while a client is connected, else every 50th); under
--mesh it does not, since the live model is sharded over the ranks. The
final evaluation adds LPIPS when its weight file exists
(msgs_torch/eval/lpips.py), as the JAX trainer does.

Sharded training (`--mesh G T`, msgs_torch/dist/) runs one process a mesh
cell, started by torchrun:

  torchrun --nproc_per_node G·T -m msgs_torch.apps.train --mesh G T ...

Parameters and Adam moments are sharded over the G gauss shards, the image
rows over all G·T ranks (the bounded splat exchange, dist/shard.py). The
cold path (evaluation, saves, densify, reset, insert, capacity growth)
all-gathers the state; rank 0 runs the single-device code on it and
broadcasts the result, and each rank takes its shard again. Only rank 0
writes logs, PLYs and checkpoints. `--dist_backend` is nccl (one card a
rank; the default on CUDA) or gloo (ranks may share a card; the default on
`--device cpu`); nothing switches it. Rank r takes card r modulo the
host's cards; `--device cuda:N` puts every rank on card N (gloo only).
`--multihost` spreads the ranks over hosts: LOCAL_RANK picks the card.
`--profile_steps A:B` traces iterations [A, B) with torch.profiler into
<model_path>/profile/trace.json; the trace carries the stage spans
(`msgs.train_step`, `msgs.preprocess`, `msgs.binning` and its children,
...; msgs_torch/trace.py), which `python3 -m benchmark.spans
<model_path>/profile/trace.json` tabulates per step. `--detect_anomaly`
turns on torch.autograd.set_detect_anomaly.

Besides the JAX trainer's records, train_log.jsonl gets one record per
structural event (densify, reset, grow, insert) with the live count before
and after, read back at that event.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import time
import traceback

import numpy as np
import torch


def build_parser():
    from msgs_torch.apps.config import ModelParams, PipelineParams, \
        add_group, add_optim_group
    p = argparse.ArgumentParser("msgs_torch train")
    add_group(p, ModelParams, "Model")
    add_group(p, PipelineParams, "Pipeline")
    add_optim_group(p)
    p.add_argument("-s", dest="source_path_short", type=str, default=None)
    p.add_argument("-m", dest="model_path_short", type=str, default=None)
    p.add_argument("-r", dest="resolution_short", type=int, default=None)
    p.add_argument("--ms_train", action="store_true")
    p.add_argument("--ms_train_max_scale", type=int, default=7)
    p.add_argument("--ms_test_scales", nargs="+", type=float, default=None,
                   help="override eval scales (e.g. 1 3 6 12 24 48 96)")
    p.add_argument("--filter_small", action="store_true")
    p.add_argument("--prune_small", action="store_true")
    p.add_argument("--preserve_large", action="store_true")
    p.add_argument("--multi_occ", action="store_true")
    p.add_argument("--multi_dc", action="store_true")
    p.add_argument("--grow_large", action="store_true")
    p.add_argument("--insert_large", action="store_true")
    p.add_argument("--fade_size", type=float, default=0.0)
    p.add_argument("--fade_ungated", action="store_true",
                   help="filter_small keys on current footprint alone")
    p.add_argument("--ms_from_iter", type=int, default=1,
                   help="iteration from which MS sampling and occ/dc LRs "
                        "activate")
    p.add_argument("--ms_fine_tail_from", type=int, default=0,
                   help="past this iteration sample only the finest level "
                        "(0 = never)")
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--test_interval", type=int, default=5000)
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--capacity", type=int, default=0,
                   help="Gaussian capacity; 0 = auto (grows on demand)")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--fast_grads", action="store_true",
                   help="round the gather VJP's gradient columns to bf16 "
                        "before the id sort (grad_pack_bf16): ~2^-8-"
                        "relative gradient noise")
    p.add_argument("--bwd_bf16", action="store_true",
                   help="run the backward compositor's φ, w·φ prefix, "
                        "moments and colour sums as bf16 tensor-core "
                        "contractions (composite_bwd_bf16.cu)")
    p.add_argument("--backend", type=str, default="pallas",
                   help="'pallas' / 'auto': the CUDA kernels on the card; "
                        "'reference': the plain PyTorch versions")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True)")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--ip", type=str, default="127.0.0.1",
                   help="network GUI host (SIBR remote viewer)")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--disable_gui", action="store_true")
    p.add_argument("--profile_steps", type=str, default=None,
                   help="START:END iteration range to trace with "
                        "torch.profiler into <model_path>/profile/")
    p.add_argument("--mesh", nargs=2, type=int, default=None,
                   metavar=("GAUSS", "TILE"),
                   help="train sharded over a GAUSS x TILE mesh of ranks, "
                        "started by torchrun --nproc_per_node GAUSS*TILE "
                        "(params/Adam gauss-sharded, image row stripes over "
                        "both axes, bounded all-to-all splat exchange; "
                        "msgs_torch/dist/shard.py). Structural ops gather "
                        "-> mutate on rank 0 -> reshard at their cadence.")
    p.add_argument("--packet_cap", type=int, default=0,
                   help="per-(source,stripe) splat packet rows for the "
                        "sharded exchange; 0 = auto, grows on overflow")
    p.add_argument("--multihost", action="store_true",
                   help="the --mesh ranks span hosts (torchrun's "
                        "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK); "
                        "LOCAL_RANK picks the card "
                        "(msgs_torch/dist/multihost.py)")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend of --mesh: nccl (one "
                        "card a rank; the default on CUDA) or gloo (ranks "
                        "may share a card; the default on --device cpu)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; under "
                        "--mesh a card a rank, cuda:N every rank on card N)")
    return p


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init_mesh(args):
    """(mesh, is_main, device) of this process. Without --mesh: no mesh,
    the one process writes, on --device. With it: this rank's place in the
    mesh, after it has joined torchrun's process group (training destroys
    the group at its end)."""
    from msgs_torch import resolve_device
    if not args.mesh:
        if args.multihost:
            raise ValueError("--multihost spreads the ranks of a --mesh over "
                             "hosts; give --mesh GAUSS TILE")
        return None, True, resolve_device(args.device)
    import torch.distributed as dist

    from msgs_torch.dist.mesh import make_mesh
    from msgs_torch.dist.multihost import maybe_initialize, rank_device, \
        torchrun_env
    n_gauss, n_tile = args.mesh
    if not torchrun_env():
        raise RuntimeError(
            f"--mesh {n_gauss} {n_tile} runs one process a mesh cell; start "
            f"it with\n  torchrun --nproc_per_node {n_gauss * n_tile} -m "
            f"msgs_torch.apps.train --mesh {n_gauss} {n_tile} ...")
    on_cpu = (args.device is not None
              and torch.device(args.device).type == "cpu")
    backend = args.dist_backend or ("gloo" if on_cpu else "nccl")
    dev = rank_device(args.device, backend, args.multihost)
    is_main = maybe_initialize(True, backend=backend, device=dev)
    world = dist.get_world_size()
    if world != n_gauss * n_tile:
        raise ValueError(f"--mesh {n_gauss}x{n_tile} needs "
                         f"{n_gauss * n_tile} ranks; the world has {world}")
    if dev.type == "cuda":
        # Rank 0 builds the kernels (or finds them built); the others load
        # the library it wrote.
        from msgs_torch.kernels import _build
        if is_main:
            _build.load()
        dist.barrier()
    return make_mesh(n_gauss, n_tile, device=dev), is_main, dev


def training(args, on_iteration=None):
    """Train; returns the final TrainState (under --mesh, the whole state,
    gathered on every rank). `on_iteration(iteration, host_ops)`, when
    given, is called at the end of every iteration; `host_ops` says
    whether the iteration evaluated, saved or ran a structural step."""
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1 <pid> → stack dump

    from msgs_torch.apps.config import extract_optim, save_cfg
    from msgs_torch.data.dataset import load_scene
    from msgs_torch.dist import shard as S
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig, \
        create_from_points, one_up_sh_degree
    from msgs_torch.ms.schedule import MsSchedule, loss_weight
    from msgs_torch.train import checkpoint as CK
    from msgs_torch.train import loop as L

    if args.source_path_short:
        args.source_path = args.source_path_short
    if args.model_path_short:
        args.model_path = args.model_path_short
    if args.resolution_short is not None:
        args.resolution = args.resolution_short
    mesh, is_main, dev = _init_mesh(args)
    op = extract_optim(args)
    if not is_main:
        # The other ranks compute but never write logs, TensorBoard or GUI.
        args.no_tensorboard = True
        args.disable_gui = True
        args.quiet = True
    say = print if is_main else (lambda *a, **k: None)
    random.seed(args.seed)
    np.random.seed(args.seed)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    os.makedirs(args.model_path, exist_ok=True)
    log_f = None
    if is_main:
        save_cfg(args.model_path, args)
        log_f = open(os.path.join(args.model_path, "train_log.jsonl"), "a")

    def log(rec):
        if log_f is not None:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()

    tb = None
    if not args.no_tensorboard:
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(args.model_path)
        except ImportError:
            print("tensorboardX unavailable; logging to JSONL only")
    # The 1,000-iteration histograms gather the state on every rank, so
    # every rank learns once whether rank 0 writes them.
    tb_histograms = tb is not None
    if mesh is not None:
        from msgs_torch.dist import collectives as X
        tb_histograms = bool(X.broadcast(
            torch.tensor(tb_histograms, device=dev), mesh.world))
    gui = None
    if not args.disable_gui and mesh is not None:
        say("network GUI disabled: under --mesh the live model is sharded "
            "over the ranks")
    elif not args.disable_gui:
        from msgs_torch.apps import network_gui
        try:
            network_gui.init(args.ip, args.port)
            gui = network_gui
        except OSError as e:
            print(f"network GUI disabled: {e}")

    say(f"Loading scene {args.source_path}")
    scene = load_scene(args.source_path, images_dir=args.images,
                       eval_split=args.eval, resolution=args.resolution,
                       white_background=args.white_background, device=dev)
    extent = scene.cameras_extent
    say(f"  {len(scene.train_views)} train / {len(scene.test_views)} test "
        f"views, {len(scene.points)} points, extent {extent:.2f}")

    sched = MsSchedule(max_reso_pow=args.ms_train_max_scale
                       if args.ms_train else 0,
                       ms_train=args.ms_train,
                       insert_large=args.insert_large,
                       ms_from_iter=args.ms_from_iter,
                       fine_tail_from=args.ms_fine_tail_from,
                       rng=random.Random(args.seed))
    filter_large = args.grow_large or args.insert_large

    n0 = len(scene.points)
    capacity = args.capacity or max(next_pow2(n0 * 4), 1 << 16)
    if n0 > capacity:
        # Explicit small capacity: subsample the init cloud to fit.
        keep = np.random.default_rng(args.seed).choice(
            n0, capacity // 2, replace=False)
        scene.points = scene.points[keep]
        scene.colors = scene.colors[keep]
        n0 = len(scene.points)
        say(f"  subsampled init cloud to {n0} (capacity {capacity})")
    cfg = GaussianConfig(sh_degree=args.sh_degree,
                         reso_lvls=sched.reso_lvls,
                         multi_occ=args.multi_occ, multi_dc=args.multi_dc,
                         capacity=capacity)
    settings = RasterSettings(filter_small=args.filter_small,
                              filter_large=filter_large,
                              fade_ungated=args.fade_ungated,
                              entry_cap=args.entry_cap,
                              backend=args.backend,
                              image_grads_only=True,
                              grad_pack_bf16=args.fast_grads,
                              bwd_bf16=args.bwd_bf16)

    st = create_from_points(cfg, scene.points, scene.colors, device=dev)
    state = L.init_train_state(st)
    first_iter = 0
    if args.start_checkpoint:
        state = CK.load_train_state(args.start_checkpoint, state)
        first_iter = int(state.iteration)
        # Capacity may have grown before the checkpoint was written.
        actual_cap = int(state.gaussians.xyz.shape[0])
        if actual_cap != cfg.capacity:
            cfg = cfg._replace(capacity=actual_cap)
        say(f"Resumed from {args.start_checkpoint} at {first_iter} "
            f"(capacity {actual_cap})")

    # --- sharded training over the gauss × tile mesh (--mesh G T) ---
    # Hot path: the sharded train step (dist/shard.py). Cold paths
    # (evaluation, saves, structural steps) gather the state, run the
    # single-device code on rank 0 and reshard its result.
    packet_cap = args.packet_cap
    spatial_lr = float(extent)
    if mesh is not None:
        if cfg.capacity % mesh.n_gauss:
            raise ValueError(f"capacity {cfg.capacity} not divisible by the "
                             f"gauss axis {mesh.n_gauss}")
        state = S.shard_train_state(state, mesh, cfg.capacity)
        say(f"mesh: {mesh.shape} over {mesh.n_stripes} ranks "
            f"({mesh.backend}, {dev})")
        sharded_steps = {}

        def get_sharded_step(lvl, height, width):
            k = (lvl, height, width, settings, cfg.capacity, packet_cap)
            if k not in sharded_steps:
                sharded_steps[k] = S.build_sharded_train_step(
                    mesh, cfg, op, settings, height, width,
                    spatial_lr_scale=spatial_lr, reso_lvl=lvl,
                    loss_mult=loss_weight(lvl) if args.ms_train else 1.0,
                    lambda_dssim=op.lambda_dssim, fade_size=args.fade_size,
                    packet_cap=packet_cap)
            return sharded_steps[k]

    def unshard(s):
        return s if mesh is None else S.fetch_train_state(s, mesh)

    def reshard(s):
        """Rank 0's whole state, sharded on every rank."""
        if mesh is None:
            return s
        return S.shard_train_state(S.broadcast_train_state(s, mesh), mesh,
                                   cfg.capacity)

    # The split's offsets come from this generator (the JAX trainer splits
    # a PRNGKey made from the same seed; the draws differ). Under the mesh
    # only rank 0's is used.
    key = torch.Generator(device=dev).manual_seed(args.seed)
    bg = torch.full((3,), 1.0 if args.white_background else 0.0,
                    dtype=torch.float32, device=dev)

    # Device-resident GT cache per sampled (view, scale); under the mesh,
    # this rank's stripe of the image zero-padded to the stripe height.
    gt_cache = {}

    def gt_on_device(view, scale):
        k = (view.uid, scale)
        if k not in gt_cache:
            img = torch.as_tensor(view.image(scale), device=dev)
            if mesh is not None:
                hp = S.padded_height(img.shape[0], mesh.n_stripes)
                img = S.pad_gt(img, hp)[mesh.stripe_rows(hp)].clone()
            gt_cache[k] = img
        return gt_cache[k]

    viewpoint_stack = []
    cur_lvl = 0
    last_reset = None
    ema_loss = 0.0
    t_start = time.time()
    pending_overflow = []   # the window's overflow scalars (async check)
    pending_exch_overflow = []  # packet-exchange overflow (mesh mode)
    metrics = None
    # Under the mesh the cold path's work runs on rank 0 alone.
    run_ops = is_main

    prof = None
    profile_range = None
    if args.profile_steps and is_main:
        a, b = args.profile_steps.split(":")
        profile_range = (int(a), int(b))

    def gui_render(cam, scale_mod):
        out = L.eval_render(state, cam, cfg=cfg, settings=settings, bg=bg)
        return out.image

    def structural(name, fn, **rec):
        """Run one structural step; log the live count around it."""
        before = int(state.gaussians.num_live)
        new = fn()
        after = int(new.gaussians.num_live)
        log({"it": iteration, "event": name, "live_before": before,
             "live_after": after, **rec})
        return new

    for iteration in range(first_iter + 1, op.iterations + 1):
        if profile_range and iteration == profile_range[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        if profile_range and iteration == profile_range[1] and prof:
            _sync(dev)
            prof.__exit__(None, None, None)
            out_dir = os.path.join(args.model_path, "profile")
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            prof = None
            print(f"[profile] trace written to {out_dir}")

        # Live-view pump; a client that drops must not stop training.
        if gui is not None and (gui.conn is not None or iteration % 50 == 1):
            try:
                gui.serve_step(gui_render, args.source_path, True,
                               device=dev)
            except Exception:
                traceback.print_exc()

        # SH warmup every 1000 iterations.
        if iteration % 1000 == 0:
            state = state._replace(gaussians=one_up_sh_degree(
                state.gaussians, cfg.sh_degree))

        # Viewpoint sampling: a stack per level-epoch.
        if not viewpoint_stack:
            cur_lvl = sched.sample_level(iteration)
            viewpoint_stack = list(scene.train_views)
        view = viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))
        sched.count_iteration(cur_lvl)
        scale = sched.scales[cur_lvl]
        cam = view.camera(scale)
        gt = gt_on_device(view, scale)

        do_px = iteration >= 250 and (last_reset is None
                                      or iteration - last_reset > 250)
        do_ds = iteration < op.densify_until_iter
        do_bm = (args.preserve_large and iteration > op.densify_until_iter
                 and cur_lvl == sched.reso_lvls - 1)
        ms_lr = (iteration >= args.ms_from_iter
                 and (args.multi_occ or args.multi_dc))
        if mesh is not None:
            step_fn = get_sharded_step(cur_lvl, cam.height, cam.width)
            state, metrics = step_fn(state, cam, gt, do_px, do_ds, do_bm,
                                     ms_lr)
            pending_exch_overflow.append(metrics["exch_overflow"])
        else:
            state, metrics = L.train_step(
                state, cam, gt,
                cfg=cfg, op=op, settings=settings, reso_lvl=cur_lvl,
                spatial_lr_scale=spatial_lr, lambda_dssim=op.lambda_dssim,
                loss_mult=loss_weight(cur_lvl) if args.ms_train else 1.0,
                fade_size=args.fade_size,
                do_px_update=do_px, do_densify_stats=do_ds,
                do_base_mask=do_bm, ms_lr_active=ms_lr)
        pending_overflow.append(metrics["overflow"])

        # Eval / save BEFORE structural ops, as the reference does, so
        # snapshots never capture a just-reset model.
        eval_due = iteration in args.test_iterations or (
            args.test_interval > 0 and iteration % args.test_interval == 0)
        densify_due = iteration > op.densify_from_iter and \
            sched.reso_iterations[cur_lvl] % op.densification_interval == 0
        reset_due = (iteration % op.opacity_reset_interval == 0
                     or (args.white_background
                         and iteration == op.densify_from_iter))
        target = sched.insert_target_for(iteration) if args.insert_large \
            else None
        host_ops = (eval_due or iteration in args.save_iterations
                    or iteration in args.checkpoint_iterations
                    or (iteration < op.densify_until_iter
                        and (densify_due or reset_due))
                    or target is not None)
        if mesh is not None and host_ops:
            state = unshard(state)   # cold path: gather → mutate → reshard

        if eval_due and run_ops:
            report = evaluate_scales(state, scene, sched, cfg, settings,
                                     args, bg, iteration)
            log({"it": iteration, "eval": report})
            if tb is not None:
                for k, m in report.items():
                    tb.add_scalar(f"eval/{k}/psnr", m["psnr"], iteration)
                    tb.add_scalar(f"eval/{k}/l1", m["l1"], iteration)
                    tb.add_scalar(f"eval/{k}/render_ms", m["render_ms"],
                                  iteration)

        if iteration in args.save_iterations and run_ops:
            out_dir = os.path.join(args.model_path,
                                   f"point_cloud/iteration_{iteration}")
            os.makedirs(out_dir, exist_ok=True)
            CK.save_ply_snapshot(os.path.join(out_dir, "point_cloud.ply"),
                                 state.gaussians)
            print(f"[save] {out_dir}")

        if iteration in args.checkpoint_iterations and run_ops:
            CK.save_train_state(os.path.join(
                args.model_path, f"chkpnt{iteration}.npz"), state)

        # Densification cadence.
        if iteration < op.densify_until_iter:
            if densify_due and run_ops:
                if cur_lvl == 0:
                    size_thr = 20.0 if iteration > op.opacity_reset_interval \
                        else 0.0
                    state = structural("densify", lambda: L.densify_step(
                        state, key, op=op, scene_extent=float(extent),
                        max_screen_size=size_thr))
                elif args.grow_large:
                    state = structural("grow", lambda: L.grow_step(
                        state, cur_lvl, op=op), lvl=cur_lvl)
            if reset_due:
                last_reset = iteration
                if run_ops:
                    state = structural("reset",
                                       lambda: L.reset_opacity_step(state))

        # Insert-large episode.
        if target is not None and run_ops:
            state, n_ins, n_sel = run_insert_episode(
                state, scene, sched, target, cfg, settings, extent, args)
            log({"it": iteration, "event": "insert", "lvl": target,
                 "n_inserted": n_ins, "n_selected": n_sel,
                 "live_after": int(state.gaussians.num_live)})

        if mesh is not None and host_ops:
            state = reshard(state)

        # Host-side housekeeping every 10 iterations: one read-back of the
        # window's overflow scalars (an overflowing step already discarded
        # its own updates), the loss and the live count. Under the mesh
        # these are sums over the mesh, the same on every rank, so every
        # rank makes the same decisions.
        if iteration % 10 == 0 or iteration == op.iterations:
            ovf = int(torch.stack(pending_overflow).max()) \
                if pending_overflow else 0
            pending_overflow.clear()
            if ovf > 0:
                new_cap = next_pow2(settings.entry_cap + ovf)
                say(f"[entry_cap] overflow {ovf}; "
                    f"growing {settings.entry_cap} -> {new_cap}")
                settings = settings._replace(entry_cap=new_cap)
            if pending_exch_overflow:
                eovf = int(torch.stack(pending_exch_overflow).max())
                pending_exch_overflow.clear()
                if eovf > 0:
                    # Double from build_sharded_loss's effective default
                    # (the step cache's key holds packet_cap, so the next
                    # step is built with the new bound).
                    auto = S.auto_packet_cap(cfg.capacity, mesh.n_gauss,
                                             mesh.n_tile)
                    packet_cap = 2 * (packet_cap or auto)
                    say(f"[packet_cap] exchange overflow {eovf}; "
                        f"growing to {packet_cap}")
            loss = float(metrics["loss"])
            ema_loss = 0.4 * loss + 0.6 * ema_loss
            n_live = int(metrics["num_live"])
            # Grow the Gaussian capacity when > 90% full.
            if n_live > 0.9 * cfg.capacity:
                new_cap = cfg.capacity * 2
                say(f"[capacity] growing {cfg.capacity} -> {new_cap}")
                # The gathered state is the same on every rank, and the
                # padding is deterministic: no broadcast is needed.
                state = CK.grow_capacity(unshard(state), new_cap)
                cfg = cfg._replace(capacity=new_cap)
                if mesh is not None:
                    state = S.shard_train_state(state, mesh, new_cap)
                    sharded_steps.clear()   # keyed on the old capacity
            if iteration % 100 == 0 or iteration == op.iterations:
                elapsed = time.time() - t_start
                say(f"it {iteration:6d} lvl {cur_lvl} loss {ema_loss:.5f} "
                    f"live {n_live} entries {int(metrics['num_entries'])} "
                    f"({elapsed:.0f}s)")
                log({"it": iteration, "loss": loss, "lvl": cur_lvl,
                     "live": n_live, "t": elapsed})
                if tb is not None:
                    if np.isfinite(loss):
                        tb.add_scalar("train_loss_patches/total_loss",
                                      loss, iteration)
                    tb.add_scalar("train/l1", float(metrics["l1"]), iteration)
                    tb.add_scalar("total_points", n_live, iteration)
                    tb.add_scalar("train/entries",
                                  int(metrics["num_entries"]), iteration)
            if iteration % 1000 == 0 and tb_histograms:
                st_g = unshard(state).gaussians   # every rank gathers
                if tb is not None:
                    live_np = st_g.live.cpu().numpy()
                    tb.add_histogram(
                        "scene/opacity_histogram",
                        st_g.act_opacity().cpu().numpy()[live_np], iteration)
                    px_live = st_g.max_pixel_sizes.cpu().numpy()[live_np]
                    if (px_live >= 0).any():
                        tb.add_histogram("scene/max_pixel_sizes",
                                         px_live[px_live >= 0], iteration)
        if on_iteration is not None:
            on_iteration(iteration, host_ops)

    if prof is not None:
        prof.__exit__(None, None, None)
    if log_f is not None:
        log_f.close()
    if tb is not None:
        tb.close()
    if mesh is not None:
        import torch.distributed as dist
        state = unshard(state)
        dist.destroy_process_group()
    return state


def run_insert_episode(state, scene, sched, target_lvl, cfg, settings,
                       extent, args):
    """Insert-large orchestration: render every train camera at level 0 for
    visibility and at the target level for each Gaussian's minimum pixel
    size over the views that saw it at level 0; select the sub-pixel
    level-0 rows; voxel-insert them; render the target level once more to
    initialise the new rows' statistics. Returns (state, n_inserted,
    n_selected)."""
    from msgs_torch.model import gaussians as G
    from msgs_torch.train import loop as L

    C = cfg.capacity
    dev = state.gaussians.xyz.device
    print(f"[insert_large] episode at lvl {target_lvl}")
    visible_l0 = torch.zeros((C,), dtype=torch.bool, device=dev)
    min_px = torch.full((C,), torch.inf, dtype=torch.float32, device=dev)

    # Measurement renders run unfiltered: sub-pixel Gaussians must report
    # their footprint to be selectable.
    msettings = settings._replace(filter_small=False, filter_large=False)
    for view in scene.train_views:
        cam0 = view.camera(sched.scales[0])
        out0 = L.eval_render(state, cam0, cfg=cfg, settings=msettings,
                             reso_lvl=0)
        visible_l0 = visible_l0 | out0.visible
        camt = view.camera(sched.scales[target_lvl])
        outt = L.eval_render(state, camt, cfg=cfg, settings=msettings,
                             reso_lvl=target_lvl)
        # A view contributes its pixel size only where the same view's
        # level-0 render saw the Gaussian.
        px = torch.where((outt.pixel_sizes > 0) & out0.visible,
                         outt.pixel_sizes, torch.inf)
        min_px = torch.minimum(min_px, px)

    st = state.gaussians
    sel = (visible_l0 & (min_px < 1.0) & torch.isfinite(min_px)
           & (st.target_reso_lvl == 0) & st.live)
    cur_min = torch.where(torch.isfinite(min_px), min_px, 0.0)
    voxel_reso = 0.02 * (target_lvl / 4.0)
    state, n_ins = L.insert_large_step(
        state, sel, cur_min, target_lvl,
        scene_extent=float(extent), voxel_reso=float(voxel_reso))
    n_ins, n_sel = int(n_ins), int(sel.sum())
    print(f"[insert_large] inserted {n_ins} aggregates at lvl "
          f"{target_lvl} (from {n_sel} selected)")

    # One pass at the target level to initialise the new rows' stats.
    st = state.gaussians
    for view in scene.train_views:
        camt = view.camera(sched.scales[target_lvl])
        outt = L.eval_render(state, camt, cfg=cfg, settings=settings,
                             reso_lvl=target_lvl)
        st = G.update_pixel_sizes(st, outt.pixel_sizes, target_lvl,
                                  cfg.reso_lvls)
    return state._replace(gaussians=st), n_ins, n_sel


def evaluate_scales(state, scene, sched, cfg, settings, args, bg, iteration):
    """Per-scale evaluation over the test set and 5 fixed train views
    (training_report): mean L1 and PSNR, median and mean render time, and
    at the final iteration SSIM and, when its weights exist, LPIPS."""
    from msgs_torch.eval.lpips import lpips_if_available
    from msgs_torch.eval.metrics import l1_loss, psnr, ssim
    from msgs_torch.train import loop as L

    dev = bg.device
    final = iteration >= getattr(args, "iterations", 10 ** 9)
    lpips = lpips_if_available(dev) if final else None
    # The eval scales may differ from the train scales; the appearance
    # level for an arbitrary scale is its log2, rounded.
    eval_scales = getattr(args, "ms_test_scales", None) or sched.scales
    report = {}
    configs = [("test", scene.test_views),
               ("train", scene.train_views[:5])]
    for split, views in configs:
        if not views:
            continue
        for scale in eval_scales:
            lvl = min(max(int(round(math.log2(max(scale, 1)))), 0),
                      sched.reso_lvls - 1)
            l1s, psnrs, ssims, lpipss, times = [], [], [], [], []
            # Untimed warm-up.
            L.eval_render(state, views[0].camera(scale), cfg=cfg,
                          settings=settings, reso_lvl=lvl, bg=bg)
            _sync(dev)
            for view in views:
                cam = view.camera(scale)
                t0 = time.time()
                out = L.eval_render(state, cam, cfg=cfg, settings=settings,
                                    reso_lvl=lvl, bg=bg)
                img = torch.clamp(out.image, 0, 1)
                _sync(dev)
                times.append(time.time() - t0)
                gt = torch.as_tensor(view.image(scale), device=dev)
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                if final:
                    ssims.append(float(ssim(img, gt)))
                    if lpips is not None:
                        lpipss.append(float(lpips(img, gt)))
            entry = {
                "l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs)),
                "render_ms": float(np.median(times) * 1000),
                "render_ms_mean": float(np.mean(times) * 1000)}
            if ssims:
                entry["ssim"] = float(np.mean(ssims))
            if lpipss:
                entry["lpips"] = float(np.mean(lpipss))
            report[f"{split}_s{scale}"] = entry
            print(f"[eval {iteration}] {split} x{scale}: "
                  f"psnr {np.mean(psnrs):.2f} l1 {np.mean(l1s):.4f} "
                  + (f"ssim {np.mean(ssims):.4f} " if ssims else "")
                  + f"{np.mean(times)*1000:.1f}ms")
    return report


def main(argv=None, on_iteration=None):
    args = build_parser().parse_args(argv)
    return training(args, on_iteration=on_iteration)


if __name__ == "__main__":
    main()
