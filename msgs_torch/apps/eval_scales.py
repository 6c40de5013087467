"""Offline multi-scale evaluation of a saved model: port of
msgs/apps/eval_scales.py.

Computes per-scale L1, PSNR, SSIM (and LPIPS when weights exist) over the
test split and the first --n_train_views train views of a saved PLY
snapshot, or of a chkpntN.npz train state with --checkpoint, and writes
eval_scales_<it>[_ungated].json with the JAX app's keys, one line per
(split, scale). render_ms is the median host-clock time of a render, from
the call to a synchronised, clipped image, without the first view.

  python -m msgs_torch.apps.eval_scales -m <model_path> [--iteration N]
      [--scales 1 2 4 8] [--skip_train] [--backend pallas] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch eval_scales")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--scales", nargs="+", type=float,
                   default=[1, 2, 4, 8, 16, 32, 64])
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--n_train_views", type=int, default=5,
                   help="train views evaluated (reference uses 5)")
    p.add_argument("--backend", default="pallas",
                   help="'pallas' / 'auto': the CUDA kernels on the card; "
                        "'reference': the plain PyTorch versions")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--anti_alias", action="store_true",
                   help="filter_small+filter_large, viewer.py:59-64")
    p.add_argument("--fade_ungated", action="store_true",
                   help="with --anti_alias: filter_small keys on the "
                        "current footprint alone")
    p.add_argument("--fade_size", type=float, default=0.0)
    p.add_argument("--checkpoint", default=None,
                   help="evaluate a chkpntN.npz train state instead of a "
                        "PLY snapshot")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from msgs_torch import resolve_device
    from msgs_torch.apps.config import load_cfg
    from msgs_torch.apps.render import background, load_ply_model, \
        load_saved_scene
    from msgs_torch.eval.lpips import lpips_if_available
    from msgs_torch.eval.metrics import l1_loss, psnr, ssim
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig
    from msgs_torch.train import loop as L

    dev = resolve_device(args.device)
    saved = load_cfg(args.model_path)
    scene = load_saved_scene(saved, args.source_path, dev)

    if args.checkpoint:
        # The trainer's state template from the saved config (the path the
        # trainer resumes through); the shapes come from the npz.
        from msgs_torch.model.gaussians import create_from_points
        from msgs_torch.train.checkpoint import load_train_state
        it = int("".join(c for c in os.path.basename(args.checkpoint)
                         if c.isdigit()) or 0)
        cfg = GaussianConfig(
            sh_degree=int(saved.get("sh_degree", 3)),
            reso_lvls=int(saved.get("ms_train_max_scale", 7)) + 1,
            multi_occ=bool(saved.get("multi_occ", False)),
            multi_dc=bool(saved.get("multi_dc", False)),
            capacity=int(saved.get("capacity", 1 << 17)))
        print(f"Loading {args.checkpoint}")
        template = L.init_train_state(create_from_points(
            cfg, scene.points[:1], scene.colors[:1], device=dev))
        state = load_train_state(args.checkpoint, template)
        cfg = cfg._replace(capacity=int(state.gaussians.xyz.shape[0]))
    else:
        state, cfg, it = load_ply_model(args.model_path, args.iteration,
                                        int(saved.get("sh_degree", 3)), dev)
    settings = RasterSettings(
        backend=args.backend, entry_cap=args.entry_cap,
        filter_small=args.anti_alias, filter_large=args.anti_alias,
        fade_ungated=args.fade_ungated)
    bg = background(saved, dev)
    lpips = lpips_if_available(dev)

    report = {}
    splits = []
    if not args.skip_test and scene.test_views:
        splits.append(("test", scene.test_views))
    if not args.skip_train and scene.train_views:
        splits.append(("train", scene.train_views[:args.n_train_views]))
    for split, views in splits:
        for scale in args.scales:
            lvl = min(max(int(round(math.log2(max(scale, 1)))), 0),
                      cfg.reso_lvls - 1)
            l1s, psnrs, ssims, lpipss, times = [], [], [], [], []
            for view in views:
                cam = view.camera(scale)
                t0 = time.perf_counter()
                out = L.eval_render(state, cam, cfg=cfg, settings=settings,
                                    reso_lvl=lvl, bg=bg,
                                    fade_size=args.fade_size)
                img = torch.clamp(out.image, 0, 1)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
                gt = torch.as_tensor(view.image(scale), device=dev)
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                ssims.append(float(ssim(img, gt)))
                if lpips is not None:
                    lpipss.append(float(lpips(img, gt)))
            entry = {"l1": float(np.mean(l1s)),
                     "psnr": float(np.mean(psnrs)),
                     "ssim": float(np.mean(ssims)),
                     "render_ms": float(np.median(times[1:] or times) * 1000),
                     "render_ms_mean": float(np.mean(times[1:] or times)
                                             * 1000)}
            if lpipss:
                entry["lpips"] = float(np.mean(lpipss))
            report[f"{split}_s{scale:g}"] = entry
            print(f"[eval_scales {it}] {split} x{scale:g}: "
                  f"psnr {entry['psnr']:.2f} ssim {entry['ssim']:.4f} "
                  f"l1 {entry['l1']:.4f} {entry['render_ms']:.1f}ms",
                  flush=True)

    tag = "_ungated" if args.fade_ungated else ""
    out_path = os.path.join(args.model_path, f"eval_scales_{it}{tag}.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    main()
