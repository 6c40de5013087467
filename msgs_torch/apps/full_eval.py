"""End-to-end published-result pipeline: port of msgs/apps/full_eval.py.

Train → render at 7k / 30k (and 40k with --ms) → metrics over the 13
standard scenes (Mip-NeRF 360 images_4 outdoor / images_2 indoor, Tanks &
Temples, Deep Blending), through msgs_torch's train, render and metrics
apps. Unknown flags go to the trainer; --device goes to all three.

  python -m msgs_torch.apps.full_eval --mipnerf360 <dir>
      --tanksandtemples <dir> --deepblending <dir> --output_path <out>
      [--skip_training ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch full_eval")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--output_path", default="./eval")
    p.add_argument("--mipnerf360", "-m360", default="")
    p.add_argument("--tanksandtemples", "-tat", default="")
    p.add_argument("--deepblending", "-db", default="")
    p.add_argument("--ms", action="store_true",
                   help="use the full multi-scale method (ms_train + "
                        "filter_small + insert_large, 40k iters)")
    p.add_argument("--device", default=None,
                   help="torch device for every app (default: the CUDA "
                        "device)")
    args, extra = p.parse_known_args(argv)

    scenes = []
    for s in MIPNERF360_OUTDOOR:
        scenes.append((os.path.join(args.mipnerf360, s), "images_4", 7))
    for s in MIPNERF360_INDOOR:
        scenes.append((os.path.join(args.mipnerf360, s), "images_2", 7))
    for s in TANKS_AND_TEMPLES:
        scenes.append((os.path.join(args.tanksandtemples, s), "images", 6))
    for s in DEEP_BLENDING:
        scenes.append((os.path.join(args.deepblending, s), "images", 6))
    scenes = [(src, imgs, ms) for src, imgs, ms in scenes
              if os.path.isdir(src)]
    if not scenes:
        print("no scene directories found — pass --mipnerf360/-tat/-db")
        return

    from msgs_torch.apps import metrics as metrics_app
    from msgs_torch.apps import render as render_app
    from msgs_torch.apps import train as train_app

    device = ["--device", args.device] if args.device else []
    all_outs = []
    for source, images, max_scale in scenes:
        name = os.path.basename(source.rstrip("/"))
        out = os.path.join(args.output_path, name)
        all_outs.append(out)
        common = ["-s", source, "-m", out, "--images", images, "--eval",
                  "--quiet"]
        if args.ms:
            common += ["--ms_train", "--filter_small", "--insert_large",
                       "--ms_train_max_scale", str(max_scale),
                       "--iterations", "40000",
                       "--test_iterations", "7000", "30000", "40000",
                       "--save_iterations", "7000", "30000", "40000"]
        if not args.skip_training:
            train_app.main(common + list(extra) + device)
        if not args.skip_rendering:
            iters = ["7000", "30000"] + (["40000"] if args.ms else [])
            for it in iters:
                render_app.main(["-m", out, "--iteration", it,
                                 "--skip_train"] + device)
        if not args.skip_metrics:
            metrics_app.main(["-m", out] + device)

    print("full_eval done:", all_outs)


if __name__ == "__main__":
    main()
