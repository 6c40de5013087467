"""Batch ablation driver: port of msgs/apps/train_all.py.

A scene × method sweep over the paper's ablation configurations, each run
through msgs_torch.apps.train. Unknown flags go to the trainer, and so
does --device.

  python -m msgs_torch.apps.train_all -s <scenes_root> -m <out_root>
      [--methods ms base abl_ms_train ...] [--scenes garden room]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os

# The JAX driver's ablation matrix (reference train_all.py:39-185): extra
# trainer flags per method.
METHOD_DICT = {
    "base": [],
    "ms": ["--ms_train", "--filter_small", "--insert_large",
           "--iterations", "40000",
           "--test_iterations", "7000", "30000", "40000",
           "--save_iterations", "40000"],
    "abl_ms_train": ["--ms_train",
                     "--iterations", "40000",
                     "--save_iterations", "40000"],
    "abl_filter_small": ["--ms_train", "--filter_small",
                         "--iterations", "40000",
                         "--save_iterations", "40000"],
    "abl_insert_large": ["--ms_train", "--insert_large",
                         "--iterations", "40000",
                         "--save_iterations", "40000"],
    "abl_grow_large": ["--ms_train", "--filter_small", "--grow_large",
                       "--iterations", "40000",
                       "--save_iterations", "40000"],
    "abl_multi_app": ["--ms_train", "--filter_small", "--insert_large",
                      "--multi_occ", "--multi_dc",
                      "--iterations", "40000",
                      "--save_iterations", "40000"],
    "ms_best": ["--ms_train", "--filter_small", "--insert_large",
                "--fade_ungated", "--multi_occ", "--multi_dc",
                "--iterations", "40000",
                "--test_iterations", "7000", "30000", "40000",
                "--save_iterations", "40000"],
}

# Per-dataset max scale (reference train_all.py:221-231).
DATASET_MAX_SCALE = {"360_v2": 7, "tandt": 6, "db": 6}


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch train_all")
    p.add_argument("-s", "--scenes_root", required=True)
    p.add_argument("-m", "--output_root", required=True)
    p.add_argument("--methods", nargs="+", default=["base", "ms"])
    p.add_argument("--scenes", nargs="+", default=None)
    p.add_argument("--max_scale", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args, extra = p.parse_known_args(argv)

    from msgs_torch.apps import train as train_app

    scenes = args.scenes or sorted(
        d for d in os.listdir(args.scenes_root)
        if os.path.isdir(os.path.join(args.scenes_root, d)))
    dataset = os.path.basename(args.scenes_root.rstrip("/"))
    max_scale = args.max_scale or DATASET_MAX_SCALE.get(dataset, 7)
    device = ["--device", args.device] if args.device else []

    for scene in scenes:
        for method in args.methods:
            if method not in METHOD_DICT:
                raise SystemExit(f"unknown method {method}; "
                                 f"have {sorted(METHOD_DICT)}")
            src = os.path.join(args.scenes_root, scene)
            out = os.path.join(args.output_root, scene, method)
            flags = list(METHOD_DICT[method])
            if "--ms_train" in flags:
                flags += ["--ms_train_max_scale", str(max_scale)]
            print(f"=== {scene} / {method} ===")
            train_app.main(["-s", src, "-m", out, "--eval", "--quiet"]
                           + flags + list(extra) + device)


if __name__ == "__main__":
    main()
