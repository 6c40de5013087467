"""Offline metric evaluation: port of msgs/apps/metrics.py.

Walks <model>/<split>/ours_<iter>/{renders,gt}, computes per-image SSIM,
PSNR and, when LPIPS weights exist (msgs_torch/eval/lpips.py), LPIPS, and
writes results.json and per_view.json with the JAX app's keys. Images are
read as the JAX app reads them: uint8 / 255.0 in float64, then float32.

  python -m msgs_torch.apps.metrics -m <model_path> [<model_path2> ...]
      [--splits test] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def evaluate(model_paths, splits=("test",), device=None):
    import torch

    from msgs_torch import resolve_device
    from msgs_torch.data.image import read_png
    from msgs_torch.eval.lpips import lpips_if_available
    from msgs_torch.eval.metrics import psnr, ssim

    dev = resolve_device(device)
    lpips = lpips_if_available(dev)

    def load(path):
        img = read_png(path)[..., :3] / 255.0
        return torch.as_tensor(img.astype(np.float32), device=dev)

    for model_path in model_paths:
        print(f"Evaluating {model_path}")
        full, per_view = {}, {}
        for split in splits:
            split_dir = os.path.join(model_path, split)
            if not os.path.isdir(split_dir):
                continue
            for method in sorted(os.listdir(split_dir)):
                mdir = os.path.join(split_dir, method)
                rdir = os.path.join(mdir, "renders")
                gdir = os.path.join(mdir, "gt")
                if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                    continue
                ssims, psnrs, lpipss, names = [], [], [], []
                for fname in sorted(os.listdir(rdir)):
                    r = load(os.path.join(rdir, fname))
                    g = load(os.path.join(gdir, fname))
                    ssims.append(float(ssim(r, g)))
                    psnrs.append(float(psnr(r, g)))
                    if lpips is not None:
                        lpipss.append(float(lpips(r, g)))
                    names.append(fname)
                entry = {
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                }
                if lpipss:
                    entry["LPIPS"] = float(np.mean(lpipss))
                full[method] = entry
                per_view[method] = {
                    "SSIM": dict(zip(names, ssims)),
                    "PSNR": dict(zip(names, psnrs)),
                    **({"LPIPS": dict(zip(names, lpipss))} if lpipss else {}),
                }
                print(f"  {method}: PSNR {entry['PSNR']:.4f} "
                      f"SSIM {entry['SSIM']:.4f}"
                      + (f" LPIPS {entry['LPIPS']:.4f}"
                         if "LPIPS" in entry else ""))
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch metrics")
    p.add_argument("-m", "--model_paths", nargs="+", required=True)
    p.add_argument("--splits", nargs="+", default=["test"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    a = p.parse_args(argv)
    evaluate(a.model_paths, a.splits, a.device)


if __name__ == "__main__":
    main()
