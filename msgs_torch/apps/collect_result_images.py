"""Per-image qualitative comparison grids: port of
msgs/apps/collect_result_images.py.

Renders each method's saved model of a scene at a view × scale matrix and
writes comparison figures (rows = scales, columns = GT and the methods,
centre-cropped, coarse rows upsampled to the finest row's width) and a
per-image PSNR CSV. Labels are burnt in through PIL where it imports, as
the JAX app does; without PIL the figures are unlabelled.

  python -m msgs_torch.apps.collect_result_images -m <out_root>/<scene> \
      [--methods base ms] [--scales 1 8 32] [--views 0 2] [-o figs/]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

# Display names, reference collect_result_images.py:34-41.
FULL_NAMES = {
    "gt": "Ground Truth",
    "base": "3DGS",
    "abl_ms_train": "3DGS+MS Train",
    "abl_filter_small": "3DGS+Filter Small",
    "abl_insert_large": "3DGS+Insert Large",
    "ms": "Full Method",
}


def _label(img: np.ndarray, text: str) -> np.ndarray:
    """Burn a text label into the bottom-left corner (PIL), or leave the
    image as it is where PIL is not installed."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return img
    im = Image.fromarray(img)
    draw = ImageDraw.Draw(im)
    h = im.size[1]
    draw.text((4, h - 14), text, fill=(255, 255, 255))
    draw.text((3, h - 15), text, fill=(0, 0, 0))
    return np.asarray(im)


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch collect_result_images")
    p.add_argument("-m", "--scene_root", required=True,
                   help="<out_root>/<scene> containing one dir per method")
    p.add_argument("-o", "--out_dir", default=None)
    p.add_argument("--methods", nargs="+", default=None)
    p.add_argument("--scales", nargs="+", type=float, default=[1, 8, 32])
    p.add_argument("--views", nargs="+", type=int, default=None,
                   help="test-view indices (default: first 2)")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--width_ratio", type=float, default=0.6,
                   help="center-crop fraction of width "
                        "(collect_result_images.py:49)")
    p.add_argument("--anti_alias", action="store_true",
                   help="render every method with filter_small+filter_large "
                        "instead of each method's own flags")
    p.add_argument("--backend", default="auto")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    import torch

    from msgs_torch import resolve_device
    from msgs_torch.apps.config import load_cfg
    from msgs_torch.apps.render import background, load_ply_model, \
        load_saved_scene, to_uint8
    from msgs_torch.data.image import write_png
    from msgs_torch.eval.metrics import psnr
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.train import loop as L

    dev = resolve_device(args.device)
    methods = args.methods or sorted(
        d for d in os.listdir(args.scene_root)
        if os.path.isdir(os.path.join(args.scene_root, d, "point_cloud")))
    if not methods:
        raise SystemExit(f"no trained methods under {args.scene_root}")
    out_dir = args.out_dir or os.path.join(args.scene_root, "figures")
    os.makedirs(out_dir, exist_ok=True)

    # The scene comes from the first method's saved config (all methods of
    # a scene share the source).
    states = {}
    scene = None
    for m in methods:
        mpath = os.path.join(args.scene_root, m)
        saved = load_cfg(mpath)
        st, cfg, it = load_ply_model(mpath, args.iteration,
                                     int(saved.get("sh_degree", 3)), dev)
        if scene is None:
            scene = load_saved_scene(saved, None, dev)
        flt = args.anti_alias or bool(saved.get("filter_small", False))
        fll = args.anti_alias or bool(saved.get("insert_large", False)) \
            or bool(saved.get("grow_large", False))
        settings = RasterSettings(backend=args.backend,
                                  entry_cap=args.entry_cap,
                                  filter_small=flt, filter_large=fll)
        states[m] = (st, cfg, settings, background(saved, dev))

    views = scene.test_views or scene.train_views
    idxs = args.views if args.views is not None else list(
        range(min(2, len(views))))

    rows_csv = []
    for vi in idxs:
        view = views[vi]
        rows = []
        for scale in args.scales:
            lvl = int(round(np.log2(max(scale, 1))))
            cam = view.camera(scale)
            gt = np.asarray(view.image(scale))
            cols = [_label(to_uint8(gt), FULL_NAMES["gt"] + f"  x{scale:g}")]
            for m in methods:
                st, cfg, settings, bg = states[m]
                out = L.eval_render(st, cam, cfg=cfg, settings=settings,
                                    reso_lvl=min(lvl, cfg.reso_lvls - 1),
                                    bg=bg)
                img = np.clip(out.image.cpu().numpy(), 0, 1)
                val = float(psnr(torch.as_tensor(img), torch.as_tensor(gt)))
                rows_csv.append([vi, scale, m, f"{val:.3f}"])
                cols.append(_label(to_uint8(img),
                                   f"{FULL_NAMES.get(m, m)}  {val:.1f}dB"))
            # Centre crop (reference width_ratio), then upsample coarse
            # scales to the finest row's width for a rectangular grid.
            w = cols[0].shape[1]
            cw = max(int(w * args.width_ratio), 1)
            x0 = (w - cw) // 2
            cols = [c[:, x0:x0 + cw] for c in cols]
            row = np.concatenate(cols, axis=1)
            if rows:
                reps = max(rows[0].shape[1] // row.shape[1], 1)
                row = np.repeat(np.repeat(row, reps, 0), reps, 1)
                row = row[:, :rows[0].shape[1]]
            rows.append(row)
        width = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)))
                for r in rows]
        fig = np.concatenate(rows, axis=0)
        path = os.path.join(out_dir, f"view{vi:03d}.png")
        write_png(path, fig)
        print(f"wrote {path}")

    with open(os.path.join(out_dir, "per_image_psnr.csv"), "w",
              newline="") as f:
        wtr = csv.writer(f)
        wtr.writerow(["view", "scale", "method", "psnr"])
        wtr.writerows(rows_csv)
    print(f"wrote {os.path.join(out_dir, 'per_image_psnr.csv')}")


if __name__ == "__main__":
    main()
