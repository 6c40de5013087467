"""Offline render CLI: port of msgs/apps/render.py.

Renders the train and test splits of a saved model to PNG pairs,
<model>/<split>/ours_<iter>/{renders,gt}/NNNNN.png, for
msgs_torch.apps.metrics. Images are quantised as the JAX app does,
`(clip(img, 0, 1) * 255).astype(uint8)`, which truncates.

  python -m msgs_torch.apps.render -m <model_path> [--iteration N]
      [--skip_train] [--skip_test] [--reso_scale S] [--anti_alias]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def find_iteration(model_path: str, iteration: int) -> int:
    """`iteration`, or with −1 the largest saved point_cloud/iteration_N."""
    base = os.path.join(model_path, "point_cloud")
    if iteration != -1:
        return iteration
    iters = [int(d.split("_")[-1]) for d in os.listdir(base)
             if d.startswith("iteration_")]
    return max(iters)


def load_ply_model(model_path: str, iteration: int, sh_degree: int, dev):
    """(GaussianState, GaussianConfig, iteration) of a saved PLY snapshot,
    at the capacity the JAX apps give it (the next power of two ≥ 1024 above
    its row count) and 8 resolution levels."""
    from msgs_torch.data.ply import read_ply
    from msgs_torch.model.gaussians import GaussianConfig
    from msgs_torch.train.checkpoint import load_ply_snapshot
    it = find_iteration(model_path, iteration)
    ply = os.path.join(model_path, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    print(f"Loading {ply}")
    n = len(read_ply(ply)["x"])
    cap = 1 << max(int(n).bit_length(), 10)
    cfg = GaussianConfig(sh_degree=sh_degree, reso_lvls=8, capacity=cap)
    return load_ply_snapshot(ply, cfg, dev), cfg, it


def load_saved_scene(saved: dict, source_path, dev):
    """The scene a model was trained on, from its saved config."""
    from msgs_torch.data.dataset import load_scene
    return load_scene(source_path or saved.get("source_path", ""),
                      images_dir=saved.get("images", "images"),
                      eval_split=bool(saved.get("eval", False)),
                      resolution=int(saved.get("resolution", -1)),
                      white_background=bool(saved.get("white_background",
                                                      False)),
                      device=dev)


def load_viewing_model(model_path: str, source_path, iteration: int, dev):
    """(GaussianState, GaussianConfig, SceneData) as the viewer and traj
    load a model: the PLY by `load_ply_model`, and the scene by
    `load_scene(source, eval_split=False, resolution=<saved>)` alone, as
    msgs/apps/viewer.py and traj.py call it. Unlike `load_saved_scene`,
    the saved images folder, eval split and background are not passed."""
    from msgs_torch.apps.config import load_cfg
    from msgs_torch.data.dataset import load_scene
    saved = load_cfg(model_path)
    st, cfg, _ = load_ply_model(model_path, iteration,
                                int(saved.get("sh_degree", 3)), dev)
    scene = load_scene(source_path or saved.get("source_path", ""),
                       eval_split=False,
                       resolution=int(saved.get("resolution", -1)),
                       device=dev)
    return st, cfg, scene


def background(saved: dict, dev):
    import torch
    white = bool(saved.get("white_background", False))
    return torch.full((3,), 1.0 if white else 0.0, dtype=torch.float32,
                      device=dev)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """The JAX apps' quantisation: clip to [0, 1], scale by 255, truncate."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def truncation_mismatches(a, b, floats_a, tol: float = 1e-5) -> int:
    """Pixels at which uint8 images a and b differ by more than `to_uint8`
    of two renders within tol of each other can: by more than 1, or by 1
    where floats_a (the [0, 1] image a was quantised from) ·255 lies
    farther than tol·255 from an integer, the truncation's boundary."""
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shapes {a.shape} and {b.shape}")
    diff = np.abs(a - b)
    v = np.clip(np.asarray(floats_a, np.float64), 0, 1) * 255
    near = np.abs(v - np.round(v)) <= tol * 255
    return int(((diff > 1) | ((diff == 1) & ~near)).sum())


def render_sets(args):
    from msgs_torch import resolve_device
    from msgs_torch.apps.config import load_cfg
    from msgs_torch.data.image import write_png
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.train import loop as L

    dev = resolve_device(args.device)
    saved = load_cfg(args.model_path)
    st, cfg, it = load_ply_model(args.model_path, args.iteration,
                                 int(saved.get("sh_degree", 3)), dev)
    scene = load_saved_scene(saved, args.source_path, dev)
    settings = RasterSettings(
        backend=args.backend, entry_cap=args.entry_cap,
        filter_small=args.anti_alias, filter_large=args.anti_alias)
    bg = background(saved, dev)

    for split, views in (("train", scene.train_views),
                         ("test", scene.test_views)):
        if (split == "train" and args.skip_train) or \
           (split == "test" and args.skip_test) or not views:
            continue
        out_dir = os.path.join(args.model_path, split, f"ours_{it}")
        rdir = os.path.join(out_dir, "renders")
        gdir = os.path.join(out_dir, "gt")
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        for i, view in enumerate(views):
            out = L.eval_render(st, view.camera(args.reso_scale), cfg=cfg,
                                settings=settings, bg=bg,
                                fade_size=args.fade_size)
            write_png(os.path.join(rdir, f"{i:05d}.png"),
                      to_uint8(out.image.cpu().numpy()))
            write_png(os.path.join(gdir, f"{i:05d}.png"),
                      to_uint8(view.image(args.reso_scale)))
            view.drop_cache()
        print(f"[render] {split}: {len(views)} views -> {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch render")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--reso_scale", type=float, default=1.0)
    p.add_argument("--fade_size", type=float, default=0.0)
    p.add_argument("--anti_alias", action="store_true")
    p.add_argument("--backend", default="pallas",
                   help="'pallas' / 'auto': the CUDA kernels on the card; "
                        "'reference': the plain PyTorch versions")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    render_sets(p.parse_args(argv))


if __name__ == "__main__":
    main()
