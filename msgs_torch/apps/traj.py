"""Trajectory video renderer: port of msgs/apps/traj.py.

Renders a generated camera path (circle or spiral) with a resolution scale
that sweeps sinusoidally from --min_scale to --max_scale and back, times
each frame, and writes <out_dir>/trajectory.mp4 and frame_times.txt.

  python -m msgs_torch.apps.traj -m <model> [--traj circle|spiral]
      [--n_frames N] [--anti_alias] [--min_scale 1 --max_scale 64]
      [--device cpu]

Each frame is upscaled to the first training view's size by a numpy
nearest-neighbour resize that equals OpenCV's INTER_NEAREST, so the app
needs no cv2. The video goes through imageio with its ffmpeg plugin
(msgs_torch.apps.video_tools.write_video); without one the app stops
before rendering anything.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np


def circle_trajectory(views, n_frames: int, radius_frac: float = 0.3):
    """(R, T) poses on a circle around the centroid of the training cameras,
    each looking at that centroid."""
    centers = []
    for v in views:
        W2C = np.eye(4)
        W2C[:3, :3] = v.R.T
        W2C[:3, 3] = v.T
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3])
    centers = np.stack(centers)
    centroid = centers.mean(0)
    radius = np.linalg.norm(centers - centroid, axis=1).mean() * radius_frac
    base = views[0]
    up = base.R[:, 1]

    frames = []
    for i in range(n_frames):
        ang = 2 * math.pi * i / n_frames
        offset = (math.cos(ang) * base.R[:, 0]
                  + math.sin(ang) * base.R[:, 2]) * radius
        pos = centroid + offset
        fwd = centroid - pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)
        T = -R.T @ pos
        frames.append((R, T))
    return frames


def spiral_trajectory(views, n_frames: int):
    frames = circle_trajectory(views, n_frames)
    out = []
    for i, (R, T) in enumerate(frames):
        lift = 0.1 * math.sin(4 * math.pi * i / n_frames)
        out.append((R, T + np.array([0, lift, 0])))
    return out


def sweep_scale(i: int, n_frames: int, min_scale: float,
                max_scale: float) -> float:
    """Frame i's resolution scale: min_scale at frame 0, max_scale halfway,
    geometric in between."""
    t = 0.5 - 0.5 * math.cos(2 * math.pi * i / n_frames)
    return min_scale * (max_scale / min_scale) ** t


def nearest_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST):
    output index x reads source index min(floor(x · (1 / (width / w))),
    w − 1) in double precision, as OpenCV computes it, and so on rows."""
    h, w = img.shape[:2]
    cols = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))),
                      w - 1).astype(np.int64)
    rows = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))),
                      h - 1).astype(np.int64)
    return img[rows[:, None], cols[None, :]]


def trajectory_frames(state, cfg, view0, poses, settings, min_scale=1.0,
                      max_scale=64.0, fade_size=1.0):
    """Render `poses` with view0's fields of view, frame i at
    `sweep_scale(i, len(poses), ...)` (its size rounded down to a multiple
    of 16, at least 16), each upscaled to view0's size. Returns (uint8
    (H, W, 3) frames, seconds per frame on the host clock: each render
    is synchronised with its CUDA device before the clock stops)."""
    import torch

    from msgs_torch.apps.render import to_uint8
    from msgs_torch.core.camera import make_camera
    from msgs_torch.train import loop as L
    dev = state.xyz.device
    n = len(poses)
    images, times = [], []
    for i, (R, T) in enumerate(poses):
        scale = sweep_scale(i, n, min_scale, max_scale)
        w = max(int(view0.width / scale) // 16 * 16, 16)
        h = max(int(view0.height / scale) // 16 * 16, 16)
        cam = make_camera(R, T, view0.fovx, view0.fovy, w, h, device=dev)
        t0 = time.perf_counter()
        out = L.eval_render(state, cam, cfg=cfg, settings=settings,
                            fade_size=fade_size)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        img = nearest_resize(out.image.cpu().numpy(), view0.width,
                             view0.height)
        images.append(to_uint8(img))
        if i % 10 == 0:
            print(f"frame {i}/{n} x{scale:.1f} {times[-1]*1000:.1f}ms")
    return images, times


def render_trajectory(args):
    from msgs_torch import resolve_device
    from msgs_torch.apps.render import load_viewing_model
    from msgs_torch.apps.video_tools import check_video_writer, write_video
    from msgs_torch.kernels.rasterize import RasterSettings

    dev = resolve_device(args.device)
    video_path = os.path.join(args.out_dir, "trajectory.mp4")
    check_video_writer(video_path)
    state, cfg, scene = load_viewing_model(
        args.model_path, args.source_path, args.iteration, dev)
    gen = circle_trajectory if args.traj == "circle" else spiral_trajectory
    poses = gen(scene.train_views, args.n_frames)
    settings = RasterSettings(
        backend=args.backend, entry_cap=args.entry_cap,
        filter_small=args.anti_alias, filter_large=args.anti_alias)

    os.makedirs(args.out_dir, exist_ok=True)
    images, times = trajectory_frames(
        state, cfg, scene.train_views[0], poses, settings,
        args.min_scale, args.max_scale, args.fade_size)
    write_video(video_path, images, args.fps)
    print(f"wrote {video_path}; mean render "
          f"{np.mean(times)*1000:.1f}ms/frame")
    with open(os.path.join(args.out_dir, "frame_times.txt"), "w") as f:
        f.writelines(f"{t*1000:.2f}\n" for t in times)


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch traj")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--traj", choices=["circle", "spiral"], default="circle")
    p.add_argument("--n_frames", type=int, default=120)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--min_scale", type=float, default=1.0)
    p.add_argument("--max_scale", type=float, default=64.0)
    p.add_argument("--fade_size", type=float, default=1.0)
    p.add_argument("--anti_alias", action="store_true")
    p.add_argument("--out_dir", default="traj_out")
    p.add_argument("--backend", default="pallas",
                   help="'pallas' / 'auto': the CUDA kernels on the card; "
                        "'reference': the plain PyTorch versions")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    render_trajectory(p.parse_args(argv))


if __name__ == "__main__":
    main()
