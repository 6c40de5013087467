"""Generate a synthetic multi-view dataset (Blender/NeRF-synthetic format)
by rendering a procedurally built ground-truth Gaussian model through
msgs_torch.

Port of tools/make_synthetic_scene.py (`build_gt_model` and `ring_cameras`
are copies of its pure-numpy helpers; the same seed gives the same model
and cameras). It writes the same layout: `train/` and `test/` PNGs (written
by msgs_torch.data.image), `transforms_{train,test}.json` and
`init_points.npz`, which both packages' loaders read. A checkerboard ground
plane, a striped wall, a fine-texture board and three detail clusters,
rendered from a ring of cameras onto black.

Usage: python -m msgs_torch.data.synthetic <out_dir> [--n_views 24]
       [--n_test 8] [--width 512 --height 512] [--n_gaussians 20000]
       [--seed 0] [--device cuda|cpu]
"""
import argparse
import json
import math
import os

import numpy as np
import torch


def build_gt_model(n: int, rng):
    """A structured Gaussian scene: checkered ground, three detail clusters,
    a back wall with stripes — lots of multi-frequency content."""
    pts, cols, scales = [], [], []

    # Scale discipline: the reference protocol prunes any Gaussian whose
    # accumulated screen radius exceeds 20 px once opacity resets begin
    # (gaussian_model.py:612, train.py:255). At 512² / fov 0.85 (focal
    # ≈563 px) and ring-camera depths ≥2.5, that caps survivable world
    # scales at ≈0.012·depth ⇒ ~0.03. Every GT splat stays under that, so
    # a valid fitted model exists inside the protocol's own constraints
    # (the earlier 0.1-0.12 ground/wall splats were unrepresentable: each
    # densify past iter 3000 pruned them and training collapsed).

    # Ground plane: grid of flat gaussians with checker colors.
    g = int(math.sqrt(n * 0.4))
    xs = np.linspace(-3, 3, g)
    zs = np.linspace(-3, 3, g)
    gx, gz = np.meshgrid(xs, zs)
    gy = np.full_like(gx, -1.0)
    checker = ((gx * 2).astype(int) + (gz * 2).astype(int)) % 2
    ground = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    gcol = np.where(checker.reshape(-1, 1) > 0,
                    np.array([[0.85, 0.8, 0.7]]), np.array([[0.25, 0.3, 0.35]]))
    pts.append(ground)
    cols.append(gcol.repeat(1, axis=0))
    scales.append(np.full((len(ground), 3), [0.03, 0.008, 0.03]))

    # Back wall with vertical stripes.
    w = int(math.sqrt(n * 0.2))
    wx, wy = np.meshgrid(np.linspace(-2.5, 2.5, w),
                         np.linspace(-0.5, 2.0, w // 2))
    wall = np.stack([wx, wy, np.full_like(wx, 4.0)], -1).reshape(-1, 3)
    stripe = (wx * 3).astype(int) % 3
    wcol = np.stack([0.2 + 0.3 * (stripe == 0), 0.2 + 0.4 * (stripe == 1),
                     0.3 + 0.4 * (stripe == 2)], -1).reshape(-1, 3)
    pts.append(wall)
    cols.append(wcol)
    scales.append(np.full((len(wall), 3), [0.025, 0.025, 0.008]))

    # Fine-texture board: a dense grid of tiny high-frequency colored
    # Gaussians on a tilted plane — sub-pixel at coarse render scales, the
    # aliasing source that filter_small / insert_large exist for.
    fb = int(math.sqrt(n * 0.25))
    fu, fv = np.meshgrid(np.linspace(-1.4, 1.4, fb),
                         np.linspace(-0.9, 0.9, fb))
    board = np.stack([fu + 2.2, 0.3 + fv * 0.9 + 0.25 * fu,
                      2.6 - 0.35 * fu], -1).reshape(-1, 3)
    fcheck = ((fu * 14).astype(int) + (fv * 14).astype(int)) % 2
    rainbow = np.stack([0.5 + 0.5 * np.sin(fu * 9),
                        0.5 + 0.5 * np.cos(fv * 11),
                        0.5 + 0.5 * np.sin((fu + fv) * 7)], -1)
    bcol = np.where(fcheck.reshape(-1, 1) > 0,
                    rainbow.reshape(-1, 3), 1.0 - rainbow.reshape(-1, 3))
    pts.append(board)
    cols.append(np.clip(bcol, 0, 1))
    scales.append(np.full((len(board), 3), [0.018, 0.018, 0.008]))

    # Detail clusters: dense colorful blobs at 3 spots.
    remaining = n - sum(len(p) for p in pts)
    centers = np.array([[-1.5, 0.0, 1.0], [1.5, 0.3, 0.0], [0.0, 0.8, 2.0]])
    per = max(remaining // 3, 1)
    for i, c in enumerate(centers):
        p = c + rng.normal(0, 0.45, (per, 3)) * np.array([1, 0.6, 1])
        hue = (np.arctan2(p[:, 0] - c[0], p[:, 2] - c[2]) / np.pi + 1) / 2
        col = np.stack([0.5 + 0.5 * np.sin(hue * 20 + i),
                        0.5 + 0.5 * np.cos(hue * 13),
                        0.4 + 0.6 * hue], -1)
        pts.append(p)
        cols.append(np.clip(col, 0, 1))
        scales.append(np.exp(rng.uniform(-4.4, -3.4, (per, 3))))

    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    scales = np.concatenate(scales).astype(np.float32)
    quats = rng.normal(size=(len(pts), 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.75, 0.98, len(pts)).astype(np.float32)
    return pts, cols, scales, quats, opac


def ring_cameras(n_views, radius=6.0, height=1.2, fov=0.85, phase=0.0):
    out = []
    for i in range(n_views):
        ang = 2 * math.pi * (i + phase) / n_views
        pos = np.array([radius * math.sin(ang), height,
                        -radius * math.cos(ang) + 0.5])
        target = np.array([0.0, 0.0, 0.5])
        fwd = target - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)
        T = -R.T @ pos
        out.append((R, T, fov))
    return out


def render_gt(pts, cols, scales, quats, opac, R, T, fov, width, height,
              device, entry_cap: int = 1 << 20) -> np.ndarray:
    """uint8 (H, W, 3) render of the ground-truth model on black; grows
    entry_cap until the binning does not overflow."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels.rasterize import RasterSettings, rasterize
    cam = make_camera(R, T, fov, fov, width, height, device=device)
    t = lambda a: torch.as_tensor(a, device=cam.world_view.device)
    while True:
        with torch.no_grad():
            out = rasterize(cam, t(pts), t(opac), colors_precomp=t(cols),
                            scales=t(scales), quats=t(quats),
                            bg=torch.zeros(3, device=cam.world_view.device),
                            settings=RasterSettings(entry_cap=entry_cap))
        if int(out.overflow) == 0:
            break
        entry_cap *= 2
    img = np.clip(out.image.cpu().numpy(), 0, 1)
    return (img * 255).astype(np.uint8)


def make_scene(out_dir: str, n_views: int = 24, n_test: int = 8,
               width: int = 512, height: int = 512, n_gaussians: int = 20000,
               seed: int = 0, device=None, quiet: bool = False):
    """Render the scene into out_dir. `device` None means the card."""
    from msgs_torch import resolve_device
    from msgs_torch.data.image import write_png
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts, cols, scales, quats, opac = build_gt_model(n_gaussians, rng)
    if not quiet:
        print(f"GT model: {len(pts)} gaussians")
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)

    def render_split(split, split_cams):
        frames = []
        for i, (R, T, fov) in enumerate(split_cams):
            img = render_gt(pts, cols, scales, quats, opac, R, T, fov, width,
                            height, dev)
            write_png(os.path.join(out_dir, split, f"r_{i}.png"), img)
            c2w = np.linalg.inv(np.block([
                [R.T, T[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]]))
            c2w[:3, 1:3] *= -1   # to OpenGL convention for the loader
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": split_cams[0][2], "frames": frames},
                      f)

    render_split("train", ring_cameras(n_views))
    # Held-out views: the same ring at half-step offset angles.
    render_split("test", ring_cameras(n_test, phase=0.45))

    # Noisy SfM-like init cloud: subsampled GT positions + noise.
    keep = rng.choice(len(pts), min(len(pts) // 4, 20000), replace=False)
    sfm = pts[keep] + rng.normal(0, 0.03, (len(keep), 3)).astype(np.float32)
    np.savez(os.path.join(out_dir, "init_points.npz"),
             points=sfm, colors=cols[keep])
    if not quiet:
        print(f"wrote {out_dir}: {n_views} train + {n_test} test views, "
              f"{len(keep)} init points")


def main(argv=None):
    ap = argparse.ArgumentParser("msgs_torch synthetic scene")
    ap.add_argument("out_dir")
    ap.add_argument("--n_views", type=int, default=24)
    ap.add_argument("--n_test", type=int, default=8,
                    help="held-out test views at offset ring angles")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--n_gaussians", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    make_scene(args.out_dir, args.n_views, args.n_test, args.width,
               args.height, args.n_gaussians, args.seed, args.device)


if __name__ == "__main__":
    main()
