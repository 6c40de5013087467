"""Video and figure assembly: port of msgs/apps/video_tools.py.

Cut segments out of videos and stack them side by side, concatenate image
grids, and plot the training cameras from above.

  python -m msgs_torch.apps.video_tools cut_and_stack -i a.mp4 b.mp4
      -o out.mp4 [--start 0 --end 5] [--axis h|v]
  python -m msgs_torch.apps.video_tools concat -i img1.png img2.png
      -o grid.png [--cols 2]
  python -m msgs_torch.apps.video_tools visualize_cameras -s <scene>
      -o cams.png [--device cpu]

PNG files are read and written by msgs_torch/data/image.py, so images need
neither PIL nor imageio. Other image formats and every video go through
imageio, as in the JAX app; a video format also needs imageio's ffmpeg
plugin (`pip install "imageio[ffmpeg]"`), and `write_video` says so
before any work is done when it is missing.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(
            'reading or writing video needs imageio: pip install '
            '"imageio[ffmpeg]"') from e
    return imageio


def check_video_writer(path: str):
    """Raise unless an installed imageio plugin can write `path`'s format
    (for .mp4: the ffmpeg or pyav plugin). Writes nothing."""
    _imageio()
    from imageio.config import extensions, known_plugins
    ext = os.path.splitext(path)[1].lower()
    names = [n for e in extensions.extension_list if e.extension == ext
             for n in e.priority]
    for name in names:
        try:
            known_plugins[name].plugin_class   # imports the plugin's backend
            return
        except ImportError:
            continue
    raise RuntimeError(
        f"{path}: no installed imageio plugin writes {ext or 'this format'} "
        f"(tried {', '.join(names) or 'none'}); pip install "
        f'"imageio[ffmpeg]"')


def write_video(path: str, frames, fps: int):
    """Write uint8 (H, W, 3) frames to `path` with imageio's mimwrite."""
    check_video_writer(path)
    _imageio().mimwrite(path, frames, fps=fps)


def read_image_file(path: str) -> np.ndarray:
    """uint8 pixels: a PNG by the port's decoder, else by imageio."""
    from msgs_torch.data.image import is_png, read_png
    if is_png(path):
        return read_png(path)
    return np.asarray(_imageio().imread(path))


def write_image_file(path: str, img: np.ndarray):
    """Write uint8 pixels: .png by the port's encoder, else by imageio."""
    from msgs_torch.data.image import write_png
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        _imageio().imwrite(path, img)


def cut_and_stack(inputs, output, start=0.0, end=None, axis="h", fps=30):
    check_video_writer(output)
    imageio = _imageio()
    clips = []
    for path in inputs:
        reader = imageio.get_reader(path)
        meta = reader.get_meta_data()
        src_fps = meta.get("fps", fps)
        frames = []
        for i, frame in enumerate(reader):
            t = i / src_fps
            if t < start:
                continue
            if end is not None and t > end:
                break
            frames.append(frame)
        reader.close()
        clips.append(frames)
    n = min(len(c) for c in clips)
    h = min(min(f.shape[0] for f in c[:n]) for c in clips)
    w = min(min(f.shape[1] for f in c[:n]) for c in clips)
    stacked = []
    ax = 1 if axis == "h" else 0
    for i in range(n):
        row = [c[i][:h, :w] for c in clips]
        stacked.append(np.concatenate(row, axis=ax))
    write_video(output, stacked, fps)
    print(f"wrote {output} ({n} frames)")


def concat_images(inputs, output, cols=None):
    imgs = [read_image_file(p) for p in inputs]
    h = min(i.shape[0] for i in imgs)
    w = min(i.shape[1] for i in imgs)
    imgs = [i[:h, :w] for i in imgs]
    cols = cols or len(imgs)
    rows = []
    for r in range(0, len(imgs), cols):
        row = imgs[r:r + cols]
        while len(row) < cols:
            row.append(np.zeros_like(imgs[0]))
        rows.append(np.concatenate(row, axis=1))
    write_image_file(output, np.concatenate(rows, axis=0))
    print(f"wrote {output}")


def visualize_cameras(source_path, output, device=None):
    """Top-down scatter of the camera centres, their look directions and
    the SfM points, drawn into an 800×800 image without matplotlib."""
    from msgs_torch import resolve_device
    from msgs_torch.data.dataset import load_scene
    scene = load_scene(source_path, eval_split=False,
                       device=resolve_device(device))
    centers, fwds = [], []
    for v in scene.train_views:
        W2C = np.eye(4)
        W2C[:3, :3] = v.R.T
        W2C[:3, 3] = v.T
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3])
        fwds.append(C2W[:3, 2])
    centers = np.stack(centers)
    fwds = np.stack(fwds)
    pts = scene.points

    size = 800
    canvas = np.full((size, size, 3), 255, np.uint8)
    allxy = np.concatenate([centers[:, [0, 2]], pts[:, [0, 2]]], axis=0)
    lo, hi = allxy.min(0), allxy.max(0)
    span = np.maximum(hi - lo, 1e-6)

    def to_px(xy):
        uv = (xy - lo) / span
        return (uv * (size - 40) + 20).astype(int)

    for p in to_px(pts[:, [0, 2]])[::max(len(pts) // 20000, 1)]:
        if 0 <= p[1] < size and 0 <= p[0] < size:
            canvas[size - 1 - p[1], p[0]] = (180, 180, 180)
    cps = to_px(centers[:, [0, 2]])
    for c in cps:
        y, x = size - 1 - c[1], c[0]
        canvas[max(y - 3, 0):y + 3, max(x - 3, 0):x + 3] = (200, 30, 30)
    for c, f in zip(centers, fwds):
        a = to_px(c[None, [0, 2]])[0]
        b = to_px((c + f * span.mean() * 0.05)[None, [0, 2]])[0]
        n = 20
        for t in range(n):
            p = (a + (b - a) * t / n).astype(int)
            if 0 <= p[1] < size and 0 <= p[0] < size:
                canvas[size - 1 - p[1], p[0]] = (30, 30, 220)
    write_image_file(output, canvas)
    print(f"wrote {output}")


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch video_tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    c1 = sub.add_parser("cut_and_stack")
    c1.add_argument("-i", "--inputs", nargs="+", required=True)
    c1.add_argument("-o", "--output", required=True)
    c1.add_argument("--start", type=float, default=0.0)
    c1.add_argument("--end", type=float, default=None)
    c1.add_argument("--axis", choices=["h", "v"], default="h")
    c1.add_argument("--fps", type=int, default=30)
    c2 = sub.add_parser("concat")
    c2.add_argument("-i", "--inputs", nargs="+", required=True)
    c2.add_argument("-o", "--output", required=True)
    c2.add_argument("--cols", type=int, default=None)
    c3 = sub.add_parser("visualize_cameras")
    c3.add_argument("-s", "--source_path", required=True)
    c3.add_argument("-o", "--output", required=True)
    c3.add_argument("--device", default=None,
                    help="torch device of the scene's cameras (default: "
                         "the CUDA device)")
    a = p.parse_args(argv)
    if a.cmd == "cut_and_stack":
        cut_and_stack(a.inputs, a.output, a.start, a.end, a.axis, a.fps)
    elif a.cmd == "concat":
        concat_images(a.inputs, a.output, a.cols)
    else:
        visualize_cameras(a.source_path, a.output, a.device)


if __name__ == "__main__":
    main()
