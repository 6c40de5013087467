"""Interactive viewer: port of msgs/apps/viewer.py.

Flies through a trained model with live controls of the resolution scale,
the fade size and the Gaussian scale modifier, and shows the render, the
accumulated pixel size and the depth. With `--display` it opens OpenCV
windows (cv2 is imported there only); without it, it renders one frame and
writes view.png, acc.png and depth.png to --out_dir through the port's PNG
encoder.

  python -m msgs_torch.apps.viewer -m <model> [--display] [--anti_alias]
      [--reso_scale S] [--device cpu]

Keys: w/s/a/d/q/e move, i/k/j/l rotate, -/= resolution scale down/up,
;/' fade size, [/] Gaussian scale modifier, p save frame.png, ESC quit.
"""
from __future__ import annotations

import argparse
import math
import os
from dataclasses import dataclass

import numpy as np

ESC = 27


@dataclass
class ViewState:
    """What the keys change: the pose and the three render controls."""
    R: np.ndarray            # (3, 3) cam→world rotation
    T: np.ndarray            # (3,) world→cam translation
    reso_scale: float
    fade_size: float = 1.0
    gs_scale: float = 1.0
    move: float = 0.1
    rot: float = 0.05


def apply_key(vs: ViewState, k: int):
    """Apply key code k to vs as msgs/apps/viewer.py's loop does. Returns
    "quit" for ESC, "save" for p, else None."""
    if k == ESC:
        return "quit"
    if k == ord("w"):
        vs.T[2] -= vs.move
    elif k == ord("s"):
        vs.T[2] += vs.move
    elif k == ord("a"):
        vs.T[0] += vs.move
    elif k == ord("d"):
        vs.T[0] -= vs.move
    elif k == ord("q"):
        vs.T[1] += vs.move
    elif k == ord("e"):
        vs.T[1] -= vs.move
    elif k in (ord("i"), ord("k"), ord("j"), ord("l")):
        axis, ang = {"i": (0, -vs.rot), "k": (0, vs.rot),
                     "j": (1, -vs.rot), "l": (1, vs.rot)}[chr(k)]
        c, s = math.cos(ang), math.sin(ang)
        if axis == 0:
            vs.R = vs.R @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        else:
            vs.R = vs.R @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    elif k == ord("-"):
        vs.reso_scale = min(vs.reso_scale * 2, 128)
    elif k == ord("="):
        vs.reso_scale = max(vs.reso_scale / 2, 1)
    elif k == ord(";"):
        vs.fade_size = max(vs.fade_size - 0.1, 0.0)
    elif k == ord("'"):
        vs.fade_size = min(vs.fade_size + 0.1, 2.0)
    elif k == ord("["):
        vs.gs_scale = max(vs.gs_scale - 0.1, 0.1)
    elif k == ord("]"):
        vs.gs_scale += 0.1
    elif k == ord("p"):
        return "save"
    return None


def render_interactive(args):
    from msgs_torch import resolve_device
    from msgs_torch.apps.render import load_viewing_model
    from msgs_torch.core.camera import make_camera
    from msgs_torch.data.image import write_png
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.train import loop as L

    dev = resolve_device(args.device)
    state, cfg, scene = load_viewing_model(
        args.model_path, args.source_path, args.iteration, dev)
    view0 = scene.train_views[0]
    fovx, fovy = view0.fovx, view0.fovy
    W0, H0 = view0.width, view0.height
    vs = ViewState(R=view0.R.copy(), T=view0.T.copy(),
                   reso_scale=float(args.reso_scale),
                   move=0.1 * scene.cameras_extent)
    settings = RasterSettings(
        backend=args.backend, entry_cap=args.entry_cap,
        filter_small=args.anti_alias, filter_large=args.anti_alias)

    def render_frame():
        w = max(int(W0 / vs.reso_scale) // 16 * 16, 16)
        h = max(int(H0 / vs.reso_scale) // 16 * 16, 16)
        cam = make_camera(vs.R, vs.T, fovx, fovy, w, h, device=dev)
        out = L.eval_render(state, cam, cfg=cfg, settings=settings,
                            fade_size=vs.fade_size,
                            scale_modifier=round(vs.gs_scale, 2))
        img = np.clip(out.image.cpu().numpy(), 0, 1)
        acc = out.acc_pixel_size.cpu().numpy()
        acc = acc / max(acc.max(), 1e-6)
        depth = out.depth.cpu().numpy()
        depth = depth / max(depth.max(), 1e-6)
        return img, acc, depth

    def save(name, x):
        write_png(os.path.join(args.out_dir, name),
                  (x * 255).astype(np.uint8))

    if not args.display:
        img, acc, depth = render_frame()
        os.makedirs(args.out_dir, exist_ok=True)
        save("view.png", img)
        save("acc.png", acc)
        save("depth.png", depth)
        print(f"headless: wrote view/acc/depth to {args.out_dir} "
              f"(reso x{vs.reso_scale}, anti_alias={args.anti_alias})")
        return

    import cv2
    while True:
        img, acc, depth = render_frame()
        cv2.imshow("render", img[..., ::-1])
        cv2.imshow("acc_pixel_size", acc)
        cv2.imshow("depth", depth)
        action = apply_key(vs, cv2.waitKey(1) & 0xFF)
        if action == "quit":
            break
        if action == "save":
            os.makedirs(args.out_dir, exist_ok=True)
            save("frame.png", img)
    cv2.destroyAllWindows()


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch viewer")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--anti_alias", action="store_true")
    p.add_argument("--reso_scale", type=float, default=1.0)
    p.add_argument("--display", action="store_true",
                   help="use OpenCV windows (needs a display)")
    p.add_argument("--out_dir", default="viewer_out")
    p.add_argument("--backend", default="pallas",
                   help="'pallas' / 'auto': the CUDA kernels on the card; "
                        "'reference': the plain PyTorch versions")
    p.add_argument("--entry_cap", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    render_interactive(p.parse_args(argv))


if __name__ == "__main__":
    main()
