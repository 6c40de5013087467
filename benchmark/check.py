"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, the lower-precision control's, and each planted
fault's, each a run of the cell's set-up, the steps or frames its check
compares (through the window's own calls, at the timed sizes) and the
check, without the rest of the window; every seed in one process:

    python3 benchmark/check.py --workload <cell> --mode program \
        --seeds 1 2 3 ... [--out chiprun_out/check.jsonl]

Modes:
  program      the program as it is.
  control      the reference in the program's place (targets, steps and
               frames), with the operands of its products rounded to TF32:
               the step below the float32 the configurations state.
  unchanged    (training) a step that returns its state unchanged.
  half_batch   (training) the loss over the top half of the image rows;
               (rendering) the bottom half of each frame left at the
               background.
  shifted      (rendering) each frame's image one pixel off to the right.

Prints one JSON line per seed: the numbers, the limits, `correct`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402
from benchmark import program as P  # noqa: E402
from benchmark import reference as ref  # noqa: E402

CONTROL = ref.Prec(tf32=True)


def _ref_cam(cam) -> ref.Cam:
    """The reference's camera from the program's (row-vector) one."""
    wv = cam.world_view
    return ref.Cam(R=wv[:3, :3], T=wv[3, :3], center=cam.cam_center,
                   tanx=float(cam.tanfovx), tany=float(cam.tanfovy),
                   width=cam.width, height=cam.height)


def _fields(st) -> dict:
    return dict(st._asdict()) if hasattr(st, "_asdict") else dict(st)


def _rset(settings, fade_size):
    return dict(filter_small=settings.filter_small,
                filter_large=settings.filter_large, fade_size=fade_size)


def control_eval_render(state, camera, *, cfg, settings, reso_lvl=0,
                        fade_size=0.0, bg=None, scale_modifier=1.0):
    st = getattr(state, "gaussians", state)
    g = _fields(st)
    with torch.no_grad():
        img, pre = ref.render_state(g, _ref_cam(camera),
                                    _rset(settings, fade_size), CONTROL)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    return SimpleNamespace(image=img, overflow=zero, num_entries=zero,
                           visible=pre["visible"])


class _RefState:
    def __init__(self, g, m, v, count, iteration):
        self.g, self.count, self.iteration = g, count, iteration
        self.gaussians = SimpleNamespace(**g)
        self.adam = SimpleNamespace(mu=m, nu=v)


def control_train_step(state, camera, gt, *, cfg, op, settings, reso_lvl,
                       spatial_lr_scale, lambda_dssim=0.2, loss_mult=1.0,
                       fade_size=0.0, do_px_update=True, **_):
    if not isinstance(state, _RefState):
        g = _fields(state.gaussians)
        state = _RefState(g, {k: torch.zeros_like(g[k]) for k in ref.PARAMS},
                          {k: torch.zeros_like(g[k]) for k in ref.PARAMS},
                          0, int(state.iteration))
    loss, _, g, m, v = ref.train_step(
        state.g, state.adam.mu, state.adam.nu, state.count + 1,
        _ref_cam(camera), gt, iteration=state.iteration, lvl=reso_lvl,
        n_levels=cfg.reso_lvls, settings=_rset(settings, fade_size),
        spatial_lr_scale=spatial_lr_scale, loss_mult=loss_mult,
        lambda_dssim=lambda_dssim, records=bool(do_px_update), prec=CONTROL)
    new = _RefState(g, m, v, state.count + 1, state.iteration + 1)
    dev = gt.device
    return new, {"loss": torch.tensor(loss, device=dev),
                 "overflow": torch.zeros((), dtype=torch.int32, device=dev)}


def plant(mode: str, kind: str):
    """Put the mode's program in place for a cell of `kind` ("train" or
    "render"); returns a function that undoes it."""
    saved = (P.train_step, P.eval_render)
    undo = []
    real_step, real_render = P.train_step, P.eval_render
    if mode == "control":
        P.train_step, P.eval_render = control_train_step, \
            control_eval_render
    elif mode == "unchanged":
        def step(state, *a, **kw):
            _, met = real_step(state, *a, **kw)
            return state, met
        P.train_step = step
    elif mode == "half_batch" and kind == "train":
        from msgs_torch.train import loop
        l1, ssim = loop.l1_loss, loop.ssim
        half = lambda x: x[:max(x.shape[0] // 2, 1)]
        loop.l1_loss = lambda a, b: l1(half(a), half(b))
        loop.ssim = lambda a, b: ssim(half(a), half(b))
        undo.append(lambda: (setattr(loop, "l1_loss", l1),
                             setattr(loop, "ssim", ssim)))
    elif mode == "half_batch":
        def render(*a, **kw):
            out = real_render(*a, **kw)
            img = out.image.clone()
            img[img.shape[0] // 2:] = 0.0
            return out._replace(image=img)
        P.eval_render = render
    elif mode == "shifted":
        def render(*a, **kw):
            out = real_render(*a, **kw)
            return out._replace(image=torch.roll(out.image, 1, dims=1))
        P.eval_render = render
    elif mode != "program":
        raise ValueError(f"unknown mode {mode!r}")

    def restore():
        P.train_step, P.eval_render = saved
        for f in undo:
            f()
    return restore


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    kind = H.Cell.load(args.workload).mix["kind"]
    for seed in args.seeds:
        restore = plant(args.mode, kind)
        t = time.perf_counter()
        line = H.result_line(args.workload, seed, 0.0, False, dev,
                             t, check_only=True)
        restore()
        rec = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "correct": line["correct"],
               "numbers": {k: c["value"] for k, c in line["checks"].items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    main()
