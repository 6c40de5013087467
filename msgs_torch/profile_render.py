"""Where the time of one 1080p render, or one 1080p training step, goes on
the card.

    python -m msgs_torch.profile_render [--train] [--out build/profile_render]

Uses the bench.py scene (100,000 Gaussians, seed 0, 1920×1080, entry_cap
1,417,216). The render mode reports:
  - the median wall time (host clock around a synchronised call) of
    `rasterize` with colors_precomp, of `eval_render` on the same scene as
    a serving state with SH degree 3 colours, and of each stage run on its
    own: preprocess (precomputed colours / SH 3), binning, payload gather,
    tile sub ranges, the compositor kernel, composite_pipeline;
  - over a few profiled eval_render calls: the device-busy share of the
    wall time (the union of device intervals in the trace), a
    torch.profiler table of device time by op and kernel, and a Chrome
    trace in --out.
With --train it does the same for `train_step` on that serving state,
perturbed, with the trainer's settings (image_grads_only): the whole step,
and its parts run on their own — the forward (render with autograd), the
loss, the loss's backward to the image, the compositor backward kernel, the
gather VJP, the preprocess backward and Adam — then the busy share and the
kernel table over a few profiled steps.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

W, H, N, ENTRY_CAP = 1920, 1080, 100_000, 1_417_216


def bench_scene(seed: int = 0):
    """bench.py:76-85, the same draws in the same order, as float32 numpy:
    (means, scales, quats, opacities, colours)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-3.0, 3.0, (N, 2)),
                            rng.uniform(2.0, 12.0, (N, 1))], axis=1)
    scales = np.exp(rng.uniform(-4.5, -2.5, (N, 3)))
    quats = rng.normal(size=(N, 4))
    opac = rng.uniform(0.2, 0.9, N)
    cols = rng.uniform(0, 1, (N, 3))
    return tuple(np.asarray(a, np.float32)
                 for a in (means, scales, quats, opac, cols))


def _wall_ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _timed_ms(setup, fn, reps=5):
    """Median wall ms of fn(setup()) with setup outside the timed span."""
    out = []
    for _ in range(reps + 1):
        x = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out[1:])


def serving_model(dev):
    """The bench scene as a serving state: SH degree 3 (DC from the
    colours, higher bands N(0, 0.05)), as chip_smoke.py serves it."""
    from msgs_torch.core.sh import rgb2sh
    from msgs_torch.core.transforms import inverse_sigmoid
    from msgs_torch.model.gaussians import GaussianConfig, empty_state
    means, scales, quats, opac, cols = (torch.as_tensor(a, device=dev)
                                        for a in bench_scene(0))
    cfg = GaussianConfig(sh_degree=3, capacity=1 << 17)
    st = empty_state(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for k, v in dict(
            xyz=means, features_dc=rgb2sh(cols)[:, None, :],
            features_rest=0.05 * torch.randn((N, 15, 3), generator=g,
                                             device=dev),
            scaling=torch.log(scales), rotation=quats,
            opacity=inverse_sigmoid(opac)[:, None]).items():
        getattr(st, k)[:N] = v
    st.live[:N] = True
    return st._replace(active_sh_degree=torch.tensor(
        3, dtype=torch.int32, device=dev)), cfg


def _profile(fn, n, out_dir, label):
    """Busy share and kernel table over n calls of fn under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    busy = _device_busy_ms(path) / n
    print(f"profiled {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%")
    ka = prof.key_averages()
    key = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(ka.table(sort_by=key, row_limit=30))


def train_main(dev, out_dir):
    """Stage breakdown of one 1080p train_step (see the module docstring)."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.eval.metrics import l1_loss, ssim
    from msgs_torch.kernels import composite as comp
    from msgs_torch.kernels.binning import bin_gaussians
    from msgs_torch.kernels.preprocess import PreprocessOut, preprocess
    from msgs_torch.kernels.rasterize import (RasterSettings, feature_table,
                                              gather_payload,
                                              gather_payload_vjp)
    from msgs_torch.train.loop import (eval_render, init_train_state,
                                       render_state, train_step)
    from msgs_torch.train.optimizer import OptimParams, adam_update, \
        group_lrs
    st, cfg = serving_model(dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)
    gt = eval_render(st, cam, cfg=cfg,
                     settings=RasterSettings(entry_cap=ENTRY_CAP)).image
    g = torch.Generator(device=dev).manual_seed(2)
    state = init_train_state(st._replace(features_dc=st.features_dc + 0.3 * (
        torch.randn(st.features_dc.shape, generator=g, device=dev))))
    settings = RasterSettings(entry_cap=ENTRY_CAP, image_grads_only=True)
    op = OptimParams()
    tx, ty = (W + 15) // 16, (H + 15) // 16

    def step():
        return train_step(state, cam, gt, cfg=cfg, op=op, settings=settings,
                          reso_lvl=0, spatial_lr_scale=5.0)

    def leaves():
        p = {k: v.detach().requires_grad_()
             for k, v in state.gaussians.params().items()}
        probe = torch.zeros((p["xyz"].shape[0], 2), device=dev,
                            requires_grad=True)
        return p, probe

    def forward(x):
        p, probe = x
        return render_state(state.gaussians.with_params(p), cam, cfg,
                            settings, bg=torch.zeros(3, device=dev),
                            means2d_probe=probe)

    def loss_of(image):
        return 0.8 * l1_loss(image, gt) + 0.2 * (1.0 - ssim(image, gt))

    def image_req():
        return forward(leaves()).image.detach().requires_grad_()

    # The compositor's and the gather's inputs at this step, and the
    # preprocess outputs with their graph, for the backward parts.
    p, probe = leaves()
    sp = state.gaussians.with_params(p)
    pre = preprocess(cam, sp.xyz, sp.act_opacity(), shs=sp.shs(),
                     scales=sp.act_scales(), quats=sp.act_rotation(),
                     active_sh_degree=sp.active_sh_degree, live_mask=sp.live,
                     means2d_probe=probe)
    table = feature_table(pre)
    with torch.no_grad():
        b = bin_gaussians(PreprocessOut(*(f.detach() for f in pre)), W, H,
                          ENTRY_CAP)
        payload = gather_payload(pre, b.gauss_id, b.gid_starts)
        first, n_sub = comp.tile_sub_ranges(b.sub_tile, b.sub_valid,
                                            b.tile_last_sub, tx * ty)
        res = comp._composite_cuda(payload, first, n_sub, tx * ty, tx, W, H)
    cot = torch.randn(res.shape, generator=g, device=dev)
    g_rows = torch.randn((payload.shape[0] * payload.shape[1],
                          comp.NFEAT), generator=g, device=dev)
    g_table = torch.randn(table.shape, generator=g, device=dev)
    grads = {k: torch.randn(v.shape, generator=g, device=dev)
             for k, v in state.gaussians.params().items()}
    lrs = group_lrs(op, 5.0, state.iteration)

    stages = [
        ("train_step", lambda: None, lambda _: step()),
        ("forward (render with autograd)", leaves, forward),
        ("loss (L1 + SSIM)", image_req, loss_of),
        ("loss backward to the image", lambda: loss_of(image_req()),
         lambda loss: loss.backward()),
        ("composite_bwd kernel (image_only)", lambda: None,
         lambda _: comp._composite_bwd_cuda(payload, first, n_sub, res, cot,
                                            tx * ty, tx, W, H, True)),
        ("gather VJP", lambda: None,
         lambda _: gather_payload_vjp(g_rows, b.gauss_id, b.gid_starts,
                                      table.shape[0], True)),
        ("preprocess backward", lambda: None,
         lambda _: torch.autograd.grad(table, list(p.values()) + [probe],
                                       g_table, retain_graph=True,
                                       allow_unused=True)),
        ("Adam", lambda: None,
         lambda _: adam_update(state.gaussians.params(), grads, state.adam,
                               lrs)),
    ]
    for name, setup, fn in stages:
        print(f"wall {name}: {_timed_ms(setup, fn):.3f} ms")
    _profile(step, 3, out_dir, "train_step")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build/profile_render")
    p.add_argument("--train", action="store_true",
                   help="break down a 1080p train_step instead of a render")
    args = p.parse_args()

    from msgs_torch import resolve_device
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import composite as comp
    from msgs_torch.kernels.binning import bin_gaussians
    from msgs_torch.kernels.preprocess import preprocess
    from msgs_torch.kernels.rasterize import (RasterSettings,
                                              composite_pipeline,
                                              gather_payload, rasterize)
    from msgs_torch.train.loop import eval_render

    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    os.makedirs(args.out, exist_ok=True)
    if args.train:
        train_main(dev, args.out)
        return
    means, scales, quats, opac, cols = (torch.as_tensor(a, device=dev)
                                        for a in bench_scene(0))
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)
    settings = RasterSettings(entry_cap=ENTRY_CAP)
    tx, ty = (W + 15) // 16, (H + 15) // 16

    def render():
        return rasterize(cam, means, opac, colors_precomp=cols,
                         scales=scales, quats=quats, settings=settings)

    def pre_fn():
        return preprocess(cam, means, opac, colors_precomp=cols,
                          scales=scales, quats=quats)

    st, cfg = serving_model(dev)

    def serve():
        return eval_render(st, cam, cfg=cfg, settings=settings)

    def pre_sh():
        return preprocess(cam, st.xyz, st.act_opacity(), shs=st.shs(),
                          scales=st.act_scales(), quats=st.act_rotation(),
                          active_sh_degree=st.active_sh_degree,
                          live_mask=st.live)

    with torch.no_grad():
        pre = pre_fn()
        b = bin_gaussians(pre, W, H, ENTRY_CAP)
        payload = gather_payload(pre, b.gauss_id, b.gid_starts)
        first, n_sub = comp.tile_sub_ranges(b.sub_tile, b.sub_valid,
                                            b.tile_last_sub, tx * ty)
        stages = {
            "rasterize (colors_precomp)": render,
            "eval_render (SH 3 state)": serve,
            "preprocess (colors_precomp)": pre_fn,
            "preprocess (SH 3 state)": pre_sh,
            "bin_gaussians": lambda: bin_gaussians(pre, W, H, ENTRY_CAP),
            "gather_payload": lambda: gather_payload(pre, b.gauss_id,
                                                     b.gid_starts),
            "tile_sub_ranges": lambda: comp.tile_sub_ranges(
                b.sub_tile, b.sub_valid, b.tile_last_sub, tx * ty),
            "composite_fwd kernel": lambda: comp._composite_cuda(
                payload, first, n_sub, tx * ty, tx, W, H),
            "composite_pipeline": lambda: composite_pipeline(pre, W, H,
                                                             settings),
        }
        for name, fn in stages.items():
            print(f"wall {name}: {_wall_ms(fn):.3f} ms")

        _profile(serve, 3, args.out, "eval_render")


def _device_busy_ms(trace_path: str) -> float:
    """Union of the device's kernel / memcpy / memset intervals in a Chrome
    trace (the profiler's per-op tables count a kernel's time on both the
    op and the kernel row, so their sums overstate it)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


if __name__ == "__main__":
    main()
