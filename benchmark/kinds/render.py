"""The `render` kind of traffic: one viewer in a closed loop over
`eval_render`, each frame's image copied to the host before the next is
sent. Its mixes (benchmark/traffic/<mix>.json) give the circle's frames,
the scale sweep, the filters and fade, the traced frames and how many
frames the check compares."""
from __future__ import annotations

import random
import time

import torch

from benchmark import harness as H
from benchmark import program as P
from benchmark import reference as ref
from benchmark import traj
from benchmark.scene import make_scene


def frames(mix: dict, views):
    """(pose view, scale) of each of the mix's n_frames. Every seed takes
    the same poses (the mix's `phase`, in frames), so every seed does the
    same work; the seed draws the scene and the frames checked."""
    n = mix["n_frames"]
    poses = traj.circle_trajectory(views, n, mix.get("radius_frac", 0.3),
                                   mix.get("phase", 0.0))
    v0 = views[0]
    out = []
    for i, (R, T) in enumerate(poses):
        scale = traj.sweep_scale(i, n, mix["min_scale"], mix["max_scale"])
        w, h = traj.frame_size(v0.width, v0.height, scale)
        out.append((type(v0)(R, T, v0.fovx, v0.fovy, w, h), scale))
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev, clock,
        trace_path=None, check_only=False) -> dict:
    cfg, mix = cell.config, cell.mix
    sc = make_scene(cfg, seed, dev)
    g = sc["fields"]
    gcfg = P.config(cfg, sc["n_levels"])
    state = P.gaussian_state(g)
    fr = frames(mix, sc["train"])
    cams = [P.camera(v, dev) for v, _ in fr]
    settings = H.settings_for(cell, cfg["entry_cap"], train=False)
    fade = mix["fade_size"]
    clock.mark("scene", dev)

    def frame(i):
        out = P.eval_render(state, cams[i], cfg=gcfg, settings=settings,
                            fade_size=fade)
        return out, out.image.cpu()

    sizes = {}
    for i, (v, _) in enumerate(fr):
        sizes.setdefault((v.width, v.height), i)
    for i in ([] if check_only else sizes.values()):
        frame(i)
    clock.mark("warmup", dev)

    n = len(fr)
    n_window = mix["trace_frames"] if trace else None
    pool = list(range(min(n, n_window or n)))
    rng = random.Random(seed ^ 0xC0FFEE)
    sample = sorted({0} | set(rng.sample(pool[1:], min(
        mix["check_frames"] - 1, len(pool) - 1))))
    kept = {}
    times, overflow, entries, visible, events = [], [], [], [], []
    if trace:
        prof = H.profiler()
        prof.__enter__()
    t0 = time.perf_counter()
    i = 0
    with torch.profiler.record_function("bench.window"):
        while True:
            j = sample[i] if check_only else i % n
            if trace:
                events.append(H.event(dev))
            a = time.perf_counter()
            out, img = frame(j)
            times.append(time.perf_counter() - a)
            overflow.append(out.overflow)
            if trace:
                entries.append(out.num_entries)
                visible.append(out.visible)
            if j in sample and j not in kept:
                kept[j] = img
            i += 1
            if trace and i >= n_window:
                break
            if check_only and i == len(sample):
                break
            if (not trace and not check_only and i % n == 0
                    and time.perf_counter() - t0 >= seconds):
                break
    t1 = time.perf_counter()
    if trace:
        events.append(H.event(dev))
        H.sync(dev)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(trace_path))
        del prof
    window = t1 - t0
    failed = int(torch.stack(overflow).gt(0).sum())
    peak = H.peak(dev)
    del state, out
    H.free(dev)

    rset = H.ref_settings(cell, train=False)
    t_check = time.perf_counter()
    maes = []
    for j in sample:
        v, _ = fr[j]
        with torch.no_grad():
            img, _ = ref.render_state(g, H.ref_cam(v, dev), rset)
        maes.append(float(torch.mean(torch.abs(
            kept[j].to(dev) - img)).double()))
    out = dict(attempted=i, failed=failed, window=window, peak=peak,
               numbers={"img_mae": max(maes)}, notes=[],
               check_s=time.perf_counter() - t_check,
               ctx=dict(frame_times=times))
    if trace:
        counts = [ref.count_work(g, H.ref_cam(fr[k % n][0], dev), rset)
                  for k in range(i)]
        # A frame's time on the device's clock: from its dispatch to the
        # next frame's, the image's copy to the host included.
        out.update(trace_path=trace_path)
        out["ctx"].update(
            work=counts, step_times=H.event_times(events), steps=i,
            num_entries=[int(e) for e in entries],
            visible=[int(x.sum()) for x in visible],
            live=int(g["live"].sum()))
    return out
