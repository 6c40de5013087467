"""The `train` kind of traffic: a window of `train_step` calls. Its mixes
(benchmark/traffic/<mix>.json) give the level counts of one cycle, the
start iteration, the read-back cadence, the traced steps and how many of
the first steps the check compares."""
from __future__ import annotations

import random
import time

import torch

from benchmark import harness as H
from benchmark import program as P
from benchmark import reference as ref
from benchmark.scene import make_scene, perturbed

B1 = 0.9
# One fixed order of the training views, the same for every seed.
VIEW_ORDER_SEED = 0
RECORDS = ("max_pixel_sizes", "min_pixel_sizes")


def sequence(mix: dict, n_views: int, seed: int):
    """(view, level) of every step, in blocks of one level cycle (the mix's
    counts per level). Block b pairs the next views of one fixed order of
    the training views with the cycle's levels, so every seed takes the
    same steps block by block; the seed draws only the order of the steps
    within each block. The first block starts with a ×1 step, then a
    coarse one where the mix has a coarse level, so the checked steps
    cover both."""
    cycle = [int(l) for l, c in sorted(mix["levels"].items(),
                                       key=lambda kv: int(kv[0]))
             for _ in range(c)]
    order = list(range(n_views))
    random.Random(VIEW_ORDER_SEED).shuffle(order)
    rng = random.Random(seed)
    pos, first = 0, True
    while True:
        block = [(order[(pos + i) % n_views], lvl)
                 for i, lvl in enumerate(cycle)]
        pos += len(cycle)
        rng.shuffle(block)
        if first:
            lead = [i for i in (
                next((i for i, s in enumerate(block) if s[1] == 0), None),
                next((i for i, s in enumerate(block) if s[1] > 0), None))
                if i is not None]
            block = [block[i] for i in lead] + \
                [s for i, s in enumerate(block) if i not in lead]
            first = False
        yield from block


def _rel(a, b):
    return abs(a - b) / abs(b)


def run(cell, seed: int, seconds: float, trace: bool, dev, clock,
        trace_path=None, check_only=False) -> dict:
    cfg, mix = cell.config, cell.mix
    cap = cfg["entry_cap"]
    n_check = mix["checked_steps"]
    sc = make_scene(cfg, seed, dev)
    g0 = sc["fields"]
    gp = perturbed(g0, cfg, seed, dev)
    host_g0 = {k: g0[k].cpu() for k in ref.PARAMS}
    host_gp = {k: v.cpu() for k, v in gp.items()}
    n_levels = sc["n_levels"]
    gcfg = P.config(cfg, n_levels)
    clock.mark("scene", dev)

    views = sc["train"]
    levels = sorted({int(l) for l in mix["levels"]})
    ms = cfg["method"] == "ms"
    eval_settings = P.settings(cap, filter_small=ms, filter_large=ms)
    base_state = P.gaussian_state(g0)
    gts, cams = {}, {}
    # A check-only run renders the targets of its checked steps alone.
    first = sequence(mix, len(views), seed)
    need = ({next(first)[0] for _ in range(n_check)} if check_only
            else range(len(views)))
    for vi, v in enumerate(views):
        if vi not in need:
            continue
        img = P.eval_render(base_state, P.camera(v, dev), cfg=gcfg,
                            settings=eval_settings).image
        for lvl in levels:
            vs = v.scaled(2 ** lvl)
            cams[vi, lvl] = P.camera(vs, dev)
            gts[vi, lvl] = (img if lvl == 0 else ref.area_downsample(
                img, vs.width, vs.height)).contiguous()
    del base_state, img
    clock.mark("targets", dev)

    settings = H.settings_for(cell, cap, train=True)
    op = P.optim()
    step_kw = dict(cfg=gcfg, op=op, settings=settings,
                   spatial_lr_scale=sc["extent"],
                   lambda_dssim=op.lambda_dssim, fade_size=0.0,
                   do_px_update=mix["do_px_update"], do_densify_stats=False,
                   do_base_mask=False, ms_lr_active=False)
    seq = sequence(mix, len(views), seed)
    state = P.train_state(gp, mix["iteration"])

    def step(state, vi, lvl):
        return P.train_step(state, cams[vi, lvl], gts[vi, lvl],
                            reso_lvl=lvl,
                            loss_mult=(0.1 if (ms and lvl > 0) else 1.0),
                            **step_kw)

    # The checked steps: the object's first ones, through the window's own
    # call and feed.
    checked, losses = [], []
    for k in range(n_check):
        vi, lvl = next(seq)
        state, _met = step(state, vi, lvl)
        checked.append((vi, lvl))
        losses.append(float(_met["loss"]))
        if k == 0:
            grad_p = H.norms({k2: m / (1 - B1)
                              for k2, m in P.first_moments(state).items()})
    dparam_p = H.norms({k: v - gp[k] for k, v in P.params_of(state).items()})
    rec_p = {k: getattr(state.gaussians, k).cpu() for k in RECORDS}
    # Warm-up: the rest of the first block, which steps every level of the
    # mix; the window starts on a block's first step.
    cyc = sum(mix["levels"].values())
    for _ in range(0 if check_only else (cyc - n_check) % cyc):
        state, _ = step(state, *next(seq))
    del gp, g0
    clock.mark("warmup", dev)

    n_trace = mix["trace_steps"]
    snaps, events = [], []
    n_done, fails = 0, []
    if trace:
        prof = H.profiler()
        prof.__enter__()
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.window"):
        while not check_only:
            vi, lvl = next(seq)
            if trace:
                st = state.gaussians
                snaps.append(({k: getattr(st, k).clone() for k in (
                    "xyz", "scaling", "rotation", "opacity", "live",
                    "max_pixel_sizes", "min_pixel_sizes", "base_mask")},
                    vi, lvl))
                events.append(H.event(dev))
            state, met = step(state, vi, lvl)
            fails.append(met["overflow"])
            n_done += 1
            if n_done % mix["readback_every"] == 0:
                int(torch.stack(fails[-mix["readback_every"]:]).sum())
            if trace and n_done >= n_trace:
                break
            if (not trace and n_done % cyc == 0
                    and time.perf_counter() - t0 >= seconds):
                break
        H.sync(dev)
    t1 = time.perf_counter()
    if trace:
        events.append(H.event(dev))
        H.sync(dev)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(trace_path))
        del prof
    window = t1 - t0
    failed = int(torch.stack(fails).gt(0).sum()) if fails else 0
    peak = H.peak(dev)
    del state
    H.free(dev)

    # The reference follows the checked steps from the same start.
    t_check = time.perf_counter()
    g = {k: v.to(dev) for k, v in host_gp.items()}
    g0 = {**g, **{k: v.to(dev) for k, v in host_g0.items()}}
    m = {k: torch.zeros_like(g[k]) for k in ref.PARAMS}
    v2 = {k: torch.zeros_like(g[k]) for k in ref.PARAMS}
    start = {k: g[k].clone() for k in ref.PARAMS + RECORDS}
    rset = H.ref_settings(cell, train=True)
    ref_losses = []
    for k, (vi, lvl) in enumerate(checked):
        view = views[vi]
        with torch.no_grad():
            tgt, _ = ref.render_state(g0, H.ref_cam(view, dev), rset)
        vs = view.scaled(2 ** lvl)
        if lvl:
            tgt = ref.area_downsample(tgt, vs.width, vs.height)
        loss, grads, g, m, v2 = ref.train_step(
            g, m, v2, k + 1, H.ref_cam(vs, dev), tgt,
            iteration=mix["iteration"] + k, lvl=lvl, n_levels=n_levels,
            settings=rset, spatial_lr_scale=sc["extent"],
            loss_mult=(0.1 if (ms and lvl > 0) else 1.0),
            records=mix["do_px_update"])
        ref_losses.append(loss)
        if k == 0:
            grad_r = H.norms(grads)
    dparam_r = H.norms({k: g[k] - start[k] for k in ref.PARAMS})
    numbers = {}
    # A ×1 step's loss and a coarse step's are compared apart: a coarse
    # step's is a mean over a few hundred pixels or fewer.
    for name, pick in (("loss_rel", lambda l: l == 0),
                       ("coarse_loss_rel", lambda l: l > 0)):
        gaps = [_rel(a, b) for a, b, (_, l) in
                zip(losses, ref_losses, checked) if pick(l)]
        if gaps:
            numbers[name] = max(gaps)
    numbers["grad_norm_gap"] = H.leaf_gaps(grad_p, grad_r)
    numbers["update_norm_gap"] = H.leaf_gaps(dparam_p, dparam_r)
    live = g["live"]
    rec_r = {k: g[k] for k in RECORDS}
    notes = []
    if mix["do_px_update"]:
        numbers["records_mismatch"] = H.records_mismatch(
            {k: v.to(dev) for k, v in rec_p.items()}, rec_r, live)
        # What a step that left the state unchanged would read.
        notes.append("records the reference moved: share of live rows "
                     f"{H.records_mismatch(start, rec_r, live)!r}")
    for (vi, lvl), a, b in zip(checked, losses, ref_losses):
        notes.append(f"step view {vi} level {lvl}: loss {a!r} reference "
                     f"{b!r}")
    for k in ref.PARAMS:
        notes.append(f"leaf {k}: grad norm {grad_p[k]!r} reference "
                     f"{grad_r[k]!r}; update norm {dparam_p[k]!r} "
                     f"reference {dparam_r[k]!r}")
    del g, g0, m, v2, start, rec_r

    out = dict(attempted=n_done, failed=failed, window=window, peak=peak,
               numbers=numbers, notes=notes,
               check_s=time.perf_counter() - t_check, ctx={})
    if trace:
        counts = []
        for (s, vi, lvl) in snaps:
            counts.append(ref.count_work(
                dict(s), H.ref_cam(views[vi].scaled(2 ** lvl), dev), rset))
        out.update(trace_path=trace_path)
        out["ctx"].update(work=counts, step_times=H.event_times(events),
                          steps=n_done)
    return out
