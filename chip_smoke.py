"""Chip smoke run of msgs_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from msgs_torch/csrc (into build/msgs_torch/), then:

  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: the kernel build time and ptxas's register / shared-memory use;
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes (scans exact; compositor forward image
     and T ≤ 1e-5, depth and acc ≤ 1e-4; compositor backward per payload
     column ≤ 3e-5·max|column| + 1e-6, for image_only True and False), with
     median times, the plain version's time and, for the scans,
     torch.cumsum's time as a yardstick;
  4. serving path: a serving model at the bench.py scene (100,000
     Gaussians, seed 0) with SH degree 3 colours, saved as a PLY snapshot
     and loaded back, rendered by eval_render at 1920×1080 from three
     cameras, with default settings and with the anti-alias filters; launch
     counters are zeroed just before and read just after, and every kernel
     of the path must have run. The bench's own colors_precomp scene is
     rendered once to hold num_entries against the reference's 1,287,253
     (BENCH_r05.json, within 0.1%);
  5. training path: that model, perturbed, takes 20 train_step calls at
     full width (1920×1080, image_grads_only, as the trainer runs) towards
     a render of the unperturbed model; counters are zeroed just before and
     read just after, all four kernels must have run, no step may overflow,
     every parameter and Adam moment stays finite, and the loss falls;
  6. a small scene rendered on the card and on the CPU (the plain versions,
     which the tests hold against the JAX package) must agree, and one
     train_step at 88×72 on the card and on the CPU must agree within the
     CPU parity test's budgets (tests/test_torch_train.py).

Any failed check raises, and the script exits non-zero without its result
lines. On success the second-to-last lines are the nvidia-smi line and one
JSON object describing every kernel; the last line is the device record.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H = 1920, 1080
N = 100_000
ENTRY_CAP = 1_417_216
REF_ENTRIES = 1_287_253       # BENCH_r05.json detail.n_entries (TPU run)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and fp32 (non-
# tensor-core) operations/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# fp32 operations per (entry, pixel) pair in composite_fwd.cu, counted from
# the source: 2 tile-local offsets, 2 pixel offsets, 9 for the power, 4 for
# expf, 1 for o·g, 5 for the mask, clamp and 1−α, ~4 for the prefix
# product, 1+1+1 for t_after and alive, 3 for w, 10 for the five
# multiply-adds, 2 for the T minimum.
OPS_PER_PAIR = 46
# composite_bwd.cu recomputes the forward's 46 and adds, per pair, with NF
# colour columns (5, or 3 under image_only): 2·NF−1 for φ, 3 for T_i, T_i·φ
# and w·φ, ~4 for the w·φ prefix (129 adds per 32 entries), 9 for dα and
# dpower, 8 for the moment terms, NF for w·g_c, and one add per reduced
# quantity (6 + NF) for the butterfly (31 adds per 32 entries × 32 pixels).
OPS_PER_PAIR_BWD = {nf: OPS_PER_PAIR + (2 * nf - 1) + 3 + 4 + 9 + 8 + nf
                    + 6 + nf for nf in (3, 5)}
STEPS = 20                    # full-width train steps


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of fn."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_device():
    from msgs_torch import resolve_device
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {smi_line}",
          flush=True)
    return dev, smi_line


def phase_build():
    from msgs_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    info = _build.build_info
    print(f"[build] {dt:.2f} s ({'built' if info['built'] else 'cached'}) "
          f"{info['path']}", flush=True)
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")


def scan_record(name, dtype, shapes, dev):
    """Exactness at every shape; times at the first (the main path's)."""
    from msgs_torch.kernels import scan
    g = torch.Generator().manual_seed(len(name))
    rec = None
    for R, E in shapes:
        if dtype == torch.float32:
            x = torch.randint(-6, 9, (R, E), generator=g).float()
        else:
            # Negative deltas with running sums up to ±(2^31 − 1).
            steps = torch.randint(-2**29, 2**29, (R, E), generator=g,
                                  dtype=torch.int64)
            third = (torch.arange(E) * 3 // E) == 1
            steps += torch.where(third, 2**29, -2**29)
            walk = torch.cumsum(steps, 1).clamp(-2**31 + 1, 2**31 - 1)
            x = torch.diff(walk, dim=1, prepend=torch.zeros((R, 1),
                                                            dtype=torch.int64))
            x = x.to(torch.int32)
        x = x.to(dev)
        got = scan.cumsum_rows(x)
        torch.cuda.synchronize()
        want = scan.cumsum_rows_plain(x)
        err = (got.double() - want.double()).abs().max().item()
        print(f"[kernels] {name} R={R} E={E}: max|Δ| {err}", flush=True)
        check(err == 0, f"{name} differs from its plain version at {R}x{E}")
        if rec is None:
            ms = median_ms(lambda: scan.cumsum_rows(x), 20)
            plain = median_ms(lambda: scan.cumsum_rows_plain(x), 20)
            lib = median_ms(lambda: torch.cumsum(x, dim=-1, dtype=x.dtype),
                            20)
            nbytes = 2 * R * E * 4
            bound = max(nbytes / PEAK_BYTES, R * E / PEAK_FP32) * 1e3
            rec = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by="bytes", max_abs_err=err, shape=[R, E])
            print(f"[kernels] {name} {R}x{E}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, torch.cumsum {lib:.4f} ms, bound "
                  f"{bound:.4f} ms", flush=True)
    return rec


def composite_stream(dev, means, scales, quats, opac, cols, width, height,
                     entry_cap):
    """Preprocess + binning + payload of a colors_precomp scene."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels.binning import bin_gaussians
    from msgs_torch.kernels.preprocess import preprocess
    from msgs_torch.kernels.rasterize import gather_payload
    from msgs_torch.kernels import composite as comp
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, width, height,
                      device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    with torch.no_grad():
        pre = preprocess(cam, t(means), t(opac), colors_precomp=t(cols),
                         scales=t(scales), quats=t(quats))
        b = bin_gaussians(pre, width, height, entry_cap)
        payload = gather_payload(pre, b.gauss_id, b.gid_starts)
    tx = (width + 15) // 16
    tiles = tx * ((height + 15) // 16)
    first, n_sub = comp.tile_sub_ranges(b.sub_tile, b.sub_valid,
                                        b.tile_last_sub, tiles)
    return payload, first, n_sub, tiles, tx


def composite_check(label, dev, stream, width, height, timed: bool):
    from msgs_torch.kernels import composite as comp
    payload, first, n_sub, tiles, tx = stream
    got = comp._composite_cuda(payload, first, n_sub, tiles, tx, width,
                               height)
    torch.cuda.synchronize()
    want, n_work = comp._composite_plain(payload, first, n_sub, tiles, tx,
                                         width, height)
    errs = {}
    for ch, name, tol in ((comp.O_R, "r", 1e-5), (comp.O_G, "g", 1e-5),
                          (comp.O_B, "b", 1e-5), (comp.O_T, "T", 1e-5),
                          (comp.O_DEPTH, "depth", 1e-4),
                          (comp.O_ACC, "acc", 1e-4),
                          (comp.O_DONE, "done", 0.0)):
        d = (got[:, ch] - want[:, ch]).abs().max().item()
        errs[name] = d
        check(math.isfinite(d) and d <= tol,
              f"composite_fwd {label}: channel {name} max|Δ| {d} > {tol}")
    print(f"[kernels] composite_fwd {label}: max|Δ| {errs}", flush=True)
    if not timed:
        return None
    args = (payload, first, n_sub, tiles, tx, width, height)
    ms = median_ms(lambda: comp._composite_cuda(*args), 20)
    plain = median_ms(lambda: comp._composite_plain(*args), 3, warmup=1)
    work_subs = int(n_work)
    pairs = work_subs * 32 * 256
    nbytes = work_subs * 32 * 12 * 4 + tiles * 2 * 4 + tiles * 8 * 256 * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    print(f"[kernels] composite_fwd {label}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms; {int(n_sub.sum())} valid sub-blocks, "
          f"{work_subs} before saturation, {pairs} pairs; bound "
          f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations "
          f"{t_ops:.4f})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=max(errs[c] for c in ("r", "g", "b", "T")),
                valid_subs=int(n_sub.sum()), work_subs=work_subs)


def grad_budget(want) -> float:
    """The JAX suite's gradient budget, 3e-5·max|g| + 1e-6."""
    return 3e-5 * max(float(want.abs().max()), 1e-8) + 1e-6


def composite_bwd_check(label, dev, stream, width, height, timed: bool):
    """The backward kernel vs composite_bwd_reference on the card, for
    image_only False and True, with a seeded cotangent."""
    from msgs_torch.kernels import composite as comp
    payload, first, n_sub, tiles, tx = stream
    res = comp._composite_cuda(payload, first, n_sub, tiles, tx, width,
                               height)
    g = torch.Generator().manual_seed(tiles)
    cot = torch.randn((tiles, comp.NOUT, comp.NPIX), generator=g).to(dev)
    recs = {}
    for image_only in (False, True):
        args = (payload, first, n_sub, res, cot, tiles, tx, width, height,
                image_only)
        got = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
        torch.cuda.synchronize()
        want = comp.composite_bwd_reference(*args).reshape(-1, comp.NFEAT)
        last = comp.F_B if image_only else comp.F_PSIZE
        worst = 0.0
        err = 0.0
        for c in range(last + 1):
            d = (got[:, c] - want[:, c]).abs().max().item()
            tol = grad_budget(want[:, c])
            check(math.isfinite(d) and d <= tol,
                  f"composite_bwd {label} image_only={image_only}: column "
                  f"{c} max|Δ| {d} > {tol}")
            worst = max(worst, d / tol)
            err = max(err, d)
        check(bool((got[:, last + 1:] == 0).all()),
              f"composite_bwd {label}: uncomputed columns not zero")
        print(f"[kernels] composite_bwd {label} image_only={image_only}: "
              f"max|Δ| {err:.3e}, worst column at {worst:.3f} of its budget",
              flush=True)
        if timed:
            ms = median_ms(lambda: comp._composite_bwd_cuda(*args), 20)
            plain = median_ms(lambda: comp.composite_bwd_reference(*args), 3,
                              warmup=1)
            n_work = int(comp._composite_plain(payload, first, n_sub, tiles,
                                               tx, width, height)[1])
            nf = 3 if image_only else 5
            pairs = n_work * 32 * 256
            nbytes = 2 * n_work * 32 * 12 * 4 + 2 * tiles * 8 * 256 * 4 \
                + tiles * 2 * 4
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = pairs * OPS_PER_PAIR_BWD[nf] / PEAK_FP32 * 1e3
            print(f"[kernels] composite_bwd {label} image_only={image_only}: "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms; {n_work} "
                  f"sub-blocks before saturation, {pairs} pairs; bound "
                  f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
                  f"operations {t_ops:.4f})", flush=True)
            recs[image_only] = dict(
                ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=err)
    if timed:
        # Deterministic: a second launch is bit-identical.
        a = comp._composite_bwd_cuda(payload, first, n_sub, res, cot, tiles,
                                     tx, width, height, True)
        b = comp._composite_bwd_cuda(payload, first, n_sub, res, cot, tiles,
                                     tx, width, height, True)
        check(torch.equal(a, b), "composite_bwd is not deterministic")
    # The trainer's setting (image_grads_only) is the record.
    return recs.get(True)


def serving_state(dev, path):
    """The bench scene as a trained model carries it (SH degree 3, DC from
    the colours, small higher bands, recorded pixel sizes), written as a PLY
    snapshot and loaded back."""
    from msgs_torch.core.sh import rgb2sh
    from msgs_torch.core.transforms import inverse_sigmoid
    from msgs_torch.model.gaussians import GaussianConfig, empty_state
    from msgs_torch.train.checkpoint import load_ply_snapshot, \
        save_ply_snapshot
    means, scales, quats, opac, cols = bench_scene(0)
    rng = np.random.default_rng(1)
    cfg = GaussianConfig(sh_degree=3, capacity=1 << 17)
    st = empty_state(cfg, dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rows = dict(
        xyz=t(means),
        features_dc=rgb2sh(t(cols))[:, None, :],
        features_rest=t(rng.normal(0, 0.05, (N, 15, 3))),
        scaling=torch.log(t(scales)),
        rotation=t(quats),
        opacity=inverse_sigmoid(t(opac))[:, None],
        max_pixel_sizes=t(rng.uniform(0.5, 4.0, N)),
        min_pixel_sizes=t(rng.uniform(0.5, 3.0, N)))
    for k, v in rows.items():
        getattr(st, k)[:N] = v
    st.base_mask[:N] = torch.as_tensor(rng.uniform(size=N) < 0.5,
                                       device=dev)
    st.live[:N] = True
    save_ply_snapshot(path, st)
    back = load_ply_snapshot(path, cfg, dev)
    for k in list(rows) + ["base_mask", "live"]:
        check(torch.equal(getattr(st, k), getattr(back, k)),
              f"PLY round trip changed {k}")
    return back, cfg, (means, scales, quats, opac, cols)


def phase_main_path(dev):
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.rasterize import RasterSettings, rasterize
    from msgs_torch.train.loop import eval_render
    with tempfile.TemporaryDirectory() as tmp:
        st, cfg, scene = serving_state(dev, os.path.join(tmp, "model.ply"))
    cams = [make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)]
    for i, (ang, tx) in enumerate(((0.03, 0.05), (-0.02, -0.08))):
        c, s = math.cos(ang), math.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        cams.append(make_camera(R, np.array([tx, 0.02 * i, 0.0]), 1.2, 0.8,
                                W, H, device=dev))
    bg = torch.zeros(3, device=dev)
    modes = {"default": RasterSettings(entry_cap=ENTRY_CAP),
             "anti_alias": RasterSettings(entry_cap=ENTRY_CAP,
                                          filter_small=True,
                                          filter_large=True)}
    reps = 3
    _build.reset_launch_counts()
    times, entries, renders = {}, {}, 0
    for mode, settings in modes.items():
        times[mode], entries[mode] = [], []
        for ci, cam in enumerate(cams):
            for r in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eval_render(st, cam, cfg=cfg, settings=settings, bg=bg)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                renders += 1
                if r > 0:
                    times[mode].append(dt)
            check(out.image.shape == (H, W, 3), f"image shape {out.image.shape}")
            check(bool(torch.isfinite(out.image).all()), "non-finite image")
            check(bool(torch.isfinite(out.depth).all()), "non-finite depth")
            check(int(out.overflow) == 0, f"{mode} cam {ci}: overflow "
                  f"{int(out.overflow)}")
            entries[mode].append(int(out.num_entries))
    # The bench's own scene (colors_precomp), for the entry count.
    means, scales, quats, opac, cols = scene
    t = lambda a: torch.as_tensor(a, device=dev)
    out = rasterize(cams[0], t(means), t(opac), colors_precomp=t(cols),
                    scales=t(scales), quats=t(quats),
                    settings=modes["default"])
    torch.cuda.synchronize()
    renders += 1
    counts = dict(_build.launch_counts)
    bench_entries = int(out.num_entries)
    print(f"[serve] launches over {renders} renders: {counts}", flush=True)
    for k, v in counts.items():
        check(v > 0 or k == "composite_bwd",
              f"kernel {k} never launched on the serving path")
    for mode in modes:
        print(f"[serve] {mode}: num_entries per camera {entries[mode]}, "
              f"median render {statistics.median(times[mode]):.3f} ms "
              f"(eval_render, host clock, 1920x1080)", flush=True)
    rel = abs(bench_entries - REF_ENTRIES) / REF_ENTRIES
    print(f"[serve] bench scene num_entries {bench_entries} vs reference "
          f"{REF_ENTRIES} (rel {rel:.2e})", flush=True)
    check(rel <= 1e-3, "bench num_entries off the reference by > 0.1%")
    check(int(out.overflow) == 0, "bench scene overflow")
    check(counts["composite_bwd"] == 0, "the serving path ran a backward")
    return counts, renders, times, st, cfg


def phase_train(dev, st, cfg):
    """STEPS full-width train_step calls of the serving model, perturbed,
    towards a render of the unperturbed model from camera 0."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.train.loop import eval_render, init_train_state, \
        train_step
    from msgs_torch.train.optimizer import OptimParams
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)
    gt = eval_render(st, cam, cfg=cfg,
                     settings=RasterSettings(entry_cap=ENTRY_CAP)).image
    rng = np.random.default_rng(2)
    noisy = lambda x, s: x + torch.as_tensor(
        rng.normal(0, s, tuple(x.shape)).astype(np.float32), device=dev)
    state = init_train_state(st._replace(
        features_dc=torch.where(st.live[:, None, None],
                                noisy(st.features_dc, 0.3), st.features_dc),
        xyz=torch.where(st.live[:, None], noisy(st.xyz, 0.005), st.xyz)))
    settings = RasterSettings(entry_cap=ENTRY_CAP, image_grads_only=True)
    losses, times = [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for it in range(STEPS):
        t0 = time.perf_counter()
        state, m = train_step(state, cam, gt, cfg=cfg, op=OptimParams(),
                              settings=settings, reso_lvl=0,
                              spatial_lr_scale=5.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(int(m["overflow"]) == 0, f"train step {it} overflowed")
    counts = dict(_build.launch_counts)
    print(f"[train] launches over {STEPS} steps: {counts}", flush=True)
    for k, v in counts.items():
        check(v > 0, f"kernel {k} never launched on the training path")
    for k, v in state.gaussians.params().items():
        check(bool(torch.isfinite(v).all()), f"non-finite parameter {k}")
        # Adam's first moment is a running mean of the gradients: finite
        # moments mean every step's gradient was finite.
        check(bool(torch.isfinite(state.adam.mu[k]).all()
                   and torch.isfinite(state.adam.nu[k]).all()),
              f"non-finite gradient moments of {k}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"[train] {int(st.num_live)} Gaussians (SH 3), {W}x{H}, "
          f"image_grads_only: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (first 3 {first:.6f}, last 3 "
          f"{last:.6f}); median step {statistics.median(times[1:]):.3f} ms "
          f"(host clock, synchronised; first step {times[0]:.3f} ms)",
          flush=True)
    check(math.isfinite(last) and last < first, "training loss did not fall")
    return counts, times


def small_state(dev, n=300, cap=384):
    """A seeded random SH-degree-3 model for the card-vs-CPU checks."""
    from msgs_torch.model.gaussians import GaussianConfig, state_from_numpy
    rng = np.random.default_rng(5)
    f = lambda a: np.asarray(a, np.float32)
    pad = lambda a, fill: np.concatenate(
        [a, np.full((cap - n,) + a.shape[1:], fill, a.dtype)])
    rows = dict(
        xyz=f(np.concatenate([rng.uniform(-1.3, 1.3, (n, 2)),
                              rng.uniform(2.0, 8.0, (n, 1))], 1)),
        features_dc=f(rng.normal(0.4, 0.5, (n, 1, 3))),
        features_rest=f(rng.normal(0, 0.15, (n, 15, 3))),
        scaling=f(rng.uniform(-4.0, -1.8, (n, 3))),
        rotation=f(rng.normal(size=(n, 4))),
        opacity=f(rng.normal(0.5, 1.0, (n, 1))),
        occ_multiplier=f(np.ones((n, 4))), dc_delta=f(np.zeros((n, 4, 3))),
        max_radii2d=f(np.zeros(n)), max_pixel_sizes=f(-np.ones(n)),
        min_pixel_sizes=f(-np.ones(n)), base_mask=np.zeros(n, bool),
        target_reso_lvl=np.zeros(n, np.int32), live=np.ones(n, bool),
        xyz_grad_accum=f(np.zeros((n, 1))), denom=f(np.zeros((n, 1))))
    arrays = {k: pad(v, 1.0 if k == "rotation" else 0)
              for k, v in rows.items()}
    arrays["active_sh_degree"] = np.int32(3)
    return (state_from_numpy(arrays, dev),
            GaussianConfig(sh_degree=3, capacity=cap))


def phase_train_small(dev):
    """One 88×72 train_step on the card and on the CPU from the same state,
    held to tests/test_torch_train.py's budgets."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import PARAM_FIELDS
    from msgs_torch.train.loop import init_train_state, train_step
    from msgs_torch.train.optimizer import OptimParams, group_lrs
    gt = np.random.default_rng(6).uniform(0, 1, (72, 88, 3)).astype(
        np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        st, cfg = small_state(d)
        cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 88, 72, device=d)
        outs.append(train_step(
            init_train_state(st), cam, torch.as_tensor(gt, device=d),
            cfg=cfg, op=OptimParams(), settings=RasterSettings(
                entry_cap=1 << 15, image_grads_only=True),
            reso_lvl=0, spatial_lr_scale=1.0))
    (a, ma), (b, mb) = outs
    check(int(ma["overflow"]) == 0 and int(ma["num_entries"]) > 0,
          "small train step: no entries or overflow")
    for k in ("num_entries", "overflow", "num_live"):
        check(int(ma[k]) == int(mb[k]), f"small train step: {k} differs")
    for k in ("loss", "l1"):
        d = abs(float(ma[k]) - float(mb[k]))
        check(d <= 3e-5 * abs(float(mb[k])) + 1e-6,
              f"small train step: {k} card vs CPU |Δ| {d}")
    lrs = group_lrs(OptimParams(), 1.0, 0)
    for k in PARAM_FIELDS:
        # First-step moments: mu = (1−b1)·g, nu = (1−b2)·g².
        g_a, g_b = a.adam.mu[k].cpu() / 0.1, b.adam.mu[k] / 0.1
        tol = grad_budget(g_b)
        d = (g_a - g_b).abs().max().item()
        check(d <= tol, f"small train step: grad {k} |Δ| {d} > {tol}")
        d = ((a.adam.nu[k].cpu() / 1e-3).sqrt()
             - (b.adam.nu[k] / 1e-3).sqrt()).abs().max().item()
        check(d <= tol, f"small train step: |grad| {k} |Δ| {d} > {tol}")
        # Adam's first update is g/|g|: where |g| is within the budget of 0
        # the two may step apart by 2·lr.
        p_a, p_b = getattr(a.gaussians, k).cpu(), getattr(b.gaussians, k)
        atol = torch.where(g_b.abs() <= tol, 2 * float(lrs[k]) + 1e-6,
                           1e-6 + 1e-6 * p_b.abs())
        check(bool(((p_a - p_b).abs() <= atol).all()),
              f"small train step: parameter {k} differs")
    for k in ("max_radii2d", "max_pixel_sizes", "min_pixel_sizes",
              "xyz_grad_accum", "denom"):
        want = getattr(b.gaussians, k)
        d = (getattr(a.gaussians, k).cpu() - want).abs().max().item()
        check(d <= grad_budget(want), f"small train step: {k} |Δ| {d}")
    for k in ("live", "base_mask", "target_reso_lvl", "active_sh_degree"):
        check(torch.equal(getattr(a.gaussians, k).cpu(),
                          getattr(b.gaussians, k)),
              f"small train step: {k} differs")
    print(f"[train-small] 88x72 train_step on the card matches the CPU plain "
          f"path (loss {float(ma['loss']):.6f})", flush=True)


def phase_small_reference(dev):
    """A small scene on the card vs on the CPU (plain versions)."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels.rasterize import RasterSettings, rasterize
    rng = np.random.default_rng(7)
    n = 500
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(3, 8, (n, 1))], 1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    outs = []
    for d in (dev, "cpu"):
        cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 88, 72, device=d)
        t = lambda a: torch.as_tensor(a, device=d)
        outs.append(rasterize(cam, t(means), t(opac), shs=t(shs),
                              scales=t(scales), quats=t(quats),
                              bg=t(np.array([0.2, 0.3, 0.4], np.float32)),
                              settings=RasterSettings(entry_cap=1 << 15)))
    a, b = outs
    for f, tol in (("image", 1e-5), ("transmittance", 1e-5),
                   ("depth", 1e-4), ("pixel_sizes", 1e-5)):
        d = (getattr(a, f).cpu() - getattr(b, f)).abs().max().item()
        check(d <= tol, f"small scene {f}: card vs CPU max|Δ| {d} > {tol}")
    for f in ("radii", "num_entries", "overflow"):
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"small scene {f}: card vs CPU differ")
    print("[small] 88x72 card render matches the CPU plain path", flush=True)


def bench_scene(seed: int = 0):
    from msgs_torch.profile_render import bench_scene as scene
    return scene(seed)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev, smi_line = phase_device()
    phase_build()

    scans = {
        "scan_f32": scan_record("scan_f32", torch.float32,
                                [(1, 270_336), (5, 1_417_216)], dev),
        "scan_i32": scan_record("scan_i32", torch.int32,
                                [(4, 1_417_216)], dev),
    }
    bench_stream = composite_stream(dev, *bench_scene(0), W, H, ENTRY_CAP)
    comp_rec = composite_check("1920x1080 bench stream", dev, bench_stream,
                               W, H, timed=True)
    rng = np.random.default_rng(3)
    n = 3000
    small = (np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                             rng.uniform(2, 8, (n, 1))], 1).astype(np.float32),
             np.exp(rng.uniform(-4, -2, (n, 3))).astype(np.float32),
             rng.normal(size=(n, 4)).astype(np.float32),
             rng.uniform(0.2, 0.95, n).astype(np.float32),
             rng.uniform(0, 1, (n, 3)).astype(np.float32))
    bwd_rec = composite_bwd_check("1920x1080 bench stream", dev,
                                  bench_stream, W, H, timed=True)
    small_stream = composite_stream(dev, *small, 256, 200, 1 << 17)
    composite_check("256x200 scene", dev, small_stream, 256, 200,
                    timed=False)
    composite_bwd_check("256x200 scene", dev, small_stream, 256, 200,
                        timed=False)
    del bench_stream, small_stream

    serve_counts, renders, _, st, cfg = phase_main_path(dev)
    train_counts, _ = phase_train(dev, st, cfg)
    del st
    phase_small_reference(dev)
    phase_train_small(dev)

    records = []
    meta = {
        "scan_f32": ("msgs_torch/csrc/scan.cu", "msgs/kernels/scan.py:57"),
        "scan_i32": ("msgs_torch/csrc/scan.cu", "msgs/kernels/scan.py:84"),
        "composite_fwd": ("msgs_torch/csrc/composite_fwd.cu",
                          "msgs/kernels/composite.py:401"),
        "composite_bwd": ("msgs_torch/csrc/composite_bwd.cu",
                          "msgs/kernels/composite.py:486"),
    }
    kernel_recs = list(scans.items()) + [("composite_fwd", comp_rec),
                                         ("composite_bwd", bwd_rec)]
    for name, rec in kernel_recs:
        src, rep = meta[name]
        # launches: over the STEPS training steps (this slice's path);
        # launches_serving: over the serving path's renders.
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": train_counts[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "launches_serving": serve_counts[name]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s; "
          f"{renders} serving renders, {STEPS} training steps", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
