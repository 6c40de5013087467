"""Chip smoke run of msgs_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from msgs_torch/csrc (into build/msgs_torch/), then:

  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: the kernel build time and ptxas's register / shared-memory use;
     for the scan (kernels 1, 2), the compositor (3, 4, 4b), every
     ablation kernel instance (7a-9), every gather instance (6: the
     feature table's transpose and the gathers) and every probe instance
     (5), the runtime's registers, stack, static and dynamic shared memory
     and CTAs per SM (cudaFuncGetAttributes,
     cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes (scans exact, also at lengths around a
     chunk and a prime near 10^6; compositor forward image and T ≤ 1e-5,
     depth and acc ≤ 1e-4; compositor backward per payload column ≤
     3e-5·max|column| + 1e-6, for image_only True and False), with median
     times (CUDA events) beside the profiler's device time, the plain
     version's time and, for the scans, torch.cumsum's time as a yardstick
     (timed in turns with the kernel), the host-clock times, and a profile
     that must show one scan launch per call and no memset;
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
     CPU parity test's budgets (tests/test_torch_train.py);
  7. the bwd_bf16 compositor backward (composite_bwd_bf16.cu) against its
     plain version per payload column (≤ BF16_BUDGET·max|column| + 1e-6)
     at the bench stream and the 256×200 scene, both image_only values;
     two launches bit-identical; and rasterize's parameter gradients with
     it against those with the exact kernel under the JAX suite's bf16
     criterion (tests/test_rasterize.py:157), on the same two scenes. The
     exact kernel is timed beside it;
  8. trainer: msgs_torch.data.synthetic renders the synthetic scene
     (24 + 8 views, 512×512, 20,000 Gaussians, seed 0) and
     msgs_torch.apps.train.main trains it 1,100 iterations in the MS-GS
     configuration (--ms_train --ms_train_max_scale 6 --filter_small
     --insert_large --bwd_bf16 --fast_grads, capacity 131,072, shortened
     densify cadence); counters are zeroed just before and read just after.
     It fails unless the bf16 backward, the forward and both scans ran and
     the exact backward did not, densify changed the live count, each of
     the three insert episodes inserted aggregates, every parameter and
     moment is finite, the logged losses at iterations 100-300 are the
     JAX package's reference run's (data/quality/ms/train_log.jsonl) within
     LOSS_REL, the ×1 test PSNR rose by PSNR_GAIN_DB from iteration 1 to
     600 (before the opacity reset), the PLY snapshot loads back and a
     resume from the iteration-600 checkpoint runs. The bf16 backward is
     then held against its plain version (BF16_BUDGET per column) on the
     last stream the run gave it at each image size, and on the streams of
     one train_step of the final state at each of COARSE_LVLS. Kernels 3,
     4b and 4 are timed on the run's last 512² stream (CUDA events, and
     the profiler's device time from a fresh process's trace of the same
     calls on the same inputs; traces in this process, in turns with and
     without idle time padding their window, are printed beside it: late
     in a long process traces lose events), and kernels 1 and 2
     at every shape the run scanned (exact, then timed as in item 3), with
     Σ calls × (ms − bound) per scan kernel.
  9. tools: the ported gather experiments (msgs_torch.tools.exp_gather and
     exp_gather2) run in-process at their defaults (N = 100,000, E = 2^21);
     counters are zeroed just before and read just after, and the gather
     kernel must have run. Every variant must equal table[gid] in its
     layout bit for bit (the scripts raise otherwise). Then gather_rows is
     held against its plain version, bit for bit, on the render path's own
     stream (the serving model's feature table, 131,073 × 12 at capacity
     2^17, and binning's 1,687,552 gauss_id slots) in all three output
     layouts, and timed there against table[gid]; the same from the
     table's transpose (feature-major, 12 × 131,073: two launches, the
     transpose and the gather), each layout equal bit for bit to its plain
     version and to the row table's gather, the feature-major output timed
     in turns with table_t[:, gid], also at the scripts' default. A
     gather's bound counts E·F floats written, E ids and each table row
     that gid references read once (msgs_torch.tools.gather_bytes). The
     render path's gather_payload is timed on the host clock and its
     device time read from a profiler trace.
 10. mxu: the ported pair-math probe (msgs_torch.tools.exp_mxu) runs
     in-process at its default, 14,336 blocks of 128 entries × a 16×16
     tile; counters are zeroed just before and read just after, and the
     probe kernel (csrc/mxu_probe.cu) must have run in each of the 12
     runs. Each run's summed output is within its row budget of its plain
     version (the script raises otherwise: 1e-5·max|row| at either
     precision). Each run prints its SASS instructions per pair (the
     built library disassembled with cuobjdump) and the issue floor they
     set (msgs_torch/tools/work.py:issue_floor_ms) at the card's
     clocks.max.sm, 1,980 MHz (the clock under load is not measured).
     Then, at 512 blocks, every variant and precision per block against
     its plain version within the same budget, and the f32 runs bit for
     bit, dfeat_nt's df on a seeded nonzero g_rows (and its summed
     output); two launches bit-identical; and pow_mxu's (block, pixel)
     cells that differ from the plain version by a mask flip's size
     (MXU_FLIP_SIZE), counted.
 11. ablate: the ported compositor ablations (msgs_torch.tools.
     exp_fwd_ablate) run in-process in `all` mode at the script's stream
     (the bench scene at entry_cap 1,572,864, 14,336 blocks); counters
     are zeroed just before and read just after, and both ablation kernels
     (csrc/fwd_ablate.cu, csrc/bwd_ablate.cu) must have run in each of
     the 15 variants, each within the tool's budgets of its plain version
     (the tool raises otherwise). On that whole stream fwd/full at each
     tile's last sub must equal composite_fwd.cu's output and bwd/full's
     r g b columns composite_bwd.cu's image-only ones, bit for bit. Then
     every variant against its plain version, written slots equal and
     values within the budgets, on the clustered check stream
     (exp_fwd_ablate.clustered_stream: skips and boundary crossings), the
     staggered one (exp_fwd_ablate.staggered_stream: strips that finish
     at different subs on both sides of a block boundary, a tile that
     saturates before its run's last block), the 256×200 scene and the
     first 512 blocks of the script's stream. Each run prints its
     CUDA-event time, the device time of each kernel it launched (the
     running sum apart), and its bound (msgs_torch/tools/work.py) with its
     share of the event time.
 12. bwd2: the ported follow-up experiments (msgs_torch.tools.exp_bwd2
     and exp_bwd3) run in-process at the same stream, nothing cut;
     counters are zeroed just before each script and read just after, and
     fwd/horner (the `horner` instance of csrc/fwd_ablate.cu) and every
     backward form (csrc/bwd_ablate.cu) must have run. Every run equals its
     plain version bit for bit (up to the sign of a zero), and fwd/horner's
     running sum is nonzero. On that whole stream every backward form is
     held against composite_bwd.cu's image-only backward under a cotangent
     of 0.1 with its depth and acc rows 0 (the constant rows' total_phi is
     over r g b): the colour columns bit for bit, the vpu forms' geometry
     columns bit for bit (predicted; failing that, within the gradient
     budget, and the miss is printed), the dot_f32 forms' within 3e-5·max
     |column| + 1e-6. Then every run against its plain version, bit for
     bit, on the four check streams of [ablate]. Each run prints as in
     [ablate].

 13. rowtight: the bench scene (colors_precomp, 1920×1080, entry_cap
     1,417,216) preprocessed once on the card, then binned with
     row_tight=True on the card and, from the same output copied to the
     CPU, by the plain path: every integer field equal, gauss_id equal per
     tile as a multiset; num_entries within 0.1% of JAX-on-CPU's 1,156,045,
     below the banded path's, no overflow. The scene rendered both ways on
     the card: image within 1e-5 and depth within 1e-4 of the banded
     render at every pixel of a tile whose entries share no depth key
     between two Gaussians (the tiles excused are counted). Counters are
     zeroed just before and read just after: both scans and the forward
     compositor ran, no backward. bin_gaussians' median host ms, row-tight
     and bands in turns; kernel 1 held exact against its plain version on
     row-tight's own 5 × 1,417,216 delta planes and timed there as in
     item 3.
 14. eval: inside the trainer's directory (item 8), before it is removed,
     msgs_torch.apps.render (--anti_alias, the model's filters), then
     metrics, then eval_scales at ×1 2 4 8 on the iteration-1100 PLY and
     with --checkpoint on chkpnt600.npz, each through its main(argv) on
     the card; counters are zeroed just before and read just after: both
     scans and the forward compositor ran, no backward. Every number they
     write is finite; metrics' ×1 test PSNR (8-bit PNGs) is within
     PNG_PSNR_DB of the trainer's final test_s1; eval_scales' median ms per
     render is printed per scale; LPIPS with seeded synthetic weights
     between a 512² test render and its ground truth matches the same call
     on the CPU within rtol 2e-4 (tests/test_lpips.py's tolerance), and is
     timed (CUDA events).
 15. dist: inside the trainer's directory, sharded training
     (msgs_torch/dist/) on the one card, every rank a process started with
     `spawn` after the parent built the kernels. (1) Parity: 4 ranks as a
     2×2 mesh over gloo take the sharded loss and its gradients for one
     512² train view at λ 0.2 from the [trainer] model at iteration 0
     (SH 3, capacity 131,072, entry_cap 1,048,576, the filters, bwd_bf16
     and fast_grads, and with the exact backward); against the
     single-device loss in this process the loss is within rtol 1e-5 and
     every parameter and probe gradient within 3e-5·max|g| for the exact
     backward (tests/test_dist.py's budgets), BF16_GRAD_REL·max|g| for the
     bf16 settings; num_entries summed over the stripes and overflow are
     printed beside the single-device ones; the ranks' counters must show
     kernels 1, 2, 3, 4 and 4b. (2) NCCL refuses two ranks on the one card;
     a world of one rank over NCCL (mesh 1×1) takes one sharded train step
     that equals the single-device train_step (loss rtol 1e-5, Adam
     moments 3e-5·max, the rest 1e-5·max, integers exact). (3) The dry run
     of msgs_torch.dist.dryrun (dryrun_multichip(4)'s ranks and checks),
     on part 1's ranks after it: the packet cap grows, densify and insert
     run through the cold path, the loss ends finite with no overflow.
     Parts 1 and 3 share one spawn of 4 ranks; part 2's rank runs beside
     them, and each part's seconds are printed. (4) The trainer CLI under
     torchrun (chip_smoke.py as each rank's entry, which calls
     msgs_torch.apps.train.main and writes its counters), --mesh 2 2
     --dist_backend gloo, the [trainer] flags cut to 300 iterations: the
     logged losses at 100, 200 and 300 within LOSS_REL of [trainer]'s, the
     live counts after each densify beside [trainer]'s, and the median
     iteration time of four ranks sharing one card, and rank 0's timeline
     (start-up, set-up, iterations, exit). Every rank's counters
     come back and count in the kernel records (launches_dist).

 16. apps: inside the trainer's directory, after [eval], the interactive
     apps on its iteration-1100 PLY, on the card; counters are zeroed at
     the start and read at the end: both scans and the forward compositor
     ran, no backward. The viewer headless (--anti_alias) at --reso_scale
     1 and 4, and at 1 with --device cpu: the card's view.png equal to the
     CPU's but for 1 at the truncation boundary (1e-5 of the CPU's render;
     msgs_torch.apps.render.truncation_mismatches); the --display key loop
     through a stub cv2 playing back VIEWER_KEYS then ESC, frame.png the
     frame shown at p. traj.trajectory_frames for TRAJ_FRAMES circle frames
     sweeping x1 to x64 (after a 4-frame warm-up), the median synchronised
     host ms per frame at each scale printed; traj.main end to end where
     an mp4 encoder imports, else one line saying why not. One loopback
     SIBR client sends GUI_REQUESTS requests for the first train view,
     each answered through network_gui.serve_step on the card: every frame
     equal to to_uint8(eval_render(...).image) of the camera receive built,
     the median round trip printed. video_tools concat and
     visualize_cameras on PNGs, importing none of PIL, imageio and cv2.

 17. io: inside the trainer's directory, after [apps]. The native
     COLMAP/PLY library (msgs_torch/native/colmap_io.cpp) is built with g++
     into build/msgs_torch/native/; if it does not build the run fails with
     the compiler's message (the struct readers' fallback does not pass
     here). A COLMAP binary model made from IO_SEED with numpy (IO_POINTS
     points with track lengths 3-6, IO_IMAGES images of IO_KEYPOINTS
     keypoints) is read by the native readers and by the struct readers:
     equal within tests/test_native_io.py's tolerances (xyz and err atol
     1e-6, rgb exact, qvec and tvec allclose), and equal to what was
     written (the native path rounds xyz and err through float32);
     load_sparse must take the native path. read_ply_f32 on the trainer's
     iteration-1100 PLY equals ply.read_ply. A x1 render of the first
     train view (kernels 1-3; counters zeroed before, read after) feeds
     add_large_gaussians_backproject on the card and on the CPU: equal
     touched rows, n_inserted, integer and pixel-size fields, float fields
     within 1e-6·max|x| + 1e-7 (a block within 4 ulp of the threshold may
     flip; they are counted); the render after the insert is finite with
     no overflow. Read times, n_inserted and the phase's seconds are
     printed.

Any failed check raises, and the script exits non-zero without its result
lines. On success the second-to-last lines are the nvidia-smi line and one
JSON object describing every kernel; the last line is the device record.
"""
from __future__ import annotations

import collections
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

# The H100's peaks and the compositor family's fp32 operations per (entry,
# pixel) pair, the pair-math probe's included: one table for this script
# and the tools.
from msgs_torch.tools.work import (MMA_FLOPS_PER_PAIR,  # noqa: E402
                                   OPS_PER_PAIR, OPS_PER_PAIR_BWD,
                                   OPS_PER_PAIR_BWD_BF16, PEAK_BF16,
                                   MAX_SM_CLOCK_HZ, PEAK_BYTES, PEAK_FP32,
                                   PROBE_OPS, PROBE_PAIRS_PER_PASS,
                                   issue_floor_ms, saturation_work)

W, H = 1920, 1080
N = 100_000
ENTRY_CAP = 1_417_216
REF_ENTRIES = 1_287_253       # BENCH_r05.json detail.n_entries (TPU run)
# Idle host time at both ends of trace_window's padded traces.
TRACE_PAD_S = 0.02
# chip_smoke.py's own argument for fresh_child's child process.
FRESH_FLAG = "--trainer-device-ms"
STEPS = 20                    # full-width train steps
# The bf16 kernel vs its plain version, per column, relative to the
# column's largest value: the two differ in the order of f32 sums and in
# the bf16 rounding flips that causes. The JAX suite's own criterion is
# 2e-2 (tests/test_rasterize.py:157).
BF16_BUDGET = 2e-3
# ×1 test PSNR, iteration 600 over iteration 1. The evaluation at 600 runs
# before that iteration's opacity reset; after it, the reset and, from 700,
# the prune of Gaussians wider than 20 pixels pull ×1 down for hundreds of
# iterations at 512² (on the H100: +2.64 dB at 600, +0.03 at 1000 and +0.58
# at 1100 without the bf16 flags, in one run of the trainer CLI).
PSNR_GAIN_DB = 2.0
TRAIN_ITERS = 1100
PSNR_ITER = 600
# The coarse levels the bf16 backward is also held at (64², 8²): the run
# trains at 512² only, since the schedule unlocks coarser levels after the
# insert episodes.
COARSE_LVLS = (3, 6)
# The trainer's logged losses at iterations 100, 200 and 300 against the JAX
# package's run of the same configuration on a scene of the same generator
# and seed (data/quality/ms/train_log.jsonl): relative budget. The two runs
# part after the first densify, at 300 here and 500 there.
LOSS_REL = 1e-2
REF_LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "quality", "ms", "train_log.jsonl")
# [dist]: the [trainer] phase's model and settings, the JAX suite's sharded
# budgets (tests/test_dist.py: loss rtol 1e-5, gradients 3e-5·max|g|, a
# step's state 1e-5·max|x|), and the sharded trainer's iterations (its
# first densify is at 300).
DIST_CAPACITY = 131_072
DIST_ENTRY_CAP = 1 << 20
DIST_LAMBDA = 0.2
DIST_ITERS = 300
DIST_PROF = (150, 160)        # rank 0's torch.profiler window in [dist]
GRAD_REL = 3e-5
STEP_REL = 1e-5
# [dist] parity's bound on the sharded gradients with the trainer's bf16
# settings, relative to max|g|: about 6x the worst reading (1.52e-4, xyz,
# on an NVIDIA H100 80GB HBM3 at 700 W). The stripes' SSIM convolutions round
# differently from the whole image's, and the bf16 rounding of the
# per-entry cotangents turns such a last-bit change into 2^-8 of an entry,
# so the exact backward's 3e-5 does not hold here; it guards the sharding
# on the exact pass.
BF16_GRAD_REL = 1e-3
# chip_smoke.py's own argument for a torchrun rank of [dist] part 4.
DIST_TRAINER_FLAG = "--dist-trainer-rank"
# [io]: the COLMAP model's seed and size (the order of a large SfM
# reconstruction), and the level the back-projection tags its rows with.
IO_SEED = 0
IO_POINTS = 1_000_000
IO_IMAGES = 300
IO_KEYPOINTS = 4000
IO_LVL = 2


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
    # One line per kernel: its mangled name (template arguments as
    # ptxas gives them), registers, stack and spills (ptxas -v).
    name = stack = None
    for line in info.get("log", "").splitlines():
        if line.startswith("=="):
            print(f"[build]   {line.strip()}")
        elif "Function properties for" in line:
            name = line.split("for", 1)[1].strip()
        elif "stack frame" in line:
            stack = line.strip()
        elif "registers" in line and name:
            print(f"[build]   {name}: "
                  f"{line.split(':', 1)[1].strip()}; {stack}")
            name = None
    # The redesigned kernels' builds as the runtime reports them.
    for label, entry, arg in (KERNEL_INFO + ablate_kernel_info()
                              + gather_probe_kernel_info()):
        i = _build.kernel_info(entry, arg)
        print(f"[build] {label}: {i['registers']} registers, "
              f"{i['stack_bytes']} bytes of stack, {i['static_smem']} bytes "
              f"of static and {i['dynamic_smem']} of dynamic shared memory, "
              f"{i['ctas_per_sm']} CTAs per SM", flush=True)


# (label, msgs_*_info entry, argument) of the kernels [build] reads back.
KERNEL_INFO = (("scan_lookback<float> (kernel 1)", "msgs_scan_info", 0),
               ("scan_lookback<int32> (kernel 2)", "msgs_scan_info", 1),
               ("composite_fwd (kernel 3)", "msgs_composite_fwd_info", 0),
               ("composite_bwd image_only (kernel 4)",
                "msgs_composite_bwd_info", 1),
               ("composite_bwd all columns (kernel 4)",
                "msgs_composite_bwd_info", 0),
               ("composite_bwd_bf16 image_only (kernel 4b)",
                "msgs_composite_bwd_bf16_info", 1),
               ("composite_bwd_bf16 all columns (kernel 4b)",
                "msgs_composite_bwd_bf16_info", 0))


def ablate_kernel_info() -> tuple:
    """KERNEL_INFO's entries for the ablation kernels (7a-9): the forward
    variants' tile or block kernel and the running sum (fwd_ablate.cu),
    every built backward instance (bwd_ablate.cu)."""
    from msgs_torch.kernels import ablate
    kind = {v: "fwd_tile" if v in ablate.TILE_VARIANTS else "fwd_block"
            for v in ablate.ALL_FWD}
    fwd = tuple((f"fwd_ablate {v} ({kind[v]}_kernel)", "msgs_fwd_ablate_info",
                 i) for i, v in enumerate(ablate.ALL_FWD))
    fwd += (("fwd_ablate running_sum_kernel", "msgs_fwd_ablate_info",
             len(ablate.ALL_FWD)),)
    return fwd + tuple(
        (f"bwd_ablate {v} ({f.moments}, {f.constants}, {f.store}, "
         f"{f.zeroing})", "msgs_bwd_ablate_info", i)
        for i, (v, f) in enumerate(ablate.BWD_INSTANCES))


def gather_probe_kernel_info() -> tuple:
    """KERNEL_INFO's entries for the gather (kernel 6: the transpose and
    every gather instance) and the pair-math probe (kernel 5: every
    variant, precision and output mode)."""
    from msgs_torch.kernels import gather, mxu_probe
    out = tuple((f"gather_rows {name} (kernel 6)", "msgs_gather_rows_info", i)
                for i, name in enumerate(gather.GATHER_INSTANCES))
    return out + tuple(
        (f"mxu_probe {v}{' ' + p if p else ''}{' per block' if pb else ''} "
         f"(kernel 5)",
         "msgs_mxu_probe_info", mxu_probe.instance_index(v, p, pb))
        for v, p, pb in mxu_probe.PROBE_INSTANCES)


def device_text(split) -> str:
    """A tool record's kernel_ms: device ms per call of each kernel (the
    running sum apart from the block terms), with the events kept."""
    if not split:
        return "device not measured"
    return "device " + ", ".join(f"{k} {v['ms']:.4f} ms ({v['events']} ev)"
                                 for k, v in split.items())


def run_text(r) -> str:
    """One ablation or follow-up run: its event time, its device time per
    kernel, and its bound with the share of the event time it is."""
    return (f"{r['name']} {r['ms']:.4f} ms, {device_text(r['kernel_ms'])}, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['pairs']} pairs, {r['bytes']} bytes; "
            f"{r['bound_ms'] / r['ms']:.1%} of the event time), max|Δ| "
            f"{r['max_abs_err']:.3e}{' exact' if r['exact'] else ''}")


def paired_ms(fa, fb, reps: int = 50) -> tuple:
    """Median CUDA-event times of fa and fb, timed in turns (a b b a ...),
    so that a drift of the host's speed touches both alike."""
    for _ in range(2):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            (fa, fb)[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e))
    return statistics.median(times[0]), statistics.median(times[1])


def host_ms(fn, reps: int = 20) -> float:
    """Median host-clock ms of one call of fn, synchronised."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 5, tries: int = 3):
    """(mean device ms of `kernel`'s events, events, traces) from profiler
    traces of reps calls of fn. A trace can lose events, at times all of
    them: one that kept none of `kernel`'s is taken again, up to `tries`
    traces. Every trace taken is returned, by kernel; (None, 0) if none
    kept an event of `kernel`. Late in a long process traces lose events
    (PERF.md §7; trace_window, fresh_child)."""
    from msgs_torch.tools import trace_ms
    traces = []
    for _ in range(tries):
        traces.append(trace_ms(fn, reps))
        rec = traces[-1].get(kernel)
        if rec:
            return rec["ms"], rec["events"], traces
    return None, 0, traces


def trace_window(fn, kernel: str, reps: int = 5, pairs: int = 3) -> dict:
    """Whether the profiler's window loses device events: traces of fn in
    turns without and with TRACE_PAD_S of idle host time at both ends of
    the window. Per trace: the events of `kernel` it kept, the
    cudaLaunchKernel records it kept, the µs from each kept event's launch
    to its start (least, most), and the µs from the last kept event's end
    to the window's end. Events that fall outside the window on the host's
    clock would be kept by the padded traces alone. Returns {"plain":
    [...], "padded": [...]}."""
    from msgs_torch.tools import kernel_name, trace_events
    out = {"plain": [], "padded": []}
    for _ in range(pairs):
        for key, pad in (("plain", 0.0), ("padded", TRACE_PAD_S)):
            ev = trace_events(fn, reps, pad)
            win = [e for e in ev if e.get("cat") == "Trace"]
            launch = {e["args"]["correlation"]: e["ts"] for e in ev
                      if e.get("cat") == "cuda_runtime"
                      and e.get("name", "").startswith("cudaLaunchKernel")
                      and "correlation" in e.get("args", {})}
            ks = [e for e in ev if e.get("ph") == "X"
                  and e.get("cat") == "kernel" and kernel_name(e) == kernel]
            gaps = [e["ts"] - launch[e["args"]["correlation"]] for e in ks
                    if e.get("args", {}).get("correlation") in launch]
            tail = (win[0]["ts"] + win[0]["dur"]
                    - max(e["ts"] + e["dur"] for e in ks)
                    if ks and win else None)
            out[key].append(dict(
                events=len(ks), launches=len(launch),
                launch_to_start_us=[round(min(gaps), 1), round(max(gaps), 1)]
                if gaps else None,
                tail_us=None if tail is None else round(tail, 1)))
    return out


def trace_total_ms(fn, reps: int = 10, kernels: int = 1, tries: int = 3):
    """Device ms of one call of fn: the mean device ms of each of its
    `kernels` kernels, summed, from a profiler trace of reps calls
    (trace_ms). A trace can lose events, late in a long process all of a
    kernel's: one that kept no event of some kernel is taken again, up to
    `tries` traces; None if none kept them all."""
    from msgs_torch.tools import trace_ms
    for _ in range(tries):
        tr = trace_ms(fn, reps)
        if len(tr) >= kernels:
            return sum(v["ms"] for v in tr.values())
    return None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def scan_traces(x) -> dict:
    """Profiler traces of 10 calls of kernel 1 or 2 on x (device_ms) and
    of 10 of torch.cumsum's (trace_ms): {"kernel": (ms, events, traces),
    "library": {kernel: {"ms", "events"}}}."""
    from msgs_torch.kernels import scan
    from msgs_torch.tools import trace_ms
    return dict(kernel=device_ms(lambda: scan.cumsum_rows(x),
                                 "scan_lookback", 10),
                library=trace_ms(
                    lambda: torch.cumsum(x, dim=-1, dtype=x.dtype), 10))


def scan_times(x, reps: int = 20, traced=None) -> dict:
    """Kernel 1 or 2 on x: CUDA-event, host-clock and device times, its
    launches per call counted by the profiler, torch.cumsum's times, and
    the bytes bound. traced: scan_traces(x) as taken elsewhere (in a
    fresh process); by default they are taken here."""
    from msgs_torch.kernels import scan
    R, E = x.shape
    call = lambda: scan.cumsum_rows(x)
    lib = lambda: torch.cumsum(x, dim=-1, dtype=x.dtype)
    ms, lib_ms = paired_ms(call, lib, 2 * reps + 10)
    plain = median_ms(lambda: scan.cumsum_rows_plain(x), reps)
    traced = traced or scan_traces(x)
    dev_ms, events, traces = traced["kernel"]
    # One launch per call and no memset: every trace holds scan_lookback
    # only, at most once per call (a trace may lose events), and one of
    # them holds it.
    check(events > 0 and all(
        set(tr) <= {"scan_lookback"}
        and tr.get("scan_lookback", {"events": 0})["events"] <= 10
        for tr in traces),
          f"scan {R}x{E}: the profiler saw {traces}, 10 calls a trace")
    lib_tr = traced["library"]
    nbytes = 2 * R * E * 4
    bound = max(nbytes / PEAK_BYTES, R * E / PEAK_FP32) * 1e3
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes", host_ms=host_ms(call, reps),
                library_host_ms=host_ms(lib, reps), device_ms=dev_ms,
                device_events=events, device_traces=len(traces),
                library_device_ms=(sum(v["ms"] for v in lib_tr.values())
                                   if lib_tr else None),
                library_kernels=sorted(lib_tr), shape=[R, E])


def scan_line(label, rec) -> str:
    return (f"{label} {rec['shape'][0]}x{rec['shape'][1]}: kernel "
            f"{rec['ms']:.4f} ms (CUDA events, in turns with torch.cumsum; "
            f"host clock {rec['host_ms']:.4f}, "
            f"device {rec['device_ms']:.4f} from {rec['device_events']} of 10 "
            f"calls in trace {rec['device_traces']}, one launch per call, no "
            f"memset), torch.cumsum "
            f"{rec['library_ms']:.4f} ms (host clock "
            f"{rec['library_host_ms']:.4f}, device "
            f"{ms_text(rec['library_device_ms'])}: "
            f"{rec['library_kernels']}), "
            f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")


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
            t = scan_times(x)
            rec = {k: t.pop(k) for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}
            rec.update(max_abs_err=err, extra=t)
            print(f"[kernels] {scan_line(name, dict(rec, **t))}", flush=True)
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
    dev_ms = device_ms(lambda: comp._composite_cuda(*args),
                       "composite_fwd_kernel")[0]
    plain = median_ms(lambda: comp._composite_plain(*args), 3, warmup=1)
    t0 = time.perf_counter()
    work_subs, strips = saturation_work(stream, width, height)
    count_s = time.perf_counter() - t0
    check(work_subs == int(n_work),
          f"composite_fwd {label}: {work_subs} sub-blocks before saturation "
          f"against the plain forward's {int(n_work)}")
    pairs = strips * 32 * 32
    nbytes = work_subs * 32 * 12 * 4 + tiles * 2 * 4 + tiles * 8 * 256 * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    print(f"[kernels] composite_fwd {label}: kernel {ms:.4f} ms (device "
          f"{ms_text(dev_ms)}), plain "
          f"{plain:.4f} ms; {int(n_sub.sum())} valid sub-blocks, "
          f"{work_subs} before saturation, {strips} of the "
          f"{8 * work_subs} warp-sub-blocks before their strip is done "
          f"(counted in {count_s:.3f} s), {pairs} pairs; "
          f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
          f"operations {t_ops:.4f})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=max(errs[c] for c in ("r", "g", "b", "T")),
                valid_subs=int(n_sub.sum()), work_subs=work_subs,
                extra=dict(device_ms=dev_ms, warp_subs=strips))


def grad_budget(want) -> float:
    """The JAX suite's gradient budget, 3e-5·max|g| + 1e-6."""
    return 3e-5 * max(float(want.abs().max()), 1e-8) + 1e-6


def bwd_work(stream, width, height):
    """A backward's work on this stream: (sub-blocks before saturation,
    (entry, pixel) pairs before each strip is done, ms to move its bytes —
    payload and dpay of those sub-blocks, forward output and cotangent,
    tile ranges)."""
    n_work, strips = saturation_work(stream, width, height)
    tiles = stream[3]
    nbytes = 2 * n_work * 32 * 12 * 4 + 2 * tiles * 8 * 256 * 4 \
        + tiles * 2 * 4
    return n_work, strips * 32 * 32, nbytes / PEAK_BYTES * 1e3


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
            dev_ms = device_ms(lambda: comp._composite_bwd_cuda(*args),
                               "composite_bwd_kernel")[0]
            plain = median_ms(lambda: comp.composite_bwd_reference(*args), 3,
                              warmup=1)
            n_work, pairs, t_bytes = bwd_work(stream, width, height)
            nf = 3 if image_only else 5
            t_ops = pairs * OPS_PER_PAIR_BWD[nf] / PEAK_FP32 * 1e3
            print(f"[kernels] composite_bwd {label} image_only={image_only}: "
                  f"kernel {ms:.4f} ms (device {ms_text(dev_ms)}), plain "
                  f"{plain:.4f} ms; {n_work} "
                  f"sub-blocks before saturation, {pairs} pairs; bound "
                  f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
                  f"operations {t_ops:.4f})", flush=True)
            recs[image_only] = dict(
                ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=err, extra=dict(device_ms=dev_ms))
    if timed:
        # Deterministic: a second launch is bit-identical.
        a = comp._composite_bwd_cuda(payload, first, n_sub, res, cot, tiles,
                                     tx, width, height, True)
        b = comp._composite_bwd_cuda(payload, first, n_sub, res, cot, tiles,
                                     tx, width, height, True)
        check(torch.equal(a, b), "composite_bwd is not deterministic")
    # The trainer's setting (image_grads_only) is the record.
    return recs.get(True)


def bf16_close(got, want) -> tuple:
    """The JAX suite's bf16 criterion (tests/test_rasterize.py:157):
    |Δ| ≤ 2e-2·max|want|, and over entries above 1e-2·max the 99th
    percentile of the relative error < 10%. Returns (ok, worst |Δ|/max,
    q99)."""
    scale = max(float(want.abs().max()), 1e-8)
    d = (got - want).abs()
    worst = float(d.max()) / scale
    sig = want.abs() > 1e-2 * scale
    q99 = float(torch.quantile((d[sig] / want[sig].abs()).double().cpu(),
                               0.99)) if bool(sig.any()) else 0.0
    return worst <= 2e-2 and q99 < 0.10, worst, q99


def ptxas_report(source: str) -> str:
    """The ptxas lines of one source in the build log."""
    from msgs_torch.kernels import _build
    out, on = [], False
    for line in _build.build_info.get("log", "").splitlines():
        if line.startswith("=="):
            on = source in line
        elif on and ("registers" in line or "stack frame" in line):
            out.append(line.strip().replace("ptxas info    : ", ""))
    return "; ".join(out)


def composite_bwd_bf16_check(label, dev, stream, width, height,
                             timed: bool):
    """The bwd_bf16 kernel vs composite_bwd_bf16_reference and vs the exact
    kernel, on the card, for image_only False and True."""
    from msgs_torch.kernels import _build
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
        got = comp._composite_bwd_bf16_cuda(*args).reshape(-1, comp.NFEAT)
        torch.cuda.synchronize()
        want = comp.composite_bwd_bf16_reference(*args).reshape(
            -1, comp.NFEAT)
        exact = comp._composite_bwd_cuda(*args).reshape(-1, comp.NFEAT)
        torch.cuda.synchronize()
        last = comp.F_B if image_only else comp.F_PSIZE
        err, worst_rel, worst_exact, worst_q99 = 0.0, 0.0, 0.0, 0.0
        for c in range(last + 1):
            d = (got[:, c] - want[:, c]).abs().max().item()
            scale = max(float(want[:, c].abs().max()), 1e-8)
            tol = BF16_BUDGET * scale + 1e-6
            check(math.isfinite(d) and d <= tol,
                  f"composite_bwd_bf16 {label} image_only={image_only}: "
                  f"column {c} max|Δ| {d} > {tol}")
            err = max(err, d)
            worst_rel = max(worst_rel, d / scale)
            # Per entry, the distance to the exact kernel is the contract's
            # own (bf16 operands, cancellation in the per-entry sums); the
            # JAX criterion holds it at the parameter gradients, which
            # bf16_grads_check does. Printed here for the record.
            _, w_e, q99 = bf16_close(got[:, c], exact[:, c])
            worst_exact = max(worst_exact, w_e)
            worst_q99 = max(worst_q99, q99)
        check(bool((got[:, last + 1:] == 0).all()),
              f"composite_bwd_bf16 {label}: uncomputed columns not zero")
        print(f"[kernels] composite_bwd_bf16 {label} image_only="
              f"{image_only}: vs plain max|Δ| {err:.3e}, worst column "
              f"{worst_rel:.3e} of its max (budget {BF16_BUDGET}); per "
              f"payload entry vs the exact kernel worst {worst_exact:.3e} of "
              f"max, q99 rel {worst_q99:.4f} (not a criterion)", flush=True)
        if timed:
            ms = median_ms(lambda: comp._composite_bwd_bf16_cuda(*args), 20)
            dev_ms = device_ms(lambda: comp._composite_bwd_bf16_cuda(*args),
                               "composite_bwd_bf16_kernel")[0]
            exact_ms = median_ms(lambda: comp._composite_bwd_cuda(*args), 20)
            plain = median_ms(
                lambda: comp.composite_bwd_bf16_reference(*args), 3,
                warmup=1)
            n_work, pairs, t_bytes = bwd_work(stream, width, height)
            nf = 3 if image_only else 5
            t_ops = pairs * OPS_PER_PAIR_BWD_BF16[nf] / PEAK_FP32 * 1e3
            t_mma = pairs * MMA_FLOPS_PER_PAIR / PEAK_BF16 * 1e3
            bound = max(t_bytes, t_ops, t_mma)
            info = _build.kernel_info("msgs_composite_bwd_bf16_info",
                                      int(image_only))
            print(f"[kernels] composite_bwd_bf16 {label} image_only="
                  f"{image_only}: kernel {ms:.4f} ms (device {ms_text(dev_ms)}; "
                  f"the exact kernel {exact_ms:.4f} ms in this call), plain "
                  f"{plain:.4f} ms; "
                  f"{n_work} sub-blocks before saturation, {pairs} pairs; "
                  f"bound {bound:.4f} ms (bytes {t_bytes:.4f}, fp32 "
                  f"operations {t_ops:.4f}; the staged-MMA design's tensor-core "
                  f"operations {t_mma:.4f}); ptxas: "
                  f"{ptxas_report('composite_bwd_bf16.cu')}; {info}",
                  flush=True)
            recs[image_only] = dict(
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                bound_by="operations" if max(t_ops, t_mma) >= t_bytes
                else "bytes", max_abs_err=err,
                extra=dict(device_ms=dev_ms, exact_kernel_ms=exact_ms,
                           build=info))
    if timed:
        a = comp._composite_bwd_bf16_cuda(payload, first, n_sub, res, cot,
                                          tiles, tx, width, height, True)
        b = comp._composite_bwd_bf16_cuda(payload, first, n_sub, res, cot,
                                          tiles, tx, width, height, True)
        check(torch.equal(a, b), "composite_bwd_bf16 is not deterministic")
    return recs.get(True)


def trainer_kernels(args) -> list:
    """(name, call) of kernels 3, 4b and 4 on a kept trainer stream."""
    from msgs_torch.kernels import composite as comp
    payload, first, n_sub, res, cot, tiles, tx, width, height, io = args
    return [("composite_fwd", lambda: comp._composite_cuda(
                payload, first, n_sub, tiles, tx, width, height)),
            ("composite_bwd_bf16",
             lambda: comp._composite_bwd_bf16_cuda(*args)),
            ("composite_bwd", lambda: comp._composite_bwd_cuda(*args))]


def fresh_child(kind: str, args: list):
    """fresh_device_child's result for `kind` on args, from a fresh process
    (chip_smoke.py FRESH_FLAG FILE) given the same inputs saved to FILE:
    late in a long process the profiler loses events (PERF.md §7). The
    child's launches do not count."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save([kind] + [a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in args], path)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            FRESH_FLAG, path], capture_output=True,
                           text=True, timeout=600)
    check(r.returncode == 0, f"fresh_child {kind}: rc {r.returncode}: "
          f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def fresh_device_ms(args) -> dict:
    """trainer_kernels' device times ({name: {"ms", "events"} or None})
    on one of the trainer's kept streams, traced in a fresh process."""
    return fresh_child("stream", args)


def fresh_device_child(path) -> int:
    """fresh_child's child. "stream": one trace of 5 calls of each of
    trainer_kernels; "scans": scan_traces of each tensor given."""
    from msgs_torch.tools import trace_ms
    kind, *args = torch.load(path)
    args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
    if kind == "stream":
        out = {name: trace_ms(fn, 5).get(name + "_kernel")
               for name, fn in trainer_kernels(args)}
    else:
        out = [scan_traces(x) for x in args]
    print(json.dumps(out))
    return 0


def trainer_stream_times(args) -> dict:
    """Kernels 3, 4b (and, for comparison, 4) on one of the trainer's kept
    streams: CUDA-event ms, device ms from a fresh process's traces
    (fresh_device_ms), and each bound, counted as in [kernels]. Traces in
    this process, padded and not (trace_window), are printed beside them:
    late in the run they lose events (PERF.md §7)."""
    payload, first, n_sub, res, cot, tiles, tx, width, height, io = args
    n_work, pairs, t_bytes = bwd_work(args[:3] + args[5:7], width, height)
    nf = 3 if io else 5
    fwd_bytes = (n_work * 32 * 12 * 4 + tiles * 2 * 4
                 + tiles * 8 * 256 * 4) / PEAK_BYTES * 1e3
    bounds = {
        "composite_fwd": max(fwd_bytes,
                             pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3),
        "composite_bwd_bf16": max(
            t_bytes, pairs * OPS_PER_PAIR_BWD_BF16[nf] / PEAK_FP32 * 1e3,
            pairs * MMA_FLOPS_PER_PAIR / PEAK_BF16 * 1e3),
        "composite_bwd": max(t_bytes,
                             pairs * OPS_PER_PAIR_BWD[nf] / PEAK_FP32 * 1e3),
    }
    fresh = fresh_device_ms(args)
    out = {}
    for name, fn in trainer_kernels(args):
        win = trace_window(fn, name + "_kernel")
        rec = fresh.get(name) or {}
        out[name] = dict(ms=median_ms(fn, 20), device_ms=rec.get("ms"),
                         device_events=rec.get("events", 0),
                         bound_ms=bounds[name],
                         in_process_traces=win)
        print(f"[trainer] {name} at {width}x{height}: a fresh process's "
              f"trace of 5 calls kept {rec.get('events', 0)} events; in "
              f"this process, traces of 5 calls in turns without and with "
              f"{TRACE_PAD_S} s of idle time at both ends of the window: "
              f"{json.dumps(win)}", flush=True)
    print(f"[trainer] kernels on the trainer's {width}x{height} stream "
          f"({tiles} tiles, {int(n_sub.sum())} sub-blocks, {n_work} before "
          f"saturation, {pairs} pairs before each strip is done, "
          f"image_only={io}): " + "; ".join(
              f"{k} {v['ms']:.4f} ms (device {ms_text(v['device_ms'])}), "
              f"bound {v['bound_ms']:.4f}" for k, v in out.items()),
          flush=True)
    return out


def trainer_scan_times(shapes) -> dict:
    """Kernels 1 and 2 at each shape the trainer scanned, {(dtype, R, E):
    calls}: exact against the plain version, then timed as in [kernels],
    with the profiler's traces taken in one fresh process (fresh_child).
    Returns {kernel: [record per shape, most calls first]}."""
    from msgs_torch.kernels import scan
    g = torch.Generator().manual_seed(9)
    out = {"scan_f32": [], "scan_i32": []}
    order = sorted(shapes.items(), key=lambda kv: -kv[1])
    xs = [torch.randint(-6, 9, (R, E), generator=g).to(dtype).cuda()
          for (dtype, R, E), _ in order]
    traced = fresh_child("scans", xs)
    for ((dtype, R, E), calls), x, tr in zip(order, xs, traced):
        name = "scan_f32" if dtype == torch.float32 else "scan_i32"
        check(torch.equal(scan.cumsum_rows(x), scan.cumsum_rows_plain(x)),
              f"{name} differs from its plain version at the trainer's "
              f"{R}x{E}")
        rec = dict(scan_times(x, traced=tr), calls=calls)
        out[name].append(rec)
        print(f"[trainer] {scan_line(name, rec)} (traced in a fresh "
              f"process); {calls} calls in the run", flush=True)
    for name, recs in out.items():
        cost = sum(r["calls"] * (r["ms"] - r["bound_ms"]) for r in recs)
        dev_cost = sum(r["calls"] * (r["device_ms"] - r["bound_ms"])
                       for r in recs)
        print(f"[trainer] {name}: {sum(r['calls'] for r in recs)} calls over "
              f"{len(recs)} shapes; Σ calls × (ms − bound) {cost:.3f} ms "
              f"(device ms: {dev_cost:.3f})", flush=True)
    return out


def trainer_bf16_check(streams):
    """The bwd_bf16 kernel vs composite_bwd_bf16_reference on the streams
    kept in the trainer phase (the last one at each image size), per
    payload column under BF16_BUDGET."""
    from msgs_torch.kernels import composite as comp
    for (width, height), args in sorted(streams.items(), reverse=True):
        n_sub, image_only = args[2], args[9]
        got = comp._composite_bwd_bf16_cuda(*args).reshape(-1, comp.NFEAT)
        torch.cuda.synchronize()
        want = comp.composite_bwd_bf16_reference(*args).reshape(
            -1, comp.NFEAT)
        last = comp.F_B if image_only else comp.F_PSIZE
        worst, worst_c = 0.0, 0
        for c in range(last + 1):
            d = (got[:, c] - want[:, c]).abs().max().item()
            scale = max(float(want[:, c].abs().max()), 1e-8)
            check(math.isfinite(d) and d <= BF16_BUDGET * scale + 1e-6,
                  f"composite_bwd_bf16 trainer {width}x{height}: column {c} "
                  f"max|Δ| {d} > {BF16_BUDGET}·{scale} + 1e-6")
            if d / scale >= worst:
                worst, worst_c = d / scale, c
        check(bool((got[:, last + 1:] == 0).all()),
              f"composite_bwd_bf16 trainer {width}x{height}: uncomputed "
              f"columns not zero")
        print(f"[trainer] composite_bwd_bf16 on the trainer's {width}x"
              f"{height} stream ({args[5]} tiles, {int(n_sub.sum())} "
              f"sub-blocks, image_only={image_only}): vs plain worst column "
              f"{worst_c} at {worst:.3e} of its max (budget {BF16_BUDGET})",
              flush=True)


def bf16_grads_check(label, dev, scene, width, height, entry_cap):
    """rasterize's parameter gradients with the bwd_bf16 kernel against
    those with the exact kernel, on the card, under the JAX suite's bf16
    criterion (tests/test_rasterize.py:157, where it is applied to these
    same gradients): for image_only True (the loss reads the image) and
    False (it also reads depth, the pixel-size channel and T)."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.rasterize import RasterSettings, rasterize
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, width, height,
                      device=dev)
    n = scene[0].shape[0]
    names = ("means", "scales", "quats", "opac", "colors", "probe")

    def grads(image_only, bf16):
        leaves = [torch.as_tensor(a, device=dev).requires_grad_()
                  for a in scene] + [
            torch.zeros((n, 2), device=dev, requires_grad=True)]
        m, s, q, o, c, probe = leaves
        before = _build.launch_counts["composite_bwd_bf16"]
        out = rasterize(cam, m, o, colors_precomp=c, scales=s, quats=q,
                        means2d_probe=probe,
                        bg=torch.tensor([0.2, 0.3, 0.4], device=dev),
                        settings=RasterSettings(entry_cap=entry_cap,
                                                image_grads_only=image_only,
                                                bwd_bf16=bf16))
        loss = torch.sum(out.image * torch.cos(out.image))
        if not image_only:
            loss = loss + 0.1 * out.depth.mean() \
                + 0.1 * out.acc_pixel_size.mean() \
                + 0.01 * out.transmittance.mean()
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        check(int(out.overflow) == 0, f"bf16 grads {label}: overflow")
        check(_build.launch_counts["composite_bwd_bf16"] - before
              == int(bf16), f"bf16 grads {label}: wrong backward kernel")
        return g

    for image_only in (False, True):
        exact, fast = grads(image_only, False), grads(image_only, True)
        worst, worst_q99 = 0.0, 0.0
        for name, e, f in zip(names, exact, fast):
            check(bool(torch.isfinite(f).all()) and float(e.abs().max()) > 0,
                  f"bf16 grads {label}: {name} non-finite or zero")
            ok, w, q99 = bf16_close(f.flatten(), e.flatten())
            check(ok, f"bf16 grads {label} image_only={image_only}: {name} "
                  f"vs the exact kernel: |Δ|/max {w:.3e}, q99 {q99:.3f}")
            worst, worst_q99 = max(worst, w), max(worst_q99, q99)
        print(f"[kernels] composite_bwd_bf16 {label} image_only="
              f"{image_only}: parameter gradients vs the exact kernel worst "
              f"{worst:.3e} of max (criterion 2e-2), q99 rel "
              f"{worst_q99:.4f} (criterion 0.10)", flush=True)


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
        check(v > 0 or k.startswith("composite_bwd")
              or k in ("gather_rows", "mxu_probe", "fwd_ablate",
                       "bwd_ablate"),
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
    check(counts["composite_bwd"] == 0 and counts["composite_bwd_bf16"] == 0,
          "the serving path ran a backward")
    return counts, renders, times, st, cfg


ROWTIGHT_ENTRIES = 1_156_045  # row-tight bench scene, JAX on the CPU


def tile_pairs(b, n: int) -> torch.Tensor:
    """Sorted (tile, gauss_id) keys of a Binned's valid sub-blocks, on the
    CPU: equal for two streams iff every tile holds the same multiset."""
    sv = b.sub_valid.cpu().bool()
    tile = b.sub_tile.cpu().long()[sv].repeat_interleave(32)
    gid = b.gauss_id.cpu().long().view(-1, 32)[sv].reshape(-1)
    return torch.sort(tile * (n + 1) + gid).values


def tied_tiles(binned, dq, n: int) -> torch.Tensor:
    """Tiles in which two distinct Gaussians of any of the given streams
    share a depth quantum (their order is the sort's to choose)."""
    keys = torch.unique(torch.cat([tile_pairs(b, n) for b in binned]))
    tile, gid = keys // (n + 1), keys % (n + 1)
    real = gid < n
    tile, gid = tile[real], gid[real]
    td = tile * (1 << 24) + dq.cpu().long()[gid]
    u, c = torch.unique(td, return_counts=True)
    return torch.unique(u[c > 1] >> 24)


def phase_rowtight(dev, smi_line):
    """Row-tight binning (bin_gaussians(row_tight=True)) on the bench
    scene: the card against the plain path on the same preprocess output,
    the entry count against JAX's, renders against the banded path's, its
    launches and times, and kernel 1 on its delta planes."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import _build, binning, scan
    from msgs_torch.kernels.preprocess import PreprocessOut, preprocess
    from msgs_torch.kernels.rasterize import RasterSettings, rasterize
    means, scales, quats, opac, cols = bench_scene(0)
    t = lambda a: torch.as_tensor(a, device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)
    args = (t(means), t(opac))
    kw = dict(colors_precomp=t(cols), scales=t(scales), quats=t(quats))
    planes = []
    launch_scan = scan._cumsum_cuda

    def keep_planes(x):
        if x.dtype == torch.float32 and tuple(x.shape) == (5, ENTRY_CAP):
            planes.append(x)
        return launch_scan(x)

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    scan._cumsum_cuda = keep_planes
    try:
        with torch.no_grad():
            pre = preprocess(cam, *args, **kw)
            tight = binning.bin_gaussians(pre, W, H, ENTRY_CAP,
                                          row_tight=True)
            bands = binning.bin_gaussians(pre, W, H, ENTRY_CAP)
            settings = {m: RasterSettings(entry_cap=ENTRY_CAP, row_tight=m)
                        for m in (True, None)}
            outs = {m: rasterize(cam, *args, settings=s, **kw)
                    for m, s in settings.items()}
        torch.cuda.synchronize()
    finally:
        scan._cumsum_cuda = launch_scan
    counts = dict(_build.launch_counts)
    print(f"[rowtight] launches (preprocess, both binnings, both renders): "
          f"{counts}", flush=True)
    for k in ("scan_f32", "scan_i32", "composite_fwd"):
        check(counts[k] > 0, f"rowtight: kernel {k} never launched")
    check(counts["composite_bwd"] == 0 and counts["composite_bwd_bf16"] == 0,
          "rowtight: a backward ran")

    plain = binning.bin_gaussians(PreprocessOut(*(x.cpu() for x in pre)),
                                  W, H, ENTRY_CAP, row_tight=True)
    for f in ("sub_tile", "sub_valid", "tile_nonempty", "tile_last_sub",
              "num_entries", "overflow", "gid_starts"):
        check(torch.equal(getattr(tight, f).cpu(), getattr(plain, f)),
              f"rowtight: {f} differs between the card and the plain path")
    check(torch.equal(tile_pairs(tight, N), tile_pairs(plain, N)),
          "rowtight: gauss_id per tile differs between the card and the "
          "plain path")
    n_t, n_b = int(tight.num_entries), int(bands.num_entries)
    rel = abs(n_t - ROWTIGHT_ENTRIES) / ROWTIGHT_ENTRIES
    print(f"[rowtight] bench scene num_entries {n_t} (JAX on the CPU "
          f"{ROWTIGHT_ENTRIES}, rel {rel:.2e}; bands {n_b}, "
          f"{1 - n_t / n_b:.2%} fewer), overflow {int(tight.overflow)}; "
          f"every integer field equals the plain path's, gauss_id per tile "
          f"as a multiset", flush=True)
    check(rel <= 1e-3, "rowtight: num_entries off JAX's by > 0.1%")
    check(n_t < n_b, "rowtight: not fewer entries than bands")
    check(int(tight.overflow) == 0, "rowtight: overflow")

    # Renders: equal except at tiles whose entries tie on a depth key.
    dq = binning._depth_quanta(pre, min(binning._depth_bits(
        ((W + 15) // 16) * ((H + 15) // 16)), 23))
    tied = tied_tiles((tight, bands), dq, N)
    tx = (W + 15) // 16
    ys = torch.arange(H, device=dev)[:, None] // 16
    xs = torch.arange(W, device=dev)[None, :] // 16
    excused = torch.isin(ys * tx + xs, tied.to(dev))
    errs = {}
    for f, tol in (("image", 1e-5), ("depth", 1e-4)):
        d = (getattr(outs[True], f) - getattr(outs[None], f)).abs()
        if d.dim() == 3:
            d = d.amax(-1)
        errs[f] = torch.where(excused, 0.0, d).max().item()
        check(errs[f] <= tol, f"rowtight: {f} max|Δ| {errs[f]} > {tol} "
              f"against the bands render")
    print(f"[rowtight] render vs bands: image max|Δ| {errs['image']:.3e}, "
          f"depth {errs['depth']:.3e} outside the {int(tied.numel())} of "
          f"{tx * ((H + 15) // 16)} tiles whose entries tie on a depth key "
          f"(excused)", flush=True)

    # bin_gaussians times, in turns (row-tight, bands, bands, row-tight).
    with torch.no_grad():
        fn = {m: (lambda m=m: binning.bin_gaussians(pre, W, H, ENTRY_CAP,
                                                    row_tight=m))
              for m in (True, None)}
        times = {True: [], None: []}
        for m in (True, None, None, True):
            times[m].append(host_ms(fn[m], 10))
    print(f"[rowtight] bin_gaussians at {W}x{H}: row-tight "
          f"{statistics.median(times[True]):.3f} ms, bands "
          f"{statistics.median(times[None]):.3f} ms (median host ms, CUDA-"
          f"synchronised, 10 calls, in turns: row-tight {times[True]}, "
          f"bands {times[None]}); {smi_line}", flush=True)

    # Kernel 1 on row-tight's own delta planes (5 x 1,417,216 f32).
    check(len(planes) >= 1, "rowtight: no 5-plane delta scan captured")
    x = planes[0]
    got = scan.cumsum_rows(x)
    torch.cuda.synchronize()
    err = (got.double() - scan.cumsum_rows_plain(x).double()).abs().max()
    check(err.item() == 0, "rowtight: kernel 1 differs from its plain "
          "version on the delta planes")
    rec = scan_times(x)
    print(f"[rowtight] {scan_line('scan_f32 (row-tight delta planes)', rec)}"
          f", max|Δ| 0 (exact); {smi_line}", flush=True)
    return counts, dict(rec, max_abs_err=err.item(), num_entries=n_t,
                        bands_entries=n_b, tied_tiles=int(tied.numel()),
                        bin_ms=statistics.median(times[True]),
                        bands_bin_ms=statistics.median(times[None]))


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
    for k in ("scan_f32", "scan_i32", "composite_fwd", "composite_bwd"):
        check(counts[k] > 0, f"kernel {k} never launched on the training "
              f"path")
    check(counts["composite_bwd_bf16"] == 0,
          "train_step without bwd_bf16 ran the bf16 backward")
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


EVAL_SCALES = ("1", "2", "4", "8")
PNG_PSNR_DB = 0.1             # metrics' x1 test PSNR vs the trainer's


def lpips_synthetic_weights(seed: int) -> dict:
    """Seeded weights in the real VGG16 layout, drawn as
    tests/test_lpips.py:_synthetic_weights draws them (no pretrained
    weights exist offline)."""
    from msgs_torch.eval.lpips import _VGG_BLOCKS
    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for ch, n in _VGG_BLOCKS:
        for _ in range(n):
            out[f"conv_{i}_w"] = rng.normal(
                0, 0.08, (3, 3, cin, ch)).astype(np.float32)
            out[f"conv_{i}_b"] = rng.normal(0, 0.01, (ch,)).astype(
                np.float32)
            cin = ch
            i += 1
    for j, (ch, _) in enumerate(_VGG_BLOCKS):
        out[f"lin_{j}_w"] = np.abs(rng.normal(
            0, 1.0 / ch, (1, 1, ch, 1))).astype(np.float32)
    return out


def phase_eval(dev, model, test_s1_psnr, smi_line):
    """The offline evaluation apps on the trainer's model, through their
    main(argv) on the card (see the module docstring, item 14)."""
    from msgs_torch.apps import eval_scales, metrics, render
    from msgs_torch.data.image import read_png
    from msgs_torch.eval.lpips import LPIPS
    from msgs_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    render.main(["-m", model, "--anti_alias"])
    metrics.main(["-m", model])
    common = ["-m", model, "--anti_alias", "--scales", *EVAL_SCALES]
    reports = {"ply": eval_scales.main(common),
               "chkpnt600": eval_scales.main(common + [
                   "--checkpoint", os.path.join(model, "chkpnt600.npz")])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    print(f"[eval] launches over render, metrics and both eval_scales runs "
          f"({wall:.1f} s): {counts}", flush=True)
    for k in ("scan_f32", "scan_i32", "composite_fwd"):
        check(counts[k] > 0, f"eval: kernel {k} never launched")
    check(counts["composite_bwd"] == 0 and counts["composite_bwd_bf16"] == 0,
          "eval: a backward ran")

    it = f"ours_{TRAIN_ITERS}"
    results = json.load(open(os.path.join(model, "results.json")))
    per_view = json.load(open(os.path.join(model, "per_view.json")))
    nums = [v for e in results.values() for v in e.values()]
    nums += [v for e in per_view.values() for d in e.values()
             for v in d.values()]
    nums += [v for r in reports.values() for e in r.values()
             for v in e.values()]
    check(all(math.isfinite(v) for v in nums), "eval: a non-finite number")
    p_png = results[it]["PSNR"]
    print(f"[eval] metrics: test x1 PSNR {p_png:.4f} from the 8-bit PNGs, "
          f"the trainer's final test_s1 {test_s1_psnr:.4f} (Δ "
          f"{p_png - test_s1_psnr:+.4f} dB); SSIM "
          f"{results[it]['SSIM']:.4f}", flush=True)
    check(abs(p_png - test_s1_psnr) <= PNG_PSNR_DB,
          f"eval: metrics' x1 PSNR {p_png} vs the trainer's {test_s1_psnr}")
    for name, rep in reports.items():
        print(f"[eval] eval_scales ({name}): " + "; ".join(
            f"{k} psnr {e['psnr']:.3f} ssim {e['ssim']:.4f} render "
            f"{e['render_ms']:.3f} ms" for k, e in rep.items())
              + f" (median host ms per render, synchronised); {smi_line}",
              flush=True)

    # LPIPS with seeded synthetic weights: the card against the CPU.
    w = lpips_synthetic_weights(7)
    sub = os.path.join(model, "test", it)
    img = read_png(os.path.join(sub, "renders", "00000.png"))[..., :3]
    gt = read_png(os.path.join(sub, "gt", "00000.png"))[..., :3]
    img, gt = (torch.as_tensor((a / 255.0).astype(np.float32))
               for a in (img, gt))
    lp = LPIPS(w, dev)
    img_d, gt_d = img.to(dev), gt.to(dev)
    got = float(lp(img_d, gt_d))
    want = float(LPIPS(w, "cpu")(img, gt))
    rel = abs(got - want) / abs(want)
    ms = median_ms(lambda: lp(img_d, gt_d), 10)
    print(f"[eval] LPIPS (synthetic weights, seed 7) at "
          f"{tuple(img.shape[:2])}: card {got:.6f}, CPU {want:.6f} (rel "
          f"{rel:.2e}); {ms:.3f} ms per call (CUDA events); {smi_line}",
          flush=True)
    check(math.isfinite(got) and rel <= 2e-4,
          f"eval: LPIPS on the card {got} vs the CPU {want}")
    return counts, dict(wall_s=wall, test_s1_png_psnr=p_png,
                        lpips_ms=ms, lpips_rel=rel,
                        render_ms={n: {k: e["render_ms"]
                                       for k, e in r.items()}
                                   for n, r in reports.items()})


# [apps]: the circle trajectory's frames and scale sweep, GUI requests.
TRAJ_FRAMES = 48
TRAJ_SCALES = (1.0, 64.0)
GUI_REQUESTS = 10
VIEWER_KEYS = "wi-;[p"


def gui_client(port, msgs, result):
    """A SIBR client: one connection, each request in turn, timing each
    round trip (send to the last byte of the source path)."""
    import socket
    import struct
    frames, ms = [], []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
        for msg in msgs:
            payload = json.dumps(msg).encode("utf-8")
            t0 = time.perf_counter()
            c.sendall(struct.pack("I", len(payload)) + payload)
            want = msg["resolution_x"] * msg["resolution_y"] * 3 + 4
            buf = b""
            while len(buf) < want:
                buf += c.recv(want - len(buf))
            n = struct.unpack("I", buf[-4:])[0]
            path = b""
            while len(path) < n:
                path += c.recv(n - len(path))
            ms.append((time.perf_counter() - t0) * 1e3)
            frames.append(buf[:-4])
    result.update(frames=frames, ms=ms, path=path.decode("ascii"))


def phase_apps(dev, model, smi_line):
    """The interactive apps on the trainer's model, on the card (see the
    module docstring, item 16)."""
    import importlib.util
    import threading
    import types

    from msgs_torch.apps import network_gui, traj, video_tools, viewer
    from msgs_torch.apps.render import load_viewing_model, to_uint8, \
        truncation_mismatches
    from msgs_torch.data.image import read_png
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.train import loop as L
    out = os.path.join(model, "apps")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()

    # Viewer, headless: the card at x1 and x4, the CPU at x1.
    renders = []
    eval_render = L.eval_render

    def recorded(*a, **k):
        renders.append(eval_render(*a, **k))
        return renders[-1]
    L.eval_render = recorded
    try:
        for d, s in (("cuda", "1"), ("cuda", "4"), ("cpu", "1")):
            viewer.main(["-m", model, "--anti_alias", "--reso_scale", s,
                         "--out_dir", os.path.join(out, f"viewer_{d}_x{s}")]
                        + (["--device", "cpu"] if d == "cpu" else []))
    finally:
        L.eval_render = eval_render
    png = {k: read_png(os.path.join(out, f"viewer_{k}", "view.png"))
           for k in ("cuda_x1", "cuda_x4", "cpu_x1")}
    check(renders[0].image.is_cuda and not renders[2].image.is_cuda,
          "apps: the viewer rendered on the wrong device")
    H0, W0 = png["cuda_x1"].shape[:2]
    check(png["cuda_x1"].max() > 0 and png["cuda_x4"].shape[:2] == (
        max(H0 // 4 // 16 * 16, 16), max(W0 // 4 // 16 * 16, 16)),
        "apps: the viewer's x1 image is black or its x4 size is wrong")
    bad = truncation_mismatches(png["cpu_x1"], png["cuda_x1"],
                                renders[2].image.numpy())
    diff = np.abs(png["cpu_x1"].astype(int) - png["cuda_x1"].astype(int))
    print(f"[apps] viewer view.png {png['cuda_x1'].shape} x1: card vs CPU "
          f"{int((diff > 0).sum())} pixels differ by 1, {bad} beyond the "
          f"truncation boundary; x4 {png['cuda_x4'].shape}", flush=True)
    check(bad == 0, f"apps: the card's view.png differs from the CPU's at "
          f"{bad} pixels")

    # Viewer, --display: the key loop through a scripted cv2.
    keys = iter([ord(c) for c in VIEWER_KEYS] + [viewer.ESC])
    shown = []
    cv2 = types.ModuleType("cv2")
    cv2.imshow = lambda name, a: shown.append((name, np.array(a)))
    cv2.waitKey = lambda delay: next(keys)
    cv2.destroyAllWindows = lambda: None
    real_cv2 = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2
    try:
        viewer.main(["-m", model, "--display", "--anti_alias", "--out_dir",
                     os.path.join(out, "viewer_keys")])
    finally:
        if real_cv2 is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = real_cv2
    n_steps = len(VIEWER_KEYS) + 1
    check(len(shown) == 3 * n_steps, f"apps: {len(shown)} imshow calls")
    at_p = shown[3 * VIEWER_KEYS.index("p")][1][..., ::-1]
    frame = read_png(os.path.join(out, "viewer_keys", "frame.png"))
    check(np.array_equal(frame, (at_p * 255).astype(np.uint8)),
          "apps: frame.png is not the frame shown when p was pressed")
    print(f"[apps] viewer key loop '{VIEWER_KEYS}' then ESC: {n_steps} "
          f"renders, sizes " + ", ".join(
              f"{a.shape[1]}x{a.shape[0]}" for n, a in shown
              if n == "render") + "; frame.png saved", flush=True)

    # traj: the circle's frames over the scale sweep, each synchronised.
    st, cfg, scene = load_viewing_model(model, None, -1, dev)
    v0 = scene.train_views[0]
    poses = traj.circle_trajectory(scene.train_views, TRAJ_FRAMES)
    settings = RasterSettings(filter_small=True, filter_large=True,
                              entry_cap=1 << 20)
    traj.trajectory_frames(st, cfg, v0, poses[:4], settings,
                           *TRAJ_SCALES)                     # warm-up
    frames, secs = traj.trajectory_frames(st, cfg, v0, poses, settings,
                                          *TRAJ_SCALES)
    check(len(frames) == TRAJ_FRAMES and all(
        f.shape == (v0.height, v0.width, 3) for f in frames)
        and frames[0].max() > 0, "apps: trajectory frames")
    by_scale = collections.defaultdict(list)
    for i, sec in enumerate(secs):
        sc = traj.sweep_scale(i, TRAJ_FRAMES, *TRAJ_SCALES)
        w = max(int(v0.width / sc) // 16 * 16, 16)
        h = max(int(v0.height / sc) // 16 * 16, 16)
        by_scale[(round(sc, 3), w, h)].append(sec * 1e3)
    traj_ms = {f"x{k[0]} {k[1]}x{k[2]}": statistics.median(v)
               for k, v in sorted(by_scale.items())}
    print(f"[apps] traj {TRAJ_FRAMES} circle frames x{TRAJ_SCALES[0]:g} to "
          f"x{TRAJ_SCALES[1]:g}, median host ms per frame (synchronised) "
          f"at each scale: " + "; ".join(
              f"{k} {v:.3f}" for k, v in traj_ms.items())
          + f"; all frames {statistics.median(secs) * 1e3:.3f}; {smi_line}",
          flush=True)
    try:
        video_tools.check_video_writer(os.path.join(out, "x.mp4"))
        no_encoder = None
    except RuntimeError as e:
        no_encoder = str(e)
    if no_encoder is None:
        tdir = os.path.join(out, "traj")
        traj.main(["-m", model, "--anti_alias", "--n_frames",
                   str(TRAJ_FRAMES), "--out_dir", tdir])
        times = open(os.path.join(tdir, "frame_times.txt")).read().split()
        check(len(times) == TRAJ_FRAMES and os.path.getsize(
            os.path.join(tdir, "trajectory.mp4")) > 0, "apps: traj.main")
        print("[apps] traj.main wrote trajectory.mp4 and frame_times.txt",
              flush=True)
    else:
        print(f"[apps] traj.main not run end to end: no mp4 encoder imports "
              f"on this machine ({no_encoder})", flush=True)

    # The network GUI: one client, GUI_REQUESTS requests on a loopback
    # port, each answered through serve_step.
    bg = torch.zeros(3, device=dev)
    cams = []

    def gui_render(cam, scale_mod):
        cams.append(cam)
        return L.eval_render(st, cam, cfg=cfg, settings=settings,
                             bg=bg).image
    cam0 = v0.camera(1.0)
    wv = cam0.world_view.cpu().numpy().copy()
    fp = cam0.full_proj.cpu().numpy().copy()
    wv[:, 1:3] *= -1
    fp[:, 1] *= -1
    msg = {"resolution_x": v0.width, "resolution_y": v0.height,
           "train": True, "fov_y": v0.fovy, "fov_x": v0.fovx,
           "z_near": 0.01, "z_far": 100.0, "shs_python": False,
           "rot_scale_python": False, "keep_alive": False,
           "scaling_modifier": 1.0,
           "view_matrix": wv.reshape(-1).tolist(),
           "view_projection_matrix": fp.reshape(-1).tolist()}
    network_gui.init("127.0.0.1", 0)
    result = {}
    client = threading.Thread(target=gui_client, args=(
        network_gui._listener.getsockname()[1], [msg] * GUI_REQUESTS,
        result))
    client.start()
    served = 0
    try:
        deadline = time.time() + 60
        while served < GUI_REQUESTS and time.time() < deadline:
            if network_gui.serve_step(gui_render, scene.source_path, True,
                                      device=dev):
                served += 1
            elif network_gui.conn is None:
                time.sleep(0.01)
        client.join(timeout=60)
    finally:
        network_gui.disconnect()
        network_gui._listener.close()
        network_gui._listener = None
    check(served == GUI_REQUESTS and not client.is_alive()
          and len(result.get("frames", ())) == GUI_REQUESTS,
          f"apps: the GUI served {served} of {GUI_REQUESTS} requests")
    check(cams[0].world_view.is_cuda, "apps: the GUI camera is not on the card")
    want = to_uint8(L.eval_render(st, cams[0], cfg=cfg, settings=settings,
                                  bg=bg).image.cpu().numpy()).tobytes()
    check(all(f == want for f in result["frames"]) and max(want) > 0,
          "apps: the GUI's bytes are not eval_render's image")
    check(result["path"] == scene.source_path, "apps: GUI source path")
    gui_ms = statistics.median(result["ms"])
    print(f"[apps] network GUI: {GUI_REQUESTS} requests at "
          f"{v0.width}x{v0.height}, every frame equal to eval_render's; "
          f"{gui_ms:.3f} ms per request (median client round trip, "
          f"{min(result['ms']):.3f} min); {smi_line}", flush=True)

    # video_tools with PNGs: the port's codec, no PIL, imageio or cv2.
    before = {m for m in ("PIL", "imageio", "cv2") if m in sys.modules}
    grid = os.path.join(out, "grid.png")
    tiles = [os.path.join(out, "viewer_cuda_x1", "view.png"),
             os.path.join(out, "viewer_cpu_x1", "view.png"),
             os.path.join(out, "viewer_keys", "frame.png")]
    video_tools.main(["concat", "-i", *tiles, "-o", grid, "--cols", "2"])
    cams_png = os.path.join(out, "cameras.png")
    video_tools.main(["visualize_cameras", "-s", scene.source_path, "-o",
                      cams_png])
    after = {m for m in ("PIL", "imageio", "cv2") if m in sys.modules}
    g, c = read_png(grid), read_png(cams_png)
    check(g.shape == (2 * frame.shape[0], 2 * frame.shape[1], 3)
          and c.shape == (800, 800, 3), "apps: video_tools outputs")
    check(after == before, f"apps: video_tools imported {after - before}")
    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("PIL", "imageio", "cv2")}
    print(f"[apps] video_tools concat {g.shape} and visualize_cameras "
          f"{c.shape} through the port's PNG codec; installed here: "
          f"{installed}", flush=True)

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    print(f"[apps] launches over the phase ({wall:.1f} s wall): {counts}",
          flush=True)
    for k in ("scan_f32", "scan_i32", "composite_fwd"):
        check(counts[k] > 0, f"apps: kernel {k} never launched")
    check(counts["composite_bwd"] == 0 and counts["composite_bwd_bf16"] == 0,
          "apps: a backward ran")
    return counts, dict(wall_s=wall, traj_ms=traj_ms, gui_ms=gui_ms,
                        viewer_diff_1=int((diff > 0).sum()),
                        mp4=no_encoder is None)


def phase_trainer(dev, smi_line):
    """The MS-GS trainer CLI on the synthetic scene (see the module
    docstring, item 8)."""
    from msgs_torch.apps import train as train_app
    from msgs_torch.data.dataset import load_scene
    from msgs_torch.data.synthetic import make_scene
    from msgs_torch.eval.metrics import psnr
    from msgs_torch.kernels import _build
    from msgs_torch.kernels import composite as comp
    from msgs_torch.kernels import scan
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig
    from msgs_torch.tools import _device_busy_ms
    from msgs_torch.train.checkpoint import load_ply_snapshot
    from msgs_torch.train.loop import eval_render, train_step
    from msgs_torch.train.optimizer import OptimParams
    with tempfile.TemporaryDirectory() as tmp:
        scene, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        make_scene(scene, device=dev, quiet=True)
        t_scene = time.perf_counter() - t0
        prof = (400, 410)      # torch.profiler window, for the busy share
        common = [
            "-s", scene, "--eval", "--ms_train", "--ms_train_max_scale", "6",
            "--filter_small", "--insert_large", "--bwd_bf16", "--fast_grads",
            "--capacity", "131072", "--entry_cap", "1048576",
            "--sh_degree", "3", "--densify_from_iter", "200",
            "--densification_interval", "100",
            "--opacity_reset_interval", "600", "--test_interval", "0",
            "--disable_gui", "--no_tensorboard", "--quiet"]
        stamps = []

        def on_iteration(it, host_ops):
            torch.cuda.synchronize()
            stamps.append((it, host_ops, time.perf_counter()))

        # The bf16 backward's last inputs at each image size, kept (not
        # copied) as the run passes them, for trainer_bf16_check; the
        # shapes the run scans, counted.
        streams = {}
        launch_bf16 = comp._composite_bwd_bf16_cuda
        launch_scan = scan._cumsum_cuda
        scan_shapes = collections.Counter()

        def keep_stream(*args):
            streams[(args[7], args[8])] = args
            return launch_bf16(*args)

        def count_scan(x):
            scan_shapes[(x.dtype, x.numel() // x.shape[-1],
                         x.shape[-1])] += 1
            return launch_scan(x)

        comp._composite_bwd_bf16_cuda = keep_stream
        scan._cumsum_cuda = count_scan
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            state = train_app.main(common + [
                "-m", model, "--iterations", str(TRAIN_ITERS),
                "--test_iterations", "1", str(PSNR_ITER), str(TRAIN_ITERS),
                "--save_iterations", str(TRAIN_ITERS),
                "--checkpoint_iterations", "600",
                "--profile_steps", f"{prof[0]}:{prof[1]}"],
                on_iteration=on_iteration)
        finally:
            comp._composite_bwd_bf16_cuda = launch_bf16
            scan._cumsum_cuda = launch_scan
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        print(f"[trainer] launches over {TRAIN_ITERS} iterations: {counts}",
              flush=True)
        for k in ("composite_bwd_bf16", "composite_fwd", "scan_f32",
                  "scan_i32"):
            check(counts[k] > 0, f"trainer: kernel {k} never launched")
        check(counts["composite_bwd"] == 0,
              "trainer: the exact backward ran under --bwd_bf16")

        log = [json.loads(l) for l in open(os.path.join(
            model, "train_log.jsonl"))]
        events = [r for r in log if "event" in r]
        for r in events:
            extra = (f", {r['n_inserted']} inserted at lvl {r['lvl']} from "
                     f"{r['n_selected']} selected" if r["event"] == "insert"
                     else "")
            print(f"[trainer]   it {r['it']}: {r['event']} live "
                  f"{r.get('live_before', '-')} -> {r['live_after']}{extra}",
                  flush=True)
        dens = [r for r in events if r["event"] == "densify"]
        check(any(r["live_after"] != r["live_before"] for r in dens),
              "trainer: densify never changed the live count")
        check(any(r["event"] == "reset" for r in events),
              "trainer: no opacity reset")
        ins = {r["lvl"]: r for r in events if r["event"] == "insert"}
        check(sorted(ins) == [2, 4, 6], f"trainer: insert episodes at "
              f"levels {sorted(ins)}, want [2, 4, 6]")
        for lvl, r in ins.items():
            check(r["n_inserted"] > 0,
                  f"trainer: insert episode at lvl {lvl} inserted nothing")
        g = state.gaussians
        for k, v in g.params().items():
            check(bool(torch.isfinite(v).all()), f"trainer: non-finite {k}")
            check(bool(torch.isfinite(state.adam.mu[k]).all()
                       and torch.isfinite(state.adam.nu[k]).all()),
                  f"trainer: non-finite moments of {k}")
        print("[trainer] logged loss (it, lvl, loss): " + ", ".join(
            f"({r['it']}, {r['lvl']}, {r['loss']:.4f})" for r in log
            if "loss" in r), flush=True)
        losses = {r["it"]: r["loss"] for r in log if "loss" in r}
        ref = {r["it"]: r["loss"] for r in map(json.loads, open(REF_LOG))
               if "loss" in r}
        for it in (100, 200, 300):
            rel = abs(losses[it] - ref[it]) / ref[it]
            print(f"[trainer] loss at {it}: {losses[it]:.6f}, the JAX "
                  f"reference run's {ref[it]:.6f} (rel {rel:.2e})",
                  flush=True)
            check(rel <= LOSS_REL, f"trainer: loss at {it} off the JAX "
                  f"reference run's by {rel:.2e} > {LOSS_REL}")
        evals = {r["it"]: r["eval"] for r in log if "eval" in r}
        p0 = evals[1]["test_s1"]["psnr"]
        pm = evals[PSNR_ITER]["test_s1"]["psnr"]
        p1 = evals[TRAIN_ITERS]["test_s1"]["psnr"]
        print(f"[trainer] test x1 PSNR {p0:.3f} (it 1) -> {pm:.3f} "
              f"(it {PSNR_ITER}) -> {p1:.3f} (it {TRAIN_ITERS}); per scale "
              f"at {TRAIN_ITERS}: " + ", ".join(
                  f"{k} {v['psnr']:.2f}" for k, v in
                  evals[TRAIN_ITERS].items() if k.startswith("test")),
              flush=True)
        check(math.isfinite(p1), "trainer: final test x1 PSNR not finite")

        # The snapshot holds the model the iteration-1100 evaluation saw
        # (the densify step of that iteration runs after both): loaded back,
        # it has that live count and renders that evaluation's ×1 test PSNR.
        cap = int(g.xyz.shape[0])
        ply = os.path.join(model, f"point_cloud/iteration_{TRAIN_ITERS}/"
                                  "point_cloud.ply")
        pcfg = GaussianConfig(sh_degree=3, reso_lvls=7, capacity=cap)
        back = load_ply_snapshot(ply, pcfg, dev)._replace(
            active_sh_degree=g.active_sh_degree.clone())
        live_at_save = next((r["live_before"] for r in events
                             if r["it"] == TRAIN_ITERS
                             and "live_before" in r), int(g.num_live))
        sc = load_scene(scene, eval_split=True, device=dev)
        views = sc.test_views
        settings = RasterSettings(filter_small=True, filter_large=True,
                                  entry_cap=1 << 21, image_grads_only=True)
        psnrs = []
        for v in views:
            out = eval_render(back, v.camera(1.0), cfg=pcfg,
                              settings=settings, reso_lvl=0,
                              bg=torch.zeros(3, device=dev))
            check(int(out.overflow) == 0, "trainer: snapshot render overflow")
            psnrs.append(float(psnr(torch.clamp(out.image, 0, 1),
                                    torch.as_tensor(v.image(1.0),
                                                    device=dev))))
        p_back = float(np.mean(psnrs))
        print(f"[trainer] PLY snapshot: {int(back.num_live)} live (at the "
              f"save {live_at_save}); x1 test PSNR {p_back:.4f} (the "
              f"evaluation's {p1:.4f})", flush=True)
        check(int(back.num_live) == live_at_save
              and abs(p_back - p1) <= 1e-3,
              "trainer: PLY snapshot does not load back")

        # Per-iteration times: host clock, synchronised, without the
        # iterations that evaluated, saved or changed structure, nor the
        # profiled window.
        steps = [(b[2] - a[2]) * 1e3 for a, b in zip(stamps, stamps[1:])
                 if not b[1] and not prof[0] <= b[0] <= prof[1]]
        win = [s for s in stamps if prof[0] <= s[0] < prof[1]]
        trace = os.path.join(model, "profile", "trace.json")
        busy = _device_busy_ms(trace) if os.path.exists(trace) else None
        span = (win[-1][2] - win[0][2]) * 1e3 if len(win) > 1 else None
        share = (f"{busy:.3f} of {span:.3f} ms "
                 f"({100 * busy / span:.1f}%) over iterations "
                 f"{win[0][0] + 1}..{win[-1][0]} (profiled)"
                 if busy and span else "not measured")

        # Resume from the iteration-600 checkpoint.
        resumed = train_app.main(common + [
            "-m", os.path.join(tmp, "resumed"),
            "--start_checkpoint", os.path.join(model, "chkpnt600.npz"),
            "--iterations", "620", "--test_iterations", "-1",
            "--save_iterations", "-1"])
        check(int(resumed.iteration) == 620,
              f"trainer: resume ended at {int(resumed.iteration)}")
        eval_counts, eval_rec = phase_eval(dev, model, p1, smi_line)
        apps_counts, apps_rec = phase_apps(dev, model, smi_line)
        io_counts, io_rec = phase_io(dev, state, pcfg, sc, model, smi_line)
        dist_counts, dist_rec = phase_dist(dev, scene, common, log, smi_line)

        # One train_step of the final state at each coarse level, as the
        # trainer takes it, for the bf16 backward's inputs there.
        tsettings = RasterSettings(filter_small=True, filter_large=True,
                                   entry_cap=1 << 20, image_grads_only=True,
                                   grad_pack_bf16=True, bwd_bf16=True)
        view = sc.train_views[0]
        comp._composite_bwd_bf16_cuda = keep_stream
        try:
            for lvl in COARSE_LVLS:
                _, m = train_step(
                    state, view.camera(2 ** lvl),
                    torch.as_tensor(view.image(2 ** lvl), device=dev),
                    cfg=pcfg, op=OptimParams(), settings=tsettings,
                    reso_lvl=lvl, spatial_lr_scale=1.0)
                check(int(m["overflow"]) == 0, f"trainer: level {lvl} step "
                      f"overflowed")
        finally:
            comp._composite_bwd_bf16_cuda = launch_bf16
    trainer_bf16_check(streams)
    times = dict(trainer_scan_times(scan_shapes),
                 **trainer_stream_times(streams[(512, 512)]))
    del streams
    check(math.isfinite(pm) and pm - p0 >= PSNR_GAIN_DB,
          f"trainer: test x1 PSNR rose {pm - p0:.3f} dB by iteration "
          f"{PSNR_ITER} < {PSNR_GAIN_DB}")
    print(f"[trainer] {TRAIN_ITERS} iterations in {wall:.1f} s wall "
          f"(scene generation {t_scene:.1f} s); median iteration "
          f"{statistics.median(steps):.3f} ms over {len(steps)} plain "
          f"iterations (host clock, synchronised); device busy {share}; "
          f"live {int(g.num_live)} of capacity {cap}; resume from "
          f"chkpnt600 to 620 ran; {smi_line}", flush=True)
    return counts, dict(times, wall_s=wall, busy=share,
                        median_iteration_ms=statistics.median(steps)), \
        eval_counts, eval_rec, apps_counts, apps_rec, dist_counts, \
        dist_rec, io_counts, io_rec


# --- [io]: the native COLMAP/PLY readers and the back-projection insert --

def colmap_model(d, seed: int, n_points: int, n_images: int, n_kp: int):
    """A COLMAP binary model in `d` made from `seed` with numpy: one PINHOLE
    camera; `n_points` points with track lengths 3-6; `n_images` images of
    `n_kp` keypoints, half of them tied to a point. Returns the points'
    (xyz, rgb, err) as written."""
    import struct
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ4d", 1, 1, 1600, 1200, 1400.0, 1400.0,
                            800.0, 600.0))
    head = np.zeros(n_points, np.dtype([
        ("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
        ("err", "<f8"), ("track_len", "<u8")]))     # packed: 51 bytes
    head["id"] = np.arange(1, n_points + 1)
    head["xyz"] = rng.normal(0, 2, (n_points, 3))
    head["rgb"] = rng.integers(0, 256, (n_points, 3), dtype=np.uint8)
    head["err"] = rng.uniform(0, 2, n_points)
    head["track_len"] = tl = rng.integers(3, 7, n_points)
    track = np.stack([rng.integers(1, n_images + 1, (n_points, 6)),
                      rng.integers(0, n_kp, (n_points, 6))],
                     -1).astype("<i4")
    # Each record padded to the longest track, then the padding dropped.
    rec = np.concatenate([head.view(np.uint8).reshape(n_points, -1),
                          track.view(np.uint8).reshape(n_points, -1)], 1)
    keep = (np.arange(rec.shape[1])[None, :]
            < (head.dtype.itemsize + 8 * tl)[:, None])
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        f.write(rec[keep].tobytes())
    kp = np.zeros(n_kp, np.dtype([("xy", "<f8", (2,)), ("point", "<i8")]))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            q = rng.normal(size=4)
            f.write(struct.pack("<i4d3di", i + 1, *(q / np.linalg.norm(q)),
                                *rng.normal(0, 3, 3), 1))
            f.write(f"img_{i:05d}.jpg".encode() + b"\0")
            kp["xy"] = rng.uniform(0, 1600, (n_kp, 2))
            kp["point"] = np.where(rng.uniform(size=n_kp) < 0.5, -1,
                                   rng.integers(1, n_points + 1, n_kp))
            f.write(struct.pack("<Q", n_kp))
            f.write(kp.tobytes())
    return head["xyz"], head["rgb"], head["err"]


def to_cpu(nt):
    """A NamedTuple of tensors (a state, a camera) with every tensor on
    the CPU."""
    return nt._replace(**{k: v.cpu() for k, v in nt._asdict().items()
                          if torch.is_tensor(v)})


def near_threshold_blocks(acc, block: int, threshold: float,
                          ulps: int = 4) -> int:
    """Blocks whose mean coverage (float64) lies within `ulps` float32 ulp
    of the threshold: the two devices may put them on either side."""
    H, W = acc.shape
    Hb, Wb = H // block, W // block
    m = acc[:Hb * block, :Wb * block].astype(np.float64).reshape(
        Hb, block, Wb, block).mean(axis=(1, 3))
    ulp = float(np.spacing(np.float32(threshold)))
    return int((np.abs(m - threshold) <= ulps * ulp).sum())


def phase_io(dev, state, cfg, scene, model, smi_line):
    """The native readers and the back-projection insert (see the module
    docstring, item 17)."""
    from msgs_torch.data import colmap, native_io, ply
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianState
    from msgs_torch.ms.backproject import add_large_gaussians_backproject
    from msgs_torch.train import loop as L
    t_phase = time.perf_counter()

    # 1. The library builds here, or the run fails with g++'s message.
    t0 = time.perf_counter()
    lib = native_io.get_lib()
    check(lib is not None, f"io: the native library did not build: "
          f"{native_io.build_error}")
    print(f"[io] native library {native_io.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native_io.CXX_FLAGS)})", flush=True)

    # 2. A large COLMAP model, read both ways and through load_sparse.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        xyz, rgb, err = colmap_model(d, IO_SEED, IO_POINTS, IO_IMAGES,
                                     IO_KEYPOINTS)
        t_write = time.perf_counter() - t0
        pts_path = os.path.join(d, "points3D.bin")
        img_path = os.path.join(d, "images.bin")
        mb = (os.path.getsize(pts_path) + os.path.getsize(img_path)) / 1e6
        t0 = time.perf_counter()
        npts = native_io.read_points3d_bin(pts_path)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        nimg = native_io.read_images_bin(img_path)
        t_ni = time.perf_counter() - t0
        t0 = time.perf_counter()
        spts = colmap.read_points3d_binary(pts_path)
        t_sp = time.perf_counter() - t0
        t0 = time.perf_counter()
        simg = colmap.read_images_binary(img_path)
        t_si = time.perf_counter() - t0
        check(npts is not None and nimg is not None,
              "io: a native reader refused the model")
        # tests/test_native_io.py's tolerances, and the exact forms.
        check(np.allclose(npts[0], spts[0], rtol=0, atol=1e-6)
              and np.array_equal(npts[1], spts[1])
            and np.allclose(npts[2], spts[2], rtol=0, atol=1e-6),
            "io: native points differ from the struct reader's")
        check(np.array_equal(npts[0], xyz.astype(np.float32).astype(
            np.float64)) and np.array_equal(spts[0], xyz)
            and np.array_equal(npts[1], rgb)
            and np.array_equal(npts[2], err.astype(np.float32).astype(
                np.float64)), "io: points differ from what was written")
        sid = sorted(simg)
        check(list(nimg["image_id"]) == sid
              and np.allclose(nimg["qvec"], [simg[i].qvec for i in sid])
              and np.allclose(nimg["tvec"], [simg[i].tvec for i in sid])
              and nimg["names"] == [simg[i].name for i in sid]
              and nimg["names"][0] == "img_00000.jpg",
              "io: native images differ from the struct reader's")
        struct_calls = []
        readers = (colmap.read_points3d_binary, colmap.read_images_binary)

        def counted(fn):
            def wrapped(*a, **k):
                struct_calls.append(fn.__name__)
                return fn(*a, **k)
            return wrapped
        colmap.read_points3d_binary, colmap.read_images_binary = map(
            counted, readers)
        try:
            t0 = time.perf_counter()
            cams, imgs, lxyz, lrgb = colmap.load_sparse(d)
            t_load = time.perf_counter() - t0
        finally:
            colmap.read_points3d_binary, colmap.read_images_binary = readers
        check(not struct_calls and np.array_equal(lxyz, npts[0])
              and np.array_equal(lrgb, rgb) and len(imgs) == IO_IMAGES
              and cams[1].model == "PINHOLE",
              f"io: load_sparse did not take the native path "
              f"(struct readers called: {struct_calls})")
    print(f"[io] COLMAP model (seed {IO_SEED}): {IO_POINTS:,} points, "
          f"tracks 3-6, {IO_IMAGES} images x {IO_KEYPOINTS} keypoints, "
          f"{mb:.1f} MB written in {t_write:.2f} s; native read points "
          f"{t_np * 1e3:.1f} ms, images {t_ni * 1e3:.1f} ms; struct read "
          f"points {t_sp * 1e3:.1f} ms, images {t_si * 1e3:.1f} ms; "
          f"load_sparse (native) {t_load * 1e3:.1f} ms; equal within "
          f"tests/test_native_io.py's tolerances", flush=True)

    # 3. read_ply_f32 on the trainer's PLY against ply.read_ply.
    path = os.path.join(model, f"point_cloud/iteration_{TRAIN_ITERS}/"
                               "point_cloud.ply")
    t0 = time.perf_counter()
    fast = native_io.read_ply_f32(path)
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = ply.read_ply(path)
    t_plain = time.perf_counter() - t0
    check(fast is not None and list(fast) == list(plain) and all(
        np.array_equal(fast[k], plain[k].astype(np.float32)) for k in plain),
        "io: read_ply_f32 differs from ply.read_ply")
    print(f"[io] read_ply_f32 on the trainer's PLY ({len(plain['x']):,} "
          f"rows, {len(plain)} properties): {t_fast * 1e3:.1f} ms, "
          f"ply.read_ply {t_plain * 1e3:.1f} ms, equal", flush=True)

    # 4. The back-projection insert on a x1 render of a train view: the
    # card against the CPU on the same inputs, then a render after it.
    settings = RasterSettings(filter_small=True, filter_large=True,
                              entry_cap=1 << 21, image_grads_only=True)
    cam = scene.train_views[0].camera(1.0)
    bg = torch.zeros(3, device=dev)
    st = state.gaussians
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = L.eval_render(st, cam, cfg=cfg, settings=settings, reso_lvl=0,
                        bg=bg)
    check(int(out.overflow) == 0, "io: render overflow")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, touched, n_ins = add_large_gaussians_backproject(
        st, cam, out.acc_pixel_size, out.depth, out.image, IO_LVL)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    after = L.eval_render(new, cam, cfg=cfg, settings=settings, reso_lvl=0,
                          bg=bg)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    t0 = time.perf_counter()
    cnew, ctouched, cn_ins = add_large_gaussians_backproject(
        to_cpu(st), to_cpu(cam), out.acc_pixel_size.cpu(), out.depth.cpu(),
        out.image.cpu(), IO_LVL)
    t_cpu = time.perf_counter() - t0
    acc = out.acc_pixel_size.cpu().numpy()
    ties = near_threshold_blocks(acc, 4, 1.0)
    same = torch.equal(touched.cpu(), ctouched)
    worst = {}
    if same:
        check(int(n_ins) == int(cn_ins), "io: n_inserted card != CPU")
        for k in GaussianState._fields:
            a, b = getattr(new, k).cpu(), getattr(cnew, k)
            if k in ("live", "target_reso_lvl", "base_mask",
                     "max_pixel_sizes", "min_pixel_sizes") \
                    or not b.is_floating_point():
                check(torch.equal(a, b), f"io: backproject {k} card != CPU")
                continue
            tol = 1e-6 * float(b.abs().max()) + 1e-7
            worst[k] = float((a - b).abs().max())
            check(worst[k] <= tol, f"io: backproject {k} card vs CPU "
                  f"{worst[k]:.3e} > {tol:.3e}")
    else:       # only blocks at the threshold may flip
        check(ties > 0 and abs(int(n_ins) - int(cn_ins)) <= ties,
              f"io: backproject touched rows differ card vs CPU with "
              f"{ties} blocks at the threshold")
    check(bool(torch.isfinite(after.image).all())
          and int(after.overflow) == 0,
          "io: the render after the insert is not finite or overflowed")
    for k in ("scan_f32", "scan_i32", "composite_fwd"):
        check(counts[k] > 0, f"io: kernel {k} never launched")
    wall = time.perf_counter() - t_phase
    print(f"[io] backproject on a x1 train view ({cam.width}x{cam.height}, "
          f"blocks of 4, "
          f"threshold 1.0, lvl {IO_LVL}): n_inserted {int(n_ins)} on the "
          f"card, {int(cn_ins)} on the CPU; live {int(st.num_live)} -> "
          f"{int(new.num_live)} of {st.live.shape[0]}; card "
          f"{t_card * 1e3:.1f} ms, CPU {t_cpu * 1e3:.1f} ms (host clock); "
          f"{'equal' if same else 'touched differs'} ({ties} blocks within "
          f"4 ulp of the threshold; float fields max |d| "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"); the render after it finite, no overflow; launches "
          f"{counts}; the phase {wall:.1f} s; {smi_line}", flush=True)
    return counts, dict(wall_s=wall, points=IO_POINTS,
                        native_points_ms=t_np * 1e3,
                        native_images_ms=t_ni * 1e3,
                        struct_points_ms=t_sp * 1e3,
                        struct_images_ms=t_si * 1e3,
                        load_sparse_ms=t_load * 1e3,
                        ply_native_ms=t_fast * 1e3,
                        ply_plain_ms=t_plain * 1e3,
                        backproject_inserted=int(n_ins),
                        backproject_card_ms=t_card * 1e3,
                        backproject_cpu_ms=t_cpu * 1e3)


# --- [dist]: sharded training on the one card (msgs_torch/dist/) ---------

def dist_inputs(scene_dir, view_idx: int = 0) -> dict:
    """What each [dist] rank gets of the trainer's scene: the initial point
    cloud, one train view's camera matrices at ×1 and its ground truth
    (numpy; the ranks rebuild tensors on their card)."""
    from msgs_torch.data.dataset import load_scene
    sc = load_scene(scene_dir, eval_split=True, device="cpu")
    view = sc.train_views[view_idx]
    cam = view.camera(1.0)
    return {"points": sc.points, "colors": sc.colors,
            "capacity": DIST_CAPACITY, "entry_cap": DIST_ENTRY_CAP,
            "gt": np.asarray(view.image(1.0), np.float32),
            "cam": (cam.world_view.numpy(), cam.full_proj.numpy(),
                    2 * math.atan(float(cam.tanfovx)),
                    2 * math.atan(float(cam.tanfovy)), cam.width,
                    cam.height)}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_model(inp, dev, bf16: bool):
    """(cfg, state, camera, gt, settings) of [dist]: the [trainer] phase's
    model at iteration 0 (SH 3, the MS-GS levels, inp's capacity:
    131,072) and its settings (inp's entry_cap, 1,048,576; the filters;
    with `bf16` its --bwd_bf16 --fast_grads, else the exact backward)."""
    from msgs_torch.core.camera import make_camera_from_matrices
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig, \
        create_from_points
    cfg = GaussianConfig(sh_degree=3, reso_lvls=7, capacity=inp["capacity"])
    st = create_from_points(cfg, inp["points"], inp["colors"], device=dev)
    cam = make_camera_from_matrices(*inp["cam"], device=dev)
    settings = RasterSettings(filter_small=True, filter_large=True,
                              entry_cap=inp["entry_cap"],
                              image_grads_only=True, grad_pack_bf16=bf16,
                              bwd_bf16=bf16)
    return cfg, st, cam, torch.as_tensor(inp["gt"], device=dev), settings


def dist_parity_rank(rank: int, inp: dict) -> dict:
    """[dist] part 1, one rank of the 2×2 mesh: the sharded loss and its
    gradients for one view at λ = DIST_LAMBDA, with the exact backward and
    with the trainer's bf16 settings. The t = 0 rank of each gauss shard
    returns its gradients."""
    from msgs_torch.dist import shard as S
    from msgs_torch.dist.mesh import make_mesh
    from msgs_torch.dist.multihost import current_rank_device
    from msgs_torch.kernels import _build
    from msgs_torch.train.loop import init_train_state
    dev = current_rank_device()
    mesh = make_mesh(2, 2, device=dev)
    out = {"coord": (mesh.g, mesh.t), "launch_counts": {}}
    for bf16 in (False, True):
        cfg, st, cam, gt, settings = dist_model(inp, dev, bf16)
        hp = S.padded_height(cam.height, mesh.n_stripes)
        gts = S.pad_gt(gt, hp)[mesh.stripe_rows(hp)].contiguous()
        local = S.shard_train_state(init_train_state(st), mesh,
                                    cfg.capacity).gaussians
        params, side = S.state_as_dicts(local)
        loss_fn = S.build_sharded_loss(mesh, cfg, settings, cam.height,
                                       cam.width, lambda_dssim=DIST_LAMBDA)
        probe = torch.zeros((local.xyz.shape[0], 2), device=dev)
        sync(dev)
        _build.reset_launch_counts()
        (loss, aux), (grads, pg) = S.sharded_value_and_grad(
            mesh, loss_fn, params, side, probe, cam, gts)
        sync(dev)
        add_counts(out["launch_counts"], _build.launch_counts)
        r = {"loss": float(loss), "num_entries": int(aux.num_entries),
             "overflow": int(aux.overflow),
             "exch_overflow": int(aux.exch_overflow)}
        if mesh.t == 0:
            r["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
            r["probe"] = pg.cpu().numpy()
        out[bf16] = r
    out["host_bytes"] = mesh.stats["host_bytes"]
    return out


def dist_gloo_rank(rank: int, inp: dict) -> dict:
    """[dist] parts 1 and 3 in one spawn of the 2×2 mesh over gloo: the
    parity pass, then the dry run's rank (msgs_torch.dist.dryrun), with
    each part's seconds on this rank."""
    from msgs_torch.dist.dryrun import dryrun_rank
    t0 = time.perf_counter()
    out = {"parity": dist_parity_rank(rank, inp)}
    t1 = time.perf_counter()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    out["dryrun"] = dryrun_rank(rank, 4)
    out["seconds"] = (t1 - t0, time.perf_counter() - t1)
    return out


def dist_reference(inp, dev, bf16: bool) -> dict:
    """[dist] part 1's single-device side: the loss and the gradients of
    every parameter and of the probe (numpy), the entries and overflow,
    of one render of dist_model(inp, dev, bf16) in this process."""
    from msgs_torch.eval.metrics import photometric_loss
    from msgs_torch.train.loop import render_state
    cfg, st, cam, gt, settings = dist_model(inp, dev, bf16)
    params = {k: v.clone().requires_grad_() for k, v in st.params().items()}
    probe = torch.zeros((cfg.capacity, 2), device=dev, requires_grad=True)
    out = render_state(st.with_params(params), cam, cfg, settings,
                       bg=torch.zeros(3, device=dev), means2d_probe=probe)
    loss = photometric_loss(out.image, gt, DIST_LAMBDA)
    gs = torch.autograd.grad(loss, list(params.values()) + [probe],
                             allow_unused=True)
    grads = {}
    for name, g in list(zip(params, gs[:-1])) + [("probe", gs[-1])]:
        like = probe if name == "probe" else params[name]
        grads[name] = (torch.zeros_like(like) if g is None else g
                       ).detach().cpu().numpy()
    return {"loss": float(loss), "grads": grads,
            "num_entries": int(out.num_entries),
            "overflow": int(out.overflow), "capacity": cfg.capacity}


def timed(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def dist_nccl_rank(rank: int, inp: dict) -> dict:
    """[dist] part 2: a world of one rank over NCCL (mesh 1×1), one sharded
    train step against the single-device train_step from the same state,
    in this process, with the exact backward."""
    from msgs_torch.dist import shard as S
    from msgs_torch.dist.mesh import make_mesh
    from msgs_torch.dist.multihost import current_rank_device
    from msgs_torch.kernels import _build
    from msgs_torch.train.loop import init_train_state, train_step
    from msgs_torch.train.optimizer import OptimParams
    dev = current_rank_device()
    cfg, st, cam, gt, settings = dist_model(inp, dev, bf16=False)
    mesh = make_mesh(1, 1, device=dev)
    state = init_train_state(st)
    step = S.build_sharded_train_step(mesh, cfg, OptimParams(), settings,
                                      cam.height, cam.width,
                                      spatial_lr_scale=1.0,
                                      lambda_dssim=DIST_LAMBDA)
    hp = S.padded_height(cam.height, 1)
    sync(dev)
    _build.reset_launch_counts()
    sh, m = step(S.shard_train_state(state, mesh, cfg.capacity), cam,
                 S.pad_gt(gt, hp))
    sync(dev)
    counts = dict(_build.launch_counts)
    one, m1 = train_step(state, cam, gt, cfg=cfg, op=OptimParams(),
                         settings=settings, reso_lvl=0,
                         spatial_lr_scale=1.0, lambda_dssim=DIST_LAMBDA)
    worst = {}
    for name, a, b in (
            [(f"g.{k}", getattr(sh.gaussians, k), getattr(one.gaussians, k))
             for k in sh.gaussians._fields]
            + [(f"mu.{k}", sh.adam.mu[k], one.adam.mu[k])
               for k in sh.adam.mu]
            + [(f"nu.{k}", sh.adam.nu[k], one.adam.nu[k])
               for k in sh.adam.nu]):
        if a.dtype.is_floating_point:
            scale = max(float(b.abs().max()), 1e-8)
            # The first moment is 0.1·gradient, the second 0.001·g²: the
            # gradient budget; parameters and side state: tests/
            # test_dist.py's step budget.
            budget = (GRAD_REL if name[:3] in ("mu.", "nu.")
                      else STEP_REL) * scale
            err = float((a - b).abs().max())
            worst[name] = err / scale
            check(err <= budget, f"[dist] NCCL 1x1 step: {name} off the "
                  f"single-device step by {err:.3e} > {budget:.3e}")
        else:
            check(bool(torch.equal(a, b)), f"[dist] NCCL 1x1 step: {name} "
                  f"differs from the single-device step")
    rel = abs(float(m["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    check(rel <= 1e-5, f"[dist] NCCL 1x1 loss rel {rel:.2e}")
    return {"backend": mesh.backend,
            "loss": float(m["loss"]), "loss_single": float(m1["loss"]),
            "num_entries": int(m["num_entries"]),
            "num_entries_single": int(m1["num_entries"]),
            "worst": max(worst.items(), key=lambda kv: kv[1]),
            "launch_counts": counts}


def dist_trainer_child(out_dir: str, argv: list) -> int:
    """One rank of [dist] part 4, started by torchrun: the trainer CLI's
    main on argv, then this rank's launch counts and iteration stamps into
    out_dir/rank<RANK>.json."""
    t_enter = time.perf_counter()
    from msgs_torch.apps import train as train_app
    from msgs_torch.kernels import _build
    stamps = []

    def on_iteration(it, host_ops):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        stamps.append((it, host_ops, time.perf_counter()))

    _build.reset_launch_counts()
    train_app.main(argv, on_iteration=on_iteration)
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"launch_counts": dict(_build.launch_counts),
                   "stamps": stamps, "t_enter": t_enter}, f)
    return 0


def trace_breakdown(trace_path: str, n: int = 4) -> str:
    """The n device activities (kernels, copies) of a Chrome trace with
    the most summed time, and the host time in gloo's collectives, in ms."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev_ms, gloo_ms = collections.Counter(), 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_ms[e["name"][:60]] += e["dur"] / 1e3
        elif e.get("cat") == "user_annotation" and \
                e["name"].startswith("gloo:"):
            gloo_ms += e["dur"] / 1e3
    return (", ".join(f"{k} {v:.3f}" for k, v in dev_ms.most_common(n))
            + f"; host in gloo collectives {gloo_ms:.3f}")


def add_counts(total: dict, counts: dict):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_dist(dev, scene, trainer_common, trainer_log, smi_line):
    """Sharded training on the one card (see the module docstring, item
    15). Returns the launch counts of every rank of the four parts."""
    from concurrent.futures import ThreadPoolExecutor

    from msgs_torch.dist.dryrun import check_records
    from msgs_torch.dist.launch import run_ranks
    from msgs_torch.tools import _device_busy_ms
    t_phase = time.perf_counter()
    counts = {}
    card = torch.device("cuda", 0)
    inp = dist_inputs(scene)

    # NCCL refuses two ranks on the one card (before any rank starts).
    try:
        run_ranks(dist_nccl_rank, 2, (inp,), backend="nccl", device="cuda")
        fail("[dist] NCCL accepted two ranks on one card")
    except ValueError as e:
        print(f"[dist] NCCL with 2 ranks on 1 card refused: {e}", flush=True)

    # Parts 1 and 3 (4 ranks, 2×2 over gloo, sharing the card) and part 2
    # (one rank over NCCL) run side by side; this process computes part
    # 1's single-device side meanwhile.
    with ThreadPoolExecutor(2) as pool:
        gloo_f = pool.submit(timed, run_ranks, dist_gloo_rank, 4, (inp,),
                             backend="gloo", device=card)
        nccl_f = pool.submit(timed, run_ranks, dist_nccl_rank, 1, (inp,),
                             backend="nccl", device="cuda")
        refs, t_ref = timed(lambda: {bf16: dist_reference(inp, dev, bf16)
                                     for bf16 in (False, True)})
        ranks, t_gloo = gloo_f.result()
        (nccl,), t_nccl = nccl_f.result()

    # 1. Parity at full width.
    parity = [r["parity"] for r in ranks]
    rank_counts = {}
    for r in parity:
        add_counts(rank_counts, r["launch_counts"])
    add_counts(counts, rank_counts)
    for k in ("scan_f32", "scan_i32", "composite_fwd", "composite_bwd",
              "composite_bwd_bf16"):
        check(rank_counts.get(k, 0) > 0, f"[dist] parity: kernel {k} never "
              f"launched on the ranks")
    for bf16 in (False, True):
        # The exact backward is held to tests/test_dist.py's budget, the
        # trainer's bf16 settings to BF16_GRAD_REL (see there).
        budget = BF16_GRAD_REL if bf16 else GRAD_REL
        ref = refs[bf16]
        loss = ref["loss"]
        for r in parity:
            rel = abs(r[bf16]["loss"] - loss) / abs(loss)
            check(rel <= 1e-5, f"[dist] parity (bf16 {bf16}): rank "
                  f"{r['coord']} loss {r[bf16]['loss']} vs single-device "
                  f"{loss} (rel {rel:.2e})")
            check(r[bf16]["overflow"] == 0 and r[bf16]["exch_overflow"] == 0,
                  f"[dist] parity: overflow on rank {r['coord']}")
        shards = [r[bf16] for r in parity if r["coord"][1] == 0]
        worst = {}
        for name, want in ref["grads"].items():
            got = np.concatenate([s["probe"] if name == "probe"
                                  else s["grads"][name] for s in shards])
            scale = max(float(np.abs(want).max()), 1e-8)
            err = float(np.abs(got - want).max())
            worst[name] = err / scale
            check(err <= budget * scale, f"[dist] parity (bf16 {bf16}): "
                  f"gradient {name} off by {err:.3e} > {budget}·max|g| = "
                  f"{budget * scale:.3e}")
        r0 = parity[0][bf16]
        print(f"[dist] parity, mesh 2x2 (4 ranks on one card over gloo), "
              f"one 512x512 view at lambda {DIST_LAMBDA}, capacity "
              f"{ref['capacity']}, "
              f"{'bwd_bf16 + fast_grads' if bf16 else 'exact backward'}: "
              f"loss {r0['loss']:.8f} vs single-device {loss:.8f}; "
              f"num_entries over the stripes {r0['num_entries']} vs "
              f"{ref['num_entries']}, overflow {r0['overflow']} vs "
              f"{ref['overflow']}, exchange overflow "
              f"{r0['exch_overflow']}; worst gradient |err|/max|g| "
              f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}; "
              f"budget {budget}); all: "
              + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()),
              flush=True)
    print(f"[dist] parity ranks' launches {rank_counts}; host-staged bytes "
          f"per rank {[r['host_bytes'] for r in parity]}", flush=True)

    # 2. One step over NCCL, a world of 1 (mesh 1×1).
    check(nccl["backend"] == "nccl", f"[dist] part 2 ran on "
          f"{nccl['backend']}")
    add_counts(counts, nccl["launch_counts"])
    print(f"[dist] NCCL 1x1: one sharded train_step, loss "
          f"{nccl['loss']:.8f} vs single-device {nccl['loss_single']:.8f}, "
          f"num_entries {nccl['num_entries']} vs "
          f"{nccl['num_entries_single']}; worst state field "
          f"{nccl['worst'][0]} at {nccl['worst'][1]:.2e} of its max "
          f"(budgets: moments {GRAD_REL}, parameters {STEP_REL}); "
          f"launches {nccl['launch_counts']}", flush=True)

    # 3. The dry run, on the same 4 ranks after part 1.
    recs = [r["dryrun"] for r in ranks]
    check_records(recs)
    for r in recs:
        add_counts(counts, r["launch_counts"])
    r = recs[0]
    print(f"[dist] dryrun_multichip(4) on the card over gloo: mesh "
          f"{r['mesh']}, {r['H']}x{r['W']}, loss {r['loss']:.6f}, packet_cap "
          f"{r['packet_cap'][0]} -> {r['packet_cap'][1]} ({r['grown']} "
          f"growths), densify live {r['densified'][0]} -> "
          f"{r['densified'][1]}, insert {r['inserted']} aggregates, "
          f"overflow {r['overflow']}/{r['exch_overflow']}", flush=True)
    secs = np.array([r["seconds"] for r in ranks])
    print(f"[dist] parts 1-3 (wall, host clock, {smi_line}): 4 gloo ranks "
          f"{t_gloo:.1f} s (on rank 0: parity {secs[0, 0]:.1f} s, dry run "
          f"{secs[0, 1]:.1f} s, the rest start-up), the NCCL rank "
          f"{t_nccl:.1f} s beside them, the single-device side "
          f"{t_ref:.1f} s in this process meanwhile", flush=True)

    # 4. The trainer CLI under torchrun, mesh 2×2 over gloo on the card.
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model")
        argv = trainer_common + [
            "-m", model, "--iterations", str(DIST_ITERS),
            "--test_iterations", "-1", "--save_iterations", "-1",
            "--mesh", "2", "2", "--dist_backend", "gloo",
            "--profile_steps", f"{DIST_PROF[0]}:{DIST_PROF[1]}"]
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "4", os.path.abspath(__file__),
             DIST_TRAINER_FLAG, tmp, *argv],
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"[dist] torchrun trainer rc "
              f"{run.returncode}:\n{run.stdout[-3000:]}\n"
              f"{run.stderr[-3000:]}")
        children = [json.load(open(os.path.join(tmp, f"rank{i}.json")))
                    for i in range(4)]
        log = [json.loads(l) for l in open(os.path.join(
            model, "train_log.jsonl"))]
        trace = os.path.join(model, "profile", "trace.json")
        busy = _device_busy_ms(trace) if os.path.exists(trace) else None
        top = trace_breakdown(trace) if busy else "not measured"
    tr_counts = {}
    for c in children:
        add_counts(tr_counts, c["launch_counts"])
    add_counts(counts, tr_counts)
    for k in ("scan_f32", "scan_i32", "composite_fwd", "composite_bwd_bf16"):
        check(tr_counts.get(k, 0) > 0, f"[dist] trainer: kernel {k} never "
              f"launched on the ranks")
    losses = {r["it"]: r["loss"] for r in log if "loss" in r}
    single = {r["it"]: r["loss"] for r in trainer_log if "loss" in r}
    for it in (100, 200, 300):
        rel = abs(losses[it] - single[it]) / single[it]
        print(f"[dist] trainer loss at {it}: {losses[it]:.6f} (mesh 2x2) vs "
              f"{single[it]:.6f} ([trainer], one rank) rel {rel:.2e}",
              flush=True)
        check(rel <= LOSS_REL, f"[dist] trainer: loss at {it} off the "
              f"single-device run's by {rel:.2e} > {LOSS_REL}")
    ev = [r for r in log if r.get("event") == "densify"]
    ev1 = {r["it"]: r for r in trainer_log if r.get("event") == "densify"}
    check(bool(ev), "[dist] trainer: no densify")
    for r in ev:
        o = ev1.get(r["it"], {})
        print(f"[dist] trainer densify at {r['it']}: live "
              f"{r['live_before']} -> {r['live_after']} (mesh 2x2) vs "
              f"{o.get('live_before')} -> {o.get('live_after')} "
              f"([trainer])", flush=True)
    st0 = children[0]["stamps"]
    # Rank 0's timeline on the host's monotonic clock (shared by the
    # processes): torchrun and the interpreter up to the rank's entry, the
    # trainer's set-up and iteration 1, iterations 2.., torchrun's exit.
    t_enter = children[0]["t_enter"]
    spans = (t_enter - t0, st0[0][2] - t_enter, st0[-1][2] - st0[0][2],
             t0 + wall - st0[-1][2])
    steps = [(b[2] - a[2]) * 1e3 for a, b in zip(st0, st0[1:])
             if not b[1] and not DIST_PROF[0] <= b[0] <= DIST_PROF[1]]
    med = statistics.median(steps)
    win = [x for x in st0 if DIST_PROF[0] <= x[0] < DIST_PROF[1]]
    span = (win[-1][2] - win[0][2]) * 1e3 if len(win) > 1 else None
    share = (f"{busy:.3f} of {span:.3f} ms ({100 * busy / span:.1f}%) "
             f"over iterations {win[0][0] + 1}..{win[-1][0]}"
             if busy and span else "not measured")
    print(f"[dist] trainer, 4 ranks sharing one card over gloo (not a "
          f"multi-card number): {DIST_ITERS} iterations in {wall:.1f} s "
          f"wall with start-up; median iteration {med:.3f} ms over "
          f"{len(steps)} plain iterations (rank 0's host clock, "
          f"synchronised); rank 0's own kernels busy {share} (profiled); "
          f"its largest device items, ms over the window: {top}; "
          f"launches {tr_counts}; {smi_line}", flush=True)
    print(f"[dist] trainer wall {wall:.1f} s: to rank 0's entry "
          f"{spans[0]:.1f}, set-up and iteration 1 {spans[1]:.1f}, "
          f"iterations 2-{DIST_ITERS} {spans[2]:.1f}, exit {spans[3]:.1f} "
          f"(host clock)", flush=True)
    print(f"[dist] {time.perf_counter() - t_phase:.1f} s ({smi_line})",
          flush=True)
    return counts, {"median_iteration_ms": med, "wall_s": wall,
                    "rank0_busy": share, "rank0_top": top}


def phase_tools(dev, st, smi_line):
    """The ported gather experiments, then the gather kernel on the render
    path's stream (see the module docstring, item 9)."""
    from msgs_torch.core.camera import make_camera
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.binning import bin_gaussians
    from msgs_torch.kernels.gather import gather_rows, gather_rows_plain
    from msgs_torch.kernels.preprocess import preprocess
    from msgs_torch.kernels.rasterize import feature_table, gather_payload
    from msgs_torch.tools import _device_busy_ms
    from msgs_torch.tools import exp_gather, exp_gather2, gather_bytes
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    runs = {"exp_gather": exp_gather.main([]),
            "exp_gather2": exp_gather2.main([])}
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"[tools] launches over both scripts: {counts}", flush=True)
    check(counts["gather_rows"] > 0, "tools: the gather kernel never ran")
    for script, res in runs.items():
        for v, r in res.items():
            check(r["max_abs_err"] in (None, 0.0),
                  f"tools: {script} {v} differs from table[gid]")
            check(math.isfinite(r["ms"]), f"tools: {script} {v} untimed")
    # Every variant of a script gathers the same rows: one bound each.
    script_bound = {script: max(r["bytes"] or 0 for r in res.values())
                    / PEAK_BYTES * 1e3 for script, res in runs.items()}
    print("[tools] scripts' default N=100000 E=2097152 F=16: " + "; ".join(
        f"{script} {v} {r['ms']:.4f} ms" + (
            "" if r["plain_ms"] is None else f" (plain {r['plain_ms']:.4f} ms)")
        for script, res in runs.items() for v, r in res.items())
        + "; bound " + ", ".join(f"{script} {b:.4f} ms" for script, b in
                                 script_bound.items())
        + f" (bytes); {smi_line}", flush=True)

    # The render path's stream: the serving model's feature table and ids.
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.8, W, H, device=dev)
    with torch.no_grad():
        pre = preprocess(cam, st.xyz, st.act_opacity(), shs=st.shs(),
                         scales=st.act_scales(), quats=st.act_rotation(),
                         active_sh_degree=st.active_sh_degree,
                         live_mask=st.live)
        b = bin_gaussians(pre, W, H, ENTRY_CAP)
        table = feature_table(pre)
    gid = b.gauss_id
    rows, F = table.shape
    E = gid.shape[0]
    # A row per slot of the model's capacity, and binning's padded slots.
    blk = 2048
    check((rows, F) == (st.xyz.shape[0] + 1, 12) and E % blk == 0
          and gid.dtype == torch.int32,
          f"tools: render stream table {tuple(table.shape)}, gid {E} "
          f"{gid.dtype}")
    layouts = {"entry": None, "feature": None, "blocked": blk}
    times, dev_times = {}, {}
    for layout, block in layouts.items():
        got = gather_rows(table, gid, "rows", layout, block)
        torch.cuda.synchronize()
        want = gather_rows_plain(table, gid, "rows", layout, block)
        check(got.shape == want.shape and torch.equal(
            got.view(torch.int32), want.view(torch.int32)),
            f"tools: gather_rows {layout} differs from its plain version "
            f"on the render stream")
        times[layout] = median_ms(
            lambda: gather_rows(table, gid, "rows", layout, block), 20)
        dev_times[layout] = trace_total_ms(
            lambda: gather_rows(table, gid, "rows", layout, block))
    plain = median_ms(lambda: gather_rows_plain(table, gid), 20)
    lib = median_ms(lambda: table[gid], 20)
    # Rows of the table that gid references: the live Gaussians that
    # binning kept, and the sentinel row of its padded slots.
    rows_read = int(torch.unique(gid).numel())
    bound = gather_bytes(gid, F) / PEAK_BYTES * 1e3
    print(f"[tools] gather_rows on the render stream ({rows}x{F} table, "
          f"{rows_read} rows referenced, {E} ids): equal to its plain "
          f"version bit for bit in every layout; kernel " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in times.items())
          + f" (device " + ", ".join(f"{k} {ms_text(v)}"
                                     for k, v in dev_times.items())
          + f"); plain {plain:.4f} ms, table[gid] {lib:.4f} ms; bound "
          f"{bound:.4f} ms (bytes)", flush=True)

    # The feature-table layouts (6b, 6c, 6e) on the same stream: the
    # table's transpose, gathered into each layout, equal to the row
    # table's gather and to the plain version bit for bit; 6b (feature
    # out) timed in turns with table_t[:, gid], one PyTorch call of the
    # same function.
    table_t = table.t().contiguous()
    times_t, dev_times_t = {}, {}
    for layout, block in layouts.items():
        got = gather_rows(table_t, gid, "features", layout, block)
        torch.cuda.synchronize()
        for want, what in ((gather_rows_plain(table_t, gid, "features",
                                              layout, block),
                            "its plain version"),
                           (gather_rows(table, gid, "rows", layout, block),
                            "the row table's gather")):
            check(got.shape == want.shape and torch.equal(
                got.view(torch.int32), want.view(torch.int32)),
                f"tools: gather_rows features/{layout} differs from {what} "
                f"on the render stream")
        times_t[layout] = median_ms(
            lambda: gather_rows(table_t, gid, "features", layout, block), 20)
        dev_times_t[layout] = trace_total_ms(
            lambda: gather_rows(table_t, gid, "features", layout, block),
            kernels=2)
    ms_6b, lib_t = paired_ms(
        lambda: gather_rows(table_t, gid, "features", "feature"),
        lambda: table_t[:, gid])
    check(torch.equal(table_t[:, gid].view(torch.int32),
                      gather_rows(table_t, gid, "features",
                                  "feature").view(torch.int32)),
          "tools: table_t[:, gid] differs from the feature-major gather")
    print(f"[tools] gather_rows from the feature table ({F}x{rows}) on the "
          f"render stream: equal to its plain version and to the row "
          f"table's gather bit for bit in every layout; kernel " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in times_t.items())
          + " (device, the transpose included: " + ", ".join(
              f"{k} {ms_text(v)}" for k, v in dev_times_t.items())
          + f"); in turns: feature {ms_6b:.4f} ms, table_t[:, gid] "
          f"{lib_t:.4f} ms; bound {bound:.4f} ms (bytes); {smi_line}",
          flush=True)

    # 6b at the scripts' default (exp_gather's draw) in turns with
    # table_t[:, gid].
    rng = np.random.default_rng(0)
    N_d, E_d, F_d = 100_000, 1 << 21, 16
    tab_np = rng.normal(size=(N_d + 1, F_d)).astype(np.float32)
    tab_t = torch.as_tensor(tab_np.T.copy(), device=dev)
    gid_d = torch.as_tensor(rng.integers(0, N_d, E_d).astype(np.int32),
                            device=dev)
    ms_6b_d, lib_t_d = paired_ms(
        lambda: gather_rows(tab_t, gid_d, "features", "feature"),
        lambda: tab_t[:, gid_d])
    check(torch.equal(tab_t[:, gid_d].view(torch.int32),
                      gather_rows(tab_t, gid_d, "features",
                                  "feature").view(torch.int32)),
          "tools: table_t[:, gid] differs from the feature-major gather at "
          "the default")
    dev_6b_d = trace_total_ms(
        lambda: gather_rows(tab_t, gid_d, "features", "feature"), kernels=2)
    dev_lib_d = trace_total_ms(lambda: tab_t[:, gid_d], kernels=2)
    print(f"[tools] scripts' default, in turns: pallas_vmem_take_lane (6b) "
          f"{ms_6b_d:.4f} ms, table_t[:, gid] {lib_t_d:.4f} ms (device "
          f"{ms_text(dev_6b_d)} and {ms_text(dev_lib_d)}, all kernels of a "
          f"call)", flush=True)
    del tab_t, gid_d, table_t

    # The render path's own gather: host clock against device time.
    def payload():
        return gather_payload(pre, gid, b.gid_starts)

    with torch.no_grad():
        wall = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        reps = 5
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                payload()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            busy = _device_busy_ms(path) / reps
    print(f"[tools] render path gather_payload: {statistics.median(wall[1:]):.4f}"
          f" ms host clock (synchronised, median of 7), device busy "
          f"{busy:.4f} ms per call (profiler trace); {smi_line}", flush=True)
    # A bitwise match in every layout: max|Δ| is 0.
    rec = dict(ms=times["entry"], plain_ms=plain, library_ms=lib,
               bound_ms=bound, bound_by="bytes", max_abs_err=0.0, extra=dict(
                   shape=[E, F], rows_read=rows_read, ms_by_layout=times,
                   ms_by_layout_feature_table=times_t,
                   feature_in_turns_ms=[ms_6b, lib_t],
                   default_6b_in_turns_ms=[ms_6b_d, lib_t_d],
                   device_ms_by_layout=dev_times,
                   device_ms_by_layout_feature_table=dev_times_t,
                   default_6b_device_ms=[dev_6b_d, dev_lib_d],
                   script_ms={f"{script}:{v}": r["ms"]
                              for script, res in runs.items()
                              for v, r in res.items()},
                   script_plain_ms={f"{script}:{v}": r["plain_ms"]
                                    for script, res in runs.items()
                                    for v, r in res.items()
                                    if r["plain_ms"] is not None},
                   script_bound_ms=script_bound))
    return counts, rec


# A (block, pixel) cell of pow_mxu that differs from its plain version by
# more than this holds a flipped 1/255 mask: a flip moves a row by
# feat·(1/255)·T, ≥ 1e-5 wherever feat·T ≥ 0.00255, where the rounding of
# either precision moves it by < 2e-6 (PERF.md, the probe's per-run table).
MXU_FLIP_SIZE = 1e-5


def probe_sass_per_pair() -> dict:
    """{(variant, precision): SASS instructions per pair} of the built
    probe: the per-block instance's static instruction count (its loops
    are unrolled; the summed instance adds its closers, run once a CTA)
    over the pairs a thread covers in one pass of the segment loop
    (work.PROBE_PAIRS_PER_PASS), the once-a-block code counted as if it
    ran every pass: an upper estimate. Needs cuobjdump (msgs_torch.tools.
    sass)."""
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.mxu_probe import VARIANTS
    from msgs_torch.tools import sass
    counts = {}
    for k, ins in sass.kernels(sass.disassemble(
            _build.build_info["path"])).items():
        counts[sass._CHECKOUT.sub("", k)] = len(ins)
    out = {}
    for v, p in PROBE_OPS:
        tag = (f"mxu_probe_kernelILi{VARIANTS.index(v)}ELb"
               f"{int(p == 'HIGH')}ELb1E")
        found = [n for k, n in counts.items() if tag in k]
        check(len(found) == 1, f"mxu: SASS of {tag}: {len(found)} kernels")
        out[v, p] = found[0] / PROBE_PAIRS_PER_PASS
    return out


def phase_mxu(dev, smi_line):
    """The ported pair-math probe, then its kernel per block (see the
    module docstring, item 10)."""
    from msgs_torch.kernels import _build
    from msgs_torch.kernels.mxu_probe import (NDF, NPIX, pair_block_probe,
                                              pair_block_probe_plain)
    from msgs_torch.tools import exp_mxu
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    runs = exp_mxu.main([])
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"[mxu] launches over the 12 runs: {counts}", flush=True)
    check(len(runs) == len(exp_mxu.RUNS), f"mxu: {len(runs)} runs")
    for r in runs:
        name = f"{r['variant']} ({r['precision']})"
        check(r["launches"] > 0, f"mxu: {name}: the kernel never ran")
        check(math.isfinite(r["ms"]) and r["max_abs_err"] <= r["budget"],
              f"mxu: {name}: {r}")
    check(counts["mxu_probe"] == sum(r["launches"] for r in runs),
          "mxu: launches outside the runs")
    # Instructions per pair, and the issue floor they set at the card's
    # clocks.max.sm (work.MAX_SM_CLOCK_HZ), printed here only: the floor is
    # computed, not measured. Each run's device time from a profiler trace
    # (its event time carries the host's call).
    per_pair = probe_sass_per_pair()
    pay = exp_mxu.make_payload(exp_mxu.DEFAULT_BLOCKS, dev)
    g0 = torch.zeros((NDF, NPIX), dtype=torch.float32, device=dev)
    for r in runs:
        kw = {"g_rows": g0} if r["variant"] == "dfeat_nt" else {}
        r.update(device_ms=trace_total_ms(
            lambda: pair_block_probe(pay, r["variant"], r["precision"],
                                     **kw)),
                 sass_per_pair=per_pair[r["variant"], r["precision"]])
    print(f"[mxu] B={exp_mxu.DEFAULT_BLOCKS}: " + "; ".join(
        f"{r['variant']} ({r['precision']}) {r['ms']:.4f} ms (device "
        f"{ms_text(r['device_ms'])}), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), {r['sass_per_pair']:.2f} SASS a pair, floor "
        f"{issue_floor_ms(r['sass_per_pair'], r['pairs']):.4f} ms at "
        f"{MAX_SM_CLOCK_HZ / 1e6:g} MHz, max|Δ| "
        f"{r['max_abs_err']:.3e} of {r['budget']:.3e}" for r in runs)
        + f"; {smi_line}", flush=True)

    # Per block at B = 512; dfeat_nt on a seeded nonzero g_rows.
    pay = exp_mxu.make_payload(512, dev)
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=(NDF, NPIX)).astype(np.float32), device=dev)
    per_block, flips = {}, {}
    for variant, precision in sorted(set(exp_mxu.RUNS),
                                     key=exp_mxu.RUNS.index):
        kw = {"g_rows": g} if variant == "dfeat_nt" else {}
        rel = exp_mxu.REL_BUDGET
        name = f"{variant} ({precision})"
        got = pair_block_probe(pay, variant, precision, per_block=True, **kw)
        torch.cuda.synchronize()
        want = pair_block_probe_plain(pay, variant, precision,
                                      per_block=True, **kw)
        dim = 2 if variant == "dfeat_nt" else 1
        err, allow = exp_mxu.held_rows(f"mxu per block {name}", got, want,
                                       rel, dim)
        check(bool(want.abs().max() > 0), f"mxu: {name} per block is 0")
        # The f32 runs keep the plain version's order of operations: bit
        # for bit per block (dfeat_nt: its df).
        if precision != "HIGH":
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"mxu: {name} per block is not bit for bit its plain "
                  f"version (max|Δ| {err})")
        again = pair_block_probe(pay, variant, precision, per_block=True,
                                 **kw)
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"mxu: {name} per block is not deterministic")
        if variant == "dfeat_nt":
            exp_mxu.held_rows(f"mxu summed {name}",
                              pair_block_probe(pay, variant, precision, **kw),
                              pair_block_probe_plain(pay, variant, precision,
                                                     **kw), rel, 0)
        per_block[name] = [err, allow]
        if variant == "pow_mxu":
            flips[name] = int(((got - want).abs().amax(dim=1)
                               > MXU_FLIP_SIZE).sum())
    a = pair_block_probe(pay, "base")
    b = pair_block_probe(pay, "base")
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          "mxu: two launches differ")
    print("[mxu] per block at B=512 (max|Δ| of the largest row allowance; "
          "the f32 runs bit for bit): "
          + "; ".join(f"{k} {e:.3e} of {lim:.3e}"
                      for k, (e, lim) in per_block.items())
          + f"; two launches bit-identical; pow_mxu (block, pixel) cells "
          f"off by more than {MXU_FLIP_SIZE:g}: {flips}", flush=True)
    del pay, a, b, got, want, again
    torch.cuda.empty_cache()
    base = runs[1]
    rec = dict(ms=base["ms"], plain_ms=base["plain_ms"], library_ms=None,
               bound_ms=base["bound_ms"], bound_by=base["bound_by"],
               max_abs_err=max(r["max_abs_err"] for r in runs),
               extra=dict(launches_mxu=counts["mxu_probe"], runs=runs,
                          per_block_max_abs_err=per_block,
                          pow_flip_cells_b512=flips))
    return counts, rec


def ablate_held(label, stream, width, height):
    """Every forward and backward ablation variant against its plain
    version on one stream: written slots equal, values within the tool's
    budgets. Returns {variant: [max|Δ|, bit-exact]}."""
    from msgs_torch.kernels import ablate
    from msgs_torch.kernels import composite as comp
    from msgs_torch.tools import exp_fwd_ablate as tool
    payload, st, sv, tls = stream
    tx = (width + 15) // 16
    tiles = ablate.n_tiles(tx, height)
    out = {}
    for v in ablate.FWD_VARIANTS:
        got, written = ablate.fwd_ablate(payload, st, sv, v, tx, width,
                                         height)
        torch.cuda.synchronize()
        want, want_w = ablate.fwd_ablate_plain(payload, st, sv, v, tx,
                                               width, height)
        check(torch.equal(written, want_w),
              f"ablate {label} fwd/{v}: written slots differ")
        tols = tool.FWD_TOL if v in ablate.TILE_VARIANTS else tool.REL_BUDGET
        out[f"fwd/{v}"] = list(tool.held(f"ablate {label} fwd/{v}",
                                         got[written], want[written], tols))
    res = comp.composite(payload, st, sv, tls, tiles, tx, width, height)
    cst = tool.make_cst(res)
    for v in ablate.BWD_VARIANTS:
        got = ablate.bwd_ablate(payload, st, sv, cst, v, tx, width, height)
        torch.cuda.synchronize()
        want = ablate.bwd_ablate_plain(payload, st, sv, cst, v, tx, width,
                                       height)
        g2, w2 = got.reshape(-1, comp.NFEAT), want.reshape(-1, comp.NFEAT)
        out[f"bwd/{v}"] = list(tool.held(f"ablate {label} bwd/{v}", g2, w2,
                                         tool.grad_tols(w2)))
    print(f"[ablate] {label}: every variant within budget of its plain "
          f"version; not bit-exact: "
          f"{[k for k, (_, exact) in out.items() if not exact]}", flush=True)
    return out


def phase_ablate(dev, small, smi_line):
    """The ported compositor ablations (see the module docstring, item
    11)."""
    from msgs_torch.kernels import _build, ablate
    from msgs_torch.kernels import composite as comp
    from msgs_torch.tools import exp_fwd_ablate as tool
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    runs = tool.main(["all"])
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    t_tool = time.perf_counter() - t0
    print(f"[ablate] launches over the 15 variants: {counts}", flush=True)
    check(len(runs) == len(ablate.FWD_VARIANTS) + len(ablate.BWD_VARIANTS),
          f"ablate: {len(runs)} runs")
    for r in runs:
        check(r["launches"] > 0 and math.isfinite(r["ms"]),
              f"ablate: {r['name']}: {r}")
    for name in ("fwd_ablate", "bwd_ablate"):
        check(counts[name] == sum(r["launches"] for r in runs
                                  if r["name"][:3] == name[:3]),
              f"ablate: {name} launches outside the runs")
    for r in runs:
        print(f"[ablate] {tool.W}x{tool.H}, entry_cap {tool.ENTRY_CAP}: "
              f"{run_text(r)}; {smi_line}", flush=True)

    # Kernels 3 and 4 on the whole stream, against fwd/full and bwd/full.
    payload, st, sv, tls = tool.make_stream(dev)
    tx = (tool.W + 15) // 16
    tiles = ablate.n_tiles(tx, tool.H)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    k3 = comp._composite_cuda(payload, first, n_sub, tiles, tx, tool.W,
                              tool.H)
    full, written = ablate.fwd_ablate(payload, st, sv, "full", tx, tool.W,
                                      tool.H)
    used = (n_sub > 0).nonzero()[:, 0]
    check(bool(written[tls[used].long()].all())
          and torch.equal(full[tls[used].long()], k3[used]),
          "ablate: fwd/full at tile_last_sub differs from composite_fwd")
    cot = torch.full_like(k3, tool.COT)
    k4 = comp._composite_bwd_cuda(payload, first, n_sub, k3, cot, tiles, tx,
                                  tool.W, tool.H, True)
    dpay = ablate.bwd_ablate(payload, st, sv, tool.make_cst(k3), "full", tx,
                             tool.W, tool.H)
    colour = slice(comp.F_R, comp.F_B + 1)
    check(torch.equal(dpay[..., colour], k4[..., colour]),
          "ablate: bwd/full's colour columns differ from composite_bwd")
    print(f"[ablate] whole stream ({payload.shape[0]} blocks, "
          f"{int(used.numel())} tiles): fwd/full at tile_last_sub equals "
          f"composite_fwd and bwd/full's r g b columns composite_bwd "
          f"(image_only) bit for bit", flush=True)
    del payload, st, sv, k3, k4, full, dpay
    torch.cuda.empty_cache()

    held = {
        "clustered 1920x1080, 16 blocks": ablate_held(
            "clustered", tool.clustered_stream(dev, 16), tool.W, tool.H),
        "staggered 1920x1080, 8 blocks": ablate_held(
            "staggered", tool.staggered_stream(dev), tool.W, tool.H),
        "256x200 scene": ablate_held(
            "256x200", tool.scene_stream(dev, small, 256, 200, 1 << 17),
            256, 200),
        "1920x1080 first 512 blocks": ablate_held(
            "1080p/512", tool.make_stream(dev, 512), tool.W, tool.H),
    }
    torch.cuda.empty_cache()
    print(f"[ablate] {time.perf_counter() - t0:.1f} s (the tool "
          f"{t_tool:.1f} s)", flush=True)
    recs = {}
    for name, prefix in (("fwd_ablate", "fwd/"), ("bwd_ablate", "bwd/")):
        mine = [r for r in runs if r["name"].startswith(prefix)]
        full_run = mine[0]
        recs[name] = dict(
            ms=full_run["ms"], plain_ms=full_run["plain_ms"],
            library_ms=None, bound_ms=full_run["bound_ms"],
            bound_by=full_run["bound_by"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            extra=dict(runs=mine, held={k: {v: e for v, e in h.items()
                                            if v.startswith(prefix)}
                                        for k, h in held.items()}))
    return counts, recs


def bwd2_held(label, stream, width, height):
    """fwd/horner and every backward form of both scripts against their
    plain versions on one stream, bit for bit; a form that zeroes in the
    kernel writes over NaN. Returns {run: max|Δ|}."""
    from msgs_torch.kernels import ablate
    from msgs_torch.kernels import composite as comp
    from msgs_torch.tools import exp_bwd2
    from msgs_torch.tools import exp_fwd_ablate as tool
    payload, st, sv, tls = stream
    tx = (width + 15) // 16
    out = {}
    got, written = ablate.fwd_ablate(payload, st, sv, "horner", tx, width,
                                     height)
    torch.cuda.synchronize()
    want, want_w = ablate.fwd_ablate_plain(payload, st, sv, "horner", tx,
                                           width, height)
    check(torch.equal(written, want_w) and torch.equal(got, want),
          f"bwd2 {label} fwd/horner differs from its plain version")
    out["fwd/horner"] = float((got - want).abs().max())
    res = comp.composite(payload, st, sv, tls, ablate.n_tiles(tx, height),
                         tx, width, height)
    cst = tool.make_cst(res)
    for run, form in exp_bwd2.BWD_RUNS.items():
        c = ablate.dense_cst(cst, st) if form.constants == "dense" else cst
        buf = (torch.full_like(payload, float("nan"))
               if form.zeroing == "kernel" else None)
        got = ablate.bwd_ablate(payload, st, sv, c, "full", tx, width,
                                height, out=buf, form=form)
        torch.cuda.synchronize()
        want = ablate.bwd_ablate_plain(payload, st, sv, c, "full", tx, width,
                                       height, form=form)
        check(torch.equal(got, want),
              f"bwd2 {label} {run}: differs from its plain version (max|Δ| "
              f"{float((got - want).abs().max())})")
        out[run] = float((got - want).abs().max())
    print(f"[bwd2] {label}: fwd/horner and the {len(out) - 1} backward "
          f"forms equal their plain versions bit for bit", flush=True)
    return out


def phase_bwd2(dev, small, smi_line):
    """The ported follow-up experiments (see the module docstring, item
    12)."""
    from msgs_torch.kernels import _build, ablate
    from msgs_torch.kernels import composite as comp
    from msgs_torch.tools import exp_bwd2, exp_bwd3
    from msgs_torch.tools import exp_fwd_ablate as tool
    t0 = time.perf_counter()
    runs, counts = {}, {}
    for script, mod in (("exp_bwd2", exp_bwd2), ("exp_bwd3", exp_bwd3)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        runs[script] = mod.main([])
        torch.cuda.synchronize()
        counts[script] = dict(_build.launch_counts)
        print(f"[bwd2] {script} launches: {counts[script]}", flush=True)
    t_tools = time.perf_counter() - t0
    check([r["name"] for r in runs["exp_bwd2"] + runs["exp_bwd3"]]
          == ["fwd/horner"] + list(exp_bwd2.BWD_RUNS),
          "bwd2: runs out of order")
    for r in runs["exp_bwd2"] + runs["exp_bwd3"]:
        check(r["launches"] > 0 and math.isfinite(r["ms"]) and r["exact"],
              f"bwd2: {r['name']}: {r}")
    horner = runs["exp_bwd2"][0]
    check(horner["max_abs_sum"] > 0, "bwd2: fwd/horner's running sum is 0")
    check(counts["exp_bwd2"]["fwd_ablate"] == horner["launches"]
          and counts["exp_bwd3"]["fwd_ablate"] == 0,
          "bwd2: fwd_ablate launches outside fwd/horner")
    for script in runs:
        check(counts[script]["bwd_ablate"] == sum(
            r["launches"] for r in runs[script] if r["name"] != "fwd/horner"),
            f"bwd2: bwd_ablate launches outside {script}'s runs")
    for r in runs["exp_bwd2"] + runs["exp_bwd3"]:
        print(f"[bwd2] {tool.W}x{tool.H}, entry_cap {tool.ENTRY_CAP}: "
              f"{run_text(r)}; {smi_line}", flush=True)

    # Every backward form against kernel 4 (image-only) on the whole stream.
    payload, st, sv, tls = tool.make_stream(dev)
    tx = (tool.W + 15) // 16
    tiles = ablate.n_tiles(tx, tool.H)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    k3 = comp._composite_cuda(payload, first, n_sub, tiles, tx, tool.W,
                              tool.H)
    cot = torch.full_like(k3, tool.COT)
    cot[:, comp.O_DEPTH:comp.O_ACC + 1] = 0.0
    k4 = comp._composite_bwd_cuda(payload, first, n_sub, k3, cot, tiles, tx,
                                  tool.W, tool.H, True).reshape(-1, 12)
    cst = tool.make_cst(k3)
    vs_k4 = {}
    for run, form in exp_bwd2.BWD_RUNS.items():
        c = ablate.dense_cst(cst, st) if form.constants == "dense" else cst
        got = ablate.bwd_ablate(payload, st, sv, c, "full", tx, tool.W,
                                tool.H, form=form).reshape(-1, 12)
        check(torch.equal(got[:, comp.F_R:], k4[:, comp.F_R:]),
              f"bwd2 {run}: colour columns differ from composite_bwd")
        worst = 0.0
        for col in range(comp.F_R):
            d = float((got[:, col] - k4[:, col]).abs().max())
            tol = grad_budget(k4[:, col])
            check(d <= tol, f"bwd2 {run}: column {col} max|Δ| {d} to "
                            f"composite_bwd > {tol}")
            worst = max(worst, d / tol)
        exact = torch.equal(got[:, :comp.F_R], k4[:, :comp.F_R])
        vs_k4[run] = {"geometry_exact": exact, "worst_of_budget": worst}
        if form.moments == "vpu" and not exact:
            print(f"[bwd2] {run}: the vpu geometry is not composite_bwd's "
                  f"bit for bit (predicted); worst column at {worst:.3e} of "
                  f"its budget", flush=True)
    print(f"[bwd2] whole stream vs composite_bwd (image_only): colour "
          f"columns bit for bit in every form; geometry " + "; ".join(
              f"{k} {'exact' if v['geometry_exact'] else 'not exact'}, worst "
              f"{v['worst_of_budget']:.3e} of budget"
              for k, v in vs_k4.items()), flush=True)
    del payload, st, sv, k3, k4, cst, got
    torch.cuda.empty_cache()

    held = {
        "clustered 1920x1080, 16 blocks": bwd2_held(
            "clustered", tool.clustered_stream(dev, 16), tool.W, tool.H),
        "staggered 1920x1080, 8 blocks": bwd2_held(
            "staggered", tool.staggered_stream(dev), tool.W, tool.H),
        "256x200 scene": bwd2_held(
            "256x200", tool.scene_stream(dev, small, 256, 200, 1 << 17),
            256, 200),
        "1920x1080 first 512 blocks": bwd2_held(
            "1080p/512", tool.make_stream(dev, 512), tool.W, tool.H),
    }
    torch.cuda.empty_cache()
    print(f"[bwd2] {time.perf_counter() - t0:.1f} s (the tools "
          f"{t_tools:.1f} s)", flush=True)
    recs = {}
    for name, mine in (("fwd_ablate_horner", [horner]),
                       ("bwd_ablate_bwd2", runs["exp_bwd2"][1:]),
                       ("bwd_ablate_bwd3", runs["exp_bwd3"])):
        first_run = mine[0]
        names = {r["name"] for r in mine}
        recs[name] = dict(
            ms=first_run["ms"], plain_ms=first_run["plain_ms"],
            library_ms=None, bound_ms=first_run["bound_ms"],
            bound_by=first_run["bound_by"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            extra=dict(runs=mine,
                       vs_composite_bwd={k: v for k, v in vs_k4.items()
                                         if k in names},
                       held={k: {v: e for v, e in h.items() if v in names}
                             for k, h in held.items()}))
    # Launches per record: the kernels' counters over its script's runs
    # (fwd/horner is the only fwd_ablate launch of either script).
    launches = {"fwd_ablate_horner": counts["exp_bwd2"]["fwd_ablate"],
                "bwd_ablate_bwd2": counts["exp_bwd2"]["bwd_ablate"],
                "bwd_ablate_bwd3": counts["exp_bwd3"]["bwd_ablate"]}
    return launches, recs


def bench_scene(seed: int = 0):
    from msgs_torch.tools import bench_scene as scene
    return scene(seed)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == [FRESH_FLAG]:
        return fresh_device_child(sys.argv[2])
    if sys.argv[1:2] == [DIST_TRAINER_FLAG]:
        return dist_trainer_child(sys.argv[2], sys.argv[3:])
    t_start = time.perf_counter()
    dev, smi_line = phase_device()
    phase_build()

    scans = {
        "scan_f32": scan_record("scan_f32", torch.float32,
                                [(1, 270_336), (5, 1_417_216), (7, 999_983),
                                 (3, 4_097), (1, 1)], dev),
        "scan_i32": scan_record("scan_i32", torch.int32,
                                [(4, 1_417_216), (7, 999_983), (2, 4_095)],
                                dev),
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
    bf16_rec = composite_bwd_bf16_check("1920x1080 bench stream", dev,
                                        bench_stream, W, H, timed=True)
    composite_bwd_bf16_check("256x200 scene", dev, small_stream, 256, 200,
                             timed=False)
    bf16_grads_check("1920x1080 bench scene", dev, bench_scene(0), W, H,
                     ENTRY_CAP)
    bf16_grads_check("256x200 scene", dev, small, 256, 200, 1 << 17)
    del bench_stream, small_stream

    serve_counts, renders, _, st, cfg = phase_main_path(dev)
    rowtight_counts, rowtight_rec = phase_rowtight(dev, smi_line)
    tools_counts, gather_rec = phase_tools(dev, st, smi_line)
    mxu_counts, mxu_rec = phase_mxu(dev, smi_line)
    ablate_counts, ablate_recs = phase_ablate(dev, small, smi_line)
    bwd2_counts, bwd2_recs = phase_bwd2(dev, small, smi_line)
    train_counts, _ = phase_train(dev, st, cfg)
    del st
    phase_small_reference(dev)
    phase_train_small(dev)
    (trainer_counts, trainer_times, eval_counts, eval_rec, apps_counts,
     apps_rec, dist_counts, dist_rec, io_counts,
     io_rec) = phase_trainer(dev, smi_line)

    records = []
    meta = {
        "scan_f32": ("msgs_torch/csrc/scan.cu", "msgs/kernels/scan.py:57"),
        "scan_i32": ("msgs_torch/csrc/scan.cu", "msgs/kernels/scan.py:84"),
        "composite_fwd": ("msgs_torch/csrc/composite_fwd.cu",
                          "msgs/kernels/composite.py:401"),
        "composite_bwd": ("msgs_torch/csrc/composite_bwd.cu",
                          "msgs/kernels/composite.py:486"),
        "composite_bwd_bf16": ("msgs_torch/csrc/composite_bwd_bf16.cu",
                               "msgs/kernels/composite.py:486 (bwd_bf16)"),
        "gather_rows": ("msgs_torch/csrc/gather.cu",
                        "tools/exp_gather.py:72, :103, :131; "
                        "tools/exp_gather2.py:75, :106"),
        "mxu_probe": ("msgs_torch/csrc/mxu_probe.cu", "tools/exp_mxu.py:209"),
        "fwd_ablate": ("msgs_torch/csrc/fwd_ablate.cu",
                       "tools/exp_fwd_ablate.py:216 (fwd_kernel_var :97)"),
        "bwd_ablate": ("msgs_torch/csrc/bwd_ablate.cu",
                       "tools/exp_fwd_ablate.py:428 (bwd_var :268)"),
        "fwd_ablate_horner": ("msgs_torch/csrc/fwd_ablate.cu",
                              "tools/exp_bwd2.py:153 (fwd_horner_kernel "
                              ":92)"),
        "bwd_ablate_bwd2": ("msgs_torch/csrc/bwd_ablate.cu",
                          "tools/exp_bwd2.py:323 (bwd_kernel_var :177)"),
        "bwd_ablate_bwd3": ("msgs_torch/csrc/bwd_ablate.cu",
                          "tools/exp_bwd3.py:259 (bwd_kernel :101)"),
    }
    kernel_recs = list(scans.items()) + [("composite_fwd", comp_rec),
                                         ("composite_bwd", bwd_rec),
                                         ("composite_bwd_bf16", bf16_rec),
                                         ("gather_rows", gather_rec),
                                         ("mxu_probe", mxu_rec),
                                         ("fwd_ablate",
                                          ablate_recs["fwd_ablate"]),
                                         ("bwd_ablate",
                                          ablate_recs["bwd_ablate"])]
    kernel_recs += list(bwd2_recs.items())
    runs = (serve_counts, rowtight_counts, tools_counts, mxu_counts,
            ablate_counts, bwd2_counts, train_counts, trainer_counts,
            eval_counts, apps_counts, dist_counts, io_counts)
    for name, rec in kernel_recs:
        src, rep = meta[name]
        # launches: over the twelve main-path runs, each counted from 0
        # (serving renders, row-tight binning, the gather tools, the
        # pair-math probe, the ablations, the follow-up experiments,
        # train_step calls, the trainer, the evaluation apps, the
        # interactive apps, every rank of the sharded runs, and the I/O
        # phase's renders); then each run's. The follow-up experiments' records
        # share the ablation kernels' counters; [bwd2] gives each record
        # the launches of its own runs.
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(c.get(name, 0) for c in runs),
            "launches_trainer": trainer_counts.get(name, 0),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "launches_train_step": train_counts.get(name, 0),
            "launches_serving": serve_counts.get(name, 0),
            "launches_tools": tools_counts.get(name, 0),
            "launches_ablate": ablate_counts.get(name, 0),
            "launches_bwd2": bwd2_counts.get(name, 0),
            "launches_rowtight": rowtight_counts.get(name, 0),
            "launches_eval": eval_counts.get(name, 0),
            "launches_apps": apps_counts.get(name, 0),
            "launches_dist": dist_counts.get(name, 0),
            "launches_io": io_counts.get(name, 0),
            **({"rowtight": rowtight_rec} if name == "scan_f32" else {}),
            **({"eval": eval_rec} if name == "composite_fwd" else {}),
            **({"apps": apps_rec} if name == "composite_fwd" else {}),
            **({"dist": dist_rec} if name == "composite_fwd" else {}),
            **({"io": io_rec} if name == "composite_fwd" else {}),
            **({"trainer_shapes": trainer_times[name]}
               if name in trainer_times else {}),
            **rec.get("extra", {})})
    print(f"[done] {time.perf_counter() - t_start:.1f} s; "
          f"{renders} serving renders, {STEPS} training steps, "
          f"{TRAIN_ITERS} trainer iterations", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
