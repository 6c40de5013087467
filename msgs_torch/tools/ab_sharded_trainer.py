"""Time the sharded trainer of two checkouts in turns on one card.

    python -m msgs_torch.tools.ab_sharded_trainer A_DIR B_DIR [--iterations N]

Each checkout's `chip_smoke.py --dist-trainer-rank` runs the trainer CLI
under torchrun as [dist] does (a 2×2 mesh over gloo, four ranks sharing
card 0, [trainer]'s MS-GS flags), in the order A, B, B, A, on one
synthetic scene made first. For each run it prints the wall time, rank
0's per-iteration milliseconds (host clock after a synchronise, the
iterations without evaluation, saves or structural steps): median, p10,
p90, mean, the medians of the first and second half, and the loss at the
last iteration. Host times of four ranks time-sharing one card spread
from call to call; compare two checkouts only within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# [trainer]'s flags in chip_smoke.py, with [dist]'s mesh and backend.
FLAGS = ["--eval", "--ms_train", "--ms_train_max_scale", "6",
         "--filter_small", "--insert_large", "--bwd_bf16", "--fast_grads",
         "--capacity", "131072", "--entry_cap", "1048576",
         "--sh_degree", "3", "--densify_from_iter", "200",
         "--densification_interval", "100",
         "--opacity_reset_interval", "600", "--test_interval", "0",
         "--disable_gui", "--no_tensorboard", "--quiet",
         "--test_iterations", "-1", "--save_iterations", "-1",
         "--mesh", "2", "2", "--dist_backend", "gloo"]


def run(tree: str, scene: str, iterations: int) -> dict:
    """One torchrun of `tree`'s trainer; rank 0's stamps and the log."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "4", os.path.join(tree, "chip_smoke.py"),
             "--dist-trainer-rank", tmp, "-s", scene,
             "-m", os.path.join(tmp, "model"),
             "--iterations", str(iterations), *FLAGS],
            cwd=tree, capture_output=True, text=True, timeout=1800)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            stamps = json.load(f)["stamps"]
        with open(os.path.join(tmp, "model", "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
    steps = [(b[0], (b[2] - a[2]) * 1e3)
             for a, b in zip(stamps, stamps[1:]) if not b[1]]
    return {"wall": wall, "steps": steps,
            "loss": {r["it"]: r["loss"] for r in log if "loss" in r}}


def summary(name: str, r: dict, iterations: int) -> str:
    ms = [x for _, x in r["steps"]]
    q = statistics.quantiles(ms, n=10)
    half = iterations // 2
    first = statistics.median([x for i, x in r["steps"] if i <= half])
    second = statistics.median([x for i, x in r["steps"] if i > half])
    return (f"{name}: wall {r['wall']:.1f} s, median "
            f"{statistics.median(ms):.3f} ms, p10 {q[0]:.3f}, p90 "
            f"{q[-1]:.3f}, mean {statistics.mean(ms):.3f}; iterations "
            f"2-{half} {first:.3f}, {half + 1}-{iterations} {second:.3f}; "
            f"loss at {iterations} {r['loss'].get(iterations)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("msgs_torch ab_sharded_trainer")
    p.add_argument("a", help="a checkout holding chip_smoke.py")
    p.add_argument("b", help="the other checkout")
    p.add_argument("--iterations", type=int, default=300)
    args = p.parse_args(argv)
    a, b = os.path.abspath(args.a), os.path.abspath(args.b)
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        subprocess.run(
            [sys.executable, "-m", "msgs_torch.data.synthetic", scene],
            cwd=b, check=True, capture_output=True)
        for name, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
            print(summary(name, run(tree, scene, args.iterations),
                          args.iterations), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
