"""Run one benchmark cell of msgs_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the set-up phases and each compared number beside its limit on
standard error, and one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`. Exits non-zero, printing no result, when no
CUDA device is present or fewer than the cell asks for, and when a module
of JAX or of the JAX package `msgs` was loaded.
"""
from __future__ import annotations

import time

_T_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# Every build and kernel cache stays inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(REPO))


def process_start() -> float:
    """The process's start on the perf_counter clock (its start time from
    /proc, in clock ticks since boot)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T_IMPORTED


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()

    import torch
    from benchmark import harness as H

    man = H.load_json(REPO / "BENCHMARK.json")
    wl = next((w for w in man["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    line = H.result_line(args.workload, args.seed, args.seconds,
                         bool(args.trace), dev, t_start)
    bad = H.forbidden_modules()
    if bad:
        print("loaded modules of JAX or its package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
