"""Store and broadcast forms of the compositor backward: the port of
tools/exp_bwd3.py.

    python -m msgs_torch.tools.exp_bwd3 [--device cpu] [--blocks K]

The JAX script times exp_bwd2's geom_vpu backward with three flags:
catstore (the nine gradient columns stored as one row), nozero (dpay
zeroed only in dead blocks instead of before every step) and nogrows (the
per-sub constants broadcast implicitly instead of as materialised
(BLOCK, NPIX) rows), in five runs: colstore (none), catstore, nozero,
nogrows and all. Here each run is csrc/bwd_ablate.cu's `full` in its
form (msgs_torch/kernels/ablate.py: bwd_ablate, BWD3_RUNS). A thread per
pixel holds the per-sub constants in registers in every form, so nogrows
is colstore's form, and `all` catstore + nozero's. A form that leaves
dpay's zeroing to the caller zeroes it in its timed call, so nozero
against colstore is the cost of the double write. Scene, stream, checks,
timing and records as msgs_torch/tools/exp_bwd2.py (the same module
runs them); the runs print as the script prints them (`<name>: <ms> ms`).
"""
from __future__ import annotations

import sys

from msgs_torch.kernels import ablate
from msgs_torch.tools import exp_bwd2


def main(argv=None) -> list:
    env = exp_bwd2.setup(argv, __doc__.splitlines()[0])
    print("=== bwd store/broadcast variants ===", flush=True)
    return exp_bwd2.bwd_records(env, ablate.BWD3_RUNS)


if __name__ == "__main__":
    main(sys.argv[1:])
