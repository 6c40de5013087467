"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: the program as it is comes out correct; the timed path
broken underneath (a planted fault) or replaced by the lower-precision
control comes out not correct."""
import pytest

import tiny
from benchmark import check

FAULTS = {"msgs-m360.train": ["unchanged", "half_batch", "control"],
          "msgs-m360.zoom": ["shifted", "half_batch", "control"],
          "3dgs-db.render": ["shifted", "half_batch", "control"]}


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_the_program_is_correct(workload):
    line = tiny.run(workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload,mode", [(w, m) for w, ms in FAULTS.items()
                                           for m in ms])
def test_a_broken_path_is_not_correct(workload, mode):
    kind = "train" if workload.endswith("train") else "render"
    restore = check.plant(mode, kind)
    try:
        line = tiny.run(workload)
    finally:
        restore()
    assert not line["correct"], line["checks"]
