"""The pair-math probe's work table (msgs_torch/tools/work.py) on the CPU:
one table of operations per pair for the probe kernel (csrc/mxu_probe.cu),
read by chip_smoke.py and the ported tool; a count for every run; the
bound and the issue floor computed from it; and the kernel's instance
index, which the card's [build] lines and tests read.
"""
import pytest

import chip_smoke
from msgs_torch.kernels import mxu_probe
from msgs_torch.tools import exp_mxu, work


def test_probe_and_tools_read_one_table():
    """The tool keeps no count, peak or bound of its own; chip_smoke.py
    takes the same objects from work.py."""
    for name in ("OPS_PER_PAIR", "TC_FLOPS_PER_PAIR", "PEAK_BYTES",
                 "PEAK_FP32", "PEAK_TF32", "bound", "_POWER", "_ALPHA"):
        assert not hasattr(exp_mxu, name), name
    assert exp_mxu.work is work
    for name in ("PROBE_OPS", "PROBE_PAIRS_PER_PASS", "issue_floor_ms",
                 "PEAK_BYTES", "PEAK_FP32"):
        assert getattr(chip_smoke, name) is getattr(work, name), name


def test_every_run_has_a_count():
    """Each of the script's 12 runs has an operation count, each matmul
    variant a tensor-core count; HIGH moves work off the CUDA cores for
    pow_mxu, acc_tn and dfeat_nt and adds the split for scan_mxu."""
    assert set(exp_mxu.RUNS) == set(work.PROBE_OPS)
    assert set(work.PROBE_TC_FLOPS) == set(mxu_probe.MATMUL_VARIANTS)
    ops = work.PROBE_OPS
    assert ops["empty", None] == 0
    assert ops["base", None] == 38 and ops["exp2", None] == 37
    for v in ("pow_mxu", "acc_tn", "dfeat_nt"):
        assert ops[v, "HIGH"] < ops[v, "HIGHEST"], v
    assert ops["scan_mxu", "HIGH"] == ops["scan_mxu", "HIGHEST"] + 2


@pytest.mark.parametrize("variant,precision", sorted(
    set(exp_mxu.RUNS), key=exp_mxu.RUNS.index))
def test_probe_bound_takes_the_largest(variant, precision):
    B = 14336
    b = work.probe_bound(variant, precision, B)
    pairs = B * 128 * 256
    nbytes = B * 128 * 16 * 4 + 8 * 256 * 4 + (
        8 * 256 * 4 if variant == "dfeat_nt" else 0)
    times = {"bytes": nbytes / work.PEAK_BYTES * 1e3,
             "operations": pairs * work.PROBE_OPS[variant, precision]
             / work.PEAK_FP32 * 1e3,
             "tensor cores": pairs * work.PROBE_TC_FLOPS.get(variant, 0)
             / work.PEAK_TF32 * 1e3 if precision == "HIGH" else 0.0}
    assert b["bound_by"] == max(times, key=times.get)
    assert b["bound_ms"] == pytest.approx(max(times.values()))
    assert b["tc_ms"] == pytest.approx(times["tensor cores"])
    assert b["pairs"] == pairs
    assert b["bound_by"] == ("bytes" if variant == "empty"
                             else "operations")


def test_issue_floor_arithmetic():
    """pairs × instructions / (SMs × schedulers × 32 lanes × clock)."""
    lanes = work.SMS * work.SCHEDULERS * work.WARP
    assert (work.SMS, work.SCHEDULERS, work.WARP) == (132, 4, 32)
    assert work.issue_floor_ms(1, lanes * 1000, clock_hz=1e6) == \
        pytest.approx(1.0)
    assert work.issue_floor_ms(2.5, lanes * 1000, clock_hz=2e6) == \
        pytest.approx(1.25)
    # The default clock is the card's clocks.max.sm, 1,980 MHz.
    assert work.issue_floor_ms(56, 469_762_048) == pytest.approx(
        469_762_048 * 56 / (lanes * 1.98e9) * 1e3)
    assert work.PROBE_PAIRS_PER_PASS == 64


def test_probe_instances_follow_the_kernels_index():
    """22 instances (3 variants without a matmul and 4 with two precisions,
    each summed and per block), numbered 4·variant + 2·HIGH + per_block as
    msgs_mxu_probe_info decodes them."""
    inst = mxu_probe.PROBE_INSTANCES
    assert len(inst) == len(set(inst)) == 22
    idx = [mxu_probe.instance_index(*i) for i in inst]
    assert idx == sorted(idx) and len(set(idx)) == 22
    for (v, p, pb), i in zip(inst, idx):
        assert i >> 2 == mxu_probe.VARIANTS.index(v)
        assert (i >> 1) & 1 == (p == "HIGH") and i & 1 == pb
    assert {(v, p) for v, p, _ in inst} == set(exp_mxu.RUNS)
