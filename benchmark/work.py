"""The yardstick's arithmetic: the H100's peaks, the operations and bytes a
render or a training step needs on its inputs (counted by the reference's
`count_work`, whatever kernel does the work), and the shares of the peak
and of a kernel's roofline the per-layer metrics report.

Operations are fp32 adds, multiplies, compares and the like, one each; a
divide or a square root one; an exp four, as msgs_torch/tools/work.py
counts them. The compositor's operations per (pixel, entry) pair are that
file's plain-version counts, frozen here: 41 forward, 67 backward with the
image's three colour cotangents only.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

FWD_OPS_PER_PAIR = 41
BWD_OPS_PER_PAIR = 67
# An entry's compositor inputs: mean (2), conic (3), opacity, colour (3).
ENTRY_BYTES = 9 * 4
# Forward output per pixel: colour (3), depth, footprint, transmittance.
FWD_PIXEL_OUT_BYTES = 6 * 4
# Backward input per pixel: the colour cotangent (3), the forward colour
# (3) and final transmittance; output: an entry's 9 gradients.
BWD_PIXEL_IN_BYTES = 7 * 4

# Per live Gaussian and render, forward: quaternion normalisation 12, its
# rotation 30, exp of the scales 12, R·S 9, Σ = (RS)(RS)ᵀ 30, the view
# transform 18, the pixel mean 8, the Jacobian and its clamps 12, J·W 30,
# (JW)Σ(JW)ᵀ 45, dilation, determinant, inverse, eigenvalue, radius and
# footprint 30, the view direction 12, the degree-3 basis 35, colour 96
# and its clamp 6, the opacity sigmoid 6, the MS weights 10, the tile
# rectangle 20.
PREPROCESS_OPS = 12 + 30 + 12 + 9 + 30 + 18 + 8 + 12 + 30 + 45 + 30 \
    + 12 + 35 + 96 + 6 + 6 + 10 + 20                            # 421
# Its backward: twice the differentiable part (all but the rectangle).
PREPROCESS_BWD_OPS = 2 * (PREPROCESS_OPS - 20)                   # 802
# Summing an entry's 9 gradients into its Gaussian's row.
GATHER_BWD_OPS_PER_ENTRY = 9
# L1 and SSIM per pixel: five separable 11-tap windows per channel (44
# each), the three products and SSIM's formula (20 a channel), L1 (9);
# the backward: the windows of img, img² and img·gt transposed (3 × 44 a
# channel), the elementwise chain (25 a channel) and L1 (3).
LOSS_OPS_PER_PIXEL = 5 * 3 * 44 + 3 * 20 + 9 + 3 * 3 * 44 + 3 * 25 + 3
# Adam per parameter: both moments (7), bias corrections (2), the square
# root, ε, the divide, the learning rate and the update (5).
ADAM_OPS = 14
# Learned floats per Gaussian: xyz 3, DC 3, degree-3 rest 45, scales 3,
# quaternion 4, opacity 1.
PARAMS_PER_GAUSSIAN = 59


def render_ops(work: dict) -> float:
    """Operations one render needs (forward only)."""
    return work["pairs"] * FWD_OPS_PER_PAIR + work["live"] * PREPROCESS_OPS


def step_ops(work: dict) -> float:
    """Operations one training step needs: the render, the loss, both
    backward passes, Adam."""
    return (work["pairs"] * (FWD_OPS_PER_PAIR + BWD_OPS_PER_PAIR)
            + work["live"] * (PREPROCESS_OPS + PREPROCESS_BWD_OPS)
            + work["entries_read"] * GATHER_BWD_OPS_PER_ENTRY
            + work["pixels"] * LOSS_OPS_PER_PIXEL
            + work["live"] * PARAMS_PER_GAUSSIAN * ADAM_OPS)


def composite_fwd_bound_s(work: dict) -> float:
    """Least time of the forward compositor on these inputs: the larger of
    its operations at the fp32 peak and its bytes at the HBM peak."""
    ops = work["pairs"] * FWD_OPS_PER_PAIR
    nbytes = (work["entries_read"] * ENTRY_BYTES
              + work["pixels"] * FWD_PIXEL_OUT_BYTES)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def composite_bwd_bound_s(work: dict) -> float:
    """Least time of the image-only backward compositor."""
    ops = work["pairs"] * BWD_OPS_PER_PAIR
    nbytes = (2 * work["entries_read"] * ENTRY_BYTES
              + work["pixels"] * BWD_PIXEL_IN_BYTES)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def share_pct(bound_s, measured_s):
    """100 · Σ bound / Σ measured, or None when nothing was measured."""
    if not measured_s or sum(measured_s) <= 0:
        return None
    return 100.0 * sum(bound_s) / sum(measured_s)
