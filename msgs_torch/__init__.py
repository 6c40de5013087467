"""msgs_torch — the msgs Gaussian-splatting renderer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Same layout and function names as the JAX package `msgs`, which stays the
reference this package is held against (tests/test_torch_*.py):

  core/     camera / SH / transform math on tensors
  kernels/  differentiable rasterizer: preprocess, binning, the gather VJP,
            prefix-scan and tile-compositor (forward and backward) kernels
            (CUDA, built at first use) beside their plain versions
  model/    Gaussian state (fields, activations, per-step statistics)
  eval/     L1, SSIM, PSNR
  data/     PLY I/O (numpy)
  train/    train_step, per-group Adam, render entry points, PLY snapshots
  tools/    experiment scripts (the row-gather layouts, the pair-math
            formulations), run with -m

Entry points take `device=None`, meaning the CUDA device; they raise when no
GPU is present and run on the CPU only when the caller passes
`device="cpu"`. Kernel wrappers launch their CUDA kernel for a CUDA tensor
and use the plain PyTorch version only for a CPU tensor.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Counterpart of msgs/__init__.py's "highest" matmul precision: reduced
# precision (TF32 here, bf16 on the TPU) quantizes camera projections,
# covariance products and SH evaluation.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# torch's CPU exp is MKL's vector exp, called by each OpenMP thread on its
# share. The first such call of a process has come out with ~13-bit
# accuracy in one thread's whole share (13 of 320 fresh processes at 32
# threads); after a first call on the calling thread alone, below torch's
# parallel grain, it has not (0 of 320; tests/test_torch_mxu.py, the
# program of test_first_cpu_exp_after_import_is_right without and with
# this import). So the package makes that call here.
torch.exp(torch.zeros(1024))


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device. Raises if a CUDA device is asked for
    and none is present; the CPU is used only when named explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "msgs_torch: no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    return dev
