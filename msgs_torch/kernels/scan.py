"""Multi-row inclusive prefix sum: the CUDA scan kernel and its plain version.

Port of the contract of msgs/kernels/scan.py:cumsum_perm. The TPU kernel
scans rows stored in a sublane-major permuted layout (perm_iota) to avoid
TPU transposes; here rows are (R, E) tensors in logical order, and binning
scatters at logical positions. The kernel (msgs_torch/csrc/scan.cu) takes
float32 (exact for integer values while every partial sum stays below 2^24,
as on the TPU) and int32 (exact to 2^31, wrapping mod 2^32 in between).
It is one launch per call, a single-pass scan with decoupled look-back whose
tickets and status words are kept per device and stream (`LookbackState`),
so a call allocates only its output.
"""
from __future__ import annotations

import torch

from msgs_torch.kernels import _build

_CHUNK = 4096          # elements per CTA in scan.cu
EPOCHS = 1 << 30       # scan.cu's status words carry a 30-bit epoch


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: torch.cumsum along the last axis, keeping the dtype
    (torch.cumsum of int32 returns int64 unless told otherwise)."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


class LookbackState:
    """The scan's scratch on one stream: a ticket counter per row (int32)
    and a status word per chunk (int64), each zero when allocated and
    grown, zeroed, when a shape needs more; and the epoch of the last
    call. The kernel leaves every ticket at 0, and each call takes a new
    epoch, so the kernel reads the words of earlier calls as not ready and
    needs no memset; at `limit` epochs the words are zeroed once and the
    count starts again at 1. A CUDA graph capture would freeze the epoch
    of one call into every replay, which would then read the words of the
    replay before as ready: `cumsum_rows` refuses to be captured."""

    def __init__(self, device, limit: int = EPOCHS):
        self.device = torch.device(device)
        self.limit = limit
        self.tickets = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.status = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.epoch = 0

    def take(self, rows: int, length: int):
        """(tickets, status words, epoch) for one (rows, length) call."""
        if self.tickets.numel() < rows:
            self.tickets = torch.zeros(rows, dtype=torch.int32,
                                       device=self.device)
        words = rows * -(-length // _CHUNK)
        if self.status.numel() < words:
            self.status = torch.zeros(words, dtype=torch.int64,
                                      device=self.device)
        self.epoch += 1
        if self.epoch == self.limit:
            self.status.zero_()
            self.epoch = 1
        return self.tickets, self.status, self.epoch


_states: dict = {}     # (device index, stream) → LookbackState
_entries = {torch.float32: ("msgs_scan_f32", "scan_f32"),
            torch.int32: ("msgs_scan_i32", "scan_i32")}


def _cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cumsum_rows: the scan cannot be captured in a "
                           "CUDA graph (its epoch is a launch argument, so "
                           "every replay would reuse one)")
    lib = _build.load()
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    x2 = x2.contiguous()
    R, E = x2.shape
    out = torch.empty_like(x2)
    stream = _build.stream_ptr(x2)
    key = (x2.get_device(), stream)
    state = _states.get(key)
    if state is None:
        state = _states[key] = LookbackState(x2.device)
    tickets, status, epoch = state.take(R, E)
    entry, name = _entries[x2.dtype]
    _build.check(getattr(lib, entry)(
        x2.data_ptr(), out.data_ptr(), tickets.data_ptr(), status.data_ptr(),
        R, E, epoch, stream), name)
    _build.launch_counts[name] += 1
    return out if x2 is x else out.view(x.shape)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of a float32 or int32
    tensor, in the input's dtype. A CUDA tensor goes through the CUDA
    kernel, a CPU tensor through the plain version."""
    if x.dtype not in _entries:
        raise TypeError(f"cumsum_rows takes float32 or int32, not {x.dtype}")
    if x.is_cuda:
        if x.numel() == 0:
            return x.clone()
        return _cumsum_cuda(x)
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    raise ValueError(f"cumsum_rows: unsupported device {x.device}")
