"""Build and load the CUDA kernels of msgs_torch/csrc.

Each `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a`, then linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in `build/msgs_torch/` at
the repository root, named by a hash of the sources and flags, so an edit to
any source rebuilds and an unchanged tree reuses the last build. Nothing is
built when the module is imported: the first kernel launch builds.

`-fmad=false` keeps every multiply and add separately rounded, as the plain
PyTorch versions (one op per kernel) round them; the kernels then agree with
their plain versions to the last bit wherever they sum in the same order.

Every kernel wrapper counts its launches in `launch_counts`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "msgs_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

# name → number of launches of that kernel in this process
launch_counts = {"scan_f32": 0, "scan_i32": 0, "composite_fwd": 0,
                 "composite_bwd": 0, "composite_bwd_bf16": 0,
                 "gather_rows": 0, "mxu_probe": 0, "fwd_ablate": 0,
                 "bwd_ablate": 0, "diff_hist_smem": 0,
                 "diff_hist_global": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (x, out, tickets, status words, rows, length, epoch, stream)
    "msgs_scan_f32": [_P, _P, _P, _P, _I, ctypes.c_longlong, ctypes.c_uint,
                      _P],
    "msgs_scan_i32": [_P, _P, _P, _P, _I, ctypes.c_longlong, ctypes.c_uint,
                      _P],
    # (int32 instance or image_only, int out[5]): the kernel's registers,
    # stack, static and dynamic shared memory, CTAs per SM
    "msgs_scan_info": [_I, _P],
    "msgs_composite_fwd_info": [_I, _P],
    "msgs_composite_bwd_info": [_I, _P],
    "msgs_composite_bwd_bf16_info": [_I, _P],
    # (ablate.ALL_FWD index, or len(ALL_FWD) for the running sum; ablate.
    #  BWD_INSTANCES index)
    "msgs_fwd_ablate_info": [_I, _P],
    "msgs_bwd_ablate_info": [_I, _P],
    # (payload, first_sub, n_sub, out, tiles, tiles_x, width, height, stream)
    "msgs_composite_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (payload, first_sub, n_sub, res, cot, dpay, tiles, tiles_x, width,
    #  height, image_only, stream)
    "msgs_composite_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "msgs_composite_bwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P],
    # (gather.GATHER_INSTANCES index; probe instance index, kernels/
    #  mxu_probe.py:PROBE_INSTANCES)
    "msgs_gather_rows_info": [_I, _P],
    "msgs_mxu_probe_info": [_I, _P],
    # (table, gid, out, work, rows, F, E, feat_table, block, stream)
    "msgs_gather_rows": [_P, _P, _P, _P, ctypes.c_longlong, _I,
                         ctypes.c_longlong, _I, ctypes.c_longlong, _P],
    # (payload, g_rows, out, df_out, partial, partial slots, tickets, B,
    #  variant, high, per_block, stream)
    "msgs_mxu_probe": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    # (SMs, int out[2]): the probe's partial slots and ticket words
    "msgs_mxu_probe_scratch": [_I, _P],
    # (payload, sub_tile, sub_valid, out, written, partial, n_blocks,
    #  variant, tiles, tiles_x, width, height, stream)
    "msgs_fwd_ablate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (payload, sub_tile, sub_valid, cst, dpay, n_blocks, instance (ablate.
    #  BWD_INSTANCES), tiles, tiles_x, width, height, stream)
    "msgs_bwd_ablate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (descriptor pointers, form, rows, ystride, ny, nx, out, int* path,
    #  stream)
    "msgs_diff_hist": [_P, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                       _P, _P, _P],
    # (instance: shared bands | shared corners | global bands | global
    #  corners, grid cells, int out[5])
    "msgs_diff_hist_info": [_I, _I, _P],
}

_lib = None
build_info: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("msgs_torch: nvcc not found; the CUDA kernels are "
                       "built with the CUDA toolkit's nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmsgs_torch_{h.hexdigest()[:16]}.so"


def _compile(so: Path):
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{cu.stem}.{so.stem}.{tag}.o" for cu in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(cu), "-o",
                               str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cu, o in zip(cus, objs)]
    logs = []
    for cu, p in zip(cus, procs):
        out, _ = p.communicate()
        logs.append(f"== {cu.name} (rc {p.returncode})\n{out}")
    log = "\n".join(logs)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"msgs_torch: nvcc failed\n{log}")
    tmp = so.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"msgs_torch: nvcc link failed\n"
                           f"{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(log)


def load():
    """The loaded kernel library; builds it first if the sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    built = not so.exists()
    if built:
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.msgs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msgs_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0)
    log = so.with_suffix(".log")
    if log.exists():
        build_info["log"] = log.read_text()
    _lib = lib
    return lib


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = _lib.msgs_cuda_error_string(err).decode()
        raise RuntimeError(f"msgs_torch: {what} failed: CUDA error {err} "
                           f"({msg})")


def kernel_info(entry: str, *args: int) -> dict:
    """A kernel's build as the card's runtime reports it (`msgs_*_info`
    entries, given their int arguments): registers a thread, stack (local)
    bytes, static and dynamic shared memory a CTA, and CTAs per SM at its
    launch configuration."""
    lib = load()
    out = (ctypes.c_int * 5)()
    check(getattr(lib, entry)(*args, ctypes.addressof(out)), entry)
    return dict(zip(("registers", "stack_bytes", "static_smem",
                     "dynamic_smem", "ctas_per_sm"), out))


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as the handle a kernel is
    launched on. The raw getter builds no Stream object: it is on every
    launch's host path."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
