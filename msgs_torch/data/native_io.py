"""ctypes bindings for the native I/O library (msgs_torch/native/colmap_io.cpp).

Port of msgs/data/native_io.py, with the port's own copy of the C++ source.
The library is built on first use with g++ into build/msgs_torch/native/ at
the repository root, named by a hash of the source and the flags (an edited
source rebuilds, an unchanged one reuses the last build), and compiled to a
temporary name that is then renamed into place, so processes that build at
once each load a whole library. When the build fails every reader returns
None, as the JAX module's do, and `build_error` keeps the compiler's
message. data/colmap.py:load_sparse tries these readers first and falls
back to its struct readers.

The points reader rounds xyz and err to float32 in C++ and widens them to
float64 here, as the JAX module does; the struct readers keep float64.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "colmap_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "msgs_torch" / \
    "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Why the library is unavailable (the compiler's output, or the error that
# stopped the build or the load); None while it is available or untried.
build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmsgs_io_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    global build_error
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"g++ did not run: {e!r}"
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        build_error = f"g++ exited {r.returncode}\n{r.stdout}{r.stderr}"
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first where needed; None if it cannot be
    built or loaded (the reason is in `build_error`)."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            build_error = f"{SRC} is missing"
            return None
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            build_error = f"{so} did not load: {e}"
            return None

        P = ctypes.POINTER
        lib.msgs_free.argtypes = [ctypes.c_void_p]
        lib.msgs_read_points3d_bin.argtypes = [
            ctypes.c_char_p, P(P(ctypes.c_float)), P(P(ctypes.c_uint8)),
            P(P(ctypes.c_float)), P(ctypes.c_int64)]
        lib.msgs_read_images_bin.argtypes = [
            ctypes.c_char_p, P(P(ctypes.c_double)), P(P(ctypes.c_double)),
            P(P(ctypes.c_int32)), P(P(ctypes.c_int32)), P(ctypes.c_char_p),
            P(ctypes.c_int64), P(ctypes.c_int64)]
        lib.msgs_read_ply_f32.argtypes = [
            ctypes.c_char_p, P(P(ctypes.c_float)), P(ctypes.c_char_p),
            P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_int64)]
        build_error = None
        _lib = lib
        return _lib


def _take(ptr, shape, dtype, lib):
    """Copy a malloc'd buffer into numpy and free it."""
    n = int(np.prod(shape))
    ctype = np.ctypeslib.as_ctypes_type(dtype)
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(n,)).copy()
    lib.msgs_free(ptr)
    return arr.reshape(shape).astype(dtype, copy=False)


def _take_names(ptr, length, count, lib):
    """The first `count` NUL-separated names of a malloc'd blob, freed."""
    blob = ctypes.string_at(ptr, length)
    lib.msgs_free(ctypes.cast(ptr, ctypes.c_void_p))
    return blob.decode().split("\0")[:count]


def read_points3d_bin(path: str
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """points3D.bin as (xyz (N, 3) f64, rgb (N, 3) u8, err (N,) f64), xyz
    and err rounded through float32; None without the library or on a
    malformed file."""
    lib = get_lib()
    if lib is None:
        return None
    xyz_p = ctypes.POINTER(ctypes.c_float)()
    rgb_p = ctypes.POINTER(ctypes.c_uint8)()
    err_p = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.msgs_read_points3d_bin(
        path.encode(), ctypes.byref(xyz_p), ctypes.byref(rgb_p),
        ctypes.byref(err_p), ctypes.byref(n))
    if rc != 0:
        return None
    n = n.value
    xyz = _take(xyz_p, (n, 3), np.float32, lib)
    rgb = _take(rgb_p, (n, 3), np.uint8, lib)
    err = _take(err_p, (n,), np.float32, lib)
    return xyz.astype(np.float64), rgb, err.astype(np.float64)


def read_images_bin(path: str) -> Optional[dict]:
    """images.bin as {qvec (N, 4), tvec (N, 3), camera_id, image_id,
    names}, in file order; None without the library or on a malformed
    file."""
    lib = get_lib()
    if lib is None:
        return None
    q_p = ctypes.POINTER(ctypes.c_double)()
    t_p = ctypes.POINTER(ctypes.c_double)()
    cam_p = ctypes.POINTER(ctypes.c_int32)()
    img_p = ctypes.POINTER(ctypes.c_int32)()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    n = ctypes.c_int64()
    rc = lib.msgs_read_images_bin(
        path.encode(), ctypes.byref(q_p), ctypes.byref(t_p),
        ctypes.byref(cam_p), ctypes.byref(img_p), ctypes.byref(names_p),
        ctypes.byref(names_len), ctypes.byref(n))
    if rc != 0:
        return None
    n = n.value
    return {"qvec": _take(q_p, (n, 4), np.float64, lib),
            "tvec": _take(t_p, (n, 3), np.float64, lib),
            "camera_id": _take(cam_p, (n,), np.int32, lib),
            "image_id": _take(img_p, (n,), np.int32, lib),
            "names": _take_names(names_p, names_len.value, n, lib)}


def read_ply_f32(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The vertex element of a binary little-endian PLY whose properties
    are float, double or uchar, every column as float32 (the Gaussian
    model schema); None without the library or for another layout."""
    lib = get_lib()
    if lib is None:
        return None
    data_p = ctypes.POINTER(ctypes.c_float)()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    n = ctypes.c_int64()
    n_props = ctypes.c_int64()
    rc = lib.msgs_read_ply_f32(
        path.encode(), ctypes.byref(data_p), ctypes.byref(names_p),
        ctypes.byref(names_len), ctypes.byref(n), ctypes.byref(n_props))
    if rc != 0:
        return None
    n, n_props = n.value, n_props.value
    data = _take(data_p, (n, n_props), np.float32, lib)
    names = _take_names(names_p, names_len.value, n_props, lib)
    return {name: data[:, i] for i, name in enumerate(names)}
