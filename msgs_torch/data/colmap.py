"""COLMAP sparse-reconstruction parsers (binary + text).

Port of msgs/data/colmap.py: `load_sparse` reads the binary files through
the native C++ readers (msgs_torch/data/native_io.py) when their library
builds, else through the struct readers here. As there, an equivalent of the reference loader (scene/colmap_loader.py:83-294):
cameras / images / points3D in both .bin and .txt flavors, PINHOLE and
SIMPLE_PINHOLE models (the only ones the reference accepts,
dataset_readers.py:88-98). Implemented directly against the public COLMAP
binary format spec with numpy bulk reads.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np

# COLMAP camera model ids → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray    # (4,) wxyz
    tvec: np.ndarray    # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)   # skip 2D points (x, y, pt3d_id)
            imgs[iid] = ColmapImage(iid, q, t, cam_id, name.decode())
    return imgs


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,))."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _pid, x, y, z, r, g, b, e = _read(f, "<Q3d3Bd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (tl,) = _read(f, "<Q")
            f.seek(8 * tl, os.SEEK_CUR)       # skip track (img_id, pt2d_idx)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    for meta in lines[::2]:
        el = meta.split()
        imgs[int(el[0])] = ColmapImage(
            int(el[0]), np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]), int(el[8]), el[9])
    return imgs


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def load_sparse(sparse_dir: str):
    """Load (cameras, images, points_xyz, points_rgb), preferring the binary
    files, read by the native readers (msgs_torch/data/native_io.py) when
    their library built, else by the struct readers."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        from msgs_torch.data import native_io
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs_native = native_io.read_images_bin(
            os.path.join(sparse_dir, "images.bin"))
        if imgs_native is not None:
            imgs = {
                int(iid): ColmapImage(
                    int(iid), imgs_native["qvec"][i], imgs_native["tvec"][i],
                    int(imgs_native["camera_id"][i]),
                    imgs_native["names"][i])
                for i, iid in enumerate(imgs_native["image_id"])}
        else:
            imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts_native = native_io.read_points3d_bin(
            os.path.join(sparse_dir, "points3D.bin"))
        if pts_native is not None:
            xyz, rgb, _ = pts_native
        else:
            xyz, rgb, _ = read_points3d_binary(
                os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        xyz, rgb, _ = read_points3d_text(
            os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, xyz, rgb
