"""Scene loading: COLMAP & Blender(NeRF-synthetic) readers, eval split,
scene normalization, and the multi-resolution camera pyramid.

Capability-parity with the reference scene/data layer (SURVEY.md §2.6):
  - readColmapSceneInfo / readNerfSyntheticInfo (dataset_readers.py:135-280)
  - nerf++-style normalization: radius = 1.1 × max camera-to-centroid
    distance (dataset_readers.py:48-69) → `cameras_extent`
  - eval split: every 8th camera (llffhold=8, dataset_readers.py:151-153)
  - resize rule (camera_utils.py:22-39): -r ∈ {1,2,4,8} →
    round(orig/(reso_scale·r)); -r=-1 → cap width at 1600 then ÷reso_scale
  - multi-resolution pyramid: one camera list per resolution scale with
    consistent cross-scale ordering (scene/__init__.py:87-94)

Port of msgs/data/dataset.py. Images are decoded and resized by
msgs_torch/data/image.py (a copy of Pillow's resize, bit-identical to the
JAX package's PIL path) and stay host-side numpy; the trainer caches each
sampled (view, scale) on the device. The on-disk pyramid cache lives in
`msgs_torch_cache/` beside the images, apart from the JAX package's
`msgs_cache/`. `ViewInfo.camera` builds the port's Camera on the view's
`device` (None: the CUDA device).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from msgs_torch.core.camera import Camera, focal2fov, fov2focal, make_camera
from msgs_torch.data.colmap import load_sparse, qvec2rotmat
from msgs_torch.data.image import image_size, read_image, resize

CACHE_DIR = "msgs_torch_cache"


@dataclass
class ViewInfo:
    """Host-side per-view record; `camera(scale)` and `image(scale)` realize
    the pyramid lazily with caching."""
    uid: int
    R: np.ndarray            # (3,3) cam→world rotation
    T: np.ndarray            # (3,) world→cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int               # full-res (after -r) width
    height: int
    white_background: bool = False
    cache_dir: Optional[str] = None   # on-disk resized-image pyramid cache
    device: object = None             # where camera() puts its tensors
    _cache: dict = field(default_factory=dict)

    def resolution(self, scale: float) -> Tuple[int, int]:
        return (max(round(self.width / scale), 1),
                max(round(self.height / scale), 1))

    def camera(self, scale: float = 1.0) -> Camera:
        key = ("cam", scale)
        if key not in self._cache:
            w, h = self.resolution(scale)
            self._cache[key] = make_camera(self.R, self.T, self.fovx,
                                           self.fovy, w, h,
                                           device=self.device)
        return self._cache[key]

    def _resized_uint8(self, scale: float) -> np.ndarray:
        """Decode + resize, with an on-disk .npy cache in the source dir —
        the analogue of the reference's camera-pyramid pickle cache
        (scene/__init__.py:67-101): cold-starting a 300-view scene at 8
        scales re-decodes/resizes thousands of images otherwise. Cached
        pre-alpha-composite uint8 (compact; compositing is cheap). Stale
        entries (source newer than cache) are rebuilt."""
        w, h = self.resolution(scale)
        cpath = None
        if self.cache_dir:
            # Key on the image's path relative to its scene, not its
            # basename: Blender scenes name frames train/r_0.png AND
            # test/r_0.png — a basename key would collide the splits onto
            # one cache file and silently serve train pixels as test GT.
            # Path separators flatten to '_' so the cache dir stays flat
            # (COLMAP image names may contain subdirectories).
            rel = os.path.splitext(
                os.path.relpath(self.image_path,
                                os.path.dirname(self.cache_dir)))[0]
            slug = rel.replace(os.sep, "_").replace("..", "up")
            cpath = os.path.join(self.cache_dir, f"{slug}_{w}x{h}.npy")
            try:
                if (os.path.exists(cpath) and os.path.getmtime(cpath)
                        >= os.path.getmtime(self.image_path)):
                    return np.load(cpath)
            except Exception:
                pass
        arr = resize(read_image(self.image_path), (w, h))
        if cpath:
            try:
                os.makedirs(self.cache_dir, exist_ok=True)
                # np.save APPENDS '.npy' when given a bare filename — write
                # through an opened handle so the tmp name is exact, then
                # atomically publish (a failed mid-write never corrupts).
                tmp = cpath + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.save(f, arr)
                os.replace(tmp, cpath)
            except Exception:
                pass
        return arr

    def image(self, scale: float = 1.0) -> np.ndarray:
        """GT image at pyramid scale, (H, W, 3) float32 in [0,1]."""
        key = ("img", scale)
        if key not in self._cache:
            arr = self._resized_uint8(scale).astype(np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, -1)
            if arr.shape[-1] == 4:
                rgb, a = arr[..., :3], arr[..., 3:]
                bg = 1.0 if self.white_background else 0.0
                arr = rgb * a + bg * (1 - a)
            self._cache[key] = arr[..., :3]
        return self._cache[key]

    def drop_cache(self):
        self._cache = {k: v for k, v in self._cache.items() if k[0] == "cam"}


@dataclass
class SceneData:
    train_views: List[ViewInfo]
    test_views: List[ViewInfo]
    points: np.ndarray          # (N,3)
    colors: np.ndarray          # (N,3) in [0,1]
    cameras_extent: float
    source_path: str


def _nerf_norm_radius(views: List[ViewInfo]) -> float:
    """nerf++ normalization (dataset_readers.py:48-69): 1.1 × max distance
    from any camera center to the centroid of camera centers."""
    centers = []
    for v in views:
        W2C = np.eye(4)
        W2C[:3, :3] = v.R.T
        W2C[:3, 3] = v.T
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3])
    centers = np.stack(centers)
    centroid = centers.mean(axis=0)
    diag = np.linalg.norm(centers - centroid, axis=1).max()
    return float(diag * 1.1)


def _apply_r_flag(width: int, height: int, r: int) -> Tuple[int, int]:
    """The reference -r downscale flag (camera_utils.py:22-39) applied once
    at load: explicit factor, or -1 → cap width at 1600."""
    if r in (1, 2, 4, 8):
        return round(width / r), round(height / r)
    if r == -1:
        if width > 1600:
            gd = width / 1600
            return round(width / gd), round(height / gd)
        return width, height
    return round(width / r), round(height / r)


def load_colmap_scene(source_path: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8,
                      resolution: int = -1,
                      white_background: bool = False,
                      disk_cache: bool = True, device=None) -> SceneData:
    cache_dir = os.path.join(source_path, CACHE_DIR) if disk_cache \
        else None
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, xyz, rgb = load_sparse(sparse)

    views = []
    for iid in sorted(imgs, key=lambda i: imgs[i].name):
        im = imgs[iid]
        cam = cams[im.camera_id]
        R = qvec2rotmat(im.qvec).T       # store cam→world (reference convention)
        T = im.tvec
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; undistort "
                f"with `convert` first (reference supports PINHOLE only)")
        fovx = focal2fov(fx, cam.width)
        fovy = focal2fov(fy, cam.height)
        w, h = _apply_r_flag(cam.width, cam.height, resolution)
        views.append(ViewInfo(
            uid=len(views), R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=os.path.join(source_path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0], width=w, height=h,
            white_background=white_background, cache_dir=cache_dir,
            device=device))

    if eval_split:
        train = [v for i, v in enumerate(views) if i % llffhold != 0]
        test = [v for i, v in enumerate(views) if i % llffhold == 0]
    else:
        train, test = views, []
    extent = _nerf_norm_radius(train)
    return SceneData(train, test, xyz.astype(np.float32),
                     rgb.astype(np.float32) / 255.0, extent, source_path)


def load_blender_scene(source_path: str, white_background: bool = False,
                       eval_split: bool = True,
                       resolution: int = -1,
                       disk_cache: bool = True, device=None) -> SceneData:
    """NeRF-synthetic transforms_{train,test}.json
    (dataset_readers.py:182-280): OpenGL→COLMAP axis flip, random 100k-point
    init inside [-1.3, 1.3]³."""
    def read_split(name) -> List[ViewInfo]:
        path = os.path.join(source_path, f"transforms_{name}.json")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        cache_dir = os.path.join(source_path, CACHE_DIR) if disk_cache \
            else None
        out = []
        for fr in meta["frames"]:
            c2w = np.array(fr["transform_matrix"])
            c2w[:3, 1:3] *= -1           # OpenGL → COLMAP camera axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_path = os.path.join(source_path, fr["file_path"] + ".png")
            if not os.path.exists(img_path):
                img_path = os.path.join(source_path, fr["file_path"])
            width, height = image_size(img_path)
            w, h = _apply_r_flag(width, height, resolution)
            fovy = focal2fov(fov2focal(fovx, width), height)
            out.append(ViewInfo(
                uid=len(out), R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=img_path,
                image_name=os.path.splitext(os.path.basename(img_path))[0],
                width=w, height=h, white_background=white_background,
                cache_dir=cache_dir, device=device))
        return out

    train = read_split("train")
    test = read_split("test")
    if not eval_split:
        # With eval off the reference folds the test frames into the train
        # set (dataset_readers.py:252-254) — they are extra training views,
        # not withheld.
        import dataclasses
        for v in test:
            train.append(dataclasses.replace(v, uid=len(train)))
        test = []
    init_npz = os.path.join(source_path, "init_points.npz")
    if os.path.exists(init_npz):
        # Synthetic scenes may ship an SfM-like init cloud.
        data = np.load(init_npz)
        pts = data["points"].astype(np.float32)
        cols = data["colors"].astype(np.float32)
    else:
        rng = np.random.default_rng(0)
        n_pts = 100_000
        pts = (rng.random((n_pts, 3)).astype(np.float32) * 2.6 - 1.3)
        cols = rng.random((n_pts, 3)).astype(np.float32)
    extent = _nerf_norm_radius(train)
    return SceneData(train, test, pts, cols, extent, source_path)


def load_scene(source_path: str, **kw) -> SceneData:
    """Auto-detect COLMAP (sparse/) vs Blender (transforms_train.json) —
    scene/__init__.py:44-51. `device` is where the views' cameras live."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        kw.pop("blender_eval", None)
        return load_colmap_scene(source_path, **kw)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        kw.pop("images_dir", None)
        kw.pop("llffhold", None)
        return load_blender_scene(source_path, **kw)
    raise ValueError(f"unrecognized scene layout at {source_path}")
