"""The benchmark's per-pixel pair count is no larger than the per-strip
count msgs_torch/tools/work.py gives kernels 3 and 4 on the same stream,
and both see the same image."""
import math

import torch

from benchmark import reference as ref
from benchmark import work as W
from benchmark.scene import base_gaussians, look_at
from msgs_torch.core.camera import make_camera
from msgs_torch.kernels import composite as comp
from msgs_torch.kernels.binning import bin_gaussians
from msgs_torch.kernels.preprocess import PreprocessOut, preprocess
from msgs_torch.kernels.rasterize import gather_payload
from msgs_torch.tools import work as port_work

CFG = dict(n_gaussians=2500, sh_degree=3, width=96, height=64, fovx_deg=60.0,
           camera_ring={"radius": 4.0}, footprint_px=4.0, scale_log_sd=0.7,
           anisotropy_log_sd=0.3, flatness=0.15, surface_jitter=0.5,
           opacity_logit=[2.0, 1.5],
           color_sd=0.12, sh_rest_sd=0.03,
           surfaces=[{"kind": "blobs", "share": 1.0, "count": 4,
                      "spread": 1.0, "radius": [0.3, 0.8],
                      "color": [0.5, 0.4, 0.3]}])


def test_pixel_pairs_within_strip_pairs():
    torch.manual_seed(0)
    g = base_gaussians(CFG, 5, "cpu")
    n = g["xyz"].shape[0]
    g.update(live=torch.ones(n, dtype=torch.bool),
             max_pixel_sizes=-torch.ones(n), min_pixel_sizes=-torch.ones(n),
             base_mask=torch.zeros(n, dtype=torch.bool))
    Wd, Hd = CFG["width"], CFG["height"]
    R, T = look_at((4.0, 0.0, 1.3), (0.0, 0.0, 0.4))
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * Hd / Wd)
    work = ref.count_work(g, ref.make_cam(R, T, fovx, fovy, Wd, Hd, "cpu"),
                          {})
    cam = make_camera(R, T, fovx, fovy, Wd, Hd, device="cpu")
    sh = torch.cat([g["features_dc"], g["features_rest"]], 1)
    q = g["rotation"] / torch.linalg.norm(g["rotation"], dim=1, keepdim=True)
    pre = preprocess(cam, g["xyz"], torch.sigmoid(g["opacity"][:, 0]),
                     shs=sh, scales=torch.exp(g["scaling"]), quats=q)
    b = bin_gaussians(PreprocessOut(*(f.detach() for f in pre)), Wd, Hd,
                      1 << 16)
    payload = gather_payload(pre, b.gauss_id, b.gid_starts).detach()
    tx, ty = (Wd + 15) // 16, (Hd + 15) // 16
    first, n_sub = comp.tile_sub_ranges(b.sub_tile, b.sub_valid,
                                        b.tile_last_sub, tx * ty)
    _, strips = port_work.saturation_work(
        (payload, first, n_sub, tx * ty, tx), Wd, Hd)
    assert work["pairs"] > 0.25 * strips * 32 * 32
    assert work["pairs"] <= strips * 32 * 32
    assert W.composite_fwd_bound_s(work) > 0
