"""Scenes made from a seed, at the size of a trained model: the Gaussians,
the views, and (for an MS-GS configuration) the records and aggregates a
trained MS-GS model holds.

A configuration file (benchmark/configs/<name>.json) gives every size and
distribution. Gaussians lie on surfaces seen from a ring of cameras
(`surfaces`: a ground disk, blobs standing on it, a far shell, the walls of
a room), flattened along the surface normal and set off it by a share of their
size (`surface_jitter`), with log-normal scales whose
median covers `footprint_px` pixels at ×1 from a typical camera distance,
opacities sigmoid(N(μ, σ)), colours around each surface's base colour and
small SH rest bands. The views are fixed by the configuration alone, so
every seed renders the same cameras; the seed draws the Gaussians, in a
few large calls of a `torch.Generator` on the device.

MS-GS fields (method "ms"): a base row's `min_pixel_sizes` is its smallest
×1 footprint over the training views that see it (`max_pixel_sizes`
stays −1, as the trainer leaves it at level 0); for each aggregate level
t, the base rows whose smallest footprint at t is under a pixel are
averaged per voxel of the contracted scene (voxel side `voxel_reso`·t/4),
every field raw, the log scale grown by log(2 / clip(mean footprint, ¼,
2)), as the insert episode builds its aggregates; an aggregate's records
are its largest and smallest footprint at level t over the views that see
it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import reference as ref

SH_C0 = 0.28209479177387814


@dataclass
class View:
    R: np.ndarray       # (3, 3) camera → world
    T: np.ndarray       # (3,) world → camera
    fovx: float
    fovy: float
    width: int
    height: int

    def center(self):
        return -self.R @ self.T

    def scaled(self, scale: float) -> "View":
        """The trainer's pyramid size for `scale`: round(W / scale)."""
        return View(self.R, self.T, self.fovx, self.fovy,
                    max(round(self.width / scale), 1),
                    max(round(self.height / scale), 1))


def look_at(pos, target, up=(0.0, 0.0, 1.0)):
    """(R, T) of a camera at `pos` looking at `target` (x right, y down, z
    forward)."""
    pos = np.asarray(pos, np.float64)
    f = np.asarray(target, np.float64) - pos
    f /= np.linalg.norm(f)
    right = np.cross(f, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    R = np.stack([right, down, f], axis=1)
    return R, -R.T @ pos


def make_views(cfg: dict):
    """(train views, test views): a ring of cameras around `look_at`, the
    radius and height wobbling with the angle; every `test_every`-th view
    held out."""
    ring = cfg["camera_ring"]
    W, H = cfg["width"], cfg["height"]
    fovx = math.radians(cfg["fovx_deg"])
    fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * H / W)
    train, test = [], []
    for i in range(cfg["n_views"]):
        a = 2.0 * math.pi * i / cfg["n_views"]
        r = ring["radius"] * (1.0 + ring["radius_wobble"] * math.cos(3 * a))
        h = ring["height"] + ring["height_wobble"] * math.sin(5 * a)
        R, T = look_at((r * math.cos(a), r * math.sin(a), h), ring["look_at"])
        v = View(R, T, fovx, fovy, W, H)
        (test if i % cfg["test_every"] == 0 else train).append(v)
    return train, test


def cameras_extent(views) -> float:
    """The trainer's spatial scale: 1.1 × the largest distance of a camera
    centre from their mean."""
    c = np.stack([v.center() for v in views])
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _surface_points(s: dict, n: int, u, z, dev):
    """Points and unit normals of one surface; u (n, 4) uniform and z (n,
    3) normal draws."""
    kind = s["kind"]
    if kind == "ground":
        r = s["radius"] * u[:, 0]
        a = 2 * math.pi * u[:, 1]
        p = torch.stack([r * torch.cos(a), r * torch.sin(a),
                         0.02 * z[:, 0]], 1)
        nrm = torch.zeros_like(p)
        nrm[:, 2] = 1.0
        return p, nrm
    if kind == "shell":
        d = z / torch.linalg.norm(z, dim=1, keepdim=True)
        d = torch.cat([d[:, :2], d[:, 2:].abs() * 0.9 - 0.1], 1)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        return s["radius"] * d, -d
    if kind == "blobs":
        k = s["count"]
        g = torch.Generator(device="cpu").manual_seed(s.get("layout_seed", 7))
        cu = torch.rand((k, 3), generator=g, dtype=torch.float64)
        rad = s["radius"][0] + (s["radius"][1] - s["radius"][0]) * cu[:, 0]
        ang = 2 * math.pi * cu[:, 1]
        rr = s["spread"] * torch.sqrt(cu[:, 2])
        c = torch.stack([rr * torch.cos(ang), rr * torch.sin(ang), rad], 1)
        c, rad = c.to(dev, torch.float32), rad.to(dev, torch.float32)
        idx = torch.clamp((u[:, 0] * k).long(), max=k - 1)
        d = z / torch.linalg.norm(z, dim=1, keepdim=True)
        return c[idx] + rad[idx, None] * d, d
    if kind == "room":
        half = torch.tensor(s["half_extent"], device=dev, dtype=torch.float32)
        areas = torch.stack([half[1] * half[2], half[0] * half[2],
                             half[0] * half[1]]).repeat_interleave(2)
        cdf = torch.cumsum(areas / areas.sum(), 0)
        face = torch.clamp(torch.searchsorted(cdf, u[:, 0].contiguous()),
                           max=5)
        axis, sign = face // 2, (face % 2).float() * 2 - 1
        p = (torch.stack([u[:, 1], u[:, 2], u[:, 3]], 1) * 2 - 1) * half
        p[torch.arange(n, device=dev), axis] = sign * half[axis]
        p = p + torch.tensor([0.0, 0.0, float(half[2])], device=dev)
        nrm = torch.zeros_like(p)
        nrm[torch.arange(n, device=dev), axis] = -sign
        return p, nrm
    raise ValueError(f"unknown surface kind {kind!r}")


def base_gaussians(cfg: dict, seed: int, dev):
    """The configuration's n_gaussians base rows as raw fields (xyz,
    features_dc, features_rest, scaling, rotation, opacity)."""
    n = cfg["n_gaussians"]
    k_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.rand((n, 6), generator=gen, device=dev)
    z = torch.randn((n, 11 + 3 * k_rest), generator=gen, device=dev)
    shares = np.array([s["share"] for s in cfg["surfaces"]], np.float64)
    counts = np.floor(shares / shares.sum() * n).astype(np.int64)
    counts[-1] = n - counts[:-1].sum()
    pts, nrms, base_col = [], [], []
    a = 0
    for s, c in zip(cfg["surfaces"], counts):
        p, nrm = _surface_points(s, int(c), u[a:a + c, :4], z[a:a + c, :3],
                                 dev)
        pts.append(p)
        nrms.append(nrm)
        base_col.append(torch.tensor(s["color"], device=dev).expand(c, 3))
        a += c
    xyz, nrm, col = torch.cat(pts), torch.cat(nrms), torch.cat(base_col)

    ring = cfg["camera_ring"]
    focal = cfg["width"] / (2.0 * math.tan(math.radians(cfg["fovx_deg"]) / 2))
    dist = torch.sqrt(torch.sum(xyz[:, :2] ** 2, 1) + ring["radius"] ** 2)
    s_major = (0.5 * cfg["footprint_px"] * dist / focal
               * torch.exp(cfg["scale_log_sd"] * z[:, 3]))
    # A reconstruction's surface is not a plane: each Gaussian sits off it
    # by N(0, surface_jitter · its largest scale).
    xyz = xyz + nrm * (cfg["surface_jitter"] * s_major * z[:, 10])[:, None]
    aniso = torch.exp(cfg["anisotropy_log_sd"] * z[:, 4])
    scaling = torch.log(torch.stack(
        [s_major * aniso, s_major / aniso, s_major * cfg["flatness"]], 1))
    # Rotate z onto the normal, then spin about it.
    q_align = torch.stack([1.0 + nrm[:, 2], -nrm[:, 1], nrm[:, 0],
                           torch.zeros_like(nrm[:, 0])], 1)
    flip = nrm[:, 2] < -0.999
    q_align[flip] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev)
    q_align = q_align / torch.linalg.norm(q_align, dim=1, keepdim=True)
    th = math.pi * u[:, 4]
    q_spin = torch.stack([torch.cos(th), torch.zeros_like(th),
                          torch.zeros_like(th), torch.sin(th)], 1)
    rotation = _quat_mul(q_align, q_spin)
    mu, sd = cfg["opacity_logit"]
    opacity = (mu + sd * z[:, 5])[:, None]
    rgb = torch.clamp(col + cfg["color_sd"] * z[:, 6:7] + 0.5
                      * cfg["color_sd"] * z[:, 7:10], 0.02, 0.98)
    features_dc = ((rgb - 0.5) / SH_C0)[:, None, :]
    features_rest = cfg["sh_rest_sd"] * z[:, 11:11 + 3 * k_rest].reshape(
        n, k_rest, 3)
    return dict(xyz=xyz, features_dc=features_dc,
                features_rest=features_rest, scaling=scaling,
                rotation=rotation, opacity=opacity)


def _footprints(rows: dict, views, dev):
    """Per row: the smallest and largest ×1 footprint over the views that
    see it (+inf / −inf where none does)."""
    n = rows["xyz"].shape[0]
    lo = torch.full((n,), math.inf, device=dev)
    hi = torch.full((n,), -math.inf, device=dev)
    with torch.no_grad():
        for v in views:
            cam = ref.make_cam(v.R, v.T, v.fovx, v.fovy, v.width, v.height,
                               dev)
            p = ref.project(rows["xyz"], rows["scaling"], rows["rotation"],
                            cam)
            r = 1.5 * p["footprint"]
            seen = p["front"] & (p["mx"] > -r) & (p["mx"] < v.width + r) \
                & (p["my"] > -r) & (p["my"] < v.height + r)
            lo = torch.where(seen, torch.minimum(lo, p["footprint"]), lo)
            hi = torch.where(seen, torch.maximum(hi, p["footprint"]), hi)
    return lo, hi


def _contract(xyz, extent):
    rel = xyz / extent
    return torch.where(rel > 1.0, 2.0 - 1.0 / rel, rel)


def _aggregates(base: dict, min1, views, lvl: int, cfg: dict, extent, dev):
    """Level-`lvl` aggregates: voxel means of the base rows whose smallest
    footprint at that level is under a pixel."""
    ratio = views[0].scaled(2 ** lvl).width / views[0].width
    cur = min1 * ratio
    sel = torch.isfinite(cur) & (cur < 1.0)
    idx = torch.nonzero(sel).squeeze(1)
    reso = cfg["voxel_reso"] * lvl / 4.0
    q = torch.floor(_contract(base["xyz"][idx], extent) / reso).long()
    q = torch.clamp(q + 512, 0, 1023)
    key = (q[:, 0] * 1024 + q[:, 1]) * 1024 + q[:, 2]
    key, order = torch.sort(key, stable=True)
    idx = idx[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.cumsum(counts, 0)])

    def mean(a):
        flat = a[idx].reshape(idx.shape[0], -1)
        s = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0)
        return (s / counts[:, None]).reshape((uniq.shape[0],) + a.shape[1:])
    agg = {k: mean(v) for k, v in base.items()}
    pooled = mean(cur[:, None])[:, 0]
    agg["scaling"] = agg["scaling"] + torch.log(
        2.0 / torch.clamp(pooled, 0.25, 2.0))[:, None]
    return agg


def make_scene(cfg: dict, seed: int, dev):
    """The state's fields at the configuration's capacity (the program's
    field names and storage), the train and test views, the scene extent
    and the row counts."""
    train, test = make_views(cfg)
    extent = cameras_extent(train)
    base = base_gaussians(cfg, seed, dev)
    n_base = base["xyz"].shape[0]
    rows = {k: [v] for k, v in base.items()}
    n_levels = cfg["max_scale_pow"] + 1 if cfg["method"] == "ms" else 1
    target, maxp, minp = [torch.zeros(n_base, dtype=torch.int32, device=dev)], \
        [torch.full((n_base,), -1.0, device=dev)], []
    agg_counts = {}
    if cfg["method"] == "ms":
        lo, _ = _footprints(base, train, dev)
        minp.append(torch.where(torch.isfinite(lo), lo, -1.0))
        room = cfg["capacity"] - n_base
        aggs = []
        for lvl in cfg["aggregate_levels"]:
            agg = _aggregates(base, lo, train, lvl, cfg, extent, dev)
            n = min(agg["xyz"].shape[0], room)
            room -= n
            agg = {k: v[:n] for k, v in agg.items()}
            aggs.append((lvl, agg))
            agg_counts[lvl] = n
        for lvl, agg in aggs:
            alo, ahi = _footprints(agg, train, dev)
            ratio = train[0].scaled(2 ** lvl).width / train[0].width
            n = agg["xyz"].shape[0]
            for k, v in agg.items():
                rows[k].append(v)
            target.append(torch.full((n,), lvl, dtype=torch.int32,
                                     device=dev))
            maxp.append(torch.where(torch.isfinite(ahi), ahi * ratio, -1.0))
            minp.append(torch.where(torch.isfinite(alo) & (lvl < n_levels - 1),
                                    alo * ratio, -1.0))
    else:
        minp.append(torch.full((n_base,), -1.0, device=dev))

    C = cfg["capacity"]
    n_live = sum(r.shape[0] for r in rows["xyz"])

    def full(parts, fill, dtype=torch.float32):
        x = torch.cat(parts)
        pad = torch.full((C - x.shape[0],) + x.shape[1:], fill, dtype=dtype,
                         device=dev)
        return torch.cat([x, pad.to(x.dtype)])
    k_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    g = dict(
        xyz=full(rows["xyz"], 0.0),
        features_dc=full(rows["features_dc"], 0.0),
        features_rest=full(rows["features_rest"], 0.0),
        scaling=full(rows["scaling"], -10.0),
        rotation=full(rows["rotation"], 0.0),
        opacity=full(rows["opacity"], 0.0),
        occ_multiplier=torch.ones((C, 4), device=dev),
        dc_delta=torch.zeros((C, 4, 3), device=dev),
        live=torch.arange(C, device=dev) < n_live,
        max_radii2d=torch.zeros((C,), device=dev),
        max_pixel_sizes=full(maxp, -1.0),
        min_pixel_sizes=full(minp, -1.0),
        base_mask=torch.zeros((C,), dtype=torch.bool, device=dev),
        target_reso_lvl=full(target, 0, torch.int32),
        xyz_grad_accum=torch.zeros((C, n_levels), device=dev),
        denom=torch.zeros((C, n_levels), device=dev),
        active_sh_degree=torch.tensor(cfg["sh_degree"], dtype=torch.int32,
                                      device=dev),
    )
    g["rotation"][n_live:, 0] = 1.0
    assert g["features_rest"].shape[1] == k_rest
    return dict(fields=g, train=train, test=test, extent=extent,
                n_base=n_base, n_live=n_live, aggregates=agg_counts,
                n_levels=n_levels)


def perturbed(g: dict, cfg: dict, seed: int, dev) -> dict:
    """The state training starts from: the scene's parameters moved by
    noise drawn from the seed (`perturb` gives each group's scale; xyz
    moves by that share of each row's largest scale)."""
    p = cfg["perturb"]
    gen = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED)
    out = dict(g)
    live = g["live"][:, None]
    s_max = torch.exp(g["scaling"]).amax(1, keepdim=True)
    noise = {"xyz": p["xyz"] * s_max, "scaling": p["scaling"],
             "rotation": p["rotation"], "opacity": p["opacity"]}
    for k, scale in noise.items():
        z = torch.randn(g[k].shape, generator=gen, device=dev)
        out[k] = torch.where(live, g[k] + scale * z, g[k])
    for k in ("features_dc", "features_rest"):
        z = torch.randn(g[k].shape, generator=gen, device=dev)
        out[k] = torch.where(live[:, :, None], g[k] + p[k] * z, g[k])
    return out
