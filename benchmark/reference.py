"""Plain PyTorch reference of what the benchmark's cells time: 3D Gaussian
splatting with the MS-GS selection, its photometric loss, Adam, and the
MS-GS pixel-size records.

Written from the published descriptions (3DGS, Kerbl et al. 2023: EWA
projection with the 0.3 px low-pass, ceil(3σ) tile rectangles, α =
min(0.99, o·exp(power)) skipped below 1/255, front-to-back blending that
stops before T falls under 1e-4; MS-GS, Yan et al. 2024: the filter_small
and filter_large opacity weights over recorded pixel footprints). It
imports nothing of the program and takes nothing the program made.

How it is computed, not what: a tile's entries are sorted by their exact
float depth; every entry is evaluated at all 256 pixels of its tile; the
transmittance is a per-pixel cumulative sum of log(1 − α) in float64
within each tile, taken over chunks of whole tiles, each chunk under
activation checkpointing, so any frame size fits. `Prec(tf32=True)` rounds
the operands of every product that a float32 matrix multiply or
convolution would take (projection, covariance, SH, the colour sums, the
SSIM windows) to TF32: the benchmark's lower-precision control. Every
entry (`render`, `render_state`, `count_work`, `ssim`, `photometric_loss`,
`train_step`) turns TF32 off itself for its duration, whatever the process
has set, so its precision is its own.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

TILE = 16
NEAR = 0.2
LOWPASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
CHUNK_ENTRIES = 1 << 17

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, to nearest even), with
    the gradient passed straight through."""
    xi = x.detach().contiguous().view(torch.int32)
    bias = ((xi >> 13) & 1) + 0xFFF
    r = ((xi + bias) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


@dataclass(frozen=True)
class Prec:
    """Which precision the products take: float32, or TF32 operands."""
    tf32: bool = False

    def r(self, x):
        return tf32(x) if self.tf32 else x


F32 = Prec(False)


@contextlib.contextmanager
def _tf32_off():
    """float32 matrix multiplies and cuDNN convolutions without TF32, the
    process's settings restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def exact_f32(fn):
    """Run `fn` with TF32 off (see `_tf32_off`)."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with _tf32_off():
            return fn(*a, **kw)
    return wrapped


# --------------------------------------------------------------------------
# Cameras (COLMAP convention: R camera→world, T world→camera)
# --------------------------------------------------------------------------

@dataclass
class Cam:
    R: torch.Tensor        # (3, 3) world→view as a right operand: v = p @ R + T
    T: torch.Tensor        # (3,)
    center: torch.Tensor   # (3,)
    tanx: float
    tany: float
    width: int
    height: int

    @property
    def fx(self):
        return self.width / (2.0 * self.tanx)

    @property
    def fy(self):
        return self.height / (2.0 * self.tany)


def make_cam(R, T, fovx, fovy, width, height, device) -> Cam:
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return Cam(R=f32(R), T=f32(T), center=f32(-R @ T),
               tanx=math.tan(fovx / 2.0), tany=math.tan(fovy / 2.0),
               width=int(width), height=int(height))


# --------------------------------------------------------------------------
# Per-Gaussian preprocessing
# --------------------------------------------------------------------------

def quat_to_rot(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def sh_basis(d):
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, _C0),
        -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * x * y, _C2[1] * y * z, _C2[2] * (2 * zz - xx - yy),
        _C2[3] * x * z, _C2[4] * (xx - yy),
        _C3[0] * y * (3 * xx - yy), _C3[1] * x * y * z,
        _C3[2] * y * (4 * zz - xx - yy),
        _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3 * yy)], -1)


def project(xyz, log_scale, quat, cam: Cam, prec: Prec = F32):
    """Screen mean (pixel centres at integers), view depth, dilated 2-D
    covariance (xx, xy, yy), the undilated footprint 2·sqrt(λmax) in
    pixels, and whether the mean lies past the near plane."""
    v = prec.r(xyz) @ prec.r(cam.R) + cam.T
    z = v[:, 2]
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    mx = ((v[:, 0] / zs / cam.tanx + 1.0) * cam.width - 1.0) * 0.5
    my = ((v[:, 1] / zs / cam.tany + 1.0) * cam.height - 1.0) * 0.5
    lx, ly = 1.3 * cam.tanx, 1.3 * cam.tany
    tx = torch.clamp(v[:, 0] / zs, -lx, lx) * zs
    ty = torch.clamp(v[:, 1] / zs, -ly, ly) * zs
    zero = torch.zeros_like(zs)
    J = torch.stack([cam.fx / zs, zero, -cam.fx * tx / (zs * zs),
                     zero, cam.fy / zs, -cam.fy * ty / (zs * zs)],
                    -1).reshape(-1, 2, 3)
    M = quat_to_rot(quat) * torch.exp(log_scale)[:, None, :]   # R·diag(s)
    M = prec.r(M)
    sigma = M @ M.transpose(1, 2)
    A = prec.r(prec.r(J) @ prec.r(cam.R.T)[None])             # J·W
    cov = prec.r(A) @ prec.r(sigma) @ prec.r(A).transpose(1, 2)
    cxx0, cxy, cyy0 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    mid0 = 0.5 * (cxx0 + cyy0)
    det0 = cxx0 * cyy0 - cxy * cxy
    lam0 = mid0 + torch.sqrt(torch.clamp(mid0 * mid0 - det0, min=1e-8))
    footprint = 2.0 * torch.sqrt(torch.clamp(lam0, min=1e-8))
    return dict(mx=mx, my=my, depth=z, cxx=cxx0 + LOWPASS, cxy=cxy,
                cyy=cyy0 + LOWPASS, footprint=footprint, front=front)


def _step_or_ramp(x, fade):
    if fade <= 0.0:
        return (x >= 0.0).to(x.dtype)
    return torch.clamp(x / fade, 0.0, 1.0)


def preprocess(g: dict, cam: Cam, *, sh_degree=3, filter_small=False,
               filter_large=False, fade_size=0.0, colors=True,
               prec: Prec = F32):
    """Everything per Gaussian that compositing needs. `g` holds the
    state's fields by the program's names (raw storage: log scales,
    unnormalised quaternions, opacity logits)."""
    p = project(g["xyz"], g["scaling"], g["rotation"], cam, prec)
    cxx, cxy, cyy = p["cxx"], p["cxy"], p["cyy"]
    det = cxx * cyy - cxy * cxy
    ok = det > 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    ca, cb, cc = cyy * inv, -cxy * inv, cxx * inv
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()

    op = torch.sigmoid(g["opacity"][:, 0])
    ps = p["footprint"]
    if filter_small:
        applies = g["max_pixel_sizes"] >= 1.0
        op = op * torch.where(applies,
                              _step_or_ramp(ps - 1.0 + fade_size, fade_size),
                              torch.ones_like(op))
    if filter_large:
        applies = (~g["base_mask"]) & (g["min_pixel_sizes"] >= 0.0)
        op = op * torch.where(
            applies, _step_or_ramp(2.0 * g["min_pixel_sizes"] - ps
                                   + fade_size, fade_size),
            torch.ones_like(op))

    # Tile rectangle: the ceil(3σ) square, cut to the tiles the α ≥ 1/255
    # ellipse can reach (a tile it cannot reach has no pixel to blend).
    tiles_x = (cam.width + TILE - 1) // TILE
    tiles_y = (cam.height + TILE - 1) // TILE
    od = op.detach()
    k2 = 2.0 * torch.log(torch.clamp(od, min=1e-12) / ALPHA_MIN)
    k = torch.sqrt(torch.clamp(k2, min=0.0))
    mx, my = p["mx"].detach(), p["my"].detach()
    ax = k * torch.sqrt(torch.clamp(cxx.detach(), min=0.0))
    ay = k * torch.sqrt(torch.clamp(cyy.detach(), min=0.0))
    x0 = torch.clamp(torch.floor((mx - torch.minimum(ax, radius)) / TILE),
                     0, tiles_x)
    y0 = torch.clamp(torch.floor((my - torch.minimum(ay, radius)) / TILE),
                     0, tiles_y)
    x1 = torch.clamp(torch.minimum(torch.floor((mx + ax) / TILE) + 1,
                                   torch.floor((mx + radius + TILE - 1)
                                               / TILE)), 0, tiles_x)
    y1 = torch.clamp(torch.minimum(torch.floor((my + ay) / TILE) + 1,
                                   torch.floor((my + radius + TILE - 1)
                                               / TILE)), 0, tiles_y)
    visible = (p["front"] & ok & g["live"] & (op.detach() > ALPHA_MIN)
               & (x1 > x0) & (y1 > y0))
    out = dict(mx=p["mx"], my=p["my"], depth=p["depth"], ca=ca, cb=cb,
               cc=cc, op=op, footprint=ps, visible=visible,
               rect=torch.stack([x0, y0, x1, y1], 1).long())
    if colors:
        sh = torch.cat([g["features_dc"], g["features_rest"]], 1)
        d = g["xyz"] - cam.center
        d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True) + 1e-12)
        basis = sh_basis(d)[:, :(sh_degree + 1) ** 2]
        col = torch.einsum("nk,nkc->nc", prec.r(basis),
                           prec.r(sh[:, :basis.shape[1]]))
        out["color"] = torch.clamp(col + 0.5, min=0.0)
    return out


# --------------------------------------------------------------------------
# Tile lists and compositing
# --------------------------------------------------------------------------

def tile_entries(pre, width, height):
    """(gaussian id, tile) of every entry, sorted by tile, then depth."""
    tiles_x = (width + TILE - 1) // TILE
    vis = torch.nonzero(pre["visible"]).squeeze(1)
    r = pre["rect"][vis]
    w = r[:, 2] - r[:, 0]
    n = w * (r[:, 3] - r[:, 1])
    gid = torch.repeat_interleave(vis, n)
    start = torch.cumsum(n, 0) - n
    j = torch.arange(gid.shape[0], device=gid.device) - \
        torch.repeat_interleave(start, n)
    wr = torch.repeat_interleave(w, n)
    rr = torch.repeat_interleave(r, n, dim=0)
    tile = (rr[:, 1] + j // wr) * tiles_x + rr[:, 0] + j % wr
    order = torch.argsort(pre["depth"].detach()[gid], stable=True)
    gid, tile = gid[order], tile[order]
    order = torch.argsort(tile, stable=True)
    return gid[order], tile[order]


def _local_pixels(device):
    p = torch.arange(TILE * TILE, device=device)
    return (p % TILE).to(torch.float32), (p // TILE).to(torch.float32)


def _blend(feat, carry, lt, seg_start, tiles_x0, tiles_y0, n_tiles, inside,
           prec_tf32: bool, count: bool):
    """One chunk of the depth-sorted entry stream: feat (E, 9) = mx, my,
    ca, cb, cc, op, r, g, b of its entries, lt (E,) their chunk-local tile,
    seg_start (n_tiles,) each tile's first entry in the chunk, carry
    (n_tiles, 256) each tile's Σ log(1 − α) over its entries in earlier
    chunks. Returns the chunk's colour (n_tiles, 256, 3), its Σ log(1 − α)
    over the blended entries (n_tiles, 256) and the carry after it; with
    `count`, also the pairs its pixels need and the entries they read."""
    lx, ly = _local_pixels(feat.device)
    px = tiles_x0[lt][:, None] + lx[None]
    py = tiles_y0[lt][:, None] + ly[None]
    dx = feat[:, 0, None] - px
    dy = feat[:, 1, None] - py
    power = -0.5 * (feat[:, 2, None] * dx * dx + feat[:, 4, None] * dy * dy) \
        - feat[:, 3, None] * dx * dy
    alpha = torch.clamp(feat[:, 5, None] * torch.exp(power), max=ALPHA_MAX)
    valid = (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    lg = torch.log1p(-a.double())
    cs = torch.cumsum(lg, 0)
    base = torch.where(seg_start[:, None] > 0,
                       cs[(seg_start - 1).clamp(min=0)],
                       torch.zeros_like(cs[:1]))
    cs = cs - (base - carry)[lt]
    t_excl = torch.exp(cs - lg)
    alive = torch.exp(cs) >= T_STOP
    w = (a.double() * t_excl * alive).to(torch.float32)
    col = feat[:, 6:9]
    if prec_tf32:
        w, col = tf32(w), tf32(col)
    out = torch.zeros((n_tiles, TILE * TILE, 3), dtype=torch.float32,
                      device=feat.device)
    out = out.index_add(0, lt, w[:, :, None] * col[:, None, :])
    zeros = torch.zeros((n_tiles, TILE * TILE), dtype=torch.float64,
                        device=feat.device)
    logt = zeros.index_add(0, lt, lg * alive)
    carry_out = carry + zeros.index_add(0, lt, lg)
    if not count:
        return out, logt, carry_out
    with torch.no_grad():
        open_ = (t_excl >= T_STOP) & inside[lt]
        pairs = open_.sum(dtype=torch.int64)
        read = open_.any(1).sum(dtype=torch.int64)
    return out, logt, carry_out, pairs, read


@exact_f32
def render(pre, width, height, *, bg=None, prec: Prec = F32,
           count: bool = False, chunk_entries: int = CHUNK_ENTRIES):
    """Image (H, W, 3) = Σ w·colour + T·bg, differentiable in the
    preprocess outputs. With `count`, returns (image, work) where work
    holds the (pixel, entry) pairs the image needs (each pixel's tile
    entries in depth order up to the one that takes T under 1e-4, entries
    with no pixel at α ≥ 1/255 in the tile left out), the entries those
    pairs read, and the entry count."""
    dev = pre["mx"].device
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    n_t = tiles_x * tiles_y
    gid, tile = tile_entries(pre, width, height)
    feat_rows = torch.stack(
        [pre["mx"], pre["my"], pre["ca"], pre["cb"], pre["cc"], pre["op"]]
        + list(pre["color"].unbind(1)), 1)
    lx, ly = _local_pixels(dev)
    grad = torch.is_grad_enabled() and feat_rows.requires_grad
    feat_all = feat_rows[gid]
    if count:
        # An entry no pixel of its tile blends (α < 1/255 at all of them)
        # is not needed: leave it out of the counted stream. It changes no
        # transmittance, so the image is the same.
        x0 = (tile % tiles_x).to(torch.float32) * TILE
        y0 = (tile // tiles_x).to(torch.float32) * TILE
        keep = torch.zeros_like(tile, dtype=torch.bool)
        for a in range(0, tile.shape[0], chunk_entries):
            f = feat_all[a:a + chunk_entries]
            px = x0[a:a + chunk_entries, None] + lx[None]
            py = y0[a:a + chunk_entries, None] + ly[None]
            dx, dy = f[:, 0, None] - px, f[:, 1, None] - py
            pw = -0.5 * (f[:, 2, None] * dx * dx + f[:, 4, None] * dy * dy) \
                - f[:, 3, None] * dx * dy
            al = torch.clamp(f[:, 5, None] * torch.exp(pw), max=ALPHA_MAX)
            ok = (pw <= 0.0) & (al >= ALPHA_MIN) & (px < width) & \
                (py < height)
            keep[a:a + chunk_entries] = ok.any(1)
        feat_all, tile, gid = feat_all[keep], tile[keep], gid[keep]
    carry = torch.zeros((n_t, TILE * TILE), dtype=torch.float64, device=dev)
    img_t = torch.zeros((n_t, TILE * TILE, 3), dtype=torch.float32,
                        device=dev)
    logt = torch.zeros((n_t, TILE * TILE), dtype=torch.float64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    read = torch.zeros((), dtype=torch.int64, device=dev)
    for a in range(0, tile.shape[0], chunk_entries):
        b = min(a + chunk_entries, tile.shape[0])
        uniq, lt = torch.unique_consecutive(tile[a:b], return_inverse=True)
        seg_start = torch.searchsorted(lt, torch.arange(
            uniq.shape[0], device=dev))
        x0 = (uniq % tiles_x).to(torch.float32) * TILE
        y0 = (uniq // tiles_x).to(torch.float32) * TILE
        inside = ((x0[:, None] + lx[None]) < width) & \
            ((y0[:, None] + ly[None]) < height)
        args = (feat_all[a:b], carry[uniq], lt, seg_start, x0, y0,
                uniq.shape[0], inside, prec.tf32, count)
        if grad:
            res = checkpoint(_blend, *args, use_reentrant=False)
        else:
            res = _blend(*args)
        img_t = img_t.index_add(0, uniq, res[0])
        logt = logt.index_add(0, uniq, res[1])
        carry = carry.index_copy(0, uniq, res[2])
        if count:
            pairs = pairs + res[3]
            read = read + res[4]
    t_t = torch.exp(logt).to(torch.float32)
    if bg is not None:
        img_t = img_t + t_t[:, :, None] * bg
    img = img_t.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, 3)
    img = img[:height, :width]
    if not count:
        return img
    return img, dict(pairs=int(pairs), entries_read=int(read),
                     entries=int(gid.shape[0]), pixels=width * height)


@exact_f32
def render_state(g, cam, settings: dict, prec: Prec = F32, count=False):
    pre = preprocess(g, cam, filter_small=settings.get("filter_small", False),
                     filter_large=settings.get("filter_large", False),
                     fade_size=settings.get("fade_size", 0.0), prec=prec)
    return render(pre, cam.width, cam.height, prec=prec, count=count), pre


@exact_f32
def count_work(g, cam, settings: dict) -> dict:
    """The compositor work one render of `g` needs (see `render`)."""
    with torch.no_grad():
        pre = preprocess(g, cam,
                         filter_small=settings.get("filter_small", False),
                         filter_large=settings.get("filter_large", False),
                         fade_size=settings.get("fade_size", 0.0),
                         colors=False)
        pre["color"] = torch.zeros_like(pre["mx"])[:, None].expand(-1, 3)
        _, work = render(pre, cam.width, cam.height, count=True)
    work["live"] = int(g["live"].sum())
    return work


# --------------------------------------------------------------------------
# Loss, Adam, MS-GS records
# --------------------------------------------------------------------------

def _window(device, size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64) - size // 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return torch.tensor(np.outer(k, k), dtype=torch.float32, device=device)


@exact_f32
def ssim(img, gt, prec: Prec = F32):
    """Mean SSIM over an 11×11 Gaussian window (σ 1.5), zero padding,
    C1 = 0.01², C2 = 0.03²; images (H, W, 3)."""
    w = prec.r(_window(img.device))[None, None].repeat(3, 1, 1, 1)

    def filt(x):
        return F.conv2d(prec.r(x).permute(2, 0, 1)[None], w, padding=5,
                        groups=3)[0]
    mu1, mu2 = filt(img), filt(gt)
    s11 = filt(img * img) - mu1 * mu1
    s22 = filt(gt * gt) - mu2 * mu2
    s12 = filt(img * gt) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


@exact_f32
def photometric_loss(img, gt, lambda_dssim=0.2, prec: Prec = F32):
    return (1.0 - lambda_dssim) * torch.mean(torch.abs(img - gt)) + \
        lambda_dssim * (1.0 - ssim(img, gt, prec))


PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def learning_rates(iteration: int, spatial_lr_scale: float) -> dict:
    """3DGS's groups: xyz on a log-linear decay from 1.6e-4 to 1.6e-6 over
    30,000 steps, scaled by the scene extent; the others fixed."""
    t = min(max(iteration / 30000.0, 0.0), 1.0)
    xyz = math.exp(math.log(1.6e-4) * (1 - t) + math.log(1.6e-6) * t)
    return {"xyz": xyz * spatial_lr_scale, "features_dc": 2.5e-3,
            "features_rest": 2.5e-3 / 20.0, "scaling": 5e-3,
            "rotation": 1e-3, "opacity": 0.05}


def adam(p, g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-15):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def update_records(g, footprint, seen, lvl, n_levels):
    """MS-GS pixel-footprint records of the rows whose target level is the
    rendered one: the max decays by 0.95 and takes the new footprint (at
    levels above 0), the min grows by 1.05 and takes it (below the
    coarsest); an unset record (−1) takes the footprint."""
    seen = seen & g["live"] & (g["target_reso_lvl"] == lvl)
    mx, mn = g["max_pixel_sizes"], g["min_pixel_sizes"]
    if lvl > 0:
        dec = torch.where(mx >= 0, mx * 0.95, mx)
        mx = torch.where(seen, torch.where(dec >= 0,
                                           torch.maximum(dec, footprint),
                                           footprint), mx)
    if lvl < n_levels - 1:
        inf = torch.where(mn >= 0, mn * 1.05, mn)
        mn = torch.where(seen, torch.where(inf >= 0,
                                           torch.minimum(inf, footprint),
                                           footprint), mn)
    return {**g, "max_pixel_sizes": mx, "min_pixel_sizes": mn}


@exact_f32
def train_step(g, m, v, step_count, cam, gt, *, iteration, lvl, n_levels,
               settings, spatial_lr_scale, loss_mult, lambda_dssim=0.2,
               records=True, prec: Prec = F32):
    """One step: render, loss, gradients of the six parameter groups,
    Adam, then the footprint records. Returns (loss, grads, g, m, v)."""
    leaves = {k: g[k].detach().requires_grad_() for k in PARAMS}
    gg = {**g, **leaves}
    with torch.enable_grad():
        img, pre = render_state(gg, cam, settings, prec)
        loss = photometric_loss(img, gt, lambda_dssim, prec) * loss_mult
        grads = dict(zip(PARAMS, torch.autograd.grad(
            loss, [leaves[k] for k in PARAMS])))
    lrs = learning_rates(iteration, spatial_lr_scale)
    new = dict(g)
    m, v = dict(m), dict(v)
    with torch.no_grad():
        for k in PARAMS:
            new[k], m[k], v[k] = adam(g[k], grads[k], m[k], v[k],
                                      step_count, lrs[k])
        if records:
            new = update_records(new, pre["footprint"].detach(),
                                 pre["visible"], lvl, n_levels)
    return float(loss.detach()), grads, new, m, v


def area_downsample(img, width, height):
    """(H, W, 3) → (height, width, 3) by area averaging."""
    x = img.permute(2, 0, 1)[None]
    return F.interpolate(x, size=(height, width), mode="area")[0].permute(
        1, 2, 0)
