"""The compositor's per-(entry, pixel) pair math in eight formulations: the
CUDA probe kernel and its plain version.

Port of the Pallas kernel of tools/exp_mxu.py (`make_kernel`, called at
:209), which asks whether parts of the compositor's pair math pay when they
move onto the matrix unit. One block is 128 payload rows (entries) × 16
features against a 16×16 pixel tile (256 pixels, x = p % 16, y = p // 16),
in 4 segments of 32 rows:

  power    -0.5·(cxx·dx² + cyy·dy²) − cxy·dx·dy, dx = x − mx, dy = y − my
  α        min(op·e^power, 0.99) where op·e^power ≥ 1/255 and power ≤ 0
  T        1 − α multiplied within each segment: w uses the exclusive
           product, `alive` the inclusive one ≥ 1e-4
  w        α·T_excl·alive
  rows 0-4 Σ_entries feat[6 + i]·w, over all four segments

The variants compute different things, and each is held to its own plain
version:

  empty     feat[0, 6]·x into row 0 only (the block is still read whole)
  base      the math above
  exp2      e^power as exp2(power·log2 e)
  pow_mxu   power as (128×8 tile-origin coefficients) @ (8×256 monomials
            x², xy, y², x, y, 1, 0, 0)
  scan_mxu  T as exp(block-diagonal lower-triangular ones @ log1p(−α)),
            T_excl = T / max(1 − α, 1e-6)
  acc_tn    the (32×256) product of the segment-masked features 6..13 with
            w; rows [:8] (segment 0 only) are kept
  dfeat_nt  df = w (128×256) @ g_rowsᵀ (256×8); the accumulator term is
            (df[:8] @ basis)·1e-6. The JAX script feeds its accumulator
            back in as g_rows, which starts at 0, so its output is 0; here
            g_rows is an input, zeros by default.

Rows 5-7 of the output stay 0. The output is the (8, 256) accumulator the
TPU kernel leaves in `out_ref`, summed over the B blocks; with
`per_block=True` it is the (B, 8, 256) per-block terms, or the (B, 128, 8)
`df` for dfeat_nt.

Precision of the matmul variants (`precision`, required for them and
refused for the others). Mosaic's HIGHEST (6-pass bf16, exact f32
products) is fp32 on the CUDA cores: each product element summed in k
order. HIGH (Mosaic's 3-pass bf16) is 3×TF32 on the tensor cores: each
operand x split into big = tf32(x) and small = tf32(x − big), the products
small·big + big·small + big·big by `mma.sync.m16n8k8` with fp32
accumulation. TF32 is off in PyTorch (msgs_torch/__init__.py), so the
kernel's TF32 is explicit. On the CPU, as in JAX's interpret mode, both
precisions are plain f32: the plain version ignores `precision`.

The plain version sums in the kernel's order: every product in k order
(starting from the first term), the segmented product by the same 5-round
tree, segments and blocks summed in order. Under the build's `-fmad=false`
the kernel's f32 runs equal it per block to the last bit wherever the
libm calls agree; the sum over blocks takes another order, fixed by B and
the grid, in one launch (see msgs_torch/csrc/mxu_probe.cu). The kernel is
msgs_torch/csrc/mxu_probe.cu.
"""
from __future__ import annotations

import ctypes

import torch

from msgs_torch.kernels import _build

BLOCK, NPIX, NFEAT, SUB = 128, 256, 16, 32
NSUB = BLOCK // SUB
NOUT = 8          # output rows (the TPU accumulator's sublanes)
NACC = 5          # rows the variants accumulate into
NDF = 8           # df columns (g_rows)
VARIANTS = ("empty", "base", "exp2", "pow_mxu", "scan_mxu", "acc_tn",
            "dfeat_nt")
MATMUL_VARIANTS = ("pow_mxu", "scan_mxu", "acc_tn", "dfeat_nt")
PRECISIONS = ("HIGHEST", "HIGH")
LOG2E = 1.4426950408889634
# The kernel's grid is what the card holds at once (at most 3 CTAs of 128
# threads an SM), each CTA a contiguous range of blocks; the summed output
# adds the CTAs' (5, 256) partials in CTA order within groups of 32 CTAs,
# then the groups' sums in order, so B and the grid fix its order. The
# grid policy lives in csrc/mxu_probe.cu alone; msgs_mxu_probe_scratch
# sizes the tickets and partials, which are kept per device and stream.
# The kernel's instances, (variant, precision, per_block), in the order of
# msgs_mxu_probe_info's index 4·variant + 2·(precision == "HIGH") +
# per_block.
PROBE_INSTANCES = tuple(
    (v, p, pb) for v in VARIANTS
    for p in ((None,) if v not in MATMUL_VARIANTS else PRECISIONS)
    for pb in (False, True))


def instance_index(variant: str, precision, per_block: bool) -> int:
    return (4 * VARIANTS.index(variant) + 2 * (precision == "HIGH")
            + int(per_block))
# Blocks per chunk of the plain version: bounds its (chunk, 128, 256)
# intermediates to 128 MiB each. Blocks are independent, so the chunking
# changes no value.
PLAIN_CHUNK = 1024


def _check(payload, variant, precision, g_rows):
    if (payload.dtype != torch.float32 or payload.dim() != 3
            or tuple(payload.shape[1:]) != (BLOCK, NFEAT)
            or payload.shape[0] == 0):
        raise TypeError(f"pair_block_probe: payload must be a (B, {BLOCK}, "
                        f"{NFEAT}) float32 tensor with B ≥ 1, not "
                        f"{payload.dtype} of shape {tuple(payload.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"pair_block_probe: variant {variant!r} not in "
                         f"{VARIANTS}")
    if variant in MATMUL_VARIANTS:
        if precision not in PRECISIONS:
            raise ValueError(f"pair_block_probe: {variant} needs a "
                             f"precision in {PRECISIONS}, not {precision!r}")
    elif precision is not None:
        raise ValueError(f"pair_block_probe: {variant} has no matmul; "
                         f"precision must be None, not {precision!r}")
    if g_rows is None:
        return
    if variant != "dfeat_nt":
        raise ValueError(f"pair_block_probe: g_rows is for dfeat_nt, not "
                         f"{variant}")
    if g_rows.dtype != torch.float32 or tuple(g_rows.shape) != (NDF, NPIX):
        raise TypeError(f"pair_block_probe: g_rows must be a ({NDF}, "
                        f"{NPIX}) float32 tensor, not {g_rows.dtype} of "
                        f"shape {tuple(g_rows.shape)}")
    if g_rows.device != payload.device:
        raise ValueError(f"pair_block_probe: payload on {payload.device}, "
                         f"g_rows on {g_rows.device}")


def pixels(dev):
    p = torch.arange(NPIX, device=dev)
    return (p % 16).float(), (p // 16).float()


def basis(px, py):
    """The nonzero monomial rows x², xy, y², x, y, 1 (rows 6-7 are 0)."""
    return [px * px, px * py, py * py, px, py, torch.ones_like(px)]


def _seq_sum(terms):
    """Left-to-right sum of an iterable of tensors, from its first term."""
    it = iter(terms)
    acc = next(it)
    for t in it:
        acc = acc + t
    return acc


def pow_coeffs(feat):
    """pow_mxu's tile-origin coefficients of x², xy, y², x, y, 1 per row
    (tools/exp_mxu.py:96-107), each (..., 1) of feat (..., 16)."""
    mx, my = feat[..., 0:1], feat[..., 1:2]
    cxx, cxy, cyy = feat[..., 2:3], feat[..., 3:4], feat[..., 4:5]
    return [-0.5 * cxx, -cxy, -0.5 * cyy, cxx * mx + cxy * my,
            cyy * my + cxy * mx,
            -0.5 * (cxx * mx * mx + cyy * my * my) - cxy * mx * my]


def _power(feat, variant, px, py):
    """(b, 4, 32, 256) power; feat is (b, 4, 32, 16)."""
    if variant == "pow_mxu":
        return _seq_sum(c * b for c, b in zip(pow_coeffs(feat),
                                                basis(px, py)))
    mx, my = feat[..., 0:1], feat[..., 1:2]
    cxx, cxy, cyy = feat[..., 2:3], feat[..., 3:4], feat[..., 4:5]
    dx = px - mx
    dy = py - my
    return -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy


def _alpha(feat, power, variant):
    g = (torch.exp2(power * LOG2E) if variant == "exp2"
         else torch.exp(power))
    alpha_raw = feat[..., 5:6] * g
    mask = (alpha_raw >= 1.0 / 255.0) & (power <= 0.0)
    return torch.where(mask, torch.clamp(alpha_raw, max=0.99), 0.0)


def _weights(alpha, variant):
    """w = α·T_excl·alive per segment (dim 2 is the 32 rows)."""
    if variant == "scan_mxu":
        lf = torch.log1p(-alpha)
        runs = [lf[:, :, 0]]
        for r in range(1, SUB):
            runs.append(runs[-1] + lf[:, :, r])
        cum = torch.exp(torch.stack(runs, dim=2))
        cum_excl = cum / torch.clamp(1.0 - alpha, min=1e-6)
    else:
        # The 5-round tree of tools/exp_mxu.py:_cumprod_static.
        cum = 1.0 - alpha
        k = 1
        while k < SUB:
            cum = torch.cat([cum[:, :, :k], cum[:, :, k:] * cum[:, :, :-k]],
                            dim=2)
            k *= 2
        cum_excl = torch.cat([torch.ones_like(cum[:, :, :1]),
                              cum[:, :, :-1]], dim=2)
    return alpha * cum_excl * (cum >= 1e-4)


def _feature_sums(feat, w, seg, n):
    """(b, n, 256): Σ over the segment's 32 rows of feat[6 + i]·w, in row
    order."""
    f = feat[:, seg, :, 6:6 + n]                       # (b, 32, n)
    ws = w[:, seg]                                     # (b, 32, 256)
    return _seq_sum(f[:, r, :, None] * ws[:, r, None, :]
                    for r in range(SUB))


def _dfeat(w, g_rows):
    """df (b, 128, 8) = w @ g_rowsᵀ, summed over pixels in order."""
    wf = w.reshape(w.shape[0], BLOCK, NPIX)
    return _seq_sum(wf[:, :, q, None] * g_rows[:, q] for q in range(NPIX))


def _chunk_terms(feat, variant, g_rows):
    """Per-block terms of one chunk: ((b, 8, 256), df (b, 128, 8) or
    None)."""
    b = feat.shape[0]
    dev = feat.device
    px, py = pixels(dev)
    out = torch.zeros((b, NOUT, NPIX), dtype=torch.float32, device=dev)
    if variant == "empty":
        out[:, 0] = feat[:, 0, 6:7] * px
        return out, None
    feat = feat.reshape(b, NSUB, SUB, NFEAT)
    alpha = _alpha(feat, _power(feat, variant, px, py), variant)
    w = _weights(alpha, variant)
    if variant == "acc_tn":
        out[:, :NACC] = _feature_sums(feat, w, 0, NACC)
        return out, None
    if variant == "dfeat_nt":
        df = _dfeat(w, g_rows)
        mono = basis(px, py)
        acc = _seq_sum(df[:, :NOUT, k, None] * m
                       for k, m in enumerate(mono)) * 1e-6
        out[:, :NACC] = acc[:, :NACC]
        return out, df
    out[:, :NACC] = _seq_sum(_feature_sums(feat, w, s, NACC)
                             for s in range(NSUB))
    return out, None


def pair_block_probe_plain(payload: torch.Tensor, variant: str,
                           precision: str | None = None,
                           g_rows: torch.Tensor | None = None,
                           per_block: bool = False) -> torch.Tensor:
    """Plain version of pair_block_probe (same arguments), in f32 at either
    precision, block-chunked so that the intermediates stay small."""
    _check(payload, variant, precision, g_rows)
    if variant == "dfeat_nt" and g_rows is None:
        g_rows = torch.zeros((NDF, NPIX), dtype=torch.float32,
                             device=payload.device)
    terms, dfs = [], []
    for chunk in payload.split(PLAIN_CHUNK):
        t, df = _chunk_terms(chunk, variant, g_rows)
        terms.append(t)
        dfs.append(df)
    if per_block:
        return torch.cat(dfs if variant == "dfeat_nt" else terms)
    return torch.cat(terms).sum(0)


class ProbeState:
    """The summed output's scratch on one stream, as many words and slots
    as msgs_mxu_probe_scratch asks for the largest grid the card can hold:
    the kernel's ticket words, zero when made and left zero by every
    launch, and room for the grid's (5, 256) partials and its groups' sums.
    Kernels on one stream run in order, so each call reuses them."""

    def __init__(self, dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sizes = (ctypes.c_int * 2)()
        err = _build.load().msgs_mxu_probe_scratch(sms,
                                                    ctypes.addressof(sizes))
        _build.check(err, "pair_block_probe scratch")
        self.slots, words = sizes
        self.tickets = torch.zeros(words, dtype=torch.int32, device=dev)
        self.partial = torch.empty((self.slots, NACC, NPIX),
                                   dtype=torch.float32, device=dev)


_states: dict = {}     # (device index, stream) → ProbeState


def _probe_cuda(payload, variant, precision, g_rows, per_block):
    if not payload.is_contiguous() or payload.data_ptr() % 16 != 0:
        raise ValueError("pair_block_probe: payload must be contiguous and "
                         "16-byte aligned (the kernel reads float4s)")
    dev = payload.device
    B = payload.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    if variant == "dfeat_nt":
        g_rows = (torch.zeros((NDF, NPIX), **f32) if g_rows is None
                  else g_rows.contiguous())
    df = (torch.empty((B, BLOCK, NDF), **f32)
          if per_block and variant == "dfeat_nt" else None)
    stream = _build.stream_ptr(payload)
    key = (dev.index, stream)
    state = _states.get(key)
    if state is None:
        state = _states[key] = ProbeState(dev)
    out = torch.empty((B, NOUT, NPIX) if per_block else (NOUT, NPIX), **f32)
    lib = _build.load()
    err = lib.msgs_mxu_probe(payload.data_ptr(),
                             None if g_rows is None else g_rows.data_ptr(),
                             out.data_ptr(),
                             None if df is None else df.data_ptr(),
                             state.partial.data_ptr(), state.slots,
                             state.tickets.data_ptr(), B,
                             VARIANTS.index(variant),
                             int(precision == "HIGH"), int(per_block),
                             stream)
    _build.check(err, "pair_block_probe")
    _build.launch_counts["mxu_probe"] += 1
    return df if df is not None else out


def pair_block_probe(payload: torch.Tensor, variant: str,
                     precision: str | None = None,
                     g_rows: torch.Tensor | None = None,
                     per_block: bool = False) -> torch.Tensor:
    """The (8, 256) accumulator of `variant` over the B blocks of a
    (B, 128, 16) float32 payload; with per_block=True the (B, 8, 256)
    per-block terms, or dfeat_nt's (B, 128, 8) df. `precision` ("HIGHEST"
    or "HIGH") is required for the matmul variants and refused for the
    others; g_rows ((8, 256), zeros by default) only for dfeat_nt. A CUDA
    tensor goes through the CUDA kernel, a CPU tensor through the plain
    version."""
    _check(payload, variant, precision, g_rows)
    if payload.device.type == "cuda":
        return _probe_cuda(payload, variant, precision, g_rows, per_block)
    if payload.device.type == "cpu":
        return pair_block_probe_plain(payload, variant, precision, g_rows,
                                      per_block)
    raise ValueError(f"pair_block_probe: unsupported device "
                     f"{payload.device}")
