"""The bf16 gradient variants of msgs_torch vs the JAX package's, on the CPU.

- `composite_bwd_bf16_reference` (through `composite(..., bwd_bf16=True)`
  and `composite_reference`) against `jax.vjp` of the Pallas compositor
  with bwd_bf16=True in interpret mode, per payload column. The two compute
  the same contract (bf16 operands, exact products, f32 sums) in different
  sum orders; a sum-order difference can flip the bf16 rounding of one w·φ
  or dpower operand, which moves that pixel's contribution by 2⁻⁸ of
  itself. Budget 2e-3·max|column| + 1e-6 (measured worst 5.6e-4), ten
  times tighter than the JAX suite's bf16 criterion.
- `rasterize` gradients under bwd_bf16 and under grad_pack_bf16 against
  JAX's under the same flag, with tests/test_rasterize.py's
  `_assert_bf16_grad_close` criterion (|Δ| ≤ 2e-2·max, q99 relative error
  < 10% on entries above 1e-2·max).
- The forward outputs under bwd_bf16 are bit-identical to the exact path.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels import composite as jcomp
from msgs.kernels.rasterize import RasterSettings as JSettings
from msgs.kernels.rasterize import rasterize as jax_rasterize
from msgs_torch.kernels import composite as tcomp
from msgs_torch.kernels import rasterize as trast
from tests.helpers import make_scene
from tests.test_rasterize import _assert_bf16_grad_close
from tests.test_torch_cuda import _edge_subs, _staggered_subs
from tests.test_torch_composite_bwd import _static, _stream
from tests.torch_parity import cameras, t

W = H = 64
N = 200
BG = np.array([0.2, 0.3, 0.4], np.float32)
NAMES = ["means", "scales", "quats", "opac", "shs", "probe"]


@functools.lru_cache(maxsize=None)
def _jax_bwd_bf16(image_only):
    """The stream, its cotangent (seed 11) and jax.vjp of the Pallas
    compositor with bwd_bf16=True (interpret mode) as (rows, 12)."""
    payload, b = _stream()
    T = _static(b)[0]
    cot = np.random.default_rng(11).normal(
        size=(T, tcomp.NOUT, tcomp.NPIX)).astype(np.float32)
    structure = (b["sub_tile"], b["sub_valid"], b["tile_last_sub"])
    _, vjp = jax.vjp(
        lambda p: jcomp.composite(p, *map(jnp.asarray, structure),
                                  *_static(b), image_only, True),
        jnp.asarray(payload))
    want = np.asarray(vjp(jnp.asarray(cot))[0]).reshape(-1, 12)
    return payload, b, cot, structure, want


@pytest.mark.parametrize("image_only", [False, True])
def test_bwd_bf16_plain_matches_jax(image_only):
    payload, b, cot, structure, want = _jax_bwd_bf16(image_only)
    last = tcomp.F_B if image_only else tcomp.F_PSIZE
    for fn in (tcomp.composite, tcomp.composite_reference):
        p = t(payload).requires_grad_()
        out = fn(p, *map(t, structure), *_static(b), image_only, True)
        out.backward(t(cot))
        got = p.grad.numpy().reshape(-1, 12)
        for c in range(last + 1):
            scale = np.abs(want[:, c]).max()
            assert scale > 0, c
            np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                       atol=2e-3 * scale + 1e-6,
                                       err_msg=f"{fn.__name__} col {c}")
        assert (got[:, last + 1:] == 0).all()


def _handmade_stream(subs, width, height):
    """Hand-made sub-blocks (subs[t]: tile t's, 32 rows each) in the JAX
    compositor's layout: payload blocks of 128 rows padded with zero rows
    to whole groups of 128 sub-blocks, sub_tile, sub_valid and
    tile_last_sub as binning makes them (an empty tile points at the
    sub-block before it)."""
    tx = (width + 15) // 16
    tiles = tx * ((height + 15) // 16)
    assert len(subs) == tiles
    n = sum(len(s) for s in subs)
    s_cap = -(-n // 128) * 128
    payload = np.zeros((s_cap * 32, 12), np.float32)
    payload[:n * 32] = np.concatenate([b for s in subs for b in s])
    counts = np.array([len(s) for s in subs])
    ends = np.cumsum(counts)
    sub_tile = np.full(s_cap, np.flatnonzero(counts)[-1], np.int32)
    sub_tile[:n] = np.repeat(np.arange(tiles), counts)
    sub_valid = (np.arange(s_cap) < n).astype(np.int32)
    tile_last_sub = np.maximum(ends - 1, 0).astype(np.int32)
    return (payload.reshape(-1, 128, 12), (sub_tile, sub_valid,
                                           tile_last_sub),
            (tiles, tx, width, height))


# The card tests' hand-made streams for kernel 4b (tests/test_torch_cuda.py):
# partial edge tiles, empty tiles, a tile saturating in its first
# sub-block; one tile whose pixels saturate at 256 different sub-blocks.
_HANDMADE = {"edges": (_edge_subs, 40, 24), "staggered": (_staggered_subs,
                                                          16, 16)}


@pytest.mark.parametrize("stream", list(_HANDMADE))
def test_tile_sub_ranges_handmade(stream):
    """tile_sub_ranges, which gives kernel 4b each tile's sub-blocks, on
    the hand-made layouts: each tile's first sub-block and count as built,
    0 for an empty tile, and no padding sub-block owned."""
    recipe, width, height = _HANDMADE[stream]
    subs = recipe()
    _, (sub_tile, sub_valid, last), static = _handmade_stream(subs, width,
                                                             height)
    first, n_sub = tcomp.tile_sub_ranges(t(sub_tile), t(sub_valid), t(last),
                                         static[0])
    counts = np.array([len(s) for s in subs])
    np.testing.assert_array_equal(n_sub.numpy(), counts)
    starts = np.cumsum(counts) - counts
    live = counts > 0
    np.testing.assert_array_equal(first.numpy()[live], starts[live])


@pytest.mark.parametrize("image_only", [False, True])
@pytest.mark.parametrize("stream", list(_HANDMADE))
def test_bwd_bf16_plain_matches_jax_handmade(stream, image_only):
    """The plain bwd_bf16 backward, which kernel 4b is held to on the card,
    against jax.vjp of the Pallas compositor with bwd_bf16=True
    (interpret mode) on the card tests' hand-made streams: per column
    within the budget above, uncomputed columns and the padding 0, and
    nothing past the sub-block where a tile saturated."""
    recipe, width, height = _HANDMADE[stream]
    payload, structure, static = _handmade_stream(recipe(), width, height)
    cot = np.random.default_rng(12).normal(
        size=(static[0], tcomp.NOUT, tcomp.NPIX)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p: jcomp.composite(p, *map(jnp.asarray, structure), *static,
                                  image_only, True), jnp.asarray(payload))
    want = np.asarray(vjp(jnp.asarray(cot))[0]).reshape(-1, 12)
    last = tcomp.F_B if image_only else tcomp.F_PSIZE
    n = int(structure[1].sum())
    for fn in (tcomp.composite, tcomp.composite_reference):
        p = t(payload).requires_grad_()
        out = fn(p, *map(t, structure), *static, image_only, True)
        out.backward(t(cot))
        got = p.grad.numpy().reshape(-1, 12)
        for c in range(last + 1):
            scale = np.abs(want[:, c]).max()
            assert scale > 0, c
            np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                       atol=2e-3 * scale + 1e-6,
                                       err_msg=f"{fn.__name__} col {c}")
        assert (got[:, last + 1:] == 0).all()
        assert (got[n * 32:] == 0).all()
        if stream == "edges":
            # Tile 2 saturates in its first sub-block (sub-block 3).
            assert (got[3 * 32:4 * 32] != 0).any()
            assert (got[4 * 32:7 * 32] == 0).all()
        else:
            assert (got[255 * 32:256 * 32] != 0).any()
            assert (got[256 * 32:258 * 32] == 0).all()


@functools.lru_cache(maxsize=None)
def _scene():
    """tests/test_rasterize.py's scene: 200 Gaussians, seed 1, SH 0."""
    return make_scene(n=N, seed=1, sh_degree=0)


def _jax_grads(flag):
    jcam, _ = cameras(W, H)
    settings = JSettings(backend="pallas", entry_cap=1 << 15, **{flag: True})

    def loss_fn(means3d, scales_, quats_, opac_, shs_, probe):
        out = jax_rasterize(
            jcam, means3d, opac_, shs=shs_, scales=scales_, quats=quats_,
            active_sh_degree=0, bg=jnp.asarray(BG), means2d_probe=probe,
            settings=settings)
        return jnp.sum(out.image * jnp.cos(out.image))

    args = [jnp.asarray(a) for a in _scene()] + [jnp.zeros((N, 2))]
    return jax.grad(loss_fn, argnums=tuple(range(6)))(*args)


def _torch_render(flags):
    _, tcam = cameras(W, H)
    leaves = [t(a).requires_grad_() for a in _scene()] + [
        torch.zeros((N, 2), requires_grad=True)]
    m, s, q, o, sh, probe = leaves
    out = trast.rasterize(tcam, m, o, shs=sh, scales=s, quats=q,
                          active_sh_degree=0, bg=torch.tensor(BG),
                          means2d_probe=probe,
                          settings=trast.RasterSettings(entry_cap=1 << 15,
                                                        **flags))
    loss = torch.sum(out.image * torch.cos(out.image))
    return out, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("flag", ["bwd_bf16", "grad_pack_bf16"])
def test_rasterize_bf16_grads_match_jax(flag):
    want = _jax_grads(flag)
    out, got = _torch_render({flag: True})
    assert int(out.overflow) == 0
    for name, e, p in zip(NAMES, want, got):
        e = np.asarray(e)
        assert np.abs(e).max() > 0, name
        _assert_bf16_grad_close(p.numpy(), e, f"{flag} {name}")


def test_bwd_bf16_forward_bit_identical():
    exact, g_exact = _torch_render({})
    fast, g_fast = _torch_render({"bwd_bf16": True})
    for f in ("image", "depth", "acc_pixel_size", "transmittance",
              "pixel_sizes", "radii"):
        assert torch.equal(getattr(exact, f), getattr(fast, f)), f
    # The backward did change: the bf16 path is in use.
    assert any(not torch.equal(a, b) for a, b in zip(g_exact, g_fast))
