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
from tests.test_torch_composite_bwd import _static, _stream
from tests.torch_parity import cameras, t

W = H = 64
N = 200
BG = np.array([0.2, 0.3, 0.4], np.float32)
NAMES = ["means", "scales", "quats", "opac", "shs", "probe"]


@pytest.mark.parametrize("image_only", [False, True])
def test_bwd_bf16_plain_matches_jax(image_only):
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
