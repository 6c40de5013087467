"""msgs_torch rasterizer gradients vs the JAX package's, on the CPU.

The payload-gather VJP against msgs/kernels/rasterize.py:_gather_payload's
custom VJP, and gradients of whole renders (means, scales, quats,
opacities, SH and the means2d_probe screen gradient) against `jax.grad`
with the Pallas backend in interpret mode, for the losses of
tests/test_rasterize.py:test_grads_cross_backend (image + depth + acc + T)
and test_image_grads_only_matches_full (image only, under
image_grads_only). Budget: 3e-5·max|g| + 1e-6, the JAX suite's own."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.kernels.rasterize import RasterSettings as JSettings
from msgs.kernels.rasterize import _gather_payload as jax_gather_payload
from msgs.kernels.rasterize import rasterize as jax_rasterize
from msgs_torch.kernels import binning as tbin
from msgs_torch.kernels import rasterize as trast
from msgs_torch.kernels.preprocess import preprocess as torch_preprocess
from tests.helpers import make_scene
from tests.torch_parity import cameras, t

W = H = 64
N = 200
BG = np.array([0.2, 0.3, 0.4], np.float32)
NAMES = ["means", "scales", "quats", "opac", "shs", "probe"]


def assert_grad_close(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * scale + 1e-6,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _scene():
    """tests/test_rasterize.py's scene: 200 Gaussians, seed 1, SH 0."""
    return make_scene(n=N, seed=1, sh_degree=0)


@functools.lru_cache(maxsize=None)
def _binned():
    """The scene's entry stream (the port's binning, whose gid_starts equal
    JAX's exactly; both VJPs get the same gauss_id)."""
    means, scales, quats, opac, shs = _scene()
    _, tcam = cameras(W, H)
    pre = torch_preprocess(tcam, t(means), t(opac), shs=t(shs),
                           scales=t(scales), quats=t(quats),
                           active_sh_degree=0)
    b = tbin.bin_gaussians(pre, W, H, 1 << 15)
    return b.gauss_id.numpy(), b.gid_starts.numpy()


@pytest.mark.parametrize("image_only", [False, True])
def test_gather_vjp_matches_jax(image_only):
    gid, starts = _binned()
    table = np.random.default_rng(2).normal(size=(N + 1, 12)).astype(
        np.float32)
    g = np.random.default_rng(3).normal(size=(len(gid), 12)).astype(
        np.float32)

    _, vjp = jax.vjp(lambda tb: jax_gather_payload(
        tb, jnp.asarray(gid), jnp.asarray(starts), image_only, False),
        jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])

    tb = t(table).requires_grad_()
    rows = trast._GatherPayload.apply(tb, t(gid), t(starts), image_only)
    assert torch.equal(rows.detach(), t(table)[t(gid).long()])
    rows.backward(t(g))
    got = tb.grad.numpy()
    last = 8 if image_only else 10
    assert (got[:, last + 1:] == 0).all() and (got[N] == 0).all()
    for c in range(last + 1):
        assert np.abs(want[:, c]).max() > 0
        assert_grad_close(want[:, c], got[:, c], f"col {c}")


def _loss_jax(image_only):
    """The JAX side: test_grads_cross_backend's loss (image + depth + acc +
    T) or test_image_grads_only_matches_full's (image only)."""
    jcam, _ = cameras(W, H)

    def loss_fn(means3d, scales_, quats_, opac_, shs_, probe):
        settings = JSettings(backend="pallas", entry_cap=1 << 15,
                             image_grads_only=image_only)
        out = jax_rasterize(
            jcam, means3d, opac_, shs=shs_, scales=scales_, quats=quats_,
            active_sh_degree=0, bg=jnp.asarray(BG), means2d_probe=probe,
            settings=settings)
        loss = jnp.mean(out.image ** 2)
        if not image_only:
            loss = (loss + 0.1 * jnp.mean(out.depth)
                    + 0.1 * jnp.mean(out.acc_pixel_size)
                    + 0.01 * jnp.mean(out.transmittance))
        return loss
    return loss_fn


def _loss_torch(image_only):
    _, tcam = cameras(W, H)

    def loss_fn(means3d, scales_, quats_, opac_, shs_, probe):
        settings = trast.RasterSettings(entry_cap=1 << 15,
                                        image_grads_only=image_only)
        out = trast.rasterize(
            tcam, means3d, opac_, shs=shs_, scales=scales_, quats=quats_,
            active_sh_degree=0, bg=torch.tensor(BG), means2d_probe=probe,
            settings=settings)
        loss = torch.mean(out.image ** 2)
        if not image_only:
            loss = (loss + 0.1 * torch.mean(out.depth)
                    + 0.1 * torch.mean(out.acc_pixel_size)
                    + 0.01 * torch.mean(out.transmittance))
        return loss, out
    return loss_fn


def _assert_untied(means, scales, quats, opac, shs):
    """No two visible Gaussians share a depth quantum, so every tile's entry
    order is the same in both packages."""
    _, tcam = cameras(W, H)
    pre = torch_preprocess(tcam, t(means), t(opac), shs=t(shs),
                           scales=t(scales), quats=t(quats),
                           active_sh_degree=0)
    T = ((W + 15) // 16) * ((H + 15) // 16)
    dq = tbin._depth_quanta(pre, min(tbin._depth_bits(T), 23))
    dq = dq[pre.visible].numpy()
    assert len(np.unique(dq)) == len(dq)


@pytest.mark.parametrize("image_only", [False, True])
def test_rasterize_grads_match_jax(image_only):
    scene = _scene()
    _assert_untied(*scene)
    args = [np.asarray(a) for a in scene] + [np.zeros((N, 2), np.float32)]
    want = jax.grad(_loss_jax(image_only), argnums=tuple(range(6)))(
        *map(jnp.asarray, args))

    leaves = [t(a).requires_grad_() for a in args]
    loss, out = _loss_torch(image_only)(*leaves)
    assert int(out.overflow) == 0
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(NAMES, want, got):
        assert np.abs(np.asarray(a)).max() > 0, f"zero gradient for {name}"
        assert torch.isfinite(b).all(), name
        assert_grad_close(a, b.numpy(), f"grad {name}")
    if image_only:
        assert not out.depth.requires_grad
        assert not out.acc_pixel_size.requires_grad


def test_bf16_variants_raise():
    """The bf16 variants match the port's exact path. The test keeps the
    name it had while both flags raised NotImplementedError; it now checks
    that under each flag the forward is bit-identical to the exact path and
    the gradients meet tests/test_rasterize.py's bf16 criterion against the
    port's exact gradients. The comparison with the JAX package's bf16
    paths is in tests/test_torch_bwd_bf16.py."""
    from tests.test_rasterize import _assert_bf16_grad_close
    args = [np.asarray(a) for a in _scene()] + [np.zeros((N, 2), np.float32)]

    def run(**flags):
        leaves = [t(a).requires_grad_() for a in args]
        m, s, q, o, sh, probe = leaves
        _, tcam = cameras(W, H)
        out = trast.rasterize(tcam, m, o, shs=sh, scales=s, quats=q,
                              active_sh_degree=0, bg=torch.tensor(BG),
                              means2d_probe=probe,
                              settings=trast.RasterSettings(
                                  entry_cap=1 << 15, image_grads_only=True,
                                  **flags))
        loss = torch.sum(out.image * torch.cos(out.image))
        return out.image, torch.autograd.grad(loss, leaves[:5])

    img_e, exact = run()
    for flag in ("bwd_bf16", "grad_pack_bf16"):
        img, fast = run(**{flag: True})
        assert torch.equal(img, img_e), flag
        for name, e, p in zip(NAMES, exact, fast):
            _assert_bf16_grad_close(p.numpy(), e.numpy(), f"{flag} {name}")
