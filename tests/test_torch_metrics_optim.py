"""msgs_torch losses, metrics and optimizer vs the JAX package's, on the
CPU: l1, ssim, psnr and the photometric loss within 1e-6, the per-pixel
ssim_map within 1e-5; expon_lr, group_lrs, adam_update and
zero_moments_at within 1e-6 relative.

Why ssim_map gets 1e-5: the 11×11 window sums in another order in XLA's
convolution and in torch's (each is within ~4e-7 of a float64 convolution
of the same inputs), and σ² = E[x²] − μ² cancels, which lifts that to up
to ~5e-6 per pixel on these images; the mean over the image averages it
away below 1e-6 (ROADMAP.md, Faults)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgs.eval import metrics as jm
from msgs.train import optimizer as jo
from msgs_torch.eval import metrics as tm
from msgs_torch.train import optimizer as to
from tests.torch_parity import t

SHAPES = {"xyz": (40, 3), "features_dc": (40, 1, 3),
          "features_rest": (40, 3, 3), "scaling": (40, 3),
          "rotation": (40, 4), "opacity": (40, 1),
          "occ_multiplier": (40, 4), "dc_delta": (40, 4, 3)}


def _close(want, got, atol=1e-6, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _images(seed, H=37, W=52):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(
        np.float32)
    return img, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    img, gt = _images(seed)
    ji, jg = jnp.asarray(img), jnp.asarray(gt)
    ti, tg = t(img), t(gt)
    _close(jm.l1_loss(ji, jg), tm.l1_loss(ti, tg), what="l1")
    _close(jm.ssim_map(ji, jg), tm.ssim_map(ti, tg), atol=1e-5,
           what="ssim_map")
    _close(jm.ssim(ji, jg), tm.ssim(ti, tg), what="ssim")
    _close(jm.psnr(ji, jg), tm.psnr(ti, tg), atol=0, rtol=1e-6, what="psnr")
    _close(jm.photometric_loss(ji, jg), tm.photometric_loss(ti, tg),
           what="photometric_loss")
    assert tm.ssim_map(ti, tg).shape == img.shape


@pytest.mark.parametrize("delay", [0, 500])
def test_lr_schedules_match_jax(delay):
    op_j = jo.OptimParams(position_lr_delay_steps=delay)
    op_t = to.OptimParams(position_lr_delay_steps=delay)
    for step in (0, 1, 250, 7000, 29_999, 40_000):
        for ms in (False, True):
            want = jo.group_lrs(op_j, 3.7, jnp.int32(step), ms_lr_active=ms)
            got = to.group_lrs(op_t, 3.7,
                               torch.tensor(step, dtype=torch.int32),
                               ms_lr_active=ms)
            assert set(want) == set(got)
            for k in want:
                assert got[k].dtype == torch.float32, k
                _close(want[k], got[k], atol=0, rtol=1e-6, what=f"{k}@{step}")
    assert float(to.expon_lr(5, 0.0, 0.0)) == 0.0
    _close(jo.expon_lr(123, 1e-3, 1e-5, 10, 0.1, 1000),
           to.expon_lr(123, 1e-3, 1e-5, 10, 0.1, 1000), atol=0, rtol=1e-6)


def test_adam_update_and_zero_moments_match_jax():
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    lrs_np = {k: np.float32(rng.uniform(1e-4, 1e-2)) for k in SHAPES}
    j_state = jo.init_adam({k: jnp.asarray(v) for k, v in params.items()})
    t_state = to.init_adam({k: t(v) for k, v in params.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: t(v) for k, v in params.items()}
    for it in range(3):
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, s)
                     ).astype(np.float32) for k, s in SHAPES.items()}
        jp, j_state = jo.adam_update(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, j_state,
            {k: jnp.asarray(v) for k, v in lrs_np.items()})
        tp, t_state = to.adam_update(
            tp, {k: t(v) for k, v in grads.items()}, t_state,
            {k: t(v) for k, v in lrs_np.items()})
        assert int(t_state.count) == it + 1
        assert t_state.count.dtype == torch.int32
        for k in SHAPES:
            _close(j_state.mu[k], t_state.mu[k], atol=0, rtol=1e-6,
                   what=f"mu {k}")
            _close(j_state.nu[k], t_state.nu[k], atol=0, rtol=1e-6,
                   what=f"nu {k}")
            _close(jp[k], tp[k], atol=1e-7, rtol=1e-6, what=f"param {k}")
    touched = rng.uniform(size=40) < 0.3
    jz = jo.zero_moments_at(j_state, jnp.asarray(touched))
    tz = to.zero_moments_at(t_state, t(touched))
    for k in SHAPES:
        _close(jz.mu[k], tz.mu[k], atol=0, what=f"zeroed mu {k}")
        _close(jz.nu[k], tz.nu[k], atol=0, what=f"zeroed nu {k}")
        assert (tz.mu[k][t(touched)] == 0).all()
    assert int(tz.count) == int(t_state.count)
