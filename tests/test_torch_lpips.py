"""msgs_torch's LPIPS against msgs/eval/lpips_jax.py:build_lpips on the
same seeded synthetic weights (tests/test_lpips.py: the real VGG16 layout,
random values; no pretrained weights exist offline): rtol 2e-4, the JAX
suite's LPIPS tolerance, at two sizes, one of them not a multiple of 16 (the
pools floor odd sizes); the distance of an image to itself < 1e-9; the
weight-file lookup through $MSGS_LPIPS_WEIGHTS, and FileNotFoundError
without a file."""
import numpy as np
import pytest
import torch

from msgs.eval.lpips_jax import build_lpips
from msgs_torch.eval import lpips as tl
from tests.test_lpips import _synthetic_weights


@pytest.mark.parametrize("size", [(32, 32), (40, 56)])
def test_lpips_matches_jax(size):
    rng = np.random.default_rng(7)
    weights = _synthetic_weights(rng)
    img = rng.uniform(0, 1, size + (3,)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(
        np.float32)
    port = tl.LPIPS(weights, device="cpu")
    ours = float(port(torch.as_tensor(img), torch.as_tensor(gt)))
    want = float(build_lpips(weights)(img, gt))
    assert ours > 0.0
    np.testing.assert_allclose(ours, want, rtol=2e-4)
    assert float(port(torch.as_tensor(img), torch.as_tensor(img))) < 1e-9


def test_lpips_fn_weight_file(tmp_path, monkeypatch):
    path = str(tmp_path / "w.npz")
    monkeypatch.setenv(tl.WEIGHTS_ENV, path)
    with pytest.raises(FileNotFoundError):
        tl.lpips_fn(device="cpu")
    assert tl.lpips_if_available(device="cpu") is None
    weights = _synthetic_weights(np.random.default_rng(1))
    np.savez(path, **weights)
    img = np.random.default_rng(2).uniform(0, 1, (24, 24, 3)).astype(
        np.float32)
    gt = img[::-1].copy()
    got = float(tl.lpips_fn(device="cpu")(torch.as_tensor(img),
                                          torch.as_tensor(gt)))
    want = float(tl.lpips_if_available(device="cpu")(torch.as_tensor(img),
                                                      torch.as_tensor(gt)))
    assert got == want == float(tl.LPIPS(weights, "cpu")(
        torch.as_tensor(img), torch.as_tensor(gt)))
