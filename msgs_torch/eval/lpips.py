"""LPIPS (VGG16 taps with learned linear heads) on tensors.

Port of msgs/eval/lpips_jax.py with its weight file and its formula: the
image, scaled to [−1, 1], is shifted and scaled per channel, runs through
VGG16's 13 convolutions (3×3, same padding, ReLU) with a 2×2 max pool
between blocks; the last ReLU of each of the 5 blocks is a tap. Each tap
is unit-normalised over channels, the squared difference of the two images'
taps is weighted per channel by the head (clamped at 0), summed over
channels and averaged over pixels, and the 5 terms are summed.

Pretrained weights cannot be fetched here: `lpips_fn` loads an npz made by
`export_weights_from_torch` (conv_{i}_w HWIO, conv_{i}_b, lin_{j}_w
(1, 1, c, 1)), from `path`, else $MSGS_LPIPS_WEIGHTS, else
`lpips_vgg16.npz` beside this file, and raises FileNotFoundError when there
is none. The convolutions are `F.conv2d` in float32 (msgs_torch turns TF32
off), as JAX computes them outside any Pallas kernel.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msgs_torch import resolve_device

WEIGHTS_ENV = "MSGS_LPIPS_WEIGHTS"
DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "lpips_vgg16.npz")

# VGG16's conv layout: (out_channels, convs) per block; a tap after each.
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """The VGG16 tower and the linear heads as buffers, built from the npz
    schema; `lpips(img, gt)` takes (H, W, 3) images in [0, 1] and returns a
    0-d tensor."""

    def __init__(self, weights: dict, device=None):
        super().__init__()
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        n_convs = sum(n for _, n in _VGG_BLOCKS)
        for i in range(n_convs):
            # HWIO → OIHW
            self.register_buffer(f"conv_{i}_w",
                                 t(weights[f"conv_{i}_w"]).permute(
                                     3, 2, 0, 1).contiguous())
            self.register_buffer(f"conv_{i}_b", t(weights[f"conv_{i}_b"]))
        for j in range(len(_VGG_BLOCKS)):
            self.register_buffer(f"lin_{j}_w", torch.clamp(
                t(weights[f"lin_{j}_w"]).reshape(-1), min=0.0))
        self.register_buffer("shift", t(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", t(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        """The 5 taps of (1, 3, H, W) input in [−1, 1]."""
        h = (x - self.shift) / self.scale
        feats, k = [], 0
        for bi, (_, n) in enumerate(_VGG_BLOCKS):
            for _ in range(n):
                h = F.relu(F.conv2d(h, getattr(self, f"conv_{k}_w"),
                                    getattr(self, f"conv_{k}_b"), padding=1))
                k += 1
            feats.append(h)
            if bi < len(_VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2)
        return feats

    @staticmethod
    def _unit_normalize(f):
        return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)

    @torch.no_grad()
    def forward(self, img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        chw = lambda a: (a.to(self.shift.device, torch.float32)
                         .permute(2, 0, 1)[None] * 2.0 - 1.0)
        total = torch.zeros((), dtype=torch.float32, device=self.shift.device)
        for j, (f1, f2) in enumerate(zip(self.features(chw(img)),
                                         self.features(chw(gt)))):
            d = (self._unit_normalize(f1) - self._unit_normalize(f2)) ** 2
            w = getattr(self, f"lin_{j}_w").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1))
        return total


def lpips_fn(path: Optional[str] = None, device=None) -> LPIPS:
    """The LPIPS module from an exported npz on `device` (None: the CUDA
    device). Raises FileNotFoundError when the weight file is absent."""
    path = path or os.environ.get(WEIGHTS_ENV, DEFAULT_PATH)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}. Export them once with "
            f"msgs_torch.eval.lpips.export_weights_from_torch on a machine "
            f"with torchvision, or set ${WEIGHTS_ENV}.")
    with np.load(path) as data:
        return LPIPS(dict(data), device)


def lpips_if_available(device=None) -> Optional[LPIPS]:
    """`lpips_fn(device=device)`, or None when there is no weight file (the
    apps then report PSNR and SSIM only, as the JAX apps do)."""
    try:
        return lpips_fn(device=device)
    except FileNotFoundError:
        return None


def export_weights_from_torch(out_path: str = DEFAULT_PATH) -> str:
    """On a machine with torchvision and its ImageNet VGG16 weights: export
    the conv weights (HWIO) and the LPIPS linear heads (from the `lpips`
    package where it imports, else uniform 1/c heads) to an npz."""
    import torchvision
    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
    out = {}
    i = 0
    for m in vgg:
        if isinstance(m, nn.Conv2d):
            out[f"conv_{i}_w"] = m.weight.detach().permute(2, 3, 1, 0).numpy()
            out[f"conv_{i}_b"] = m.bias.detach().numpy()
            i += 1
    try:
        import lpips as lpips_pkg
    except ImportError:
        for j, (ch, _) in enumerate(_VGG_BLOCKS):
            out[f"lin_{j}_w"] = np.full((1, 1, ch, 1), 1.0 / ch, np.float32)
    else:
        net = lpips_pkg.LPIPS(net="vgg")
        for j, lin in enumerate(net.lins):
            out[f"lin_{j}_w"] = lin.model[1].weight.detach().permute(
                2, 3, 1, 0).numpy()
    np.savez(out_path, **out)
    return out_path
