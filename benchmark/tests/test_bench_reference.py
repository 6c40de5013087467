"""The reference rasterizer against a per-pixel walk: every pixel visits
its tile's Gaussians in depth order, blends while T stays at or above
1e-4, and counts the entries it reads."""
import math

import numpy as np
import pytest
import torch

from benchmark import reference as ref
from benchmark.scene import look_at


def _scene(n=60, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.cat([torch.rand(n, 2, generator=g) * 2 - 1,
                     torch.rand(n, 1, generator=g) * 2 + 2], 1)
    return dict(
        xyz=xyz, scaling=torch.log(torch.rand(n, 3, generator=g) * 0.15
                                   + 0.02),
        rotation=torch.randn(n, 4, generator=g),
        opacity=torch.randn(n, 1, generator=g) * 2 + 1,
        features_dc=torch.randn(n, 1, 3, generator=g) * 0.5,
        features_rest=torch.randn(n, 15, 3, generator=g) * 0.05,
        live=torch.ones(n, dtype=torch.bool),
        max_pixel_sizes=-torch.ones(n), min_pixel_sizes=-torch.ones(n),
        base_mask=torch.zeros(n, dtype=torch.bool))


def _walk(pre, W, H):
    """Per-pixel front-to-back blending in float64, the tile lists taken
    from the rectangles, and each pixel's count of read entries."""
    P = {k: v.detach().double().numpy() if torch.is_tensor(v) and
         v.dtype.is_floating_point else v.numpy() for k, v in pre.items()}
    order = np.argsort(P["depth"], kind="stable")
    img = np.zeros((H, W, 3))
    pairs = 0
    for y in range(H):
        for x in range(W):
            tx, ty = x // 16, y // 16
            T, row = 1.0, []
            for i in order:
                if not P["visible"][i]:
                    continue
                x0, y0, x1, y1 = P["rect"][i]
                if not (x0 <= tx < x1 and y0 <= ty < y1):
                    continue
                row.append(i)
            # entries with no pixel of the tile at alpha >= 1/255 are not
            # needed by any pixel of it
            def alpha(i, px, py):
                dx, dy = P["mx"][i] - px, P["my"][i] - py
                pw = -0.5 * (P["ca"][i] * dx * dx + P["cc"][i] * dy * dy) \
                    - P["cb"][i] * dx * dy
                a = min(0.99, P["op"][i] * math.exp(pw))
                return a if (pw <= 0 and a >= 1 / 255) else 0.0
            xs = range(tx * 16, min(tx * 16 + 16, W))
            ys = range(ty * 16, min(ty * 16 + 16, H))
            needed = [i for i in row if any(alpha(i, px, py) > 0
                                             for px in xs for py in ys)]
            for i in needed:
                pairs += 1
                a = alpha(i, x, y)
                if a == 0.0:
                    continue
                if T * (1 - a) < 1e-4:
                    break
                img[y, x] += a * T * P["color"][i]
                T *= 1 - a
    return img, pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_a_per_pixel_walk(seed):
    W, H = 40, 24
    R, T = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 3.0), up=(0.0, -1.0, 0.0))
    cam = ref.make_cam(R, T, 1.2, 2 * math.atan(math.tan(0.6) * H / W),
                       W, H, "cpu")
    pre = ref.preprocess(_scene(seed=seed), cam)
    assert int(pre["visible"].sum()) > 20
    img, work = ref.render(pre, W, H, count=True, chunk_entries=64)
    want, pairs = _walk(pre, W, H)
    assert np.abs(img.double().numpy() - want).max() < 2e-5
    assert work["pairs"] == pairs


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.14159265])
    r = ref.tf32(x)
    assert r[0] == 1.0                      # a tie goes to even
    assert r[1] == 1.0 + 2 * 2 ** -10
    assert abs(float(r[2]) - 3.14159265) < 2 ** -10 * 2
    m = r.view(torch.int32) & 0x1FFF
    assert int(m.abs().sum()) == 0
