"""The kinds of traffic: each mix's runner is found by its `kind`; the
training sequence gives every seed the same steps block by block, in
another order; and the reference keeps TF32 off whatever the process
has set."""
import json
from collections import Counter
from pathlib import Path

import torch

from benchmark import harness as H
from benchmark import reference as ref

REPO = Path(__file__).resolve().parents[2]
MIX = json.loads((REPO / "benchmark" / "traffic" /
                  "ms-plain-steps.json").read_text())


def test_every_mix_has_a_runner():
    for path in (REPO / "benchmark" / "traffic").glob("*.json"):
        kind = json.loads(path.read_text())["kind"]
        assert callable(H.kind(kind).run), path.name


def _blocks(seed, n_views=169, n_blocks=14):
    seq = H.kind("train").sequence(MIX, n_views, seed)
    cyc = sum(MIX["levels"].values())
    steps = [next(seq) for _ in range(cyc * n_blocks)]
    return [steps[i:i + cyc] for i in range(0, len(steps), cyc)]


def test_every_seed_takes_the_same_steps_block_by_block():
    a, b = _blocks(3_000_000_019), _blocks(4_300_000_011)
    assert [Counter(x) for x in a] == [Counter(x) for x in b]
    assert a != b
    counts = Counter(l for x in a for _, l in x)
    assert counts == Counter({int(l): c * len(a)
                              for l, c in MIX["levels"].items()})
    # Views without replacement within an epoch: the blocks inside the
    # first 169 steps repeat no view, and the next 169 hold every view.
    views = [v for x in a for v, _ in x]
    assert len(set(views[:168])) == 168
    assert set(views[168:337]) | set(views[:168]) == set(range(169))
    for blocks in (a, b):
        assert blocks[0][0][1] == 0 and blocks[0][1][1] > 0


def _ssim_flags(monkeypatch):
    seen = []
    conv = ref.F.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return conv(*a, **kw)
    monkeypatch.setattr(ref.F, "conv2d", spy)
    return seen


def test_the_reference_keeps_tf32_off(monkeypatch):
    seen = _ssim_flags(monkeypatch)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    g = torch.Generator().manual_seed(0)
    img = torch.rand(40, 56, 3, generator=g).to(dev)
    gt = torch.rand(40, 56, 3, generator=g).to(dev)
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        out = {}
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            out[on] = ref.photometric_loss(img, gt)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (on, on)
        assert torch.equal(out[False], out[True])
        assert seen and all(f == (False, False) for f in seen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
