"""The benchmark's frozen trajectory against the app's."""
import numpy as np
import pytest

from benchmark import traj
from benchmark.scene import make_views
from msgs_torch.apps import traj as app


@pytest.mark.parametrize("n", [120, 7])
def test_circle_and_sweep_equal_the_app(n):
    import json
    from pathlib import Path
    cfg = json.loads((Path(traj.__file__).parent / "configs" /
                      "msgs-m360.json").read_text())
    views, _ = make_views(cfg)
    mine = traj.circle_trajectory(views, n)
    theirs = app.circle_trajectory(views, n)
    for (r1, t1), (r2, t2) in zip(mine, theirs):
        assert np.array_equal(r1, r2) and np.array_equal(t1, t2)
    for i in range(n):
        assert traj.sweep_scale(i, n, 1.0, 64.0) == \
            app.sweep_scale(i, n, 1.0, 64.0)


def test_frame_size_is_the_apps_rule():
    for scale in (1.0, 1.7, 9.3, 64.0):
        w, h = traj.frame_size(1237, 822, scale)
        assert w == max(int(1237 / scale) // 16 * 16, 16)
        assert h == max(int(822 / scale) // 16 * 16, 16)
