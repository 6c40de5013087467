"""95th percentile (linear interpolation) of every window frame's time from
its dispatch to its image on the host, in ms."""
import numpy as np


def read(ctx):
    if ctx["kind"] != "render" or not ctx.get("frame_times"):
        return None
    return float(np.percentile(np.asarray(ctx["frame_times"]) * 1e3, 95))
