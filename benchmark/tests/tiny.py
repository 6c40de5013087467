"""Tiny versions of the cells, for runs on the CPU."""
import time

import torch

from benchmark import harness as H

CONFIG = dict(n_gaussians=3000, capacity=4096, width=64, height=48,
              n_views=10, entry_cap=1 << 16, max_scale_pow=2,
              aggregate_levels=[2])
MIX = {"msgs-m360.train": dict(levels={"0": 2, "2": 1}, readback_every=2),
       "msgs-m360.zoom": dict(n_frames=6, max_scale=4.0, check_frames=3),
       "3dgs-db.render": dict(n_frames=4, check_frames=2)}
SEED = 3_000_000_019   # past 32 signed bits, as the driver's seeds are
# Limits for this size: the cells' own are set from full-size readings,
# where the control's errors grow with the scene; at this size the
# program reads under 2e-5 and the control over 1e-4 (loss 1e-2).
LIMITS = {"img_mae": 2e-5, "loss_rel": 1e-3, "coarse_loss_rel": 1e-3,
          "grad_norm_gap": 1e-3, "update_norm_gap": 1e-3,
          "records_mismatch": 1e-3}


def run(workload, seed=SEED, seconds=0.0):
    torch.set_num_threads(2)
    return H.result_line(workload, seed, seconds, False, torch.device("cpu"),
                         time.perf_counter(), config_override=CONFIG,
                         mix_override=MIX[workload], limits_override=LIMITS)
