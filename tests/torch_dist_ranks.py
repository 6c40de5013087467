"""The rank side of tests/test_torch_dist.py: what each of the 8 ranks of a
2×4 mesh computes, on the CPU over gloo. It imports no JAX (every rank
imports this module); the test process holds the results against the JAX
package and against the port's single-device path."""
from __future__ import annotations

import numpy as np
import torch

CAP = 512
H, W = 128, 64  # 8 stripes of one tile row each
ENTRY_CAP = 1 << 12


def _numpy(state) -> dict:
    """{name: array} of a TrainState's tensors (gaussians and moments)."""
    g = state.gaussians
    out = {f"g.{k}": v.numpy().copy() for k, v in g._asdict().items()}
    out.update({f"mu.{k}": v.numpy().copy() for k, v in state.adam.mu.items()})
    out.update({f"nu.{k}": v.numpy().copy() for k, v in state.adam.nu.items()})
    out["count"] = state.adam.count.numpy().copy()
    return out


def _states_equal(a, b) -> bool:
    na, nb = _numpy(a), _numpy(b)
    return all(np.array_equal(na[k], nb[k]) for k in na)


def inputs(state_arrays: dict, cam, gt) -> dict:
    """What every rank gets: the Gaussian state as numpy arrays, the
    camera's matrices and the ground truth."""
    return {"state": state_arrays, "gt": np.asarray(gt, np.float32),
            "cam": (np.asarray(cam.world_view), np.asarray(cam.full_proj),
                    0.9, 0.9 * H / W, W, H)}


def all_cases(rank: int, inp: dict) -> dict:
    """Every sharded case of the test, on this rank."""
    from msgs_torch.core.camera import make_camera_from_matrices
    from msgs_torch.dist import shard as S
    from msgs_torch.dist.mesh import make_mesh
    from msgs_torch.kernels.rasterize import RasterSettings
    from msgs_torch.model.gaussians import GaussianConfig, state_from_numpy
    from msgs_torch.train.loop import init_train_state
    from msgs_torch.train.optimizer import OptimParams

    mesh = make_mesh(n_gauss=2, n_tile=4, device="cpu")
    cfg = GaussianConfig(sh_degree=1, reso_lvls=2, capacity=CAP)
    st = state_from_numpy(inp["state"], "cpu")
    cam = make_camera_from_matrices(*inp["cam"], device="cpu")
    hp = S.padded_height(H, mesh.n_stripes)
    gt = S.pad_gt(torch.tensor(inp["gt"]), hp)[mesh.stripe_rows(hp)]
    settings = RasterSettings(entry_cap=ENTRY_CAP)
    out = {"coord": (mesh.g, mesh.t)}

    # The sharded loss and its gradients (packet_cap = C_local: no packet
    # can overflow).
    local = S.shard_train_state(init_train_state(st), mesh, CAP).gaussians
    params, side = S.state_as_dicts(local)
    for lam in (0.0, 0.2):
        loss_fn = S.build_sharded_loss(mesh, cfg, settings, H, W,
                                       lambda_dssim=lam,
                                       packet_cap=CAP // 2)
        probe = torch.zeros((CAP // 2, 2))
        (loss, aux), (grads, pg) = S.sharded_value_and_grad(
            mesh, loss_fn, params, side, probe, cam, gt)
        out[f"loss_{lam}"] = {
            "loss": float(loss), "l1": float(aux.l1),
            "grads": {k: v.numpy() for k, v in grads.items()},
            "probe": pg.numpy(), "contributed": aux.contributed.numpy(),
            "radii": aux.radii.numpy(),
            "num_entries": int(aux.num_entries),
            "overflow": int(aux.overflow),
            "exch_overflow": int(aux.exch_overflow)}

    # Packet growth (the trainer's recovery loop): an undersized cap
    # overflows and leaves the state as it was; doubling converges to the
    # untruncated step.
    op = OptimParams()
    state0 = S.shard_train_state(init_train_state(st), mesh, CAP)

    def run(packet_cap):
        step = S.build_sharded_train_step(mesh, cfg, op, settings, H, W,
                                          spatial_lr_scale=1.0,
                                          packet_cap=packet_cap)
        return step(state0, cam, gt)

    s_big, m_big = run(CAP)
    attempts = []
    pc = 4
    while True:
        s_new, m = run(pc)
        attempts.append((pc, int(m["exch_overflow"]),
                         _states_equal(s_new, state0)))
        if int(m["exch_overflow"]) == 0 or pc > 4 * CAP:
            break
        pc *= 2
    out["growth"] = {
        "attempts": attempts,
        "loss_new": float(m["loss"]), "loss_big": float(m_big["loss"]),
        "exch_overflow_big": int(m_big["exch_overflow"]),
        "overflow_big": int(m_big["overflow"]),
        "num_live_big": int(m_big["num_live"]),
        "new": _numpy(s_new), "big": _numpy(s_big)}
    return out
