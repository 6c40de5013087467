"""The benchmark's only door into the program (msgs_torch): the state and
camera it is handed, the two entries the windows drive (`train_step`,
`eval_render`), and the build. Everything else the benchmark runs is its
own. The checks' tests replace `train_step` or `eval_render` here to plant
a fault under a whole run.
"""
from __future__ import annotations

import torch

from msgs_torch.core.camera import make_camera
from msgs_torch.kernels.rasterize import RasterSettings
from msgs_torch.model.gaussians import GaussianConfig, GaussianState
from msgs_torch.train import loop as _loop
from msgs_torch.train.optimizer import OptimParams
from msgs_torch.train.loop import TrainState, init_train_state

train_step = _loop.train_step
eval_render = _loop.eval_render
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def build() -> float:
    """Build (or load from the checkout's build directory) the CUDA
    library; returns the seconds it took."""
    from msgs_torch.kernels import _build
    _build.load()
    return float(_build.build_info.get("seconds", 0.0))


def launch_counts() -> dict:
    from msgs_torch.kernels import _build
    return dict(_build.launch_counts)


def config(cfg: dict, n_levels: int) -> GaussianConfig:
    return GaussianConfig(sh_degree=cfg["sh_degree"], reso_lvls=n_levels,
                          capacity=cfg["capacity"])


def gaussian_state(fields: dict) -> GaussianState:
    return GaussianState(**{k: fields[k] for k in GaussianState._fields})


def train_state(fields: dict, iteration: int) -> TrainState:
    st = init_train_state(gaussian_state(fields))
    return st._replace(iteration=torch.tensor(
        iteration, dtype=torch.int32, device=fields["xyz"].device))


def camera(view, device):
    return make_camera(view.R, view.T, view.fovx, view.fovy, view.width,
                       view.height, device=device)


def settings(entry_cap: int, filter_small=False, filter_large=False,
             image_grads_only=False) -> RasterSettings:
    return RasterSettings(filter_small=filter_small,
                          filter_large=filter_large, entry_cap=entry_cap,
                          image_grads_only=image_grads_only)


def optim() -> OptimParams:
    return OptimParams()


def params_of(state) -> dict:
    return {k: getattr(state.gaussians, k) for k in PARAMS}


def first_moments(state) -> dict:
    return {k: state.adam.mu[k] for k in PARAMS}
