"""The training step and the render entry points over a Gaussian state.

Port of msgs/train/loop.py: `render_state`, `eval_render`, `TrainState`,
`init_train_state` and `train_step` (render → (1−λ)·L1 + λ·(1−SSIM) →
backward → per-group Adam → pixel-size, max-radii, densification-stat and
base-mask updates, with a step whose binning overflowed discarded), and the
structural steps the trainer runs at their cadences (`densify_step`,
`grow_step`, `reset_opacity_step`, `insert_large_step`), each of which
zeroes the Adam moments of the rows it replaced.

PyTorch runs eagerly: `train_step` builds the render's autograd graph,
takes the gradients with `torch.autograd.grad`, and does everything after
that under `torch.no_grad()`. It returns a new TrainState; the input
state's tensors are not modified.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from msgs_torch import resolve_device
from msgs_torch.eval.metrics import l1_loss, ssim
from msgs_torch.kernels.rasterize import RasterSettings, RenderOutput, rasterize
from msgs_torch.model import gaussians as G
from msgs_torch.model.gaussians import GaussianConfig, GaussianState, \
    state_from_numpy
from msgs_torch.ms.voxel import insert_large_gaussians
from msgs_torch.trace import span
from msgs_torch.train.optimizer import AdamState, OptimParams, \
    adam_update, group_lrs, init_adam, zero_moments_at


class TrainState(NamedTuple):
    gaussians: GaussianState
    adam: AdamState
    iteration: torch.Tensor   # () int32


def init_train_state(st: GaussianState) -> TrainState:
    return TrainState(gaussians=st, adam=init_adam(st.params()),
                      iteration=torch.zeros((), dtype=torch.int32,
                                            device=st.xyz.device))


def train_state_from_numpy(arrays: dict, device=None) -> TrainState:
    """A TrainState from numpy arrays — how a JAX TrainState carries
    across: {"gaussians": {field: array}, "mu": {param: array},
    "nu": {param: array}, "count": array, "iteration": array}."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.array(a), device=dev)
    return TrainState(
        gaussians=state_from_numpy(arrays["gaussians"], dev),
        adam=AdamState(mu={k: t(v) for k, v in arrays["mu"].items()},
                       nu={k: t(v) for k, v in arrays["nu"].items()},
                       count=t(arrays["count"])),
        iteration=t(arrays["iteration"]))


def render_state(st: GaussianState, camera, cfg: GaussianConfig,
                 settings: RasterSettings, *, bg=None, reso_lvl: int = 0,
                 fade_size: float = 0.0, scale_modifier: float = 1.0,
                 means2d_probe=None, override_color=None,
                 active_sh_degree=None) -> RenderOutput:
    """Render a GaussianState through the rasterizer, on the device its
    tensors live on; differentiable in the state's parameters and in
    `means2d_probe`."""
    # The state's activations and SH concat are preprocess's first part.
    with span("msgs.preprocess"):
        kw = dict(
            opacities=st.act_opacity(),
            shs=None if override_color is not None else st.shs(),
            colors_precomp=override_color,
            scales=st.act_scales(scale_modifier),
            quats=st.act_rotation(),
            active_sh_degree=(st.active_sh_degree if active_sh_degree is None
                              else active_sh_degree),
            bg=bg,
            live_mask=st.live,
            means2d_probe=means2d_probe,
            fade_size=fade_size,
            max_pixel_sizes=st.max_pixel_sizes,
            min_pixel_sizes=st.min_pixel_sizes,
            base_mask=st.base_mask,
            occ_multiplier=st.act_occ(cfg.multi_occ),
            dc_delta=st.dc_delta if cfg.multi_dc else None,
            reso_lvl=reso_lvl,
            settings=settings,
        )
    return rasterize(camera, st.xyz, **kw)


def _grads(loss, leaves):
    """d loss / d leaves; a leaf the render does not use (occ_multiplier
    without multi_occ, dc_delta without multi_dc) gets zeros, as in JAX."""
    with span("msgs.backward"):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


def train_step(state: TrainState, camera, gt_image, *,
               cfg: GaussianConfig, op: OptimParams,
               settings: RasterSettings, reso_lvl: int,
               spatial_lr_scale: float, lambda_dssim: float = 0.2,
               loss_mult: float = 1.0, fade_size: float = 0.0,
               do_px_update=True, do_densify_stats=True,
               do_base_mask=False, ms_lr_active=False):
    """One optimization step at a fixed resolution level: render, weighted
    photometric loss, backward, Adam with per-group LRs (xyz on the expon
    schedule), then the pixel-size stats, max radii, densification stats
    and base mask under their gates (bools or 0-d bool tensors). A step
    whose binning overflowed changes nothing but the iteration counter.
    Returns (new state, metrics)."""
    with span("msgs.train_step"):
        st = state.gaussians
        dev = st.xyz.device
        params = {k: v.detach().requires_grad_()
                  for k, v in st.params().items()}
        probe = torch.zeros((st.xyz.shape[0], 2), dtype=torch.float32,
                            device=dev, requires_grad=True)
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            out = render_state(st.with_params(params), camera, cfg,
                               settings, bg=bg, reso_lvl=reso_lvl,
                               fade_size=fade_size, means2d_probe=probe)
            with span("msgs.loss"):
                l1 = l1_loss(out.image, gt_image)
                loss = ((1.0 - lambda_dssim) * l1
                        + lambda_dssim * (1.0 - ssim(out.image, gt_image))) \
                    * loss_mult
            *gs, probe_grad = _grads(loss, list(params.values()) + [probe])
        grads = dict(zip(params, gs))

        with span("msgs.update"), torch.no_grad():
            lrs = group_lrs(op, spatial_lr_scale, state.iteration,
                            ms_lr_active=ms_lr_active)
            new_params, new_adam = adam_update(st.params(), grads,
                                               state.adam, lrs)
            new = st.with_params(new_params)

            gate = lambda b: torch.as_tensor(b, device=dev)
            vis = out.visible
            px = torch.where(gate(do_px_update), out.pixel_sizes.detach(),
                             0.0)
            new = G.update_pixel_sizes(new, px, reso_lvl, cfg.reso_lvls)
            ds = gate(do_densify_stats)
            new = G.update_max_radii(new, out.radii, vis & ds)
            new = G.add_densification_stats(new, probe_grad * ds, vis & ds,
                                            reso_lvl)
            new = G.update_base_mask(new, vis & gate(do_base_mask))

            # Overflow safety: a step whose binning truncated entries
            # rendered (and differentiated) a wrong image; keep the old
            # state.
            ok = out.overflow == 0
            keep = lambda a, b: torch.where(ok, a, b)
            new = GaussianState(*(keep(a, b) for a, b in zip(new, st)))
            new_adam = AdamState(
                mu={k: keep(v, state.adam.mu[k])
                    for k, v in new_adam.mu.items()},
                nu={k: keep(v, state.adam.nu[k])
                    for k, v in new_adam.nu.items()},
                count=keep(new_adam.count, state.adam.count))

            metrics = {"loss": loss.detach(), "l1": l1.detach(),
                       "num_entries": out.num_entries,
                       "overflow": out.overflow, "num_live": new.num_live}
        return TrainState(gaussians=new, adam=new_adam,
                          iteration=state.iteration + 1), metrics


def densify_step(state: TrainState, key=None, *, op: OptimParams,
                 scene_extent: float, max_screen_size: float,
                 noise=None) -> TrainState:
    """The level-0 densify-and-prune pass. `key` is the torch.Generator the
    split draws its offsets from (or `noise`, (2, C, 3), the draws
    themselves)."""
    st, touched = G.densify_and_prune(
        state.gaussians, key,
        grad_threshold=op.densify_grad_threshold,
        min_opacity=0.005,
        scene_extent=scene_extent,
        max_screen_size=max_screen_size,
        percent_dense=op.percent_dense,
        noise=noise)
    return state._replace(gaussians=st,
                          adam=zero_moments_at(state.adam, touched))


def grow_step(state: TrainState, lvl: int, *, op: OptimParams) -> TrainState:
    st, touched = G.grow_large_gaussians(
        state.gaussians, lvl, grad_threshold=op.densify_grad_threshold)
    return state._replace(gaussians=st,
                          adam=zero_moments_at(state.adam, touched))


def reset_opacity_step(state: TrainState) -> TrainState:
    """Opacity reset; zeroes only the opacity group's moments at the reset
    rows (the reference swaps just the opacity tensor in its optimizer)."""
    st, touched = G.reset_opacity(state.gaussians)
    adam = state.adam
    m = touched[:, None]
    adam = adam._replace(
        mu={**adam.mu, "opacity": torch.where(m, 0.0, adam.mu["opacity"])},
        nu={**adam.nu, "opacity": torch.where(m, 0.0, adam.nu["opacity"])})
    return state._replace(gaussians=st, adam=adam)


def insert_large_step(state: TrainState, mask, cur_min_pixel_sizes, lvl, *,
                      scene_extent: float, voxel_reso: float):
    """Voxel-insert the masked rows as level-`lvl` aggregates. Returns
    (state, n_inserted as a 0-d int32 tensor)."""
    st, touched, n_ins = insert_large_gaussians(
        state.gaussians, mask, cur_min_pixel_sizes, lvl, scene_extent,
        voxel_reso)
    return (state._replace(gaussians=st,
                           adam=zero_moments_at(state.adam, touched)),
            n_ins)


def eval_render(state, camera, *, cfg: GaussianConfig,
                settings: RasterSettings, reso_lvl: int = 0,
                fade_size: float = 0.0, bg=None,
                scale_modifier: float = 1.0) -> RenderOutput:
    """Render for evaluation or serving, without autograd. `state` is a
    GaussianState or any object with a `.gaussians` field holding one."""
    st = getattr(state, "gaussians", state)
    with span("msgs.eval_render"), torch.no_grad():
        return render_state(st, camera, cfg, settings, bg=bg,
                            reso_lvl=reso_lvl, fade_size=fade_size,
                            scale_modifier=scale_modifier)
