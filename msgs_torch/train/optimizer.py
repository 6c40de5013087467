"""Per-group Adam over the GaussianState parameter dict, as plain functions
on dicts of tensors.

Port of msgs/train/optimizer.py: the reference's 8 named groups with
eps=1e-15, fixed LRs per group (f_rest = feature_lr/20, occ/dc at 0 until
`ms_lr_active`), and xyz on a log-lerp exponential decay scaled by
`spatial_lr_scale`. The update keeps the JAX order of operations,
(mu/bc1)/(sqrt(nu/bc2)+eps); torch.optim.Adam rounds differently
(lr/bc1 as the step size, sqrt(nu)/sqrt(bc2)) and would not allow the
functional moment surgery (`zero_moments_at`) or the overflow discard of
the train step.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_F32 = torch.float32


class OptimParams(NamedTuple):
    """Mirror of the reference OptimizationParams + MS extras."""
    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_steps: int = 0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000):
    """Log-lerp exponential decay with an optional sine warm-up delay, in
    float32 on the device of `step` (an int or a 0-d tensor)."""
    step = torch.as_tensor(step).to(_F32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    f32 = lambda v: torch.tensor(v, dtype=_F32, device=step.device)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                         + torch.log(f32(lr_final)) * t)
    return delay_rate * log_lerp


def group_lrs(op: OptimParams, spatial_lr_scale: float, step,
              ms_lr_active=False):
    """Current per-group learning rates (float32 0-d tensors);
    `ms_lr_active` turns on the occ/dc groups."""
    xyz = expon_lr(step,
                   op.position_lr_init * spatial_lr_scale,
                   op.position_lr_final * spatial_lr_scale,
                   op.position_lr_delay_steps,
                   op.position_lr_delay_mult,
                   op.position_lr_max_steps)
    f32 = lambda v: torch.tensor(v, dtype=_F32, device=xyz.device)
    ms = torch.as_tensor(ms_lr_active, device=xyz.device).to(_F32)
    return {
        "xyz": xyz,
        "features_dc": f32(op.feature_lr),
        "features_rest": f32(op.feature_lr / 20.0),
        "opacity": f32(op.opacity_lr),
        "scaling": f32(op.scaling_lr),
        "rotation": f32(op.rotation_lr),
        "occ_multiplier": ms * op.opacity_lr,
        "dc_delta": ms * op.feature_lr * 0.1,
    }


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor   # () int32


def init_adam(params: dict) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=some.device))


def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict,
                b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step with per-group LRs (torch.optim.Adam semantics, eps
    added outside the square root). Returns (new params, new state); the
    inputs are not modified."""
    count = state.count + 1
    c = count.to(_F32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    new_mu, new_nu, new_p = {}, {}, {}
    for k in params:
        g = grads[k]
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new_p[k] = params[k] - lrs[k] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


def zero_moments_at(state: AdamState, touched: torch.Tensor) -> AdamState:
    """Zero the Adam moments of rows whose content was replaced."""
    def z(a):
        m = touched.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, 0.0, a)
    return AdamState(mu={k: z(v) for k, v in state.mu.items()},
                     nu={k: z(v) for k, v in state.nu.items()},
                     count=state.count)
