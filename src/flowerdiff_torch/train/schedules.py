"""Learning-rate and loss-gate schedules (port of
flowerdiff/train/schedules.py).

`cosine_warm_restarts_schedule`: SGDR cosine annealing with warm restarts,
epoch-granular, as a pure function of the optimizer's global step: the
float epoch is step / steps_per_epoch (no floor). With t_mult = 2 the
restarts fall at epochs t0 (2^k - 1): 10, 30, 70 for t0 = 10. The arithmetic
is float32 in the reference's order, so the cycle index at a restart
boundary comes out as the reference's does.

`onecycle_schedule`: the reference's one-cycle schedule, which is optax's
`cosine_onecycle_schedule` (not torch's `OneCycleLR`, which places its
cosine phases differently), written out in float32 in optax's order: the
interval ends and half-differences of the cumulative values in float64,
rounded to float32, the position in the interval and the cosine in float32.

`vae_gan_loss_gates`: the VAE-GAN objective's staged gates of an epoch
(recon only before 40, the KL ramp to 80, the classifier ramp to 160, then
the center loss; the EMA center update from epoch 60 when the center term
is on) and the KL weight's linear ramp over the first 60% of the epochs.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np

_F = np.float32


def cosine_warm_restarts_schedule(base_lr: float, steps_per_epoch: int, t0: int = 10,
                                  t_mult: int = 2,
                                  eta_min: float = 0.0) -> Callable[[int], float]:
    """schedule(step) -> learning rate (a Python float holding an f32)."""

    def schedule(step: int) -> float:
        epoch = _F(step) / _F(steps_per_epoch)
        if t_mult == 1:
            t_cur = np.mod(epoch, _F(t0))
            t_i = _F(t0)
        else:
            # cycle index k = floor(log_{t_mult}(epoch / t0 * (t_mult - 1) + 1))
            k = np.floor(np.log(epoch / _F(t0) * _F(t_mult - 1.0) + _F(1.0))
                         / _F(math.log(t_mult)))
            start = _F(t0) * (np.power(_F(t_mult), k) - _F(1.0)) / _F(t_mult - 1.0)
            t_i = _F(t0) * np.power(_F(t_mult), k)
            t_cur = epoch - start
        lr = _F(eta_min) + _F(0.5) * _F(base_lr - eta_min) * (
            _F(1.0) + np.cos(_F(np.pi) * t_cur / t_i))
        return float(lr)

    return schedule


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0,
                      final_div_factor: float = 1000.0) -> Callable[[int], float]:
    """schedule(step) -> learning rate (a Python float holding an f32):
    cosine from max_lr / div_factor up to max_lr over the first
    int(pct_start * total_steps) steps, cosine down to max_lr / (div_factor
    * final_div_factor) at total_steps, constant after."""
    if total_steps <= 0:
        raise ValueError("onecycle_schedule needs total_steps > 0")
    bounds = np.array([0, int(pct_start * total_steps), int(total_steps)], np.int64)
    values = np.cumprod(np.array([max_lr / div_factor, div_factor,
                                  1.0 / (div_factor * final_div_factor)]))
    ends = values[1:].astype(_F)
    halves = ((values[:-1] - values[1:]) / 2.0).astype(_F)
    sizes = (bounds[1:] - bounds[:-1]).astype(_F)

    def schedule(step: int) -> float:
        inside = (bounds[:-1] <= step) & (step < bounds[1:])
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (step - bounds[:-1]).astype(_F) / sizes
        interp = ends + halves * (np.cos(_F(np.pi) * pct) + _F(1.0))
        lr = np.where(inside, interp, _F(0.0)).sum(dtype=_F)
        if bounds[-1] <= step:
            lr = lr + _F(values[-1])
        return float(lr)

    return schedule


class LossGates(NamedTuple):
    """An epoch's scalar gates of the VAE-GAN objective, the same for every
    step of the epoch."""
    kl_weight: float
    kl_factor: float
    cls_factor: float
    center_factor: float
    update_centers: float  # 1.0 once epoch >= 60 and center_factor > 0


def vae_gan_loss_gates(epoch: int, num_epochs: int, kl_weight_start: float = 0.001,
                       kl_weight_end: float = 0.05) -> LossGates:
    kl_weight = min(kl_weight_end, kl_weight_start
                    + (epoch / (num_epochs * 0.6)) * (kl_weight_end - kl_weight_start))
    if epoch < 40:
        kl_f, cls_f, cen_f = 0.0, 0.0, 0.0
    elif epoch < 80:
        kl_f, cls_f, cen_f = min(1.0, (epoch - 20) / 20), 0.0, 0.0
    elif epoch < 160:
        kl_f, cls_f, cen_f = 1.0, min(0.2, (epoch - 40) / 20), 0.0
    else:
        kl_f, cls_f, cen_f = 1.0, 1.0, min(1.0, (epoch - 60) / 20)
    update = 1.0 if (epoch >= 60 and cen_f > 0) else 0.0
    return LossGates(kl_weight, kl_f, cls_f, cen_f, update)
