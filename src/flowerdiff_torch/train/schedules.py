"""Learning-rate schedules (port of flowerdiff/train/schedules.py).

`cosine_warm_restarts_schedule`: SGDR cosine annealing with warm restarts,
epoch-granular, as a pure function of the optimizer's global step: the
float epoch is step / steps_per_epoch (no floor). With t_mult = 2 the
restarts fall at epochs t0 (2^k - 1): 10, 30, 70 for t0 = 10. The arithmetic
is float32 in the reference's order, so the cycle index at a restart
boundary comes out as the reference's does.

`onecycle_schedule` and the VAE-GAN loss gates come with the VAE-GAN slice.
"""
from __future__ import annotations

import math
from typing import Callable

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
