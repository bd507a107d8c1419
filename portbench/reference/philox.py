"""The step noise of the served sampler, recomputed.

At step t the sampler adds sqrt(beta_t) z to every element of a chunk's
(bucket, latent) state, row-major. Element e takes lane e % 4 of Philox4x32-10
on the counter (e // 4, t, 0, 0) under the chunk's key, turned into normals
by Box-Muller on the lane pair: (r0, r1) gives lanes 0 and 1, (r2, r3) lanes
2 and 3, with u1 = ((a >> 8) + 1) 2^-24 and u2 = (b >> 8) 2^-24 in f32.
Integers are held in int64 and kept to 32 bits by masks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def _mulhilo(a: int, b: torch.Tensor):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _M32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox4x32_10(c0: torch.Tensor, c1: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor):
    """Four 32-bit outputs of the counters (c0, c1, 0, 0) under keys (k0, k1),
    all int64 tensors that broadcast together."""
    c = [c0, c1 + torch.zeros_like(c0), torch.zeros_like(c0), torch.zeros_like(c0)]
    for rnd in range(10):
        if rnd:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c[0])
        hi1, lo1 = _mulhilo(0xCD9E8D57, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def step_noise(elements: torch.Tensor, keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Normals (S, R, L) f32: steps (S,) int64; elements (R, L) int64, each
    element's index in its chunk's row-major state; keys (R, 2) int64, the
    key of each row's chunk."""
    e = elements[None]
    k0, k1 = keys[None, :, 0:1], keys[None, :, 1:2]
    r = philox4x32_10(e // 4, steps[:, None, None], k0, k1)
    lane = e % 4
    a = torch.where(lane < 2, r[0], r[2])
    b = torch.where(lane < 2, r[1], r[3])
    u1 = ((a >> 8) + 1).to(torch.float32) * 2.0**-24
    u2 = (b >> 8).to(torch.float32) * 2.0**-24
    rad = torch.sqrt(-2.0 * torch.log(u1))
    th = u2 * _TWO_PI_F32
    return torch.where(lane % 2 == 0, rad * torch.cos(th), rad * torch.sin(th))
