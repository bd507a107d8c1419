"""DDPM forward/reverse step math (port of flowerdiff/diffusion/ddpm.py).

`t` is a (B,) integer tensor; coefficients broadcast over trailing dims.
`ddpm_eps_loss` draws t and eps from a `torch.Generator`, or takes them from
the caller, which is how it is held against the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from flowerdiff_torch.diffusion.schedule import DiffusionSchedule


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    abar = _bcast(sched.alpha_bar[t], x0)
    return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * eps


def clip_eps_for_x0(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
                    eps_theta: torch.Tensor, clip_x0: float) -> torch.Tensor:
    """Clamp the implied x0 estimate to [-clip, clip] and return the
    equivalent epsilon (static x0-thresholding)."""
    abar = _bcast(sched.alpha_bar[t], xt)
    x0 = (xt - torch.sqrt(1.0 - abar) * eps_theta) / torch.sqrt(abar)
    x0 = torch.clamp(x0, -clip_x0, clip_x0)
    return (xt - torch.sqrt(abar) * x0) / torch.sqrt(1.0 - abar)


def p_sample_mean(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
                  eps_theta: torch.Tensor,
                  clip_x0: Optional[float] = None) -> torch.Tensor:
    """Posterior mean (xt - (1 - a_t) / sqrt(1 - abar_t) eps) / sqrt(a_t)."""
    if clip_x0 is not None:
        eps_theta = clip_eps_for_x0(sched, xt, t, eps_theta, clip_x0)
    alpha = _bcast(sched.alpha[t], xt)
    abar = _bcast(sched.alpha_bar[t], xt)
    return (xt - ((1.0 - alpha) / torch.sqrt(1.0 - abar)) * eps_theta) / torch.sqrt(alpha)


def p_sample(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
             eps_theta: torch.Tensor, noise: torch.Tensor,
             clip_x0: Optional[float] = None) -> torch.Tensor:
    """One ancestral step, sigma^2 = beta_t, no noise where t == 0."""
    mean = p_sample_mean(sched, xt, t, eps_theta, clip_x0)
    sigma = torch.sqrt(_bcast(sched.beta[t], xt))
    keep = _bcast((t > 0).to(xt.dtype), xt)
    return mean + sigma * noise * keep


def ddpm_eps_loss(sched: DiffusionSchedule, eps_fn: Callable[..., torch.Tensor],
                  generator: Optional[torch.Generator], x0: torch.Tensor,
                  *cond: torch.Tensor, distance: str = "euclidean",
                  t: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform-t epsilon-prediction loss. distance='euclidean' is the latent
    pipeline's per-sample L2 distance, 'mse' the pixel pipeline's MSE.
    t (B,) and eps (like x0) are drawn from `generator` unless given."""
    from flowerdiff_torch.losses.distances import euclidean_distance_loss

    if t is None:
        t = torch.randint(0, sched.n_steps, (x0.shape[0],), generator=generator,
                          device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    eps_theta = eps_fn(q_sample(sched, x0, t, eps), t, *cond)
    if distance == "euclidean":
        return euclidean_distance_loss(eps, eps_theta)
    if distance == "mse":
        return ((eps - eps_theta) ** 2).mean()
    raise ValueError(f"unknown distance {distance!r}")
