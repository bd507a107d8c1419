"""Reverse-diffusion samplers (port of flowerdiff/diffusion/sampler.py):
plain per-step loops over the f32 eps function.

- `sample`: full ancestral sampling, steps t = T-1 .. 0. It is also the
  plain whole-path oracle for the kernel sampler.
- `sample_from(x_t, t_start)`: steps t = t_start-1 .. 0 (t_start steps),
  as the reference's `_reverse_scan` with t0 = t_start - 1. Note that
  `DiffusionSampler.sample_from(x_t, t_start)` in diffusion/api.py runs the
  masked loop, which applies the steps t_start .. 0: one step more. Each
  is ported as its reference computes it.
- `sample_with_trajectory`: full sampling that also returns every state:
  trajectory[i] is the state after the step at t = T-1-i, so
  trajectory[-1] is x0.
- `ddim_sample`: DDIM (Song et al. 2021) over `num_steps` strided
  timesteps ts = round(i (T-1) / max(S-1, 1)) in float32, rounded half to
  even, taken in reverse; ᾱ of the step after the last reads 1.

Randomness comes from an explicit `torch.Generator`: x (unless `x_init` is
given), then one standard normal draw of x's shape a step (none with
`stochastic=False`, which runs the posterior-mean recursion, or in DDIM
with eta = 0, whose step noise is multiplied by sigma = 0).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from flowerdiff_torch.diffusion.ddpm import p_sample, p_sample_mean
from flowerdiff_torch.diffusion.schedule import DiffusionSchedule
from flowerdiff_torch.parallel.mesh import all_gather_rows, data_size, local_rows

EpsFn = Callable[..., torch.Tensor]


def _start(shape, generator, device, x_init) -> torch.Tensor:
    if x_init is None:
        return torch.randn(shape, generator=generator, device=device)
    return x_init.to(device=device, dtype=torch.float32)


@torch.no_grad()
def _reverse_scan(sched: DiffusionSchedule, eps_fn: EpsFn, x: torch.Tensor, cond: tuple,
                  t_start: int, collect: bool, clip_x0: Optional[float] = None,
                  generator: Optional[torch.Generator] = None, stochastic: bool = True,
                  mesh=None):
    """The ancestral step at t = t_start-1 .. 0 from x: (x, the (t_start, B,
    ...) stack of the state after each step when `collect`, else None).
    Under `mesh` x is this rank's rows and each step's noise the rank's
    rows of the global batch's draw."""
    sched = sched.to(x.device)
    noise_shape = (x.shape[0] * data_size(mesh),) + tuple(x.shape[1:])
    states = []
    for t in range(t_start - 1, -1, -1):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, t_vec, *cond)
        if stochastic:
            noise = local_rows(mesh, torch.randn(noise_shape, generator=generator,
                                                 device=x.device))
            x = p_sample(sched, x, t_vec, eps, noise, clip_x0)
        else:
            x = p_sample_mean(sched, x, t_vec, eps, clip_x0)
        if collect:
            states.append(x)
    return x, (torch.stack(states) if collect else None)


def sample(sched: DiffusionSchedule, eps_fn: EpsFn, shape: tuple, *cond: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           device=None, clip_x0: Optional[float] = None,
           x_init: Optional[torch.Tensor] = None,
           stochastic: bool = True, mesh=None) -> torch.Tensor:
    """Full ancestral sampling from N(0, I) (or from `x_init`). Under a
    data-parallel `mesh` (parallel/mesh.py) the request's rows are split
    over the "data" ranks: each rank runs its rows of the global start and
    of every step's noise, and the rows are gathered back, equal to the
    unsplit run's."""
    x = local_rows(mesh, _start(shape, generator, device, x_init))
    cond = tuple(local_rows(mesh, c) for c in cond)
    x = _reverse_scan(sched, eps_fn, x, cond, sched.n_steps, False, clip_x0, generator,
                      stochastic, mesh)[0]
    return all_gather_rows(mesh, x)


def sample_from(sched: DiffusionSchedule, eps_fn: EpsFn, x_t: torch.Tensor, t_start: int,
                *cond: torch.Tensor, generator: Optional[torch.Generator] = None,
                clip_x0: Optional[float] = None, stochastic: bool = True) -> torch.Tensor:
    """Denoise x_t with the steps t = t_start-1 .. 0."""
    x = x_t.to(torch.float32)
    return _reverse_scan(sched, eps_fn, x, cond, t_start, False, clip_x0, generator,
                         stochastic)[0]


def sample_with_trajectory(sched: DiffusionSchedule, eps_fn: EpsFn, shape: tuple,
                           *cond: torch.Tensor, generator: Optional[torch.Generator] = None,
                           device=None, clip_x0: Optional[float] = None,
                           x_init: Optional[torch.Tensor] = None, stochastic: bool = True):
    """(x0, trajectory (T, *shape)): trajectory[i] is the state after the
    step at t = T-1-i, so trajectory[-1] == x0."""
    x = _start(shape, generator, device, x_init)
    return _reverse_scan(sched, eps_fn, x, cond, sched.n_steps, True, clip_x0, generator,
                         stochastic)


def ddim_timesteps(n_steps: int, num_steps: int) -> torch.Tensor:
    """The DDIM steps, descending: round(i * (T-1) / max(S-1, 1)) for
    i < S, computed in float32 and rounded half to even."""
    stride = torch.tensor((n_steps - 1) / max(num_steps - 1, 1), dtype=torch.float32)
    idx = torch.arange(num_steps, dtype=torch.float32)
    return torch.round(idx * stride).to(torch.long).flip(0)


@torch.no_grad()
def ddim_sample(sched: DiffusionSchedule, eps_fn: EpsFn, shape: tuple, *cond: torch.Tensor,
                num_steps: int = 50, eta: float = 0.0,
                generator: Optional[torch.Generator] = None, device=None,
                clip_x0: Optional[float] = None,
                x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM over `num_steps` strided timesteps (eta = 0: deterministic).
    A step from t to t_prev: x0 = (x - sqrt(1 - ᾱ_t) eps) / sqrt(ᾱ_t),
    clipped to +-clip_x0 with eps recomputed from the clipped x0; sigma =
    eta sqrt((1 - ᾱ_prev) / (1 - ᾱ_t)) sqrt(1 - ᾱ_t / ᾱ_prev); x =
    sqrt(ᾱ_prev) x0 + sqrt(max(1 - ᾱ_prev - sigma^2, 0)) eps + sigma z."""
    x = _start(shape, generator, device, x_init)
    sched = sched.to(x.device)
    ts = ddim_timesteps(sched.n_steps, num_steps).tolist()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, t_vec, *cond)
        abar_t = sched.alpha_bar[t]
        abar_prev = sched.alpha_bar[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
        if clip_x0 is not None:
            x0 = torch.clamp(x0, -clip_x0, clip_x0)
            eps = (x - torch.sqrt(abar_t) * x0) / torch.sqrt(1.0 - abar_t)
        sigma = (eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar_t))
                 * torch.sqrt(1.0 - abar_t / abar_prev))
        dir_xt = torch.sqrt(torch.clamp(1.0 - abar_prev - sigma**2, min=0.0)) * eps
        x = torch.sqrt(abar_prev) * x0 + dir_xt
        if eta != 0.0:
            x = x + sigma * torch.randn(x.shape, generator=generator, device=x.device)
    return x
