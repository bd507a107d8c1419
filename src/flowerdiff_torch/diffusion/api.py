"""Sampling facade (port of flowerdiff/diffusion/api.py).

`DiffusionSampler` holds (model, schedule) and samples with the plain f32
model: ancestral `sample`, `sample_from`, `masked_denoise`,
`sample_with_trajectory`, `ddim` and one `eps` evaluation.
`FusedDiffusionSampler` overrides `sample` only, with the kernel path
(kernels/full_sampler.py); its DDIM, trajectory and masked sampling run the
plain model, as the reference's do. `NormalizedSampler` denormalises
z-scored latents on the way out; `DDIMSampler` routes `sample` to `ddim`.

`sample_from(x_t, t_start)` and `masked_denoise` run the masked loop: every
step t = T-1 .. 0 evaluates every chain and draws noise for every chain,
and chain i takes the step only where t <= t_start_i, so `sample_from`
applies the steps t_start .. 0, one more than diffusion/sampler.py's
`sample_from(x_t, t_start)`, which runs t_start-1 .. 0. Each follows its
reference.

Classifier-free guidance doubles the batch: conditional rows, then the same
rows with cond_mask 0, and eps = eps_u + s * (eps_c - eps_u).

Randomness comes from an explicit `torch.Generator`; `x_init` and
`stochastic=False` let a caller inject the starting state and drop the step
noise, which is how the port is held against the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from flowerdiff_torch.diffusion.ddpm import p_sample, p_sample_mean
from flowerdiff_torch.diffusion.sampler import (
    ddim_sample,
    sample as _sample_impl,
    sample_with_trajectory as _traj_impl,
)
from flowerdiff_torch.kernels.full_sampler import (
    ReverseProcess,
    draw_request,
    prepare_fused_sampler,
)
from flowerdiff_torch.diffusion.schedule import DiffusionSchedule
from flowerdiff_torch.utils.device import resolve_device


@torch.no_grad()
def _masked_scan(sched: DiffusionSchedule, eps_fn, x: torch.Tensor, t_start: torch.Tensor,
                 *cond, clip_x0: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, stochastic: bool = True):
    """Steps t = T-1 .. 0 over every chain; chain i keeps its state until
    t <= t_start[i] and takes every step from then on."""
    x = x.to(torch.float32)
    sched = sched.to(x.device)
    t_start = t_start.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))
    for t in range(sched.n_steps - 1, -1, -1):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, t_vec, *cond)
        if stochastic:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
            new_x = p_sample(sched, x, t_vec, eps, noise, clip_x0)
        else:
            new_x = p_sample_mean(sched, x, t_vec, eps, clip_x0)
        x = torch.where(t <= t_start, new_x, x)
    return x


def guided_eps_fn(model, guidance_scale: Optional[float]):
    """eps_fn(x, t, *cond) over `model`, with CFG by batch doubling when
    guidance_scale is set."""
    if guidance_scale is None:
        return lambda x, t, *cond: model(x, t, *cond)
    s = float(guidance_scale)

    def eps(x, t, *cond):
        b = x.shape[0]
        cond2 = tuple(torch.cat([c, c]) for c in cond)
        mask = torch.cat([torch.ones(b, device=x.device),
                          torch.zeros(b, device=x.device)])
        e = model(torch.cat([x, x]), torch.cat([t, t]), *cond2, cond_mask=mask)
        e_c, e_u = e[:b], e[b:]
        return e_u + s * (e_c - e_u)

    return eps


class DiffusionSampler:
    """Sampling entry points for one (model, schedule) pair with the plain
    f32 model.

    Conditioning is variadic: (classes,) for v1/v2, (classes, colors) for v3.
    """

    def __init__(self, model, sched: DiffusionSchedule, event_shape: Tuple[int, ...],
                 clip_x0: Optional[float] = None,
                 guidance_scale: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.event_shape = tuple(event_shape)
        self.clip_x0 = clip_x0
        self.guidance_scale = guidance_scale
        self._eps = guided_eps_fn(self.model, guidance_scale)

    def _cond(self, cond):
        return tuple(c.to(self.device) for c in cond)

    def _x(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def sample(self, batch: int, *cond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               stochastic: bool = True, mesh=None) -> torch.Tensor:
        """Full ancestral sampling, steps T-1 .. 0. `mesh`: a data-parallel
        mesh (parallel/mesh.py) over which the request's rows are split; the
        gathered result equals the unsplit run's."""
        return _sample_impl(
            self.sched, self._eps, (batch,) + self.event_shape, *self._cond(cond),
            generator=generator, device=self.device, clip_x0=self.clip_x0, x_init=x_init,
            stochastic=stochastic, mesh=mesh)

    def sample_from(self, x_t, t_start: int, *cond: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    stochastic: bool = True) -> torch.Tensor:
        """Denoise x_t with the steps t_start .. 0 (the masked loop)."""
        x = self._x(x_t)
        t_vec = torch.full((x.shape[0],), int(t_start), dtype=torch.long, device=self.device)
        return self.masked_denoise(x, t_vec, *cond, generator=generator, stochastic=stochastic)

    def masked_denoise(self, x_init, t_start_vec, *cond: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       stochastic: bool = True) -> torch.Tensor:
        """Chain i takes the steps t_start_vec[i] .. 0, all chains in one
        loop of T steps (viz/denoise_path.py in the reference)."""
        return _masked_scan(self.sched, self._eps, self._x(x_init),
                            torch.as_tensor(t_start_vec).to(self.device), *self._cond(cond),
                            clip_x0=self.clip_x0, generator=generator, stochastic=stochastic)

    def sample_with_trajectory(self, batch: int, *cond: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               x_init: Optional[torch.Tensor] = None,
                               stochastic: bool = True):
        """(x0, trajectory (T, batch, ...)), trajectory[-1] == x0."""
        return _traj_impl(self.sched, self._eps, (batch,) + self.event_shape,
                          *self._cond(cond), generator=generator, device=self.device,
                          clip_x0=self.clip_x0, x_init=x_init, stochastic=stochastic)

    def ddim(self, batch: int, *cond: torch.Tensor, num_steps: int = 50,
             generator: Optional[torch.Generator] = None,
             x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic DDIM (eta = 0) over `num_steps` strided steps."""
        return ddim_sample(self.sched, self._eps, (batch,) + self.event_shape,
                           *self._cond(cond), num_steps=num_steps, generator=generator,
                           device=self.device, clip_x0=self.clip_x0, x_init=x_init)

    @torch.no_grad()
    def eps(self, x, t, *cond: torch.Tensor) -> torch.Tensor:
        """One (guided) eps evaluation of the plain model."""
        return self._eps(self._x(x), torch.as_tensor(t).to(self.device), *self._cond(cond))

    @property
    def latent_dim(self) -> int:
        assert len(self.event_shape) == 1
        return self.event_shape[0]


class FusedDiffusionSampler(DiffusionSampler):
    """DiffusionSampler whose `sample` runs the kernel path
    (kernels/full_sampler.py). Latent pipeline only. It overrides `sample`
    alone, as the reference does: `ddim`, `sample_from`, `masked_denoise`
    and `sample_with_trajectory` run the plain f32 model.

    On a CUDA device every call is one launch of the reverse-process kernel
    (`process`, a `ReverseProcess`): all T steps of the call, its plan bound
    at the first call of each (batch, guided) and listed in
    `process.bound`; a kernel that fails to build or launch raises. The
    kernel takes every denoiser the JAX kernel holds in its 100 MiB of VMEM
    whose widths are at most 4096, at any depth up to 32768 stages
    (`kernels.full_sampler.process_plan`, which raises past them, naming
    the bound). On the CPU the same call runs the step loop on the
    kernels' plain twins."""

    def __init__(self, model, sched: DiffusionSchedule, event_shape: Tuple[int, ...],
                 clip_x0: Optional[float] = None,
                 guidance_scale: Optional[float] = None, device=None):
        super().__init__(model, sched, event_shape, clip_x0=clip_x0,
                         guidance_scale=guidance_scale, device=device)
        self._prep = prepare_fused_sampler(self.model, self.sched)
        self.process = ReverseProcess(self._prep)

    @torch.no_grad()
    def sample(self, batch: int, *cond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               stochastic: bool = True) -> torch.Tensor:
        color = cond[1] if len(cond) > 1 else None
        guided = self.guidance_scale is not None
        inputs = draw_request(self._prep, batch, cond[0], color, generator, x_init, guided)
        return self.process(inputs, stochastic=stochastic, clip_x0=self.clip_x0,
                            guidance_scale=self.guidance_scale)


class NormalizedSampler:
    """Sampler over a model trained on per-dim z-scored latents. Outputs are
    denormalised to raw VAE-latent space (x * std + mean);
    `sample_from` / `masked_denoise` take model-space chains, and `eps`
    stays in model space, as in the reference."""

    def __init__(self, inner: DiffusionSampler, mean, std):
        self._inner = inner
        self.device = inner.device
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=inner.device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=inner.device)
        self.sched = inner.sched
        self.event_shape = inner.event_shape
        self.model = inner.model

    def _denorm(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.std + self.mean

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """Raw VAE latents -> model space."""
        return (x - self.mean) / self.std

    def sample(self, batch: int, *cond, **kw) -> torch.Tensor:
        return self._denorm(self._inner.sample(batch, *cond, **kw))

    def sample_from(self, x_t, t_start: int, *cond, **kw) -> torch.Tensor:
        return self._denorm(self._inner.sample_from(x_t, t_start, *cond, **kw))

    def masked_denoise(self, x_init, t_start_vec, *cond, **kw) -> torch.Tensor:
        return self._denorm(self._inner.masked_denoise(x_init, t_start_vec, *cond, **kw))

    def sample_with_trajectory(self, batch: int, *cond, **kw):
        final, traj = self._inner.sample_with_trajectory(batch, *cond, **kw)
        return self._denorm(final), self._denorm(traj)

    def ddim(self, batch: int, *cond, num_steps: int = 50, **kw) -> torch.Tensor:
        return self._denorm(self._inner.ddim(batch, *cond, num_steps=num_steps, **kw))

    def eps(self, x, t, *cond) -> torch.Tensor:
        return self._inner.eps(x, t, *cond)

    @property
    def latent_dim(self) -> int:
        return self._inner.latent_dim


class DDIMSampler:
    """A view over a sampler whose `sample` is `ddim` at a fixed step
    count, so a consumer switches sampler by construction. Every other
    attribute, the trajectory and masked entry points included (they stay
    ancestral), passes through to the inner sampler. Composes inside or
    outside `NormalizedSampler`."""

    def __init__(self, inner, num_steps: int = 50):
        self._inner = inner
        self.num_steps = int(num_steps)

    def sample(self, batch: int, *cond, generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None, stochastic: bool = True) -> torch.Tensor:
        """`ddim` with eta = 0, which draws no step noise: `stochastic`
        changes nothing."""
        del stochastic
        return self._inner.ddim(batch, *cond, num_steps=self.num_steps, generator=generator,
                                x_init=x_init)

    def __getattr__(self, name):
        return getattr(self._inner, name)
