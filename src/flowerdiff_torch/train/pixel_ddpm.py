"""Pixel-space DDPM training of the v4/v5 family (port of
flowerdiff/train/pixel_ddpm.py).

Plain Adam(1e-4) (no clip, no decay, no EMA) on the MSE epsilon-loss at
uniform random timesteps, over a PixelUNet on NHWC images in [0, 1].
Parameters and optimizer state are f32; compute_dtype 'bfloat16' runs the
model's convolutions under bf16 autocast (models/pixel_unet.py).

Randomness: a step draws t, then eps, from one generator
(`diffusion/ddpm.ddpm_eps_loss`), or takes them injected (`draws`), which is
how the step is held against the reference. The entry points derive a
generator per (seed..., step), the counterpart of the reference's
fold_in(rng, step). The step runs under cuDNN's deterministic algorithms,
so two runs from one seed are bit-equal on the card.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from flowerdiff_torch.diffusion import DiffusionSchedule, linear_schedule
from flowerdiff_torch.diffusion.ddpm import ddpm_eps_loss
from flowerdiff_torch.models.pixel_unet import PixelUNet
from flowerdiff_torch.parallel.mesh import (
    all_reduce_mean,
    broadcast_from_rank0,
    data_size,
    local_rows,
    mesh_size,
)
from flowerdiff_torch.train.optim import AdamState
from flowerdiff_torch.utils.device import derived_generator, deterministic_cudnn, resolve_device
from flowerdiff_torch.utils.weights import init_numpy_params, load_pixel_unet


@dataclasses.dataclass(frozen=True)
class PixelDiffusionConfig:
    lr: float = 1e-4
    n_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    img_size: int = 64
    base_channels: int = 64
    time_emb_dim: int = 128
    learnable_residual: bool = False  # True for the v5 preset
    compute_dtype: str = "float32"
    # sampling-time x0-thresholding; pixel data lives in [0, 1], so 1.0
    # bounds the x0 estimate; None = the reference's unclipped sampler
    clip_denoised: Optional[float] = 1.0


def create_pixel_diffusion_state(seed: int, cfg: PixelDiffusionConfig, device=None,
                                 params: Optional[dict] = None):
    """(state, model, schedule) on `device` (default cuda): an `AdamState`
    with optax.adam(cfg.lr)'s formulas over a PixelUNet that starts from
    `params` (a flax-named numpy tree) or, without one, from the seeded
    initialiser at the reference's initial distribution (kaiming kernels,
    zero biases, res_ratio 0.1)."""
    dev = resolve_device(device)
    arch = dict(base_channels=cfg.base_channels, time_emb_dim=cfg.time_emb_dim,
                learnable_residual=cfg.learnable_residual)
    if params is None:
        params = init_numpy_params("pixel", seed=seed, bias_std=0.0, **arch)
    model = load_pixel_unet(PixelUNet(compute_dtype=cfg.compute_dtype, **arch), params)
    model = model.to(dev).train()
    lr = float(cfg.lr)
    state = AdamState(model, lambda _: lr)
    sched = linear_schedule(cfg.n_steps, cfg.beta_start, cfg.beta_end).to(dev)
    return state, model, sched


def make_pixel_diffusion_step_body(model: PixelUNet, mesh=None):
    """step(state, sched, images, generator=None, draws=None) -> loss (0-d
    device tensor); the state is updated in place. images: (B, H, W, 3)
    float; draws: (t (B,), eps like images) in place of the generator's, in
    the eps-loss's order. Under `mesh` (parallel/mesh.py) images are this
    rank's rows, the draws (given or drawn) the global batch's, and the
    gradients and the loss are averaged over the "data" ranks before the
    optimizer."""
    params = list(model.parameters())
    ranks = data_size(mesh)

    def step(state: AdamState, sched: DiffusionSchedule, images: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
        if draws is None:
            b, dev = images.shape[0] * ranks, images.device
            draws = (torch.randint(0, sched.n_steps, (b,), generator=generator, device=dev),
                     torch.randn((b,) + tuple(images.shape[1:]), generator=generator,
                                 device=dev, dtype=images.dtype))
        t, eps = local_rows(mesh, draws)
        with deterministic_cudnn():
            loss = ddpm_eps_loss(sched, model, None, images, distance="mse", t=t, eps=eps)
            grads = torch.autograd.grad(loss, params)
        *grads, loss = all_reduce_mean(mesh, list(grads) + [loss.detach()])
        state.apply_gradients(grads)
        return loss

    return step


def make_pixel_diffusion_step(model: PixelUNet, sched: DiffusionSchedule, mesh=None):
    """step(state, images, seed=0, draws=None) -> loss: the step body with
    its draws from a generator derived from (seed..., the state's step).
    `seed`: an int or a tuple of ints."""
    body = make_pixel_diffusion_step_body(model, mesh)

    def step(state, images, seed=0, draws=None):
        words = seed if isinstance(seed, tuple) else (seed,)
        gen = None if draws is not None else derived_generator(images.device, *words,
                                                               state.step)
        return body(state, sched, images, gen, draws)

    return step


class PixelDiffusionTrainer:
    def __init__(self, cfg: PixelDiffusionConfig, seed: int = 0, device=None,
                 params: Optional[dict] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state, self.model, self.sched = create_pixel_diffusion_state(
            seed, cfg, self.device, params)
        self._step = make_pixel_diffusion_step(self.model, self.sched)
        self._fused = {}
        self.last_step_losses = None  # (T,) per-step losses of the last fused run

    def run_epoch(self, batches, seed: int = 0, mesh=None) -> float:
        """batches: (images, labels) with NHWC float images on the device;
        batch i draws from the generator of (seed, i, step). Returns the
        mean loss (one host fetch). mesh: the batches are this rank's rows
        (a DeviceDataset on that mesh); the loss is the global batches'."""
        step = self._step
        if mesh is not None:
            if ("step", mesh) not in self._fused:
                self._fused["step", mesh] = make_pixel_diffusion_step(self.model, self.sched,
                                                                      mesh)
            step = self._fused["step", mesh]
        losses = [step(self.state, images, (seed, i))
                  for i, (images, _labels) in enumerate(batches)]
        return float(torch.stack(losses).mean())

    def run_epochs_fused(self, dataset, epochs: int, seed: int = 0, batch_size: int = 64,
                         mesh=None):
        """Train `epochs` epochs over a data.DeviceDataset (augmented when it
        augments) through train/fused.py's `make_fused_pixel_epochs`; one
        host fetch. Returns the per-epoch mean losses. `mesh`: a
        data-parallel mesh (parallel/mesh.py); batch_size is the global
        batch, the state starts from rank 0's, and the losses are the global
        batch's."""
        from flowerdiff_torch.train.fused import epoch_rows, make_fused_pixel_epochs

        host_seed = int(np.random.default_rng(
            [seed % 2**32, seed >> 32, self.state.step]).integers(0, 2**31 - 1))
        idx, steps = epoch_rows(host_seed, dataset.n, batch_size, epochs)
        key = (steps, dataset.augment_enabled, dataset.max_rotation_deg, dataset.jitter, mesh)
        if key not in self._fused:
            self._fused[key] = make_fused_pixel_epochs(
                self.model, augment=dataset.augment_enabled,
                max_rotation_deg=dataset.max_rotation_deg, jitter=dataset.jitter,
                steps_per_epoch=steps, mesh=mesh)
        if mesh_size(mesh) > 1:
            broadcast_from_rank0(self.state.tensors())
        losses = self._fused[key](self.state, self.sched, dataset.images,
                                  torch.from_numpy(idx).to(self.device), seed)
        self.last_step_losses = losses.cpu().numpy()
        return self.last_step_losses.reshape(epochs, steps).mean(axis=1).tolist()

    def sampling_model(self) -> PixelUNet:
        """A copy of the model with the current weights, in eval mode."""
        return copy.deepcopy(self.model).eval()

    def sampler(self):
        """A DiffusionSampler over a copy of the current weights, images of
        (img_size, img_size, 3), x0 clipped at cfg.clip_denoised."""
        from flowerdiff_torch.diffusion.api import DiffusionSampler

        return DiffusionSampler(self.sampling_model(), self.sched,
                                (self.cfg.img_size, self.cfg.img_size, 3),
                                clip_x0=self.cfg.clip_denoised, device=self.device)

    def eps_fn(self):
        """eps_fn(xt, t) over a copy of the current weights, without gradient."""
        model = self.sampling_model()

        @torch.no_grad()
        def fn(xt, t):
            return model(xt, t)

        return fn
