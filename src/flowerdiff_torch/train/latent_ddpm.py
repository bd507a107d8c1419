"""Latent-space conditional DDPM training (port of
flowerdiff/train/latent_ddpm.py).

The VAE is frozen: latents are posterior draws of its encoder, taken without
gradient and z-scored when latent statistics are given. The denoiser trains
on the euclidean epsilon-loss at uniform random timesteps with global-norm
gradient clipping, AdamW, an SGDR learning rate that is a function of the
optimizer's step count, and an optional per-step EMA of the weights.

The optimizer is written out to optax's formulas, where PyTorch's own
differ: the clip scales by clip / max(norm, clip) (no epsilon in the
denominator), and every parameter takes the AdamW update on every step,
whether its gradient is zero or not: the q and k projections of the
length-1 attention have exactly zero gradient and still decay by
1 - lr * wd a step.

Randomness comes from one `torch.Generator` on the training device. State
is updated in place (the reference returns new states).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from flowerdiff_torch.diffusion import DiffusionSchedule, linear_schedule
from flowerdiff_torch.diffusion.ddpm import ddpm_eps_loss
from flowerdiff_torch.kernels.train_step import draw_step_inputs
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.parallel.mesh import (
    all_reduce_mean,
    broadcast_from_rank0,
    data_size,
    local_rows,
    mesh_size,
)
from flowerdiff_torch.train.optim import AdamState
from flowerdiff_torch.train.schedules import cosine_warm_restarts_schedule
from flowerdiff_torch.utils.device import resolve_device
from flowerdiff_torch.utils.weights import init_numpy_params, load_denoiser

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw defaults


@dataclasses.dataclass(frozen=True)
class LatentDiffusionConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    n_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    t0: int = 10  # warm-restart period (epochs)
    t_mult: int = 2
    # the reference's default; its runner sets n // batch (15 for 1020 images)
    steps_per_epoch: int = 16
    latent_dim: int = 256
    hidden_dims: tuple = (256, 512, 1024, 512, 256)
    time_emb_dim: int = 256
    num_classes: int = 102
    num_colors: Optional[int] = None  # 10 for the v3 preset
    dropout_rate: float = 0.3
    shared_cond_proj: bool = True
    global_skip: bool = False  # True for the v2 preset
    compute_dtype: str = "float32"
    # train in per-dim z-scored latent space; needs latent_stats (mean, std)
    normalize_latents: bool = False
    # sampling-time x0-thresholding bound, in z-scored units when normalized
    clip_denoised: Optional[float] = None
    # classifier-free guidance: per-sample probability of training with the
    # null condition, and the sampling-time guidance scale
    cond_dropout: float = 0.0
    guidance_scale: Optional[float] = None
    # 'ancestral' or 'ddim' over ddim_steps strided timesteps (sampler())
    sampler: str = "ancestral"
    ddim_steps: int = 50
    # per-step EMA of the denoiser weights; sampling then uses the EMA copy
    ema_decay: Optional[float] = None
    # the uncached fused epochs encode the whole epoch's images in one call
    epoch_encode: bool = False
    # compute type of the frozen encoder's convolutions in the epoch-encode
    # path and the latent cache ('bfloat16' = autocast); the noise draw and
    # the latents stay f32
    encode_dtype: Optional[str] = None
    # the hand-written forward+backward train step (kernels/train_step.py);
    # v1/v2 variants only
    train_kernel: bool = False
    train_kernel_dtype: str = "bfloat16"  # 'float32': the exact lane
    # K > 0 keeps a pool of K posterior draws per image on the device and
    # trains on a uniformly drawn slot per sample instead of re-encoding
    latent_cache: int = 0
    # rebuild the pool every R epochs (0 = build once)
    cache_refresh_epochs: int = 0


class LatentTrainState(AdamState):
    """The denoiser's parameters (the module's own), the AdamW moments, the
    step count and the optional EMA copy. `apply_gradients` is the optimizer
    chain: global-norm clip, AdamW with the SGDR learning rate of the
    current step count, then the EMA, all in place and without a host
    synchronisation."""

    def __init__(self, model: ConditionalLatentDenoiser, cfg: LatentDiffusionConfig):
        super().__init__(model, cosine_warm_restarts_schedule(cfg.lr, cfg.steps_per_epoch,
                                                              cfg.t0, cfg.t_mult),
                         ADAM_B1, ADAM_B2, ADAM_EPS, cfg.weight_decay, cfg.grad_clip)
        self.cfg = cfg
        self.ema_decay = None if cfg.ema_decay is None else float(cfg.ema_decay)
        self.ema: Optional[List[torch.Tensor]] = (
            None if cfg.ema_decay is None else [p.clone() for p in self.params])

    @property
    def model(self) -> ConditionalLatentDenoiser:
        return self.module

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """grads: a tensor for EVERY parameter name (zeros where a parameter
        took no part in the loss). The given tensors are left as they are."""
        super().apply_gradients([grads[n] for n in self.names])
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)

    @property
    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        return None if self.ema is None else dict(zip(self.names, self.ema))


def create_latent_diffusion_state(seed: int, cfg: LatentDiffusionConfig, device=None,
                                  params: Optional[dict] = None):
    """(state, model, schedule). The denoiser starts from `params` (a
    flax-named numpy tree) or, without one, from the seeded initialiser with
    zero biases, the reference's initial distribution."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: choose 'float32' or 'bfloat16'")
    dev = resolve_device(device)
    kw = dict(latent_dim=cfg.latent_dim, hidden_dims=tuple(cfg.hidden_dims),
              time_emb_dim=cfg.time_emb_dim, num_classes=cfg.num_classes,
              num_colors=cfg.num_colors, shared_cond_proj=cfg.shared_cond_proj,
              global_skip=cfg.global_skip)
    if params is None:
        params = init_numpy_params("denoiser", seed=seed, bias_std=0.0, **kw)
    model = load_denoiser(ConditionalLatentDenoiser(dropout_rate=cfg.dropout_rate, **kw), params)
    model = model.to(dev).train()
    for p in model.parameters():
        p.requires_grad_(False)  # gradients are taken explicitly, never accumulated
    sched = linear_schedule(cfg.n_steps, cfg.beta_start, cfg.beta_end).to(dev)
    return LatentTrainState(model, cfg), model, sched


def make_latent_encode_fn(vae: FlowerVAE, encode_dtype: Optional[str] = None):
    """The frozen VAE's posterior draw: encode(images, generator,
    latent_stats=None, noise=None) -> z, without gradient, z-scored when
    latent_stats = (mean, std) is given. mu and logvar are cast to float32
    before the draw, so a reduced-precision encoder (`encode_dtype`
    'bfloat16': autocast over the encoder) changes only the convolutions'
    precision, never the noise."""
    autocast = encode_dtype not in (None, "float32")
    if autocast and encode_dtype != "bfloat16":
        raise ValueError(f"encode_dtype {encode_dtype!r}: choose 'bfloat16' or 'float32'")

    @torch.no_grad()
    def encode(images, generator=None, latent_stats=None, noise=None):
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=autocast):
            mu, logvar = vae.encode_with_params(images)
        z = FlowerVAE.reparameterize(mu.float(), logvar.float(), generator, noise)
        if latent_stats is not None:
            mean, std = latent_stats
            z = (z - mean) / std
        return z

    return encode


def make_latent_denoise_body(model: ConditionalLatentDenoiser, cfg: LatentDiffusionConfig,
                             mesh=None):
    """The trainable half of the step on pre-encoded latents, by eager
    autograd over the module (the path for v3 and for train_kernel=False):
    denoise(state, sched, z, labels, colors, generator, draws=None) -> loss
    (0-d tensor). cfg.compute_dtype 'bfloat16' runs the model under bf16
    autocast (parameters, gradients and moments stay f32). The draws are the
    same, in the same order, as the kernel body's (`draw_step_inputs`).

    Under `mesh` (parallel/mesh.py) z, labels and colors are this rank's
    rows and `draws` this rank's rows of the global batch's; drawn here,
    they are the global batch's draws, of which the rank keeps its rows.
    The gradients and the loss are averaged over the "data" ranks before
    the optimizer, so the clip sees the global norm and the loss is the
    global batch's."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    bf16 = cfg.compute_dtype == "bfloat16"
    ranks = data_size(mesh)

    def denoise(state, sched, z, labels, colors, generator=None, draws=None):
        if draws is None:
            z_global = z if ranks == 1 else z.new_empty((z.shape[0] * ranks,) + z.shape[1:])
            draws = local_rows(mesh, draw_step_inputs(model, sched.n_steps, cfg.cond_dropout,
                                                      z_global, generator))
        t, eps, keep, masks = draws
        cond_mask = keep if cfg.cond_dropout > 0.0 else None
        pairs = list(zip(masks[0::2], masks[1::2]))

        def eps_fn(xt, tt, *cond):
            with torch.autocast(xt.device.type, dtype=torch.bfloat16, enabled=bf16):
                return model(xt, tt, *cond, cond_mask=cond_mask, masks=pairs)

        cond = (labels,) if colors is None else (labels, colors)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = ddpm_eps_loss(sched, eps_fn, None, z, *cond, distance="euclidean",
                                 t=t, eps=eps)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            for p in params:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        *grads, loss = all_reduce_mean(mesh, grads + [loss.detach()])
        state.apply_gradients(dict(zip(names, grads)))
        return loss

    return denoise


def make_latent_diffusion_step_body(model: ConditionalLatentDenoiser, vae: FlowerVAE,
                                    sched: DiffusionSchedule, cfg: LatentDiffusionConfig,
                                    mesh=None):
    """step(state, images, labels, colors, generator, latent_stats=None) ->
    loss: the frozen encode of one batch of NHWC float images, then the
    eager denoise body. Under `mesh` the batch is this rank's rows, and the
    posterior noise and the step's draws are the rank's rows of the global
    batch's."""
    encode = make_latent_encode_fn(vae)
    denoise = make_latent_denoise_body(model, cfg, mesh)
    ranks = data_size(mesh)

    def step(state, images, labels, colors, generator=None, latent_stats=None):
        noise = None
        if ranks > 1:
            noise = local_rows(mesh, torch.randn((images.shape[0] * ranks, model.latent_dim),
                                                 generator=generator, device=images.device))
        z = encode(images, generator, latent_stats, noise=noise)
        return denoise(state, sched, z, labels, colors, generator)

    return step


class LatentDiffusionTrainer:
    def __init__(self, cfg: LatentDiffusionConfig, vae: FlowerVAE, seed: int = 0,
                 latent_stats=None, device=None):
        """latent_stats: (mean, std) per-dim arrays for z-scored training
        (cfg.normalize_latents)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state, self.model, self.sched = create_latent_diffusion_state(
            seed, cfg, self.device)
        self.vae = vae.to(self.device).eval()
        if cfg.normalize_latents and latent_stats is None:
            raise ValueError("cfg.normalize_latents=True requires latent_stats (mean, std)")
        self.latent_stats = None
        if cfg.normalize_latents:
            self.latent_stats = tuple(
                torch.as_tensor(np.asarray(s), dtype=torch.float32, device=self.device)
                for s in latent_stats)
        self._step = make_latent_diffusion_step_body(self.model, self.vae, self.sched, cfg)
        self._fused = {}
        self._z_pool = None  # latent-cache pool (cfg.latent_cache > 0)
        self._pool_age = 0   # epochs trained since the pool was built
        self._pool_builds = 0
        self.last_step_losses = None  # (T,) per-step losses of the last fused run

    def run_epoch(self, batches: Iterable, generator: Optional[torch.Generator] = None,
                  mesh=None) -> float:
        """One epoch over (images, labels[, colors]) batches of NHWC float
        images; returns the mean loss. mesh: the batches are this rank's
        rows (a DeviceDataset on that mesh); the loss is the global
        batches'."""
        step = self._step
        if mesh is not None:
            if ("step", mesh) not in self._fused:
                self._fused["step", mesh] = make_latent_diffusion_step_body(
                    self.model, self.vae, self.sched, self.cfg, mesh)
            step = self._fused["step", mesh]
        losses = []
        for batch in batches:
            images, labels = batch[0], batch[1]
            colors = batch[2] if self.cfg.num_colors is not None else None
            losses.append(step(self.state, images, labels, colors, generator,
                               self.latent_stats))
        return float(torch.stack(losses).mean())

    def run_epochs_fused(self, dataset, epochs: int, vae: Optional[FlowerVAE] = None,
                         generator: Optional[torch.Generator] = None, batch_size: int = 64,
                         mesh=None):
        """Train `epochs` epochs over a data.DeviceDataset (augmented when it
        augments) and return the per-epoch mean losses, with one host fetch.
        With cfg.latent_cache > 0 this is the latent-cache path
        (`run_epochs_cached`); otherwise every step encodes freshly
        augmented images through the frozen VAE (train/fused.py
        `make_fused_latent_epochs`, cfg.epoch_encode choosing the form).
        `vae`: the frozen VAE (default: the trainer's). `mesh`: a
        data-parallel mesh (parallel/mesh.py); batch_size is the global
        batch, the state starts from rank 0's, and the losses are the global
        batch's. The latent cache and the train-step kernel run on a mesh of
        one rank only."""
        if self.cfg.latent_cache > 0:
            # a 1x1 mesh is how the runner spells "single chip": allowed
            if mesh_size(mesh) > 1:
                raise ValueError(
                    "latent_cache is the single-chip fast path; use the "
                    "uncached fused path under a multi-device mesh")
            return self.run_epochs_cached(dataset, epochs, vae, generator,
                                          batch_size=batch_size)
        from flowerdiff_torch.train.fused import epoch_rows, make_fused_latent_epochs

        cfg = self.cfg
        vae = self.vae if vae is None else vae.to(self.device).eval()
        has_colors = cfg.num_colors is not None
        seed = 0 if generator is None else generator.initial_seed()
        host_seed = int(np.random.default_rng(
            [seed % 2**32, seed >> 32, self.state.step]).integers(0, 2**31 - 1))
        idx, steps = epoch_rows(host_seed, dataset.n, batch_size, epochs)
        key = ("uncached", steps, dataset.augment_enabled, dataset.max_rotation_deg,
               dataset.jitter, vae, mesh)
        if key not in self._fused:
            self._fused[key] = make_fused_latent_epochs(
                self.model, vae, self.sched, cfg, has_colors=has_colors,
                augment=dataset.augment_enabled, max_rotation_deg=dataset.max_rotation_deg,
                jitter=dataset.jitter, steps_per_epoch=steps, mesh=mesh)
        if mesh_size(mesh) > 1:
            broadcast_from_rank0(self.state.tensors() + (self.state.ema or []))
        losses = self._fused[key](
            self.state, dataset.images, dataset.labels,
            dataset.colors if has_colors else None,
            torch.from_numpy(idx).to(self.device), generator, self.latent_stats)
        self.last_step_losses = losses.cpu().numpy()
        return self.last_step_losses.reshape(epochs, steps).mean(axis=1).tolist()

    def run_epochs_cached(self, dataset, epochs: int, vae: Optional[FlowerVAE] = None,
                          generator: Optional[torch.Generator] = None, batch_size: int = 64):
        """Latent-cache training (cfg.latent_cache = K pool slots):
        denoiser-only epochs over cached posterior draws, the pool rebuilt
        every cfg.cache_refresh_epochs (0 = never). Every window of epochs
        is queued before the one host fetch of all losses."""
        from flowerdiff_torch.train.fused import (
            epoch_rows,
            make_fused_cached_epochs,
            make_latent_cache_builder,
        )

        cfg = self.cfg
        vae = self.vae if vae is None else vae.to(self.device).eval()
        has_colors = cfg.num_colors is not None
        refresh = cfg.cache_refresh_epochs
        if self._fused.get("cache_vae") is not vae:
            self._fused["cache_vae"] = vae
            self._fused["build_pool"] = make_latent_cache_builder(
                vae, cfg, augment=dataset.augment_enabled,
                max_rotation_deg=dataset.max_rotation_deg, jitter=dataset.jitter)
        build_pool = self._fused["build_pool"]
        # the shuffle stream is seeded on the host, so the loop fetches
        # nothing from the device
        seed = 0 if generator is None else generator.initial_seed()

        pending = []  # (device losses, take, steps) per queued window
        done = 0
        while done < epochs:
            if self._z_pool is None or (refresh > 0 and self._pool_age >= refresh):
                self._z_pool = build_pool(dataset.images, generator, self.latent_stats)
                self._pool_age = 0
                self._pool_builds += 1
            take = epochs - done
            if refresh > 0:
                take = min(take, refresh - self._pool_age)
            host_seed = int(np.random.default_rng(
                [seed % 2**32, seed >> 32, self.state.step, done]).integers(0, 2**31 - 1))
            idx, steps = epoch_rows(host_seed, dataset.n, batch_size, take)
            key = ("cached", steps)
            if key not in self._fused:
                self._fused[key] = make_fused_cached_epochs(
                    self.model, cfg, has_colors=has_colors, steps_per_epoch=steps)
            losses = self._fused[key](
                self.state, self.sched, self._z_pool, dataset.labels,
                dataset.colors if has_colors else None,
                torch.from_numpy(idx).to(self.device), generator)
            pending.append((losses, take, steps))
            done += take
            self._pool_age += take
        out, per_step = [], []
        for losses, take, steps in pending:
            per_step.append(losses.cpu().numpy())
            out.extend(per_step[-1].reshape(take, steps).mean(axis=1).tolist())
        self.last_step_losses = np.concatenate(per_step)
        return out

    @property
    def sampling_params(self) -> Dict[str, torch.Tensor]:
        """EMA weights when cfg.ema_decay is set, else the live weights, by
        parameter name."""
        ema = self.state.ema_params
        return ema if ema is not None else dict(zip(self.state.names, self.state.params))

    def sampling_model(self) -> ConditionalLatentDenoiser:
        """A copy of the denoiser holding the sampling params, in eval mode."""
        model = copy.deepcopy(self.model)
        model.load_state_dict({k: v.clone() for k, v in self.sampling_params.items()},
                              strict=True)
        return model.eval()

    def sampler(self, fused: bool = False):
        """Sampling facade over the sampling params (the EMA weights when
        cfg.ema_decay is set), wrapped in the latent codec when training is
        z-scored, and in the DDIM view (cfg.ddim_steps strided steps) when
        cfg.sampler is 'ddim'. fused=True samples the ancestral `sample`
        through the stage, head and reverse-step kernels."""
        from flowerdiff_torch.diffusion.api import (
            DDIMSampler,
            DiffusionSampler,
            FusedDiffusionSampler,
            NormalizedSampler,
        )

        cls = FusedDiffusionSampler if fused else DiffusionSampler
        sampler = cls(self.sampling_model(), self.sched, (self.cfg.latent_dim,),
                      clip_x0=self.cfg.clip_denoised,
                      guidance_scale=self.cfg.guidance_scale, device=self.device)
        if self.latent_stats is not None:
            sampler = NormalizedSampler(sampler, *self.latent_stats)
        if self.cfg.sampler == "ddim":
            sampler = DDIMSampler(sampler, num_steps=self.cfg.ddim_steps)
        return sampler

    def eps_fn(self, deterministic: bool = True):
        """eps_fn(xt, t, *cond) over the sampling params."""
        model = self.sampling_model()
        model.train(not deterministic)

        @torch.no_grad()
        def fn(xt, t, *cond):
            return model(xt, t, *cond)

        return fn
