"""VAE-GAN training: one step, two optimizers (port of
flowerdiff/train/vae_gan.py).

One step, in the reference's order:
  1. ONE generator forward: encode, reparameterise, decode;
  2. the discriminator's loss on (real, the DETACHED reconstruction) and
     its Adam step;
  3. the generator's loss against the UPDATED discriminator: euclidean
     reconstruction + VGG perceptual + KL + classifier cross-entropy +
     center loss + adversarial term, each weighted by the configuration's
     lambda, the epoch's gates and, for the perceptual, KL and adversarial
     terms, adaptive scales min(1, recon / term) computed on the device
     from detached values (no host synchronisation);
  4. the gradient of that loss over the generator's parameters only
     (`torch.autograd.grad`: nothing lands in the discriminator's, and the
     classifier head's gradient is part of the same sum), the global-norm
     clip and AdamW with the one-cycle learning rate;
  5. the EMA update of the class centers, gated by the epoch's flag.

The optimizers follow optax's formulas (train/optim.py): the generator's
chain is clip_by_global_norm then adamw (every leaf decays), the
discriminator's plain adam. Parameters and optimizer state are f32;
compute_dtype='bfloat16' runs the conv and dense stacks of the encoder,
decoder and discriminator and the VGG backbone under bf16 autocast (the
encoder's fc2 heads, the decoder's sigmoid, the discriminator's head and the
classifier stay f32, as in the reference).

Randomness: a step draws the reparameterisation noise, then the
classifier's two dropout keep masks, from one generator; both may be
injected instead (`draws`), which is how the step is held against the
reference. The entry points derive a generator per (seed, offset, step),
the counterpart of the reference's fold_in(fold_in(rng, offset), step).
The step runs under cuDNN's deterministic algorithms and its center update
sums in a fixed order, so two runs from one seed are bit-equal on the card.

Under a data-parallel mesh (parallel/mesh.py) each rank steps on its rows
of the global batch with its rows of the global batch's draws, and the
collectives the reference's mesh inserts are written out: the
discriminator's and the generator's gradients are averaged over the ranks
before their optimizers (so the clip sees the global norm), the adaptive
scales read the global batch's loss terms, the KL's batch sum is scaled by
the ranks (losses/kl.py), the centers' segment sums are summed over the
ranks, and the metrics are the global batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from flowerdiff_torch.losses import (
    center_loss,
    discriminator_loss,
    euclidean_distance_loss,
    generator_adv_loss,
    kl_divergence,
    update_centers,
)
from flowerdiff_torch.models.discriminator import Discriminator64
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.models.vgg import VGGPerceptual
from flowerdiff_torch.parallel.mesh import (
    all_reduce_mean,
    broadcast_from_rank0,
    data_size,
    local_rows,
    mesh_size,
)
from flowerdiff_torch.train.optim import AdamState
from flowerdiff_torch.train.schedules import LossGates, onecycle_schedule, vae_gan_loss_gates
from flowerdiff_torch.utils.device import derived_generator, deterministic_cudnn, resolve_device
from flowerdiff_torch.utils.weights import init_numpy_params, load_discriminator, load_vae

METRICS = ("recon", "perceptual", "kl", "class", "center", "gan", "d_loss", "total")
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class VAEGANConfig:
    """Hyperparameters; the defaults are the reference's."""
    lr: float = 1e-4
    weight_decay: float = 1e-5
    d_lr: float = 1e-4
    d_betas: tuple = (0.5, 0.999)
    lambda_recon: float = 1.0
    lambda_cls: float = 0.3
    lambda_center: float = 0.1
    lambda_vgg: float = 0.4
    lambda_gan: float = 0.2
    kl_weight_start: float = 0.001
    kl_weight_end: float = 0.05
    grad_clip: float = 1.0
    total_steps: int = 10_000  # the one-cycle horizon: epochs x steps a epoch
    use_perceptual: bool = True
    num_classes: int = 102
    latent_dim: int = 256
    channels: tuple = (64, 128, 256, 512)
    head_width: int = 512
    compute_dtype: str = "float32"  # 'bfloat16': the stacks under bf16 autocast
    remat: bool = False  # recompute the encoder's residual blocks in the backward


class VAEGANState:
    """The generator's and the discriminator's `AdamState`s and the EMA
    class centers (num_classes, latent_dim), all updated in place."""

    def __init__(self, gen: AdamState, disc: AdamState, centers: torch.Tensor):
        self.gen, self.disc, self.centers = gen, disc, centers

    @property
    def step(self) -> int:
        return self.gen.step

    def tensors(self) -> List[torch.Tensor]:
        return self.gen.tensors() + self.disc.tensors() + [self.centers]

    def snapshot(self) -> "VAEGANSnapshot":
        """A copy of every tensor and of the step count (as a device
        tensor), taken without a host synchronisation."""
        return VAEGANSnapshot([t.clone() for t in self.tensors()],
                              torch.tensor(self.step, device=self.centers.device))

    def restore(self, snap: "VAEGANSnapshot") -> None:
        torch._foreach_copy_(self.tensors(), snap.tensors)
        self.gen.step = self.disc.step = int(snap.step)


@dataclasses.dataclass
class VAEGANSnapshot:
    tensors: List[torch.Tensor]
    step: torch.Tensor


def _check_dtype(cfg: VAEGANConfig) -> None:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: choose one of {COMPUTE_DTYPES}")


def create_vae_gan_state(seed: int, cfg: VAEGANConfig, vae: Optional[FlowerVAE] = None,
                         disc: Optional[Discriminator64] = None, img_size: int = 64,
                         device=None, g_params: Optional[dict] = None,
                         d_params: Optional[dict] = None):
    """(state, vae, disc) on `device` (default cuda). The generator (encoder,
    decoder, classifier) starts from `g_params` and the discriminator from
    `d_params` (flax-named numpy trees, e.g. the reference's init carried
    across) or, without them, from the seeded initialiser at the reference's
    initial distribution (kaiming kernels, zero biases). `vae` / `disc`:
    modules to train in place of the configuration's."""
    _check_dtype(cfg)
    dev = resolve_device(device)
    base = img_size // 2 ** (len(cfg.channels) - 1)
    arch = dict(latent_dim=cfg.latent_dim, channels=tuple(cfg.channels),
                head_width=cfg.head_width, base_size=base)
    if vae is None:
        vae = FlowerVAE(num_classes=cfg.num_classes, remat=cfg.remat, **arch)
    if disc is None:
        disc = Discriminator64(device=dev)
    if g_params is None:
        g_params = init_numpy_params("generator", seed=seed, bias_std=0.0,
                                     num_classes=cfg.num_classes, **arch)
    if d_params is None:
        d_params = init_numpy_params("discriminator", seed=seed + 1, bias_std=0.0)
    vae = load_vae(vae, g_params).to(dev).train()
    disc = load_discriminator(disc, d_params).to(dev).train()
    gen = AdamState(vae, onecycle_schedule(cfg.lr, cfg.total_steps), 0.9, 0.999,
                    weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
    d_lr = float(cfg.d_lr)
    dstate = AdamState(disc, lambda _: d_lr, cfg.d_betas[0], cfg.d_betas[1])
    centers = torch.zeros((cfg.num_classes, cfg.latent_dim), device=dev)
    return VAEGANState(gen, dstate, centers), vae, disc


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (optax's
    `softmax_cross_entropy_with_integer_labels`), as a one-hot product: no
    gather or scatter, so it reduces in a fixed order on the card."""
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return -(F.log_softmax(logits, dim=-1) * onehot).sum(dim=-1).mean()


def draw_step_inputs(vae: FlowerVAE, batch: int, generator: Optional[torch.Generator],
                     device) -> tuple:
    """(eps (B, latent), classifier keep masks): a step's draws, in its order."""
    latent = vae.decoder.fc1.in_features
    eps = torch.randn((batch, latent), generator=generator, device=device)
    return eps, vae.classifier.draw_masks(batch, generator, device)


def make_vae_gan_step_body(vae: FlowerVAE, disc: Discriminator64, cfg: VAEGANConfig,
                           vgg: Optional[VGGPerceptual] = None, mesh=None):
    """step(state, images, labels, gates, generator=None, draws=None) ->
    metrics (a dict of 0-d device tensors, `METRICS`).

    images: (B, 64, 64, 3) float in [0, 1]; labels (B,); gates: the five
    `LossGates` as a (5,) f32 tensor; draws: (eps, classifier keep masks) in
    place of the generator's (`draw_step_inputs`). Under `mesh` images and
    labels are this rank's rows, draws (given or drawn) the global batch's,
    and the metrics the global batch's."""
    _check_dtype(cfg)
    ranks = data_size(mesh)
    use_vgg = cfg.use_perceptual and vgg is not None
    bf16 = cfg.compute_dtype == "bfloat16"
    g_params = list(vae.parameters())
    d_params = list(disc.parameters())

    def step(state: VAEGANState, images, labels, gates, generator=None, draws=None):
        dev = images.device
        if draws is None:
            draws = draw_step_inputs(vae, images.shape[0] * ranks, generator, dev)
        eps, masks = local_rows(mesh, draws)
        kl_weight, kl_factor, cls_factor, center_factor, do_update = gates.unbind(0)

        def autocast():
            return torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16)

        with deterministic_cudnn():
            # one generator forward; the D step sees its detached output
            with autocast():
                recon, mu, logvar, z = vae.autoencode(images, noise=eps)
                d_loss = discriminator_loss(disc(images), disc(recon.detach()))
            state.disc.apply_gradients(all_reduce_mean(mesh, torch.autograd.grad(d_loss,
                                                                                 d_params)))

            # the generator's objective against the updated discriminator
            with autocast():
                recon_loss = euclidean_distance_loss(recon, images)
                perceptual = (vgg(recon, images) if use_vgg
                              else torch.zeros((), device=dev))
                kl = kl_divergence(mu, logvar, ranks)
                ce = _cross_entropy(vae.classify(z, deterministic=False, masks=masks), labels)
                center = center_loss(z, labels, state.centers)
                adv = generator_adv_loss(disc(recon))

                local = (recon_loss, perceptual, kl, ce, center, adv, d_loss)
                terms = local
                if mesh is not None:  # the global batch's terms
                    stacked = torch.stack([t.detach().float() for t in local])
                    terms = [v.to(t.dtype) for v, t in
                             zip(all_reduce_mean(mesh, [stacked])[0], local)]
                r, p, k, a = (terms[i].detach() for i in (0, 1, 2, 5))
                big = r > 1e-8
                perceptual_scale = torch.where(big, torch.clamp(r / (p + 1e-8), max=1.0), 1.0)
                kl_scale = torch.where(big & (k > 0), torch.clamp(r / (k + 1e-8), max=1.0), 1.0)
                gan_scale = torch.where(big, torch.clamp(r / (a + 1e-8), max=1.0), 1.0)
                total = (cfg.lambda_recon * recon_loss
                         + cfg.lambda_vgg * perceptual_scale * perceptual
                         + kl_weight * kl_scale * kl_factor * kl
                         + cfg.lambda_cls * cls_factor * ce
                         + cfg.lambda_center * center_factor * center
                         + cfg.lambda_gan * gan_scale * adv)
            grads = torch.autograd.grad(total, g_params)
        state.gen.apply_gradients(all_reduce_mean(mesh, grads))

        with torch.no_grad():
            updated = update_centers(state.centers, z.detach(), labels, momentum=0.9, mesh=mesh)
            state.centers.copy_(torch.where(do_update > 0, updated, state.centers))
        values = tuple(terms) + tuple(all_reduce_mean(mesh, [total.detach()]))
        return {k: v.detach() for k, v in zip(METRICS, values)}

    return step


def make_vae_gan_step(vae: FlowerVAE, disc: Discriminator64, cfg: VAEGANConfig,
                      vgg: Optional[VGGPerceptual] = None, mesh=None):
    """step(state, images, labels, gates, seed, draws=None) -> metrics: the
    step body with its draws from a generator derived from (seed..., the
    state's step). `seed`: an int or a tuple of ints."""
    body = make_vae_gan_step_body(vae, disc, cfg, vgg, mesh)

    def step(state, images, labels, gates, seed=0, draws=None):
        words = seed if isinstance(seed, tuple) else (seed,)
        gen = None if draws is not None else derived_generator(images.device, *words,
                                                               state.step)
        return body(state, images, labels, gates, gen, draws)

    return step


def gates_array(g: LossGates, device=None) -> torch.Tensor:
    return torch.tensor(tuple(g), dtype=torch.float32, device=device)


class VAEGANTrainer:
    """Epochs, gates and the per-epoch best-state policy around the step.
    Metrics are summed on the device and fetched once a call."""

    def __init__(self, cfg: VAEGANConfig, seed: int = 0, vgg: Optional[VGGPerceptual] = None,
                 img_size: int = 64, device=None, g_params: Optional[dict] = None,
                 d_params: Optional[dict] = None):
        """vgg: the perceptual criterion (default: VGGPerceptual() from the
        in-repo asset when cfg.use_perceptual)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state, self.vae, self.disc = create_vae_gan_state(
            seed, cfg, img_size=img_size, device=self.device, g_params=g_params,
            d_params=d_params)
        if cfg.use_perceptual and vgg is None:
            vgg = VGGPerceptual(device=self.device)
        self.vgg = vgg if cfg.use_perceptual else None
        self.step_fn = make_vae_gan_step(self.vae, self.disc, cfg, self.vgg)
        self._fused = {}

    def _gates(self, epoch: int, num_epochs: int) -> LossGates:
        return vae_gan_loss_gates(epoch, num_epochs, self.cfg.kl_weight_start,
                                  self.cfg.kl_weight_end)

    def run_epoch(self, batches, epoch: int, num_epochs: int, seed: int = 0,
                  mesh=None) -> Dict[str, float]:
        """batches: (images, labels) device tensors. Batch i draws from the
        generator of (seed, i, step). Returns the epoch's mean metrics.
        mesh: the batches are this rank's rows (a DeviceDataset on that
        mesh); the metrics are the global batches'."""
        gates = gates_array(self._gates(epoch, num_epochs), self.device)
        step_fn = self.step_fn
        if mesh is not None:
            if ("step", mesh) not in self._fused:
                self._fused["step", mesh] = make_vae_gan_step(self.vae, self.disc, self.cfg,
                                                              self.vgg, mesh)
            step_fn = self._fused["step", mesh]
        totals, count = None, 0
        for i, (images, labels) in enumerate(batches):
            m = step_fn(self.state, images, labels, gates, (seed, i))
            totals = m if totals is None else {k: totals[k] + m[k] for k in METRICS}
            count += 1
        means = torch.stack([totals[k] for k in METRICS]).cpu().numpy() / count
        return dict(zip(METRICS, means.tolist()))

    def run_epochs_fused(self, dataset, start_epoch: int, num_epochs_total: int, epochs: int,
                         seed: int = 0, batch_size: int = 64, best=None, mesh=None):
        """Train `epochs` epochs (absolute epoch `start_epoch` onwards, for
        the gates) over a data.DeviceDataset, augmented when it augments;
        one host fetch. Returns the per-epoch mean metrics.

        best: (best_loss, best_state or None) turns on the reference's
        per-epoch best-state policy on the device: each epoch whose mean
        total is below the carried best replaces the best state (a
        `VAEGANSnapshot`; None: a snapshot of the current state). Then the
        return is (metrics, (best_loss, best absolute epoch or None,
        best_state)).

        mesh: a data-parallel mesh (parallel/mesh.py); batch_size is the
        global batch, the state starts from rank 0's, and the metrics (so
        the best epoch) are the global batch's on every rank."""
        from flowerdiff_torch.train.fused import epoch_rows, make_fused_vae_gan_epochs

        host_seed = int(np.random.default_rng(
            [seed % 2**32, seed >> 32, self.state.step]).integers(0, 2**31 - 1))
        idx, steps = epoch_rows(host_seed, dataset.n, batch_size, epochs)
        gates = np.repeat(np.asarray([tuple(self._gates(start_epoch + e, num_epochs_total))
                                      for e in range(epochs)], np.float32), steps, axis=0)
        track_best = best is not None
        key = (steps, dataset.augment_enabled, dataset.max_rotation_deg, dataset.jitter,
               track_best, mesh)
        if key not in self._fused:
            self._fused[key] = make_fused_vae_gan_epochs(
                self.vae, self.disc, self.cfg, self.vgg, augment=dataset.augment_enabled,
                max_rotation_deg=dataset.max_rotation_deg, jitter=dataset.jitter,
                steps_per_epoch=steps, track_best=track_best, mesh=mesh)
        if mesh_size(mesh) > 1:
            broadcast_from_rank0(self.state.tensors())
        args = (self.state, dataset.images, dataset.labels, torch.from_numpy(idx).to(self.device),
                torch.from_numpy(gates).to(self.device), seed)
        if track_best:
            best_loss, best_state = best
            if best_state is None:
                best_state = self.state.snapshot()
            metrics, bl, bi, best_state = self._fused[key](
                *args, best_loss=torch.tensor(float(best_loss), device=self.device),
                best_state=best_state)
        else:
            metrics = self._fused[key](*args)
        per_step = torch.stack([metrics[k] for k in METRICS]).cpu().numpy()  # (8, T)
        means = per_step.reshape(len(METRICS), epochs, steps).mean(axis=2)
        out = [dict(zip(METRICS, means[:, e].tolist())) for e in range(epochs)]
        if not track_best:
            return out
        bi = int(bi)
        return out, (float(bl), start_epoch + bi if bi >= 0 else None, best_state)
