"""End-to-end pipeline (port of flowerdiff/runner.py): data, then the VAE-GAN
trained if its checkpoint is missing, then the latent statistics, then the
latent DDPM trained or resumed, then the final sweep; or, for v4/v5, the
pixel DDPM and its artifacts.

As in the reference:
  - checkpoints are step directories per model (`ckpt_vae`, `ckpt_diffusion`,
    `ckpt_pixel`, train/checkpoints.py); `checkpoint_path` with `...epoch_N`
    resumes the diffusion stage from step N;
  - training runs in fused chunks of epochs (`_chunk_size`) that never cross
    a visualisation or checkpoint cadence, so the artifacts land at the same
    epochs as an epoch-by-epoch run;
  - the VAE-GAN keeps the state of its best epoch (lowest mean total loss)
    and saves it at the save cadence and at the end, beside the final state;
  - every stage prints one `[stage ...]` line attributing its wall time.

Randomness: where the reference folds the epoch into a key, the port
derives an integer seed or a generator from (seed, stream, epoch)
(`utils/device.derived_seed`): stream 0 the VAE-GAN, 1 the latent DDPM, 2
the pixel DDPM. The two runners therefore train on other draws; their
control flow, cadences, checkpoints and artifact names are the same.

Under a data-parallel mesh (parallel/mesh.py; the CLI under torchrun)
every rank trains on its rows of each global batch and holds the same
state; rank 0 alone writes the logs, figures, checkpoints, the final sweep
and the quality report, and loads the dataset (and its cache) first.

Figures need matplotlib (and the latent sweeps sklearn). A run that asks
for cadence figures or the final sweep without them stops before training;
the figures every run writes (the loss curves, the v3 color grid, the pixel
grid and single sample) are skipped with one line each where matplotlib is
missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from flowerdiff_torch import viz
from flowerdiff_torch.configs import VersionPreset
from flowerdiff_torch.data import DeviceDataset, synthetic_flowers
from flowerdiff_torch.data.flowers102 import class_names as flowers_class_names
from flowerdiff_torch.data.flowers102 import load_flowers102
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.parallel.mesh import barrier, is_writer, mesh_size
from flowerdiff_torch.train.checkpoints import (
    CheckpointManager,
    parse_epoch_from_filename,
    state_to_tree,
    tree_into_state,
    tree_into_vae_gan_state,
    vae_gan_snapshot_to_tree,
    vae_gan_state_to_tree,
)
from flowerdiff_torch.train.latent_ddpm import LatentDiffusionTrainer
from flowerdiff_torch.train.metrics import LossHistory
from flowerdiff_torch.train.pixel_ddpm import PixelDiffusionTrainer
from flowerdiff_torch.train.vae_gan import VAEGANTrainer
from flowerdiff_torch.utils.device import derived_generator, derived_seed, resolve_device
from flowerdiff_torch.utils.image import psnr
from flowerdiff_torch.viz._common import pyplot
from flowerdiff_torch.viz.animation import create_pixel_diffusion_animation
from flowerdiff_torch.viz.grids import generate_pixel_samples_grid

VAE_STREAM, DIFFUSION_STREAM, PIXEL_STREAM = 0, 1, 2


def _say(*args, **kwargs) -> None:
    """print, on the rank that writes (parallel/mesh.py `is_writer`)."""
    if is_writer():
        print(*args, **kwargs)


def missing_packages(*names: str) -> list:
    return [n for n in names if importlib.util.find_spec(n) is None]


def require_viz_packages(*names: str) -> None:
    """Raise ImportError naming the packages a run's figures need and lack."""
    missing = missing_packages(*names)
    if missing:
        raise ImportError(
            f"the figures of this run need {', '.join(missing)}, which is not installed; "
            f"run with --no-cadence-viz --no-final-sweep (or cadence_viz=False, "
            f"final_sweep=False) to train without them")


def unconditional_figure(what: str, fn, *args, **kwargs):
    """A figure the reference writes on every run: drawn where matplotlib
    imports, otherwise skipped with one line naming the package; rank 0
    alone draws it in a multi-process run."""
    if not is_writer():
        return None
    if missing_packages("matplotlib"):
        _say(f"skipped {what}: matplotlib is not installed")
        return None
    return fn(*args, **kwargs)


class _StageClock:
    """Wall-clock attribution of a pipeline stage: on `done`, one
    `[stage ...]` line with its total and its dispatch / checkpoint-save /
    viz buckets, largest first."""

    def __init__(self, stage: str):
        self.stage = stage
        self.t0 = time.perf_counter()
        self.buckets: dict[str, float] = {}
        self.first_dispatch: Optional[float] = None

    @contextlib.contextmanager
    def track(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            self.buckets[name] = self.buckets.get(name, 0.0) + dt
            if name == "dispatch" and self.first_dispatch is None:
                self.first_dispatch = dt

    def done(self) -> float:
        total = time.perf_counter() - self.t0
        parts = ", ".join(f"{k} {v:.1f}s" for k, v in
                          sorted(self.buckets.items(), key=lambda kv: -kv[1]))
        other = total - sum(self.buckets.values())
        first = (f" (first dispatch incl. compile {self.first_dispatch:.1f}s)"
                 if self.first_dispatch is not None else "")
        _say(f"[stage {self.stage}] {total:.1f}s total: {parts}, "
              f"other {other:.1f}s{first}", flush=True)
        return total


class _CondAdapter:
    """A (classes,)-conditioned view of a v3 (classes, colors) sampler that
    adds a default color label, for the class-only figures."""

    def __init__(self, sampler, default_color: int = 0):
        self._sampler = sampler
        self._color = default_color
        self.sched = sampler.sched
        self.event_shape = sampler.event_shape
        self.latent_dim = sampler.latent_dim
        self.device = sampler.device

    def _colors(self, n: int) -> torch.Tensor:
        return torch.full((n,), self._color, dtype=torch.long, device=self.device)

    def sample(self, batch, classes, **kw):
        return self._sampler.sample(batch, classes, self._colors(batch), **kw)

    def masked_denoise(self, x_init, t_start, classes, **kw):
        return self._sampler.masked_denoise(x_init, t_start, classes,
                                            self._colors(x_init.shape[0]), **kw)


def _writer_first(fn, *args, **kwargs):
    """fn(*args, **kwargs) on rank 0 first, then on the other ranks, which
    then read what it cached (one process: just the call)."""
    if is_writer():
        out = fn(*args, **kwargs)
        barrier()
        return out
    barrier()
    return fn(*args, **kwargs)


def _copy_leaves(dst, names, leaves: dict) -> None:
    """Copy host arrays `leaves[name]` into the tensors `dst`, in place."""
    torch._foreach_copy_(dst, [torch.as_tensor(np.asarray(leaves[n])).to(d.device)
                               for n, d in zip(names, dst)])


class PipelineRunner:
    def __init__(self, preset: VersionPreset, results_dir: Optional[str] = None,
                 data_root: str = "./data", dataset: str = "auto", seed: int = 42,
                 synthetic_size: int = 512, fused_epochs: bool = True, device=None,
                 mesh=None):
        """dataset: 'auto' (Flowers102 under data_root, else synthetic),
        'flowers102' or 'synthetic'. fused_epochs: train in chunks of
        epochs (the trainers' `run_epochs_fused`) instead of epoch by
        epoch. mesh: a data-parallel mesh (parallel/mesh.py), None for one
        process."""
        self.preset = preset
        self.seed = seed
        self.mesh = mesh
        self.writer = is_writer()
        self.device = resolve_device(device)
        self.fused_epochs = fused_epochs
        self.max_epochs_per_dispatch = 50
        is_pixel = preset.pixel is not None
        self.results_dir = results_dir or (
            "./oxford_flowers_image_diffusion" if is_pixel
            else "./oxford_flowers_conditional_improved")
        os.makedirs(self.results_dir, exist_ok=True)
        self.class_names = flowers_class_names()

        images, labels = _writer_first(self._load_data, data_root, dataset, synthetic_size)
        colors = None
        if preset.latent is not None and preset.latent.num_colors is not None:
            from flowerdiff_torch.data.color_labels import extract_color_labels_cached
            from flowerdiff_torch.viz.color_viz import create_flower_color_visualization

            colors, _names = _writer_first(
                extract_color_labels_cached, images,
                cache_path=os.path.join(self.results_dir, "color_labels.npz"))
            unconditional_figure(
                "color_visualization.png", create_flower_color_visualization,
                images[:100], labels[:100], self.class_names,
                num_samples=min(20, len(images)),
                save_path=os.path.join(self.results_dir, "color_visualization.png"),
                color_labels=colors[:100])
        self.train_ds = DeviceDataset(
            images, labels, colors=colors, augment=True,
            max_rotation_deg=0.0 if is_pixel else 10.0,  # the pixel family only flips
            jitter=0.0 if is_pixel else 0.2, device=self.device, mesh=mesh)
        # held-out rows (recon PSNR, t-SNE, MMD, the quality report): the
        # real test split, or synthetic images from another seed
        eval_images, eval_labels = _writer_first(self._load_eval_data, data_root, dataset,
                                                 synthetic_size)
        eval_ds = DeviceDataset(eval_images, eval_labels, augment=False, device=self.device)
        self.test_images, self.test_labels = eval_ds.full()[:2]
        self.train_images_eval = self.train_ds.full()[0]

    def _chunk_size(self, epoch: int, total: int, *cadences: Optional[int],
                    cap: Optional[int] = None) -> int:
        """Epochs for the next fused chunk: it never crosses a cadence
        boundary and never exceeds the cap."""
        n = min(cap or self.max_epochs_per_dispatch, total - epoch)
        for cadence in cadences:
            if cadence:
                n = min(n, cadence - (epoch % cadence))
        return max(1, n)

    def _load_data(self, data_root, dataset, synthetic_size):
        if dataset in ("auto", "flowers102"):
            try:
                return load_flowers102(data_root, "train", self.preset.img_size)
            except FileNotFoundError:
                if dataset == "flowers102":
                    raise
                _say("Flowers102 not found — using the synthetic dataset.")
        return synthetic_flowers(synthetic_size, 102, self.preset.img_size, seed=self.seed)

    def _load_eval_data(self, data_root, dataset, synthetic_size):
        """The real test split, or a synthetic set drawn from seed + 1000
        (other petal phases, jitter and noise: images never trained on)."""
        if dataset in ("auto", "flowers102"):
            try:
                return load_flowers102(data_root, "test", self.preset.img_size)
            except FileNotFoundError:
                if dataset == "flowers102":
                    raise
        return synthetic_flowers(max(128, synthetic_size // 2), 102, self.preset.img_size,
                                 seed=self.seed + 1000)

    # ------------------------------------------------------------------ #
    # Latent pipeline (v1/v2/v3, flagship)
    # ------------------------------------------------------------------ #

    def run_latent(self, total_epochs: int, vae_epochs: Optional[int] = None,
                   checkpoint_path: Optional[str] = None, batch_size: Optional[int] = None,
                   final_sweep: bool = True, cadence_viz: bool = True,
                   checkpoint_every: Optional[int] = None, restore_scope: str = "full"):
        """restore_scope: "full" restores the whole checkpointed state
        (exact resume, needed to train on); "params" restores only what
        sampling reads (the VAE's generator weights; the diffusion weights
        and EMA), the optimizer moments staying at init, and skips the
        recon PSNR. Returns (VAE-GAN trainer, diffusion trainer). Under a
        mesh of more than one rank the restore is always "full"."""
        preset = self.preset
        assert preset.vae is not None and preset.latent is not None
        if restore_scope not in ("full", "params"):
            raise ValueError(f"restore_scope {restore_scope!r}: choose 'full' or 'params'")
        if mesh_size(self.mesh) > 1:
            restore_scope = "full"
        if cadence_viz or final_sweep:
            require_viz_packages("matplotlib", "sklearn")
        batch_size = batch_size or preset.batch_size
        steps_per_epoch = max(1, self.train_ds.n // batch_size)
        vae_epochs = vae_epochs if vae_epochs is not None else preset.vae_epochs

        # ---- VAE-GAN: train if missing ----
        vae_cfg = dataclasses.replace(preset.vae,
                                      total_steps=max(1, vae_epochs * steps_per_epoch))
        trainer = VAEGANTrainer(vae_cfg, seed=derived_seed(self.seed, VAE_STREAM),
                                img_size=preset.img_size, device=self.device)
        vae_ckpt = CheckpointManager(os.path.join(self.results_dir, "ckpt_vae"))
        history = LossHistory()
        if vae_ckpt.exists():
            _say(f"Loading existing autoencoder from {vae_ckpt.directory}")
            like_tree = vae_gan_state_to_tree(trainer.state)
            if restore_scope == "params":
                host = vae_ckpt.restore_host(like=like_tree)
                gen = trainer.state.gen
                _copy_leaves(gen.params, gen.names, host["gen"]["params"])
            else:
                tree_into_vae_gan_state(trainer.state, vae_ckpt.restore(like=like_tree))
        else:
            _say("No existing autoencoder found. Training a new one...")
            self._train_vae_gan(trainer, vae_ckpt, history, vae_epochs, batch_size,
                                cadence_viz, checkpoint_every)

        vae = trainer.vae
        self._trained_vae = vae
        setup_clock = _StageClock("inter_stage_setup")
        decode_fn, encode_mu_fn, encode_decode_fn = self._vae_fns(vae)
        if restore_scope != "params" and self.writer:
            with setup_clock.track("recon_psnr"):
                _say(f"VAE recon PSNR: {self._recon_psnr(encode_decode_fn):.2f} dB "
                      f"(held-out) / "
                      f"{self._recon_psnr(encode_decode_fn, images=self.train_images_eval):.2f}"
                      f" dB (train)")

        # ---- latent diffusion: resume, then train ----
        lat_cfg = dataclasses.replace(preset.latent, steps_per_epoch=steps_per_epoch)
        latent_stats = None
        if lat_cfg.normalize_latents:
            with setup_clock.track("latent_stats"):
                latent_stats = self._compute_latent_stats(vae)
        diff = LatentDiffusionTrainer(lat_cfg, vae, seed=derived_seed(self.seed,
                                                                     DIFFUSION_STREAM),
                                      latent_stats=latent_stats, device=self.device)
        setup_clock.done()
        diff_ckpt = CheckpointManager(os.path.join(self.results_dir, "ckpt_diffusion"))
        start_epoch = 0
        if checkpoint_path:
            epoch = parse_epoch_from_filename(checkpoint_path)
            if epoch is not None and diff_ckpt.exists():
                start_epoch = epoch
                tree_into_state(diff.state,
                                diff_ckpt.restore(epoch, like=state_to_tree(diff.state)))
                _say(f"Continuing training from epoch {start_epoch}")
        elif diff_ckpt.exists():
            start_epoch = diff_ckpt.latest_step()
            if restore_scope == "params" and start_epoch >= total_epochs:
                host = diff_ckpt.restore_host(like=state_to_tree(diff.state))
                _copy_leaves(diff.state.params, diff.state.names, host["params"])
                if diff.state.ema is not None:
                    _copy_leaves(diff.state.ema, diff.state.names, host["ema_params"])
            else:
                tree_into_state(diff.state, diff_ckpt.restore(like=state_to_tree(diff.state)))
            _say(f"Loaded diffusion model at epoch {start_epoch}")

        # the reference saves at every visualisation cadence;
        # checkpoint_every decouples the two
        ckpt_every = checkpoint_every or preset.diffusion_visualize_every
        viz_cadence = preset.diffusion_visualize_every if cadence_viz else None
        diff_losses = []
        ep_rng = np.random.default_rng(self.seed + 1)
        epoch = start_epoch
        clock = _StageClock("latent_ddpm")
        saved_at = None
        while epoch < total_epochs:
            gen = derived_generator(self.device, self.seed, DIFFUSION_STREAM, epoch)
            if self.fused_epochs:
                cached = diff.cfg.latent_cache > 0
                n = self._chunk_size(epoch, total_epochs, viz_cadence, ckpt_every,
                                     cap=1000 if cached else None)
                with clock.track("dispatch"):
                    chunk = diff.run_epochs_fused(self.train_ds, n, None, gen, batch_size,
                                                  mesh=self.mesh)
            else:
                chunk = [diff.run_epoch(self.train_ds.batches(ep_rng, batch_size), gen,
                                        mesh=self.mesh)]
            for off, loss in enumerate(chunk):
                diff_losses.append(loss)
                _say(f"Epoch {epoch + off + 1}/{total_epochs}, Average Loss: {loss:.6f}")
            epoch += len(chunk)
            if cadence_viz and self.writer and epoch % preset.diffusion_visualize_every == 0:
                with clock.track("viz"):
                    self._diffusion_viz(diff, decode_fn, encode_mu_fn, epoch)
            if epoch % ckpt_every == 0 or epoch == total_epochs:
                with clock.track("ckpt_save"):
                    diff_ckpt.save(epoch, state_to_tree(diff.state))
                saved_at = epoch
        if diff_losses:
            if saved_at != total_epochs:
                with clock.track("ckpt_save"):
                    diff_ckpt.save(total_epochs, state_to_tree(diff.state))
            name = "diffusion_loss_continued.png" if start_epoch else "diffusion_loss.png"
            unconditional_figure(name, viz.plot_single_loss_curve, diff_losses,
                                 os.path.join(self.results_dir, name),
                                 start_epoch=start_epoch or None)
        clock.done()

        if final_sweep and self.writer:
            sweep_clock = _StageClock("final_sweep")
            self._final_sweep(diff, decode_fn, encode_mu_fn, clock=sweep_clock)
            sweep_clock.done()
        return trainer, diff

    def _train_vae_gan(self, trainer: VAEGANTrainer, vae_ckpt: CheckpointManager,
                       history: LossHistory, vae_epochs: int, batch_size: int,
                       cadence_viz: bool, checkpoint_every: Optional[int]) -> None:
        """The VAE-GAN stage: chunks of epochs, the best-epoch state kept
        (on the device in the fused form, as a copied tree epoch by epoch)
        and saved at the save cadence (checkpoint_every, else the viz
        cadence) and at the end, then the final state as step vae_epochs,
        the history and the loss curves."""
        preset = self.preset
        clock = _StageClock("vae_gan")
        best = float("inf")
        best_tree = None  # epoch by epoch: a copied tree of the best state
        best_state = None  # fused: the trainer's snapshot of the best state
        best_epoch = 0
        saved_best_epoch = None
        ep_rng = np.random.default_rng(self.seed)
        save_every = checkpoint_every or preset.vae_visualize_every

        def best_as_tree():
            if best_tree is not None:
                return best_tree
            return vae_gan_snapshot_to_tree(trainer.state, best_state)

        have_best = False
        epoch = 0
        while epoch < vae_epochs:
            seed = derived_seed(self.seed, VAE_STREAM, epoch)
            if self.fused_epochs:
                n = self._chunk_size(epoch, vae_epochs, preset.vae_visualize_every, save_every)
                with clock.track("dispatch"):
                    chunk, (best, maybe_epoch, best_state) = trainer.run_epochs_fused(
                        self.train_ds, epoch, vae_epochs, n, seed, batch_size,
                        best=(best, best_state), mesh=self.mesh)
                if maybe_epoch is not None:
                    best_epoch, have_best = maybe_epoch, True
            else:
                batches = self.train_ds.batches(ep_rng, batch_size)
                if preset.latent.num_colors is not None:
                    batches = ((img, lab) for img, lab, _col in batches)
                chunk = [trainer.run_epoch(batches, epoch, vae_epochs, seed, mesh=self.mesh)]
            for off, metrics in enumerate(chunk):
                history.append(metrics)
                _say(f"Epoch {epoch + off + 1}/{vae_epochs}, "
                      + ", ".join(f"{k}: {v:.6f}" for k, v in sorted(metrics.items())))
            if not self.fused_epochs:
                totals = [m["total"] for m in chunk]
                if min(totals) < best:
                    # a copy of the FULL state (both optimizers and the
                    # centers), so that a resume from it is exact
                    best = min(totals)
                    best_epoch = epoch + len(chunk) - 1
                    best_tree = _clone_tree(vae_gan_state_to_tree(trainer.state))
                    have_best = True
            epoch += len(chunk)
            if (epoch % save_every == 0 or epoch == vae_epochs) and have_best:
                with clock.track("ckpt_save"):
                    vae_ckpt.save(best_epoch, best_as_tree())
                saved_best_epoch = best_epoch
            if ((epoch % preset.vae_visualize_every == 0 or epoch == vae_epochs) and cadence_viz
                    and self.writer):
                with clock.track("viz"):
                    self._vae_viz(trainer, epoch)
        if have_best and saved_best_epoch != best_epoch:
            with clock.track("ckpt_save"):
                vae_ckpt.save(best_epoch, best_as_tree())
        with clock.track("ckpt_save"):
            vae_ckpt.save(vae_epochs, vae_gan_state_to_tree(trainer.state))
        if self.writer:
            history.save_jsonl(os.path.join(self.results_dir, "vae_history.jsonl"))
        unconditional_figure("autoencoder_losses.png", viz.plot_loss_curves, history.history,
                             os.path.join(self.results_dir, "autoencoder_losses.png"))
        clock.done()

    # ------------------------------------------------------------------ #
    # Pixel pipeline (v4/v5)
    # ------------------------------------------------------------------ #

    def run_pixel(self, epochs: Optional[int] = None, batch_size: Optional[int] = None,
                  cadence_viz: bool = True):
        preset = self.preset
        assert preset.pixel is not None
        if cadence_viz and preset.pixel_visualize_every:
            require_viz_packages("matplotlib")
        epochs = epochs if epochs is not None else preset.pixel_epochs
        batch_size = batch_size or preset.batch_size
        trainer = PixelDiffusionTrainer(preset.pixel, seed=derived_seed(self.seed, PIXEL_STREAM),
                                        device=self.device)
        ckpt = CheckpointManager(os.path.join(self.results_dir, "ckpt_pixel"))
        if ckpt.exists():
            tree_into_state(trainer.state, ckpt.restore(like=state_to_tree(trainer.state)))
            _say(f"Loaded pixel diffusion at epoch {ckpt.latest_step()}")
        else:
            ep_rng = np.random.default_rng(self.seed)
            epoch = 0
            while epoch < epochs:
                seed = derived_seed(self.seed, PIXEL_STREAM, epoch)
                if self.fused_epochs:
                    n = self._chunk_size(epoch, epochs, preset.pixel_visualize_every)
                    chunk = trainer.run_epochs_fused(self.train_ds, n, seed, batch_size,
                                                     mesh=self.mesh)
                else:
                    chunk = [trainer.run_epoch(self.train_ds.batches(ep_rng, batch_size), seed,
                                               mesh=self.mesh)]
                for off, loss in enumerate(chunk):
                    _say(f"Diffusion Epoch {epoch + off + 1}/{epochs}, Loss: {loss:.4f}")
                epoch += len(chunk)
                if (cadence_viz and self.writer and preset.pixel_visualize_every
                        and epoch % preset.pixel_visualize_every == 0):
                    # 0-based epoch in the artifact names, as the reference
                    sampler = trainer.sampler()
                    generate_pixel_samples_grid(sampler, save_path=os.path.join(
                        self.results_dir, f"samples_grid_epoch_{epoch - 1}.png"))
                    create_pixel_diffusion_animation(sampler, save_path=os.path.join(
                        self.results_dir, f"diffusion_animation_epoch_{epoch - 1}.gif"))
            ckpt.save(epochs, state_to_tree(trainer.state))

        if not self.writer:
            return trainer
        sampler = trainer.sampler()
        unconditional_figure("samples_grid.png", generate_pixel_samples_grid, sampler,
                             save_path=os.path.join(self.results_dir, "samples_grid.png"))
        create_pixel_diffusion_animation(
            sampler, save_path=os.path.join(self.results_dir, "diffusion_animation.gif"))
        unconditional_figure("generated_pixel_diffusion.png", self._single_pixel_sample,
                             sampler)
        return trainer

    def _single_pixel_sample(self, sampler):
        """One generated image -> generated_pixel_diffusion.png."""
        plt = pyplot()
        img = sampler.sample(1, generator=derived_generator(self.device, self.seed, 9))
        img = img[0].float().cpu().numpy()
        plt.figure(figsize=(4, 4))
        plt.imshow(np.clip(img, 0, 1))
        plt.axis("off")
        plt.title("Generated Image")
        path = os.path.join(self.results_dir, "generated_pixel_diffusion.png")
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        _say(f"Generated image saved as {path}")

    # ------------------------------------------------------------------ #
    # Helpers
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _compute_latent_stats(self, vae: FlowerVAE, noise: Optional[torch.Tensor] = None):
        """Per-dim mean and std (at least 1e-3) of the trained VAE's
        posterior draws over the train split, for z-scored DDPM training.
        The draw comes from the generator of (seed, 3), so a resume
        recomputes the same statistics (`noise` replaces the draw). Saved
        as latent_stats.npz; returned as host arrays (mean, std)."""
        imgs = self.train_ds.full()[0]
        mu, logvar = vae.encode_with_params(imgs)
        z = FlowerVAE.reparameterize(mu, logvar, derived_generator(self.device, self.seed, 3),
                                     noise)
        mean = z.mean(dim=0).cpu().numpy()
        std = torch.clamp(z.std(dim=0, unbiased=False), min=1e-3).cpu().numpy()
        if self.writer:
            np.savez(os.path.join(self.results_dir, "latent_stats.npz"), mean=mean, std=std)
        _say(f"latent stats: |mean| {float(np.abs(mean).mean()):.3f}, "
              f"std range [{float(std.min()):.3f}, {float(std.max()):.3f}]")
        return mean, std

    def _quality_report(self, sampler, encode_mu_fn):
        """Classifier accuracy on generated samples, latent MMD and the
        perceptual Fréchet distance (VGG relu3_3, globally pooled) against
        the held-out and the train rows, appended to sample_quality.jsonl
        (utils/quality.py)."""
        from flowerdiff_torch.models.vgg import VGGPerceptual, load_vgg_params
        from flowerdiff_torch.utils.quality import sample_quality_report

        vae = self._trained_vae
        vgg_params, pretrained = load_vgg_params()
        vgg = VGGPerceptual(vgg_params, pretrained, device=self.device)

        def classify(z):
            return vae.classify(z)

        def pooled_feats(x):
            return vgg.features(x).mean(dim=(2, 3))  # (N, 256)

        with torch.no_grad():
            report = sample_quality_report(
                sampler, classify, encode_mu_fn, self.test_images, self.seed + 7,
                num_classes=len(self.class_names),
                extra_splits={"train": self.train_images_eval},
                decode_fn=vae.decode, feature_fn=pooled_feats, feature_params=vgg_params,
                run_id=os.path.abspath(self.results_dir))
        _say("Sample quality: classifier acc "
              f"{report['classifier_accuracy']:.3f} (chance "
              f"{report['chance_accuracy']:.3f}), latent MMD heldout "
              f"{report['latent_mmd']:.4f} / train "
              f"{report['latent_mmd_train']:.4f}, perceptual FD heldout "
              f"{report['perceptual_fd']:.1f} / train "
              f"{report['perceptual_fd_train']:.1f}")

        def _safe(d):
            return {k: (v if not isinstance(v, float) or np.isfinite(v) else str(v))
                    for k, v in d.items()}

        # two rows, one a split, from one generation pass
        shared = {k: report[k] for k in ("classifier_accuracy", "chance_accuracy", "n_generated")}
        shared.update({k: report[k] for k in ("fd_backbone", "fd_run_id") if k in report})
        rows = [
            {"split": "heldout", **shared, "latent_mmd": report["latent_mmd"],
             "perceptual_fd": report.get("perceptual_fd"), "n_real": report["n_real"]},
            {"split": "train", **shared, "latent_mmd": report["latent_mmd_train"],
             "perceptual_fd": report.get("perceptual_fd_train")},
        ]
        with open(os.path.join(self.results_dir, "sample_quality.jsonl"), "a") as f:
            for row in rows:
                f.write(json.dumps(_safe(row)) + "\n")
        return report

    @staticmethod
    def _vae_fns(vae: FlowerVAE):
        """(decode(z), encode_mu(x), encode_decode(x, generator)) over the
        VAE's current weights, without gradient."""

        @torch.no_grad()
        def decode(z):
            return vae.decode(z)

        @torch.no_grad()
        def encode_mu(x):
            return vae.encode_with_params(x)[0]

        @torch.no_grad()
        def encode_decode(x, generator=None):
            mu, logvar = vae.encode_with_params(x)
            return vae.decode(FlowerVAE.reparameterize(mu, logvar, generator))

        return decode, encode_mu, encode_decode

    def _recon_psnr(self, encode_decode_fn, n: int = 64, images=None) -> float:
        imgs = (self.test_images if images is None else images)[:n]
        recon = encode_decode_fn(imgs, derived_generator(self.device, 0))
        return float(psnr(imgs, recon))

    def _vae_viz(self, trainer: VAEGANTrainer, epoch: int):
        _, encode_mu_fn, encode_decode_fn = self._vae_fns(trainer.vae)
        labels = self.test_labels.cpu().numpy()
        viz.visualize_reconstructions(encode_decode_fn, self.test_images, labels, epoch,
                                      self.class_names, self.results_dir)
        viz.visualize_latent_space(encode_mu_fn, self.test_images, labels, epoch,
                                   self.class_names, self.results_dir, max_points=2000)

    def _viz_sampler(self, diff):
        """(the sampler, its class-only view): v3's gets a default color."""
        sampler = diff.sampler()
        if self.preset.latent.num_colors is not None:
            return sampler, _CondAdapter(sampler)
        return sampler, sampler

    def _diffusion_viz(self, diff, decode_fn, encode_mu_fn, epoch: int):
        """Cadence figures: the first 2 classes for v1/v2; classes 4, 53 and
        68 with purple and yellow color strips for v3."""
        raw_sampler, sampler = self._viz_sampler(diff)
        labels = self.test_labels.cpu().numpy()
        if self.preset.latent.num_colors is not None:
            from flowerdiff_torch.viz.color_viz import generate_class_color_samples

            class_list = [i for i in (4, 53, 68) if i < len(self.class_names)]
            for class_idx in class_list:
                name = self.class_names[class_idx]
                for color in ("purple", "yellow"):
                    generate_class_color_samples(
                        raw_sampler, decode_fn, class_idx, color, self.class_names,
                        save_path=os.path.join(
                            self.results_dir,
                            f"sample_class_color_{name}_{color}_epoch_{epoch}.png"))
        else:
            class_list = range(min(len(self.class_names), 2))
        for class_idx in class_list:
            name = self.class_names[class_idx]
            viz.create_diffusion_animation(
                sampler, decode_fn, class_idx, self.class_names,
                save_path=os.path.join(self.results_dir,
                                       f"diffusion_animation_class_{name}_epoch_{epoch}.gif"))
            viz.generate_class_samples(
                sampler, decode_fn, class_idx, self.class_names,
                save_path=os.path.join(self.results_dir, f"sample_class_{name}_epoch_{epoch}.png"))
            viz.visualize_denoising_steps(
                encode_mu_fn, decode_fn, sampler, self.test_images, labels, class_idx,
                self.class_names,
                save_path=os.path.join(self.results_dir,
                                       f"denoising_path_{name}_epoch_{epoch}.png"))

    def _final_sweep(self, diff, decode_fn, encode_mu_fn, clock=None):
        """The quality report, the sample grid, then 10 denoising paths and
        10 GIFs, one a class, with the plain f32 model (as the reference)."""
        clock = clock or _StageClock("final_sweep(detached)")
        _raw, sampler = self._viz_sampler(diff)
        labels = self.test_labels.cpu().numpy()
        with clock.track("quality_report"):
            self._quality_report(sampler, encode_mu_fn)
        with clock.track("samples_grid"):
            viz.generate_samples_grid(sampler, decode_fn, self.class_names,
                                      save_dir=self.results_dir)
        for class_idx in range(min(len(self.class_names), 10)):
            name = self.class_names[class_idx]
            with clock.track("denoising_paths"):
                viz.visualize_denoising_steps(
                    encode_mu_fn, decode_fn, sampler, self.test_images, labels, class_idx,
                    self.class_names,
                    save_path=os.path.join(self.results_dir, f"denoising_path_{name}_final.png"))
            with clock.track("animations"):
                viz.create_diffusion_animation(
                    sampler, decode_fn, class_idx, self.class_names, fps=15,
                    save_path=os.path.join(self.results_dir,
                                           f"diffusion_animation_{name}_final.gif"))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree
