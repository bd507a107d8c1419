"""Production sampling services (port of `SamplingService` and
`PixelSamplingService` in flowerdiff/serving.py).

One `SamplingService` holds the denoiser behind a sampler, optionally
z-score denormalisation, and the VAE decoder. A request of N class labels
is cut into bucket-sized chunks (`request_plan`): full top-bucket chunks
plus one ladder bucket for the tail, each padded with class 0 and sliced
back on the host. Each chunk runs

    sample -> denormalise -> decode
    [-> round(clip(img, 0, 1) * 255) as uint8 with quantize_uint8=True]

and the service returns (N, 64, 64, 3) images as numpy: float32 by default,
as the reference does, or uint8 when the service quantizes.

The sampler: `sampler_kind='ancestral'` runs the 1000 ancestral steps with
CFG and x0 clip, on the kernel path (`FusedDiffusionSampler`) when
`use_fused` (default: on a CUDA device), where the 1000 steps are one launch
of the reverse-process kernel and `warmup` binds every bucket's plan of it
before traffic; with `use_fused=False` it runs the plain f32 model.
`sampler_kind='ddim'` runs `ddim_steps` deterministic DDIM steps of the
plain f32 model (a `DDIMSampler` outside the `NormalizedSampler`, as in the
reference). `sample_async` issues every chunk before it fetches any;
`sample` is `sample_async(...)()`.

The decoder runs under cuDNN's deterministic algorithms, so a result is
reproducible bit for bit for a given (seed, request): chunk i of a request
draws from a generator seeded by (seed, i). `decode_bf16=True` runs the
decoder's convolutions and products in bf16 (autocast), its output cast
back to f32 before any quantisation.

Unlike the reference service, `guidance_scale` is a constructor argument
and reaches the sampler.

`PixelSamplingService` serves the unconditional pixel family (v4/v5) on the
same bucket ladder, (4, 16, 64) by default: one 1000-step reverse process
(or DDIM) of the PixelUNet per chunk, then the clip to [0, 1] (and the
uint8 quantisation) on the device. Its sampler runs under cuDNN's
deterministic algorithms, so two identical requests are bit-equal.

`animate` (both services) returns one diffusion animation as GIF bytes, built
from the same frames as viz/animation.py.

Threads: each service holds one lock (`device_lock`) while it enqueues
device work (a request's chunks, a decode, an animation's sampling) and
releases it before it waits for the results. The lock keeps
`deterministic_cudnn`'s process-wide flags to one thread at a time. A
bucket's first call on the kernel path binds its plan (and may build the
kernel), which a threaded caller keeps out of live traffic by warming every
bucket first (`warmup`; `unwarmed` lists what is left); the HTTP server
(serving_http.serve) refuses a service with a bucket left. Every call
enqueues on the calling thread's current stream (the default stream for the
HTTP server's threads), so later work cannot overtake an earlier copy of a
result. `service_from_run` and
`pixel_service_from_run` build a service from the run directory the
runner (runner.py) leaves: the latest checkpoints, the latent statistics and
the configuration the run trained with.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from flowerdiff_torch.diffusion.api import (
    DDIMSampler,
    DiffusionSampler,
    FusedDiffusionSampler,
    NormalizedSampler,
)
from flowerdiff_torch.diffusion.schedule import DiffusionSchedule, linear_schedule
from flowerdiff_torch.utils import profiling
from flowerdiff_torch.utils.device import (
    derived_generator,
    deterministic_cudnn,
    resolve_device,
)

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def quantize_uint8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats -> uint8, rounding half to even like jnp.round."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def _to_host(out: torch.Tensor):
    """(host tensor, event or None): a card tensor's copy into pinned host
    memory enqueued without waiting, and the event that marks it done."""
    with profiling.annotate("service.to_host", bytes=out.numel() * out.element_size()):
        if not out.is_cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


def _fetcher(pending, call: Optional[int] = None) -> Callable[[], np.ndarray]:
    """fetch() over (host tensor, event, rows to keep) chunks: waits for each
    in order (a span `service.fetch` of the call `call` each), slices its
    padding off, concatenates."""
    def fetch() -> np.ndarray:
        outs = []
        for i, (out, done, take) in enumerate(pending):
            with profiling.annotate("service.fetch", call=call, chunk=i):
                if done is not None:
                    done.synchronize()
            outs.append(out.numpy()[:take])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    return fetch


class SamplingService:
    @profiling.spanned("service.build")
    def __init__(
        self,
        model,
        vae,
        sched: Optional[DiffusionSchedule] = None,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        latent_stats=None,
        clip_x0: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        quantize_uint8: bool = False,
        use_fused: Optional[bool] = None,
        sampler_kind: str = "ancestral",
        ddim_steps: int = 50,
        decode_bf16: bool = False,
        device=None,
    ):
        """model: the port's ConditionalLatentDenoiser; vae: the port's
        FlowerVAE (decode half). latent_stats: (mean, std) per-dim arrays
        when the model was trained on z-scored latents. clip_x0: the
        x0-thresholding bound; guidance_scale: classifier-free guidance.
        quantize_uint8: return uint8 images (rounded half to even on the
        device, a quarter of the bytes to the host) instead of the decoder's
        float32 output. use_fused: the kernel path for ancestral `sample`;
        None picks it on a CUDA device and the plain model elsewhere. On the
        card the kernel path takes every denoiser the JAX kernel holds in its
        100 MiB of VMEM whose widths are at most 4096 (the --tiny preset's
        and the flagship's among them; `kernels.full_sampler.process_plan`).
        sampler_kind: 'ancestral' or 'ddim' (`ddim_steps` strided steps).
        decode_bf16: the decoder under bf16 autocast, output f32."""
        self.device = resolve_device(device)
        self.device_lock = threading.RLock()
        if sampler_kind not in ("ancestral", "ddim"):
            raise ValueError(f"unknown sampler_kind {sampler_kind!r}")
        self.quantize_uint8 = quantize_uint8
        self.decode_bf16 = decode_bf16
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.sched = sched or linear_schedule()
        self.model = model.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.use_fused = self.device.type == "cuda" if use_fused is None else use_fused
        cls = FusedDiffusionSampler if self.use_fused else DiffusionSampler
        self.sampler = cls(self.model, self.sched, (model.latent_dim,), clip_x0=clip_x0,
                           guidance_scale=guidance_scale, device=self.device)
        if latent_stats is not None:
            self.sampler = NormalizedSampler(self.sampler, *latent_stats)
        if sampler_kind == "ddim":
            self.sampler = DDIMSampler(self.sampler, num_steps=ddim_steps)

    def bucket_size(self, n: int) -> int:
        """Smallest bucket >= n."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{n} exceeds the largest bucket {self.buckets[-1]}; "
            "oversize requests are chunked via request_plan()")

    def request_plan(self, n: int) -> list:
        """Bucket sizes for an n-image request: full top-bucket chunks plus
        one ladder bucket for the tail."""
        top = self.buckets[-1]
        plan = [top] * (n // top)
        rest = n % top
        if rest:
            plan.append(self.bucket_size(rest))
        return plan or [self.buckets[0]]

    @staticmethod
    def _pad(arr: np.ndarray, target: int) -> np.ndarray:
        n = arr.shape[0]
        if n == target:
            return arr
        return np.concatenate([arr, np.zeros((target - n,) + arr.shape[1:], arr.dtype)])

    @profiling.spanned("service.decode")
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        with deterministic_cudnn(), torch.autocast(self.device.type, dtype=torch.bfloat16,
                                                   enabled=self.decode_bf16):
            img = self.vae.decode(latents)
        img = img.float()
        return quantize_uint8(img) if self.quantize_uint8 else img

    def warmup(self, seed: int = 0, buckets: Optional[Sequence[int]] = None,
               with_colors: bool = False) -> None:
        """Run the live path once per bucket (default: all), host numpy
        classes in and images out, so that every kernel is built and, on
        the kernel path, every bucket's plan of the reverse-process kernel
        bound (its tensor maps encoded) before live traffic. A span
        `service.warmup` holds one `service.sample_async` a bucket."""
        buckets = buckets or self.buckets
        with profiling.annotate("service.warmup", buckets=tuple(buckets)):
            for b in buckets:
                classes = np.zeros((b,), np.int64)
                colors = np.zeros((b,), np.int64) if with_colors else None
                self.sample(classes, seed, colors, decode=True)

    def unwarmed(self) -> list:
        """The buckets whose live request would still bind a plan of the
        reverse-process kernel (the kernel path on the card): [] once
        `warmup` has run, and always off that path."""
        sampler = self.sampler
        if isinstance(sampler, NormalizedSampler):
            sampler = sampler._inner
        if self.device.type != "cuda" or not isinstance(sampler, FusedDiffusionSampler):
            return []
        guided = sampler.guidance_scale is not None
        return [b for b in self.buckets if (b, guided) not in sampler.process.bound]

    @torch.no_grad()
    def sample_async(self, classes, seed: int = 0, colors=None, decode: bool = True,
                     x_init=None, stochastic: bool = True) -> Callable[[], np.ndarray]:
        """Dispatch a request as bucket-sized chunks (`request_plan`) and
        return `fetch()`, which waits for the chunks in order and slices
        each chunk's padding off. Every chunk is issued before any is
        fetched: its sampler replay, decode and the copy of its result into
        pinned host memory (`non_blocking`) are all enqueued, so chunk i's
        copy overlaps chunk i + 1's sampling. Arguments as `sample`.

        Spans (utils/profiling.py): the call `service.sample_async` (its
        call id, images, chunks), then a `service.chunk` a chunk (chunk,
        bucket, take) over its copies in (`service.cond_copy`), the
        generator (`sampler.draw`), the sampler's spans, the decode and the
        copy out; its self time holds the denormalisation."""
        classes = np.asarray(classes, np.int64).reshape(-1)
        if colors is not None:
            colors = np.asarray(colors, np.int64).reshape(-1)
        if x_init is not None:
            x_init = np.asarray(x_init, np.float32)
        n = classes.shape[0]
        plan = self.request_plan(n)
        call = profiling.new_id()
        pending = []
        start = 0
        with profiling.annotate("service.sample_async", call=call, images=n, chunks=len(plan)), \
                self.device_lock:
            for i, b in enumerate(plan):
                take = min(b, n - start)
                part = slice(start, start + take)
                with profiling.annotate("service.chunk", chunk=i, bucket=b, take=take):
                    with profiling.annotate("service.cond_copy"):
                        cond = [torch.from_numpy(self._pad(classes[part], b)).to(self.device)]
                        if colors is not None:
                            cond.append(torch.from_numpy(self._pad(colors[part], b))
                                        .to(self.device))
                        x0 = None
                        if x_init is not None:
                            x0 = torch.from_numpy(self._pad(x_init[part], b)).to(self.device)
                    with profiling.annotate("sampler.draw"):
                        generator = derived_generator(self.device, seed, i)
                    lat = self.sampler.sample(b, *cond, generator=generator, x_init=x0,
                                              stochastic=stochastic)
                    pending.append((*_to_host(self._decode(lat) if decode else lat), take))
                start += take
        return _fetcher(pending, call)

    def sample(self, classes, seed: int = 0, colors=None, decode: bool = True,
               x_init=None, stochastic: bool = True) -> np.ndarray:
        """One image (or latent, decode=False) per entry of `classes`
        (and `colors` for v3). Returns (N, 64, 64, 3) images (float32, or
        uint8 with quantize_uint8) or (N, latent) float32 latents. x_init
        (N, latent) and stochastic=False fix the starting state and drop the
        step noise (for checks against a reference). `sample_async`, then
        its fetch."""
        return self.sample_async(classes, seed, colors, decode, x_init, stochastic)()

    def sample_latents(self, classes, seed: int = 0, colors=None) -> np.ndarray:
        return self.sample(classes, seed, colors, decode=False)

    @torch.no_grad()
    def _decode_async(self, latents: torch.Tensor) -> Callable[[], np.ndarray]:
        """Enqueue the decode of (N, latent) raw VAE latents (host or
        device) in bucket-sized chunks, each padded with zero rows; returns
        fetch(), as `sample_async`."""
        n = latents.shape[0]
        pending = []
        start = 0
        with self.device_lock:
            for b in self.request_plan(n):
                take = min(b, n - start)
                chunk = latents[start:start + take].to(self.device)
                if take < b:
                    chunk = torch.cat([chunk, chunk.new_zeros((b - take,) + chunk.shape[1:])])
                pending.append((*_to_host(self._decode(chunk)), take))
                start += take
        return _fetcher(pending)

    def decode_latents(self, latents) -> np.ndarray:
        """(N, latent) raw VAE latents -> (N, 64, 64, 3) images (float32,
        or uint8 with quantize_uint8), in bucket-sized chunks."""
        return self._decode_async(torch.from_numpy(np.asarray(latents, np.float32)))()

    def animate(self, class_idx: int, seed: int = 0, color: Optional[int] = None,
                num_frames: int = 50, fps: int = 10, label: Optional[str] = None) -> bytes:
        """One diffusion animation as GIF bytes, the serving form of
        viz.create_diffusion_animation: one clean latent through the
        bucketed sampler (the generator of (seed, 0)), re-noised to each t
        of the ping-pong timestep list with one eps (the generator of
        (seed, 0, 1)), every frame decoded through the bucket ladder."""
        from flowerdiff_torch.viz.animation import (
            _pingpong_timesteps,
            _render_frame,
            encode_gif,
            frame_title,
            renoise_frames,
        )

        cls = np.full((1,), class_idx, np.int64)
        col = np.full((1,), color, np.int64) if color is not None else None
        clean = torch.from_numpy(self.sample(cls, seed, col, decode=False))
        timesteps = _pingpong_timesteps(self.sched.n_steps, num_frames)
        with self.device_lock, torch.no_grad():
            clean = clean.to(self.device)
            eps = torch.randn(clean.shape, generator=derived_generator(self.device, seed, 0, 1),
                              device=self.device)
            fetch = self._decode_async(renoise_frames(self.sched, clean, timesteps, eps))
        decoded = fetch()
        decoded = decoded.astype(np.float32) / 255.0 if self.quantize_uint8 else decoded
        name = label if label is not None else str(class_idx)
        frames = [_render_frame(decoded[i], frame_title(name, t, self.sched.n_steps))
                  for i, t in enumerate(timesteps)]
        return encode_gif(frames, fps)

    def sample_classes(self, class_ids: Sequence[int], n_per_class: int,
                       seed: int = 0, colors: Optional[Sequence[int]] = None) -> np.ndarray:
        """Decoded (N, 64, 64, 3) images, one row block per class."""
        classes = np.repeat(np.asarray(class_ids, np.int64), n_per_class)
        color_arr = (np.repeat(np.asarray(colors, np.int64), n_per_class)
                     if colors is not None else None)
        return self.sample(classes, seed, color_arr)


class PixelSamplingService:
    """Deployment API for the unconditional pixel family (v4/v5): requests
    of N images cut into bucket-sized chunks (`request_plan`, the ladder
    smaller than the latent one: a 64x64x3 sample is ~2,000x the state of a
    latent), each chunk one reverse process of the PixelUNet from the
    generator of (seed, chunk), then clipped to [0, 1] (and quantised to
    uint8 with quantize_uint8) on the device."""

    bucket_size = SamplingService.bucket_size
    request_plan = SamplingService.request_plan

    def __init__(self, model, sched: Optional[DiffusionSchedule] = None,
                 buckets: Tuple[int, ...] = (4, 16, 64), clip_x0: Optional[float] = 1.0,
                 sampler_kind: str = "ancestral", ddim_steps: int = 50, img_size: int = 64,
                 quantize_uint8: bool = False, device=None):
        """model: the port's PixelUNet; clip_x0: the x0-thresholding bound
        (None: the reference's unclipped sampler); sampler_kind:
        'ancestral' or 'ddim' (`ddim_steps` strided steps)."""
        self.device = resolve_device(device)
        self.device_lock = threading.RLock()
        if sampler_kind not in ("ancestral", "ddim"):
            raise ValueError(f"unknown sampler_kind {sampler_kind!r}")
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.quantize_uint8 = quantize_uint8
        self.sched = sched or linear_schedule()
        self.model = model.to(self.device).eval()
        self.sampler = DiffusionSampler(self.model, self.sched, (img_size, img_size, 3),
                                        clip_x0=clip_x0, device=self.device)
        if sampler_kind == "ddim":
            self.sampler = DDIMSampler(self.sampler, num_steps=ddim_steps)

    def _post(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_uint8(x) if self.quantize_uint8 else torch.clamp(x, 0.0, 1.0)

    def warmup(self, seed: int = 0, buckets: Optional[Sequence[int]] = None) -> None:
        """Run the live path once per bucket (default: all)."""
        for b in buckets or self.buckets:
            self.sample_images(b, seed)

    def unwarmed(self) -> list:
        """[]: the pixel family's sampler binds no kernel plan."""
        return []

    @torch.no_grad()
    def sample_async(self, classes, seed: int = 0, colors=None, decode: bool = True,
                     x_init=None, stochastic: bool = True) -> Callable[[], np.ndarray]:
        """The batcher's entry, as `SamplingService.sample_async`: the pixel
        family is unconditional, so only the row count of `classes`
        matters. Every chunk is issued (sampling, clip, the copy into pinned
        host memory) before `fetch()` waits for any. x_init (N, H, W, 3) and
        stochastic=False fix the starting state and drop the step noise."""
        if colors is not None:
            raise ValueError("the pixel family has no color conditioning")
        if not decode:
            raise ValueError("the pixel family has no latent space to return")
        n = int(np.asarray(classes).reshape(-1).shape[0])
        if x_init is not None:
            x_init = np.asarray(x_init, np.float32)
        pending = []
        start = 0
        with self.device_lock:
            for i, b in enumerate(self.request_plan(n)):
                take = min(b, n - start)
                x0 = None
                if x_init is not None:
                    x0 = torch.from_numpy(SamplingService._pad(x_init[start:start + take], b))
                with deterministic_cudnn():
                    x = self.sampler.sample(b, generator=derived_generator(self.device, seed, i),
                                            x_init=x0, stochastic=stochastic)
                pending.append((*_to_host(self._post(x)), take))
                start += take
        return _fetcher(pending)

    def sample(self, classes, seed: int = 0, colors=None, decode: bool = True,
               x_init=None, stochastic: bool = True) -> np.ndarray:
        """`sample_async`, then its fetch."""
        return self.sample_async(classes, seed, colors, decode, x_init, stochastic)()

    def sample_images(self, n: int, seed: int = 0) -> np.ndarray:
        """n images (n, img_size, img_size, 3) in [0, 1] (float32, or uint8
        with quantize_uint8), as host numpy."""
        return self.sample(np.zeros((n,), np.int64), seed)

    @torch.no_grad()
    def animate(self, seed: int = 0, num_frames: int = 50, fps: int = 10, label=None) -> bytes:
        """GIF bytes of frames captured from one reverse trajectory (the
        generator of (seed, 0)), the serving form of
        viz.create_pixel_diffusion_animation."""
        from flowerdiff_torch.viz.animation import encode_gif, trajectory_frames

        with self.device_lock, deterministic_cudnn():
            _, traj = self.sampler.sample_with_trajectory(
                1, generator=derived_generator(self.device, seed, 0))
        return encode_gif(trajectory_frames(traj, self.sched.n_steps, num_frames), fps)


def service_from_run(results_dir: str, version: str = "v1", synthetic_size: int = 1020,
                     seed: int = 42, tiny: bool = False, cond_dropout: Optional[float] = None,
                     ema_decay: Optional[float] = None, guidance_scale: Optional[float] = None,
                     sampler_kind: str = "ancestral", ddim_steps: int = 50,
                     buckets: Tuple[int, ...] = DEFAULT_BUCKETS, quantize_uint8: bool = False,
                     decode_bf16: bool = False, device=None) -> SamplingService:
    """A SamplingService over a finished run's results directory: the
    runner restores (restore_scope="params") the trained VAE's generator
    weights and the latest diffusion checkpoint's weights and EMA, and
    recomputes the latent statistics as the run did (a run directory
    without a VAE checkpoint trains one first). The service samples from
    the EMA weights when the run kept them, with the run's z-scoring and x0
    clip. cond_dropout / ema_decay must be the run's (they change what
    the checkpoint holds); guidance_scale may differ (the preset's when
    None) and reaches the sampler."""
    from flowerdiff_torch.configs import get_preset, tiny_preset
    from flowerdiff_torch.runner import PipelineRunner
    from flowerdiff_torch.train.checkpoints import CheckpointManager

    preset = get_preset(version)
    if tiny:
        preset = tiny_preset(preset)
    lat = preset.latent
    if lat is None:
        raise ValueError(f"preset {version} has no latent stage")
    lat = dataclasses.replace(
        lat,
        cond_dropout=cond_dropout if cond_dropout is not None else lat.cond_dropout,
        ema_decay=ema_decay if ema_decay is not None else lat.ema_decay,
        guidance_scale=guidance_scale if guidance_scale is not None else lat.guidance_scale)
    preset = dataclasses.replace(preset, latent=lat)

    saved = CheckpointManager(os.path.join(results_dir, "ckpt_diffusion")).latest_step()
    if not saved:
        raise FileNotFoundError(f"no diffusion checkpoint under {results_dir}")
    runner = PipelineRunner(preset, results_dir=results_dir, dataset="synthetic", seed=seed,
                            synthetic_size=synthetic_size, device=device)
    _, diff = runner.run_latent(total_epochs=saved, final_sweep=False, cadence_viz=False,
                                restore_scope="params")
    return SamplingService(
        diff.sampling_model(), runner._trained_vae, sched=diff.sched,
        buckets=buckets, latent_stats=diff.latent_stats,
        clip_x0=diff.cfg.clip_denoised, guidance_scale=diff.cfg.guidance_scale,
        quantize_uint8=quantize_uint8, sampler_kind=sampler_kind, ddim_steps=ddim_steps,
        decode_bf16=decode_bf16, device=runner.device)


def pixel_service_from_run(results_dir: str, version: str = "v4", seed: int = 42,
                           tiny: bool = False, sampler_kind: str = "ancestral",
                           ddim_steps: int = 50, buckets: Tuple[int, ...] = (4, 16, 64),
                           quantize_uint8: bool = False, device=None) -> PixelSamplingService:
    """A PixelSamplingService over a finished v4/v5 run's `ckpt_pixel`
    (its latest step), the counterpart of service_from_run."""
    from flowerdiff_torch.configs import get_preset, tiny_preset
    from flowerdiff_torch.train.checkpoints import (
        CheckpointManager,
        state_to_tree,
        tree_into_state,
    )
    from flowerdiff_torch.train.pixel_ddpm import PixelDiffusionTrainer

    preset = get_preset(version)
    if tiny:
        preset = tiny_preset(preset)
    if preset.pixel is None:
        raise ValueError(f"preset {version} has no pixel stage")
    ckpt = CheckpointManager(os.path.join(results_dir, "ckpt_pixel"))
    if not ckpt.exists():
        raise FileNotFoundError(f"no ckpt_pixel under {results_dir}")
    trainer = PixelDiffusionTrainer(preset.pixel, seed=seed, device=device)
    tree_into_state(trainer.state, ckpt.restore(like=state_to_tree(trainer.state)))
    return PixelSamplingService(
        trainer.sampling_model(), sched=trainer.sched, buckets=buckets,
        clip_x0=preset.pixel.clip_denoised, sampler_kind=sampler_kind, ddim_steps=ddim_steps,
        img_size=preset.pixel.img_size, quantize_uint8=quantize_uint8, device=trainer.device)
