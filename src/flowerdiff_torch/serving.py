"""Production sampling service (port of `SamplingService` in
flowerdiff/serving.py).

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
`use_fused` (default: on a CUDA device), where the 1000 steps are one replay
of the bucket's captured CUDA graph and `warmup` captures every bucket's
graph before traffic; with `use_fused=False` it runs the plain f32 model.
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

Not ported yet: `service_from_run`, `animate`, `PixelSamplingService`.
"""
from __future__ import annotations

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
from flowerdiff_torch.utils.device import (
    derived_generator,
    deterministic_cudnn,
    resolve_device,
)

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def quantize_uint8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats -> uint8, rounding half to even like jnp.round."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


class SamplingService:
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
        None picks it on a CUDA device and the plain model elsewhere.
        sampler_kind: 'ancestral' or 'ddim' (`ddim_steps` strided steps).
        decode_bf16: the decoder under bf16 autocast, output f32."""
        self.device = resolve_device(device)
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
        the kernel path, every bucket's CUDA graph captured before live
        traffic."""
        for b in buckets or self.buckets:
            classes = np.zeros((b,), np.int64)
            colors = np.zeros((b,), np.int64) if with_colors else None
            self.sample(classes, seed, colors, decode=True)

    @torch.no_grad()
    def sample_async(self, classes, seed: int = 0, colors=None, decode: bool = True,
                     x_init=None, stochastic: bool = True) -> Callable[[], np.ndarray]:
        """Dispatch a request as bucket-sized chunks (`request_plan`) and
        return `fetch()`, which waits for the chunks in order and slices
        each chunk's padding off. Every chunk is issued before any is
        fetched: its sampler replay, decode and the copy of its result into
        pinned host memory (`non_blocking`) are all enqueued, so chunk i's
        copy overlaps chunk i + 1's sampling. Arguments as `sample`."""
        classes = np.asarray(classes, np.int64).reshape(-1)
        if colors is not None:
            colors = np.asarray(colors, np.int64).reshape(-1)
        if x_init is not None:
            x_init = np.asarray(x_init, np.float32)
        n = classes.shape[0]
        pending = []
        start = 0
        for i, b in enumerate(self.request_plan(n)):
            take = min(b, n - start)
            part = slice(start, start + take)
            cond = [torch.from_numpy(self._pad(classes[part], b)).to(self.device)]
            if colors is not None:
                cond.append(torch.from_numpy(self._pad(colors[part], b)).to(self.device))
            x0 = None
            if x_init is not None:
                x0 = torch.from_numpy(self._pad(x_init[part], b)).to(self.device)
            lat = self.sampler.sample(b, *cond, generator=derived_generator(self.device, seed, i),
                                      x_init=x0, stochastic=stochastic)
            out = self._decode(lat) if decode else lat
            done = None
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                out = host
            pending.append((out, done, take))
            start += take

        def fetch() -> np.ndarray:
            outs = []
            for out, done, take in pending:
                if done is not None:
                    done.synchronize()
                outs.append(out.numpy()[:take])
            return outs[0] if len(outs) == 1 else np.concatenate(outs)

        return fetch

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
    def decode_latents(self, latents) -> np.ndarray:
        """(N, latent) raw VAE latents -> (N, 64, 64, 3) images (float32,
        or uint8 with quantize_uint8), in bucket-sized chunks."""
        latents = np.asarray(latents, np.float32)
        n = latents.shape[0]
        outs = []
        start = 0
        for b in self.request_plan(n):
            take = min(b, n - start)
            chunk = torch.from_numpy(self._pad(latents[start:start + take], b))
            outs.append(self._decode(chunk.to(self.device)).cpu().numpy()[:take])
            start += take
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def sample_classes(self, class_ids: Sequence[int], n_per_class: int,
                       seed: int = 0, colors: Optional[Sequence[int]] = None) -> np.ndarray:
        """Decoded (N, 64, 64, 3) images, one row block per class."""
        classes = np.repeat(np.asarray(class_ids, np.int64), n_per_class)
        color_arr = (np.repeat(np.asarray(colors, np.int64), n_per_class)
                     if colors is not None else None)
        return self.sample(classes, seed, color_arr)
