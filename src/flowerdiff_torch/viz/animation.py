"""Diffusion GIF animations (port of flowerdiff/viz/animation.py).

create_diffusion_animation: denoise one latent (seeded), then re-noise the
clean latent to each t of a forward-then-backward ("ping-pong") timestep
list with one FIXED eps, decode every frame, title each with its share of
noise, write a GIF. All frames' latents are one batched q_sample
(`renoise_frames`), all frames decode in one call, and the frames are drawn
with PIL (a nearest-upscaled image under a white title bar) and encoded with
one shared palette (`encode_gif`).

create_pixel_diffusion_animation: frames captured from one trajectory of
the pixel-space sampler (`trajectory_frames`).

`SamplingService.animate` and `PixelSamplingService.animate` build the same
frames from the same helpers and return the GIF's bytes.
"""
from __future__ import annotations

import io
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from flowerdiff_torch.diffusion.ddpm import q_sample
from flowerdiff_torch.viz._common import generators, host, sampler_device


def _pingpong_timesteps(n_steps: int, num_frames: int) -> list[int]:
    """0 .. n-1 strided to about num_frames, n-1 appended, then back over
    the interior."""
    if num_frames >= n_steps:
        timesteps = list(range(n_steps))
    else:
        step_size = n_steps // num_frames
        timesteps = list(range(0, n_steps, step_size))
        if timesteps[-1] != n_steps - 1:
            timesteps.append(n_steps - 1)
    timesteps = sorted(timesteps)
    return timesteps + sorted(timesteps[1:-1], reverse=True)


def renoise_frames(sched, clean: torch.Tensor, timesteps: Sequence[int],
                   eps: torch.Tensor) -> torch.Tensor:
    """(frames, D) latents: the clean (1, D) latent re-noised to each t with
    the same eps (1, D); a t == 0 frame is the clean latent itself."""
    n, d = len(timesteps), clean.shape[-1]
    ts = torch.as_tensor(list(timesteps), dtype=torch.long, device=clean.device)
    frames = q_sample(sched.to(clean.device), clean.expand(n, d), ts, eps.expand(n, d))
    return torch.where((ts > 0)[:, None], frames, clean.expand(n, d))


def trajectory_frames(traj, n_steps: int, num_frames: int) -> List[np.ndarray]:
    """uint8 frames of sample 0 of a (T, B, H, W, 3) trajectory, whose
    index i holds the state after the step at t = n_steps - 1 - i: every
    max(1, n_steps // num_frames)-th t and t = 0, noisiest first."""
    traj = host(traj)
    step_interval = max(1, n_steps // num_frames)
    capture = sorted(set(range(0, n_steps, step_interval)) | {0})
    return [np.uint8(255 * np.clip(traj[n_steps - 1 - t][0], 0, 1))
            for t in sorted(capture, reverse=True)]


def encode_gif(frames, fps: int) -> bytes:
    """The frames as GIF bytes, quantised to ONE adaptive palette (median
    cut, 255 colors) built from the first, middle and last frames stacked,
    Floyd-Steinberg dithered, looping."""
    from PIL import Image

    ims = [Image.fromarray(np.asarray(f)) for f in frames]
    probe = np.concatenate([np.asarray(ims[0]), np.asarray(ims[len(ims) // 2]),
                            np.asarray(ims[-1])], axis=0)
    pal = Image.fromarray(probe).quantize(colors=255, method=Image.MEDIANCUT)
    qs = [im.quantize(palette=pal, dither=Image.FLOYDSTEINBERG) for im in ims]
    buf = io.BytesIO()
    qs[0].save(buf, format="GIF", save_all=True, append_images=qs[1:],
               duration=int(1000.0 / fps), loop=0)
    return buf.getvalue()


def _write_gif(frames, save_path: str, fps: int) -> None:
    data = encode_gif(frames, fps)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "wb") as f:
        f.write(data)


def _render_frame(img: np.ndarray, title: str, scale: int = 5, title_h: int = 28) -> np.ndarray:
    """One GIF frame: the image upscaled by `scale` (nearest) under a white
    bar of height `title_h` holding the centred title."""
    from PIL import Image, ImageDraw

    h, w = img.shape[0], img.shape[1]
    arr = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    im = Image.fromarray(arr).resize((w * scale, h * scale), Image.NEAREST)
    canvas = Image.new("RGB", (w * scale, h * scale + title_h), "white")
    canvas.paste(im, (0, title_h))
    draw = ImageDraw.Draw(canvas)
    tw = draw.textlength(title)
    draw.text((max(0, (w * scale - tw) // 2), title_h // 2 - 6), title, fill="black")
    return np.asarray(canvas)


def frame_title(name: str, t: int, n_steps: int) -> str:
    return f"Class: {name} (t={t}, {t / n_steps * 100:.1f}% noise)"


def create_diffusion_animation(sampler, decode_fn, class_idx, class_names: Sequence[str],
                               num_frames: int = 50, seed: int = 42,
                               save_path: Optional[str] = None, fps: int = 10,
                               reverse: bool = False,
                               extra_cond: Optional[torch.Tensor] = None) -> str:
    """The clean latent from the generator of (seed, 0), the fixed eps from
    (seed, 1)."""
    if isinstance(class_idx, str):
        class_idx = list(class_names).index(class_idx)
    if save_path is None:
        os.makedirs("./results", exist_ok=True)
        save_path = f"./results/diffusion_animation_{class_names[class_idx]}.gif"

    sched = sampler.sched
    dev = sampler_device(sampler)
    sample_gen, noise_gen = generators(dev, seed, 2)
    classes = torch.tensor([class_idx], dtype=torch.long, device=dev)
    cond = (classes,) if extra_cond is None else (classes, extra_cond)
    clean = sampler.sample(1, *cond, generator=sample_gen)

    timesteps = _pingpong_timesteps(sched.n_steps, num_frames)
    if reverse:
        timesteps = sorted(set(timesteps), reverse=True)
    eps = torch.randn((1, sampler.latent_dim), generator=noise_gen, device=dev)
    decoded = host(decode_fn(renoise_frames(sched, clean, timesteps, eps)))

    frames = [_render_frame(decoded[i], frame_title(class_names[class_idx], t, sched.n_steps))
              for i, t in enumerate(timesteps)]
    _write_gif(frames, save_path, fps)
    return save_path


def create_pixel_diffusion_animation(sampler, num_frames: int = 50,
                                     save_path: str = "diffusion_animation.gif", fps: int = 10,
                                     seed=0) -> str:
    """A pixel-space animation from one trajectory (the generator of
    (seed, 0), or `seed` itself when it is a generator)."""
    (gen,) = generators(sampler_device(sampler), seed, 1)
    _, traj = sampler.sample_with_trajectory(1, generator=gen)
    _write_gif(trajectory_frames(traj, sampler.sched.n_steps, num_frames), save_path, fps)
    return save_path
