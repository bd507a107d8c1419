"""Served images recomputed: the ancestral DDPM reverse process (v1:564-598)
with the configuration's classifier-free guidance, x0 clipping and z-score
denormalisation, then the decoder and the uint8 output.

    schedule: beta linear from beta_start to beta_end over T steps (float64,
      rounded once to f32), alpha = 1 - beta, alpha_bar = cumprod(alpha)
    step t = T-1 .. 0:
      e = eps(x_t) (guided: e_u + s (e_c - e_u) from the doubled rows)
      x0 = clip((x_t - sqrt(1 - ab) e) / sqrt(ab), -c, c);  e = (x_t - sqrt(ab) x0) / sqrt(1 - ab)
      x_{t-1} = (x_t - (1 - a) / sqrt(1 - ab) e) / sqrt(a) + [t > 0] sqrt(beta) z
    latent = x_0 * std + mean; image = decode(latent)

Rows do not interact, so only the rows asked for are computed; what depends
on a row's chunk (its x_T, drawn with the whole bucket, its Philox key, the
offset of its noise) is drawn as the served chunk draws it (`seeds.py`,
`philox.py`).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench.reference import decoder, philox, seeds
from portbench.reference.denoiser import Denoiser

NOISE_BLOCK = 25  # steps of noise drawn at once


class Row(NamedTuple):
    """One served image: the seed its request (or dispatch) was served with,
    the chunk of that request it fell in, the chunk's bucket, its row in the
    chunk and its class."""
    seed: int
    chunk: int
    bucket: int
    row: int
    cls: int


def schedule(cfg: dict):
    s = cfg["schedule"]
    i = np.arange(s["n_steps"], dtype=np.float64)
    beta = (s["beta_start"] + i * (s["beta_end"] - s["beta_start"]) / (s["n_steps"] - 1))
    beta = beta.astype(np.float32)
    alpha = (1.0 - beta.astype(np.float64)).astype(np.float32)
    alpha_bar = np.cumprod(alpha.astype(np.float64)).astype(np.float32)
    return beta, alpha, alpha_bar


def _starts(rows: List[Row], latent: int, device):
    x, keys = [], []
    drawn: Dict[tuple, tuple] = {}
    for r in rows:
        k = (r.seed, r.chunk, r.bucket)
        if k not in drawn:
            drawn[k] = seeds.chunk_start(r.seed, r.chunk, r.bucket, latent, device)
        x.append(drawn[k][0][r.row])
        keys.append(drawn[k][1])
    return torch.stack(x), torch.tensor(keys, dtype=torch.int64, device=device)


@torch.no_grad()
def latents(params: Dict[str, torch.Tensor], stats, cfg: dict, rows: List[Row],
            products: str) -> torch.Tensor:
    """x_0 * std + mean, (len(rows), latent) f32."""
    den_cfg, smp = cfg["denoiser"], cfg["sampler"]
    device = params["latent_proj.weight"].device
    latent = den_cfg["latent_dim"]
    beta, alpha, alpha_bar = schedule(cfg)
    n_steps = len(beta)
    eps_fn = Denoiser(params, den_cfg, n_steps, products)
    guided = smp["guidance_scale"] is not None
    copies = 2 if guided else 1
    classes = torch.tensor([r.cls for r in rows], dtype=torch.int64, device=device)
    adds = eps_fn.condition(classes, guided)
    x, keys = _starts(rows, latent, device)
    elements = (torch.tensor([r.row for r in rows], dtype=torch.int64, device=device)[:, None]
                * latent + torch.arange(latent, device=device)[None])
    clip = smp["clip_x0"]
    top = -1  # the first step of the noise block drawn
    for t in range(n_steps - 1, -1, -1):
        if t <= top - NOISE_BLOCK or top < 0:
            top = t
            steps = torch.arange(t, max(-1, t - NOISE_BLOCK), -1, device=device)
            noise = philox.step_noise(elements, keys, steps)
        e = eps_fn(x, t, adds, copies)
        if guided:
            e_c, e_u = e[: x.shape[0]], e[x.shape[0]:]
            e = e_u + float(np.float32(smp["guidance_scale"])) * (e_c - e_u)
        a, ab, b = (float(v) for v in (alpha[t], alpha_bar[t], beta[t]))
        sq1mab, sqab = np.sqrt(1.0 - ab), np.sqrt(ab)
        if clip is not None:
            x0 = torch.clamp((x - sq1mab * e) / sqab, -clip, clip)
            e = (x - sqab * x0) / sq1mab
        x = (x - (1.0 - a) / sq1mab * e) / np.sqrt(a)
        if t > 0:
            x = x + np.sqrt(b) * noise[top - t]
    mean, std = stats
    return x * std + mean


@torch.no_grad()
def images(params: Dict[str, Dict[str, torch.Tensor]], stats, cfg: dict, rows: List[Row],
           precision: str = "reference", block: int = 256) -> np.ndarray:
    """uint8 (len(rows), H, W, 3) of the served rows. precision: 'reference'
    (the configuration's `precision.products`, the decoder in f32 with its
    stated TF32 setting) or 'control' (`precision.control_products`, the
    decoder under `precision.control_decoder` autocast)."""
    prec = cfg["precision"]
    control = precision == "control"
    products = prec["control_products"] if control else prec["products"]
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    keep = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32, cudnn.allow_tf32 = False, bool(prec["decoder_conv_tf32"])
    try:
        z = latents(params["denoiser"], stats, cfg, rows, products)
        device = z.device
        out = []
        dtype = getattr(torch, prec["control_decoder"]) if control else torch.float32
        for i in range(0, z.shape[0], block):
            with torch.autocast(device.type, dtype=dtype, enabled=control):
                img = decoder.decode(params["decoder"], cfg["decoder"], z[i:i + block])
            out.append(decoder.to_uint8(img.float()).cpu().numpy())
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = keep
    return np.concatenate(out) if out else np.zeros((0,), np.uint8)
