"""The latent family: the conditional latent MLP denoiser (kernel 3) over the
flat-latent VAE decoder, served by the port's `SamplingService` (the
flagship and v2). Its functions are the harness's own where they already
are; a request carries one class an image."""
from __future__ import annotations

from portbench.harness import arith, check, port, weights
from portbench.reference import sampler as ref


def _no_colors(cfg: dict) -> dict:
    if cfg["denoiser"].get("num_colors") is not None:
        raise ValueError("the latent family has no colour embedding: a configuration with "
                         "num_colors needs a family of its own")
    return cfg


def make(cfg: dict, seed: int, device):
    return weights.make(_no_colors(cfg), seed, device)


def build_service(cfg: dict, params, stats, device):
    return port.build_service(_no_colors(cfg), params, stats, device)


def conditions(cfg: dict) -> dict:
    return {"classes": _no_colors(cfg)["denoiser"]["num_classes"]}


def reference(params, stats, cfg: dict, picks, precision: str):
    buckets = cfg["service"]["buckets"]
    rows = [row for d, first, n in picks for row in check.rows_of(d, first, n, buckets)]
    return ref.images(params, stats, cfg, rows,
                      precision={"program": "reference", "control": "control"}[precision])


image_flops = arith.image_flops
