"""The system under test: the latent family's service, the port's
`SamplingService` built as `flowerdiff_torch/tools/serve.py::build_service`
builds it for a user but with the benchmark's seeded weights in place of a
run directory (`families/latent.py` points here); and the recorder around
any family's service.

Every import of the port happens inside these functions, so importing the
harness imports no part of it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _on_meta(factory):
    with torch.device("meta"):
        return factory()


def build_service(cfg: dict, params: Dict[str, Dict[str, torch.Tensor]], stats, device):
    """The configuration's SamplingService on `device`, its modules holding
    copies of `params` (made without the modules' own initialisation)."""
    from flowerdiff_torch.diffusion.schedule import linear_schedule
    from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
    from flowerdiff_torch.models.vae import FlowerVAE
    from flowerdiff_torch.serving import SamplingService

    den, dec = cfg["denoiser"], cfg["decoder"]
    model = _on_meta(lambda: ConditionalLatentDenoiser(
        latent_dim=den["latent_dim"], hidden_dims=tuple(den["hidden_dims"]),
        time_emb_dim=den["time_emb_dim"], num_classes=den["num_classes"],
        shared_cond_proj=den["shared_cond_proj"], global_skip=den["global_skip"]))
    vae = _on_meta(lambda: FlowerVAE(latent_dim=dec["latent_dim"], channels=tuple(dec["channels"]),
                                     head_width=dec["head_width"], base_size=dec["base_size"]))
    model = model.to_empty(device=device)
    vae = vae.to_empty(device=device)
    model.load_state_dict(params["denoiser"], strict=True)
    with torch.no_grad():
        for p in vae.encoder.parameters():
            p.zero_()  # the service decodes only
    missing, unexpected = vae.load_state_dict(
        {f"decoder.{k}": v for k, v in params["decoder"].items()}, strict=False)
    stray = [k for k in missing if not k.startswith("encoder.")] + list(unexpected)
    if stray:
        raise RuntimeError(f"the decoder's weights do not fit the port's module: {stray}")
    sch = cfg["schedule"]
    svc = cfg["service"]
    return SamplingService(
        model, vae, sched=linear_schedule(sch["n_steps"], sch["beta_start"], sch["beta_end"]),
        buckets=tuple(svc["buckets"]), latent_stats=stats, clip_x0=cfg["sampler"]["clip_x0"],
        guidance_scale=cfg["sampler"]["guidance_scale"], quantize_uint8=svc["quantize_uint8"],
        use_fused=True, decode_bf16=svc["decode_bf16"], device=device)


class Dispatch:
    """One call of `sample_async`: what it was asked (classes, seed, colours
    or None), when, its chunks' buckets and, once fetched, a copy of what it
    returned."""
    __slots__ = ("index", "classes", "colors", "seed", "plan", "t_call", "t_issued", "out")

    def __init__(self, index, classes, seed, plan, colors=None):
        self.index, self.classes, self.seed, self.plan = index, classes, seed, plan
        self.colors = colors
        self.t_call = self.t_issued = None
        self.out: Optional[np.ndarray] = None


class RecordingService:
    """The service as its callers see it, every `sample_async` recorded:
    classes, colours, seed, its chunks' buckets, the host times of the call,
    the result. It computes nothing itself."""

    def __init__(self, service):
        self.service = service
        self.buckets = service.buckets
        self.dispatches: List[Dispatch] = []
        self._lock = threading.Lock()

    def sample_async(self, classes, seed=0, colors=None, decode=True, **kw):
        classes = np.asarray(classes, np.int64).reshape(-1)
        if colors is not None:
            colors = np.asarray(colors, np.int64).reshape(-1)
        plan = self.service.request_plan(classes.shape[0])
        with self._lock:
            d = Dispatch(len(self.dispatches), classes.copy(), int(seed), plan,
                         None if colors is None else colors.copy())
            self.dispatches.append(d)
        d.t_call = time.perf_counter()
        fetch = self.service.sample_async(classes, seed, colors, decode=decode, **kw)
        d.t_issued = time.perf_counter()

        def recorded_fetch():
            out = fetch()
            d.out = np.array(out)  # a copy, so the service's pinned array is not kept
            return out

        return recorded_fetch


def reachable_buckets(service, sizes) -> List[int]:
    """The buckets requests of these sizes reach."""
    return sorted({b for n in sizes for b in service.request_plan(int(n))})
