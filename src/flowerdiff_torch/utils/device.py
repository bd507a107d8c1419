"""Device selection, derived generators and cuDNN's deterministic mode,
shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no card is present; the port has no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flowerdiff_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def derived_seed(*words: int) -> int:
    """A 63-bit seed from the integers `words` through numpy's SeedSequence:
    the port's counterpart of `jax.random.fold_in`. Equal words give the
    same seed; another word gives an unrelated one."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def derived_generator(device, *words: int) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with `derived_seed(*words)`."""
    return torch.Generator(device=device).manual_seed(derived_seed(*words))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN on, with its deterministic algorithms only, for the block;
    every flag is restored after it. (`torch.backends.cudnn.flags` would
    also set allow_tf32 and benchmark to its own defaults for the block.)
    The service's decode and the VAE-GAN step run under it: cuDNN's default
    algorithms may differ from run to run."""
    cudnn = torch.backends.cudnn
    before = cudnn.enabled, cudnn.deterministic
    cudnn.enabled, cudnn.deterministic = True, True
    try:
        yield
    finally:
        cudnn.enabled, cudnn.deterministic = before
