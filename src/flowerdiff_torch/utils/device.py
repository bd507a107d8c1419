"""Device selection and derived generators shared by the port's entry points."""
from __future__ import annotations

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


def derived_generator(device, *words: int) -> torch.Generator:
    """A `torch.Generator` on `device` seeded from the integers `words`
    through numpy's SeedSequence: the port's counterpart of
    `jax.random.fold_in`. Equal words give the same stream; another word
    gives an unrelated one."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)
