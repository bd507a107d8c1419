"""What the viz modules share: pyplot on the headless backend, imported
when a figure is drawn (importing `flowerdiff_torch.viz` needs neither
matplotlib nor PIL nor sklearn), the generators a seed stands for, and the
host copy of a result."""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from flowerdiff_torch.utils.device import derived_generator

Seed = Union[int, torch.Generator]


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def sampler_device(sampler) -> torch.device:
    return torch.device(getattr(sampler, "device", "cpu"))


def generators(device, seed: Seed, n: int) -> List[torch.Generator]:
    """The `n` generators of a figure's `n` draws: one stream derived from
    (seed, i) each, where the reference splits its key `n` ways, or, for a
    generator passed in, that generator `n` times (its draws in order)."""
    if isinstance(seed, torch.Generator):
        return [seed] * n
    return [derived_generator(device, int(seed), i) for i in range(n)]


def host(x) -> np.ndarray:
    """A tensor's or array's values as a numpy array on the host."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return np.asarray(x)
